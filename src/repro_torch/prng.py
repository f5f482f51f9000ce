"""Threefry-2x32 keys and bits, bit-exact with ``jax.random``.

The JAX package derives every random stream from ``jax.random`` keys:
the driver's epoch and chunk keys, the per-step split of the async
trainer, ``init_params``, the ALiR init, and the fused kernel's seed
(which *is* the raw key words). Reproducing those bits is what lets the
port be held against the reference from one seed, end to end.

This module implements jax's default ``threefry2x32`` implementation in
its *partitionable* mode (``jax_threefry_partitionable=True``), the mode
that changes how ``split`` and ``random_bits`` lay out their counters:

* a key is a ``(2,)`` uint32 array of words;
* ``split(key, n)[i]`` and ``fold_in(key, i)`` both hash the counter
  pair ``(0, i)``;
* ``random_bits(key, shape)`` hashes the 64-bit row-major index of every
  element as the counter pair ``(hi, lo)`` and XORs the two output
  words.

Key derivation is small and runs in numpy (uint32). Bulk bits run in
torch on the target device, in int64 masked to 32 bits, because torch's
uint32 support is partial.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# ---------------------------------------------------------------------------
# The hash, once in numpy (uint32 wraps) and once in torch (int64 & mask)
# ---------------------------------------------------------------------------
def _threefry2x32_np(k1, k2, x1, x2):
    """Key words and counters broadcast against each other."""
    k1, k2 = np.asarray(k1, np.uint32), np.asarray(k2, np.uint32)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(_PARITY))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x1, np.uint32) + ks[0]
        x1 = np.asarray(x2, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 = x0 ^ x1
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _threefry2x32_torch(k1: int, k2: int, x1: torch.Tensor,
                        x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The same hash on int64 tensors holding uint32 values; ``k1``,
    ``k2`` are Python ints."""
    ks = (int(k1), int(k2), int(k1) ^ int(k2) ^ _PARITY)
    x0 = (x1 + ks[0]).bitwise_and_(_MASK)
    x1 = (x2 + ks[1]).bitwise_and_(_MASK)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK)
            x1 = (x1 << r).bitwise_and_(_MASK).bitwise_or_(x1 >> (32 - r))
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_MASK)
    return x0, x1


# ---------------------------------------------------------------------------
# Keys (numpy)
# ---------------------------------------------------------------------------
def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's 64 bits as two words."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return np.array([(seed >> 32) & _MASK, seed & _MASK], dtype=np.uint32)


def _words(key) -> np.ndarray:
    key = np.asarray(key)
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key is (..., 2) uint32 words, got {key.shape}")
    return key.astype(np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for one ``(2,)`` key."""
    k = _words(key)
    o0, o1 = _threefry2x32_np(k[0], k[1], np.uint32(0),
                              np.uint32(int(data) & _MASK))
    return np.array([o0, o1], dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``. Also takes a stack of keys
    ``(..., 2)`` and returns ``(..., num, 2)``: the split of each."""
    k = _words(key)
    lead = k.shape[:-1]
    flat = k.reshape(-1, 1, 2)
    lo = np.arange(num, dtype=np.uint32)[None, :]
    o0, o1 = _threefry2x32_np(flat[..., 0], flat[..., 1], np.zeros_like(lo), lo)
    return np.stack([o0, o1], axis=-1).reshape(*lead, num, 2)


def step_keys(keys, steps: int) -> np.ndarray:
    """The per-step keys a ``lax.scan`` of ``key, sub = split(key)``
    consumes: ``(..., steps, 2)`` subkeys from ``(..., 2)`` start keys."""
    k = _words(keys)
    out = np.empty((*k.shape[:-1], steps, 2), dtype=np.uint32)
    for i in range(steps):
        pair = split(k, 2)
        k, out[..., i, :] = pair[..., 0, :], pair[..., 1, :]
    return out


# ---------------------------------------------------------------------------
# Bulk bits and floats (torch, on the target device)
# ---------------------------------------------------------------------------
def random_bits(key, shape: tuple[int, ...], device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor of
    values in ``[0, 2**32)``."""
    k = _words(key)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    hi, lo = idx >> 32, idx & _MASK
    b1, b2 = _threefry2x32_torch(int(k[0]), int(k[1]), hi, lo)
    return b1.bitwise_xor_(b2).reshape(shape)


def uniform(key, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: 23
    random mantissa bits under exponent 0, then ``f·(max−min) + min``.

    XLA contracts that scale-and-shift into one fused multiply-add
    (single rounding). Here it runs in float64 and is rounded once to
    float32: the product of two float32 values is exact in float64, and
    the sum is exact too whenever ``|minval|`` is within 2**6 of
    ``maxval − minval`` (every use in this package), so the result is
    the FMA's, bit for bit."""
    bits = random_bits(key, shape, device)
    one_bits = int(np.array(1.0, np.float32).view(np.uint32))
    f = ((bits >> 9) | one_bits).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    scale = np.float32(maxval) - lo
    if lo == 0.0 and scale == 1.0:
        return f
    out = (f.double() * float(scale) + float(lo)).float()
    return torch.clamp_min(out, float(lo))


def normal(key, shape: tuple[int, ...], device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2)·erfinv(u)``
    with ``u`` uniform on ``(nextafter(-1, 0), 1)``. The uniforms are
    bit-exact; ``erfinv`` is torch's, which differs from XLA's
    polynomial in the last few ulps."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, float(lo), 1.0, device)
    return torch.erfinv(u) * torch.tensor(np.float32(np.sqrt(2)),
                                          dtype=torch.float32, device=device)
