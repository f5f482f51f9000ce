"""Threefry-2x32 keys and bits in jax's partitionable layout.

Frozen copy of ``src/repro_torch/prng.py`` at commit 69e108eca3b3 (the
port's bit-exact ``jax.random``): ``PRNGKey``, ``fold_in``, ``split``,
``step_keys``, ``random_bits``, ``uniform`` and ``normal``. One change:
the bulk draws take the key words and an int64 tensor of flat element
indices, all broadcast together, so the reference draws only the rows of a
table it touches, bitwise those rows of the whole draw.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32_np(k1, k2, x1, x2):
    """The hash on uint32 numpy words; everything broadcasts."""
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


def threefry2x32_torch(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The same hash on int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]).bitwise_and_(MASK)
    x1 = (x2 + ks[1]).bitwise_and_(MASK)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            x1 = (x1 << r).bitwise_and_(MASK).bitwise_or_(x1 >> (32 - r))
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(MASK)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """The seed's 64 bits as two uint32 words."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return np.array([(seed >> 32) & MASK, seed & MASK], dtype=np.uint32)


def fold_in(key, data) -> np.ndarray:
    """``fold_in(key, data)``; ``data`` may be an array of integers, giving
    ``(*data.shape, 2)`` keys."""
    k = np.asarray(key, np.uint32)
    d = np.asarray(data, np.int64) & MASK
    o0, o1 = threefry2x32_np(k[0], k[1], np.zeros_like(d, np.uint32), d.astype(np.uint32))
    return np.stack([o0, o1], axis=-1).astype(np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``split(key, num)`` of a ``(..., 2)`` stack of keys: ``(..., num, 2)``."""
    k = np.asarray(key, np.uint32)
    lead = k.shape[:-1]
    flat = k.reshape(-1, 1, 2)
    lo = np.arange(num, dtype=np.uint32)[None, :]
    o0, o1 = threefry2x32_np(flat[..., 0], flat[..., 1], np.zeros_like(lo), lo)
    return np.stack([o0, o1], axis=-1).reshape(*lead, num, 2)


def step_keys(keys, steps: int) -> np.ndarray:
    """The subkeys a scan of ``key, sub = split(key)`` consumes:
    ``(..., steps, 2)`` from ``(..., 2)`` start keys."""
    k = np.asarray(keys, np.uint32)
    out = np.empty((*k.shape[:-1], steps, 2), dtype=np.uint32)
    for i in range(steps):
        pair = split(k, 2)
        k, out[..., i, :] = pair[..., 0, :], pair[..., 1, :]
    return out


def key_words(keys, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(..., 2)`` uint32 words as two int64 tensors ``(...)`` on ``device``."""
    t = torch.from_numpy(np.asarray(keys, np.uint32).astype(np.int64)).to(device)
    return t[..., 0], t[..., 1]


def random_bits(k0: torch.Tensor, k1: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The uint32 bits (as int64) of flat elements ``index`` of a draw under
    the key words ``k0``, ``k1`` (int64 tensors that broadcast against
    ``index``). Element i's bits hash the counter pair ``(i >> 32, i &
    mask)`` and XOR the two output words, whatever the draw's shape."""
    b1, b2 = threefry2x32_torch(k0, k1, index >> 32, index & MASK)
    return b1.bitwise_xor_(b2)


def uniform(k0: torch.Tensor, k1: torch.Tensor, index: torch.Tensor,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms of flat elements ``index``: 23 random mantissa bits
    under exponent 0, then the scale and shift rounded once (an FMA's
    result, worked in float64)."""
    bits = random_bits(k0, k1, index)
    one_bits = int(np.array(1.0, np.float32).view(np.uint32))
    f = ((bits >> 9) | one_bits).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    scale = np.float32(maxval) - lo
    if lo == 0.0 and scale == 1.0:
        return f
    out = (f.double() * float(scale) + float(lo)).float()
    return torch.clamp_min(out, float(lo))


def normal(k0: torch.Tensor, k1: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """float32 normals of flat elements ``index``: ``sqrt(2)·erfinv(u)``,
    ``u`` uniform on ``(nextafter(-1, 0), 1)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32))
    sqrt2 = torch.tensor(np.float32(np.sqrt(2)), dtype=torch.float32, device=index.device)
    return torch.erfinv(uniform(k0, k1, index, lo, 1.0)) * sqrt2
