"""K7: single-token sliding-window attention decode over a full ring-buffer
KV cache — a CUDA kernel for Hopper, its plain torch version, and the
wrapper that chooses.

Replaces the JAX package's ``_swa_kernel`` (``repro/kernels/swa_decode.py``,
reached through ``swa_decode_kernel``). Source:
``repro_torch/csrc/swa_decode.cu``. For ``q (B, H, D)`` and ``k``/``v``
``(B, W, Hkv, D)``, every slot of the window valid::

    s[b, h, w] = (q[b, h] · k[b, w, h // rep]) · (1/sqrt(D)),  rep = H // Hkv
    out[b, h]  = Σ_w softmax_w(s[b, h])[w] · v[b, w, h // rep]

accumulated in float32 and written in q's dtype (float32 or bfloat16).
With ``Hkv == H`` that is the TPU kernel's function and signature; the
port's decode calls it with the model's KV heads (GQA), the grouping of
``repro.models.attention._sdpa``. The TPU kernel walks the window's
chunks in order with a running max, sum and accumulator; the CUDA kernel
gives each CTA a batch row and a range of window rows with all its KV
heads, streams them through a ring of shared-memory stages by bulk
asynchronous copies, and merges the CTAs' partials in a second kernel in
a fixed order (the source note says why). ``chunk`` shapes only the
plain version's precondition: the kernel cuts the window its own way.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels.ref import swa_decode_plain
from repro_torch.kernels.sgns_fused import (
    LAUNCHES, _check, _entry, _kernel_device, _raise_on)

__all__ = ["swa_decode", "swa_decode_plain"]

_DTYPES = (torch.float32, torch.bfloat16)
# The launch's constants (``csrc/swa_decode.cu``).
CONSUMER_WARPS, MAX_STAGES, STAGE_BYTES, RING_BYTES, RING_OFFSET = 8, 4, 40 * 1024, 200 * 1024, 128


class SwaShape(NamedTuple):
    """K7's instantiation and ring at one shape, as ``make_plan`` picks them."""

    nc: int              # columns a lane (the kernel's NC)
    qp: int              # query heads a warp, padded (QP)
    multi: bool          # a warp serves more than one KV head (MULTI)
    rows: int            # window rows a tile
    stages: int
    smem: int            # dynamic shared memory of the partial kernel


def swa_shape(W: int, H: int, Hkv: int, D: int, elem: int) -> SwaShape:
    """The partial kernel's instantiation and shared memory for a window of
    ``W`` rows of ``Hkv`` heads of width ``D`` (``elem`` bytes an element);
    raises ``ValueError`` for a shape the kernel does not take."""
    need = -(-D // 32)
    nc = 2 if need <= 2 else need if need <= 4 else 8
    rep = H // Hkv
    qw = -(-Hkv // CONSUMER_WARPS) * rep if Hkv >= CONSUMER_WARPS else rep
    qp = 1
    while qp < qw:
        qp *= 2
    if need > 8 or qp > 8 or qp * nc > 32:
        raise ValueError(f"a group of {rep} query heads of width {D} exceeds the kernel's "
                         f"registers")
    row_bytes = Hkv * D * elem
    align = 16 // math.gcd(row_bytes % 16, 16)
    wph = 1 if Hkv >= CONSUMER_WARPS else CONSUMER_WARPS // Hkv
    group = (32 // qp) * wph
    rows = STAGE_BYTES // 2 // row_bytes
    rows = rows // group * group if rows >= group else rows
    rows = max(rows // align * align, align)
    rows = min(rows, W)
    stages = min(RING_BYTES // (2 * rows * row_bytes), MAX_STAGES)
    if W % align or stages < 2:
        raise ValueError(f"the kernel does not take a window of {W} rows of {Hkv}·{D}")
    return SwaShape(nc, qp, qp > 1 and Hkv > CONSUMER_WARPS, rows, stages,
                    RING_OFFSET + stages * 2 * rows * row_bytes)


@functools.lru_cache(maxsize=64)
def _parts(B: int, W: int, H: int, Hkv: int, D: int, bf16: int, device_index: int) -> int:
    """The partials a query head the kernel writes at this shape (its
    window split and warps a head); a ValueError for a shape it does not
    take (the source's ``swa_decode_parts`` says which)."""
    fn = _entry("swa_decode", "swa_decode_parts")
    with torch.cuda.device(device_index):
        parts = fn(B, W, H, Hkv, D, bf16)
    if parts == -1001:
        raise ValueError(f"a group of {H // Hkv} query heads of width {D} exceeds the "
                         f"kernel's registers")
    if parts == -1002:
        raise ValueError(f"the kernel does not take a window of {W} rows of {Hkv}·{D} "
                         f"{'bfloat16' if bf16 else 'float32'} elements: a tile of two "
                         f"rows must fit its ring, and whole tiles must be 16-byte aligned")
    _raise_on(-min(parts, 0), "swa_decode (plan)")
    return parts


def swa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               chunk: int = 512) -> torch.Tensor:
    """K7 on ``q (B, H, D)`` and a full ring ``k``/``v (B, W, Hkv, D)``
    (contiguous, one device, one dtype: float32 or bfloat16; ``W % chunk
    == 0``, ``H % Hkv == 0``). Returns ``(B, H, D)`` in q's dtype. CPU
    tensors run the plain version; CUDA tensors launch the kernel."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be (B, H, D) and k, v (B, W, Hkv, D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, D = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    if W % chunk != 0:
        raise ValueError(f"window {W} not divisible by chunk {chunk}")
    if Hkv == 0 or H % Hkv != 0:
        raise ValueError(f"{H} query heads do not group over {Hkv} KV heads")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    device = q.device
    _check(q, "q", q.dtype, (B, H, D), device)
    _check(k, "k", q.dtype, (B, W, Hkv, D), device)
    _check(v, "v", q.dtype, (B, W, Hkv, D), device)
    if device.type == "cpu":
        return swa_decode_plain(q, k, v, chunk=chunk)
    _kernel_device(device)
    if torch.cuda.current_device() != device.index:
        with torch.cuda.device(device):
            return swa_decode(q, k, v, chunk=chunk)
    bf16 = int(q.dtype == torch.bfloat16)
    parts = _parts(B, W, H, Hkv, D, bf16, device.index)
    if any(t.data_ptr() % 16 for t in (k, v)):
        raise ValueError("k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    # one scratch buffer: m (B·H, parts), l (B·H, parts), acc (B·H, parts, D)
    n = B * H * parts
    scratch = torch.empty(n * (D + 2), dtype=torch.float32, device=device)
    m_ptr = scratch.data_ptr()
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    err = _entry("swa_decode", "swa_decode_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), m_ptr, m_ptr + 4 * n,
        m_ptr + 8 * n, B, W, H, Hkv, D, 1.0 / D ** 0.5, bf16, stream)
    _raise_on(err, "swa_decode")
    LAUNCHES["swa_decode"] += 1
    return out


def swa_decode_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      chunk: int = 512) -> torch.Tensor:
    """The reference's ``swa_decode_kernel(q, k, v, *, chunk)`` (its
    ``interpret`` dial has no counterpart): :func:`swa_decode`, K7 on CUDA
    tensors and its plain version on CPU ones."""
    return swa_decode(q, k, v, chunk=chunk)
