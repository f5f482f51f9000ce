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
gives each (batch, KV head, chunk) its own CTA and merges the chunks'
partials in a second kernel (the source note says why).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ref import swa_decode_plain
from repro_torch.kernels.sgns_fused import (
    LAUNCHES, _check, _entry, _kernel_device, _ptr, _raise_on, _stream)

__all__ = ["swa_decode", "swa_decode_plain", "MAX_GROUP_WIDTH"]

#: The kernel keeps ``(H // Hkv) · D`` accumulators over its 256 threads,
#: at most 8 each.
MAX_GROUP_WIDTH = 2048
_DTYPES = (torch.float32, torch.bfloat16)


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
    if (H // Hkv) * D > MAX_GROUP_WIDTH:
        raise ValueError(f"(H // Hkv)·D = {(H // Hkv) * D} exceeds the kernel's "
                         f"{MAX_GROUP_WIDTH}")
    n_split = W // chunk
    out = torch.empty_like(q)
    m_part = torch.empty((B * H, n_split), dtype=torch.float32, device=device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((B * H, n_split, D), dtype=torch.float32, device=device)
    per_vec = 16 // q.element_size()
    vec = int(D % per_vec == 0 and all(t.data_ptr() % 16 == 0 for t in (k, v)))
    fn = _entry("swa_decode", "swa_decode_launch")
    with torch.cuda.device(device):
        err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(m_part), _ptr(l_part),
                 _ptr(acc_part), B, W, H, Hkv, D, chunk, 1.0 / D ** 0.5,
                 int(q.dtype == torch.bfloat16), vec, _stream(device))
    _raise_on(err, "swa_decode")
    LAUNCHES["swa_decode"] += 1
    return out
