"""K3: the SGNS forward and row gradients on gathered rows — a CUDA kernel
for Hopper, its plain torch version, and the wrapper that chooses.

Replaces the JAX package's ``_sgns_kernel`` (``repro/kernels/sgns_update.py``,
the ``pallas`` engine's row-gradient kernel). Source:
``repro_torch/csrc/sgns_row_grads.cu``, one warp per pair. Per pair, on rows
``w``, ``c_pos`` ``(d,)`` and ``c_neg`` ``(K, d)``::

    s_pos = w·c_pos,  s_k = w·c_k
    loss  = softplus(−s_pos) + Σ_k softplus(s_k)
    g_pos = σ(s_pos) − 1,  g_k = σ(s_k)
    dW = g_pos·c_pos + Σ_k g_k·c_k,  dC_pos = g_pos·w,  dC_k = g_k·w

These are the gradients of the *sum* loss (word2vec's update semantics).
The reference pads d to 128 lanes and the batch to its VMEM block; both
are TPU artifacts and are not carried over: the kernel takes any ``N``
pairs and any d.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.sgns_fused import (
    LAUNCHES, MAX_NEGATIVES, _check, _entry, _kernel_device, _ptr, _raise_on,
    _softplus, _stream)


def sgns_row_grads_plain(w: torch.Tensor, c_pos: torch.Tensor,
                         c_neg: torch.Tensor):
    """What K3 computes, in torch: ``(loss (N,), dW (N, d), dC_pos (N, d),
    dC_neg (N, K, d))`` in the TPU kernel's softplus form."""
    s_pos = (w * c_pos).sum(-1)
    s_neg = (w[:, None, :] * c_neg).sum(-1)
    loss = _softplus(-s_pos) + _softplus(s_neg).sum(-1)
    g_pos = torch.sigmoid(s_pos) - 1.0
    g_neg = torch.sigmoid(s_neg)
    d_w = g_pos[:, None] * c_pos + (g_neg[..., None] * c_neg).sum(1)
    d_cp = g_pos[:, None] * w
    d_cn = g_neg[..., None] * w[:, None, :]
    return loss, d_w, d_cp, d_cn


def sgns_row_grads(w: torch.Tensor, c_pos: torch.Tensor, c_neg: torch.Tensor):
    """K3 on gathered float32 rows ``w``, ``c_pos`` ``(N, d)`` and ``c_neg``
    ``(N, K, d)`` (contiguous, one device). Returns ``(loss (N,), dW,
    dC_pos, dC_neg)`` — the per-pair loss, unreduced. CPU tensors run the
    plain version; CUDA tensors launch the kernel."""
    device = w.device
    N, d = w.shape
    K = c_neg.shape[1] if c_neg.dim() == 3 else -1
    if not 1 <= K <= MAX_NEGATIVES:
        raise ValueError(f"c_neg must be (N, K, d) with K in [1, {MAX_NEGATIVES}], "
                         f"got shape {tuple(c_neg.shape)}")
    _check(w, "w", torch.float32, (N, d), device)
    _check(c_pos, "c_pos", torch.float32, (N, d), device)
    _check(c_neg, "c_neg", torch.float32, (N, K, d), device)
    if device.type == "cpu":
        return sgns_row_grads_plain(w, c_pos, c_neg)
    _kernel_device(device)
    loss = torch.empty((N,), dtype=torch.float32, device=device)
    d_w = torch.empty_like(w)
    d_cp = torch.empty_like(c_pos)
    d_cn = torch.empty_like(c_neg)
    vec4 = int(d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (w, c_pos, c_neg)))
    fn = _entry("sgns_row_grads", "sgns_row_grads_launch")
    with torch.cuda.device(device):
        err = fn(_ptr(w), _ptr(c_pos), _ptr(c_neg), N, d, K, _ptr(loss), _ptr(d_w),
                 _ptr(d_cp), _ptr(d_cn), vec4, _stream(device))
    _raise_on(err, "sgns_row_grads")
    LAUNCHES["sgns_row_grads"] += 1
    return loss, d_w, d_cp, d_cn
