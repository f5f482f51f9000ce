"""K3: the SGNS forward and row gradients on gathered rows — a CUDA kernel
for Hopper, its plain torch version, and the wrapper that chooses.

Replaces the JAX package's ``_sgns_kernel`` (``repro/kernels/sgns_update.py``,
the ``pallas`` engine's row-gradient kernel). Source:
``repro_torch/csrc/sgns_row_grads.cu``. Per pair, on rows ``w``, ``c_pos``
``(d,)`` and ``c_neg`` ``(K, d)``::

    s_pos = w·c_pos,  s_k = w·c_k
    loss  = softplus(−s_pos) + Σ_k softplus(s_k)
    g_pos = σ(s_pos) − 1,  g_k = σ(s_k)
    dW = g_pos·c_pos + Σ_k g_k·c_k,  dC_pos = g_pos·w,  dC_k = g_k·w

These are the gradients of the *sum* loss (word2vec's update semantics).
The reference pads d to 128 lanes and the batch to its VMEM block; both
are TPU artifacts and are not carried over: the kernel takes any ``N``
pairs and any d.

On the card, persistent CTAs walk tiles of ``TILE_PAIRS`` consecutive
pairs; a producer warp copies each tile's three spans (``w``, ``c_pos``,
``c_neg``) into a ring of ``STAGES`` shared-memory stages, by one bulk copy
a span where its address and size are 16-byte multiples and by 4-byte
copies where not, and one warp a pair computes every output from the
staged rows. What the CPU can check of that lies here:
:func:`ring_shape` (the stage layout) and :func:`tile_plan` (which CTA
takes which tile, and how each span is copied).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.sgns_fused import (
    LAUNCHES, MAX_NEGATIVES, _check, _entry, _kernel_device, _ptr, _raise_on,
    _softplus, _stream)


TILE_PAIRS = 8             # pairs a tile (kTilePairs): one consumer warp each
STAGES = 2                 # ring stages (kStages)
BAR_BYTES = 128            # the ring's mbarriers, ahead of its stages
SMEM_OPTIN = 232_448       # shared memory a CTA may have on an H100 (227 KB)


def _align(x: int, a: int) -> int:
    return -(-x // a) * a


class Ring(NamedTuple):
    tile: int            # pairs a stage; 0: rows too long to stage (read in place)
    cp_off: int          # byte offset of the c_pos tile in a stage
    cn_off: int          # byte offset of the c_neg tile
    stage_bytes: int     # a stage's stride
    smem_bytes: int      # dynamic shared memory a CTA


def ring_shape(d: int, K: int, smem_optin: int = SMEM_OPTIN) -> Ring:
    """The stage layout, as the launch computes it: the largest tile of at
    most ``TILE_PAIRS`` pairs whose ``STAGES`` stages fit ``smem_optin``
    bytes; each of a stage's w, c_pos and c_neg tiles starts 16-byte
    aligned, and stages 128 bytes apart."""
    for t in range(TILE_PAIRS, 0, -1):
        row_tile = _align(4 * t * d, 16)
        stage = _align(2 * row_tile + 4 * t * K * d, 128)
        smem = BAR_BYTES + STAGES * stage
        if smem <= smem_optin:
            return Ring(t, row_tile, 2 * row_tile, stage, smem)
    return Ring(0, 0, 0, 0, 0)


class Span(NamedTuple):
    first: int           # the span's first float in its tensor
    count: int           # floats
    bulk: bool           # one bulk copy (else 4-byte copies)


def tile_plan(N: int, d: int, K: int, ctas: int, ptrs=(0, 0, 0), tile: int | None = None):
    """The ring kernel's schedule: ``[(cta, p0, pairs, (w, c_pos, c_neg)
    spans)]`` in each CTA's order, CTA by CTA. Tile t covers pairs ``[t
    tile, (t + 1) tile)`` (the last one shorter) and goes to CTA t mod
    ``ctas``; a span is one bulk copy iff its address (``ptrs``: the
    tensors' data pointers) and its size are 16-byte multiples."""
    P = ring_shape(d, K).tile if tile is None else tile
    ntiles = -(-N // P)
    plan = []
    for cta in range(ctas):
        for t in range(cta, ntiles, ctas):
            p0 = t * P
            r = min(P, N - p0)
            spans = []
            for ptr, per in zip(ptrs, (d, d, K * d)):
                first, count = p0 * per, r * per
                spans.append(Span(first, count, (ptr + 4 * first) % 16 == 0 and count % 4 == 0))
            plan.append((cta, p0, r, tuple(spans)))
    return plan


def column_stride(w: torch.Tensor, c_pos: torch.Tensor, c_neg: torch.Tensor) -> int:
    """Columns a lane takes at a time: 4 (16-byte loads) when d % 4 == 0
    and every input is 16-byte aligned, else 1. It fixes the order of the
    per-lane partial sums, so it is the first design's rule."""
    ok = w.shape[-1] % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (w, c_pos, c_neg))
    return 4 if ok else 1


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
    vec4 = int(column_stride(w, c_pos, c_neg) == 4)
    fn = _entry("sgns_row_grads", "sgns_row_grads_launch")
    with torch.cuda.device(device):
        err = fn(_ptr(w), _ptr(c_pos), _ptr(c_neg), N, d, K, _ptr(loss), _ptr(d_w),
                 _ptr(d_cp), _ptr(d_cn), vec4, _stream(device))
    _raise_on(err, "sgns_row_grads")
    LAUNCHES["sgns_row_grads"] += 1
    return loss, d_w, d_cp, d_cn
