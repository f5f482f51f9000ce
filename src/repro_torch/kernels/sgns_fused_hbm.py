"""K4: the SGNS step as a chain of pair blocks (K4a) or in word2vec's
per-pair order (K4b) — CUDA kernels for Hopper, their plain torch
versions, and the wrapper that chooses.

Replaces the JAX package's ``_hbm_block_kernel`` and
``_hbm_sequential_kernel`` (``repro/kernels/sgns_fused_hbm.py``, engine
``pallas_fused_hbm``). Source: ``repro_torch/csrc/sgns_fused_hbm.cu``.
The TPU kernel exists to keep the ``(V, d)`` tables in HBM; on the H100
they are there anyway, and what this step adds over K2 is its
**semantics**:

* ``sequential=False`` — the batch is walked in blocks of ``block_pairs``
  pairs (a shorter tail block covers any remainder). Within a block,
  every gradient is taken from the tables as of block start, then applied
  as accumulating adds in reference order (W at centers; C at contexts,
  then at negatives). Block b+1 sees block b's writes. Equal to
  ``train_step_sparse`` once per block on the step's negatives; with one
  block, to one sparse step over the batch. On the card: one persistent
  launch a step for every worker, the sort of the touched rows inside it
  (:mod:`~repro_torch.kernels.sgns_block_step`, shared with K2).
* ``sequential=True`` — each pair's gradients are taken from the tables as
  every earlier pair left them, and applied at once: a loop of batch-1
  sparse steps: word2vec's exact order (one thread block cluster a worker
  on the card).

The negatives sit at the pairs' global counters
(:func:`block_negative_ids`), so one draw of the whole step's ``(n, B,
K)`` ids is the blocks' draws: on the card K4a's launch makes it itself,
and K4b takes K1's. The loss is the log-sigmoid form of
``sparse_row_grads_per_pair``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.sgns import train_step_sparse_
from repro_torch.kernels.sgns_block_step import run_block_step
from repro_torch.kernels.sgns_fused import (
    LAUNCHES, MAX_NEGATIVES, _check, _entry, _kernel_device, _ptr, _raise_on,
    _stream, alias_draw_from_counters, sample_negatives)


#: K4b's cluster of 8 CTAs holds at most 4 columns a thread, 128 threads a CTA.
SEQ_CLUSTER, SEQ_MAX_THREADS, SEQ_CHUNK = 8, 128, 256   # kSeqCluster, kSeqMaxThreads, kSeqChunk
MAX_SEQUENTIAL_DIM = SEQ_CLUSTER * SEQ_MAX_THREADS * 4


class SequentialShape(NamedTuple):
    """K4b's launch at one shape, as ``sgns_hbm_sequential_launch`` picks it."""

    km: int              # KM: the negatives the instantiation holds (5, 8 or 16)
    cpt: int             # CPT: columns a thread (1, 2 or 4)
    threads: int         # threads a CTA
    static_smem: int     # a CTA's partial-sum slots and the chunk's dot products
    dynamic_smem: int    # a chunk's staged ids and row comparisons (``Staged::bytes``)


def sequential_shape(d: int, B: int, K: int) -> SequentialShape:
    """K4b's instantiation and shared memory a CTA for ``(d, B, K)``."""
    km = 5 if K <= 5 else 8 if K <= 8 else 16
    per_cta = -(-d // SEQ_CLUSTER)
    threads = min(-(-per_cta // 32) * 32, SEQ_MAX_THREADS)
    cols = -(-per_cta // threads)
    cpt = 1 if cols == 1 else 2 if cols == 2 else 4
    warps = SEQ_MAX_THREADS // 32
    static = 4 * (2 * SEQ_CLUSTER * warps + SEQ_CHUNK) * (km + 1)
    dynamic = (min(B, SEQ_CHUNK) + 2) * ((km + 3) * 4 + 2 * (km + 1))
    return SequentialShape(km, cpt, threads, static, dynamic)


def pick_block_pairs(B: int, block_pairs: int) -> int:
    """The main block size: ``block_pairs`` clamped to the batch. A batch
    that is not a multiple gets one shorter *tail* block for the
    remainder — never a fall back to tiny blocks."""
    return max(1, min(int(block_pairs), B))


def block_negative_ids(seeds: torch.Tensor, prob: torch.Tensor,
                       alias: torch.Tensor, pair0: int, blk: int,
                       K: int) -> torch.Tensor:
    """The draw of one pair block ``[pair0, pair0 + blk)`` for every
    worker: ``(n, blk, K)`` ids at the pairs' global row-major counters,
    so the blocks' draws concatenate to the whole step's draw."""
    n = prob.shape[0]
    row = torch.arange(blk, dtype=torch.int64, device=prob.device)[:, None]
    col = torch.arange(K, dtype=torch.int64, device=prob.device)[None, :]
    base = ((pair0 + row) * K + col).expand(n, blk, K)
    return alias_draw_from_counters(seeds, prob, alias, base)


def sgns_fused_hbm_step_plain(params: dict, centers: torch.Tensor,
                              contexts: torch.Tensor, table: dict,
                              seeds: torch.Tensor, lr: float, *,
                              negatives: int = 5, block_pairs: int = 256,
                              sequential: bool = False):
    """The step K4 computes, in torch: the worker-batched sparse step once
    per pair block on that block's draw (``sequential=False``), or once
    per pair (``sequential=True``). Updates ``params`` in place; returns
    ``(params, loss (n, B), ids (n, B, K))``."""
    n, B = centers.shape
    K = negatives
    blk = 1 if sequential else pick_block_pairs(B, block_pairs)
    loss = torch.empty((n, B), dtype=torch.float32, device=params["W"].device)
    ids = []
    for b0 in range(0, B, blk):
        b1 = min(b0 + blk, B)
        ids_b = block_negative_ids(seeds, table["prob"], table["alias"], b0,
                                   b1 - b0, K)
        loss[:, b0:b1] = train_step_sparse_(params, centers[:, b0:b1],
                                            contexts[:, b0:b1], ids_b, lr)
        ids.append(ids_b)
    return params, loss, torch.cat(ids, dim=1)


@functools.lru_cache(maxsize=16)
def _block_offsets(B: int, K: int, blk: int, V: int, device: torch.device):
    """``block · V`` for each entry of a worker's W list ``(B,)`` and C list
    ``(B·(K+1),)`` (contexts, then each pair's K negatives): int32 where the
    keys fit, so the radix sorts take half the passes."""
    dtype = torch.int32 if -(-B // blk) * V < 2**31 else torch.int64
    off = (torch.arange(B, dtype=torch.int64, device=device) // blk * V).to(dtype)
    return off, torch.cat([off, off.repeat_interleave(K)])


def block_sorts(centers: torch.Tensor, contexts: torch.Tensor, ids: torch.Tensor,
                blk: int, V: int):
    """The block chains' apply lists (K5 and K6 on the card; K2's and K4a's
    launch sorts the same lists itself): each worker's touched
    rows of W (its centers) and of C (``concat(contexts, ids)``) sorted
    stably by (block of ``blk`` pairs, row). Returns ``(w_rows, w_perm,
    c_rows, c_perm)``: rows int32 and the index each came from, int64 — for
    W a pair index, for C an index into ``concat(contexts (B), ids (B·K))``.
    Block b's C entries are positions ``[b·blk·(K+1), (b·blk + nb)·(K+1))``,
    its W entries ``[b·blk, b·blk + nb)``; within a block each row's
    entries form one run in addend order."""
    n, B = centers.shape
    K = ids.shape[-1]
    off_w, off_c = _block_offsets(B, K, blk, V, centers.device)
    w_keys, w_perm = torch.sort(centers + off_w, dim=1, stable=True)
    c_keys, c_perm = torch.sort(torch.cat([contexts, ids.reshape(n, B * K)], 1) + off_c,
                                dim=1, stable=True)
    return (w_keys % V).to(torch.int32), w_perm, (c_keys % V).to(torch.int32), c_perm


def sgns_fused_hbm_step(params: dict, centers: torch.Tensor,
                        contexts: torch.Tensor, table: dict, seeds: torch.Tensor,
                        lr: float, *, negatives: int = 5, block_pairs: int = 256,
                        sequential: bool = False):
    """K4: one SGNS step for every worker, by pair blocks or pair by pair.
    ``params`` ``{"W", "C"}`` ``(n, V, d)`` float32 are updated **in
    place**; ``centers``/``contexts`` ``(n, B)`` int32 ids in ``[0, V)``
    (not bounds-checked; the trainer checks each chunk); ``table`` the
    stacked ``{"prob", "alias"}`` alias tables; ``seeds`` ``(n, 2)``;
    ``lr`` the step's learning rate.

    Returns ``(params, loss (n, B), ids (n, B, K))``.
    """
    W, C = params["W"], params["C"]
    device = W.device
    n, V, d = W.shape
    B = centers.shape[-1]
    K = int(negatives)
    if not 1 <= K <= MAX_NEGATIVES:
        raise ValueError(f"negatives must be in [1, {MAX_NEGATIVES}], got {K}")
    if int(block_pairs) < 1:
        raise ValueError(f"block_pairs must be >= 1, got {block_pairs}")
    _check(W, "W", torch.float32, (n, V, d), device)
    _check(C, "C", torch.float32, (n, V, d), device)
    _check(centers, "centers", torch.int32, (n, B), device)
    _check(contexts, "contexts", torch.int32, (n, B), device)
    _check(table["prob"], "prob", torch.float32, (n, V), device)
    _check(table["alias"], "alias", torch.int32, (n, V), device)
    _check(seeds, "seeds", torch.int32, (n, 2), device)
    if device.type == "cpu":
        return sgns_fused_hbm_step_plain(params, centers, contexts, table, seeds, lr,
                                         negatives=K, block_pairs=block_pairs,
                                         sequential=sequential)
    _kernel_device(device)
    if sequential and d > MAX_SEQUENTIAL_DIM:
        raise ValueError(f"the sequential kernel takes d <= {MAX_SEQUENTIAL_DIM}, got {d}")
    if sequential:
        ids = sample_negatives(seeds, table["prob"], table["alias"], (B, K))
        loss = torch.empty((n, B), dtype=torch.float32, device=device)
        fn = _entry("sgns_fused_hbm", "sgns_hbm_sequential_launch")
        with torch.cuda.device(device):
            err = fn(_ptr(W), _ptr(C), _ptr(centers), _ptr(contexts), _ptr(ids), n, V,
                     d, B, K, -float(np.float32(lr)), _ptr(loss), _stream(device))
        _raise_on(err, "sgns_fused_hbm_step (sequential)")
        LAUNCHES["sgns_fused_hbm_step"] += 1
        return params, loss, ids
    loss, ids = run_block_step("sgns_fused_hbm", "sgns_hbm_chain_launch", "sgns_fused_hbm_step",
                               params, centers, contexts, table, seeds, lr,
                               pick_block_pairs(B, block_pairs), K)
    return params, loss, ids
