"""K6: K5's block chain with a hot tier of the frequency-sorted tables —
the CUDA kernel's wrapper and its plain torch version.

Replaces the JAX package's ``_tiered_kernel`` (``repro/kernels/
sgns_fused_tiered.py``, engine ``pallas_fused_tiered``). Source:
``repro_torch/csrc/sgns_fused_tiered.cu`` (+ ``sgns_pipe.cuh``). Vocab ids
are sorted by descending frequency, so the ``kH`` hottest rows are the id
prefix. The reference keeps a copy of rows ``[0, kH)`` of each table
resident for the step and runs K5's ring over the rest. On the card K6 is
K5's launch with L2 cache hints: loads and stores of ids ``< kH`` ask the
L2 to keep those rows (``evict_last``), the others to drop theirs first,
and the step's hot rows go back to normal priority at its end. Each row
sees the same addends in the same order on either tier, so the result is
K5's — and K4a's — bit for bit, at every ``hot_rows``. ``kH =
clamp(hot_rows, 0, V)``; ``kH == 0`` is K5.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.sgns_fused_pipe import (
    NUM_SLOTS, chain_step, check_step_args, plan_blocks, run_plan_plain,
    sgns_fused_pipe_step)


def sgns_fused_tiered_step_plain(params: dict, centers: torch.Tensor,
                                 contexts: torch.Tensor, table: dict,
                                 seeds: torch.Tensor, lr: float, *,
                                 negatives: int = 5, block_pairs: int = 256,
                                 hot_rows: int = 256, ring_depth: int = NUM_SLOTS):
    """The step K6 computes, in torch: the reference's two paths — a hot
    copy of rows ``[0, kH)`` with a spill row at ``kH``, and K5's cold
    buffers — over the plan at ``hot_rows=kH`` (:func:`~repro_torch.kernels
    .sgns_fused_pipe.run_plan_plain`). Updates ``params`` in place; returns
    ``(params, loss (n, B), ids (n, B, K))``."""
    from repro_torch.kernels.sgns_fused import sample_negatives_plain

    V = params["W"].shape[1]
    kH = max(0, min(int(hot_rows), V))
    B = centers.shape[1]
    ids = sample_negatives_plain(seeds, table["prob"], table["alias"], (B, negatives))
    plan = plan_blocks(centers, contexts, ids, V, block_pairs, hot_rows=kH,
                       ring_depth=ring_depth)
    return params, run_plan_plain(params, plan, lr, B, hot_rows=kH), ids


def sgns_fused_tiered_step(params: dict, centers: torch.Tensor,
                           contexts: torch.Tensor, table: dict, seeds: torch.Tensor,
                           lr: float, *, negatives: int = 5, block_pairs: int = 256,
                           hot_rows: int = 256, ring_depth: int = NUM_SLOTS):
    """K6: one SGNS step for every worker, K5's chain with the hot tier's
    L2 policy: K1's draw, K4a's two block sorts and one launch on the
    card. Arguments and return as
    :func:`~repro_torch.kernels.sgns_fused_pipe.sgns_fused_pipe_step`, plus
    ``hot_rows`` (clamped to ``[0, V]``; 0 runs K5)."""
    check_step_args(params, centers, contexts, table, seeds, negatives, block_pairs,
                    ring_depth)
    V = params["W"].shape[1]
    kH = max(0, min(int(hot_rows), V))
    kw = dict(negatives=int(negatives), block_pairs=block_pairs, ring_depth=ring_depth)
    if kH == 0:
        return sgns_fused_pipe_step(params, centers, contexts, table, seeds, lr, **kw)
    device = params["W"].device
    if device.type == "cpu":
        return sgns_fused_tiered_step_plain(params, centers, contexts, table, seeds, lr,
                                            hot_rows=kH, **kw)
    return params, *chain_step(params, centers, contexts, table, seeds, lr,
                               negatives=int(negatives), block_pairs=block_pairs,
                               hot_rows=kH)
