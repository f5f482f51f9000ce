"""The yardstick's counts: the least bytes and the model flops of one SGNS
step, and the H100's peaks.

Frozen copy of ``src/repro_torch/launch/roofline.py`` at commit
69e108eca3b3 (``unique_rows``, ``step_bytes``, ``sgns_model_flops``,
``PEAK_FLOPS``, ``HBM_BW``): NVIDIA's data sheet for the H100 SXM at 700 W,
dense, float32 outside the tensor cores.
"""

from __future__ import annotations

import torch

PEAK_FLOPS = 67e12          # float32 FLOP/s
HBM_BW = 3.35e12            # bytes/s


def unique_rows(ids: torch.Tensor) -> int:
    """Distinct rows per worker of ``ids`` ``(n, ...)``, summed over workers."""
    return sum(int(ids[w].unique().numel()) for w in range(ids.shape[0]))


def step_bytes(centers: torch.Tensor, contexts: torch.Tensor, ids: torch.Tensor,
               d: int) -> int:
    """The least bytes one SGNS step moves, whatever its schedule: each
    distinct row of each table read once and written once, the ids and the
    loss, the draw's table entries and seeds. ``centers``/``contexts``
    ``(n, B)``, ``ids`` ``(n, B, K)``."""
    n, B, K = ids.shape
    rows = unique_rows(centers) + unique_rows(torch.cat([contexts, ids.view(n, -1)], 1))
    return 2 * rows * d * 4 + n * B * (4 + 4 + 4) + n * B * K * 8 + n * 8


def sgns_model_flops(pairs: int, negatives: int, dim: int) -> float:
    """2 tables × (K + 1) dot products forward and backward:
    ``6 · pairs · (K + 1) · d``."""
    return 6.0 * pairs * (negatives + 1) * dim


def least_step_seconds(nbytes: float, flops: float) -> tuple[float, float, float]:
    """``(least, bytes term, flops term)`` seconds of a step at the peaks."""
    t_bytes, t_flops = nbytes / HBM_BW, flops / PEAK_FLOPS
    return max(t_bytes, t_flops), t_bytes, t_flops
