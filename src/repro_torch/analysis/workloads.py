"""The ``@zipf50k`` workload: the reference's skewed kernel shape.

The counterpart of ``repro.analysis.workloads``: one model of V = 50,000
rows of width 512, a batch of 8,192 pairs with power-law ids over the
frequency-sorted vocabulary, K = 5, blocks of 128 pairs (64 a step) and a
hot tier of 2,048 rows. Small blocks make hot rows recur across blocks;
the large batch spreads the hot tier's copy over 64 blocks. The ids are
bitwise the reference's: numpy draws from ``default_rng(11)``, the alias
noise table of counts ``p·1e6``, and the counter-hash draw under
``PRNGKey(3)``'s raw words.
"""

from __future__ import annotations

import numpy as np

ZIPF50K = {"V": 50_000, "D": 512, "B": 8192, "K": 5, "BLK": 128, "HOT": 2048}


def zipf50k_ids(device=None):
    """The workload's id streams for one worker, on ``device`` (the GPU
    unless ``"cpu"`` is asked for): ``(centers (1, B), contexts (1, B),
    negatives (1, B, K), noise table {"prob", "alias"} (1, V), seeds
    (1, 2))``."""
    from repro_torch import prng
    from repro_torch.data.pairs import build_noise_table
    from repro_torch.device import resolve_device
    from repro_torch.kernels.sgns_fused import sample_negatives, seed_tensor

    import torch

    dev = resolve_device(device)
    V, B, K = ZIPF50K["V"], ZIPF50K["B"], ZIPF50K["K"]
    rng = np.random.default_rng(11)
    p = 1.0 / np.arange(1, V + 1) ** 1.05
    p /= p.sum()
    c = rng.choice(V, size=B, p=p).astype(np.int32)
    x = rng.choice(V, size=B, p=p).astype(np.int32)
    table = {k: v.to(dev)[None].contiguous()
             for k, v in build_noise_table((p * 1e6).astype(np.float32),
                                           kind="alias").items()}
    seeds = seed_tensor(prng.PRNGKey(3)[None], dev)
    neg = sample_negatives(seeds, table["prob"], table["alias"], (B, K))
    to = lambda a: torch.from_numpy(a)[None].to(dev)
    return to(c), to(x), neg, table, seeds


def zipf50k_row_traffic(hot_rows: int, device=None) -> int:
    """Row transfers one step moves at this hot tier, by the planner on
    ``device``: 91,386 at ``hot_rows=0`` and 59,692 at 2,048."""
    from repro_torch.kernels.sgns_fused_pipe import plan_blocks, plan_row_traffic

    c, x, neg, _, _ = zipf50k_ids(device)
    plan = plan_blocks(c, x, neg, ZIPF50K["V"], ZIPF50K["BLK"], hot_rows=hot_rows)
    return plan_row_traffic(plan, hot_rows=hot_rows)
