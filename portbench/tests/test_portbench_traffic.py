"""The traffic comes from the seed alone: the same seed gives the same
inputs, another seed other inputs of the same shapes."""

from __future__ import annotations

import numpy as np
import torch

from conftest import TINY_CONFIG, TINY_TRAFFIC
from portbench.drives.merge import train_submodels
from portbench.drives.train import _checked_pairs, make_inputs, seeds_of

BIG = 2**31 + 99


def _same(a, b) -> bool:
    return all(np.array_equal(getattr(a, k), getattr(b, k))
               for k in ("centers", "contexts", "init_key", "check_keys", "chunk_key",
                         "window_keys")) and all(np.array_equal(a.table[k], b.table[k])
                                                 for k in a.table)


def test_same_seed_same_training_inputs():
    for name in ("fused", "rowgrad"):
        a = make_inputs(TINY_CONFIG, TINY_TRAFFIC[name], BIG)
        b = make_inputs(TINY_CONFIG, TINY_TRAFFIC[name], BIG)
        assert _same(a, b)
        c = make_inputs(TINY_CONFIG, TINY_TRAFFIC[name], BIG + 1)
        assert not _same(a, c)
        assert c.centers.shape == a.centers.shape and c.n == a.n and c.d == a.d


def test_pool_rows_all_differ_between_the_checked_steps():
    a = make_inputs(TINY_CONFIG, TINY_TRAFFIC["fused"], BIG)
    centers, _ = _checked_pairs(a)
    assert centers.shape[1] == 3 + a.steps_per_chunk
    for i in range(centers.shape[1] - 1):
        assert not np.array_equal(centers[:, i], centers[:, i + 1])
    assert len({tuple(k) for k in a.window_keys[:64]}) == 64


def test_same_seed_same_submodels():
    m1, k1 = train_submodels(TINY_CONFIG, TINY_TRAFFIC["alir"], BIG, torch.device("cpu"))
    m2, k2 = train_submodels(TINY_CONFIG, TINY_TRAFFIC["alir"], BIG, torch.device("cpu"))
    assert torch.equal(m1, m2) and torch.equal(k1, k2)
    assert not bool(k1.all())            # the random division leaves words out


def test_seeds_take_more_than_32_bits():
    assert seeds_of(2**40 + 1, 3) != seeds_of(1, 3)
    assert seeds_of(BIG, 4)[:2] == seeds_of(BIG, 2)
