"""The analysis tools behind K4b's and K7's designs: the pair-order counts
(``repro_torch.analysis.pair_conflicts``) against hand-made batches and a
brute-force count, and its batch source on a small corpus; the patches of
``repro_torch.analysis.kernel_variants`` against the kernels' sources."""

import itertools

import numpy as np
import pytest

from repro_torch.analysis.kernel_variants import VARIANTS, patched_source
from repro_torch.analysis.pair_conflicts import hbm_batches, pair_conflicts, summarize


def test_counts_of_a_hand_made_batch():
    # pair:      0  1  2  3  4
    cen = np.array([[0, 1, 0, 2, 3]])
    ctx = np.array([[5, 6, 7, 8, 6]])
    neg = np.array([[[9], [9], [10], [11], [12]]])
    c = pair_conflicts(cen, ctx, neg)
    assert c["pairs"] == 4
    # pair 1 meets pair 0 (negative 9); pair 2 meets pair 0 (center 0), not 1
    assert c["meet_prev"] == 1
    assert c["meet_prev2"] == 1
    assert c["meet_either"] == 2
    # runs: pair 0 alone (pair 1 shares its negative 9); pairs 1-3; pair 4,
    # whose context 6 is pair 1's
    assert c["runs"].tolist() == [1, 3, 1]


def _brute(cen, ctx, neg):
    n, B = cen.shape
    rows = lambda w, p: (cen[w, p], {ctx[w, p], *neg[w, p].tolist()})
    meets = lambda a, b: a[0] == b[0] or bool(a[1] & b[1])
    m1 = m2 = either = 0
    runs = []
    for w in range(n):
        for p in range(1, B):
            a = meets(rows(w, p), rows(w, p - 1))
            b = p >= 2 and meets(rows(w, p), rows(w, p - 2))
            m1, m2, either = m1 + a, m2 + b, either + (a or b)
        start = 0
        for p in range(B + 1):
            if p == B or any(meets(rows(w, p), rows(w, q)) for q in range(start, p)):
                runs.append(p - start)
                start = p
    return m1, m2, either, runs


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_counts_equal_a_brute_force_count(seed):
    rng = np.random.default_rng(seed)
    n, B, K, V = 3, 120, 5, 400
    cen = (rng.zipf(1.3, (n, B)) - 1) % V
    ctx = (rng.zipf(1.3, (n, B)) - 1) % V
    neg = (rng.zipf(1.3, (n, B, K)) - 1) % V
    c = pair_conflicts(cen, ctx, neg)
    m1, m2, either, runs = _brute(cen, ctx, neg)
    assert (c["meet_prev"], c["meet_prev2"], c["meet_either"]) == (m1, m2, either)
    assert c["runs"].tolist() == runs
    assert int(c["runs"].sum()) == n * B
    s = summarize([c, c])
    assert s["meet_prev"] == pytest.approx(m1 / (n * (B - 1)))
    assert s["runs"]["pairs_in_runs_of_at_least"]["2"] <= 1.0


def test_hbm_batches_are_the_trainers_shapes_and_draws():
    got = list(itertools.islice(hbm_batches(steps=2, num_workers=2, batch_size=64,
                                            vocab=1000, sentences=2000), 3))
    assert len(got) == 2
    for cen, ctx, ids in got:
        assert cen.shape == ctx.shape == (2, 64) and ids.shape == (2, 64, 5)
        assert ids.min() >= 0 and cen.min() >= 0
    assert not np.array_equal(got[0][2], got[1][2])      # a new draw each step


@pytest.mark.parametrize("lib, name", [(lib, name) for lib, v in VARIANTS.items()
                                       for name in v])
def test_kernel_variant_patches_apply(lib, name):
    """``analysis/kernel_variants.py`` times patched copies of K7, K4b, K3
    and K1 on the card; each patch must still find the code it changes."""
    text = patched_source(lib, name)
    assert "extern \"C\"" in text
