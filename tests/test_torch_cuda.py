"""The port's CUDA kernels against their plain versions on the GPU.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
test, never at import). Run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.analysis.contracts import engine_matrix
from repro_torch.core.distributions import build_alias_table
from repro_torch.kernels import sgns_fused as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _table(V, n, device):
    p = np.arange(1, V + 1, dtype=np.float64) ** -1.0
    prob, alias = build_alias_table(p / p.sum())
    return {"prob": torch.tensor(prob, dtype=torch.float32, device=device).expand(n, V)
            .contiguous(),
            "alias": torch.tensor(alias, dtype=torch.int32, device=device).expand(n, V)
            .contiguous()}


def _seeds(n, seed, device):
    return K.seed_tensor(prng.split(prng.PRNGKey(seed), n), device)


@pytest.mark.parametrize("shape", ((1024, 5), (333,)))
def test_sample_negatives_kernel_bitwise(device, shape):
    t = _table(20_000, 3, device)
    before = K.LAUNCHES["sample_negatives"]
    ids = K.sample_negatives(_seeds(3, 0, device), t["prob"], t["alias"], shape)
    assert K.LAUNCHES["sample_negatives"] == before + 1
    ref = K.sample_negatives_plain(_seeds(3, 0, device), t["prob"], t["alias"], shape)
    assert torch.equal(ids, ref)


@pytest.mark.parametrize("d", (48, 50))          # 16-byte path and scalar path
def test_sgns_fused_step_kernel_matches_plain_and_repeats(device, d):
    n, V, B, negatives = 2, 5000, 256, 5
    t = _table(V, n, device)
    gen = torch.Generator(device=device).manual_seed(0)
    W = 0.1 * torch.randn((n, V, d), generator=gen, device=device)
    C = 0.1 * torch.randn((n, V, d), generator=gen, device=device)
    cen = K.sample_negatives_plain(_seeds(n, 1, device), t["prob"], t["alias"], (B,))
    ctx = K.sample_negatives_plain(_seeds(n, 2, device), t["prob"], t["alias"], (B,))
    seeds = _seeds(n, 3, device)
    outs = []
    for _ in range(2):
        p = {"W": W.clone(), "C": C.clone()}
        outs.append(K.sgns_fused_step(p, cen, ctx, t, seeds, 0.05, negatives=negatives))
    plain = K.sgns_fused_step_plain({"W": W.clone(), "C": C.clone()}, cen, ctx, t, seeds,
                                    0.05, negatives=negatives)
    (p1, l1, i1), (p2, l2, i2) = outs
    assert torch.equal(i1, plain[2])
    for k in ("W", "C"):
        assert torch.equal(p1[k], p2[k])               # deterministic
        assert float((p1[k] - plain[0][k]).abs().max()) <= 1e-5
    assert torch.equal(l1, l2)
    assert float((l1 - plain[1]).abs().max()) <= 1e-4


# The kernels below against their plain versions on the card. K3's outputs
# are per-pair (no accumulation): the two differ only in the dot products'
# summation order, a few ulps of O(0.1) values. K4 accumulates duplicate
# rows; its plain version reduces the dot products in another order and
# carries the difference through every later update, hence K2's tolerances.
@pytest.mark.parametrize("d", (48, 50))          # 16-byte path and scalar path
def test_sgns_row_grads_kernel_matches_plain(device, d):
    from repro_torch.kernels import sgns_update as U

    gen = torch.Generator(device=device).manual_seed(0)
    N, negatives = 777, 5
    w = 0.3 * torch.randn((N, d), generator=gen, device=device)
    cp = 0.3 * torch.randn((N, d), generator=gen, device=device)
    cn = 0.3 * torch.randn((N, negatives, d), generator=gen, device=device)
    before = K.LAUNCHES["sgns_row_grads"]
    out = U.sgns_row_grads(w, cp, cn)
    assert K.LAUNCHES["sgns_row_grads"] == before + 1
    plain = U.sgns_row_grads_plain(w, cp, cn)
    for o, p in zip(out, plain):
        assert o.shape == p.shape
        assert float((o - p).abs().max()) <= 1e-5


# K3, the ring kernel: against its plain version at the 16-byte and scalar
# paths' widths and the random path's (d = 48, 50, 500) and at N = 1, 7 (a
# tail tile of 3 pairs: 4-byte copies at d = 50) and 10,240 (the random
# path's n·B); run twice, bitwise; and bitwise its first design
# (kernel_variants' `first`, built from the checkout's sources): the same
# column stride, warp butterfly and rounding tree.
@pytest.fixture(scope="module")
def k3_first():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.analysis import kernel_variants as KV
    from repro_torch.kernels import build

    out = build.build_dir().parent / "kernel_variants"
    return KV.build_variants(out, {"sgns_row_grads": ["first"]})[("sgns_row_grads", "first")]


def _k3_check(device, first, w, cp, cn):
    from repro_torch.analysis import kernel_variants as KV
    from repro_torch.kernels import build
    from repro_torch.kernels import sgns_update as U

    before = K.LAUNCHES["sgns_row_grads"]
    out = U.sgns_row_grads(w, cp, cn)
    again = U.sgns_row_grads(w, cp, cn)
    assert K.LAUNCHES["sgns_row_grads"] == before + 2
    KV.use("sgns_row_grads", first)
    try:
        old = U.sgns_row_grads(w, cp, cn)
    finally:
        KV.use("sgns_row_grads", build.library_path("sgns_row_grads"))
    plain = U.sgns_row_grads_plain(w, cp, cn)
    torch.cuda.synchronize(device)
    for o, a, f, p, tol in zip(out, again, old, plain, (1e-4, 1e-5, 1e-5, 1e-5)):
        assert o.shape == p.shape and bool(torch.isfinite(o).all())
        assert torch.equal(o, a) and torch.equal(o, f)
        assert float((o - p).abs().max()) <= tol


@pytest.mark.parametrize("N", (1, 7, 10_240))
@pytest.mark.parametrize("d", (48, 50, 500))
def test_sgns_row_grads_ring_matches_plain_and_the_first_design(device, k3_first, d, N):
    gen = torch.Generator(device=device).manual_seed(d + N)
    w = 0.3 * torch.randn((N, d), generator=gen, device=device)
    cp = 0.3 * torch.randn((N, d), generator=gen, device=device)
    cn = 0.3 * torch.randn((N, 5, d), generator=gen, device=device)
    _k3_check(device, k3_first, w, cp, cn)


@pytest.mark.parametrize("which", ("w", "c_neg"))
@pytest.mark.parametrize("d", (48, 500))
def test_sgns_row_grads_ring_takes_misaligned_inputs(device, k3_first, d, which):
    """An input one float into its storage: its spans go by 4-byte copies
    and the column stride is the scalar one, as in the first design."""
    gen = torch.Generator(device=device).manual_seed(d)
    N = 1_003
    shapes = {"w": (N, d), "c_pos": (N, d), "c_neg": (N, 5, d)}
    t = {}
    for name, shape in shapes.items():
        if name == which:
            storage = 0.3 * torch.randn(int(np.prod(shape)) + 1, generator=gen, device=device)
            t[name] = storage[1:].view(shape)
            assert t[name].data_ptr() % 16 == 4
        else:
            t[name] = 0.3 * torch.randn(shape, generator=gen, device=device)
    _k3_check(device, k3_first, t["w"], t["c_pos"], t["c_neg"])


def _hbm_inputs(device, d, n=2, V=5000, B=300):
    t = _table(V, n, device)
    gen = torch.Generator(device=device).manual_seed(1)
    W = 0.1 * torch.randn((n, V, d), generator=gen, device=device)
    C = 0.1 * torch.randn((n, V, d), generator=gen, device=device)
    cen = K.sample_negatives_plain(_seeds(n, 1, device), t["prob"], t["alias"], (B,))
    ctx = K.sample_negatives_plain(_seeds(n, 2, device), t["prob"], t["alias"], (B,))
    return W, C, cen, ctx, t, _seeds(n, 3, device)


@pytest.mark.parametrize("sequential", (False, True), ids=("blocks", "sequential"))
@pytest.mark.parametrize("d", (48, 50))
def test_sgns_fused_hbm_kernel_matches_plain_and_repeats(device, d, sequential):
    """B = 300 with block_pairs = 128: two full blocks and a tail of 44."""
    from repro_torch.kernels import sgns_fused_hbm as H

    W, C, cen, ctx, t, seeds = _hbm_inputs(device, d)
    kw = dict(negatives=5, block_pairs=128, sequential=sequential)
    outs = []
    for _ in range(2):
        before = K.LAUNCHES["sgns_fused_hbm_step"]
        p = {"W": W.clone(), "C": C.clone()}
        outs.append(H.sgns_fused_hbm_step(p, cen, ctx, t, seeds, 0.05, **kw))
        assert K.LAUNCHES["sgns_fused_hbm_step"] == before + 1
    plain = H.sgns_fused_hbm_step_plain({"W": W.clone(), "C": C.clone()}, cen, ctx, t,
                                        seeds, 0.05, **kw)
    (p1, l1, i1), (p2, l2, i2) = outs
    assert torch.equal(i1, plain[2])
    for k in ("W", "C"):
        assert torch.equal(p1[k], p2[k])               # deterministic
        assert float((p1[k] - plain[0][k]).abs().max()) <= 1e-5
        assert float((p1[k] - (W if k == "W" else C)).abs().max()) > 0
    assert torch.equal(l1, l2)
    assert float((l1 - plain[1]).abs().max()) <= 1e-4


@pytest.mark.parametrize("step", ("K2", "K4a"))
def test_block_step_draws_inside_its_launch(device, step):
    """K2 and K4a draw the step's negatives inside their one launch: K1's
    count does not move, and the ids they return are K1's bit for bit,
    each worker from its own table (three Zipf exponents) and seed."""
    from repro_torch.kernels import sgns_fused_hbm as H

    n, V, B = 3, 5000, 300
    W, C, cen, ctx, _, seeds = _hbm_inputs(device, 48, n=n, V=V, B=B)
    tables = [build_alias_table(p / p.sum()) for p in
              (np.arange(1, V + 1, dtype=np.float64) ** -a for a in (0.6, 1.0, 1.4))]
    t = {"prob": torch.tensor(np.stack([x[0] for x in tables]), dtype=torch.float32,
                              device=device),
         "alias": torch.tensor(np.stack([x[1] for x in tables]), dtype=torch.int32,
                               device=device)}
    counter = "sgns_fused_step" if step == "K2" else "sgns_fused_hbm_step"
    before = dict(K.LAUNCHES)
    p = {"W": W.clone(), "C": C.clone()}
    if step == "K2":
        _, _, ids = K.sgns_fused_step(p, cen, ctx, t, seeds, 0.05, negatives=5)
    else:
        _, _, ids = H.sgns_fused_hbm_step(p, cen, ctx, t, seeds, 0.05, negatives=5,
                                          block_pairs=128)
    assert K.LAUNCHES[counter] == before[counter] + 1
    assert K.LAUNCHES["sample_negatives"] == before["sample_negatives"]
    k1 = K.sample_negatives(seeds, t["prob"], t["alias"], (B, 5))
    torch.cuda.synchronize(device)
    assert ids.shape == (n, B, 5) and torch.equal(ids, k1)
    assert not torch.equal(ids[0], ids[2])


def test_sgns_fused_hbm_one_block_equals_the_fused_step(device):
    """block_pairs >= B: the same sort, the same two phases as K2; only
    the loss form differs (log-sigmoid), so the tables are bitwise K2's."""
    from repro_torch.kernels import sgns_fused_hbm as H

    W, C, cen, ctx, t, seeds = _hbm_inputs(device, 48)
    ph, lh, ih = H.sgns_fused_hbm_step({"W": W.clone(), "C": C.clone()}, cen, ctx, t,
                                       seeds, 0.05, negatives=5, block_pairs=10_000)
    pf, lf, i_f = K.sgns_fused_step({"W": W.clone(), "C": C.clone()}, cen, ctx, t, seeds,
                                    0.05, negatives=5)
    assert torch.equal(ih, i_f)
    for k in ("W", "C"):
        assert torch.equal(ph[k], pf[k])
    assert float((lh - lf).abs().max()) <= 1e-5


# K5 and K6 against K4a: the same draw, the same pair body, the same addends
# in the same order per row, so the tables and the loss are bitwise K4a's at
# the same block size, at every ring depth and hot tier; against their plain
# versions within K2's tolerances. Cases: the 16-byte and scalar paths (d =
# 48, 50) and the main path's width (d = 500); n = 40 workers, more than the
# card's groups of at least 8 CTAs (264 CTAs: 33 groups); one block (blk >=
# B); and a vocabulary of 1,000 rows under Zipf(1), whose hottest rows run
# past 32 addends in a block of 256 pairs, so their applies follow a run
# across fetches and over every column chunk.
CHAIN_CASES = {
    "d48": dict(d=48, n=3, V=5000, B=300, blk=128),
    "d50": dict(d=50, n=3, V=5000, B=300, blk=128),
    "d500": dict(d=500, n=2, V=5000, B=300, blk=128),
    "n40": dict(d=48, n=40, V=2000, B=200, blk=64),
    "one-block": dict(d=48, n=3, V=5000, B=300, blk=512),
    "zipf-runs": dict(d=500, n=2, V=1000, B=1024, blk=256),
}


def _check_chain(device, case, **dial):
    """K4a's whole call, then the K5/K6 wrapper twice (one launch each,
    bitwise K4a's and each other), its plain version within K2's
    tolerances, and the launch alone on fixed block sorts bitwise too."""
    from repro_torch.kernels import sgns_fused_hbm as H
    from repro_torch.kernels import sgns_fused_pipe as P
    from repro_torch.kernels import sgns_fused_tiered as T

    c = CHAIN_CASES[case]
    W, C, cen, ctx, t, seeds = _hbm_inputs(device, c["d"], n=c["n"], V=c["V"], B=c["B"])
    kw = dict(negatives=5, block_pairs=c["blk"])
    ph, lh, ih = H.sgns_fused_hbm_step({"W": W.clone(), "C": C.clone()}, cen, ctx, t, seeds,
                                       0.05, **kw)
    hot = dial.get("hot_rows", 0)
    step, plain_step = ((T.sgns_fused_tiered_step, T.sgns_fused_tiered_step_plain) if hot
                        else (P.sgns_fused_pipe_step, P.sgns_fused_pipe_step_plain))
    counter = "sgns_fused_tiered_step" if hot else "sgns_fused_pipe_step"
    outs = []
    for _ in range(2):
        before = K.LAUNCHES[counter]
        outs.append(step({"W": W.clone(), "C": C.clone()}, cen, ctx, t, seeds, 0.05,
                         **kw, **dial))
        assert K.LAUNCHES[counter] == before + 1
    plain = plain_step({"W": W.clone(), "C": C.clone()}, cen, ctx, t, seeds, 0.05, **kw,
                       **dial)
    (p1, l1, i1), (p2, l2, i2) = outs
    assert torch.equal(i1, ih) and torch.equal(i1, plain[2]) and torch.equal(i1, i2)
    assert torch.equal(l1, lh) and torch.equal(l1, l2)
    for k in ("W", "C"):
        assert torch.equal(p1[k], ph[k]) and torch.equal(p1[k], p2[k])
        assert float((p1[k] - plain[0][k]).abs().max()) <= 1e-5
        assert float((p1[k] - (W if k == "W" else C)).abs().max()) > 0
    assert float((l1 - plain[1]).abs().max()) <= 1e-4
    blk = H.pick_block_pairs(c["B"], c["blk"])
    runs = H.block_sorts(cen, ctx, i1, blk, c["V"])
    p3 = {"W": W.clone(), "C": C.clone()}
    l3 = P.run_chain(p3, cen, ctx, i1, runs, 0.05, blk, hot_rows=min(hot, c["V"]))
    assert torch.equal(l3, lh)
    for k in ("W", "C"):
        assert torch.equal(p3[k], ph[k])
    return runs


@pytest.mark.parametrize("ring_depth", (2, 3))
@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_sgns_fused_pipe_kernel_bitwise_equals_hbm(device, case, ring_depth):
    runs = _check_chain(device, case, ring_depth=ring_depth)
    if case == "zipf-runs":       # the case is what it says: C runs past 32 addends
        c_keys = runs[2]
        _, counts = torch.unique_consecutive(c_keys[0, :c_keys.shape[1] // 4],
                                             return_counts=True)
        assert int(counts.max()) > 32


@pytest.mark.parametrize("hot_rows", (1, 256, "V"))
@pytest.mark.parametrize("case", ("d48", "d50", "d500", "zipf-runs"))
def test_sgns_fused_tiered_kernel_bitwise_equals_hbm(device, case, hot_rows):
    hot = CHAIN_CASES[case]["V"] if hot_rows == "V" else hot_rows
    _check_chain(device, case, hot_rows=hot)


def test_sgns_fused_tiered_with_no_hot_rows_runs_k5(device):
    from repro_torch.kernels import sgns_fused_tiered as T

    W, C, cen, ctx, t, seeds = _hbm_inputs(device, 48)
    before = dict(K.LAUNCHES)
    T.sgns_fused_tiered_step({"W": W.clone(), "C": C.clone()}, cen, ctx, t, seeds, 0.05,
                             negatives=5, block_pairs=128, hot_rows=0)
    assert K.LAUNCHES["sgns_fused_pipe_step"] == before["sgns_fused_pipe_step"] + 1
    assert K.LAUNCHES["sgns_fused_tiered_step"] == before["sgns_fused_tiered_step"]


# K2 and K4a, one launch a step (csrc/sgns_block_step.cuh): each run twice
# (bitwise), against its plain version within K2's tolerances, K4a bitwise
# K5 at the same block size, and K2 == K4a (blk >= B) == K5 (blk = B)
# bitwise; the launch's own sort bitwise block_sorts, and its apply items
# the rule's (sgns_block_step.apply_items). Cases: the 16-byte and scalar
# paths (d = 48, 50) and the main path's width (d = 500), each with a tail
# block; n = 40 workers, more than the card's groups; a vocabulary of 8
# rows, whose runs all pass the split threshold (narrow chunks); a batch
# whose C list (24,576 keys) is sorted in global scratch, not shared
# memory; and a vocabulary of a million rows, whose 20-bit rows take five
# 4-bit radix passes (block count * V stays far below 2**31: the sort is by
# row within each (block, table) list; the CPU test of block_sorts covers
# keys of 64 bits).
BLOCK_CASES = {
    "d48": dict(d=48, n=3, V=5000, B=300, blk=128),
    "d50": dict(d=50, n=3, V=5000, B=300, blk=128),
    "d500": dict(d=500, n=2, V=5000, B=300, blk=128),
    "n40": dict(d=48, n=40, V=2000, B=200, blk=64),
    "vocab8": dict(d=500, n=2, V=8, B=300, blk=128),
    "global-sort": dict(d=48, n=2, V=5000, B=4096, blk=4096),
    "vocab1m": dict(d=48, n=1, V=1_000_000, B=1024, blk=256),
}


def _twice(step, counter, W, C, *args, **kw):
    """Two runs of ``step`` from clones of the same tables, one launch each;
    bitwise equal to each other."""
    outs = []
    for _ in range(2):
        before = K.LAUNCHES[counter]
        outs.append(step({"W": W.clone(), "C": C.clone()}, *args, **kw))
        assert K.LAUNCHES[counter] == before + 1
    (p1, l1, i1), (p2, l2, i2) = outs
    assert torch.equal(l1, l2) and torch.equal(i1, i2)
    for k in ("W", "C"):
        assert torch.equal(p1[k], p2[k])
    return outs[0]


def _same(a, b):
    return (torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
            and all(torch.equal(a[0][k], b[0][k]) for k in ("W", "C")))


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_step_kernels_match_plain_repeat_and_agree(device, case):
    from repro_torch.kernels import sgns_block_step as BS
    from repro_torch.kernels import sgns_fused_hbm as H
    from repro_torch.kernels import sgns_fused_pipe as P

    c = BLOCK_CASES[case]
    W, C, cen, ctx, t, seeds = _hbm_inputs(device, c["d"], n=c["n"], V=c["V"], B=c["B"])
    args = (cen, ctx, t, seeds, 0.05)
    k2 = _twice(K.sgns_fused_step, "sgns_fused_step", W, C, *args, negatives=5)
    k4 = _twice(H.sgns_fused_hbm_step, "sgns_fused_hbm_step", W, C, *args, negatives=5,
                block_pairs=c["blk"])
    for got, plain in ((k2, K.sgns_fused_step_plain({"W": W.clone(), "C": C.clone()}, *args,
                                                    negatives=5)),
                       (k4, H.sgns_fused_hbm_step_plain({"W": W.clone(), "C": C.clone()},
                                                        *args, negatives=5,
                                                        block_pairs=c["blk"]))):
        assert torch.equal(got[2], plain[2])
        assert float((got[1] - plain[1]).abs().max()) <= 1e-4
        for k in ("W", "C"):
            assert float((got[0][k] - plain[0][k]).abs().max()) <= 1e-5
            assert float((got[0][k] - (W if k == "W" else C)).abs().max()) > 0
    k5 = P.sgns_fused_pipe_step({"W": W.clone(), "C": C.clone()}, *args, negatives=5,
                                block_pairs=c["blk"])
    assert _same(k4, k5)
    one = H.sgns_fused_hbm_step({"W": W.clone(), "C": C.clone()}, *args, negatives=5,
                                block_pairs=c["B"])
    k5_one = P.sgns_fused_pipe_step({"W": W.clone(), "C": C.clone()}, *args, negatives=5,
                                    block_pairs=c["B"])
    assert _same(k2, one) and _same(k2, k5_one)
    # the launch's sort and items, against block_sorts and the item rule
    blk = H.pick_block_pairs(c["B"], c["blk"])
    _, ids, lists, items, n_items = BS.run_block_step(
        "sgns_fused_hbm", "sgns_hbm_chain_launch", "sgns_fused_hbm_step",
        {"W": W.clone(), "C": C.clone()}, cen, ctx, t, seeds, 0.05, blk, 5, scratch=True)
    torch.cuda.synchronize(device)
    assert torch.equal(ids, k4[2])
    for got, want in zip(lists, H.block_sorts(cen, ctx, k4[2], blk, c["V"])):
        assert torch.equal(got, want)
    vec4 = c["d"] % 4 == 0
    c_rows, w_rows = lists[2].cpu().numpy(), lists[0].cpu().numpy()
    longest = 0
    for w in range(c["n"]):
        for b in range(-(-c["B"] // blk)):
            nb = min(blk, c["B"] - b * blk)
            for tab, rows, s0, N in ((0, c_rows, b * blk * 6, nb * 6), (1, w_rows, b * blk, nb)):
                want = BS.apply_items(rows[w, s0:s0 + N], c["d"], vec4, s0=s0)
                m = int(n_items[w, b, tab])
                np.testing.assert_array_equal(items[w, b, tab, :m].cpu().numpy(), want)
                longest = max(longest, int(want[:, 1].max()))
    if case == "vocab8":          # the case is what it says: runs past the threshold
        assert longest >= BS.SPLIT_RUNS


# K7 against its plain version: float32 reductions over the window in
# another order (split across CTAs and warps, tiles of a few rows, merged
# partials), so a few ulps of O(0.1) outputs; bfloat16 outputs round to 8
# bits (the JAX test's 3e-2). Cases: the decode path's h2o-danube-1.8b
# shape (32 query heads over 8 KV heads, D = 80, W = 4096, chunk 512), a
# JAX test shape (H = Hkv), rows of 2·50 elements with a ragged last tile
# (D = 50, chunk 96), one KV head for eight query heads, and 16 KV heads
# (two a warp).
SWA_CASES = {"danube": (4, 4096, 32, 8, 80, 512), "jax": (2, 256, 4, 4, 64, 64),
             "scalar": (1, 192, 6, 2, 50, 96), "mqa": (3, 128, 8, 1, 128, 128),
             "kv16": (2, 512, 32, 16, 64, 128)}


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("case", sorted(SWA_CASES))
def test_swa_decode_kernel_matches_plain(device, case, dtype):
    from repro_torch.kernels import swa_decode as S

    B, W, H, Hkv, D, chunk = SWA_CASES[case]
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    q = (0.5 * torch.randn((B, H, D), generator=gen, device=device)).to(dt)
    k = (0.5 * torch.randn((B, W, Hkv, D), generator=gen, device=device)).to(dt)
    v = (0.5 * torch.randn((B, W, Hkv, D), generator=gen, device=device)).to(dt)
    before = K.LAUNCHES["swa_decode"]
    out = S.swa_decode(q, k, v, chunk=chunk)
    assert K.LAUNCHES["swa_decode"] == before + 1
    ref = S.swa_decode_plain(q, k, v, chunk=chunk)
    torch.cuda.synchronize(device)
    assert out.dtype == dt and out.shape == (B, H, D)
    assert bool(torch.isfinite(out.float()).all())
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert float((out.float() - ref.float()).abs().max()) <= tol


def test_swa_decode_kernel_refuses_what_it_does_not_take(device):
    from repro_torch.kernels import swa_decode as S

    q = torch.zeros((1, 8, 512), device=device)
    kv = torch.zeros((1, 64, 1, 512), device=device)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        S.swa_decode(q, kv, kv, chunk=48)
    with pytest.raises(ValueError, match="exceeds the kernel"):
        S.swa_decode(q, kv, kv, chunk=64)


def _swa_inputs(device, B, W, H, Hkv, D, dt, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = (0.5 * torch.randn((B, H, D), generator=gen, device=device)).to(dt)
    k = (0.5 * torch.randn((B, W, Hkv, D), generator=gen, device=device)).to(dt)
    v = (0.5 * torch.randn((B, W, Hkv, D), generator=gen, device=device)).to(dt)
    return q, k, v


# K7 at the widths of the decode models (D = 64, 80, 128) and group sizes
# H / Hkv = 1, 4 and 8 (8 KV heads: a warp each; 2 KV heads: four warps
# share one), and a window of one row a CTA; each case run twice.
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("rep", (1, 4, 8))
@pytest.mark.parametrize("D", (64, 80, 128))
def test_swa_decode_kernel_widths_and_groups_repeat(device, D, rep, dtype):
    from repro_torch.kernels import swa_decode as S

    Hkv = 2 if rep == 8 else 8
    B, W, H = 2, 1024, rep * Hkv
    dt = getattr(torch, dtype)
    q, k, v = _swa_inputs(device, B, W, H, Hkv, D, dt)
    before = K.LAUNCHES["swa_decode"]
    out = S.swa_decode(q, k, v, chunk=256)
    again = S.swa_decode(q, k, v, chunk=256)
    assert K.LAUNCHES["swa_decode"] == before + 2
    ref = S.swa_decode_plain(q, k, v, chunk=256)
    torch.cuda.synchronize(device)
    assert torch.equal(out, again)                        # fixed merge order
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_swa_decode_kernel_window_of_one_tile(device, dtype):
    from repro_torch.kernels import swa_decode as S

    dt = getattr(torch, dtype)
    q, k, v = _swa_inputs(device, 3, 8, 32, 8, 80, dt, seed=1)
    out = S.swa_decode(q, k, v, chunk=8)
    again = S.swa_decode(q, k, v, chunk=8)
    ref = S.swa_decode_plain(q, k, v, chunk=8)
    torch.cuda.synchronize(device)
    assert torch.equal(out, again)
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert float((out.float() - ref.float()).abs().max()) <= tol


# K4b (sequential) against its plain per-pair loop, and twice bitwise: the
# 16-byte and scalar widths and the main path's (d = 48, 50, 500); n = 40
# workers (40 clusters of 8 CTAs, several to an SM); and a vocabulary of 8
# rows, where a pair's context is also one of its negatives and negatives
# repeat, so the kernel's forwarding inside a pair and from pair to pair
# is exercised.
SEQ_CASES = {"d48": dict(d=48, n=2, V=5000, B=300), "d50": dict(d=50, n=2, V=5000, B=300),
             "d500": dict(d=500, n=2, V=5000, B=300),
             "n40": dict(d=48, n=40, V=2000, B=200),
             "collide": dict(d=50, n=3, V=8, B=300)}


@pytest.mark.parametrize("case", sorted(SEQ_CASES))
def test_sgns_sequential_kernel_cases_match_plain_and_repeat(device, case):
    from repro_torch.kernels import sgns_fused_hbm as H

    c = SEQ_CASES[case]
    W, C, cen, ctx, t, seeds = _hbm_inputs(device, c["d"], n=c["n"], V=c["V"], B=c["B"])
    kw = dict(negatives=5, sequential=True)
    outs = []
    for _ in range(2):
        before = K.LAUNCHES["sgns_fused_hbm_step"]
        outs.append(H.sgns_fused_hbm_step({"W": W.clone(), "C": C.clone()}, cen, ctx, t,
                                          seeds, 0.05, **kw))
        assert K.LAUNCHES["sgns_fused_hbm_step"] == before + 1
    plain = H.sgns_fused_hbm_step_plain({"W": W.clone(), "C": C.clone()}, cen, ctx, t,
                                        seeds, 0.05, **kw)
    (p1, l1, i1), (p2, l2, i2) = outs
    assert torch.equal(i1, plain[2]) and torch.equal(i1, i2)
    if case == "collide":       # the case is what it says
        assert bool((i1 == ctx[..., None].long()).any())
        srt = i1.sort(dim=-1).values
        assert bool((srt[..., 1:] == srt[..., :-1]).any())
    for k in ("W", "C"):
        assert torch.equal(p1[k], p2[k])
        assert float((p1[k] - plain[0][k]).abs().max()) <= 1e-5
    assert torch.equal(l1, l2)
    assert float((l1 - plain[1]).abs().max()) <= 1e-4


# The sparse-step engines' scatters on the card: the ordered apply adds
# each row's duplicates in pair order (sgns.ordered_add_), bitwise the
# CPU's serial index_add_ on the same addends; one step of dense, sparse
# and rowgrad, run twice from the same state on batches with duplicate
# rows drawn by the random phase's CDF sampler, repeats bit for bit and
# stays within K2's tolerances of the same step on the CPU.
@pytest.mark.parametrize("d", (48, 50, 500))
def test_ordered_add_is_the_cpus_serial_index_add(device, d):
    from repro_torch.core.sgns import ordered_add_

    rng = np.random.default_rng(d)
    V, N = 300, 4000
    rows = torch.from_numpy((rng.zipf(1.3, N) - 1) % V)
    table = torch.from_numpy(rng.standard_normal((V, d)).astype(np.float32))
    add = torch.from_numpy(rng.standard_normal((N, d)).astype(np.float32))
    assert int(torch.bincount(rows).max()) > 100
    ref = table.clone().index_add_(0, rows, add)
    got = ordered_add_(table.to(device), rows.to(device), add.to(device))
    assert torch.equal(got.cpu(), ref)


def _sparse_step_case(name, params, cen, ctx, negs, lr):
    from repro_torch.core import sgns
    from repro_torch.kernels.sgns_update import sgns_row_grads

    if name == "dense":
        return sgns.train_step_dense_(params, cen, ctx, negs, lr)
    grads = sgns_row_grads if name == "rowgrad" else sgns.sparse_row_grads_per_pair
    return sgns.train_step_sparse_(params, cen, ctx, negs, lr, row_grads=grads)


@pytest.mark.parametrize("d", (48, 500))
@pytest.mark.parametrize("name", ("dense", "sparse", "rowgrad"))
def test_sparse_engines_repeat_bitwise_on_the_card(device, name, d):
    from repro_torch.core.engine import get_engine
    from repro_torch.data.pairs import build_noise_table

    n, V, B, negatives = 3, 2000, 512, 5
    rng = np.random.default_rng(5)
    counts = (1e6 / np.arange(1, V + 1)).astype(np.float32)
    cdf = build_noise_table(counts, kind="cdf").to(device).expand(n, V).contiguous()
    cen = torch.from_numpy(((rng.zipf(1.2, (n, B)) - 1) % V).astype(np.int32)).to(device)
    ctx = torch.from_numpy(((rng.zipf(1.2, (n, B)) - 1) % V).astype(np.int32)).to(device)
    negs = get_engine(f"{name}:cdf").sample(cdf, _seeds(n, 4, device), (B, negatives))
    W = torch.from_numpy((0.1 * rng.standard_normal((n, V, d))).astype(np.float32))
    C = torch.from_numpy((0.1 * rng.standard_normal((n, V, d))).astype(np.float32))
    assert int(torch.bincount(negs[0].reshape(-1).cpu()).max()) > 1
    runs = []
    for _ in range(2):
        p = {"W": W.to(device), "C": C.to(device)}
        runs.append((p, _sparse_step_case(name, p, cen, ctx, negs, 0.05)))
    p_cpu = {"W": W.clone(), "C": C.clone()}
    l_cpu = _sparse_step_case(name, p_cpu, cen.cpu(), ctx.cpu(), negs.cpu(), 0.05)
    (p1, l1), (p2, l2) = runs
    torch.cuda.synchronize(device)
    assert torch.equal(l1, l2)
    assert float((l1.cpu() - l_cpu).abs().max()) <= 1e-4
    for k in ("W", "C"):
        assert torch.equal(p1[k], p2[k])
        assert float((p1[k].cpu() - p_cpu[k]).abs().max()) <= 1e-5
        assert float((p1[k].cpu() - (W if k == "W" else C)).abs().max()) > 0


# The main path's done criterion on the card: the configuration of
# tests/test_system.py::test_full_pipeline_learns_semantics (1,000 words,
# 10,000 sentences, 4 workers, d = 48, 5 epochs) through the port's
# run_pipeline with K2 (fused) and with K5 (fused_pipe), held to that
# test's four conditions.
@pytest.mark.parametrize("engine", ("fused", "fused_pipe"))
def test_port_pipeline_learns_semantics_on_the_card(device, engine):
    from repro_torch.core import driver
    from repro_torch.core.sgns import SGNSConfig
    from repro_torch.data.corpus import SemanticCorpusModel
    from repro_torch.eval.benchmarks import BenchmarkSuite, evaluate_all

    gen = SemanticCorpusModel.create(vocab_size=1000, seed=0)
    corpus = gen.generate(num_sentences=10_000, seed=1)
    suite = BenchmarkSuite.from_model(gen, top_words=700)
    cfg = SGNSConfig(vocab_size=0, dim=48, window=5, negatives=5)
    K.reset_launch_counts()
    res = driver.run_pipeline(corpus, 1000, strategy="shuffle", num_workers=4, cfg=cfg,
                              epochs=5, batch_size=512, window=5, max_vocab=None,
                              merge_methods=("alir_pca", "average"), device=device,
                              engine=engine)
    kernel = "sgns_fused_step" if engine == "fused" else "sgns_fused_pipe_step"
    assert K.LAUNCHES[kernel] == 5 * res.timings["steps_per_epoch"] > 0
    emb, valid = res.merged["alir_pca"]
    s = evaluate_all(emb, valid, res.union_vocab, suite)
    emb_a, valid_a = res.merged["average"]
    s_avg = evaluate_all(emb_a, valid_a, res.union_vocab, suite)
    print(f"{engine}: alir_pca {s}, average {s_avg}, epoch losses {res.losses}")
    assert s["similarity"] > 0.05, s
    assert s["categorization"] > 0.15, s     # 16 topics → chance ≈ 0.10
    assert res.losses[-1] < res.losses[0] * 0.8
    assert s["similarity"] >= s_avg["similarity"] - 0.02


# This slice's paths on the card: the fused engines' draw outside a step
# (K1, which the sync baseline runs once a step), the periodic sync (one
# K2 launch a local step for all workers), and the merges' bitwise claims.
@pytest.mark.parametrize("name", ("fused", "fused_hbm", "fused_pipe", "fused_tiered"))
def test_fused_engine_sample_is_k1(device, name):
    from repro_torch.core.engine import get_engine

    t = _table(20_000, 2, device)
    before = dict(K.LAUNCHES)
    ids = get_engine(name).sample(t, _seeds(2, 4, device), (1024, 5))
    assert K.LAUNCHES["sample_negatives"] == before["sample_negatives"] + 1
    assert {k: v for k, v in K.LAUNCHES.items() if k != "sample_negatives"} == {
        k: v for k, v in before.items() if k != "sample_negatives"}
    ref = K.sample_negatives_plain(_seeds(2, 4, device), t["prob"], t["alias"], (1024, 5))
    assert torch.equal(ids, ref)


def _sync_world(device, V=3000, d=48, B=96, outer=3, every=2):
    gen = torch.Generator(device=device).manual_seed(7)
    params = {"W": (torch.rand((V, d), generator=gen, device=device) - 0.5) / d,
              "C": 0.02 * torch.randn((V, d), generator=gen, device=device)}
    t = _table(V, 1, device)
    table = {k: v[0] for k, v in t.items()}
    cen = K.sample_negatives_plain(_seeds(1, 1, device), t["prob"], t["alias"],
                                   (outer, every, B))[0]
    ctx = K.sample_negatives_plain(_seeds(1, 2, device), t["prob"], t["alias"],
                                   (outer, every, B))[0]
    return params, table, cen, ctx


@pytest.mark.parametrize("n", (1, 3))
def test_periodic_sync_is_the_hand_loop_on_the_card(device, n):
    from repro_torch.core.async_trainer import make_periodic_sync_epoch
    from repro_torch.core.sgns import SGNSConfig, linear_lr, worker_mean

    params, table, cen, ctx = _sync_world(device)
    outer, every, B = cen.shape
    cfg = SGNSConfig(vocab_size=params["W"].shape[0], dim=params["W"].shape[1], negatives=5)
    key = prng.PRNGKey(3)
    K.reset_launch_counts()
    got, losses = make_periodic_sync_epoch(cfg, table, 12, sync_every=every, num_workers=n,
                                           engine="fused", device=device)(
        {k: v.clone() for k, v in params.items()}, cen, ctx, key, 1)
    assert K.LAUNCHES["sgns_fused_step"] == outer * every
    assert K.LAUNCHES["sample_negatives"] == 0
    tab = {k: v.expand(n, -1).contiguous() for k, v in table.items()}
    seeds = K.seed_tensor(prng.step_keys(key, outer * every), device)
    for step, tol in ((K.sgns_fused_step, 0.0), (K.sgns_fused_step_plain, 1e-5)):
        stacked = {k: v.repeat(n, 1, 1) for k, v in params.items()}
        hand = torch.empty((outer, every), device=device)
        for o in range(outer):
            for j in range(every):
                i = o * every + j
                _, loss, _ = step(stacked, cen[o, j].reshape(n, -1).contiguous(),
                                  ctx[o, j].reshape(n, -1).contiguous(), tab,
                                  seeds[i].expand(n, 2).contiguous(),
                                  float(linear_lr(1 + i, 12, cfg)), negatives=5)
                hand[o, j] = worker_mean(loss).mean()
            means = {k: t.mean(dim=0) for k, t in stacked.items()}
            for k, t in stacked.items():
                t.copy_(means[k].expand_as(t))
        for k in ("W", "C"):
            assert float((got[k] - means[k]).abs().max()) <= tol
        assert float((losses - hand).abs().max()) <= 10 * tol
    assert float((got["W"] - params["W"]).abs().max()) > 0


def _merge_world(device, V=2000, d=32, n=5):
    gen = torch.Generator(device=device).manual_seed(1)
    Y = torch.randn((V, d), generator=gen, device=device)
    models, masks = [], []
    for i in range(n):
        q, _ = torch.linalg.qr(torch.randn((d, d), generator=gen, device=device))
        mask = torch.rand(V, generator=gen, device=device) > (0.0 if i == 0 else 0.2)
        mask[: d + 2] = True
        models.append((Y @ q) * mask[:, None])
        masks.append(mask)
    return models, masks


@pytest.mark.parametrize("name", ("alir", "alir_tree"))
def test_merges_are_arrival_order_invariant_on_the_card(device, name):
    from repro_torch.core.merge import StackedModels, get_merger

    models, masks = _merge_world(device)
    stacked = StackedModels(models=torch.stack(models), mask=torch.stack(masks))
    batch = get_merger(name, max_iters=6, device=device).merge(stacked)
    again = get_merger(name, max_iters=6, device=device).merge(stacked)
    assert torch.equal(batch.emb, again.emb)
    for order in ((4, 0, 3, 1, 2), (2, 4, 1, 0, 3)):
        m = get_merger(name, max_iters=6, device=device)
        for w in order:
            m.add(w, models[w], masks[w], fold=(name == "alir" and w == order[2]))
        final = m.final()
        assert final.worker_ids == tuple(range(5))
        assert final.emb.device.type == "cuda"
        for k in ("emb", "valid", "transforms"):
            assert torch.equal(getattr(final, k), getattr(batch, k)), k


# Served reconstructions against reconstruct_missing on the card: cuBLAS
# picks other kernels for an (m, d) @ (d, d) product than for the batched
# (n, V, d) @ (n, d, d) one, so the sums run in other orders.
SERVE_REC_ATOL = 1e-5


@pytest.mark.parametrize("d", (32, 500))
def test_store_gather_and_reconstruction_on_the_card(device, tmp_path, d):
    """The device store's gathers: merged and present rows bitwise the
    published tables, absent rows within SERVE_REC_ATOL of
    ``reconstruct_missing`` on the card, one batch mixing the spaces."""
    import asyncio

    from repro_torch.core.merge import StackedModels, reconstruct_missing
    from repro_torch.serve import EmbeddingServer, ServeConfig, publish_incremental
    from repro_torch.serve.publish import submodel_arrivals

    models, masks = _merge_world(device, V=3000, d=d, n=4)
    stacked = StackedModels(models=torch.stack(models), mask=torch.stack(masks))
    _, final = publish_incremental(submodel_arrivals(stacked), str(tmp_path),
                                   publish_every=4, device=device)
    rec = reconstruct_missing(stacked, final.emb)
    srv = EmbeddingServer(str(tmp_path), ServeConfig(coalesce_ms=0.5), device=device)
    t = srv.store.table
    assert all(x.device.type == "cuda" for x in (t.emb, t.valid, t.mask, t.transforms,
                                                  t.models))
    rows = np.random.default_rng(0).permutation(3000)[:700]

    async def go():
        return [await srv.embed_rows(rows, submodel=w) for w in (None, 0, 1, 2, 3)]

    merged, *subs = asyncio.run(go())
    assert merged["found"].all()
    np.testing.assert_array_equal(merged["vectors"], final.emb[rows].cpu().numpy())
    mask = stacked.mask.cpu().numpy()
    for w, out in enumerate(subs):
        present = mask[w, rows]
        got, want = out["vectors"], rec[w, rows].cpu().numpy()
        np.testing.assert_array_equal(got[present], stacked.models[w, rows].cpu().numpy()
                                      [present])
        assert (~present).any() == (w > 0)              # worker 0 holds every row
        assert float(np.abs(got - want).max()) <= SERVE_REC_ATOL
    keys = [(-1, 5), (1, 5), (2, 7), (-1, 9)]
    out = srv._gather(keys)
    np.testing.assert_array_equal(out[(-1, 9)], final.emb[9].cpu().numpy())
    assert all(v.dtype == np.float32 and v.shape == (d,) for v in out.values())


def test_server_hot_reload_and_pinned_store_on_the_card(device, tmp_path):
    import asyncio

    from repro_torch.core.merge import StackedModels, get_merger
    from repro_torch.serve import (ArtifactStore, EmbeddingServer, publish_incremental)
    from repro_torch.serve.publish import submodel_arrivals

    models, masks = _merge_world(device, V=1000, d=16, n=4)
    stacked = StackedModels(models=torch.stack(models), mask=torch.stack(masks))
    arrivals = list(submodel_arrivals(stacked))
    merger = get_merger("alir", device=device)
    publish_incremental(arrivals[:2], str(tmp_path), merger=merger, publish_every=2,
                        final_cold_fold=False)
    srv = EmbeddingServer(str(tmp_path), device=device)
    pinned = ArtifactStore(str(tmp_path), version=1, device=device)
    asyncio.run(srv.embed_rows(np.arange(100)))
    assert len(srv.cache) == 100
    _, final = publish_incremental(arrivals[2:], str(tmp_path), merger=merger,
                                   publish_every=2)
    assert srv.refresh() and srv.store.version == 2 and len(srv.cache) == 0
    assert not pinned.refresh() and pinned.version == 1
    out = asyncio.run(srv.embed_rows(np.arange(1000)))
    np.testing.assert_array_equal(out["vectors"], final.emb.cpu().numpy())


# Elastic training on the card: a kill and a resume land on the
# uninterrupted elastic run's bits (K2 on shuffle, K3 on random), each
# kernel launched once per step trained; and every engine × sampler makes
# no collective over a chunk (no c10d:: op, no NCCL kernel) with its
# tables updated in place.
def _small_elastic_setup(engine, strategy):
    from repro_torch.core.driver import prepare_training
    from repro_torch.core.sgns import SGNSConfig
    from repro_torch.data.corpus import SemanticCorpusModel

    corpus = SemanticCorpusModel.create(vocab_size=3000, seed=0).generate(4000, seed=1)
    return prepare_training(corpus, 3000, strategy, 4,
                            SGNSConfig(vocab_size=0, dim=48, negatives=5), epochs=2,
                            batch_size=128, rate=0.5, max_steps_per_epoch=8,
                            steps_per_chunk=2, subsample_t=None, engine=engine)


@pytest.mark.parametrize("engine,strategy,kernel", [("fused", "shuffle", "sgns_fused_step"),
                                                    ("rowgrad", "random", "sgns_row_grads")])
def test_elastic_kill_resume_is_bitwise_on_the_card(device, tmp_path, engine, strategy,
                                                    kernel):
    from repro_torch.elastic import (ElasticRunner, FaultEvent, FaultSchedule,
                                     WorkerStateStore, simulate_elastic)

    setup = _small_elastic_setup(engine, strategy)
    total = setup.sched.total_steps
    K.reset_launch_counts()
    base = ElasticRunner(setup, WorkerStateStore(str(tmp_path / "base")),
                         device=device).run_all()
    assert K.LAUNCHES[kernel] == 4 * total and K.LAUNCHES["sample_negatives"] == 0
    for name, faults, steal in (
            ("restart", FaultSchedule((FaultEvent("kill", 0, 3),
                                       FaultEvent("restart", 0, 5))), None),
            ("steal", FaultSchedule((FaultEvent("kill", 1, 2),)), 1)):
        r = ElasticRunner(setup, WorkerStateStore(str(tmp_path / name)), ckpt_every=3,
                          device=device)
        K.reset_launch_counts()
        sim = simulate_elastic(r, 2, faults, steal_after=steal)
        assert sim.unfinished == [] and bool(sim.stolen) == (steal is not None)
        assert K.LAUNCHES[kernel] >= 4 * total
        for w in range(4):
            for k in ("W", "C"):
                np.testing.assert_array_equal(sim.params[w][k], base[w][k],
                                              err_msg=f"{name} worker {w} {k}")


@pytest.mark.parametrize("engine", engine_matrix(5000),
                         ids=lambda e: e.describe() + ("-seq" if getattr(e, "sequential",
                                                                          False) else ""))
def test_every_engine_is_collective_free_and_in_place_on_the_card(device, engine):
    from repro_torch.analysis.contracts import certify_engine_contracts

    rep = certify_engine_contracts(engine, vocab_size=5000, dim=48, negatives=5, steps=2,
                                   batch=256, num_workers=2, device=device)
    assert rep.device_kernels > 0 and rep.in_place.tables_in_place == 2


@pytest.mark.parametrize("d", (48, 50, 500))
@pytest.mark.parametrize("spec", ("rowgrad", "fused", "fused_hbm", "fused_pipe", "fused_tiered",
                                  "fused_hbm:sequential"))
def test_vmem_estimate_is_what_the_card_reports(device, spec, d):
    """One step of the engine at d = 48, 50 (the 4-byte paths) and 500, then
    ``cudaFuncGetAttributes`` of every instantiation it launched: static and
    dynamic shared memory equal to ``analysis/vmem.py``'s estimate."""
    from repro_torch.analysis import vmem
    from repro_torch.core.async_trainer import AsyncShardTrainer
    from repro_torch.core.engine import get_engine
    from repro_torch.core.sgns import SGNSConfig
    from repro_torch.data.pairs import stack_noise_tables

    eng = (get_engine("fused_hbm", sequential=True) if spec == "fused_hbm:sequential"
           else get_engine(spec))
    V, B = 2000, 512
    tr = AsyncShardTrainer(cfg=SGNSConfig(vocab_size=V, dim=d, negatives=5), num_workers=1,
                           total_steps=2, engine=eng, device=device)
    params = tr.init(prng.PRNGKey(0))
    table = tr.device_table(stack_noise_tables([np.arange(V, 0, -1)], kind=eng.table_kind))
    rng = np.random.default_rng(d)
    c, x = (rng.integers(0, V, (1, 1, B), dtype=np.int32) for _ in range(2))
    tr.epoch(params, c, x, table, prng.PRNGKey(1))
    torch.cuda.synchronize(device)
    rows = vmem.card_check(vmem.check_vmem_budget(eng, vocab_size=V, dim=d, negatives=5,
                                                  batch=B))
    assert rows and all(r["match"] for r in rows), rows


def test_multiproc_ranks_on_one_card_choose_gloo(device):
    from repro_torch.launch.mesh import worker_backend

    assert worker_backend(device, 1) == "nccl"
    assert worker_backend(device, torch.cuda.device_count() + 1) == "gloo"
    assert worker_backend("cpu", 2) == "gloo"


@pytest.mark.parametrize("arch", ("smollm-360m", "h2o-danube-1.8b"))
def test_lm_train_step_on_the_card_matches_the_cpu_and_repeats(device, arch):
    """One training step of a reduced LM from one converted init: the card's
    loss within rtol 1e-5 of the CPU's and each gradient within 1e-3 of its
    largest |g| (matmul and reduction order); with SGD the parameters after
    the step within atol 1e-5; the AdamW step run twice on the card
    bitwise (h2o-danube's S = 48 runs past its window of 32)."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.optim import get_optimizer
    from repro_torch.tree import tree_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    init = convert.to_jax_model_params(Model(cfg, prng.PRNGKey(0), device="cpu"))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 48), dtype=np.int32)

    def run(dev, opt):
        model = convert.from_jax_model_params(cfg, init, device=dev)
        t = torch.from_numpy(toks).to(dev)
        batch = {"tokens": t, "labels": t}
        names, params = zip(*model.named_parameters())
        model.requires_grad_(True)
        grads = torch.autograd.grad(model.loss_fn(batch), params)
        grads = tree_paths(convert.to_jax_opt_state(model.param_tree(dict(zip(names, grads)))))
        with torch.no_grad():
            state = opt.init(model.param_tree())
        _, loss = model.make_train_step(opt)(state, batch, 0)
        return float(loss), grads, tree_paths(convert.to_jax_model_params(model))

    sgd = get_optimizer("sgd", lr=0.1)
    card, cpu = run(device, sgd), run("cpu", sgd)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5)
    for path, g in cpu[1].items():
        assert np.abs(card[1][path] - g).max() <= 1e-3 * np.abs(g).max(), path
        np.testing.assert_allclose(card[2][path], cpu[2][path], rtol=0, atol=1e-5, err_msg=path)
    adamw = get_optimizer("adamw", lr=3e-3)
    a, b = run(device, adamw), run(device, adamw)
    assert a[0] == b[0]
    for path in a[2]:
        assert np.array_equal(a[1][path], b[1][path]) and np.array_equal(a[2][path], b[2][path])


ZOO_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b",
             "xlstm-1.3b", "qwen2-vl-7b", "seamless-m4t-large-v2")


@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_zoo_train_step_on_the_card_matches_the_cpu_and_repeats(device, arch):
    """The slice-14 archs (reduced) from one converted init, with their
    patch embeddings or frames: one step's loss within rtol 1e-5 of the
    CPU's and each gradient within 1e-3 of its largest |g|; with SGD the
    parameters after the step within 1e-5 (xlstm-1.3b 2e-4: its
    recurrences grow a last-ulp difference), scaled by max(1, max |p|);
    a step with ``cfg.train_optimizer`` run twice on the card bitwise (the
    MoE dispatch and combine take no float atomics)."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.optim import get_optimizer
    from repro_torch.tree import tree_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    init = convert.to_jax_model_params(Model(cfg, prng.PRNGKey(0), device="cpu"))
    rng = np.random.default_rng(0)
    np_b = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24), dtype=np.int32)}
    np_b["labels"] = np_b["tokens"]
    if cfg.frontend == "vision":
        np_b["patch_embeds"] = rng.standard_normal((2, cfg.frontend_tokens, cfg.d_model),
                                                   dtype=np.float32)
    if cfg.encoder_layers:
        np_b["frames"] = rng.standard_normal((2, 24, cfg.d_model), dtype=np.float32)

    def run(dev, opt):
        model = convert.from_jax_model_params(cfg, init, device=dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in np_b.items()}
        names, params = zip(*model.named_parameters())
        model.requires_grad_(True)
        grads = torch.autograd.grad(model.loss_fn(batch), params)
        grads = tree_paths(convert.to_jax_opt_state(model.param_tree(dict(zip(names, grads)))))
        with torch.no_grad():
            state = opt.init(model.param_tree())
        _, loss = model.make_train_step(opt)(state, batch, 0)
        return float(loss), grads, tree_paths(convert.to_jax_model_params(model))

    tol = 2e-4 if arch == "xlstm-1.3b" else 1e-5
    sgd = get_optimizer("sgd", lr=0.1)
    card, cpu = run(device, sgd), run("cpu", sgd)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5)
    for path, g in cpu[1].items():
        assert np.abs(card[1][path] - g).max() <= 1e-3 * np.abs(g).max(), path
        scale = max(1.0, float(np.abs(cpu[2][path]).max()))
        np.testing.assert_allclose(card[2][path], cpu[2][path], rtol=0, atol=tol * scale,
                                   err_msg=path)
    opt = get_optimizer(cfg.train_optimizer, lr=3e-3)
    a, b = run(device, opt), run(device, opt)
    assert a[0] == b[0]
    for path in a[2]:
        assert np.array_equal(a[1][path], b[1][path]) and np.array_equal(a[2][path], b[2][path])


# ---------------------------------------------------------------------------
# The LLM sharding layer on the card: the smoke mesh and the cost model
# ---------------------------------------------------------------------------
@pytest.fixture
def smoke_mesh(device):
    """``make_smoke_mesh()`` on the card (an NCCL group of one), gone after
    the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    mesh = make_smoke_mesh(device)
    yield mesh
    dist.destroy_process_group()


def _first_module_that_differs(arch, device, mesh) -> str:
    """One loss of the reduced ``arch`` from the same init on the card, with
    and without the mesh: the first module (in call order) whose output is
    not bitwise the mesh-less one's, or "none"."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import shard_for_training
    from repro_torch.models import Model
    from repro_torch.optim import get_optimizer
    from repro_torch.sharding import ctx as shctx
    from repro_torch.sharding.rules import tree_data_specs, with_sharding

    cfg = get_config(arch).reduced()
    t = torch.randint(0, cfg.vocab_size, (4, 32), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(0)).to(device)
    outs = []
    for sharded in (False, True):
        model = Model(cfg, prng.PRNGKey(0), device=device)
        seen = []
        for name, mod in model.named_modules():
            mod.register_forward_hook(
                lambda m, a, o, name=name: seen.append(
                    (name, o if isinstance(o, torch.Tensor) else None)))
        batch = {"tokens": t, "labels": t}
        if sharded:
            shard_for_training(model, get_optimizer("sgd").init(model.param_tree()), mesh)
            batch = with_sharding(batch, tree_data_specs(batch, mesh), mesh)
            with torch.no_grad(), shctx.use_mesh_constraints(mesh):
                model.loss_fn(batch)
            seen = [(n, o.full_tensor() if hasattr(o, "full_tensor") else o) for n, o in seen]
        else:
            with torch.no_grad():
                model.loss_fn(batch)
        outs.append(seen)
    for (name, a), (_, b) in zip(*outs):
        if a is not None and not torch.equal(a, b):
            return name
    return "none"


@pytest.mark.parametrize("arch", ("smollm-360m", "deepseek-v2-lite-16b"))
def test_lm_training_on_the_smoke_mesh_is_the_run_without(device, smoke_mesh, arch):
    """Reduced LM training on the card with DTensor parameters and optimizer
    state on the 1 × 1 mesh against the mesh-less run: bitwise, or, where a
    DTensor decomposition reorders a sum, PR 23's card tolerance (loss rtol
    1e-5, parameters 1e-5), with the first module that differs printed."""
    from repro_torch.launch.train import train

    kw = dict(reduced=True, steps=3, batch=4, seq=32, lr=3e-3, ckpt_dir=None,
              ckpt_every=100, device=device)
    plain_model, plain, _ = train(arch, **kw)
    model, losses, _ = train(arch, mesh=smoke_mesh, **kw)
    ours = dict(model.named_parameters())
    bitwise = losses == plain and all(torch.equal(ours[n].full_tensor(), p)
                                      for n, p in plain_model.named_parameters())
    if not bitwise:
        print(f"{arch}: not bitwise on the smoke mesh; losses {losses} vs {plain}; the first "
              f"module that differs: {_first_module_that_differs(arch, device, smoke_mesh)}")
    np.testing.assert_allclose(losses, plain, rtol=1e-5)
    for name, p in plain_model.named_parameters():
        torch.testing.assert_close(ours[name].full_tensor(), p, rtol=0, atol=1e-5)
    if arch == "smollm-360m":
        assert bitwise


def test_op_cost_matmul_flops_are_the_profilers_on_the_card(device, smoke_mesh):
    """One reduced training step on the smoke mesh under the profiler and
    under ``op_cost``: the matmul flops of the events that ran a kernel
    (the leaves under DTensor's calls) equal op_cost's count. (Peak bytes
    are held to the allocator's at full width, in ``chip_smoke.py
    sharding``: at this size the allocator's fixed costs dominate.)"""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import op_cost
    from repro_torch.launch.train import train
    from repro_torch.optim import get_optimizer
    from repro_torch.sharding import ctx as shctx
    from repro_torch.sharding.rules import tree_data_specs, with_sharding

    mm_names = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
    model, _, opt_state = train("smollm-360m", reduced=True, steps=1, batch=4, seq=64,
                                lr=3e-3, ckpt_dir=None, ckpt_every=100, device=device,
                                mesh=smoke_mesh)
    step = model.make_train_step(get_optimizer("adamw", lr=3e-3))
    t = torch.randint(0, model.cfg.vocab_size, (4, 64), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(0)).to(device)
    b = {"tokens": t, "labels": t}
    batch = with_sharding(b, tree_data_specs(b, smoke_mesh), smoke_mesh)

    def leaf_flops(prof):
        def has_mm_child(e):
            return any(c.name in mm_names or has_mm_child(c) for c in e.cpu_children)

        def device_us(e):
            return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

        return sum(e.flops or 0 for e in prof.events()
                   if e.name in mm_names and device_us(e) > 0 and not has_mm_child(e))

    with shctx.use_mesh_constraints(smoke_mesh):
        opt_state, _ = step(opt_state, batch, 1)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_flops=True) as prof:
        with shctx.use_mesh_constraints(smoke_mesh):
            opt_state, _ = step(opt_state, batch, 2)
        torch.cuda.synchronize(device)
    mode = op_cost.CostMode()
    mode.track(list(model.parameters()))
    mode.track([opt_state, batch])
    with shctx.use_mesh_constraints(smoke_mesh, mode=mode):
        opt_state, _ = step(opt_state, batch, 3)
    assert mode.cost.matmul_flops == leaf_flops(prof) > 0
