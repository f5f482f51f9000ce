"""The port's CUDA kernels against their plain versions on the GPU.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
test, never at import). Run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import prng
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
# rows; its plain version does so with CUDA index_add_ (atomics, no fixed
# order), hence K2's tolerances.
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


# K7 against its plain version: float32 reductions over the window in
# another order (split into chunks, tiles of 64 rows, merged partials), so
# a few ulps of O(0.1) outputs; bfloat16 outputs round to 8 bits (the JAX
# test's 3e-2). Cases: the decode path's h2o-danube-1.8b shape (32 query
# heads over 8 KV heads, D = 80, W = 4096, chunk 512), a JAX test shape
# (H = Hkv), the scalar-load path with a ragged last tile (D = 50, chunk 96)
# and one KV head for eight query heads.
SWA_CASES = {"danube": (4, 4096, 32, 8, 80, 512), "jax": (2, 256, 4, 4, 64, 64),
             "scalar": (1, 192, 6, 2, 50, 96), "mqa": (3, 128, 8, 1, 128, 128)}


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
