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
