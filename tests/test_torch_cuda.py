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
