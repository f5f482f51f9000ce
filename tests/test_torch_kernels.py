"""The port's kernel module on the CPU (plain versions behind the
wrappers) against the JAX package's fused kernel run in interpret mode:
K1's draw bitwise, K2's step within tolerance, worker batching, the
launch counters, and the wrappers' input checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sgns as jsgns
from repro.data.pairs import build_noise_table as j_noise_table, unigram_noise_probs
from repro.kernels.sgns_fused import (
    fused_negative_ids, sample_negatives_fused, sgns_fused_step as j_fused_step)
from repro_torch import convert, prng
from repro_torch.kernels import sgns_fused as K

V, D, NEG = 240, 32, 5


def _counts(v=V, seed=0):
    return np.random.default_rng(seed).zipf(1.3, v).astype(np.float64)


@pytest.fixture(scope="module")
def table():
    t = j_noise_table(_counts(), kind="alias")
    return {k: np.asarray(a) for k, a in t.items()}


def _stack(table_np, n):
    t = convert.from_jax_table(table_np)
    return {k: v.expand(n, -1).contiguous() for k, v in t.items()}


def _keys(n, seed=0):
    return np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))


# ------------------------------------------------------------------ K1 draw
def test_mix32_matches_uint32_arithmetic():
    x = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    with np.errstate(over="ignore"):
        y = x ^ (x >> np.uint32(16))
        y = y * np.uint32(0x7FEB352D)
        y = y ^ (y >> np.uint32(15))
        y = y * np.uint32(0x846CA68B)
        y = y ^ (y >> np.uint32(16))
    got = K.mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), y)


@pytest.mark.parametrize("shape", ((64, NEG), (1000,), (7, 3, 2)))
def test_sample_negatives_bitwise_with_reference(table, shape):
    """Each worker's ids equal the reference's replay and its Pallas
    sampler kernel (interpret mode) under the same key."""
    n = 3
    keys = _keys(n, seed=11)
    got = K.sample_negatives(K.seed_tensor(keys), *_stack(table, n).values(), shape)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, *shape)
    jt = {k: jnp.asarray(v) for k, v in table.items()}
    for w in range(n):
        replay = fused_negative_ids(jnp.asarray(keys[w]), jt["prob"], jt["alias"], shape)
        kernel = sample_negatives_fused(jt, jnp.asarray(keys[w]), shape, interpret=True)
        np.testing.assert_array_equal(got[w].numpy(), np.asarray(replay))
        np.testing.assert_array_equal(got[w].numpy(), np.asarray(kernel))


def test_sample_negatives_chi_square_matches_unigram_075(table):
    """Chi-square goodness of fit of the port's draw against
    unigram^0.75, as the reference tests its in-kernel draw."""
    p = unigram_noise_probs(_counts())
    N = 400_000
    draws = K.sample_negatives(K.seed_tensor(_keys(1, 123)), *_stack(table, 1).values(),
                               (N,))[0].numpy()
    assert draws.min() >= 0 and draws.max() < len(p)
    obs = np.bincount(draws, minlength=len(p)).astype(np.float64)
    exp = p * N
    keep = exp >= 5.0
    chi2 = float(np.sum((obs[keep] - exp[keep]) ** 2 / exp[keep])
                 + (obs[~keep].sum() - exp[~keep].sum()) ** 2 / max(exp[~keep].sum(), 1.0))
    df = int(keep.sum())
    assert chi2 < df + 4.0 * np.sqrt(2.0 * df), (chi2, df)


def test_sample_negatives_workers_use_their_own_tables():
    """Worker w draws from row w of the stacked tables: a worker whose
    table puts all mass on one id only ever draws that id."""
    p = np.zeros(V)
    p[17] = 1.0
    from repro_torch.core.distributions import build_alias_table

    prob, alias = build_alias_table(p)
    flat = {"prob": np.asarray(prob, np.float32), "alias": alias}
    spread = j_noise_table(np.ones(V), kind="alias")
    stacked = {k: torch.stack([torch.from_numpy(np.asarray(flat[k])),
                               torch.from_numpy(np.asarray(spread[k]))]) for k in flat}
    ids = K.sample_negatives(K.seed_tensor(_keys(2)), stacked["prob"], stacked["alias"],
                             (500,))
    assert set(ids[0].tolist()) == {17}
    assert len(set(ids[1].tolist())) > 100     # uniform over 240 ids


# ------------------------------------------------------------------ K2 step
def _jparams(seed=1):
    p = jsgns.init_params(jax.random.PRNGKey(seed), jsgns.SGNSConfig(vocab_size=V, dim=D))
    return {"W": np.asarray(p["W"]),
            "C": np.asarray(0.02 * jax.random.normal(jax.random.PRNGKey(seed + 1), (V, D)))}


def _batch(B, seed=2, dup=True):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, V, B, dtype=np.int32)
    x = rng.integers(0, V, B, dtype=np.int32)
    if dup:                       # repeated rows: the accumulating apply
        c[: B // 4] = 3
        x[: B // 8] = 3
        x[B // 8: B // 4] = 0
    return c, x


# Tolerances of the port's step against the reference kernel on identical
# inputs: the two sum the dot products and the loss in different orders
# (and XLA may contract multiply-adds), so tables agree to a few float32
# ulps of their O(1e-2) entries, and the mean loss to ~1e-6 relative.
TABLE_ATOL = 1e-6
LOSS_RTOL = 1e-5


@pytest.mark.parametrize("lr", (0.025, 0.5))
@pytest.mark.parametrize("B", (48, 128))
def test_sgns_fused_step_matches_reference_kernel(table, B, lr):
    p0 = _jparams()
    c, x = _batch(B)
    key = jax.random.PRNGKey(7)
    jp, jloss = j_fused_step({k: jnp.asarray(v) for k, v in p0.items()}, jnp.asarray(c),
                             jnp.asarray(x), {k: jnp.asarray(v) for k, v in table.items()},
                             key, jnp.float32(lr), negatives=NEG, interpret=True)
    tp = {k: v[None] for k, v in convert.from_jax_params(p0).items()}
    tp, tloss, ids = K.sgns_fused_step(
        tp, torch.from_numpy(c)[None], torch.from_numpy(x)[None], _stack(table, 1),
        K.seed_tensor(np.asarray(key)[None]), lr, negatives=NEG)
    np.testing.assert_array_equal(
        ids[0].numpy(), np.asarray(fused_negative_ids(key.astype(jnp.uint32),
                                                      jnp.asarray(table["prob"]),
                                                      jnp.asarray(table["alias"]), (B, NEG))))
    assert len(np.unique(ids[0].numpy())) < B * NEG     # negatives collide too
    out = convert.to_numpy({k: v[0] for k, v in tp.items()})
    for k in ("W", "C"):
        assert np.abs(out[k] - p0[k]).max() > 1e-3       # the step moved the table
        np.testing.assert_allclose(out[k], np.asarray(jp[k]), rtol=0, atol=TABLE_ATOL)
    np.testing.assert_allclose(float(tloss.mean()), float(jloss), rtol=LOSS_RTOL)


def test_worker_batched_step_equals_per_worker_steps(table):
    """One call for n workers is the n single-worker calls, bitwise."""
    n, B = 3, 64
    params = [_jparams(seed=s) for s in (1, 4, 9)]
    batches = [_batch(B, seed=s) for s in (2, 5, 8)]
    seeds = K.seed_tensor(_keys(n, seed=3))
    stacked = {k: torch.from_numpy(np.stack([p[k] for p in params])) for k in ("W", "C")}
    cen = torch.from_numpy(np.stack([b[0] for b in batches]))
    ctx = torch.from_numpy(np.stack([b[1] for b in batches]))
    stacked, loss, ids = K.sgns_fused_step(stacked, cen, ctx, _stack(table, n), seeds, 0.1)
    for w in range(n):
        one = {k: torch.from_numpy(params[w][k].copy())[None] for k in ("W", "C")}
        one, l1, i1 = K.sgns_fused_step(one, cen[w:w + 1], ctx[w:w + 1], _stack(table, 1),
                                        seeds[w:w + 1], 0.1)
        for k in ("W", "C"):
            assert torch.equal(one[k][0], stacked[k][w])
        assert torch.equal(l1[0], loss[w]) and torch.equal(i1[0], ids[w])


def test_launch_counters_stay_zero_on_cpu(table):
    K.reset_launch_counts()
    n, B = 2, 16
    K.sample_negatives(K.seed_tensor(_keys(n)), *_stack(table, n).values(), (B, NEG))
    p = {k: torch.from_numpy(np.stack([v, v])) for k, v in _jparams().items()}
    c, x = _batch(B)
    K.sgns_fused_step(p, torch.from_numpy(np.stack([c, c])),
                      torch.from_numpy(np.stack([x, x])), _stack(table, n),
                      K.seed_tensor(_keys(n)), 0.025)
    assert K.LAUNCHES == {"sample_negatives": 0, "sgns_fused_step": 0,
                          "sgns_row_grads": 0, "sgns_fused_hbm_step": 0,
                          "sgns_fused_pipe_step": 0, "sgns_fused_tiered_step": 0,
                          "swa_decode": 0}


def test_wrappers_check_their_inputs(table):
    n, B = 1, 8
    t = _stack(table, n)
    seeds = K.seed_tensor(_keys(n))
    p = {k: torch.from_numpy(v)[None] for k, v in _jparams().items()}
    c = torch.zeros((n, B), dtype=torch.int32)
    with pytest.raises(TypeError, match="centers"):
        K.sgns_fused_step(p, c.long(), c, t, seeds, 0.1)
    with pytest.raises(ValueError, match="contexts"):
        K.sgns_fused_step(p, c, torch.zeros((n, B + 1), dtype=torch.int32), t, seeds, 0.1)
    with pytest.raises(ValueError, match="negatives"):
        K.sgns_fused_step(p, c, c, t, seeds, 0.1, negatives=K.MAX_NEGATIVES + 1)
    t2, seeds2 = _stack(table, 2), K.seed_tensor(_keys(2))
    with pytest.raises(ValueError, match="contiguous"):
        K.sample_negatives(seeds2, t2["prob"], torch.zeros((V, 2), dtype=torch.int32).T,
                           (4,))
    # a tensor on neither the CPU nor a CUDA device has no kernel: raise
    meta = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError, match="no kernel"):
        K.sample_negatives(seeds.to("meta"), meta["prob"], meta["alias"], (4,))


def test_seed_tensor_keeps_the_key_bits():
    keys = np.array([[0, 2**32 - 1], [2**31, 5]], dtype=np.uint32)
    s = K.seed_tensor(keys)
    assert s.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy().view(np.uint32), keys)
    np.testing.assert_array_equal(prng.split(keys[0], 2).shape, (2, 2))
