"""core/sgns.py, core/engine.py and core/async_trainer.py of the port
against the JAX package: init bitwise, the sparse step and the learning
rate within tolerance, and whole trainer chunks (per-step losses and
tables) against the reference trainer on its ``pallas_fused`` engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sgns as jsgns
from repro.core.async_trainer import AsyncShardTrainer as JTrainer
from repro.data.pairs import stack_noise_tables as j_stack_tables
from repro_torch import convert, prng
from repro_torch.core import sgns as tsgns
from repro_torch.core.async_trainer import AsyncShardTrainer as TTrainer, _mean_loss
from repro_torch.core.engine import (
    ENGINE_NAMES, REFERENCE_ENGINE, FusedEngine, UpdateEngine, get_engine)

# Float tolerances against the reference on identical inputs: reductions
# run in another order (and XLA contracts some multiply-adds), so values
# agree to a few float32 ulps; over a chunk of steps the tables drift by
# no more than ~1e-6 at their O(1e-2) scale.
ATOL = 1e-6
RTOL = 1e-5


@pytest.mark.parametrize("shape", ((50, 8), (333, 48), (1000, 500)))
@pytest.mark.parametrize("seed", (0, 7))
def test_init_params_bitwise(seed, shape):
    V, d = shape
    j = jsgns.init_params(jax.random.PRNGKey(seed), jsgns.SGNSConfig(vocab_size=V, dim=d))
    t = tsgns.init_params(prng.PRNGKey(seed), tsgns.SGNSConfig(vocab_size=V, dim=d),
                          device="cpu")
    np.testing.assert_array_equal(t["W"].numpy().view(np.uint32),
                                  np.asarray(j["W"]).view(np.uint32))
    assert not t["C"].any() and t["C"].shape == (V, d)


def test_linear_lr_matches_reference():
    cfg_j = jsgns.SGNSConfig(vocab_size=1)
    cfg_t = tsgns.SGNSConfig(vocab_size=1)
    for total in (1, 7, 640, 10_000):
        for step in sorted({0, 1, total // 3, total - 1, total, total + 5}):
            ref = np.float32(jsgns.linear_lr(jnp.int32(step), total, cfg_j))
            got = tsgns.linear_lr(step, total, cfg_t)
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, ref, rtol=1e-7)


def _rows(V=120, d=24, B=40, K=4, seed=0):
    rng = np.random.default_rng(seed)
    params = {"W": rng.normal(0, 0.1, (V, d)).astype(np.float32),
              "C": rng.normal(0, 0.1, (V, d)).astype(np.float32)}
    c = rng.integers(0, V, B).astype(np.int32)
    x = rng.integers(0, V, B).astype(np.int32)
    negs = rng.integers(0, V, (B, K)).astype(np.int32)
    c[:10] = 5
    negs[:, 0] = 5
    return params, c, x, negs


def test_sparse_row_grads_match_reference():
    p, c, x, negs = _rows()
    w, cp, cn = p["W"][c], p["C"][x], p["C"][negs]
    ref = jsgns.sparse_row_grads_per_pair(jnp.asarray(w), jnp.asarray(cp), jnp.asarray(cn))
    got = tsgns.sparse_row_grads_per_pair(torch.from_numpy(w), torch.from_numpy(cp),
                                          torch.from_numpy(cn))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


def test_train_step_sparse_matches_reference():
    p, c, x, negs = _rows()
    jp, jloss = jsgns.train_step_sparse({k: jnp.asarray(v) for k, v in p.items()},
                                        jnp.asarray(c), jnp.asarray(x), jnp.asarray(negs),
                                        jnp.float32(0.05))
    tp, tloss = tsgns.train_step_sparse(convert.from_jax_params(p), torch.from_numpy(c),
                                        torch.from_numpy(x), torch.from_numpy(negs), 0.05)
    for k in ("W", "C"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    assert torch.equal(tsgns.embedding_matrix(tp), tp["W"])


def test_engine_registry():
    assert ENGINE_NAMES == ("dense", "sparse", "rowgrad", "fused", "fused_hbm",
                            "fused_pipe", "fused_tiered")
    eng = get_engine("fused")
    assert isinstance(eng, FusedEngine) and isinstance(eng, UpdateEngine)
    assert eng.table_kind == "alias" and eng.describe() == "fused:alias"
    assert get_engine(eng) is eng and get_engine("fused") == eng
    assert get_engine() == eng                       # the port's main-path engine
    assert REFERENCE_ENGINE["fused"] == "pallas_fused"
    from repro.core.engine import ENGINES as J_ENGINES
    assert set(REFERENCE_ENGINE.values()) <= set(J_ENGINES)
    with pytest.raises(ValueError, match="alias"):
        get_engine("fused:cdf")
    with pytest.raises(ValueError, match="unknown update engine"):
        get_engine("pallas_fused")


# ------------------------------------------------------------------ trainer
@pytest.fixture(scope="module")
def setup():
    n, V, d, S, B = 3, 150, 16, 6, 48
    rng = np.random.default_rng(0)
    counts = [rng.zipf(1.4, V).astype(np.float64) for _ in range(n)]
    c = rng.integers(0, V, (n, S, B)).astype(np.int32)
    x = ((c + rng.integers(1, 4, (n, S, B))) % V).astype(np.int32)
    return dict(n=n, V=V, d=d, S=S, B=B, counts=counts, c=c, x=x)


def _trainers(s, total_steps=20):
    jt = JTrainer(cfg=jsgns.SGNSConfig(vocab_size=s["V"], dim=s["d"], negatives=5),
                  num_workers=s["n"], total_steps=total_steps, engine="pallas_fused")
    tt = TTrainer(cfg=tsgns.SGNSConfig(vocab_size=s["V"], dim=s["d"], negatives=5),
                  num_workers=s["n"], total_steps=total_steps, engine="fused",
                  device="cpu")
    return jt, tt


def test_trainer_init_bitwise(setup):
    jt, tt = _trainers(setup)
    jp = jt.init(jax.random.PRNGKey(5))
    tp = tt.init(prng.PRNGKey(5))
    for k in ("W", "C"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_trainer_chunks_match_reference_pallas_fused(setup):
    """Two chunks through both trainers from the same state and keys:
    per-step losses and tables within tolerance (negatives bitwise, as
    the kernel tests pin)."""
    s = setup
    jt, tt = _trainers(s)
    jtable = j_stack_tables(s["counts"], kind="alias")
    ttable = convert.from_jax_table({k: np.asarray(v) for k, v in jtable.items()})
    jp = jt.init(jax.random.PRNGKey(1))
    tp = convert.from_jax_params({k: np.asarray(v) for k, v in jp.items()})
    for chunk, step0 in ((0, 0), (1, s["S"])):
        key = jax.random.fold_in(jax.random.PRNGKey(3), chunk)
        jp, jl = jt.epoch(jp, jnp.asarray(s["c"]), jnp.asarray(s["x"]), jtable, key,
                          step0=step0)
        tp, tl = tt.epoch(tp, s["c"], s["x"], ttable, np.asarray(key), step0=step0)
        assert tuple(tl.shape) == (s["n"], s["S"])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL)
    for k in ("W", "C"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=ATOL)
    assert abs(_mean_loss([tl]) - float(jnp.mean(jl))) < 1e-5


def test_worker_epoch_equals_the_stacked_epoch_slice(setup):
    """One worker's chunk with its split-out key gives that worker's slice
    of the stacked run (the per-worker path the elastic runner uses)."""
    from repro_torch.core.driver import worker_chunk_key

    s = setup
    _, tt = _trainers(s)
    table = convert.from_jax_table(
        {k: np.asarray(v) for k, v in j_stack_tables(s["counts"], kind="alias").items()})
    start = tt.init(prng.PRNGKey(2))
    stacked = {k: v.clone() for k, v in start.items()}
    chunk_key = prng.fold_in(prng.fold_in(prng.fold_in(prng.PRNGKey(0), 0), 0), 1)
    stacked, losses = tt.epoch(stacked, s["c"], s["x"], table, chunk_key, step0=4)
    w = 1
    np.testing.assert_array_equal(prng.split(chunk_key, s["n"])[w],
                                  worker_chunk_key(0, 0, 1, s["n"], w))
    one = {k: v[w].clone() for k, v in start.items()}
    one, l1 = tt.worker_epoch(one, s["c"][w], s["x"][w], {k: v[w] for k, v in table.items()},
                              worker_chunk_key(0, 0, 1, s["n"], w), step0=4)
    assert torch.equal(l1, losses[w])
    for k in ("W", "C"):
        assert torch.equal(one[k], stacked[k][w])


def test_trainer_rejects_out_of_vocabulary_ids(setup):
    """The kernels index the tables unchecked, so the trainer refuses a
    chunk with an id outside [0, V)."""
    s = setup
    _, tt = _trainers(s)
    table = convert.from_jax_table(
        {k: np.asarray(v) for k, v in j_stack_tables(s["counts"], kind="alias").items()})
    params = tt.init(prng.PRNGKey(0))
    bad = s["c"].copy()
    bad[1, 2, 3] = s["V"]
    with pytest.raises(ValueError, match="outside the vocabulary"):
        tt.epoch(params, bad, s["x"], table, prng.PRNGKey(1))
    bad[1, 2, 3] = -1
    with pytest.raises(ValueError, match="outside the vocabulary"):
        tt.epoch(params, s["c"], bad, table, prng.PRNGKey(1))
