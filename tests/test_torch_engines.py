"""The port's sparse-step engine family against the JAX package.

* the engine registry, spec parsing and dial errors, as
  ``tests/test_engine.py`` checks the reference's;
* one step of every engine (``dense``, ``sparse:cdf``, ``sparse:alias``,
  ``rowgrad``, ``fused_hbm`` by blocks and pair by pair, ``fused_pipe``,
  ``fused_tiered``) for n = 3 workers against ``jax.vmap`` of its
  reference engine on the same params, ids and keys;
* K3's plain version against the reference's Pallas kernel (interpret
  mode, which pads d to 128 lanes) and its jnp oracle;
* K4's plain versions against ``sgns_fused_hbm_step(interpret=True)``,
  with and without a tail block, and in sequential mode;
* ``fused_hbm`` with one block against one port ``sparse`` step.

Tolerances: the port and XLA sum the dot products (and the loss) in
different orders and XLA contracts some multiply-adds, so tables agree to
a few float32 ulps of their O(0.1) entries (atol 1e-6) and losses to
rtol 1e-5. Negative ids are compared bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import get_engine as j_get_engine
from repro.core.sgns import SGNSConfig as JCfg
from repro.data.pairs import stack_noise_tables as j_stack_tables
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.sgns_fused import fused_negative_ids
from repro.kernels.sgns_fused_hbm import (
    _block_negative_ids as j_block_ids, sgns_fused_hbm_step as j_hbm_step)
from repro_torch import convert, prng
from repro_torch.core import sgns as tsgns
from repro_torch.core.engine import (
    ENGINE_NAMES, REFERENCE_ENGINE, DenseEngine, FusedEngine, FusedHBMEngine,
    FusedPipeEngine, FusedTieredEngine, RowGradEngine, SparseEngine, UpdateEngine,
    get_engine)
from repro_torch.core.sgns import SGNSConfig as TCfg
from repro_torch.data.pairs import stack_noise_tables as t_stack_tables
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sgns_fused as K
from repro_torch.kernels import sgns_fused_hbm as H
from repro_torch.kernels import sgns_update as U

TABLE_ATOL = 1e-6
LOSS_RTOL = 1e-5
N_WORKERS, V, D, B, NEG = 3, 200, 24, 21, 5


# ------------------------------------------------------------------ registry
def test_registry_resolves_all_names():
    assert ENGINE_NAMES == ("dense", "sparse", "rowgrad", "fused", "fused_hbm",
                            "fused_pipe", "fused_tiered")
    for name in ENGINE_NAMES:
        eng = get_engine(name)
        assert isinstance(eng, UpdateEngine) and eng.name == name
        assert eng.table_kind in ("cdf", "alias")
    assert get_engine("sparse").table_kind == "cdf"          # the reference default
    assert get_engine("rowgrad").table_kind == "cdf"
    assert get_engine("fused_hbm").table_kind == "alias"
    from repro.core.engine import ENGINES as J_ENGINES
    assert set(REFERENCE_ENGINE) == set(ENGINE_NAMES)
    assert set(REFERENCE_ENGINE.values()) <= set(J_ENGINES)


def test_registry_sampler_suffix_and_overrides():
    assert get_engine("sparse:alias").sampler == "alias"
    assert get_engine("rowgrad:cdf").table_kind == "cdf"
    assert get_engine("dense", sampler="alias").table_kind == "alias"
    eng = get_engine("sparse")
    assert get_engine(eng) is eng
    assert get_engine(eng, sampler="alias").sampler == "alias"
    assert get_engine("sparse:alias") == get_engine("sparse:alias")
    assert hash(get_engine("rowgrad")) == hash(get_engine("rowgrad"))
    assert get_engine("sparse") != get_engine("sparse:alias")
    assert get_engine("rowgrad:alias").describe() == "rowgrad:alias"
    assert isinstance(get_engine("rowgrad"), SparseEngine)
    assert isinstance(get_engine("dense"), DenseEngine)
    assert isinstance(get_engine("rowgrad"), RowGradEngine)


def test_registry_rejects_unknown():
    with pytest.raises(ValueError, match="unknown update engine"):
        get_engine("hogwild")
    with pytest.raises(ValueError, match="unknown update engine"):
        get_engine("pallas")          # the reference's name, not the port's
    with pytest.raises(ValueError, match="unknown negative sampler"):
        get_engine("sparse:gumbel")


def test_fused_engines_are_alias_only():
    assert FusedEngine().table_kind == "alias"
    with pytest.raises(ValueError, match="alias"):
        get_engine("fused:cdf")
    with pytest.raises(ValueError, match="alias"):
        get_engine("fused_hbm:cdf")
    with pytest.raises(ValueError, match="alias"):
        get_engine("fused_tiered:cdf")


def test_fused_hbm_fields_and_dials():
    eng = get_engine("fused_hbm")
    assert isinstance(eng, FusedHBMEngine) and isinstance(eng, FusedEngine)
    assert eng.block_pairs == 256 and eng.sequential is False
    assert get_engine("fused_hbm", block_pairs=64).block_pairs == 64
    assert get_engine(eng, sequential=True).sequential is True
    with pytest.raises(ValueError, match="block_pairs >= 1"):
        get_engine("fused_hbm", block_pairs=0)
    with pytest.raises(ValueError, match="block_pairs >= 1"):
        get_engine("fused_hbm", block_pairs=-3)


def test_fused_pipe_and_tiered_fields_dials_and_validate():
    pipe, tiered = get_engine("fused_pipe"), get_engine("fused_tiered")
    assert isinstance(pipe, FusedPipeEngine) and isinstance(pipe, FusedHBMEngine)
    assert isinstance(tiered, FusedTieredEngine) and isinstance(tiered, FusedPipeEngine)
    assert (pipe.block_pairs, pipe.ring_depth, pipe.sequential) == (256, 2, False)
    assert (tiered.block_pairs, tiered.ring_depth, tiered.hot_rows) == (256, 2, 256)
    assert get_engine("fused_pipe", ring_depth=3).ring_depth == 3
    assert get_engine(tiered, hot_rows=0).hot_rows == 0
    for bad in (1, 0, -2):
        with pytest.raises(ValueError, match="ring_depth >= 2"):
            get_engine("fused_pipe", ring_depth=bad)
        with pytest.raises(ValueError, match="ring_depth >= 2"):
            get_engine("fused_tiered", ring_depth=bad)
    with pytest.raises(ValueError, match="hot_rows >= 0"):
        get_engine("fused_tiered", hot_rows=-1)
    with pytest.raises(ValueError, match="block_pairs >= 1"):
        get_engine("fused_tiered", block_pairs=0)
    tiered.validate(vocab_size=256)                 # hot_rows == V is allowed
    tiered.validate(vocab_size=None)
    with pytest.raises(ValueError, match="exceeds vocab_size"):
        tiered.validate(vocab_size=255)
    from repro_torch.core.async_trainer import AsyncShardTrainer

    with pytest.raises(ValueError, match="exceeds vocab_size"):
        AsyncShardTrainer(cfg=TCfg(vocab_size=100, dim=8), num_workers=1, total_steps=1,
                          engine=get_engine("fused_tiered", hot_rows=101), device="cpu")


def test_fused_pipe_sequential_runs_the_sequential_kernel(world):
    """``sequential=True`` on either block engine is ``fused_hbm``'s
    per-pair step (K4b), as the reference's engines fall back."""
    cfg = TCfg(vocab_size=V, dim=D, negatives=NEG)
    tt = t_stack_tables(world["counts"], kind="alias")
    seeds = K.seed_tensor(world["keys"])
    runs = []
    for spec in ("fused_hbm", "fused_pipe", "fused_tiered"):
        step = get_engine(spec, block_pairs=8, sequential=True).make_step(cfg, 100)
        runs.append(step(_tparams(world), torch.from_numpy(world["c"]),
                         torch.from_numpy(world["x"]), tt, seeds, 7))
    blocks = get_engine("fused_pipe", block_pairs=8).make_step(cfg, 100)(
        _tparams(world), torch.from_numpy(world["c"]), torch.from_numpy(world["x"]), tt,
        seeds, 7)
    for p, loss in runs[1:]:
        assert torch.equal(loss, runs[0][1])
        for k in ("W", "C"):
            assert torch.equal(p[k], runs[0][0][k])
    assert not torch.equal(blocks[0]["C"], runs[0][0]["C"])


# ------------------------------------------------------------- one step
@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    counts = [rng.zipf(1.3, V).astype(np.float64) for _ in range(N_WORKERS)]
    counts[1][:20] = 0                     # a worker that never saw some rows
    W = (0.1 * rng.normal(size=(N_WORKERS, V, D))).astype(np.float32)
    C = (0.1 * rng.normal(size=(N_WORKERS, V, D))).astype(np.float32)
    c = rng.integers(0, V, (N_WORKERS, B)).astype(np.int32)
    x = rng.integers(0, V, (N_WORKERS, B)).astype(np.int32)
    c[:, :5] = 3                          # duplicate rows: accumulating applies
    x[:, 2:6] = 3
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(5), N_WORKERS))
    return dict(counts=counts, W=W, C=C, c=c, x=x, keys=keys)


def _tparams(w):
    return {"W": torch.from_numpy(w["W"].copy()), "C": torch.from_numpy(w["C"].copy())}


ENGINE_CASES = (("dense", {}), ("sparse:cdf", {}), ("sparse:alias", {}),
                ("rowgrad", {}), ("rowgrad:alias", {}),
                ("fused_hbm", {"block_pairs": 8}),
                ("fused_hbm", {"block_pairs": 8, "sequential": True}),
                ("fused_pipe", {"block_pairs": 8}),
                ("fused_pipe", {"block_pairs": 8, "ring_depth": 3}),
                ("fused_tiered", {"block_pairs": 8, "hot_rows": 16}))


@pytest.mark.parametrize("spec,dials", ENGINE_CASES,
                         ids=[f"{s}-{'-'.join(f'{k}{v}' for k, v in d.items())}"
                              for s, d in ENGINE_CASES])
def test_engine_step_matches_vmapped_reference(world, spec, dials):
    name, _, sampler = spec.partition(":")
    t_eng = get_engine(spec, **dials)
    j_spec = REFERENCE_ENGINE[name] + (f":{sampler}" if sampler else "")
    j_eng = j_get_engine(j_spec, **dials)
    j_step = j_eng.make_step(JCfg(vocab_size=V, dim=D, negatives=NEG), 100)
    t_step = t_eng.make_step(TCfg(vocab_size=V, dim=D, negatives=NEG), 100)
    jt = j_stack_tables(world["counts"], kind=j_eng.table_kind)
    tt = t_stack_tables(world["counts"], kind=t_eng.table_kind)
    jp, jl = jax.vmap(lambda p, c, x, t, k: j_step(p, c, x, t, k, jnp.int32(7)))(
        {"W": jnp.asarray(world["W"]), "C": jnp.asarray(world["C"])},
        jnp.asarray(world["c"]), jnp.asarray(world["x"]), jt, jnp.asarray(world["keys"]))
    tp = _tparams(world)
    tp, tl = t_step(tp, torch.from_numpy(world["c"]), torch.from_numpy(world["x"]), tt,
                    K.seed_tensor(world["keys"]), 7)
    assert tuple(tl.shape) == (N_WORKERS,)
    for k in ("W", "C"):
        assert np.abs(tp[k].numpy() - world[k]).max() > 1e-4     # the step moved it
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=TABLE_ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOSS_RTOL)


def test_engine_draws_match_the_reference_samplers(world):
    """The ids a step consumes: ``engine.sample`` on the per-step seeds is
    the reference engine's draw under vmap, bitwise."""
    for sampler in ("cdf", "alias"):
        t_eng = get_engine(f"sparse:{sampler}")
        j_eng = j_get_engine(f"sparse:{sampler}")
        jt = j_stack_tables(world["counts"], kind=sampler)
        ref_ids = jax.vmap(lambda t, k: j_eng.sample(t, k, (B, NEG)))(
            jt, jnp.asarray(world["keys"]))
        got = t_eng.sample(t_stack_tables(world["counts"], kind=sampler),
                           K.seed_tensor(world["keys"]), (B, NEG))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_ids))


@pytest.mark.parametrize("name", ("fused", "fused_hbm", "fused_pipe", "fused_tiered"))
def test_fused_engines_sample_replays_the_reference_draw(name):
    """A fused engine's draw outside a step is the kernel's counter-hash
    draw, as the reference's ``pallas_fused*`` ``sample`` replays it: the
    ids are bitwise equal on the same table and key (the sync baseline
    draws its negatives through ``engine.sample``)."""
    from repro.data.pairs import build_noise_table as j_build_table
    from repro_torch.data.pairs import build_noise_table as t_build_table

    counts = np.random.default_rng(11).zipf(1.3, 50).astype(np.float64)
    jt = j_build_table(counts, kind="alias")
    tt = {k: v[None] for k, v in t_build_table(counts, kind="alias").items()}
    j_eng, t_eng = j_get_engine(REFERENCE_ENGINE[name]), get_engine(name)
    for seed, shape in ((3, (8, 5)), (0, (7,)), (12, (33, 3)), (2**31 + 5, (4, 2, 5))):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(j_eng.sample(jt, key, shape))
        got = t_eng.sample(tt, K.seed_tensor(np.asarray(key)[None]), shape)[0]
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- sgns steps
def test_train_step_dense_matches_reference(world):
    from repro.core import sgns as jsgns

    p = {k: world[k][0] for k in ("W", "C")}
    c, x = world["c"][0], world["x"][0]
    negs = np.random.default_rng(3).integers(0, V, (B, NEG)).astype(np.int32)
    negs[:, 0] = 3
    jp, jl = jsgns.train_step_dense({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(c), jnp.asarray(x), jnp.asarray(negs),
                                    jnp.float32(0.05))
    tp, tl = tsgns.train_step_dense(convert.from_jax_params(p), torch.from_numpy(c),
                                    torch.from_numpy(x), torch.from_numpy(negs), 0.05)
    for k in ("W", "C"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=TABLE_ATOL)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    args = [convert.from_jax_params(p), torch.from_numpy(c), torch.from_numpy(x),
            torch.from_numpy(negs)]
    jargs = [{k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(c), jnp.asarray(x),
             jnp.asarray(negs)]
    np.testing.assert_allclose(float(tsgns.sum_loss_fn(*args)),
                               float(jsgns.sum_loss_fn(*jargs)), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tsgns.loss_fn(*args)), float(jsgns.loss_fn(*jargs)),
                               rtol=LOSS_RTOL)


def test_worker_batched_steps_equal_per_worker_steps(world):
    """One batched in-place step is each worker's single-model step, to
    the ulps by which torch's einsum rounds differently at another batch
    size."""
    negs = np.random.default_rng(4).integers(0, V, (N_WORKERS, B, NEG)).astype(np.int32)
    n_ = torch.from_numpy(negs)
    c, x = torch.from_numpy(world["c"]), torch.from_numpy(world["x"])
    sp = _tparams(world)
    loss = tsgns.train_step_sparse_(sp, c, x, n_, 0.05)
    dp = _tparams(world)
    dloss = tsgns.train_step_dense_(dp, c, x, n_, 0.05)
    for w in range(N_WORKERS):
        one = {k: torch.from_numpy(world[k][w].copy()) for k in ("W", "C")}
        p1, l1 = tsgns.train_step_sparse(one, c[w], x[w], n_[w], 0.05)
        p2, l2 = tsgns.train_step_dense(one, c[w], x[w], n_[w], 0.05)
        for k in ("W", "C"):
            torch.testing.assert_close(sp[k][w], p1[k], rtol=0, atol=TABLE_ATOL)
            torch.testing.assert_close(dp[k][w], p2[k], rtol=0, atol=TABLE_ATOL)
        assert float(loss[w].mean()) == pytest.approx(float(l1), rel=1e-6)
        assert float(dloss[w].mean()) == pytest.approx(float(l2), rel=1e-6)


# ------------------------------------------------------------------ K3
def _rows(N=37, d=D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.3, (N, d)).astype(np.float32),
            rng.normal(0, 0.3, (N, d)).astype(np.float32),
            rng.normal(0, 0.3, (N, NEG, d)).astype(np.float32))


@pytest.mark.parametrize("d", (D, 50))
def test_row_grads_plain_matches_reference_kernel_and_oracle(d):
    """K3's plain version against the reference's Pallas kernel in
    interpret mode (its wrapper pads d to 128 lanes and B to its block)
    and against the jnp oracle."""
    w, cp, cn = _rows(d=d)
    got = U.sgns_row_grads(*(torch.from_numpy(a) for a in (w, cp, cn)))
    j_mean, *j_grads = j_ops.sgns_row_grads(jnp.asarray(w), jnp.asarray(cp),
                                            jnp.asarray(cn), interpret=True)
    oracle = j_ref.sgns_row_grads_ref(jnp.asarray(w), jnp.asarray(cp), jnp.asarray(cn))
    np.testing.assert_allclose(float(got[0].mean()), float(j_mean), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(oracle[0]), rtol=LOSS_RTOL)
    for g, jk, o in zip(got[1:], j_grads, oracle[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jk), rtol=0, atol=TABLE_ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(o), rtol=0, atol=TABLE_ATOL)
    port_oracle = ref.sgns_row_grads_ref(*(torch.from_numpy(a) for a in (w, cp, cn)))
    for g, o in zip(got, port_oracle):
        np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=LOSS_RTOL, atol=TABLE_ATOL)


def test_ops_wrappers_keep_the_reference_contract(world):
    w, cp, cn = _rows()
    t = ops.sgns_row_grads(*(torch.from_numpy(a) for a in (w, cp, cn)))
    j = j_ops.sgns_row_grads(jnp.asarray(w), jnp.asarray(cp), jnp.asarray(cn),
                             interpret=True)
    assert t[0].dim() == 0
    np.testing.assert_allclose(float(t[0]), float(j[0]), rtol=LOSS_RTOL)
    p = {k: world[k][0] for k in ("W", "C")}
    negs = np.random.default_rng(5).integers(0, V, (B, NEG)).astype(np.int32)
    args = (jnp.asarray(world["c"][0]), jnp.asarray(world["x"][0]), jnp.asarray(negs),
            jnp.float32(0.05))
    jp, jl = j_ops.sgns_apply_step({k: jnp.asarray(v) for k, v in p.items()}, *args,
                                   interpret=True)
    tp, tl = ops.sgns_apply_step(convert.from_jax_params(p),
                                 torch.from_numpy(world["c"][0]),
                                 torch.from_numpy(world["x"][0]), torch.from_numpy(negs),
                                 0.05)
    for k in ("W", "C"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=TABLE_ATOL)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    fn = ops.make_row_grad_fn()
    tp2, _ = tsgns.train_step_sparse(convert.from_jax_params(p),
                                     torch.from_numpy(world["c"][0]),
                                     torch.from_numpy(world["x"][0]),
                                     torch.from_numpy(negs), 0.05, row_grad_fn=fn)
    assert torch.equal(tp2["W"], tp["W"]) and torch.equal(tp2["C"], tp["C"])


def test_row_grads_wrapper_checks_and_counts():
    w, cp, cn = (torch.from_numpy(a) for a in _rows(N=8))
    K.reset_launch_counts()
    U.sgns_row_grads(w, cp, cn)
    assert K.LAUNCHES["sgns_row_grads"] == 0          # CPU: the plain version
    with pytest.raises(TypeError, match="c_pos"):
        U.sgns_row_grads(w, cp.double(), cn)
    with pytest.raises(ValueError, match="c_neg"):
        U.sgns_row_grads(w, cp, cn[:, 0])
    with pytest.raises(ValueError, match="contiguous"):
        U.sgns_row_grads(w, cp, cn.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="no kernel"):
        U.sgns_row_grads(w.to("meta"), cp.to("meta"), cn.to("meta"))


# ------------------------------------------------------------------ K4
@pytest.fixture(scope="module")
def hbm_world(world):
    table = j_stack_tables(world["counts"][:2], kind="alias")
    return {k: np.asarray(v) for k, v in table.items()}


def test_pick_block_pairs_clamps_to_batch():
    assert H.pick_block_pairs(96, 256) == 96
    assert H.pick_block_pairs(96, 32) == 32
    assert H.pick_block_pairs(96, 50) == 50
    assert H.pick_block_pairs(97, 50) == 50
    assert H.pick_block_pairs(8, 0) == 1


def test_block_draws_equal_the_whole_step_draw(world, hbm_world):
    """Per-block counters are global positions: the blocks' draws
    concatenate to K1's whole-step draw and to the reference's blocks."""
    table = convert.from_jax_table(hbm_world)
    seeds = K.seed_tensor(world["keys"][:2])
    full = K.sample_negatives(seeds, table["prob"], table["alias"], (B, NEG))
    parts = [H.block_negative_ids(seeds, table["prob"], table["alias"], b0,
                                  min(8, B - b0), NEG) for b0 in range(0, B, 8)]
    assert torch.equal(torch.cat(parts, dim=1), full)
    for w in range(2):
        j = j_block_ids(jnp.asarray(world["keys"][w]), jnp.asarray(hbm_world["prob"][w]),
                        jnp.asarray(hbm_world["alias"][w]), jnp.int32(16), 5, NEG)
        np.testing.assert_array_equal(parts[2][w, :5].numpy(), np.asarray(j))


@pytest.mark.parametrize("blk,sequential", ((7, False), (8, False), (B, False),
                                            (8, True)),
                         ids=("divides", "tail", "one-block", "sequential"))
def test_hbm_plain_matches_reference_kernel(world, hbm_world, blk, sequential):
    """K4's plain version (2 workers at once) against the reference's
    interpret-mode kernel run per worker, with the same key: ids bitwise,
    tables and losses within tolerance. B = 21 leaves a tail block of 5 at
    ``block_pairs=8``."""
    n = 2
    tp = {k: torch.from_numpy(world[k][:n].copy()) for k in ("W", "C")}
    tp, tloss, ids = H.sgns_fused_hbm_step(
        tp, torch.from_numpy(world["c"][:n]), torch.from_numpy(world["x"][:n]),
        convert.from_jax_table(hbm_world), K.seed_tensor(world["keys"][:n]), 0.05,
        negatives=NEG, block_pairs=blk, sequential=sequential)
    assert tuple(tloss.shape) == (n, B)
    for w in range(n):
        jt = {k: jnp.asarray(v[w]) for k, v in hbm_world.items()}
        key = jnp.asarray(world["keys"][w])
        np.testing.assert_array_equal(
            ids[w].numpy(), np.asarray(fused_negative_ids(key, jt["prob"], jt["alias"],
                                                          (B, NEG))))
        jp, jloss = j_hbm_step({k: jnp.asarray(world[k][w]) for k in ("W", "C")},
                               jnp.asarray(world["c"][w]), jnp.asarray(world["x"][w]), jt,
                               key, jnp.float32(0.05), negatives=NEG, block_pairs=blk,
                               sequential=sequential, interpret=True)
        for k in ("W", "C"):
            np.testing.assert_allclose(tp[k][w].numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=TABLE_ATOL)
        np.testing.assert_allclose(float(tloss[w].mean()), float(jloss), rtol=LOSS_RTOL)


def test_hbm_one_block_is_one_sparse_step(world, hbm_world):
    """``block_pairs >= B``: bitwise the port's sparse step on the
    replayed ids; smaller blocks and the sequential order differ."""
    n = 2
    c, x = torch.from_numpy(world["c"][:n]), torch.from_numpy(world["x"][:n])
    table = convert.from_jax_table(hbm_world)
    seeds = K.seed_tensor(world["keys"][:n])
    runs = {}
    for label, kw in (("one", dict(block_pairs=4 * B)), ("blocks", dict(block_pairs=4)),
                      ("seq", dict(sequential=True))):
        p = {k: torch.from_numpy(world[k][:n].copy()) for k in ("W", "C")}
        runs[label] = H.sgns_fused_hbm_step(p, c, x, table, seeds, 0.05, negatives=NEG,
                                            **kw)
    sp = {k: torch.from_numpy(world[k][:n].copy()) for k in ("W", "C")}
    loss = tsgns.train_step_sparse_(sp, c, x, runs["one"][2], 0.05)
    for k in ("W", "C"):
        assert torch.equal(runs["one"][0][k], sp[k])
    assert torch.equal(runs["one"][1], loss)
    assert not torch.equal(runs["blocks"][0]["C"], sp["C"])
    assert not torch.equal(runs["seq"][0]["C"], runs["blocks"][0]["C"])


def test_hbm_wrapper_checks_and_counts(world, hbm_world):
    table = convert.from_jax_table(hbm_world)
    p = {k: torch.from_numpy(world[k][:2].copy()) for k in ("W", "C")}
    c, x = torch.from_numpy(world["c"][:2]), torch.from_numpy(world["x"][:2])
    seeds = K.seed_tensor(world["keys"][:2])
    K.reset_launch_counts()
    H.sgns_fused_hbm_step(p, c, x, table, seeds, 0.05, block_pairs=4)
    assert all(v == 0 for v in K.LAUNCHES.values())   # CPU: plain versions
    with pytest.raises(ValueError, match="block_pairs"):
        H.sgns_fused_hbm_step(p, c, x, table, seeds, 0.05, block_pairs=0)
    with pytest.raises(TypeError, match="centers"):
        H.sgns_fused_hbm_step(p, c.long(), x, table, seeds, 0.05)
    with pytest.raises(ValueError, match="negatives"):
        H.sgns_fused_hbm_step(p, c, x, table, seeds, 0.05, negatives=K.MAX_NEGATIVES + 1)
    meta = {k: v.to("meta") for k, v in p.items()}
    with pytest.raises(ValueError, match="no kernel"):
        H.sgns_fused_hbm_step(meta, c.to("meta"), x.to("meta"),
                              {k: v.to("meta") for k, v in table.items()},
                              seeds.to("meta"), 0.05)


def test_trainer_runs_every_engine_and_the_loss_drops():
    """AsyncShardTrainer (one chunk of steps) trains with each engine:
    finite per-step losses that end below the init plateau."""
    from repro_torch.core.async_trainer import AsyncShardTrainer

    cfg = TCfg(vocab_size=150, dim=16, negatives=4)
    rng = np.random.default_rng(0)
    n, S, Bt = 2, 12, 64
    c = rng.integers(0, 30, (n, S, Bt)).astype(np.int32)
    x = ((c + 1) % 30).astype(np.int32)
    counts = [rng.zipf(1.3, cfg.vocab_size).astype(np.float64)] * n
    for spec in ("dense", "sparse:alias", "rowgrad", "fused_hbm", "fused_pipe",
                 "fused_tiered"):
        dials = {"block_pairs": 16} if spec.startswith("fused_") else {}
        if spec == "fused_tiered":
            dials["hot_rows"] = 8
        eng = get_engine(spec, **dials)
        tr = AsyncShardTrainer(cfg=cfg, num_workers=n, total_steps=S, engine=eng,
                               device="cpu")
        p = tr.init(prng.PRNGKey(0))
        p, losses = tr.epoch(p, c, x, t_stack_tables(counts, kind=eng.table_kind),
                             prng.PRNGKey(4))
        assert torch.isfinite(losses).all()
        assert float(losses[:, -1].mean()) < (cfg.negatives + 1) * np.log(2), spec
