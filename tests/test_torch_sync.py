"""The port's synchronous baselines against the JAX package's.

* ``make_sync_epoch`` with ``dense``, ``sparse:alias`` and ``fused`` against
  the reference's with no mesh: the negatives bitwise (each step's key is
  the reference's scan split), the tables within atol 1e-6 and the losses
  within rtol 1e-5 (the dense gradients' sums run in another order than
  XLA's);
* ``make_periodic_sync_epoch`` with one worker against the reference's on
  a one-device mesh (same tolerances); with three stacked workers against
  a hand loop of engine steps and means over the worker axis, bitwise;
* a ``gloo`` process group of one against no group, bitwise (an
  all-reduce over one rank is the identity);
* ``train_sync_baseline`` against the reference's on ``test_system.py``'s
  tiny corpus (W atol 1e-5 after 3 epochs, losses rtol 1e-5), the
  driver's helpers bitwise, and the port passing ``test_system.py``'s
  sync-baseline thresholds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import driver as jdriver
from repro.core.async_trainer import make_periodic_sync_epoch as j_periodic
from repro.core.async_trainer import make_sync_epoch as j_sync
from repro.core.engine import get_engine as j_get_engine
from repro.core.sgns import SGNSConfig as JCfg
from repro.data.corpus import SemanticCorpusModel as JGen
from repro.data.pairs import build_noise_table as j_build_table
from repro_torch import prng
from repro_torch.core import driver as tdriver
from repro_torch.core.async_trainer import make_periodic_sync_epoch, make_sync_epoch
from repro_torch.core.engine import REFERENCE_ENGINE, get_engine
from repro_torch.core.sgns import SGNSConfig as TCfg
from repro_torch.data.corpus import SemanticCorpusModel as TGen
from repro_torch.data.pairs import build_noise_table as t_build_table
from repro_torch.kernels.sgns_fused import seed_tensor

TABLE_ATOL = 1e-6
LOSS_RTOL = 1e-5
V, D, NEG = 150, 16, 4
SPECS = ("dense", "sparse:alias", "fused")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(3)
    counts = rng.zipf(1.3, V).astype(np.float64)
    W = ((rng.random((V, D)) - 0.5) / D).astype(np.float32)
    C = (0.02 * rng.normal(size=(V, D))).astype(np.float32)
    c = rng.integers(0, V, (4, 2, 24)).astype(np.int32)     # (outer, sync_every, B)
    x = rng.integers(0, V, (4, 2, 24)).astype(np.int32)
    c[..., :4] = 7                                          # duplicate rows
    return dict(counts=counts, W=W, C=C, c=c, x=x)


def _tables(spec, counts):
    name, _, sampler = spec.partition(":")
    t_eng = get_engine(spec)
    j_eng = j_get_engine(REFERENCE_ENGINE[name] + (f":{sampler}" if sampler else ""))
    return (j_eng, j_build_table(counts, kind=j_eng.table_kind),
            t_eng, t_build_table(counts, kind=t_eng.table_kind))


def _tp(w):
    return {"W": torch.from_numpy(w["W"].copy()), "C": torch.from_numpy(w["C"].copy())}


def _jp(w):
    return {"W": jnp.asarray(w["W"]), "C": jnp.asarray(w["C"])}


def _close(tp, jp):
    for k in ("W", "C"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=TABLE_ATOL)


@pytest.mark.parametrize("spec", SPECS)
def test_sync_epoch_matches_the_reference(world, spec):
    j_eng, jt, t_eng, tt = _tables(spec, world["counts"])
    cfg_j, cfg_t = JCfg(vocab_size=V, dim=D, negatives=NEG), TCfg(vocab_size=V, dim=D,
                                                                   negatives=NEG)
    c, x = world["c"].reshape(8, 24), world["x"].reshape(8, 24)
    key = jax.random.PRNGKey(9)
    jp, jl = j_sync(cfg_j, jt, 20, engine=j_eng)(_jp(world), jnp.asarray(c),
                                                  jnp.asarray(x), key, jnp.int32(3))
    tp, tl = make_sync_epoch(cfg_t, tt, 20, engine=t_eng, device="cpu")(
        _tp(world), torch.from_numpy(c), torch.from_numpy(x), np.asarray(key), 3)
    _close(tp, jp)
    assert np.abs(tp["W"].numpy() - world["W"]).max() > 1e-4       # it trained
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOSS_RTOL)
    # the negatives each step drew: the reference's draw on its scan's keys
    seeds = seed_tensor(prng.step_keys(np.asarray(key), 8))
    table = {k: v[None] for k, v in tt.items()} if isinstance(tt, dict) else tt[None]
    k = key
    for i in range(8):
        k, sub = jax.random.split(k)
        want = np.asarray(j_eng.sample(jt, sub, (24, NEG)))
        got = t_eng.sample(table, seeds[i:i + 1], (24, NEG))[0]
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec", SPECS)
def test_periodic_sync_one_worker_matches_the_reference_mesh(world, spec):
    j_eng, jt, t_eng, tt = _tables(spec, world["counts"])
    cfg_j, cfg_t = JCfg(vocab_size=V, dim=D, negatives=NEG), TCfg(vocab_size=V, dim=D,
                                                                   negatives=NEG)
    mesh = jax.make_mesh((1,), ("worker",))
    key = jax.random.PRNGKey(4)
    jp, jl = j_periodic(cfg_j, jt, 16, sync_every=2, mesh=mesh, engine=j_eng)(
        _jp(world), jnp.asarray(world["c"]), jnp.asarray(world["x"]), key, jnp.int32(1))
    start = _tp(world)
    tp, tl = make_periodic_sync_epoch(cfg_t, tt, 16, sync_every=2, engine=t_eng,
                                      device="cpu")(
        start, torch.from_numpy(world["c"]), torch.from_numpy(world["x"]),
        np.asarray(key), 1)
    assert tuple(tl.shape) == (4, 2) and tuple(tp["W"].shape) == (V, D)
    for k in ("W", "C"):                   # the caller's tables are not trained in place
        assert torch.equal(start[k], torch.from_numpy(world[k]))
    _close(tp, jp)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOSS_RTOL)


def _hand_loop(spec, world, tt, n, total_steps, key, step0):
    """``outer`` × (``sync_every`` engine steps of all n workers with one
    seed, then every copy replaced by the mean over the worker axis)."""
    cfg = TCfg(vocab_size=V, dim=D, negatives=NEG)
    step = get_engine(spec).make_step(cfg, total_steps)
    table = ({k: v.expand(n, -1).contiguous() for k, v in tt.items()}
             if isinstance(tt, dict) else tt.expand(n, -1).contiguous())
    stacked = {k: v.repeat(n, 1, 1) for k, v in _tp(world).items()}
    outer, every, B = world["c"].shape
    seeds = seed_tensor(prng.step_keys(key, outer * every))
    losses = torch.empty((outer, every))
    for o in range(outer):
        for j in range(every):
            i = o * every + j
            stacked, loss = step(
                stacked, torch.from_numpy(world["c"][o, j].reshape(n, B // n).copy()),
                torch.from_numpy(world["x"][o, j].reshape(n, B // n).copy()), table,
                seeds[i].expand(n, 2).contiguous(), step0 + i)
            losses[o, j] = loss.mean()
        means = {k: t.mean(dim=0) for k, t in stacked.items()}
        for k, t in stacked.items():
            t.copy_(means[k].expand_as(t))
    return means, losses


@pytest.mark.parametrize("spec", ("fused", "sparse"))
def test_periodic_sync_three_workers_is_the_hand_loop(world, spec):
    _, _, t_eng, tt = _tables(spec, world["counts"])
    key = prng.PRNGKey(8)
    tp, tl = make_periodic_sync_epoch(TCfg(vocab_size=V, dim=D, negatives=NEG), tt, 16,
                                      sync_every=2, num_workers=3, engine=t_eng,
                                      device="cpu")(
        _tp(world), world["c"], world["x"], key, 2)
    hp, hl = _hand_loop(spec, world, tt, 3, 16, key, 2)
    for k in ("W", "C"):
        assert torch.equal(tp[k], hp[k])
    assert torch.equal(tl, hl)


def test_periodic_sync_rejects_bad_shapes(world):
    _, _, t_eng, tt = _tables("sparse", world["counts"])
    cfg = TCfg(vocab_size=V, dim=D, negatives=NEG)
    epoch = make_periodic_sync_epoch(cfg, tt, 8, sync_every=3, engine=t_eng, device="cpu")
    with pytest.raises(ValueError, match="expected 3"):
        epoch(_tp(world), world["c"], world["x"], prng.PRNGKey(0), 0)
    epoch = make_periodic_sync_epoch(cfg, tt, 8, sync_every=2, num_workers=5,
                                     engine=t_eng, device="cpu")
    with pytest.raises(ValueError, match="does not split over 5"):
        epoch(_tp(world), world["c"], world["x"], prng.PRNGKey(0), 0)
    with pytest.raises(ValueError, match="num_workers >= 1"):
        make_periodic_sync_epoch(cfg, tt, 8, sync_every=0, engine=t_eng, device="cpu")


@pytest.fixture
def gloo_group(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("spec", ("dense", "fused"))
def test_a_group_of_one_is_no_group_bitwise(world, gloo_group, spec):
    _, _, t_eng, tt = _tables(spec, world["counts"])
    cfg = TCfg(vocab_size=V, dim=D, negatives=NEG)
    c, x, key = world["c"].reshape(8, 24), world["x"].reshape(8, 24), prng.PRNGKey(5)
    runs = [make_sync_epoch(cfg, tt, 12, group=g, engine=t_eng, device="cpu")(
        _tp(world), c, x, key, 0) for g in (None, gloo_group)]
    runs += [make_periodic_sync_epoch(cfg, tt, 12, sync_every=2, num_workers=2, group=g,
                                      engine=t_eng, device="cpu")(
        _tp(world), world["c"], world["x"], key, 0) for g in (None, gloo_group)]
    for (pa, la), (pb, lb) in (runs[:2], runs[2:]):
        assert torch.equal(la, lb)
        for k in ("W", "C"):
            assert torch.equal(pa[k], pb[k])


def test_driver_streams_and_tiled_permutation_bitwise():
    assert (tdriver._STREAM_SYNC_EPOCH, tdriver._STREAM_SYNC_PERM) == (
        jdriver._STREAM_SYNC_EPOCH, jdriver._STREAM_SYNC_PERM)
    for seed, stream, epoch in ((0, 1, 0), (3, 2, 4)):
        np.testing.assert_array_equal(tdriver._epoch_key(seed, stream, epoch),
                                      np.asarray(jdriver._epoch_key(seed, stream, epoch)))
    for n, need in ((40, 200), (100, 60), (7, 7), (5, 23)):
        a = tdriver._tiled_permutation(tdriver._epoch_rng(1, 2, 3), n, need)
        b = jdriver._tiled_permutation(jdriver._epoch_rng(1, 2, 3), n, need)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no training pairs"):
        tdriver._tiled_permutation(np.random.default_rng(0), 0, 5)


def _tiny(pkg_gen):
    return pkg_gen.create(vocab_size=120, seed=4).generate(num_sentences=40, seed=5)


@pytest.mark.parametrize("spec", ("dense", "fused"))
def test_sync_baseline_matches_the_reference_on_the_tiny_corpus(spec):
    kw = dict(epochs=3, batch_size=256, window=3, max_vocab=None)
    jp, jv, ji = jdriver.train_sync_baseline(
        _tiny(JGen), 120, JCfg(vocab_size=0, dim=16, window=3, negatives=3),
        engine=REFERENCE_ENGINE[spec], **kw)
    tp, tv, ti = tdriver.train_sync_baseline(
        _tiny(TGen), 120, TCfg(vocab_size=0, dim=16, window=3, negatives=3),
        engine=spec, device="cpu", **kw)
    np.testing.assert_array_equal(tv.word_ids, jv.word_ids)
    assert ti["steps_per_epoch"] == ji["steps_per_epoch"]
    np.testing.assert_allclose(tp["W"].numpy(), np.asarray(jp["W"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ti["losses"], ji["losses"], rtol=1e-5)
    # test_system.py's thresholds for the tiny corpus
    assert np.isfinite(tp["W"].numpy()).all() and np.isfinite(ti["losses"]).all()
    assert ti["losses"][-1] < ti["losses"][0]
    assert ti["train_s"] > 0


def test_sync_baseline_trains_to_the_reference_threshold():
    """``test_system.py::test_sync_baseline_trains`` on the port."""
    corpus = TGen.create(vocab_size=1000, seed=0).generate(num_sentences=10_000, seed=1)
    cfg = TCfg(vocab_size=0, dim=32, window=5, negatives=5)
    params, vocab, info = tdriver.train_sync_baseline(
        corpus, 1000, cfg, epochs=2, batch_size=512, window=5, max_vocab=None,
        max_steps_per_epoch=200, device="cpu")
    assert info["losses"][-1] < info["losses"][0]
    assert np.isfinite(params["W"].numpy()).all()
    assert tuple(params["W"].shape) == (vocab.size, 32)
