"""The port's ``Merger`` API (``core/merge.py``) and the mesh Gram
(``sharding/merge.py``) against the JAX package's, on the CPU.

* the registry (names, overrides, rejection), ``MergeConfig`` validation,
  and quorum and deadline on an injected clock, step for step as the
  reference's mergers behave;
* batch ≡ incremental: every merger's ``final()`` after arrivals in any
  order is bitwise its batch ``merge`` (property-tested with hypothesis
  for ALiR, as ``tests/test_property.py`` tests the reference);
* each merger against the reference's on the same stack: the gauge-free
  merges within 2e-5, PCA up to column signs within 2e-5, ALiR within
  1e-4 after Procrustes alignment (``eigh`` fixes signs per LAPACK build;
  ALiR's SVDs amplify summation-order differences);
* the deprecated shims' warnings and results;
* ``mesh_sharded_gram`` in a ``gloo`` group of one: bitwise
  ``sharded_gram``, with exactly one ``all_gather_into_tensor``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st

from repro.core import merge as jm
from repro_torch.core import merge as tm
from repro_torch.sharding.merge import mesh_sharded_gram

ATOL = 2e-5
ALIR_ATOL = 1e-4


def rotated(V=64, d=6, n=4, miss_frac=0.2, seed=0):
    """Sub-models = one table under random orthogonal maps, rows missing
    at random (model 0 keeps every row, so the union covers V)."""
    rng = np.random.default_rng(seed)
    Y = rng.normal(size=(V, d)).astype(np.float32)
    models, masks = [], []
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(d, d)))
        mask = np.ones(V, bool) if i == 0 else rng.random(V) >= miss_frac
        mask[: d + 2] = True
        M = (Y @ q + 0.01 * rng.normal(size=(V, d))).astype(np.float32)
        M[~mask] = 0.0
        models.append(M)
        masks.append(mask)
    return models, masks


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _align(A, B):
    u, _, vt = np.linalg.svd(A.T @ B)
    return A @ (u @ vt)


def _get(name, **kw):
    return tm.get_merger(name, device="cpu", **kw)


# ------------------------------------------------------------------ registry
def test_registry_names_overrides_and_rejection():
    assert tm.MERGER_NAMES == jm.MERGER_NAMES
    for name in tm.MERGER_NAMES:
        assert _get(name).name == name
    m = _get("alir", max_iters=3, quorum=2, deadline=5.0)
    assert (m.config.max_iters, m.config.quorum, m.config.deadline) == (3, 2, 5.0)
    m = _get("alir_tree", config=tm.MergeConfig(max_iters=7), fan_in=4)
    assert (m.config.max_iters, m.config.fan_in) == (7, 4)
    inst = _get("average")
    assert tm.get_merger(inst) is inst
    with pytest.raises(ValueError, match="instance"):
        tm.get_merger(inst, quorum=2)
    with pytest.raises(ValueError, match="instance"):
        tm.get_merger(inst, device="cpu")
    with pytest.raises(ValueError, match="unknown merger"):
        _get("nope")
    assert set(tm.MERGERS) >= {"alir", "average", "concat", "pca"}
    assert tm.get_merger("alir_tree", device="cpu").describe().startswith("alir_tree(")
    np.testing.assert_array_equal(tm.MergeConfig(seed=5).prng_key(),
                                  np.asarray(jax.random.PRNGKey(5)))


@pytest.mark.parametrize("field,value,name", (("quorum", 0, "alir"),
                                              ("deadline", -1.0, "alir"),
                                              ("fan_in", 1, "alir_tree"),
                                              ("shard", 0, "alir")))
def test_merge_config_validation(field, value, name):
    with pytest.raises(ValueError, match=field):
        jm.get_merger(name, **{field: value})
    with pytest.raises(ValueError, match=field):
        _get(name, **{field: value})


def test_quorum_and_deadline_on_an_injected_clock():
    models, masks = rotated(n=4, seed=1)
    mergers = []
    for mod, kw in ((jm, {}), (tm, {"device": "cpu"})):
        now = [0.0]
        m = mod.get_merger("alir", quorum=3, deadline=10.0, max_iters=4,
                           clock=lambda now=now: now[0], **kw)
        assert m.add(0, models[0], masks[0], fold=False) is None
        first = m.add(2, models[2], masks[2])
        assert first.worker_ids == (0, 2) and not m.quorum_met
        with pytest.raises(RuntimeError, match="quorum not met"):
            m.final()
        assert m.final(require_quorum=False).worker_ids == (0, 2)
        now[0] = 9.5
        m.add(1, models[1], masks[1], fold=False)
        assert m.quorum_met and not m.deadline_passed
        now[0] = 10.5
        assert m.deadline_passed
        assert m.add(3, models[3], masks[3]) is None     # late: recorded, not folded
        assert m.late_workers == [3] and m.worker_ids == (0, 1, 2)
        mergers.append(m.final())
    j, t = mergers
    assert t.worker_ids == j.worker_ids
    np.testing.assert_array_equal(_np(t.valid), _np(j.valid))


def test_add_validations():
    models, masks = rotated(n=3)
    m = tm.IncrementalAlirMerger(device="cpu")
    m.add(0, models[0], masks[0])
    with pytest.raises(ValueError, match="already folded"):
        m.add(0, models[1], masks[1])
    with pytest.raises(ValueError, match="shape"):
        m.add(1, models[1][:, :3], masks[1])
    with pytest.raises(ValueError, match="mask"):
        m.add(1, models[1], masks[1][:10])
    assert m.worker_ids == (0,) and m.n_folded == 1
    with pytest.raises(ValueError, match="no sub-models"):
        tm.IncrementalAlirMerger(device="cpu").fold()


# ------------------------------------------------ batch ≡ incremental (bitwise)
@pytest.mark.parametrize("name", tm.MERGER_NAMES)
def test_every_merger_final_is_its_batch_merge(name):
    models, masks = rotated(V=64, d=8, n=4, seed=13)
    stacked = tm.stack_models(models, masks)
    batch = _get(name, max_iters=6).merge(stacked)
    inc = _get(name, max_iters=6)
    for w in (2, 0, 3, 1):
        inc.add(w, models[w], masks[w], fold=False)
    final = inc.final()
    assert final.worker_ids == (0, 1, 2, 3)
    assert torch.equal(final.emb, batch.emb) and torch.equal(final.valid, batch.valid)


@settings(max_examples=10, deadline=None)
@given(perm=st.permutations(tuple(range(4))), seed=st.integers(0, 999),
       warm=st.booleans())
def test_alir_cold_final_is_arrival_order_invariant(perm, seed, warm):
    """Fold in any arrival order (warm intermediate folds or none), finish
    with the canonical cold fold: bitwise the batch merge."""
    models, masks = rotated(V=40, d=5, n=4, miss_frac=0.25, seed=seed)
    batch = _get("alir").merge(tm.stack_models(models, masks))
    merger = tm.IncrementalAlirMerger(device="cpu")
    for w in perm:
        merger.add(w, models[w], masks[w], fold=warm)
    final = merger.final()
    assert final.worker_ids == (0, 1, 2, 3)
    assert torch.equal(final.Y, batch.Y) and torch.equal(final.valid, batch.valid)
    assert torch.equal(final.transforms, batch.transforms)


def test_warm_folds_match_the_reference_up_to_rotation():
    """Warm intermediate folds inherit their gauge from the arrival
    history, in both packages; the last warm fold matches the reference's
    after Procrustes alignment, and coverage grows with arrivals."""
    models, masks = rotated(V=100, d=8, n=4, miss_frac=0.2, seed=6)
    tmerge, jmerge = tm.IncrementalAlirMerger(device="cpu"), jm.IncrementalAlirMerger()
    tf = [tmerge.add(w, models[w], masks[w]) for w in range(4)]
    jf = [jmerge.add(w, models[w], masks[w]) for w in range(4)]
    counts = [int(f.valid.sum()) for f in tf]
    assert counts == sorted(counts) and counts == [int(np.asarray(f.valid).sum())
                                                   for f in jf]
    a, b = _np(tf[-1].Y), _np(jf[-1].Y)
    np.testing.assert_allclose(_align(a, b), b, rtol=0, atol=ALIR_ATOL)


# ------------------------------------------------------- against the reference
@pytest.mark.parametrize("name", ("average", "concat"))
def test_gauge_free_mergers_match_the_reference(name):
    models, masks = rotated(seed=2)
    t = _get(name).merge(tm.stack_models(models, masks))
    j = jm.get_merger(name).merge(jm.stack_models(models, masks))
    np.testing.assert_array_equal(_np(t.valid), _np(j.valid))
    np.testing.assert_array_equal(_np(t.mask), _np(j.mask))
    np.testing.assert_allclose(_np(t.emb), _np(j.emb), rtol=0, atol=ATOL)


@pytest.mark.parametrize("out_dim", (3, 6, None))
def test_pca_merger_matches_the_reference_up_to_signs(out_dim):
    models, masks = rotated(seed=3, miss_frac=0.1)
    t = _get("pca", out_dim=out_dim).merge(tm.stack_models(models, masks))
    j = jm.get_merger("pca", out_dim=out_dim).merge(jm.stack_models(models, masks))
    te, je = _np(t.emb), _np(j.emb)
    assert te.shape == je.shape == (64, out_dim or 6)
    np.testing.assert_allclose(te * np.sign((te * je).sum(0)), je, rtol=0, atol=ATOL)


@pytest.mark.parametrize("init", ("pca", "random"))
def test_alir_merger_matches_the_reference_after_procrustes(init):
    """Every word in every model, so the consensus is defined up to one
    global orthogonal map: compare after aligning, and the transforms'
    images ``M_i W_i`` directly in the consensus frame."""
    models, masks = rotated(V=80, d=6, n=4, miss_frac=0.0, seed=4)
    t = _get("alir", init=init, max_iters=12).merge(tm.stack_models(models, masks))
    j = jm.get_merger("alir", init=init, max_iters=12).merge(jm.stack_models(models, masks))
    te, je = _np(t.emb), _np(j.emb)
    np.testing.assert_allclose(_align(te, je), je, rtol=0, atol=ALIR_ATOL)
    assert t.worker_ids == j.worker_ids and tuple(t.transforms.shape) == (4, 6, 6)
    np.testing.assert_allclose(_np(t.disps), _np(j.disps), rtol=1e-3, atol=1e-6)
    # the result carries exactly the maps alir_transforms solves
    st_ = tm.stack_models(models, masks)
    assert torch.equal(t.transforms, tm.alir_transforms(st_, t.emb))


# --------------------------------------------------------------------- shims
def test_deprecated_shims_warn_and_delegate():
    models, masks = rotated(V=50, d=6, n=3, miss_frac=0.1, seed=8)
    stacked = tm.stack_models(models, masks)
    with pytest.warns(DeprecationWarning, match="merge_alir is deprecated"):
        Y, valid, disps = tm.merge_alir(stacked, max_iters=6, device="cpu")
    assert torch.equal(Y, _get("alir", max_iters=6).merge(stacked).emb)
    assert tuple(disps.shape) == (6,)
    for fn, name, kw in ((tm.merge_concat, "concat", {}),
                         (tm.merge_average, "average", {}),
                         (tm.merge_pca, "pca", {"out_dim": 4})):
        with pytest.warns(DeprecationWarning, match=f"merge_{name} is deprecated"):
            emb, _ = fn(stacked, device="cpu", **kw)
        assert torch.equal(emb, _get(name, **kw).merge(stacked).emb)


def test_registry_paths_emit_no_deprecation_warnings():
    models, masks = rotated(V=50, d=6, n=3, seed=8)
    stacked = tm.stack_models(models, masks)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        for name in tm.MERGER_NAMES:
            m = _get(name, max_iters=4)
            m.merge(stacked)
            m.add(0, models[0], masks[0])
        tm.merge(stacked, "alir_pca", out_dim=6, device="cpu")
        tm.merge(stacked, "alir_tree", out_dim=6, device="cpu", max_iters=4)


def test_mergers_live_on_the_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in tm.MERGER_NAMES:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tm.get_merger(name)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.IncrementalAlirMerger()


# ----------------------------------------------------------------- mesh Gram
@pytest.fixture
def gloo_group(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("S", (1, 4, 8))
def test_mesh_sharded_gram_is_sharded_gram_with_one_all_gather(gloo_group, monkeypatch, S):
    calls = []
    real = dist.all_gather_into_tensor
    monkeypatch.setattr(dist, "all_gather_into_tensor",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for other in ("all_reduce", "broadcast", "all_gather", "reduce_scatter_tensor"):
        monkeypatch.setattr(dist, other, lambda *a, _n=other, **k: calls.append(_n))
    rng = np.random.default_rng(5)
    A = torch.from_numpy(rng.normal(size=(128, 16)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(128, 16)).astype(np.float32))
    got = mesh_sharded_gram(A, B, gloo_group, num_shards=S)
    assert calls == [1]
    assert torch.equal(got, tm.sharded_gram(A, B, S))
    ref = np.asarray(jm.sharded_gram(jnp.asarray(A.numpy()), jnp.asarray(B.numpy()), S))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=ATOL)


def test_mesh_sharded_gram_keeps_the_reference_errors(gloo_group):
    A = torch.zeros((10, 4))
    with pytest.raises(ValueError, match="must divide evenly into 4 shards"):
        mesh_sharded_gram(A, A, gloo_group, num_shards=4)
    assert torch.equal(mesh_sharded_gram(A, A, gloo_group), torch.zeros((4, 4)))
