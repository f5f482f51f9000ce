"""The port's reduction-tree merge (``core/merge_tree.py``) against the
JAX package's, on the CPU.

* topology: ``build_tree``, ``tree_levels`` and ``tree_depth`` equal to
  the reference's for fan_in 2–4 over 1–13 workers;
* the root against the reference's root: within 1e-4 after Procrustes
  alignment (each node's PCA init fixes eigenvector signs per LAPACK
  build; ALiR is equivariant under a global orthogonal map);
* the root bitwise independent of the arrival order, and equal to the
  batch merge;
* ``reconstruct_worker`` from every level, the elastic node policies
  (deadline, passthrough, quorum at the root), root-path re-solves;
* ``state_dir`` persistence: a persisted tree resumes without re-solving,
  a merge resumes after partial arrivals to the uninterrupted root
  bitwise, and nodes persisted by either package reload in the other
  (the reference's ``tests/test_merge_tree.py`` cases, run on the port);
* ``apply_merges(("alir_tree",), fan_in=...)`` through the driver.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import merge as jm
from repro.core import merge_tree as jmt
from repro_torch.core import driver as tdriver
from repro_torch.core import merge as tm
from repro_torch.core import merge_tree as tmt

ALIR_ATOL = 1e-4


def rotated_world(V=96, d=8, n=8, miss_frac=0.25, seed=0):
    rng = np.random.default_rng(seed)
    Y = rng.normal(size=(V, d)).astype(np.float32)
    models, masks = [], []
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(d, d)))
        mask = np.ones(V, bool) if i == 0 else rng.random(V) >= miss_frac
        mask[: d + 2] = True
        M = (Y @ q).astype(np.float32)
        M[~mask] = 0.0
        models.append(M)
        masks.append(mask)
    return Y, models, masks


def _align(A, B):
    u, _, vt = np.linalg.svd(A.T @ B)
    return A @ (u @ vt)


def _shape(node):
    return (node.level, node.index, node.worker_ids, tuple(_shape(c) for c in node.children))


@pytest.mark.parametrize("fan_in", (2, 3, 4))
@pytest.mark.parametrize("n", (1, 2, 3, 5, 8, 13))
def test_topology_equals_the_reference(fan_in, n):
    ids = list(np.random.default_rng(n).permutation(40)[:n] * 3)
    t, j = tmt.build_tree(ids, fan_in), jmt.build_tree(ids, fan_in)
    assert _shape(t) == _shape(j)
    assert tmt.tree_depth(t) == jmt.tree_depth(j)
    assert ([[_shape(x) for x in lvl] for lvl in tmt.tree_levels(t)]
            == [[_shape(x) for x in lvl] for lvl in jmt.tree_levels(j)])


def test_build_tree_rejects_bad_inputs():
    with pytest.raises(ValueError, match="zero workers"):
        tmt.build_tree([], 2)
    with pytest.raises(ValueError, match="fan_in"):
        tmt.build_tree([0, 1], 1)


@pytest.mark.parametrize("fan_in", (2, 3))
def test_root_matches_the_reference_after_procrustes(fan_in):
    _, models, masks = rotated_world(V=80, d=6, n=6, miss_frac=0.0, seed=2)
    t = tm.get_merger("alir_tree", fan_in=fan_in, max_iters=12, device="cpu").merge(
        tm.stack_models(models, masks))
    j = jm.get_merger("alir_tree", fan_in=fan_in, max_iters=12).merge(
        jm.stack_models(models, masks))
    te, je = t.emb.numpy(), np.asarray(j.emb)
    assert t.worker_ids == j.worker_ids == tuple(range(6))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_allclose(_align(te, je), je, rtol=0, atol=ALIR_ATOL)
    assert tuple(t.transforms.shape) == (6, 6, 6)


@settings(max_examples=8, deadline=None)
@given(perm=st.permutations(tuple(range(6))), seed=st.integers(0, 999),
       fan_in=st.integers(2, 4))
def test_root_is_arrival_order_invariant(perm, seed, fan_in):
    """Topology and node keys are functions of the sorted ids and fan_in,
    and nodes solve cold: any arrival order gives the batch root bitwise."""
    _, models, masks = rotated_world(V=40, d=5, n=6, seed=seed)
    batch = tm.get_merger("alir_tree", fan_in=fan_in, device="cpu").merge(
        tm.stack_models(models, masks))
    merger = tm.get_merger("alir_tree", fan_in=fan_in, device="cpu")
    for w in perm:
        merger.add(w, models[w], masks[w], fold=False)
    final = merger.final()
    assert final.worker_ids == tuple(range(6))
    for k in ("emb", "valid", "transforms", "mask"):
        assert torch.equal(getattr(final, k), getattr(batch, k)), k


def test_reconstruct_worker_from_every_level():
    _, models, masks = rotated_world(V=96, d=8, n=8, miss_frac=0.3, seed=9)
    m = tm.get_merger("alir_tree", max_iters=15, device="cpu")
    for w in range(8):
        m.add(w, models[w], masks[w], fold=False)
    root = m.fold()
    w, present = 5, masks[5]
    for level, index in ((1, 2), (2, 1), (3, 0)):          # ancestors of leaf 5
        node = m.node(level, index)
        assert node is not None and w in node.worker_ids
        rec = tmt.reconstruct_worker(node, w).numpy()
        assert np.abs(rec[present] - models[w][present]).max() < 0.05
    rec = tmt.reconstruct_worker(root, w).numpy()
    assert np.abs(rec[present] - models[w][present]).max() < 0.05
    with pytest.raises(KeyError, match="not covered"):
        tmt.reconstruct_worker(m.node(1, 0), 5)


def test_deadline_quorum_and_passthrough_as_the_reference():
    _, models, masks = rotated_world(n=8, seed=11)
    results = []
    for mod, mt_, kw in ((jm, jmt, {}), (tm, tmt, {"device": "cpu"})):
        now = [0.0]
        m = mt_.TreeAlirMerger(mod.MergeConfig(deadline=10.0, quorum=8, max_iters=6),
                               workers=range(8), clock=lambda now=now: now[0], **kw)
        for w in (0, 1, 2, 4, 5, 6, 7):
            assert m.add(w, models[w], masks[w], fold=False) is None
        now[0] = 11.0
        assert m.add(3, models[3], masks[3]) is None and m.late_workers == [3]
        with pytest.raises(RuntimeError, match="quorum"):
            m.final()
        final = m.final(require_quorum=False)
        assert final.worker_ids == (0, 1, 2, 4, 5, 6, 7)
        node = m.node(1, 1)                                 # workers {2, 3}: passthrough
        assert node.worker_ids == (2,)
        np.testing.assert_array_equal(np.asarray(node.Y), models[2] * masks[2][:, None])
        results.append((m.stats["solved"], m.stats["passthrough"]))
    assert results[0] == results[1]


def test_incremental_arrival_resolves_only_the_root_path():
    _, models, masks = rotated_world(n=8, seed=15)
    m = tm.get_merger("alir_tree", max_iters=4, device="cpu")
    for w in range(7):
        m.add(w, models[w], masks[w], fold=False)
    m.fold()
    before = m.stats["solved"] + m.stats["passthrough"]
    m.add(7, models[7], masks[7])
    assert (m.stats["solved"] + m.stats["passthrough"]) - before <= 3
    before = m.stats["solved"] + m.stats["passthrough"]
    m.fold()
    assert m.stats["solved"] + m.stats["passthrough"] == before


def test_critical_path_below_serial_solve_time():
    _, models, masks = rotated_world(n=8, seed=17)
    m = tm.get_merger("alir_tree", max_iters=6, device="cpu")
    m.merge(tm.stack_models(models, masks))
    serial = sum(m.stats["node_s"].values())
    assert 0 < m.critical_path_s() <= serial + 1e-9
    assert len(m.stats["node_s"]) == 7


def test_persisted_tree_resumes_without_resolving(tmp_path):
    _, models, masks = rotated_world(n=8, seed=19)
    d1 = str(tmp_path / "tree")
    m1 = tmt.TreeAlirMerger(tm.MergeConfig(max_iters=6), workers=range(8), state_dir=d1,
                            device="cpu")
    for w in range(8):
        m1.add(w, models[w], masks[w], fold=False)
    ref = m1.fold()
    assert m1.stats["solved"] == 7

    m2 = tmt.TreeAlirMerger(tm.MergeConfig(max_iters=6), workers=range(8), state_dir=d1,
                            device="cpu")
    assert m2.stats["loaded"] == 15                    # 8 leaves + 7 nodes
    resumed = m2.fold()
    assert m2.stats["solved"] == 0                     # pure cache reuse
    for k in ("emb", "valid", "mask", "transforms", "disps"):
        assert torch.equal(getattr(resumed, k), getattr(ref, k)), k
    assert torch.equal(m2.final().emb, ref.emb)
    # resume=False ignores the state; another fan_in's nodes are never reused
    assert tmt.TreeAlirMerger(tm.MergeConfig(), state_dir=d1, resume=False,
                              device="cpu").stats["loaded"] == 0
    assert tmt.TreeAlirMerger(tm.MergeConfig(fan_in=3), state_dir=d1,
                              device="cpu").stats["loaded"] == 0


def test_resume_after_partial_arrivals_then_continue(tmp_path):
    """Kill the merge mid-arrival: a new merger reloads the persisted
    leaves, accepts the remaining workers, and the finished fold is
    bitwise the uninterrupted one."""
    _, models, masks = rotated_world(n=8, seed=21)
    uninterrupted = tm.get_merger("alir_tree", max_iters=6, device="cpu").merge(
        tm.stack_models(models, masks))
    d1 = str(tmp_path / "tree")
    m1 = tmt.TreeAlirMerger(tm.MergeConfig(max_iters=6), workers=range(8), state_dir=d1,
                            device="cpu")
    for w in (3, 0, 6, 1):
        m1.add(w, models[w], masks[w], fold=False)
    del m1                                             # "preempted"

    m2 = tmt.TreeAlirMerger(tm.MergeConfig(max_iters=6), workers=range(8), state_dir=d1,
                            device="cpu")
    assert m2.worker_ids == (0, 1, 3, 6)               # leaves reloaded
    for w in (7, 2, 5, 4):
        m2.add(w, models[w], masks[w], fold=False)
    final = m2.fold()
    assert torch.equal(final.emb, uninterrupted.emb)
    assert torch.equal(final.transforms, uninterrupted.transforms)


@pytest.mark.parametrize("writer", ("repro", "port"))
def test_persisted_nodes_reload_across_packages(tmp_path, writer):
    """A tree persisted by one package resumes in the other with no
    re-solve: the reloaded root is the writer's root, bitwise."""
    _, models, masks = rotated_world(n=6, seed=23)
    d = str(tmp_path / "tree")
    make = {"repro": lambda **kw: jmt.TreeAlirMerger(jm.MergeConfig(max_iters=6), **kw),
            "port": lambda **kw: tmt.TreeAlirMerger(tm.MergeConfig(max_iters=6),
                                                    device="cpu", **kw)}
    reader = "port" if writer == "repro" else "repro"
    m1 = make[writer](workers=range(6), state_dir=d)
    for w in range(6):
        m1.add(w, models[w], masks[w], fold=False)
    ref = m1.fold()
    m2 = make[reader](workers=range(6), state_dir=d)
    assert m2.stats["loaded"] == 6 + 6 and m2.worker_ids == tuple(range(6))  # 3 + 2 + 1 nodes
    resumed = m2.fold()
    assert m2.stats["solved"] == 0
    for k in ("emb", "valid", "mask", "transforms"):
        np.testing.assert_array_equal(np.asarray(getattr(resumed, k)),
                                      np.asarray(getattr(ref, k)), err_msg=k)


def test_alir_tree_through_merge_and_apply_merges():
    _, models, masks = rotated_world(n=8, seed=7)
    stacked = tm.stack_models(models, masks)
    emb, valid = tm.merge(stacked, "alir_tree", out_dim=8, fan_in=4, device="cpu")
    direct = tm.get_merger("alir_tree", fan_in=4, device="cpu").merge(stacked)
    assert torch.equal(emb, direct.emb) and bool(valid.all())
    res = tdriver.PipelineResult(strategy="shuffle", num_workers=8, union_vocab=None,
                                 stacked=stacked)
    tdriver.apply_merges(res, ("alir_tree",), out_dim=8, fan_in=4)
    np.testing.assert_array_equal(res.merged["alir_tree"][0], emb.numpy())
    assert res.timings["merge_alir_tree_s"] > 0
    assert "alir_tree" in tm.MERGERS
