"""The port's elastic training (``repro_torch.elastic``) on the CPU, mirroring
``tests/test_elastic.py`` with the reference's setup (4 workers, 2 epochs of
8 steps in chunks of 2, d = 8).

Parity rule: *an elastic resume ≡ the uninterrupted run*, bitwise inside
the port. The baseline is the uninterrupted elastic run
(:meth:`ElasticRunner.run_all`), as the reference defines it. Resume from
any checkpoint, a sparse checkpoint cadence, kill/restart, kill/steal and a
seeded fault schedule must land on its tables bit for bit, for the
``sparse`` engine, ``fused`` (K2's plain version) and ``rowgrad`` (K3's
plain version). Cursors, stream suffixes, chunk keys, the checkpoint crash
windows, the quorum/deadline merges and ``merge_finished`` are checked as
the reference checks itself (integers and merges bitwise); the chunk keys
also bitwise against the reference's. The seeded chaos matrix runs under
``-m chaos``; one seed of ``chaos_resume`` stays in tier 1.
"""

import os
from functools import lru_cache

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core.driver import worker_chunk_key as j_worker_chunk_key
from repro_torch.checkpoint import io as ckio
from repro_torch.core import merge as mg
from repro_torch.core.driver import prepare_training, worker_chunk_key
from repro_torch.core.schedule import plan_epoch
from repro_torch.core.sgns import SGNSConfig
from repro_torch.data.corpus import SemanticCorpusModel
from repro_torch.data.pipeline import PairChunkStream, make_worker_streams
from repro_torch.data.vocab import build_vocab
from repro_torch.elastic import (
    ElasticRunner, FaultEvent, FaultSchedule, WorkerCursor, WorkerStateStore,
    merge_finished, simulate_elastic)

N_WORKERS = 4
EPOCHS = 2
ENGINES = ("sparse", "fused", "rowgrad")
CPU = "cpu"


@lru_cache(maxsize=None)
def world():
    gen = SemanticCorpusModel.create(vocab_size=150, seed=0)
    return gen.generate(num_sentences=500, seed=1)


@lru_cache(maxsize=None)
def setup_for(engine: str):
    cfg = SGNSConfig(vocab_size=0, dim=8, negatives=2)
    s = prepare_training(world(), 150, "random", N_WORKERS, cfg,
                         epochs=EPOCHS, batch_size=16,
                         max_steps_per_epoch=8, steps_per_chunk=2,
                         seed=3, subsample_t=None, engine=engine,
                         process_index=0, process_count=1)
    assert s.sched.num_chunks >= 3, s.sched   # mid-epoch cuts must exist
    return s


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """``baseline(engine)``: the uninterrupted elastic run — the
    bit-identity reference — trained once per engine."""
    runs: dict = {}

    def get(engine: str) -> dict:
        if engine not in runs:
            store = WorkerStateStore(str(tmp_path_factory.mktemp(f"baseline_{engine}")))
            runs[engine] = ElasticRunner(setup_for(engine), store, ckpt_every=1,
                                         device=CPU).run_all()
        return runs[engine]

    return get


def runner(engine: str, path, ckpt_every: int = 1) -> ElasticRunner:
    return ElasticRunner(setup_for(engine), WorkerStateStore(str(path)),
                         ckpt_every=ckpt_every, device=CPU)


def assert_tables_equal(a: dict, b: dict, ctx=""):
    for k in ("W", "C"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=f"{ctx} key={k}")


def train_chunks(r: ElasticRunner, worker: int, k: int) -> None:
    """Train ``worker`` for ``k`` chunks through the runner's pieces,
    checkpointing on its cadence, then drop everything (the kill)."""
    sched = r.setup.sched
    params, cursor = r.load_worker(worker)
    it = None
    for _ in range(k):
        if it is None:
            it = r.chunk_iter(worker, cursor)
        params = r.train_chunk(params, cursor, next(it))
        cursor = cursor.advanced(sched)
        if cursor.chunk == 0:
            it = None
        r._maybe_save(params, cursor, done=cursor.done(EPOCHS))


# ======================================================================
# 1. Cursors
# ======================================================================
def test_cursor_progression_wraps_epochs():
    sched = plan_epoch(min_pairs=64, batch_size=4, epochs=2,
                       steps_per_chunk=4)          # 4 chunks/epoch
    cur = WorkerCursor.start(worker=2)
    seen = []
    while not cur.done(2):
        seen.append((cur.epoch, cur.chunk, cur.step0))
        cur.validate(sched)
        cur = cur.advanced(sched)
    assert seen == [(e, c, e * sched.steps_per_epoch + c * sched.chunk_steps)
                    for e in range(2) for c in range(sched.num_chunks)]
    assert cur.done(2) and cur.worker == 2


def test_cursor_meta_roundtrip_and_validation():
    sched = plan_epoch(64, 4, 2, 4)
    cur = WorkerCursor(worker=1, epoch=1, chunk=2, step0=sched.step0(1, 2))
    assert WorkerCursor.from_meta(cur.to_meta()) == cur
    assert cur.global_chunk_index(sched) == sched.num_chunks + 2
    cur.validate(sched)
    with pytest.raises(ValueError, match="different schedule"):
        WorkerCursor(worker=1, epoch=1, chunk=2, step0=5).validate(sched)
    with pytest.raises(ValueError, match="out of range"):
        WorkerCursor(worker=1, epoch=0, chunk=99, step0=0).validate(sched)
    with pytest.raises(ValueError, match="non-negative"):
        WorkerCursor(worker=-1, epoch=0, chunk=0, step0=0)


# ======================================================================
# 1b. Stream fast-forward + key replay
# ======================================================================
def test_start_chunk_suffix_bit_exact():
    """chunks(epoch, N, start_chunk=c) equals the suffix of the
    uninterrupted stream for every chunk boundary c."""
    s = setup_for("sparse")
    sched = s.sched
    for w in (0, N_WORKERS - 1):
        stream = PairChunkStream(
            [s.streams[w]], batch_size=s.batch_size,
            steps_per_chunk=sched.chunk_steps,
            sentences_per_block=s.sentences_per_block)
        for epoch in range(EPOCHS):
            full = list(stream.chunks(epoch, sched.num_chunks))
            for cut in range(sched.num_chunks + 1):
                tail = list(stream.chunks(epoch, sched.num_chunks, start_chunk=cut))
                assert len(tail) == sched.num_chunks - cut
                for (fc, fx), (tc, tx) in zip(full[cut:], tail):
                    np.testing.assert_array_equal(fc, tc)
                    np.testing.assert_array_equal(fx, tx)


def test_chunk_keys_and_step0_are_position_pure():
    """The per-chunk key and LR offset depend only on the cursor's
    coordinates; every key is bitwise the reference's, and distinct
    coordinates give distinct keys."""
    s = setup_for("sparse")
    sched = s.sched
    keys = set()
    for epoch in range(EPOCHS):
        for chunk in range(sched.num_chunks):
            for w in range(N_WORKERS):
                k = worker_chunk_key(s.seed, epoch, chunk, N_WORKERS, w)
                np.testing.assert_array_equal(
                    k, worker_chunk_key(s.seed, epoch, chunk, N_WORKERS, w))
                np.testing.assert_array_equal(
                    k, np.asarray(j_worker_chunk_key(s.seed, epoch, chunk, N_WORKERS, w)))
                keys.add(tuple(np.asarray(k).ravel().tolist()))
            WorkerCursor(worker=1, epoch=epoch, chunk=chunk,
                         step0=sched.step0(epoch, chunk)).validate(sched)
    assert len(keys) == EPOCHS * sched.num_chunks * N_WORKERS


# ======================================================================
# 2. Mid-epoch kill → resume (store round-trip), every engine
# ======================================================================
@pytest.mark.parametrize("engine", ENGINES)
def test_resume_from_any_checkpoint_is_bit_identical(engine, tmp_path, baseline):
    """Train worker 0 for k chunks, throw the runner away (the kill),
    resume from the store with a fresh runner, finish: the tables equal
    the uninterrupted run for several mid-epoch k."""
    base = baseline(engine)
    sched = setup_for(engine).sched
    total = sched.num_chunks * EPOCHS
    for k in (1, sched.num_chunks - 1, sched.num_chunks + 1, total - 1):
        r1 = runner(engine, tmp_path / f"cut{k}")
        train_chunks(r1, 0, k)
        del r1                                      # the kill
        final = runner(engine, tmp_path / f"cut{k}").run_worker(0, resume=True)
        assert_tables_equal(final, base[0], ctx=f"{engine}: cut after {k} chunks")


@pytest.mark.parametrize("engine", ENGINES)
def test_sparse_checkpoint_cadence_still_bit_identical(engine, tmp_path, baseline):
    """ckpt_every > 1: a kill loses the chunks since the last checkpoint
    but the replay regenerates them bit-exactly."""
    base = baseline(engine)
    sched = setup_for(engine).sched
    r1 = runner(engine, tmp_path, ckpt_every=3)
    train_chunks(r1, 1, sched.num_chunks + 2)       # dies mid-epoch 1
    stored = r1.store.cursor(1)
    assert stored is not None
    assert stored.global_chunk_index(sched) <= sched.num_chunks + 2
    final = runner(engine, tmp_path, ckpt_every=3).run_worker(1)
    assert_tables_equal(final, base[1], ctx=f"{engine}: sparse cadence")


def test_schedule_drift_rejected_on_resume(tmp_path):
    store = WorkerStateStore(str(tmp_path))
    store.save(WorkerCursor(worker=0, epoch=0, chunk=1, step0=999),
               {"W": np.zeros((4, 2), np.float32)})
    with pytest.raises(ValueError, match="different schedule"):
        ElasticRunner(setup_for("sparse"), store, device=CPU).load_worker(0)


def test_loaded_tables_are_fresh_tensors(tmp_path):
    """A resumed worker's tables are new tensors on the runner's device,
    not views of the arrays read from disk, and its noise table is that
    worker's slice of the setup's."""
    r = runner("sparse", tmp_path)
    train_chunks(r, 2, 1)
    params, cursor = r.load_worker(2)
    arrays, _, _ = r.store.load(2)
    for k, t in params.items():
        assert t.device.type == CPU and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), arrays[k])
        t.add_(1.0)
        assert not np.array_equal(t.numpy(), arrays[k])
    assert cursor.chunk == 1
    np.testing.assert_array_equal(r._neg_table(2).numpy(),
                                  setup_for("sparse").neg_table[2].numpy())


# ======================================================================
# 3. Crash window in checkpoint/io
# ======================================================================
class _DieOnManifest:
    """os.replace stand-in that kills the process (raises) the moment
    the manifest rename is attempted — after the table npz landed."""

    def __init__(self, real):
        self.real = real

    def __call__(self, src, dst):
        if os.path.basename(dst) == ckio.MANIFEST_NAME:
            raise RuntimeError("killed between table and manifest rename")
        return self.real(src, dst)


def test_crash_between_table_and_manifest_is_invisible(tmp_path, monkeypatch):
    d = str(tmp_path)
    v1 = ckio.publish_arrays(d, {"a": np.arange(3)}, meta={"tag": "one"})
    real = os.replace
    monkeypatch.setattr(os, "replace", _DieOnManifest(real))
    with pytest.raises(RuntimeError, match="killed between"):
        ckio.publish_arrays(d, {"a": np.arange(9)}, meta={"tag": "two"})
    monkeypatch.setattr(os, "replace", real)
    orphans = [f for f in os.listdir(d)
               if f.startswith("table_v") and f.endswith(".npz")]
    assert len(orphans) == 2                       # v1 + the orphan v2
    arrays, meta, version = ckio.load_arrays(d)
    assert version == v1 and meta["tag"] == "one"
    np.testing.assert_array_equal(arrays["a"], np.arange(3))
    v3 = ckio.publish_arrays(d, {"a": np.arange(5)}, meta={"tag": "three"})
    assert v3 == v1 + 2
    assert ckio.load_arrays(d)[1]["tag"] == "three"


def test_gc_orphans_sweeps_debris_without_reusing_versions(tmp_path, monkeypatch):
    d = str(tmp_path)
    v1 = ckio.publish_arrays(d, {"a": np.arange(3)})
    real = os.replace
    monkeypatch.setattr(os, "replace", _DieOnManifest(real))
    with pytest.raises(RuntimeError):
        ckio.publish_arrays(d, {"a": np.arange(4)})
    monkeypatch.setattr(os, "replace", real)
    open(os.path.join(d, ".tmp-deadbeef"), "wb").write(b"partial")
    removed = ckio.gc_orphans(d)
    assert sorted(removed) == sorted(
        [".tmp-deadbeef", os.path.basename(ckio._table_path(d, v1 + 1))])
    assert ckio.load_arrays(d)[2] == v1
    assert ckio.next_version(d) == v1 + 2
    assert ckio.publish_arrays(d, {"a": np.arange(5)}) == v1 + 2
    assert ckio.gc_orphans(d) == []                # idempotent


def test_worker_store_crash_window(tmp_path, monkeypatch):
    """A kill mid-checkpoint leaves the previous (params, cursor) pair
    loadable — never a torn one — and the store's gc sweeps the debris."""
    sched = plan_epoch(64, 4, 2, 4)
    store = WorkerStateStore(str(tmp_path))
    c0 = WorkerCursor(worker=0, epoch=0, chunk=1, step0=sched.step0(0, 1))
    store.save(c0, {"W": np.ones((4, 2), np.float32)})
    real = os.replace
    monkeypatch.setattr(os, "replace", _DieOnManifest(real))
    c1 = WorkerCursor(worker=0, epoch=0, chunk=2, step0=sched.step0(0, 2))
    with pytest.raises(RuntimeError):
        store.save(c1, {"W": np.full((4, 2), 2.0, np.float32)})
    monkeypatch.setattr(os, "replace", real)
    params, cursor, _ = store.load(0)
    assert cursor == c0 == store.cursor(0)
    np.testing.assert_array_equal(params["W"], np.ones((4, 2), np.float32))
    assert store.gc(num_workers=1)                 # debris existed
    assert store.finished_workers(1, epochs=1) == []


# ======================================================================
# 4. Quorum / deadline merge (the port's Merger registry, bitwise)
# ======================================================================
def _rotated_world(V=90, d=8, n=4, seed=5, exclusive_block=0):
    """n rotated copies of one truth table; optionally a block of words
    seen ONLY by the last worker (the elastic dead-worker scenario)."""
    rng = np.random.default_rng(seed)
    Y = rng.normal(size=(V, d)).astype(np.float32)
    models, masks = [], []
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(d, d)))
        mask = rng.random(V) >= 0.25
        mask[: d + 2] = True                       # shared anchor rows
        if exclusive_block:
            mask[V - exclusive_block:] = i == n - 1
        M = (Y @ q).astype(np.float32)
        M[~mask] = 9.9                             # garbage where absent
        models.append(M)
        masks.append(mask.copy())
    return Y, models, masks


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n_missing", [1, 2, 3])
def test_quorum_final_matches_batch_over_survivors(n_missing):
    _, models, masks = _rotated_world(n=4, seed=100 + n_missing)
    rng = np.random.default_rng(n_missing)
    survivors = sorted(rng.choice(4, size=4 - n_missing, replace=False))
    batch = mg.get_merger("alir", device=CPU).merge(mg.stack_models(
        [models[w] for w in survivors], [masks[w] for w in survivors]))
    m = mg.IncrementalAlirMerger(quorum=len(survivors), device=CPU)
    assert not m.quorum_met
    for w in rng.permutation(survivors):           # any arrival order
        m.add(int(w), models[w], masks[w])
    assert m.quorum_met
    final = m.final()
    _equal(final.Y, batch.Y)
    _equal(final.valid, batch.valid)


def test_quorum_unmet_raises_but_can_be_overridden():
    _, models, masks = _rotated_world(n=4, seed=7)
    m = mg.IncrementalAlirMerger(quorum=3, device=CPU)
    m.add(0, models[0], masks[0])
    with pytest.raises(RuntimeError, match="quorum"):
        m.final()
    assert m.final(require_quorum=False).worker_ids == (0,)


def test_deadline_excludes_late_arrivals():
    _, models, masks = _rotated_world(n=4, seed=9)
    now = [0.0]
    m = mg.IncrementalAlirMerger(quorum=2, deadline=10.0, clock=lambda: now[0],
                                 device=CPU)
    m.add(0, models[0], masks[0])
    now[0] = 5.0
    m.add(2, models[2], masks[2])
    now[0] = 11.0                                  # window closed
    assert m.deadline_passed
    assert m.add(3, models[3], masks[3]) is None
    assert m.late_workers == [3]
    final = m.final()
    assert final.worker_ids == (0, 2)
    batch = mg.get_merger("alir", device=CPU).merge(
        mg.stack_models([models[0], models[2]], [masks[0], masks[2]]))
    _equal(final.Y, batch.Y)


def test_dead_worker_checkpoint_round_trips_its_exclusive_words():
    """Words only the dead worker saw are OOV in the survivors' quorum
    merge; folding its last checkpoint in rescues them, and
    reconstruct_missing round-trips those rows into every survivor's
    space."""
    B = 10
    Y, models, masks = _rotated_world(V=90, d=8, n=4, seed=13, exclusive_block=B)
    sl = slice(90 - B, 90)
    survivors = [0, 1, 2]
    m = mg.IncrementalAlirMerger(quorum=3, device=CPU)
    for w in survivors:
        m.add(w, models[w], masks[w])
    assert not np.asarray(m.final().valid)[sl].any()
    stacked = mg.stack_models(models, masks)
    res_all = mg.get_merger("alir", max_iters=60, tol=1e-12, device=CPU).merge(stacked)
    Yall = np.asarray(res_all.Y)
    assert np.asarray(res_all.valid)[sl].all()     # coverage rescued
    Ws = np.asarray(mg.alir_transforms(stacked, res_all.Y))
    np.testing.assert_allclose(Yall[sl], models[3][sl] @ Ws[3], atol=1e-5)
    rec = np.asarray(mg.reconstruct_missing(stacked, res_all.Y))
    for w in survivors:
        np.testing.assert_allclose(rec[w][sl] @ Ws[w], Yall[sl], atol=1e-4)
        assert np.abs(rec[w][sl]).max() > 0.1      # not zero-filled OOV


# ======================================================================
# 5. Fault simulation — fixed and seeded schedules, every engine
# ======================================================================
@pytest.mark.parametrize("engine", ENGINES)
def test_kill_restart_resume_bit_identical(engine, tmp_path, baseline):
    base = baseline(engine)
    faults = FaultSchedule((FaultEvent("kill", 1, 2), FaultEvent("restart", 1, 4),
                            FaultEvent("delay", 0, 3, duration=2)))
    sim = simulate_elastic(runner(engine, tmp_path), 2, faults)
    assert sim.unfinished == []
    for w in range(N_WORKERS):
        assert_tables_equal(sim.params[w], base[w], ctx=f"{engine} worker {w}")


@pytest.mark.parametrize("engine", ENGINES)
def test_kill_steal_bit_identical(engine, tmp_path, baseline):
    base = baseline(engine)
    sim = simulate_elastic(runner(engine, tmp_path), 2,
                           FaultSchedule((FaultEvent("kill", 1, 1),)), steal_after=2)
    assert sim.unfinished == []
    assert sim.stolen                              # work moved hosts
    assert all(dst == 0 for _, dst in sim.stolen.values())
    for w in range(N_WORKERS):
        assert_tables_equal(sim.params[w], base[w], ctx=f"{engine} worker {w}")


@pytest.mark.parametrize("engine", ENGINES)
def test_seeded_chaos_resume_tier1(engine, tmp_path, baseline):
    """One seed of the chaos matrix's kill+restart+delay schedule, in tier 1."""
    _chaos_resume(engine, 0, tmp_path, baseline)


def test_unrecovered_kill_leaves_workers_unfinished(tmp_path):
    """No restart, no stealing: the dead host's workers never finish and
    the simulation terminates instead of spinning."""
    sim = simulate_elastic(runner("sparse", tmp_path), 2,
                           FaultSchedule((FaultEvent("kill", 1, 1),)))
    assert sim.unfinished == list(range(2, N_WORKERS))   # host 1's block
    assert sorted(sim.params) == [0, 1]
    assert sim.ticks < 100


def test_merge_finished_feeds_registry_merger(tmp_path):
    """Whatever the simulation finished goes through the registry: quorum
    enforced, arrival order erased, flat or tree merger accepted."""
    s = setup_for("sparse")
    sim = simulate_elastic(runner("sparse", tmp_path), 2,
                           FaultSchedule((FaultEvent("kill", 1, 1),)))
    survivors = sim.finished
    assert survivors == [0, 1]
    assert WorkerStateStore(str(tmp_path)).finished_workers(N_WORKERS, EPOCHS) == survivors
    mask = np.asarray(s.mask)
    with pytest.raises(RuntimeError, match="quorum"):
        merge_finished(sim, mask, quorum=N_WORKERS, device=CPU)
    final = merge_finished(sim, mask, quorum=len(survivors), device=CPU)
    assert final.worker_ids == tuple(survivors)
    batch = mg.get_merger("alir", device=CPU).merge(mg.stack_models(
        [sim.params[w]["W"] for w in survivors], [mask[w] for w in survivors]))
    _equal(final.Y, batch.Y)
    tree = merge_finished(sim, mask, merger="alir_tree", fan_in=2,
                          quorum=len(survivors), device=CPU)
    assert tree.worker_ids == tuple(survivors)
    assert np.isfinite(np.asarray(tree.Y)).all()


# ======================================================================
# 6. The chaos matrix (pytest -m chaos)
# ======================================================================
CHAOS_SEEDS = range(4)


def _chaos_resume(engine, seed, tmp_path, baseline):
    base = baseline(engine)
    faults = FaultSchedule.seeded(seed, hosts=3, horizon=6, kills=2,
                                  restarts=2, delays=1)
    sim = simulate_elastic(runner(engine, tmp_path), 3, faults)
    assert sim.unfinished == []
    for w in range(N_WORKERS):
        assert_tables_equal(sim.params[w], base[w], ctx=f"{engine} seed {seed} worker {w}")


@pytest.mark.chaos
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_resume(engine, seed, tmp_path, baseline):
    """Seeded kill+restart (+straggler delay) schedules: every worker
    finishes and every table is bit-identical to the uninterrupted run."""
    _chaos_resume(engine, seed, tmp_path, baseline)


@pytest.mark.chaos
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_steal(engine, seed, tmp_path, baseline):
    """Seeded unrecovered kills + work-stealing: survivors adopt the
    victims' workers mid-stream; results still bit-identical."""
    base = baseline(engine)
    faults = FaultSchedule.seeded(seed + 1000, hosts=3, horizon=6, kills=2, restarts=0)
    sim = simulate_elastic(runner(engine, tmp_path, ckpt_every=2), 3, faults,
                           steal_after=1)
    assert sim.unfinished == []
    for w in range(N_WORKERS):
        assert_tables_equal(sim.params[w], base[w], ctx=f"{engine} seed {seed} worker {w}")


@pytest.mark.chaos
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_quorum_merge(engine, seed, tmp_path, baseline):
    """Seeded unrecovered kills, no stealing: every survivor bit-identical
    to the uninterrupted run, and the quorum fold bitwise the batch ALiR
    merge over the surviving subset."""
    base = baseline(engine)
    faults = FaultSchedule.seeded(seed + 2000, hosts=4, horizon=5, kills=2, restarts=0)
    sim = simulate_elastic(runner(engine, tmp_path), 4, faults)
    survivors = sim.finished
    assert survivors
    for w in survivors:
        assert_tables_equal(sim.params[w], base[w], ctx=f"{engine} seed {seed} worker {w}")
    if not sim.unfinished:
        return
    mask = np.asarray(setup_for(engine).mask)
    batch = mg.get_merger("alir", device=CPU).merge(mg.stack_models(
        [sim.params[w]["W"] for w in survivors], [mask[w] for w in survivors]))
    m = mg.IncrementalAlirMerger(quorum=len(survivors), device=CPU)
    for w in np.random.default_rng(seed).permutation(survivors):
        m.add(int(w), sim.params[int(w)]["W"], mask[int(w)])
    final = m.final()
    _equal(final.Y, batch.Y)
    _equal(final.valid, batch.valid)


# ======================================================================
# 7. Hypothesis: arbitrary cut points
# ======================================================================
@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 50), worker=st.integers(0, N_WORKERS - 1),
       epoch=st.integers(0, 3), cut=st.integers(0, 6))
def test_stream_resumable_at_arbitrary_cut_points(seed, worker, epoch, cut):
    """For arbitrary (seed, worker, epoch, chunk-boundary) cut points the
    fast-forwarded stream is the exact suffix of the uninterrupted one."""
    gen = SemanticCorpusModel.create(vocab_size=80, seed=0)
    corpus = gen.generate(num_sentences=120, seed=2)
    vocab = build_vocab(corpus, 80, min_count=1, max_size=None)
    stream = make_worker_streams(
        corpus, vocab, num_workers=N_WORKERS, strategy="equal",
        rate=1.0 / N_WORKERS, window=3, subsample_t=None, seed=seed)[worker]
    cs = PairChunkStream([stream], batch_size=8, steps_per_chunk=2,
                         sentences_per_block=64)
    num_chunks = 6
    cut = min(cut, num_chunks)
    full = list(cs.chunks(epoch, num_chunks))
    tail = list(cs.chunks(epoch, num_chunks, start_chunk=cut))
    assert len(tail) == num_chunks - cut
    for (fc, fx), (tc, tx) in zip(full[cut:], tail):
        np.testing.assert_array_equal(fc, tc)
        np.testing.assert_array_equal(fx, tx)


def test_elastic_entry_points_refuse_the_cpu_by_default(monkeypatch, tmp_path):
    """Without a GPU and without device="cpu", nothing quietly trains or
    merges on the CPU."""
    import torch

    from repro_torch.elastic import train_submodels_elastic

    s = setup_for("sparse")
    sim = simulate_elastic(runner("sparse", tmp_path / "sim"), 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: ElasticRunner(s, WorkerStateStore(str(tmp_path))),
        lambda: train_submodels_elastic(world(), 150, "random", 2,
                                        SGNSConfig(vocab_size=0, dim=8), epochs=1,
                                        batch_size=16, state_dir=str(tmp_path / "x")),
        lambda: merge_finished(sim, s.mask),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "x").exists()
