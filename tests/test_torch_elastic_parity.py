"""The port's elastic package against the JAX package's, on the CPU.

* ``FaultSchedule.seeded`` draws the reference's events, bitwise, for
  several seeds and shapes (one numpy SeedSequence domain);
* cursor metas and worker state directories written by either package
  are read by the other, bitwise (one checkpoint format);
* the port's uninterrupted elastic run on ``sparse`` is within W/C atol
  1e-5 and epoch losses rtol 1e-5 of the reference's (``PERF.md`` §2's rule
  for 16–24 steps; here 16 steps a worker), on the same setup (4 workers, 2
  epochs of 8 steps in chunks of 2);
* a state directory one package wrote mid-run is resumed and finished by
  the other, within the same tolerance of the reference's uninterrupted run.
"""

from functools import lru_cache

import numpy as np
import pytest

from repro.core.driver import prepare_training as j_prepare_training
from repro.core.sgns import SGNSConfig as JConfig
from repro.data.corpus import SemanticCorpusModel as JCorpusModel
from repro.elastic import ElasticRunner as JRunner
from repro.elastic import FaultSchedule as JFaultSchedule
from repro.elastic import WorkerCursor as JCursor
from repro.elastic import WorkerStateStore as JStore
from repro_torch.core.driver import prepare_training
from repro_torch.core.sgns import SGNSConfig
from repro_torch.data.corpus import SemanticCorpusModel
from repro_torch.elastic import ElasticRunner, FaultSchedule, WorkerCursor, WorkerStateStore

ATOL = 1e-5          # W, C after 16 steps
RTOL = 1e-5          # epoch losses
N_WORKERS, EPOCHS = 4, 2
KW = dict(epochs=EPOCHS, batch_size=16, max_steps_per_epoch=8, steps_per_chunk=2,
          seed=3, subsample_t=None, engine="sparse", process_index=0, process_count=1)


@lru_cache(maxsize=None)
def setups():
    port = prepare_training(
        SemanticCorpusModel.create(vocab_size=150, seed=0).generate(500, seed=1),
        150, "random", N_WORKERS, SGNSConfig(vocab_size=0, dim=8, negatives=2), **KW)
    ref = j_prepare_training(
        JCorpusModel.create(vocab_size=150, seed=0).generate(num_sentences=500, seed=1),
        150, "random", N_WORKERS, JConfig(vocab_size=0, dim=8, negatives=2), **KW)
    return port, ref


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's uninterrupted elastic run and its epoch losses."""
    r = JRunner(setups()[1], JStore(str(tmp_path_factory.mktemp("jbase"))))
    return {"params": r.run_all(), "losses": r.epoch_losses()}


def _close(got: dict, want: dict, ctx: str):
    for k in ("W", "C"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=0,
                                   atol=ATOL, err_msg=f"{ctx} {k}")


@pytest.mark.parametrize("seed", [0, 1, 7, 1000, 2003])
@pytest.mark.parametrize("shape", [dict(hosts=3, horizon=6, kills=2, restarts=2, delays=1),
                                   dict(hosts=4, horizon=5, kills=2, restarts=0),
                                   dict(hosts=2, horizon=4, kills=1, restarts=1, delays=3,
                                        max_delay=2)])
def test_seeded_fault_schedules_are_the_reference_ones(seed, shape):
    ours = FaultSchedule.seeded(seed, **shape)
    ref = JFaultSchedule.seeded(seed, **shape)
    assert [(e.kind, e.host, e.tick, e.duration) for e in ours.events] == \
           [(e.kind, e.host, e.tick, e.duration) for e in ref.events]
    assert ours.last_tick == ref.last_tick
    assert ours.killed_hosts() == ref.killed_hosts()
    for t in range(ours.last_tick + 1):
        assert len(ours.at(t)) == len(ref.at(t))


def test_cursor_metas_cross_packages():
    port, ref = setups()
    for epoch in range(EPOCHS):
        for chunk in range(port.sched.num_chunks):
            c = WorkerCursor(worker=3, epoch=epoch, chunk=chunk,
                             step0=port.sched.step0(epoch, chunk))
            j = JCursor(worker=3, epoch=epoch, chunk=chunk,
                        step0=ref.sched.step0(epoch, chunk))
            assert c.to_meta() == j.to_meta()
            assert JCursor.from_meta(c.to_meta()) == j
            assert WorkerCursor.from_meta(j.to_meta()) == c
            assert c.advanced(port.sched).to_meta() == j.advanced(ref.sched).to_meta()
            assert c.global_chunk_index(port.sched) == j.global_chunk_index(ref.sched)


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_worker_state_dirs_cross_packages(writer, tmp_path):
    rng = np.random.default_rng(0)
    params = {"W": rng.normal(size=(7, 3)).astype(np.float32),
              "C": rng.normal(size=(7, 3)).astype(np.float32)}
    cursor = dict(worker=2, epoch=1, chunk=3, step0=11)
    if writer == "port":
        v = WorkerStateStore(str(tmp_path)).save(WorkerCursor(**cursor), params)
        reader = JStore(str(tmp_path))
    else:
        v = JStore(str(tmp_path)).save(JCursor(**cursor), params)
        reader = WorkerStateStore(str(tmp_path))
    got, cur, version = reader.load(2)
    assert version == v and cur.to_meta() == cursor and reader.cursor(2).to_meta() == cursor
    for k, a in params.items():
        assert got[k].dtype == a.dtype
        np.testing.assert_array_equal(got[k], a)
    assert reader.finished_workers(3, epochs=1) == [2]


def test_uninterrupted_run_matches_the_reference(tmp_path, reference_run):
    ref = reference_run
    r = ElasticRunner(setups()[0], WorkerStateStore(str(tmp_path)), device="cpu")
    ours = r.run_all()
    for w in range(N_WORKERS):
        _close(ours[w], ref["params"][w], f"worker {w}")
    np.testing.assert_allclose(r.epoch_losses(), ref["losses"], rtol=RTOL)


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_mid_run_state_is_finished_by_the_other_package(writer, tmp_path, reference_run):
    """One package trains every worker part-way (a different cut per
    worker, ckpt_every=1) and dies; the other resumes the state directory
    and finishes, within the tolerance of the reference's uninterrupted run."""
    ref = reference_run
    port_setup, ref_setup = setups()
    first = (JRunner(ref_setup, JStore(str(tmp_path))) if writer == "repro" else
             ElasticRunner(port_setup, WorkerStateStore(str(tmp_path)), device="cpu"))
    sched = port_setup.sched
    for w in range(N_WORKERS):
        params, cursor = first.load_worker(w)
        it = None
        for _ in range(1 + 2 * w):                  # cuts 1, 3, 5, 7 chunks
            if it is None:
                it = first.chunk_iter(w, cursor)
            params = first.train_chunk(params, cursor, next(it))
            cursor = cursor.advanced(sched)
            if cursor.chunk == 0:
                it = None
            first._maybe_save(params, cursor, done=cursor.done(EPOCHS))
    second = (ElasticRunner(port_setup, WorkerStateStore(str(tmp_path)), device="cpu")
              if writer == "repro" else JRunner(ref_setup, JStore(str(tmp_path))))
    for w in range(N_WORKERS):
        assert second.store.cursor(w).global_chunk_index(sched) == 1 + 2 * w
        _close(second.run_worker(w, resume=True), ref["params"][w],
               f"{writer} wrote, worker {w}")
