"""Elastic per-worker training: checkpoint/resume, fault simulation,
work-stealing, and merge-from-whatever-finished.

The counterpart of ``repro.elastic.runner``. The paper's training phase
has no cross-worker synchronization, so a preempted worker should cost
nothing beyond its own lost progress. Every worker trains through
:meth:`~repro_torch.core.async_trainer.AsyncShardTrainer.worker_epoch` (the
stacked step with n = 1 on views of the worker's own tables, updated in
place), with its pair chunks, seeds and LR step counter all derived from a
:class:`~repro_torch.elastic.cursor.WorkerCursor` — so a worker killed at
any chunk boundary and resumed anywhere (same host, restarted host, or a
survivor that stole it) replays the identical step sequence and lands on
bit-identical tables. The fault simulation (:func:`simulate_elastic`)
exists to *prove* it under seeded kill/restart/delay/steal schedules.

The tables stay on the runner's device (the GPU unless ``device="cpu"``)
between chunks; they go to the host only for a checkpoint or a result.

The equivalence baseline is the reference's: the *uninterrupted elastic
run* (:meth:`ElasticRunner.run_all`), not
:func:`repro_torch.core.driver.train_submodels` — a kernel's launch
geometry may depend on the number of stacked workers, so the n = 1 and
the stacked executions are not promised to agree bit for bit.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import sgns
from repro_torch.core.async_trainer import AsyncShardTrainer
from repro_torch.core.driver import (
    PipelineResult, TrainingSetup, prepare_training, worker_chunk_key)
from repro_torch.core.merge import (
    MergeConfig, MergeResult, Merger, StackedModels, get_merger)
from repro_torch.data.pipeline import HostShardPlan, PairChunkStream
from repro_torch.device import resolve_device
from repro_torch.elastic.cursor import WorkerCursor
from repro_torch.elastic.faults import FaultSchedule
from repro_torch.elastic.store import WorkerStateStore


def _host(params: dict) -> dict:
    """A worker's tables as host numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


# ---------------------------------------------------------------------------
class ElasticRunner:
    """Trains one worker at a time from a cursor, checkpointing through
    a :class:`WorkerStateStore`.

    ``ckpt_every`` is the checkpoint cadence in chunks, anchored to the
    worker's *global chunk index* (stream position), not to how many
    chunks this particular process happened to train — so interrupted
    and uninterrupted runs write checkpoints at identical boundaries.
    Epoch boundaries and worker completion always checkpoint.
    ``device`` — where the tables live and the engine runs (the GPU
    unless ``"cpu"``; raises without one).
    """

    def __init__(self, setup: TrainingSetup,
                 store: WorkerStateStore | None = None, *,
                 ckpt_every: int = 1, device=None):
        if ckpt_every < 1:
            raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
        self.setup = setup
        self.store = store
        self.ckpt_every = ckpt_every
        self.num_workers = len(setup.streams)
        self.trainer = AsyncShardTrainer(
            cfg=setup.cfg, num_workers=self.num_workers,
            total_steps=setup.sched.total_steps, engine=setup.engine,
            device=device)
        self.device = self.trainer.device
        # worker -> its noise table(s) on the device (the alias layout's
        # {"prob", "alias"} dict, or the CDF), sliced from setup.neg_table
        self._neg_cache: dict[int, object] = {}
        # per-(worker, epoch) chunk losses (device tensors) trained by THIS
        # process (a resumed process only sees the tail it trained).
        self.chunk_losses: dict[tuple[int, int], list] = {}

    # ------------------------------------------------------------ pieces
    def init_params(self, worker: int) -> dict:
        """Worker ``worker``'s initial tables: the stacked trainer's
        ``init_params(split(PRNGKey(cfg.seed), n)[worker])``, a pure
        function of (cfg.seed, worker), whoever calls it."""
        keys = prng.split(prng.PRNGKey(self.setup.cfg.seed), self.num_workers)
        return sgns.init_params(keys[worker], self.setup.cfg, device=self.device)

    def load_worker(self, worker: int, *, resume: bool = True
                    ) -> tuple[dict, WorkerCursor]:
        """(params, cursor) to continue from: the store's last complete
        checkpoint when ``resume`` and one exists, else a fresh start.
        The stored cursor is schedule-validated — a checkpoint from a
        different corpus/step-cap fails loudly here. Loaded tables are
        fresh tensors on the runner's device (never views of the arrays
        read from disk)."""
        if resume and self.store is not None:
            state = self.store.load(worker)
            if state is not None:
                params, cursor, _ = state
                cursor.validate(self.setup.sched)
                return ({k: torch.from_numpy(np.ascontiguousarray(v))
                         .to(self.device, copy=True) for k, v in params.items()},
                        cursor)
        return self.init_params(worker), WorkerCursor.start(worker)

    def chunk_iter(self, worker: int, cursor: WorkerCursor):
        """The worker's chunk stream for ``cursor.epoch``, fast-forwarded
        to ``cursor.chunk`` — bit-exact suffix of the uninterrupted
        stream (``PairChunkStream.chunks(start_chunk=)``)."""
        s = self.setup
        stream = PairChunkStream(
            [s.streams[worker]], batch_size=s.batch_size,
            steps_per_chunk=s.sched.chunk_steps,
            sentences_per_block=s.sentences_per_block)
        return stream.chunks(cursor.epoch, s.sched.num_chunks,
                             start_chunk=cursor.chunk)

    def _neg_table(self, worker: int):
        if worker not in self._neg_cache:
            table = self.setup.neg_table
            self._neg_cache[worker] = (
                {k: v[worker].to(self.device).contiguous() for k, v in table.items()}
                if isinstance(table, dict) else table[worker].to(self.device).contiguous())
        return self._neg_cache[worker]

    def train_chunk(self, params: dict, cursor: WorkerCursor, chunk):
        """One chunk of one worker, keyed exactly as the stacked epoch
        would have keyed it (:func:`worker_chunk_key`); ``params`` are
        updated in place and returned."""
        centers, contexts = chunk          # (1, S, B) host buffers
        key = worker_chunk_key(self.setup.seed, cursor.epoch, cursor.chunk,
                               self.num_workers, cursor.worker)
        params, losses = self.trainer.worker_epoch(
            params, centers[0], contexts[0], self._neg_table(cursor.worker), key,
            step0=cursor.step0)
        self.chunk_losses.setdefault(
            (cursor.worker, cursor.epoch), []).append(losses)
        return params

    def _maybe_save(self, params: dict, cursor: WorkerCursor,
                    *, done: bool) -> None:
        if self.store is None:
            return
        sched = self.setup.sched
        at_cadence = cursor.global_chunk_index(sched) % self.ckpt_every == 0
        at_epoch = cursor.chunk == 0            # just wrapped an epoch
        if done or at_cadence or at_epoch:
            self.store.save(cursor, params)

    # -------------------------------------------------------- full runs
    def run_worker(self, worker: int, *, resume: bool = True) -> dict:
        """Train ``worker`` from its cursor to the end of the last epoch;
        returns its final params (host numpy)."""
        params, cursor = self.load_worker(worker, resume=resume)
        it = None
        while not cursor.done(self.setup.epochs):
            if it is None:
                it = self.chunk_iter(worker, cursor)
            params = self.train_chunk(params, cursor, next(it))
            cursor = cursor.advanced(self.setup.sched)
            if cursor.chunk == 0:
                it = None                       # next epoch: new stream
            self._maybe_save(params, cursor,
                             done=cursor.done(self.setup.epochs))
        return _host(params)

    def run_all(self, *, resume: bool = True) -> dict[int, dict]:
        """Every worker, sequentially, no faults — the uninterrupted
        elastic baseline the chaos matrix compares against."""
        return {w: self.run_worker(w, resume=resume)
                for w in range(self.num_workers)}

    def epoch_losses(self) -> list[float]:
        """Mean loss per epoch over every chunk this process trained
        (partial on resumed runs — only the replayed tail is visible)."""
        out = []
        for epoch in range(self.setup.epochs):
            arrs = [v.detach().cpu().numpy()
                    for (w, e), vs in self.chunk_losses.items()
                    if e == epoch for v in vs]
            out.append(float(np.mean(np.concatenate(
                [a.ravel() for a in arrs]))) if arrs else float("nan"))
        return out


# ---------------------------------------------------------------------------
# In-process multi-host fault simulation.
# ---------------------------------------------------------------------------
@dataclass
class _LiveWorker:
    params: dict
    cursor: WorkerCursor
    it: object = None


@dataclass
class _Host:
    plan: HostShardPlan
    alive: bool = True
    dead_since: int | None = None
    delay_until: int = 0
    live: dict = field(default_factory=dict)    # worker -> _LiveWorker


@dataclass
class SimulationResult:
    """What the cluster produced: final tables per finished worker, when
    each finished (tick), which never did, and how long the run took."""

    params: dict                 # worker -> {"W": ..., "C": ...} (numpy)
    finished_tick: dict          # worker -> tick index
    unfinished: list             # workers with no complete training
    ticks: int
    stolen: dict                 # worker -> (from_host, to_host)

    @property
    def finished(self) -> list:
        return sorted(self.params)


def simulate_elastic(
    runner: ElasticRunner,
    process_count: int,
    faults: FaultSchedule | None = None,
    *,
    steal_after: int | None = None,
    max_ticks: int = 10_000,
) -> SimulationResult:
    """Drive ``process_count`` simulated hosts over
    :meth:`HostShardPlan.all_hosts` under a fault schedule.

    Time advances in ticks: each tick, every live, un-delayed host
    trains one chunk for each unfinished worker it owns, checkpointing
    per the runner's cadence. Faults apply at tick boundaries (see
    :mod:`repro_torch.elastic.faults`). When ``steal_after`` is set, a host
    dead for that many ticks has its unfinished workers re-assigned
    round-robin to the live hosts (the re-planned ownership map — a
    restarted victim does NOT get stolen workers back, so no worker is
    ever trained twice concurrently); the thief resumes each stolen
    worker from its last store checkpoint.

    Requires the runner to have a store — resume is the whole mechanism.
    """
    if runner.store is None:
        raise ValueError("simulate_elastic needs a runner with a store")
    faults = faults or FaultSchedule()
    epochs = runner.setup.epochs
    sched = runner.setup.sched
    num_workers = runner.num_workers
    hosts = [_Host(plan=p) for p in
             HostShardPlan.all_hosts(process_count, num_workers)]
    owners = {w: hi for hi, h in enumerate(hosts)
              for w in range(h.plan.start, h.plan.stop)}
    finished: dict[int, dict] = {}
    finished_tick: dict[int, int] = {}
    stolen: dict[int, tuple] = {}

    def unfinished_owned(hi: int) -> list[int]:
        return [w for w in sorted(owners)
                if owners[w] == hi and w not in finished]

    tick = 0
    while tick < max_ticks and len(finished) < num_workers:
        # -- faults fire at the tick boundary
        for e in faults.at(tick):
            if e.host >= len(hosts):
                continue
            h = hosts[e.host]
            if e.kind == "kill":
                h.alive, h.dead_since = False, tick
                h.live.clear()                 # in-memory state is gone
            elif e.kind == "restart":
                h.alive, h.dead_since = True, None
            elif e.kind == "delay":
                h.delay_until = max(h.delay_until, tick + e.duration)

        # -- straggler detection → work-stealing
        if steal_after is not None:
            live_ids = [i for i, h in enumerate(hosts) if h.alive]
            for hi, h in enumerate(hosts):
                if (h.alive or h.dead_since is None
                        or tick - h.dead_since < steal_after or not live_ids):
                    continue
                for i, w in enumerate(unfinished_owned(hi)):
                    to = live_ids[i % len(live_ids)]
                    owners[w] = to
                    stolen[w] = (hi, to)

        # -- one chunk of work per live host per owned worker
        progressed = False
        for hi, h in enumerate(hosts):
            if not h.alive or tick < h.delay_until:
                continue
            for w in unfinished_owned(hi):
                lw = h.live.get(w)
                if lw is None:
                    params, cursor = runner.load_worker(w, resume=True)
                    if cursor.done(epochs):
                        finished[w] = _host(params)
                        finished_tick.setdefault(w, tick)
                        continue
                    lw = h.live[w] = _LiveWorker(params, cursor)
                if lw.it is None:
                    lw.it = runner.chunk_iter(w, lw.cursor)
                lw.params = runner.train_chunk(lw.params, lw.cursor,
                                               next(lw.it))
                lw.cursor = lw.cursor.advanced(sched)
                if lw.cursor.chunk == 0:
                    lw.it = None
                done = lw.cursor.done(epochs)
                runner._maybe_save(lw.params, lw.cursor, done=done)
                if done:
                    finished[w] = _host(lw.params)
                    finished_tick[w] = tick
                    del h.live[w]
                progressed = True
        tick += 1

        if progressed or len(finished) == num_workers:
            continue
        # -- nothing ran this tick: stop unless something can still
        #    unblock us (a future fault event, a pending steal window,
        #    or a delayed host waking up).
        if tick <= faults.last_tick:
            continue
        delayed_wake = any(
            h.alive and h.delay_until > tick and unfinished_owned(hi)
            for hi, h in enumerate(hosts))
        steal_pending = (
            steal_after is not None
            and any(h.alive for h in hosts)
            and any(not h.alive and unfinished_owned(hi)
                    for hi, h in enumerate(hosts)))
        if not (delayed_wake or steal_pending):
            break

    return SimulationResult(
        params=finished, finished_tick=finished_tick,
        unfinished=sorted(set(range(num_workers)) - set(finished)),
        ticks=tick, stolen=stolen)


def merge_finished(
    sim: SimulationResult,
    mask,
    *,
    merger: Merger | str = "alir",
    config: MergeConfig | None = None,
    require_quorum: bool = True,
    device=None,
    **overrides,
) -> MergeResult:
    """Merge-from-whatever-finished through the unified Merger registry:
    feed the simulation's finished workers into any registered merger
    (``"alir"``, the ``"alir_tree"`` reduction tree, ...) **in
    finished-tick order** — the realistic arrival stream — and return
    the canonical :meth:`~repro_torch.core.merge.Merger.final` fold.

    Every registry merger restacks in canonical worker order before
    solving, so the result is independent of the arrival (finish)
    order; ``quorum``/``deadline`` dials (via ``config`` or keyword
    ``overrides``) apply exactly as documented on
    :class:`~repro_torch.core.merge.MergeConfig` — a preempted cluster that
    finished fewer than ``quorum`` workers raises instead of silently
    publishing a thin consensus.

    Args:
        sim: a :func:`simulate_elastic` result (or anything with
            ``params``/``finished_tick``).
        mask: ``(num_workers, V)`` per-worker presence
            (``TrainingSetup.mask``).
        merger: registry name or pre-built :class:`Merger`.
        config / overrides: :class:`MergeConfig` dials
            (``get_merger(merger, config, **overrides)``).
        require_quorum: forwarded to :meth:`Merger.final`.
        device: where a merger built from a name runs (the GPU unless
            ``"cpu"``); a pre-built merger keeps its own.
    """
    m = (get_merger(merger, config, device=device, **overrides)
         if isinstance(merger, str) else merger)
    mask = np.asarray(mask)
    order = sorted(sim.params,
                   key=lambda w: (sim.finished_tick.get(w, 0), w))
    for w in order:
        m.add(int(w), sim.params[w]["W"], mask[int(w)], fold=False)
    return m.final(require_quorum=require_quorum)


# ---------------------------------------------------------------------------
# High-level entry: the elastic counterpart of driver.train_submodels.
# ---------------------------------------------------------------------------
def train_submodels_elastic(
    corpus,
    raw_vocab_size: int,
    strategy: str,
    num_workers: int,
    cfg,
    *,
    state_dir: str,
    resume: bool = True,
    ckpt_every: int = 1,
    epochs: int = 3,
    batch_size: int = 512,
    rate: float | None = None,
    window: int | None = None,
    subsample_t: float | None = 1e-4,
    max_vocab: int | None = 300_000,
    base_min_count: int = 100,
    seed: int = 0,
    max_steps_per_epoch: int | None = None,
    engine="fused",
    steps_per_chunk: int = 128,
    sentences_per_block: int = 1024,
    device=None,
) -> PipelineResult:
    """Preemption-tolerant :func:`~repro_torch.core.driver.train_submodels`
    on ``device`` (the GPU unless ``device="cpu"``): workers train one at a
    time through :meth:`AsyncShardTrainer.worker_epoch`, checkpointing
    ``(params, cursor)`` to ``state_dir`` every ``ckpt_every`` chunks.
    Re-running the same command after a kill resumes every worker from its
    last checkpoint and produces tables bit-identical to the uninterrupted
    elastic run; on a finished state directory it trains nothing. Single
    process by design; multi-host elasticity is exercised by
    :func:`simulate_elastic`. The port defaults to ``fused``, its main-path
    engine (the reference defaults to ``sparse``)."""
    device = resolve_device(device)
    setup = prepare_training(
        corpus, raw_vocab_size, strategy, num_workers, cfg,
        epochs=epochs, batch_size=batch_size, rate=rate, window=window,
        subsample_t=subsample_t, max_vocab=max_vocab,
        base_min_count=base_min_count, seed=seed,
        max_steps_per_epoch=max_steps_per_epoch, engine=engine,
        steps_per_chunk=steps_per_chunk,
        sentences_per_block=sentences_per_block,
        process_index=0, process_count=1)
    store = WorkerStateStore(state_dir)
    runner = ElasticRunner(setup, store, ckpt_every=ckpt_every, device=device)

    t0 = time.perf_counter()
    by_worker = runner.run_all(resume=resume)
    t_train = time.perf_counter() - t0

    W = np.stack([by_worker[w]["W"] for w in range(num_workers)])
    stacked = StackedModels(models=torch.from_numpy(W).to(device),
                            mask=torch.from_numpy(setup.mask).to(device))
    return PipelineResult(
        strategy=strategy, num_workers=num_workers,
        union_vocab=setup.union_vocab, stacked=stacked,
        timings={"vocab_s": setup.vocab_s, "train_s": t_train,
                 "steps_per_epoch": setup.sched.steps_per_epoch},
        losses=runner.epoch_losses())
