"""End-to-end paper pipeline: divide → async train → merge → evaluate.

The counterpart of ``repro.core.driver`` (single process):

    result = run_pipeline(corpus, raw_vocab_size, strategy="shuffle",
                          num_workers=10, cfg=cfg, device="cuda")

Vocabulary policy (paper §4.2): ``shuffle`` shares one global
frequency-capped vocabulary; ``random`` / ``equal`` give each sub-model
its own vocabulary (``min_count = base_min_count / num_workers``) and
merge over the union. All sub-models train in the union index space, so
tables stack into ``(n, V_union, d)``.

The divide phase (vocabularies, noise tables, pair streams, schedule)
is numpy and bitwise equal to the reference's; the epoch, chunk and
worker keys follow the same threefry derivation, so a run from the same
seed draws the same negatives. :func:`train_sync_baseline` is the
paper's synchronized baseline end to end (one shared table, the gradient
synchronized every step), the comparison the asynchronous path is
measured against.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.core.sgns import SGNSConfig
from repro_torch.core.async_trainer import (
    AsyncShardTrainer, _mean_loss, make_sync_epoch)
from repro_torch.core.engine import get_engine
from repro_torch.core.merge import StackedModels, merge as merge_models
from repro_torch.core.schedule import plan_epoch
from repro_torch.data.corpus import Corpus
from repro_torch.data.pairs import stack_noise_tables
from repro_torch.data.vocab import Vocab, build_vocab, union_vocab, UNK
from repro_torch.data.pipeline import (
    HostShardPlan, make_worker_streams, prefetch_chunks)
from repro_torch.device import resolve_device
from repro_torch.spans import span

# PRNG streams: fold_in(fold_in(PRNGKey(seed), stream), epoch), as in the
# reference (its arithmetic-seed predecessors collided across runs).
_STREAM_ASYNC_DATA = 0      # per-chunk keys for the async workers' epochs
_STREAM_SYNC_EPOCH = 1      # the sync baseline's in-epoch negative draws
_STREAM_SYNC_PERM = 2       # the sync baseline's numpy pair permutation

# Leading entropy word of every numpy SeedSequence built here, disjoint
# from the pipeline's pair-extraction domain.
_SEED_DOMAIN = 0xD21  # driver epoch streams


def _epoch_key(seed: int, stream: int, epoch: int) -> np.ndarray:
    """Collision-free per-(seed, stream, epoch) key."""
    return prng.fold_in(prng.fold_in(prng.PRNGKey(seed), stream), epoch)


def worker_chunk_key(seed: int, epoch: int, chunk: int, num_workers: int,
                     worker: int) -> np.ndarray:
    """The exact key worker ``worker`` consumes for chunk ``chunk`` of
    ``epoch`` inside :func:`train_submodels`'s loop."""
    ep_key = _epoch_key(seed, _STREAM_ASYNC_DATA, epoch)
    return prng.split(prng.fold_in(ep_key, chunk), num_workers)[worker]


def _epoch_rng(seed: int, stream: int, epoch: int) -> np.random.Generator:
    """numpy counterpart of :func:`_epoch_key` (a domain-tagged
    SeedSequence)."""
    return np.random.default_rng(
        np.random.SeedSequence((_SEED_DOMAIN, seed, stream, epoch)))


def _tiled_permutation(rng: np.random.Generator, n_pairs: int,
                       need: int) -> np.ndarray:
    """``need`` pair indices covering [0, n_pairs) as evenly as possible:
    whole independent permutations back to back."""
    if n_pairs <= 0:
        raise ValueError("no training pairs extracted from the corpus")
    reps = -(-need // n_pairs)
    if reps == 1:
        return rng.permutation(n_pairs)[:need]
    return np.concatenate(
        [rng.permutation(n_pairs) for _ in range(reps)])[:need]


# ---------------------------------------------------------------------------
def _project_vocab(worker_vocab: Vocab, union: Vocab, raw_vocab_size: int) -> Vocab:
    """Worker vocabulary re-indexed into union-vocab id space."""
    lookup = np.full(raw_vocab_size, UNK, dtype=np.int32)
    union_ids = union.lookup[worker_vocab.word_ids]
    lookup[worker_vocab.word_ids] = union_ids
    counts = np.zeros(union.size, dtype=np.int64)
    counts[union_ids] = worker_vocab.counts
    return Vocab(word_ids=union.word_ids, counts=counts, lookup=lookup)


def build_worker_vocabs(
    corpus: Corpus,
    raw_vocab_size: int,
    strategy: str,
    num_workers: int,
    rate: float,
    max_vocab: int | None = 300_000,
    base_min_count: int = 100,
    seed: int = 0,
) -> tuple[list[Vocab], Vocab, np.ndarray]:
    """Returns (projected worker vocabs, union vocab, presence mask (n, V))."""
    if strategy == "shuffle":
        g = build_vocab(corpus, raw_vocab_size, min_count=1, max_size=max_vocab)
        mask = np.ones((num_workers, g.size), dtype=bool)
        return [g] * num_workers, g, mask

    from repro_torch.core.sampling import sample_sentence_indices

    min_count = max(1, int(round(base_min_count / num_workers)))
    per_worker = []
    for w in range(num_workers):
        idx = sample_sentence_indices(
            corpus.num_sentences, strategy, rate, w, num_workers, epoch=0, seed=seed)
        sub = corpus.select(idx)
        per_worker.append(build_vocab(sub, raw_vocab_size, min_count=min_count,
                                      max_size=max_vocab))
    union = union_vocab(per_worker, raw_vocab_size)
    projected = [_project_vocab(v, union, raw_vocab_size) for v in per_worker]
    mask = np.zeros((num_workers, union.size), dtype=bool)
    for w, v in enumerate(per_worker):
        mask[w, union.lookup[v.word_ids]] = True
    return projected, union, mask


def _neg_tables(worker_vocabs: list[Vocab], kind: str = "cdf",
                power: float = 0.75):
    """Stacked per-worker noise tables (CPU tensors) in layout ``kind``."""
    return stack_noise_tables([v.counts for v in worker_vocabs],
                              kind=kind, power=power)


# ---------------------------------------------------------------------------
@dataclass
class TrainingSetup:
    """Everything the train loop needs, derived once from the corpus."""

    cfg: SGNSConfig              # vocab_size bound to the union vocab
    plan: HostShardPlan
    engine: object               # resolved UpdateEngine
    streams: list                # per-worker WorkerStream, union id space
    union_vocab: Vocab
    mask: np.ndarray             # (n, V_union) presence mask
    neg_table: object            # stacked per-worker noise tables (CPU)
    sched: object                # EpochSchedule
    batch_size: int
    sentences_per_block: int
    seed: int
    epochs: int
    vocab_s: float               # wall-clock of the vocab/noise build


def prepare_training(
    corpus: Corpus,
    raw_vocab_size: int,
    strategy: str,
    num_workers: int,
    cfg: SGNSConfig,
    *,
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
    process_index: int | None = None,
    process_count: int | None = None,
) -> TrainingSetup:
    """Divide-phase setup: worker vocabularies (projected into the union
    id space), stacked noise tables in the engine's layout, per-worker
    pair streams, and the epoch schedule sized from a streamed epoch-0
    pair count."""
    rate = rate if rate is not None else 1.0 / num_workers
    window = window if window is not None else cfg.window
    engine = get_engine(engine)
    plan = HostShardPlan.for_runtime(num_workers, process_index=process_index,
                                     process_count=process_count)

    t0 = time.perf_counter()
    worker_vocabs, union, mask = build_worker_vocabs(
        corpus, raw_vocab_size, strategy, num_workers, rate,
        max_vocab=max_vocab, base_min_count=base_min_count, seed=seed)
    cfg = SGNSConfig(**{**cfg.__dict__, "vocab_size": union.size})
    neg_table = _neg_tables(worker_vocabs, kind=engine.table_kind)
    vocab_s = time.perf_counter() - t0

    streams = []
    for w in range(num_workers):
        s = make_worker_streams(
            corpus, worker_vocabs[w], num_workers=num_workers, strategy=strategy,
            rate=rate, window=window, subsample_t=subsample_t, seed=seed)[w]
        streams.append(s)

    # Steps/epoch from a streamed epoch-0 count over all workers (shorter
    # streams wrap); the count stops once the step cap is reached.
    count_cap = (None if max_steps_per_epoch is None
                 else max_steps_per_epoch * batch_size)
    min_pairs = min(s.count_pairs(0, sentences_per_block, max_pairs=count_cap)
                    for s in streams)
    if min_pairs == 0:
        raise ValueError("a worker drew an empty sample")
    sched = plan_epoch(min_pairs, batch_size, epochs, steps_per_chunk,
                       max_steps_per_epoch=max_steps_per_epoch)

    return TrainingSetup(
        cfg=cfg, plan=plan, engine=engine, streams=streams,
        union_vocab=union, mask=mask, neg_table=neg_table, sched=sched,
        batch_size=batch_size, sentences_per_block=sentences_per_block,
        seed=seed, epochs=epochs, vocab_s=vocab_s)


@dataclass
class PipelineResult:
    strategy: str
    num_workers: int
    union_vocab: Vocab
    stacked: StackedModels
    merged: dict = field(default_factory=dict)       # method -> (emb, valid)
    timings: dict = field(default_factory=dict)
    losses: list = field(default_factory=list)       # per-epoch mean loss
    chunk_losses: list = field(default_factory=list)  # per-chunk (n, S) arrays
    plan: HostShardPlan | None = None                # whose workers `stacked` holds
    group: object = None                             # the merge phase's process group
    presence: np.ndarray | None = None               # every worker's (n, V) presence mask


def train_submodels(
    corpus: Corpus,
    raw_vocab_size: int,
    strategy: str,
    num_workers: int,
    cfg: SGNSConfig,
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
    prefetch: int = 2,
    sentences_per_block: int = 1024,
    process_index: int | None = None,
    process_count: int | None = None,
    device=None,
    group=None,
) -> PipelineResult:
    """Divide and train the n sub-models on ``device`` (the GPU unless
    ``device="cpu"``).

    ``engine`` is a spec string (``"rowgrad:cdf"``, ``"sparse:alias"``)
    or an engine instance carrying its dials (``get_engine("fused_hbm",
    block_pairs=128)``); the noise tables are built in its layout and
    moved to ``device``. The port defaults to ``fused``, its main-path
    engine (the reference defaults to ``sparse``).

    ``process_index`` / ``process_count`` (default: the rank and world
    size of the ``torch.distributed`` default group) select multi-process
    training: every process divides the corpus alike, then extracts and
    trains only its :class:`HostShardPlan` block of workers, with **no
    collective**; the result holds that block (``plan`` says which), and
    :func:`gather_submodels` (called by :func:`apply_merges`) gathers the
    blocks over ``group`` (default: the default group) in the merge phase.
    Each worker's keys are split by its global id, so its tables and chunk
    losses are bitwise those of the one-process run."""
    device = resolve_device(device)
    plan = HostShardPlan.for_runtime(num_workers, process_index=process_index,
                                     process_count=process_count)
    if plan.process_count > 1:
        if group is None:
            if not dist.is_initialized():
                raise ValueError(
                    "multi-process training (process_count > 1) needs the process group "
                    "its merge phase gathers over: repro_torch.launch.mesh."
                    "make_worker_group")
            group = dist.group.WORLD
        plan.validate_for_mesh(group)
    setup = prepare_training(
        corpus, raw_vocab_size, strategy, num_workers, cfg,
        epochs=epochs, batch_size=batch_size, rate=rate, window=window,
        subsample_t=subsample_t, max_vocab=max_vocab,
        base_min_count=base_min_count, seed=seed,
        max_steps_per_epoch=max_steps_per_epoch, engine=engine,
        steps_per_chunk=steps_per_chunk,
        sentences_per_block=sentences_per_block,
        process_index=plan.process_index, process_count=plan.process_count)
    cfg, engine, sched = setup.cfg, setup.engine, setup.sched
    trainer = AsyncShardTrainer(cfg=cfg, num_workers=num_workers,
                                total_steps=sched.total_steps, engine=engine,
                                device=device, plan=plan)
    # this process's rows of the noise tables
    neg_table = trainer.device_table(setup.neg_table)
    t_init0 = time.perf_counter()
    params = trainer.init(prng.PRNGKey(cfg.seed))
    if device.type == "cuda":
        # the tables exist before training starts: the init's kernels do
        # not run into (and get timed as) the training loop
        torch.cuda.synchronize(device)
    t_init = time.perf_counter() - t_init0
    chunk_stream = setup.plan.chunk_stream(
        setup.streams, batch_size=batch_size,
        steps_per_chunk=sched.chunk_steps,
        sentences_per_block=sentences_per_block)

    losses, chunk_losses = [], []
    wait_s = 0.0            # host time blocked on the next chunk
    t_train0 = time.perf_counter()
    with span("repro_torch.train_loop"):
        for epoch in range(epochs):
            ep_key = _epoch_key(seed, _STREAM_ASYNC_DATA, epoch)
            ep_losses = []
            # Host extraction and the H2D copy of chunk k+1 overlap the
            # device's work on chunk k (queue depth = `prefetch`).
            chunk_it = prefetch_chunks(chunk_stream.chunks(epoch, sched.num_chunks),
                                       depth=prefetch, device=device)
            t_wait = time.perf_counter()
            for k, (centers, contexts) in enumerate(chunk_it):
                wait_s += time.perf_counter() - t_wait
                centers, contexts = trainer.device_chunk(centers, contexts)
                params, cl = trainer.epoch(params, centers, contexts, neg_table,
                                           prng.fold_in(ep_key, k),
                                           step0=sched.step0(epoch, k))
                ep_losses.append(cl)
                t_wait = time.perf_counter()
            losses.append(_mean_loss(ep_losses))
            chunk_losses.extend(c.cpu().numpy() for c in ep_losses)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    t_train = time.perf_counter() - t_train0

    stacked = StackedModels(
        models=params["W"],
        mask=torch.from_numpy(setup.mask[plan.start:plan.stop]).to(device))
    return PipelineResult(
        strategy=strategy, num_workers=num_workers, union_vocab=setup.union_vocab,
        stacked=stacked, timings={"vocab_s": setup.vocab_s, "train_s": t_train,
                                  "init_s": t_init, "chunk_wait_s": wait_s,
                                  "steps_per_epoch": sched.steps_per_epoch},
        losses=losses, chunk_losses=chunk_losses, plan=plan, group=group,
        presence=setup.mask)


def gather_submodels(res: PipelineResult) -> PipelineResult:
    """The merge phase's gathers of a multi-process run: every rank's block
    of sub-models (``W``), and of chunk losses, all-gathered over
    ``res.group`` in rank order (:func:`repro_torch.sharding.merge
    .gather_worker_blocks`, one ``all_gather`` each), so that every rank
    holds all n sub-models, the presence mask, every worker's chunk losses
    and the epoch losses of the one-process run, bitwise. A one-process
    result is returned as it is."""
    from repro_torch.sharding.merge import gather_worker_blocks

    plan = res.plan
    if plan is None or plan.process_count == 1:
        return res
    t0 = time.perf_counter()
    device = res.stacked.models.device
    models = gather_worker_blocks(res.stacked.models, res.group)
    widths = [c.shape[1] for c in res.chunk_losses]
    local = torch.from_numpy(np.concatenate(res.chunk_losses, axis=1)).to(device)
    every = gather_worker_blocks(local, res.group)
    chunks = list(torch.split(every, widths, dim=1))
    per_epoch = len(chunks) // max(len(res.losses), 1)
    losses = [_mean_loss(chunks[e * per_epoch:(e + 1) * per_epoch])
              for e in range(len(res.losses))]
    mask = torch.from_numpy(res.presence).to(device)
    res.stacked = StackedModels(models=models, mask=mask)
    res.chunk_losses = [c.cpu().numpy() for c in chunks]
    res.losses = losses
    res.plan = HostShardPlan(0, 1, res.num_workers)
    res.timings["gather_s"] = time.perf_counter() - t0
    return res


def run_pipeline(
    corpus: Corpus,
    raw_vocab_size: int,
    strategy: str = "shuffle",
    num_workers: int = 10,
    cfg: SGNSConfig | None = None,
    merge_methods: tuple[str, ...] = ("concat", "pca", "alir_pca"),
    merge_fan_in: int = 2,
    merge_shard: int = 1,
    device=None,
    **kw,
) -> PipelineResult:
    """Train the sub-models (``**kw`` go to :func:`train_submodels`,
    ``engine`` among them) and merge them with each of ``merge_methods``."""
    cfg = cfg or SGNSConfig(vocab_size=0, dim=64)
    res = train_submodels(corpus, raw_vocab_size, strategy, num_workers, cfg,
                          device=device, **kw)
    return apply_merges(res, merge_methods, out_dim=cfg.dim,
                        fan_in=merge_fan_in, shard=merge_shard)


def apply_merges(res: PipelineResult, merge_methods, out_dim: int, *,
                 fan_in: int = 2, shard: int = 1) -> PipelineResult:
    """Fold the stacked sub-models with each requested method on their
    device, recording wall-clock per method in ``res.timings``.
    ``fan_in`` sizes the ``alir_tree`` reduction tree; ``shard`` the ALiR
    Gram accumulation. A multi-process result is gathered first
    (:func:`gather_submodels`); every rank then merges all n sub-models."""
    res = gather_submodels(res)
    device = res.stacked.models.device
    for method in merge_methods:
        t0 = time.perf_counter()
        emb, valid = merge_models(res.stacked, method, out_dim=out_dim,
                                  key=prng.PRNGKey(42), fan_in=fan_in,
                                  shard=shard, device=device)
        res.merged[method] = (emb.cpu().numpy(), valid.cpu().numpy())
        res.timings[f"merge_{method}_s"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# Synchronized baseline (the paper's Hogwild stand-in) end to end.
# ---------------------------------------------------------------------------
def train_sync_baseline(
    corpus: Corpus,
    raw_vocab_size: int,
    cfg: SGNSConfig,
    epochs: int = 3,
    batch_size: int = 512,
    window: int | None = None,
    subsample_t: float | None = 1e-4,
    max_vocab: int | None = 300_000,
    seed: int = 0,
    max_steps_per_epoch: int | None = None,
    engine="dense",
    device=None,
    group=None,
):
    """One table trained on the whole corpus with the gradient
    synchronized every step (:func:`make_sync_epoch`) on ``device`` (the
    GPU unless ``device="cpu"``); ``group`` is the optional process group
    the gradients are all-reduced over. Returns ``(params, vocab, {"train_s",
    "steps_per_epoch", "losses"})``, ``losses`` one mean per epoch."""
    from repro_torch.core import sgns
    from repro_torch.data.pairs import extract_pairs

    device = resolve_device(device)
    engine = get_engine(engine)
    vocab = build_vocab(corpus, raw_vocab_size, min_count=1, max_size=max_vocab)
    cfg = SGNSConfig(**{**cfg.__dict__, "vocab_size": vocab.size})
    window = window if window is not None else cfg.window
    neg_table = _neg_tables([vocab], kind=engine.table_kind)
    # single model: drop the stacked leading worker axis
    neg_table = ({k: v[0] for k, v in neg_table.items()}
                 if isinstance(neg_table, dict) else neg_table[0])

    centers, contexts = extract_pairs(corpus, vocab, window=window,
                                      subsample_t=subsample_t, seed=seed)
    steps = max(1, len(centers) // batch_size)
    if max_steps_per_epoch is not None:
        steps = min(steps, max_steps_per_epoch)
    total_steps = steps * epochs
    epoch_fn = make_sync_epoch(cfg, neg_table, total_steps, group=group,
                               engine=engine, device=device)
    params = sgns.init_params(prng.PRNGKey(cfg.seed), cfg, device=device)
    need = steps * batch_size
    losses = []
    t0 = time.perf_counter()
    for epoch in range(epochs):
        rng = _epoch_rng(seed, _STREAM_SYNC_PERM, epoch)
        perm = _tiled_permutation(rng, len(centers), need)
        c = torch.from_numpy(centers[perm].reshape(steps, batch_size))
        x = torch.from_numpy(contexts[perm].reshape(steps, batch_size))
        params, ep_losses = epoch_fn(params, c, x,
                                     _epoch_key(seed, _STREAM_SYNC_EPOCH, epoch),
                                     epoch * steps)
        losses.append(float(ep_losses.mean()))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return params, vocab, {"train_s": time.perf_counter() - t0,
                           "steps_per_epoch": steps, "losses": losses}
