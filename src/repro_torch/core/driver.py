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
seed draws the same negatives.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.sgns import SGNSConfig
from repro_torch.core.async_trainer import AsyncShardTrainer, _mean_loss
from repro_torch.core.engine import get_engine
from repro_torch.core.merge import StackedModels, merge as merge_models
from repro_torch.core.schedule import plan_epoch
from repro_torch.data.corpus import Corpus
from repro_torch.data.pairs import stack_noise_tables
from repro_torch.data.vocab import Vocab, build_vocab, union_vocab, UNK
from repro_torch.data.pipeline import (
    HostShardPlan, make_worker_streams, prefetch_chunks)
from repro_torch.device import resolve_device

# PRNG streams: fold_in(fold_in(PRNGKey(seed), stream), epoch), as in the
# reference (its arithmetic-seed predecessors collided across runs).
_STREAM_ASYNC_DATA = 0      # per-chunk keys for the async workers' epochs

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
) -> PipelineResult:
    """Divide and train the n sub-models on ``device`` (the GPU unless
    ``device="cpu"``). Single process: ``process_count > 1`` raises."""
    if (process_count or 1) > 1:
        raise ValueError("the port trains in one process; process_count > 1 "
                         "is not supported")
    device = resolve_device(device)
    setup = prepare_training(
        corpus, raw_vocab_size, strategy, num_workers, cfg,
        epochs=epochs, batch_size=batch_size, rate=rate, window=window,
        subsample_t=subsample_t, max_vocab=max_vocab,
        base_min_count=base_min_count, seed=seed,
        max_steps_per_epoch=max_steps_per_epoch, engine=engine,
        steps_per_chunk=steps_per_chunk,
        sentences_per_block=sentences_per_block,
        process_index=process_index, process_count=process_count)
    cfg, engine, sched = setup.cfg, setup.engine, setup.sched
    neg_table = {k: v.to(device) for k, v in setup.neg_table.items()} \
        if isinstance(setup.neg_table, dict) else setup.neg_table.to(device)

    trainer = AsyncShardTrainer(cfg=cfg, num_workers=num_workers,
                                total_steps=sched.total_steps, engine=engine,
                                device=device)
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
    with torch.profiler.record_function("repro_torch.train_loop"):
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

    stacked = StackedModels(models=params["W"],
                            mask=torch.from_numpy(setup.mask).to(device))
    return PipelineResult(
        strategy=strategy, num_workers=num_workers, union_vocab=setup.union_vocab,
        stacked=stacked, timings={"vocab_s": setup.vocab_s, "train_s": t_train,
                                  "init_s": t_init, "chunk_wait_s": wait_s,
                                  "steps_per_epoch": sched.steps_per_epoch},
        losses=losses, chunk_losses=chunk_losses)


def run_pipeline(
    corpus: Corpus,
    raw_vocab_size: int,
    strategy: str = "shuffle",
    num_workers: int = 10,
    cfg: SGNSConfig | None = None,
    merge_methods: tuple[str, ...] = ("concat", "pca", "alir_pca"),
    merge_shard: int = 1,
    device=None,
    **kw,
) -> PipelineResult:
    """Train the sub-models and merge them with each of ``merge_methods``."""
    cfg = cfg or SGNSConfig(vocab_size=0, dim=64)
    res = train_submodels(corpus, raw_vocab_size, strategy, num_workers, cfg,
                          device=device, **kw)
    return apply_merges(res, merge_methods, out_dim=cfg.dim, shard=merge_shard)


def apply_merges(res: PipelineResult, merge_methods, out_dim: int, *,
                 shard: int = 1) -> PipelineResult:
    """Fold the stacked sub-models with each requested method on their
    device, recording wall-clock per method in ``res.timings``."""
    device = res.stacked.models.device
    for method in merge_methods:
        t0 = time.perf_counter()
        emb, valid = merge_models(res.stacked, method, out_dim=out_dim,
                                  key=prng.PRNGKey(42), shard=shard,
                                  device=device)
        res.merged[method] = (emb.cpu().numpy(), valid.cpu().numpy())
        res.timings[f"merge_{method}_s"] = time.perf_counter() - t0
    return res
