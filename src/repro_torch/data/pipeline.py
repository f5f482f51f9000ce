"""Per-worker sample streams and the chunk pipeline that feeds the trainer.

The port's copy of ``repro.data.pipeline``. Each worker draws its own
sample directly from the (shared, read-only) corpus with a deterministic
numpy stream — ``seed = hash(worker, epoch)`` for Shuffle,
``hash(worker)`` for fixed RANDOM SAMPLING — so no shuffle phase exists
and every chunk is bitwise equal to the reference's.

What differs is the device copy in :func:`prefetch_chunks`: pinned host
memory plus a ``non_blocking`` copy on a side CUDA stream, with an event
the consumer's stream waits on.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.data.corpus import Corpus
from repro_torch.data.vocab import Vocab
from repro_torch.data.pairs import extract_pairs
from repro_torch.core.sampling import sample_sentence_indices

# Pair-extraction RNG streams: domain-tagged SeedSequence tuples, equal
# to the reference's (the leading constant keeps them disjoint from the
# driver's epoch streams; the sub-tag keeps whole-epoch and per-block
# extraction apart, since SeedSequence absorbs trailing zero words).
_SEED_DOMAIN = 0x91BE       # pipeline pair extraction
_SUB_EPOCH, _SUB_BLOCK = 0, 1


def _extract_seed(seed: int, worker: int, epoch: int,
                  block: int | None = None) -> np.random.SeedSequence:
    if block is None:
        return np.random.SeedSequence(
            (_SEED_DOMAIN, _SUB_EPOCH, seed, worker, epoch))
    return np.random.SeedSequence(
        (_SEED_DOMAIN, _SUB_BLOCK, seed, worker, epoch, block))


@dataclass
class WorkerStream:
    """One sub-model's training stream for one epoch."""

    corpus: Corpus
    vocab: Vocab
    worker: int
    strategy: str           # 'equal' | 'random' | 'shuffle'
    rate: float             # sampling rate r in (0, 1]
    num_workers: int
    window: int = 10
    subsample_t: float | None = 1e-4
    seed: int = 0

    def sentence_indices(self, epoch: int) -> np.ndarray:
        """This worker's sentence sample for ``epoch``."""
        return sample_sentence_indices(
            num_sentences=self.corpus.num_sentences,
            strategy=self.strategy,
            rate=self.rate,
            worker=self.worker,
            num_workers=self.num_workers,
            epoch=epoch,
            seed=self.seed,
        )

    def pairs(self, epoch: int, max_pairs: int | None = None):
        """All of this worker's ``(centers, contexts)`` pairs for
        ``epoch``, materialized in one pass."""
        idx = self.sentence_indices(epoch)
        sub = self.corpus.select(idx)
        return extract_pairs(
            sub,
            self.vocab,
            window=self.window,
            subsample_t=self.subsample_t,
            seed=_extract_seed(self.seed, self.worker, epoch),
            max_pairs=max_pairs,
        )

    def pair_blocks(
        self, epoch: int, sentences_per_block: int = 1024
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Stream (centers, contexts) per sentence-block; deterministic
        in (seed, worker, epoch, block)."""
        idx = self.sentence_indices(epoch)
        for b, start in enumerate(range(0, len(idx), sentences_per_block)):
            sub = self.corpus.select(idx[start : start + sentences_per_block])
            c, x = extract_pairs(
                sub,
                self.vocab,
                window=self.window,
                subsample_t=self.subsample_t,
                seed=_extract_seed(self.seed, self.worker, epoch, block=b),
            )
            if len(c):
                yield c, x

    def count_pairs(self, epoch: int, sentences_per_block: int = 1024,
                    max_pairs: int | None = None) -> int:
        """Number of pairs the block stream yields for ``epoch``, counted
        block by block; stops early once ``max_pairs`` is reached."""
        total = 0
        for c, _ in self.pair_blocks(epoch, sentences_per_block):
            total += len(c)
            if max_pairs is not None and total >= max_pairs:
                break
        return total

    def batches(
        self, epoch: int, batch_size: int, max_pairs: int | None = None
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Full-batch slices of :meth:`pairs` (the materialized path; the
        trailing partial batch is dropped)."""
        centers, contexts = self.pairs(epoch, max_pairs=max_pairs)
        n = (len(centers) // batch_size) * batch_size
        for i in range(0, n, batch_size):
            yield centers[i : i + batch_size], contexts[i : i + batch_size]


def make_worker_streams(
    corpus: Corpus,
    vocab: Vocab,
    num_workers: int,
    strategy: str,
    rate: float | None = None,
    **kw,
) -> list[WorkerStream]:
    """One :class:`WorkerStream` per worker, ordered by worker id.
    ``rate`` defaults to the paper's ``1/num_workers``; extra kwargs
    (``window``, ``subsample_t``, ``seed``) pass through."""
    rate = rate if rate is not None else 1.0 / num_workers
    return [
        WorkerStream(
            corpus=corpus,
            vocab=vocab,
            worker=w,
            strategy=strategy,
            rate=rate,
            num_workers=num_workers,
            **kw,
        )
        for w in range(num_workers)
    ]


@dataclass
class PairChunkStream:
    """Fixed-shape ``(n_workers, steps_per_chunk, batch)`` chunk producer.

    Each worker's epoch is consumed a block of sentences at a time and
    packed into buffers whose shape never changes; workers whose epoch
    runs dry wrap around (the block stream is deterministic, so a wrap
    replays the same pairs).
    """

    streams: list[WorkerStream]
    batch_size: int
    steps_per_chunk: int
    sentences_per_block: int = 1024

    @property
    def num_workers(self) -> int:
        return len(self.streams)

    @property
    def chunk_pairs(self) -> int:
        return self.batch_size * self.steps_per_chunk

    def chunks(
        self, epoch: int, num_chunks: int | None = None,
        start_chunk: int = 0,
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yield (centers, contexts) int32 arrays of shape
        (n_workers, steps_per_chunk, batch) for chunk indices
        ``[start_chunk, num_chunks)`` (infinite when ``num_chunks`` is
        ``None``). The first ``start_chunk`` chunks are extracted and
        discarded through the same fill path, so the yielded tail is
        bitwise the suffix of the uninterrupted stream."""
        if start_chunk < 0:
            raise ValueError(f"start_chunk must be >= 0, got {start_chunk}")
        if num_chunks is not None and start_chunk > num_chunks:
            raise ValueError(
                f"start_chunk {start_chunk} past the stream's "
                f"num_chunks {num_chunks}")
        n, need = self.num_workers, self.chunk_pairs
        gens = [s.pair_blocks(epoch, self.sentences_per_block)
                for s in self.streams]
        bufs: list[list[np.ndarray]] = [[] for _ in range(n)]
        xufs: list[list[np.ndarray]] = [[] for _ in range(n)]
        have = [0] * n
        pass_pairs = [0] * n   # pairs seen since this worker's last wrap

        def fill_and_cut(w: int, centers=None, contexts=None) -> None:
            # Advance worker w's buffers by one chunk's worth of pairs;
            # write the chunk rows out only when asked.
            while have[w] < need:
                try:
                    c, x = next(gens[w])
                except StopIteration:
                    if pass_pairs[w] == 0:
                        raise ValueError(
                            f"worker {w} epoch {epoch}: empty sample")
                    pass_pairs[w] = 0
                    gens[w] = self.streams[w].pair_blocks(
                        epoch, self.sentences_per_block)
                    continue
                bufs[w].append(c)
                xufs[w].append(x)
                have[w] += len(c)
                pass_pairs[w] += len(c)
            flat_c = np.concatenate(bufs[w])
            flat_x = np.concatenate(xufs[w])
            if centers is not None:
                centers[w] = flat_c[:need]
                contexts[w] = flat_x[:need]
            bufs[w] = [flat_c[need:]]
            xufs[w] = [flat_x[need:]]
            have[w] -= need

        done = 0
        while done < start_chunk:
            for w in range(n):
                fill_and_cut(w)
            done += 1
        while num_chunks is None or done < num_chunks:
            centers = np.empty((n, need), dtype=np.int32)
            contexts = np.empty((n, need), dtype=np.int32)
            for w in range(n):
                fill_and_cut(w, centers, contexts)
            shape = (n, self.steps_per_chunk, self.batch_size)
            yield centers.reshape(shape), contexts.reshape(shape)
            done += 1


# ---------------------------------------------------------------------------
# Ingestion planning (single process in the port).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class HostShardPlan:
    """Which workers' chunk streams this process extracts: the
    contiguous block ``[p·W//P, (p+1)·W//P)``. A pure value, so any
    ``process_count`` can be planned in one process; a multi-process run
    trains each process's block on its own device
    (:func:`repro_torch.core.driver.train_submodels`)."""

    process_index: int
    process_count: int
    num_workers: int

    def __post_init__(self):
        if self.process_count < 1:
            raise ValueError(f"process_count must be >= 1, got {self.process_count}")
        if not (0 <= self.process_index < self.process_count):
            raise ValueError(
                f"process_index {self.process_index} outside "
                f"[0, {self.process_count})")
        if self.num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {self.num_workers}")

    @property
    def start(self) -> int:
        return (self.process_index * self.num_workers) // self.process_count

    @property
    def stop(self) -> int:
        return ((self.process_index + 1) * self.num_workers) // self.process_count

    @property
    def workers(self) -> range:
        return range(self.start, self.stop)

    @property
    def num_local(self) -> int:
        return self.stop - self.start

    @classmethod
    def for_runtime(cls, num_workers: int, process_index: int | None = None,
                    process_count: int | None = None) -> "HostShardPlan":
        """Plan for this process; unpinned fields default to the rank and
        world size of the ``torch.distributed`` default group (one process
        when none is initialised)."""
        from repro_torch.launch.mesh import world

        rank, size = world()
        return cls(process_index=rank if process_index is None else process_index,
                   process_count=size if process_count is None else process_count,
                   num_workers=num_workers)

    @classmethod
    def all_hosts(cls, process_count: int,
                  num_workers: int) -> list["HostShardPlan"]:
        """One plan per simulated host."""
        return [cls(p, process_count, num_workers)
                for p in range(process_count)]

    def local_streams(self, streams: Sequence[WorkerStream]
                      ) -> list[WorkerStream]:
        """This process's slice of the global per-worker stream list."""
        if len(streams) != self.num_workers:
            raise ValueError(
                f"plan covers {self.num_workers} workers, got "
                f"{len(streams)} streams")
        for w, s in zip(self.workers, streams[self.start:self.stop]):
            if s.worker != w:
                raise ValueError(
                    f"stream at global position {w} claims worker "
                    f"{s.worker}; streams must be ordered by worker id")
        return list(streams[self.start:self.stop])

    def chunk_stream(self, streams: Sequence[WorkerStream], *,
                     batch_size: int, steps_per_chunk: int,
                     sentences_per_block: int = 1024) -> PairChunkStream:
        """The process-local :class:`PairChunkStream`."""
        return PairChunkStream(
            self.local_streams(streams), batch_size=batch_size,
            steps_per_chunk=steps_per_chunk,
            sentences_per_block=sentences_per_block)

    def validate_for_mesh(self, mesh=None) -> None:
        """Check that the plan can train on ``mesh``: a process group (or
        its world size; default ``process_count``) of exactly
        ``process_count`` ranks, and even per-process blocks (every rank
        gathers equal-shaped blocks in the merge phase)."""
        import torch.distributed as dist

        size = (self.process_count if mesh is None else
                mesh if isinstance(mesh, int) else dist.get_world_size(mesh))
        if self.num_workers % self.process_count != 0:
            raise ValueError(
                f"num_workers={self.num_workers} must divide evenly over "
                f"{self.process_count} processes for per-process blocks (got uneven blocks)")
        if self.num_workers % size != 0 or size != self.process_count:
            raise ValueError(
                f"num_workers={self.num_workers} over a world of {size} ranks: the plan "
                f"has {self.process_count} processes")

    def describe(self) -> str:
        """One-line plan summary."""
        return (f"host {self.process_index}/{self.process_count}: "
                f"workers [{self.start}, {self.stop}) "
                f"({self.num_local} of {self.num_workers})")


_SENTINEL = object()


def prefetch_chunks(iterator, depth: int = 2, device=None):
    """Double-buffered prefetch: a background thread extracts the next
    chunk(s) and starts their copy to ``device`` while the caller's
    device work runs.

    ``device=None`` yields the host arrays unchanged; a CPU device
    yields tensors sharing the arrays' memory; a CUDA device copies each
    array from pinned host memory with ``non_blocking=True`` on a side
    stream, and the consumer's current stream waits on the copy's event
    before the tensors are handed out.

    ``depth`` bounds the queue. Producer-thread lifecycle guarantees
    (as the reference's):

    * an exception anywhere in the producer (extraction or the copy) is
      delivered to the consumer and re-raised — including when the
      queue is full at the time it is raised;
    * abandoning the generator (``close()`` / ``break`` / consumer
      exception) releases and **joins** the producer thread;
    * a producer thread that dies without delivering its sentinel or
      exception surfaces as ``RuntimeError`` instead of a hang.
    """
    if depth < 1:
        raise ValueError("prefetch depth must be >= 1")
    dev = None if device is None else torch.device(device)
    return _prefetch_gen(iterator, depth, dev)


def _prefetch_gen(iterator, depth: int, device):
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    cuda = device is not None and device.type == "cuda"
    side = torch.cuda.Stream(device=device) if cuda else None

    def put(item) -> bool:
        # Bounded put that gives up when the consumer abandons the
        # generator, so the thread never blocks forever on a full queue.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def transfer(item):
        if device is None:
            return item, None
        if not cuda:
            return tuple(torch.from_numpy(np.asarray(a)) for a in item), None
        with torch.cuda.stream(side):
            pinned = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                      for a in item]
            out = tuple(p.to(device, non_blocking=True) for p in pinned)
            done = torch.cuda.Event()
            done.record(side)
        # the pinned buffers ride along until the consumer has waited
        return out, (done, pinned)

    def produce():
        try:
            for item in iterator:
                if not put(transfer(item)):
                    return
            put(_SENTINEL)
        except BaseException as e:  # surface extraction errors to the consumer
            put(e)

    thread = threading.Thread(target=produce, daemon=True,
                              name="prefetch_chunks")
    thread.start()
    try:
        while True:
            try:
                item = q.get(timeout=0.5)
            except queue.Empty:
                if not thread.is_alive():
                    raise RuntimeError(
                        "prefetch_chunks producer thread died without "
                        "delivering a chunk, sentinel or exception")
                continue
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            tensors, pending = item
            if pending is not None:
                done, _ = pending
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(done)
                for t in tensors:
                    t.record_stream(consumer)
            yield tensors
    finally:
        stop.set()
        # Unblock a producer waiting on the full queue, then reap it.
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)



def stacked_pair_batches(
    streams: list[WorkerStream],
    epoch: int,
    batch_size: int,
    num_batches: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(n_workers, num_batches, batch) arrays: one :class:`PairChunkStream`
    chunk covering the whole request, so streamed and materialized
    consumers see the same batches for the same seed."""
    stream = PairChunkStream(streams, batch_size=batch_size,
                             steps_per_chunk=num_batches)
    return next(stream.chunks(epoch, num_chunks=1))
