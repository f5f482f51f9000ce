"""Worker cursors: the resume coordinate of an elastic worker.

A :class:`WorkerCursor` names the exact point in a worker's deterministic
work stream where training will continue: the epoch, the chunk index
within it, and the counter-PRNG/LR step offset of that chunk's first
step. Everything a worker consumes is a pure function of
``(seed, worker, epoch, chunk)`` — the pair chunks
(:meth:`repro_torch.data.pipeline.PairChunkStream.chunks` with
``start_chunk=``), the per-chunk PRNG key
(:func:`repro_torch.core.driver.worker_chunk_key`) and the LR/negative-draw
step counter (:meth:`repro_torch.core.schedule.EpochSchedule.step0`) — so the
cursor plus the run configuration is *sufficient* state: a worker
resumed from it on any host replays the remainder of its stream
bit-exactly.

The port's own copy of ``repro.elastic.cursor``; cursors round-trip
through either package's checkpoint manifests.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.schedule import EpochSchedule

_CURSOR_FIELDS = ("worker", "epoch", "chunk", "step0")


@dataclass(frozen=True)
class WorkerCursor:
    """Position of the NEXT chunk this worker will train.

    ``step0`` is redundant with ``(epoch, chunk)`` under a fixed
    :class:`EpochSchedule` — it is stored anyway and cross-checked on
    resume (:meth:`validate`), so a checkpoint written under a different
    schedule (corpus changed, step cap changed) fails loudly instead of
    silently training with a shifted LR/negative stream.
    """

    worker: int
    epoch: int
    chunk: int
    step0: int

    def __post_init__(self):
        for name in _CURSOR_FIELDS:
            v = getattr(self, name)
            if not isinstance(v, int) or v < 0:
                raise ValueError(f"cursor field {name!r} must be a "
                                 f"non-negative int, got {v!r}")

    # ------------------------------------------------------ construction
    @classmethod
    def start(cls, worker: int) -> "WorkerCursor":
        """Fresh worker: epoch 0, chunk 0, step 0."""
        return cls(worker=worker, epoch=0, chunk=0, step0=0)

    @classmethod
    def from_meta(cls, meta: dict) -> "WorkerCursor":
        """Inverse of :meth:`to_meta` (checkpoint manifest round-trip)."""
        return cls(**{k: int(meta[k]) for k in _CURSOR_FIELDS})

    def to_meta(self) -> dict:
        """JSON-safe dict stored as checkpoint-manifest metadata."""
        return {k: int(getattr(self, k)) for k in _CURSOR_FIELDS}

    # -------------------------------------------------------- progression
    def advanced(self, sched: EpochSchedule) -> "WorkerCursor":
        """Cursor after training the chunk this one points at, wrapping
        into the next epoch at the chunk horizon."""
        epoch, chunk = self.epoch, self.chunk + 1
        if chunk >= sched.num_chunks:
            epoch, chunk = epoch + 1, 0
        return WorkerCursor(worker=self.worker, epoch=epoch, chunk=chunk,
                            step0=epoch * sched.steps_per_epoch
                            + chunk * sched.chunk_steps)

    def done(self, epochs: int) -> bool:
        """True once every chunk of every epoch has been trained."""
        return self.epoch >= epochs

    # -------------------------------------------------------- validation
    def validate(self, sched: EpochSchedule) -> None:
        """Reject a cursor that does not belong to ``sched`` — the
        schedule-drift guard run on every resume."""
        if self.chunk >= sched.num_chunks:
            raise ValueError(
                f"cursor chunk {self.chunk} out of range for a "
                f"{sched.num_chunks}-chunk schedule")
        expect = sched.step0(self.epoch, self.chunk)
        if self.step0 != expect:
            raise ValueError(
                f"cursor step0={self.step0} disagrees with the schedule "
                f"({expect} for epoch={self.epoch}, chunk={self.chunk}); "
                "the checkpoint was written under a different schedule")

    def global_chunk_index(self, sched: EpochSchedule) -> int:
        """Flat chunk index across epochs under ``sched`` — the
        checkpoint-cadence anchor: tied to stream position, not to any
        host's execution history, so a resumed run checkpoints at the
        same boundaries the uninterrupted run would have."""
        return self.epoch * sched.num_chunks + self.chunk
