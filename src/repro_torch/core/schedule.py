"""Epoch/chunk/step bookkeeping for streamed training (the port's own
copy of ``repro.core.schedule``).

The streaming pipeline feeds the device fixed-shape chunks of
``chunk_steps`` batches, so an epoch must be a whole number of chunks,
and the linear LR decay is sized from ``total_steps`` — three coupled
quantities that used to be derived inline in ``train_submodels``. This
module is the single source of that derivation, so schedule consumers
(LR decay, chunk loops, wall-clock projections) can never drift apart.

Rounding policy: the epoch is fitted into whole chunks by *shrinking the
chunk*, never by rounding the epoch up past ``max_steps_per_epoch`` —
a step cap is a hard budget (word2vec's LR floor makes extra steps
harmless, but the paper's wall-clock tables assume the cap is exact).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EpochSchedule:
    """The one consistent answer to "how many steps is this run?".

    Invariants (asserted in tests):
      * ``steps_per_epoch == num_chunks * chunk_steps``
      * ``steps_per_epoch <= max_steps_per_epoch`` (when capped)
      * ``chunk_steps <= requested steps_per_chunk``
      * ``total_steps == steps_per_epoch * epochs``
    """

    steps_per_epoch: int
    chunk_steps: int
    num_chunks: int
    epochs: int

    @property
    def total_steps(self) -> int:
        """LR-decay horizon: every step the whole run will take."""
        return self.steps_per_epoch * self.epochs

    def step0(self, epoch: int, chunk: int) -> int:
        """Global index of the first step of ``chunk`` within ``epoch``
        (what the LR schedule sees)."""
        return epoch * self.steps_per_epoch + chunk * self.chunk_steps


def plan_epoch(
    min_pairs: int,
    batch_size: int,
    epochs: int,
    steps_per_chunk: int,
    max_steps_per_epoch: int | None = None,
) -> EpochSchedule:
    """Derive the epoch schedule from the streamed epoch-0 pair count.

    ``min_pairs`` is the smallest per-worker pair count (shorter streams
    wrap, so every worker runs the same step count). Always yields at
    least one step; an explicit cap is never exceeded.
    """
    if min_pairs <= 0:
        raise ValueError(f"min_pairs must be positive, got {min_pairs}")
    if batch_size <= 0 or epochs <= 0 or steps_per_chunk <= 0:
        raise ValueError("batch_size, epochs and steps_per_chunk must be "
                         "positive")
    steps = max(1, min_pairs // batch_size)
    if max_steps_per_epoch is not None:
        steps = min(steps, max_steps_per_epoch)
    num_chunks = -(-steps // min(steps_per_chunk, steps))
    chunk_steps = steps // num_chunks
    return EpochSchedule(steps_per_epoch=num_chunks * chunk_steps,
                         chunk_steps=chunk_steps, num_chunks=num_chunks,
                         epochs=epochs)
