"""The Divide phase — the paper's three data-division strategies
(numpy; the port's own copy of ``repro.core.sampling``).

* EQUAL PARTITIONING — sequentially cut the corpus into ``n`` contiguous
  equal slices (the paper's weak baseline: preserves neither unigram nor
  bigram distributions when the corpus has topical/temporal drift).
* RANDOM SAMPLING  — each worker draws ``r·N`` sentences u.a.r. *with
  replacement*, with a fixed per-worker seed: every epoch re-visits the
  same sample (paper §3.1, Theorem 1: expected unigram distribution of a
  sample equals the corpus distribution).
* SHUFFLE          — identical to RANDOM SAMPLING except the draw is
  re-seeded every epoch, so a worker sees a *fresh* sample per epoch
  (paper §3.2: stateless, regularizing, best quality in Table 2).

All three are deterministic functions of (worker, epoch, seed), which is
what makes the TPU realization stateless — no materialized sub-corpora.
"""

from __future__ import annotations

import numpy as np

STRATEGIES = ("equal", "random", "shuffle")


def sample_sentence_indices(
    num_sentences: int,
    strategy: str,
    rate: float,
    worker: int,
    num_workers: int,
    epoch: int = 0,
    seed: int = 0,
) -> np.ndarray:
    """Sentence indices forming ``worker``'s sub-corpus for ``epoch``."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; expected one of {STRATEGIES}")
    if not (0.0 < rate <= 1.0):
        raise ValueError(f"rate must be in (0, 1], got {rate}")
    target = max(1, int(round(rate * num_sentences)))

    if strategy == "equal":
        # Contiguous slice; ignores `rate` in favour of exact n-way split
        # (the paper's equal partitioning is 100/r partitions of rN/100
        # sentences each — identical when rate == 1/num_workers).
        bounds = np.linspace(0, num_sentences, num_workers + 1).astype(np.int64)
        return np.arange(bounds[worker], bounds[worker + 1], dtype=np.int64)

    if strategy == "random":
        rng = np.random.default_rng((seed, 0x5EED, worker))
    else:  # shuffle: fresh sample every epoch
        rng = np.random.default_rng((seed, 0x5EED, worker, epoch))
    return rng.integers(0, num_sentences, size=target, dtype=np.int64)

