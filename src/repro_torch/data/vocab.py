"""Vocabulary construction, mirroring word2vec / the paper's setup
(numpy; the port's own copy of ``repro.data.vocab``).

The paper: vocabulary filtered by frequency (300K cap for Hogwild and
Shuffle; min-count ``100/k`` for the k sub-models of the random-sampling
variants). We reproduce both policies.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.data.corpus import Corpus

UNK = -1  # tokens outside the vocab map to UNK and are dropped from pairs


@dataclass(frozen=True)
class Vocab:
    """Mapping from raw word ids to contiguous vocab ids [0, size)."""

    word_ids: np.ndarray    # (size,) raw word id per vocab slot, freq-sorted desc
    counts: np.ndarray      # (size,) occurrence counts
    lookup: np.ndarray      # (raw_vocab,) raw -> vocab id or UNK

    @property
    def size(self) -> int:
        return len(self.word_ids)

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def unigram_probs(self) -> np.ndarray:
        return self.counts / max(self.total, 1)

    def encode(self, raw_tokens: np.ndarray) -> np.ndarray:
        return self.lookup[raw_tokens]

    def contains_raw(self, raw: np.ndarray) -> np.ndarray:
        return self.lookup[raw] != UNK


def build_vocab(
    corpus: Corpus,
    raw_vocab_size: int,
    min_count: int = 1,
    max_size: int | None = None,
) -> Vocab:
    counts = np.bincount(corpus.tokens, minlength=raw_vocab_size).astype(np.int64)
    order = np.argsort(-counts, kind="stable")
    keep = counts[order] >= max(min_count, 1)
    order = order[keep]
    if max_size is not None:
        order = order[:max_size]
    lookup = np.full(raw_vocab_size, UNK, dtype=np.int32)
    lookup[order] = np.arange(len(order), dtype=np.int32)
    return Vocab(word_ids=order.astype(np.int32), counts=counts[order], lookup=lookup)


def union_vocab(vocabs: list[Vocab], raw_vocab_size: int) -> Vocab:
    """Union of sub-model vocabularies (the ALiR merge operates on this)."""
    counts = np.zeros(raw_vocab_size, dtype=np.int64)
    for v in vocabs:
        counts[v.word_ids] += v.counts
    order = np.argsort(-counts, kind="stable")
    order = order[counts[order] > 0]
    lookup = np.full(raw_vocab_size, UNK, dtype=np.int32)
    lookup[order] = np.arange(len(order), dtype=np.int32)
    return Vocab(word_ids=order.astype(np.int32), counts=counts[order], lookup=lookup)


def intersection_raw_ids(vocabs: list[Vocab]) -> np.ndarray:
    """Raw word ids present in every sub-model (Concat/PCA operate here)."""
    common = set(vocabs[0].word_ids.tolist())
    for v in vocabs[1:]:
        common &= set(v.word_ids.tolist())
    return np.array(sorted(common), dtype=np.int32)
