"""The traffic's data: the synthetic corpus and the numpy divide phase.

Frozen copies, at commit 69e108eca3b3, of the port's host-side data code:

* ``src/repro_torch/data/corpus.py``: ``Corpus``, ``SemanticCorpusModel``
  (``create``, ``topic_word_dists``, ``generate``); ``Corpus.select`` is
  the same gather without its loop;
* ``src/repro_torch/data/vocab.py``: ``Vocab``, ``build_vocab``,
  ``union_vocab``;
* ``src/repro_torch/core/sampling.py``: ``sample_sentence_indices``;
* ``src/repro_torch/core/driver.py``: ``_project_vocab``,
  ``build_worker_vocabs``;
* ``src/repro_torch/data/pairs.py``: ``subsample_mask``, ``extract_pairs``,
  ``unigram_noise_probs`` and the noise tables' layouts;
* ``src/repro_torch/data/pipeline.py``: ``_extract_seed`` and the fill of
  ``PairChunkStream.chunks`` (a worker's pair blocks, wrapped when its
  sample runs dry), here as :func:`pair_pool`;
* ``src/repro_torch/core/schedule.py``: ``plan_epoch``'s step count;
* ``src/repro_torch/core/distributions.py``: ``build_alias_table``.

:func:`rank_vocab` is the benchmark's own: a vocabulary of every word of
the corpus model, ids by the model's frequency rank, so the table's shape
does not move with the seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

UNK = -1


@dataclass(frozen=True)
class Corpus:
    tokens: np.ndarray   # (T,) int32
    offsets: np.ndarray  # (S+1,) int64

    @property
    def num_sentences(self) -> int:
        return len(self.offsets) - 1

    @property
    def num_tokens(self) -> int:
        return int(self.offsets[-1])

    def select(self, idx: np.ndarray) -> "Corpus":
        """Sub-corpus from sentence indices (repeats allowed)."""
        lengths = (self.offsets[1:] - self.offsets[:-1])[idx]
        new_offsets = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lengths, out=new_offsets[1:])
        starts = np.repeat(self.offsets[idx] - new_offsets[:-1], lengths)
        src = starts + np.arange(int(new_offsets[-1]), dtype=np.int64)
        return Corpus(tokens=self.tokens[src], offsets=new_offsets)


@dataclass(frozen=True)
class SemanticCorpusModel:
    vocab_size: int
    latents: np.ndarray
    topics: np.ndarray
    zipf_probs: np.ndarray
    centers: np.ndarray
    beta: float

    @staticmethod
    def create(vocab_size: int, num_topics: int = 16, num_features: int = 4,
               latent_dim: int = 12, zipf_a: float = 1.05, beta: float = 4.0,
               seed: int = 0) -> "SemanticCorpusModel":
        rng = np.random.default_rng(seed)
        centers = rng.normal(size=(num_topics, latent_dim))
        centers /= np.linalg.norm(centers, axis=1, keepdims=True)
        offs = 0.35 * rng.normal(size=(num_features, latent_dim))
        topics = rng.integers(0, num_topics, size=vocab_size)
        feats = (rng.random((vocab_size, num_features)) < 0.5).astype(np.int8)
        latents = centers[topics] + feats @ offs
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        zipf = ranks ** (-zipf_a)
        perm = rng.permutation(vocab_size)
        zipf = zipf[perm]
        zipf /= zipf.sum()
        return SemanticCorpusModel(vocab_size=vocab_size, latents=latents, topics=topics,
                                   zipf_probs=zipf, centers=centers, beta=beta)

    def topic_word_dists(self) -> np.ndarray:
        logits = self.beta * (self.latents @ self.centers.T)
        logits = logits - logits.max(axis=0, keepdims=True)
        p = self.zipf_probs[:, None] * np.exp(logits)
        p /= p.sum(axis=0, keepdims=True)
        return p.T

    def generate(self, num_sentences: int, mean_sentence_len: int = 20,
                 seed: int = 1) -> Corpus:
        rng = np.random.default_rng(seed)
        K = self.centers.shape[0]
        cdfs = np.cumsum(self.topic_word_dists(), axis=1)
        cdfs[:, -1] = 1.0
        lengths = rng.poisson(mean_sentence_len, size=num_sentences)
        lengths = np.clip(lengths, 3, None).astype(np.int64)
        sent_topics = rng.integers(0, K, size=num_sentences)
        offsets = np.zeros(num_sentences + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        total = int(offsets[-1])
        u = rng.random(total)
        tokens = np.empty(total, dtype=np.int32)
        tok_topic = np.repeat(sent_topics, lengths)
        for k in range(K):
            m = tok_topic == k
            if m.any():
                tokens[m] = np.searchsorted(cdfs[k], u[m]).astype(np.int32)
        np.clip(tokens, 0, self.vocab_size - 1, out=tokens)
        return Corpus(tokens=tokens, offsets=offsets)


@dataclass(frozen=True)
class Vocab:
    word_ids: np.ndarray    # (size,) raw word id per slot
    counts: np.ndarray      # (size,) occurrence counts
    lookup: np.ndarray      # (raw_vocab,) raw -> id or UNK

    @property
    def size(self) -> int:
        return len(self.word_ids)

    def unigram_probs(self) -> np.ndarray:
        return self.counts / max(int(self.counts.sum()), 1)


def build_vocab(corpus: Corpus, raw_vocab_size: int, min_count: int = 1,
                max_size: int | None = None) -> Vocab:
    counts = np.bincount(corpus.tokens, minlength=raw_vocab_size).astype(np.int64)
    order = np.argsort(-counts, kind="stable")
    order = order[counts[order] >= max(min_count, 1)]
    if max_size is not None:
        order = order[:max_size]
    lookup = np.full(raw_vocab_size, UNK, dtype=np.int32)
    lookup[order] = np.arange(len(order), dtype=np.int32)
    return Vocab(word_ids=order.astype(np.int32), counts=counts[order], lookup=lookup)


def union_vocab(vocabs: list[Vocab], raw_vocab_size: int) -> Vocab:
    counts = np.zeros(raw_vocab_size, dtype=np.int64)
    for v in vocabs:
        counts[v.word_ids] += v.counts
    order = np.argsort(-counts, kind="stable")
    order = order[counts[order] > 0]
    lookup = np.full(raw_vocab_size, UNK, dtype=np.int32)
    lookup[order] = np.arange(len(order), dtype=np.int32)
    return Vocab(word_ids=order.astype(np.int32), counts=counts[order], lookup=lookup)


def rank_vocab(corpus: Corpus, model: SemanticCorpusModel) -> Vocab:
    """Every word of the model, id = its rank in the model's Zipf prior
    (most probable first), counts from ``corpus``; unseen words keep their
    row with count 0."""
    order = np.argsort(-model.zipf_probs, kind="stable")
    counts = np.bincount(corpus.tokens, minlength=model.vocab_size).astype(np.int64)
    lookup = np.empty(model.vocab_size, dtype=np.int32)
    lookup[order] = np.arange(model.vocab_size, dtype=np.int32)
    return Vocab(word_ids=order.astype(np.int32), counts=counts[order], lookup=lookup)


def sample_sentence_indices(num_sentences: int, strategy: str, rate: float, worker: int,
                            num_workers: int, epoch: int = 0, seed: int = 0) -> np.ndarray:
    if not (0.0 < rate <= 1.0):
        raise ValueError(f"rate must be in (0, 1], got {rate}")
    target = max(1, int(round(rate * num_sentences)))
    if strategy == "equal":
        bounds = np.linspace(0, num_sentences, num_workers + 1).astype(np.int64)
        return np.arange(bounds[worker], bounds[worker + 1], dtype=np.int64)
    if strategy == "random":
        rng = np.random.default_rng((seed, 0x5EED, worker))
    elif strategy == "shuffle":
        rng = np.random.default_rng((seed, 0x5EED, worker, epoch))
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return rng.integers(0, num_sentences, size=target, dtype=np.int64)


def _project_vocab(worker_vocab: Vocab, union: Vocab, raw_vocab_size: int) -> Vocab:
    lookup = np.full(raw_vocab_size, UNK, dtype=np.int32)
    union_ids = union.lookup[worker_vocab.word_ids]
    lookup[worker_vocab.word_ids] = union_ids
    counts = np.zeros(union.size, dtype=np.int64)
    counts[union_ids] = worker_vocab.counts
    return Vocab(word_ids=union.word_ids, counts=counts, lookup=lookup)


def build_worker_vocabs(corpus: Corpus, raw_vocab_size: int, strategy: str, num_workers: int,
                        rate: float, max_vocab: int | None, base_min_count: int,
                        seed: int) -> tuple[list[Vocab], Vocab, np.ndarray]:
    """(worker vocabularies in the union's ids, the union, presence (n, V))."""
    if strategy == "shuffle":
        g = build_vocab(corpus, raw_vocab_size, min_count=1, max_size=max_vocab)
        return [g] * num_workers, g, np.ones((num_workers, g.size), dtype=bool)
    min_count = max(1, int(round(base_min_count / num_workers)))
    per_worker = []
    for w in range(num_workers):
        idx = sample_sentence_indices(corpus.num_sentences, strategy, rate, w, num_workers,
                                      epoch=0, seed=seed)
        per_worker.append(build_vocab(corpus.select(idx), raw_vocab_size,
                                      min_count=min_count, max_size=max_vocab))
    union = union_vocab(per_worker, raw_vocab_size)
    projected = [_project_vocab(v, union, raw_vocab_size) for v in per_worker]
    mask = np.zeros((num_workers, union.size), dtype=bool)
    for w, v in enumerate(per_worker):
        mask[w, union.lookup[v.word_ids]] = True
    return projected, union, mask


def subsample_mask(tokens: np.ndarray, vocab: Vocab, t: float,
                   rng: np.random.Generator) -> np.ndarray:
    freqs = vocab.unigram_probs()
    f = np.where(tokens == UNK, 1.0, freqs[np.clip(tokens, 0, None)])
    keep_prob = np.minimum(1.0, (np.sqrt(f / t) + 1.0) * (t / np.maximum(f, 1e-12)))
    keep = rng.random(len(tokens)) < keep_prob
    return keep & (tokens != UNK)


def extract_pairs(corpus: Corpus, vocab: Vocab, window: int, subsample_t: float | None,
                  seed) -> tuple[np.ndarray, np.ndarray]:
    """(centers, contexts) vocab ids: subsampled and UNK tokens leave the
    stream before windowing; each center draws its window from [1, win]."""
    rng = np.random.default_rng(seed)
    toks = vocab.lookup[corpus.tokens]
    if subsample_t is not None:
        keep = subsample_mask(toks, vocab, subsample_t, rng)
    else:
        keep = toks != UNK
    sent_id = np.repeat(np.arange(corpus.num_sentences, dtype=np.int64),
                        np.diff(corpus.offsets))
    toks, sent_id = toks[keep], sent_id[keep]
    n = len(toks)
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    dyn = rng.integers(1, window + 1, size=n)
    centers_parts, contexts_parts = [], []
    for off in range(1, window + 1):
        valid = np.arange(n - off)
        same_sent = sent_id[valid] == sent_id[valid + off]
        fwd = same_sent & (off <= dyn[valid])
        bwd = same_sent & (off <= dyn[valid + off])
        i = valid[fwd]
        centers_parts.append(toks[i])
        contexts_parts.append(toks[i + off])
        j = valid[bwd]
        centers_parts.append(toks[j + off])
        contexts_parts.append(toks[j])
    centers = np.concatenate(centers_parts).astype(np.int32)
    contexts = np.concatenate(contexts_parts).astype(np.int32)
    perm = rng.permutation(len(centers))
    return centers[perm], contexts[perm]


_SEED_DOMAIN = 0x91BE
_SUB_BLOCK = 1


def _block_seed(seed: int, worker: int, epoch: int, block: int) -> np.random.SeedSequence:
    return np.random.SeedSequence((_SEED_DOMAIN, _SUB_BLOCK, seed, worker, epoch, block))


def pair_blocks(corpus: Corpus, vocab: Vocab, worker: int, strategy: str, rate: float,
                num_workers: int, window: int, subsample_t: float | None, seed: int,
                epoch: int = 0, sentences_per_block: int = 1024):
    """A worker's pairs for ``epoch``, a block of its sample's sentences at
    a time."""
    idx = sample_sentence_indices(corpus.num_sentences, strategy, rate, worker, num_workers,
                                  epoch=epoch, seed=seed)
    for b, start in enumerate(range(0, len(idx), sentences_per_block)):
        sub = corpus.select(idx[start:start + sentences_per_block])
        c, x = extract_pairs(sub, vocab, window, subsample_t,
                             _block_seed(seed, worker, epoch, b))
        if len(c):
            yield c, x


def pair_pool(corpus: Corpus, vocabs: list[Vocab], strategy: str, rate: float, window: int,
              subsample_t: float | None, seed: int, steps: int,
              batch: int) -> tuple[np.ndarray, np.ndarray]:
    """The first ``steps`` batches of every worker's epoch-0 stream,
    ``(n, steps, batch)`` int32 centers and contexts; a worker whose sample
    runs dry starts it again."""
    n, need = len(vocabs), steps * batch
    centers = np.empty((n, need), dtype=np.int32)
    contexts = np.empty((n, need), dtype=np.int32)
    for w in range(n):
        got, have = [], 0
        while have < need:
            before = have
            for c, x in pair_blocks(corpus, vocabs[w], w, strategy, rate, n, window,
                                    subsample_t, seed):
                got.append((c, x))
                have += len(c)
                if have >= need:
                    break
            if have == before:
                raise ValueError(f"worker {w}: empty sample")
        centers[w] = np.concatenate([c for c, _ in got])[:need]
        contexts[w] = np.concatenate([x for _, x in got])[:need]
    shape = (n, steps, batch)
    return centers.reshape(shape), contexts.reshape(shape)


def epoch_steps(corpus: Corpus, vocabs: list[Vocab], strategy: str, rate: float, window: int,
                subsample_t: float | None, seed: int, batch: int) -> int:
    """Steps of one epoch: the smallest worker's epoch-0 pairs over the batch."""
    least = min(sum(len(c) for c, _ in pair_blocks(corpus, v, w, strategy, rate, len(vocabs),
                                                   window, subsample_t, seed))
                for w, v in enumerate(vocabs))
    return max(1, least // batch)


def unigram_noise_probs(counts: np.ndarray, power: float = 0.75) -> np.ndarray:
    p = np.asarray(counts, dtype=np.float64) ** power
    s = p.sum()
    return p / s if s > 0 else np.full_like(p, 1.0 / len(p))


def noise_cdf(counts: np.ndarray) -> np.ndarray:
    """The unigram^0.75 CDF, float32, its last entry 1."""
    c = np.cumsum(unigram_noise_probs(counts))
    c[-1] = 1.0
    return c.astype(np.float32)


def build_alias_table(probs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vose's alias table: (prob float64, alias int32)."""
    p = np.asarray(probs, dtype=np.float64)
    V = len(p)
    scaled = p * (V / p.sum())
    prob = np.ones(V, dtype=np.float64)
    alias = np.arange(V, dtype=np.int32)
    small = [i for i in range(V) if scaled[i] < 1.0]
    large = [i for i in range(V) if scaled[i] >= 1.0]
    while small and large:
        lo = small.pop()
        hi = large.pop()
        prob[lo] = scaled[lo]
        alias[lo] = hi
        scaled[hi] = (scaled[hi] + scaled[lo]) - 1.0
        (small if scaled[hi] < 1.0 else large).append(hi)
    for i in small + large:
        prob[i] = 1.0
        alias[i] = i
    return prob, alias


def noise_alias(counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The unigram^0.75 alias table: (prob float32, alias int32)."""
    prob, alias = build_alias_table(unigram_noise_probs(counts))
    return prob.astype(np.float32), alias.astype(np.int32)
