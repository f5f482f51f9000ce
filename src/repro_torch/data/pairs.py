"""Skip-gram (center, context) pair extraction and the noise tables.

The port's own copy of the host-side half of ``repro.data.pairs``:

* dynamic window — the effective window for each center is drawn
  uniformly from [1, win] (word2vec's ``b`` trick);
* frequent-word subsampling with the usual ``(sqrt(f/t)+1)·t/f`` keep
  probability;
* the unigram^0.75 noise distribution as a CDF or a Vose alias table,
  one per sub-model, stacked along a leading worker axis;
* the two ``jax.random`` negative samplers that draw from those tables
  (``cdf``: inverse-CDF lookup; ``alias``: Vose draw), worker-batched.

Pair extraction is numpy and bitwise equal to the reference's; the
noise tables are torch tensors (built in float64 on the host, stored as
float32/int32). The samplers are plain torch ops on the tables' device
(they are XLA ops, not Pallas kernels, in the reference); each worker's
ids are bitwise equal to ``jax.vmap`` of the reference sampler over the
same keys. :class:`NegativeSampler` and :class:`AliasSampler` hold one
vocabulary's table on a device and draw from it with one key.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.data.corpus import Corpus
from repro_torch.data.vocab import Vocab, UNK
from repro_torch.device import resolve_device


def subsample_mask(
    tokens: np.ndarray, vocab: Vocab, t: float = 1e-4, rng: np.random.Generator | None = None
) -> np.ndarray:
    """word2vec frequent-word subsampling. tokens are vocab ids (UNK allowed)."""
    rng = rng or np.random.default_rng(0)
    freqs = vocab.unigram_probs()
    f = np.where(tokens == UNK, 1.0, freqs[np.clip(tokens, 0, None)])
    keep_prob = np.minimum(1.0, (np.sqrt(f / t) + 1.0) * (t / np.maximum(f, 1e-12)))
    keep = rng.random(len(tokens)) < keep_prob
    return keep & (tokens != UNK)


def extract_pairs(
    corpus: Corpus,
    vocab: Vocab,
    window: int = 10,
    subsample_t: float | None = 1e-4,
    seed: int | np.random.SeedSequence = 0,
    max_pairs: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Return (centers, contexts) vocab-id arrays for the whole corpus.

    Implements word2vec semantics: subsampled/UNK tokens are removed from
    the stream *before* windowing (so windows reach across removed
    words), and each center uses a dynamic window size.
    """
    rng = np.random.default_rng(seed)
    toks = vocab.encode(corpus.tokens)
    if subsample_t is not None:
        keep = subsample_mask(toks, vocab, t=subsample_t, rng=rng)
    else:
        keep = toks != UNK

    # Sentence id per token, so windows never cross sentence boundaries.
    sent_id = np.repeat(
        np.arange(corpus.num_sentences, dtype=np.int64),
        np.diff(corpus.offsets),
    )
    toks, sent_id = toks[keep], sent_id[keep]
    n = len(toks)
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)

    dyn = rng.integers(1, window + 1, size=n)
    centers_parts, contexts_parts = [], []
    for off in range(1, window + 1):
        # pair (i, i+off) valid both directions when off <= dyn of the center
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
    centers, contexts = centers[perm], contexts[perm]
    if max_pairs is not None:
        centers, contexts = centers[:max_pairs], contexts[:max_pairs]
    return centers, contexts


# ---------------------------------------------------------------------------
# Negative sampling: two interchangeable draws, worker-batched. Tables are
# ``(n, V)`` (a CDF, or ``{"prob", "alias"}``), keys ``(n, 2)`` (numpy
# uint32 words or a tensor holding their bits, as the trainer's per-step
# seeds), ids ``(n, *shape)`` int32 on the tables' device.
# ---------------------------------------------------------------------------
def cdf_to_ids(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF lookup per worker: the id ``i`` with ``cdf[w, i-1] <=
    u < cdf[w, i]``, for ``cdf`` ``(n, V)`` and ``u`` ``(n, ...)``.

    ``right=True`` (jax's ``side="right"``) is load-bearing: an id with
    zero probability (``cdf[i] == cdf[i-1]``, a union-vocabulary row this
    worker never saw) is unreachable, even for ``u == 0.0`` or a ``u``
    exactly on a repeated boundary."""
    n, V = cdf.shape
    idx = torch.searchsorted(cdf, u.reshape(n, -1), right=True)
    return torch.clamp(idx, 0, V - 1).to(torch.int32).reshape(u.shape)


def sample_negatives_cdf(cdf: torch.Tensor, keys,
                         shape: tuple[int, ...]) -> torch.Tensor:
    """``(n, *shape)`` ids: worker w's ``uniform(keys[w], shape)``
    through its own CDF."""
    u = prng.uniform(prng.key_tensor(keys, cdf.device), shape)
    return cdf_to_ids(cdf, u)


def sample_negatives_alias(table: dict, keys,
                           shape: tuple[int, ...]) -> torch.Tensor:
    """``(n, *shape)`` ids: worker w splits its key, draws a
    ``randint`` index and a uniform, and keeps the index if the uniform
    falls under its ``prob``, else takes its ``alias``."""
    prob, alias = table["prob"], table["alias"]
    n, V = prob.shape
    k = prng.split(prng.key_tensor(keys, prob.device))          # (n, 2, 2)
    idx = prng.randint(k[:, 0], shape, 0, V)
    u = prng.uniform(k[:, 1], shape)
    flat = idx.reshape(n, -1).long()
    p = torch.gather(prob, 1, flat).reshape(idx.shape)
    a = torch.gather(alias, 1, flat).reshape(idx.shape)
    return torch.where(u < p, idx, a.to(torch.int32))


NEGATIVE_SAMPLERS = {
    "cdf": sample_negatives_cdf,
    "alias": sample_negatives_alias,
}


def negative_sampler_fn(kind: str):
    """``fn(table, keys, shape) -> (n, *shape) int32`` for ``kind``."""
    try:
        return NEGATIVE_SAMPLERS[kind]
    except KeyError:
        raise ValueError(
            f"unknown negative sampler {kind!r}; expected one of "
            f"{sorted(NEGATIVE_SAMPLERS)}") from None


def unigram_noise_probs(vocab_counts: np.ndarray, power: float = 0.75) -> np.ndarray:
    """word2vec noise distribution: unigram counts raised to 3/4."""
    p = np.asarray(vocab_counts, dtype=np.float64) ** power
    s = p.sum()
    return p / s if s > 0 else np.full_like(p, 1.0 / len(p))


def build_noise_table(vocab_counts: np.ndarray, kind: str = "cdf",
                      power: float = 0.75):
    """One vocab's unigram^0.75 noise table in the layout ``kind``
    draws from: a ``(V,)`` float32 CDF, or a ``{'prob', 'alias'}`` Vose
    alias table (float32/int32 — the fused kernel's operands). CPU
    tensors; the trainer moves them to its device."""
    p = unigram_noise_probs(vocab_counts, power)
    if kind == "cdf":
        c = np.cumsum(p)
        c[-1] = 1.0
        return torch.from_numpy(c.astype(np.float32))
    if kind == "alias":
        from repro_torch.core.distributions import build_alias_table

        prob, alias = build_alias_table(p)
        return {"prob": torch.from_numpy(prob.astype(np.float32)),
                "alias": torch.from_numpy(alias.astype(np.int32))}
    raise ValueError(f"unknown noise-table kind {kind!r}; "
                     f"expected 'cdf' or 'alias'")


def stack_noise_tables(counts_per_worker: list[np.ndarray], kind: str = "cdf",
                       power: float = 0.75):
    """Stacked per-worker noise tables: ``(n, V)`` CDFs, or
    ``{'prob': (n, V), 'alias': (n, V)}`` alias tables. Each sub-model
    draws from its *own* sample's noise distribution (paper §3.2).
    Workers with identical counts (the ``shuffle`` strategy's shared
    vocabulary) share one build."""
    built: dict[bytes, object] = {}
    tables = []
    for c in counts_per_worker:
        c = np.asarray(c)
        sig = c.tobytes() + str(c.dtype).encode()
        if sig not in built:
            built[sig] = build_noise_table(c, kind=kind, power=power)
        tables.append(built[sig])
    if kind == "cdf":
        return torch.stack(tables)
    return {k: torch.stack([t[k] for t in tables]) for k in ("prob", "alias")}


class NegativeSampler:
    """Unigram^0.75 sampler: inverse-CDF lookup. ``cdf`` and ``probs`` are
    float32 tensors on ``device`` (the GPU unless ``device="cpu"``)."""

    def __init__(self, vocab_counts: np.ndarray, power: float = 0.75, device=None):
        device = resolve_device(device)
        p = unigram_noise_probs(vocab_counts, power)
        cdf = np.cumsum(p)
        cdf[-1] = 1.0
        self.cdf = torch.tensor(cdf, dtype=torch.float32, device=device)
        self.probs = torch.tensor(p, dtype=torch.float32, device=device)

    def sample(self, key, shape: tuple[int, ...]) -> torch.Tensor:
        """``shape`` int32 ids, bitwise the reference's draw under ``key``."""
        return sample_negatives_cdf(self.cdf[None], np.asarray(key)[None], shape)[0]


class AliasSampler:
    """Unigram^0.75 sampler via Vose's alias method: O(V) build, O(1) draw.
    ``prob``, ``alias`` and ``probs`` are tensors on ``device`` (the GPU
    unless ``device="cpu"``)."""

    def __init__(self, vocab_counts: np.ndarray, power: float = 0.75, device=None):
        from repro_torch.core.distributions import build_alias_table

        device = resolve_device(device)
        p = unigram_noise_probs(vocab_counts, power)
        prob, alias = build_alias_table(p)
        self.prob = torch.tensor(prob, dtype=torch.float32, device=device)
        self.alias = torch.tensor(alias, dtype=torch.int32, device=device)
        self.probs = torch.tensor(p, dtype=torch.float32, device=device)

    @property
    def table(self) -> dict:
        return {"prob": self.prob, "alias": self.alias}

    def sample(self, key, shape: tuple[int, ...]) -> torch.Tensor:
        """``shape`` int32 ids, bitwise the reference's draw under ``key``."""
        table = {k: v[None] for k, v in self.table.items()}
        return sample_negatives_alias(table, np.asarray(key)[None], shape)[0]
