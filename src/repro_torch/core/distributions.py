"""Unigram/bigram distribution tooling (paper Fig. 1 and Theorems 1–2)
and Vose alias tables for the noise distribution.

The port's own numpy copy of ``repro.core.distributions``; integer
outputs are bitwise equal to the reference's and floats follow the same
expressions. The paper's empirical case for random sampling is that the
KL divergence from a sub-corpus's unigram and bigram distributions to the
full corpus's is small (much smaller than for equal partitioning); these
functions measure that, and the Theorem 2 miss-probability threshold.
"""

from __future__ import annotations

import numpy as np

from repro_torch.data.corpus import Corpus


def unigram_distribution(corpus: Corpus, vocab_size: int) -> np.ndarray:
    c = np.bincount(corpus.tokens, minlength=vocab_size).astype(np.float64)
    return c / max(c.sum(), 1.0)


def bigram_distribution(
    corpus: Corpus, vocab_size: int, window: int = 1
) -> dict[int, float]:
    """Sparse word–context pair distribution within ``window`` (keys w*V+c)."""
    counts: dict[int, int] = {}
    toks, offs = corpus.tokens.astype(np.int64), corpus.offsets
    for off in range(1, window + 1):
        a = toks[:-off]
        b = toks[off:]
        # Drop pairs crossing sentence boundaries.
        sent_id = np.repeat(np.arange(len(offs) - 1), np.diff(offs))
        same = sent_id[:-off] == sent_id[off:]
        keys = (a[same] * vocab_size + b[same])
        uniq, cnt = np.unique(keys, return_counts=True)
        for k, c in zip(uniq.tolist(), cnt.tolist()):
            counts[k] = counts.get(k, 0) + c
    total = float(sum(counts.values())) or 1.0
    return {k: v / total for k, v in counts.items()}


def kl_divergence_dense(p: np.ndarray, q: np.ndarray, eps: float = 1e-10) -> float:
    """KL(p || q) with additive smoothing on q (q = full-corpus reference)."""
    q = (q + eps) / (q + eps).sum()
    mask = p > 0
    return float(np.sum(p[mask] * np.log(p[mask] / q[mask])))


def kl_divergence_sparse(p: dict[int, float], q: dict[int, float], eps: float = 1e-10) -> float:
    qs = sum(q.values()) + eps * (len(p) + len(q))
    out = 0.0
    for k, pv in p.items():
        qv = (q.get(k, 0.0) + eps) / qs
        out += pv * np.log(pv / qv)
    return float(out)


def build_alias_table(probs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vose's alias method: O(V) build, O(1) draw.

    Returns ``(prob, alias)`` with ``prob`` float64 in [0, 1] and
    ``alias`` int32, such that drawing ``i ~ U{0..V-1}``, ``u ~ U[0,1)``
    and returning ``i`` if ``u < prob[i]`` else ``alias[i]`` samples
    exactly from ``probs``.
    """
    p = np.asarray(probs, dtype=np.float64)
    if p.ndim != 1 or len(p) == 0:
        raise ValueError("probs must be a non-empty 1-D array")
    if (p < 0).any():
        raise ValueError("probs must be non-negative")
    s = p.sum()
    if s <= 0:
        raise ValueError("probs must sum to a positive value")
    V = len(p)
    scaled = p * (V / s)
    prob = np.ones(V, dtype=np.float64)
    alias = np.arange(V, dtype=np.int32)
    # Partition into under-/over-full buckets and pair them off.
    small = [i for i in range(V) if scaled[i] < 1.0]
    large = [i for i in range(V) if scaled[i] >= 1.0]
    while small and large:
        lo = small.pop()
        hi = large.pop()
        prob[lo] = scaled[lo]
        alias[lo] = hi
        scaled[hi] = (scaled[hi] + scaled[lo]) - 1.0
        (small if scaled[hi] < 1.0 else large).append(hi)
    # Leftovers are exactly full up to float rounding.
    for i in small + large:
        prob[i] = 1.0
        alias[i] = i
    return prob, alias


def alias_implied_probs(prob: np.ndarray, alias: np.ndarray) -> np.ndarray:
    """The exact distribution an alias table samples from (test oracle)."""
    V = len(prob)
    out = prob.astype(np.float64).copy()
    np.add.at(out, alias, 1.0 - prob)
    return out / V


def theorem2_threshold(rate: float, sentence_len: float) -> float:
    """P_C(w) above which a word is exp(-O(N))-unlikely to be missed.

    Theorem 2: u = r/100, ℓ = sentence length; threshold is
    ``1 - (1-u) ** ((1-u) / (ℓ u))``. (Paper's example: u=0.1, ℓ=100
    → ≈ 0.0095.)
    """
    u = rate
    if not (0.0 < u < 1.0):
        raise ValueError("rate must be in (0,1)")
    return 1.0 - (1.0 - u) ** ((1.0 - u) / (sentence_len * u))
