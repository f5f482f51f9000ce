"""Embedding evaluation — the paper's three task families (numpy; the
port's own copy of ``repro.eval.benchmarks``).

* similarity    — Spearman's ρ between model cosine and gold similarity
                  (stand-ins for MEN/RG65/RareWords/WS353);
* analogy       — 3CosAdd accuracy on a:b :: c:? quadruples
                  (stand-ins for Google/SemEval);
* categorization— cluster purity of k-means on the embeddings against
                  gold topic labels (stand-ins for AP/Battig).

Gold data comes from the synthetic corpus generator's latent geometry
(see data/corpus.py). OOV handling follows the paper: benchmark items
containing a word missing from the merged model are dropped, and the
count of such words is reported alongside each score.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.data.corpus import SemanticCorpusModel
from repro_torch.data.vocab import Vocab, UNK


# ---------------------------------------------------------------------------
def spearman(x: np.ndarray, y: np.ndarray) -> float:
    """Spearman's rank correlation (scipy-free, average ranks for ties)."""
    def ranks(a):
        order = np.argsort(a, kind="stable")
        r = np.empty(len(a), dtype=np.float64)
        r[order] = np.arange(len(a), dtype=np.float64)
        # average tied ranks
        vals, inv, cnt = np.unique(a, return_inverse=True, return_counts=True)
        sums = np.zeros(len(vals))
        np.add.at(sums, inv, r)
        return sums[inv] / cnt[inv]

    rx, ry = ranks(x), ranks(y)
    rx -= rx.mean()
    ry -= ry.mean()
    den = np.sqrt((rx ** 2).sum() * (ry ** 2).sum())
    return float((rx * ry).sum() / den) if den > 0 else 0.0


def _normalize(emb: np.ndarray) -> np.ndarray:
    return emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)


# ---------------------------------------------------------------------------
@dataclass
class BenchmarkSuite:
    """Gold data in *raw word id* space, evaluated against any vocab/emb."""

    sim_a: np.ndarray
    sim_b: np.ndarray
    sim_gold: np.ndarray
    quads: np.ndarray           # (Q, 4) raw ids
    cat_words: np.ndarray
    cat_labels: np.ndarray

    @staticmethod
    def from_model(gen: SemanticCorpusModel, seed: int = 7,
                   n_pairs: int = 400, n_quads: int = 200, n_cat: int = 300,
                   top_words: int | None = None) -> "BenchmarkSuite":
        a, b, g = gen.similarity_benchmark(n_pairs, seed=seed, top_words=top_words)
        q = gen.analogy_benchmark(n_quads, seed=seed + 1, top_words=top_words)
        w, l = gen.categorization_benchmark(n_cat, seed=seed + 2, top_words=top_words)
        return BenchmarkSuite(a, b, g, q, w, l)


def evaluate_similarity(emb: np.ndarray, valid: np.ndarray, vocab: Vocab,
                        suite: BenchmarkSuite) -> tuple[float, int]:
    ia, ib = vocab.encode(suite.sim_a), vocab.encode(suite.sim_b)
    ok = (ia != UNK) & (ib != UNK)
    ok &= valid[np.clip(ia, 0, None)] & valid[np.clip(ib, 0, None)]
    oov = int((~ok).sum())
    if ok.sum() < 5:
        return 0.0, oov
    e = _normalize(emb)
    sims = (e[ia[ok]] * e[ib[ok]]).sum(-1)
    return spearman(sims, suite.sim_gold[ok]), oov


def evaluate_analogy(emb: np.ndarray, valid: np.ndarray, vocab: Vocab,
                     suite: BenchmarkSuite, candidates: int | None = 2000
                     ) -> tuple[float, int]:
    """3CosAdd: argmax_d cos(d, b - a + c), excluding a, b, c."""
    q = vocab.encode(suite.quads.reshape(-1)).reshape(-1, 4)
    ok = np.all(q != UNK, axis=1)
    ok &= np.all(valid[np.clip(q, 0, None)], axis=1)
    oov = int((~ok).sum())
    q = q[ok]
    if len(q) == 0:
        return 0.0, oov
    e = _normalize(emb)
    # candidate set: most-frequent slice keeps eval O(Q · C)
    C = min(candidates or len(e), len(e))
    cand = np.arange(C)
    target = _normalize(e[q[:, 1]] - e[q[:, 0]] + e[q[:, 2]])
    scores = target @ e[cand].T                     # (Q, C)
    for col in range(3):
        inside = q[:, col] < C
        scores[np.arange(len(q))[inside], q[inside, col]] = -np.inf
    pred = cand[np.argmax(scores, axis=1)]
    return float((pred == q[:, 3]).mean()), oov


def _kmeans(x: np.ndarray, k: int, iters: int = 50, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), size=k, replace=False)]
    assign = np.zeros(len(x), dtype=np.int64)
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        new_assign = d.argmin(1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for j in range(k):
            m = assign == j
            if m.any():
                centers[j] = x[m].mean(0)
    return assign


def evaluate_categorization(emb: np.ndarray, valid: np.ndarray, vocab: Vocab,
                            suite: BenchmarkSuite) -> tuple[float, int]:
    ids = vocab.encode(suite.cat_words)
    ok = (ids != UNK) & valid[np.clip(ids, 0, None)]
    oov = int((~ok).sum())
    if ok.sum() < 10:
        return 0.0, oov
    x = _normalize(emb)[ids[ok]]
    labels = suite.cat_labels[ok]
    k = len(np.unique(labels))
    assign = _kmeans(x, k)
    purity = 0.0
    for j in range(k):
        m = assign == j
        if m.any():
            _, cnt = np.unique(labels[m], return_counts=True)
            purity += cnt.max()
    return float(purity / ok.sum()), oov


def evaluate_all(emb: np.ndarray, valid: np.ndarray, vocab: Vocab,
                 suite: BenchmarkSuite) -> dict:
    emb = np.asarray(emb)
    valid = np.asarray(valid).astype(bool)
    sim, sim_oov = evaluate_similarity(emb, valid, vocab, suite)
    ana, ana_oov = evaluate_analogy(emb, valid, vocab, suite)
    cat, cat_oov = evaluate_categorization(emb, valid, vocab, suite)
    return {
        "similarity": sim, "similarity_oov": sim_oov,
        "analogy": ana, "analogy_oov": ana_oov,
        "categorization": cat, "categorization_oov": cat_oov,
    }
