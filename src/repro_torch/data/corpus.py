"""Synthetic corpus with known semantic structure (numpy; the port's own
copy of ``repro.data.corpus``, kept bit-for-bit equal).

Generative model ("semantic lattice"):

* Every word ``w`` has a latent vector ``z_w = center[topic(w)] +
  Σ_f flag(w,f)·offset[f]`` — a cluster center plus binary feature
  offsets. Topics give categorization gold; feature flips give analogy
  gold (``a:b :: c:d`` where b = a with feature f flipped, d = c with f
  flipped); cosine of latents gives similarity gold.
* Word frequency is Zipfian by rank, independent of topic — the corpus
  has the heavy-tail unigram distribution that word2vec's subsampling,
  negative-sampling table and the paper's Theorem 2 all care about.
* A sentence picks a topic ``t`` and draws words i.i.d. from
  ``p(w|t) ∝ zipf(w) · exp(β · z_w · center[t])``: words co-occur with
  their topical neighbours, giving a non-trivial bigram (word–context)
  distribution. This is the structure SGNS must recover.

Corpora are stored flat (``tokens`` int32 + ``offsets``) so sampling
strategies can slice sentences cheaply.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Corpus:
    """A tokenized corpus: flat token ids plus sentence boundaries."""

    tokens: np.ndarray   # (T,) int32
    offsets: np.ndarray  # (S+1,) int64; sentence i = tokens[offsets[i]:offsets[i+1]]

    @property
    def num_sentences(self) -> int:
        return len(self.offsets) - 1

    @property
    def num_tokens(self) -> int:
        return int(self.offsets[-1])

    def sentence(self, i: int) -> np.ndarray:
        return self.tokens[self.offsets[i] : self.offsets[i + 1]]

    def sentences(self) -> list:
        return [self.sentence(i) for i in range(self.num_sentences)]

    def select(self, idx: np.ndarray) -> "Corpus":
        """Sub-corpus from sentence indices (with repetition allowed)."""
        lengths = (self.offsets[1:] - self.offsets[:-1])[idx]
        new_offsets = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lengths, out=new_offsets[1:])
        out = np.empty(int(new_offsets[-1]), dtype=np.int32)
        starts = self.offsets[idx]
        for j, (s, l, o) in enumerate(zip(starts, lengths, new_offsets[:-1])):
            out[o : o + l] = self.tokens[s : s + l]
        return Corpus(tokens=out, offsets=new_offsets)


@dataclass(frozen=True)
class SemanticCorpusModel:
    """The generator + its gold semantic geometry."""

    vocab_size: int
    latents: np.ndarray        # (V, m) gold latent vectors
    topics: np.ndarray         # (V,) int topic id per word
    features: np.ndarray       # (V, F) binary feature flags per word
    zipf_probs: np.ndarray     # (V,) unigram prior
    centers: np.ndarray        # (K, m) topic centers
    offsets_f: np.ndarray      # (F, m) feature offsets
    beta: float

    # ------------------------------------------------------------------
    @staticmethod
    def create(
        vocab_size: int = 2000,
        num_topics: int = 16,
        num_features: int = 4,
        latent_dim: int = 12,
        zipf_a: float = 1.05,
        beta: float = 4.0,
        seed: int = 0,
    ) -> "SemanticCorpusModel":
        rng = np.random.default_rng(seed)
        centers = rng.normal(size=(num_topics, latent_dim))
        centers /= np.linalg.norm(centers, axis=1, keepdims=True)
        offs = 0.35 * rng.normal(size=(num_features, latent_dim))
        topics = rng.integers(0, num_topics, size=vocab_size)
        feats = (rng.random((vocab_size, num_features)) < 0.5).astype(np.int8)
        latents = centers[topics] + feats @ offs
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        zipf = ranks ** (-zipf_a)
        # Random rank assignment so frequency is independent of topic.
        perm = rng.permutation(vocab_size)
        zipf = zipf[perm]
        zipf /= zipf.sum()
        return SemanticCorpusModel(
            vocab_size=vocab_size,
            latents=latents,
            topics=topics,
            features=feats,
            zipf_probs=zipf,
            centers=centers,
            offsets_f=offs,
            beta=beta,
        )

    # ------------------------------------------------------------------
    def topic_word_dists(self) -> np.ndarray:
        """(K, V) word distribution per topic."""
        logits = self.beta * (self.latents @ self.centers.T)  # (V, K)
        logits = logits - logits.max(axis=0, keepdims=True)
        p = self.zipf_probs[:, None] * np.exp(logits)
        p /= p.sum(axis=0, keepdims=True)
        return p.T  # (K, V)

    def generate(
        self,
        num_sentences: int,
        mean_sentence_len: int = 20,
        seed: int = 1,
    ) -> Corpus:
        """Vectorized sentence sampling."""
        rng = np.random.default_rng(seed)
        K = self.centers.shape[0]
        topic_dists = self.topic_word_dists()           # (K, V)
        cdfs = np.cumsum(topic_dists, axis=1)            # (K, V)
        cdfs[:, -1] = 1.0
        lengths = rng.poisson(mean_sentence_len, size=num_sentences)
        lengths = np.clip(lengths, 3, None).astype(np.int64)
        sent_topics = rng.integers(0, K, size=num_sentences)
        offsets = np.zeros(num_sentences + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        total = int(offsets[-1])
        u = rng.random(total)
        tokens = np.empty(total, dtype=np.int32)
        # Sample per topic in one vectorized searchsorted each. The
        # default side='left' is kept: the Dirichlet topic weights are
        # strictly positive so no CDF step is flat and u ~ U[0,1) never
        # hits a boundary exactly — and the committed gold-benchmark
        # corpora were generated with this exact lookup, so it must not
        # change bit-for-bit.
        tok_topic = np.repeat(sent_topics, lengths)
        for k in range(K):
            m = tok_topic == k
            if m.any():
                tokens[m] = np.searchsorted(  # repro-lint: ignore[RL002]
                    cdfs[k], u[m]).astype(np.int32)
        np.clip(tokens, 0, self.vocab_size - 1, out=tokens)
        return Corpus(tokens=tokens, offsets=offsets)

    # ------------------- gold benchmark constructors -------------------
    def gold_similarity(self, word_a: np.ndarray, word_b: np.ndarray) -> np.ndarray:
        za, zb = self.latents[word_a], self.latents[word_b]
        num = (za * zb).sum(-1)
        den = np.linalg.norm(za, axis=-1) * np.linalg.norm(zb, axis=-1) + 1e-9
        return num / den

    def similarity_benchmark(self, n_pairs: int = 300, seed: int = 7, top_words: int | None = None):
        rng = np.random.default_rng(seed)
        hi = top_words or self.vocab_size
        a = rng.integers(0, hi, size=n_pairs)
        b = rng.integers(0, hi, size=n_pairs)
        keep = a != b
        a, b = a[keep], b[keep]
        return a, b, self.gold_similarity(a, b)

    def analogy_benchmark(self, n_quads: int = 200, seed: int = 11, top_words: int | None = None):
        """Quadruples a:b :: c:d — b=a with feature f flipped, same for c:d.

        Built from the lattice: pick feature f, pick words a, c with the
        same topic-pair structure differing only in f.
        """
        rng = np.random.default_rng(seed)
        hi = top_words or self.vocab_size
        F = self.features.shape[1]
        # Index words by (topic, feature-vector) signature.
        sig = {}
        for w in range(hi):
            key = (int(self.topics[w]), tuple(int(x) for x in self.features[w]))
            sig.setdefault(key, []).append(w)
        quads = []
        tries = 0
        while len(quads) < n_quads and tries < n_quads * 60:
            tries += 1
            f = int(rng.integers(0, F))
            t1 = int(rng.integers(0, self.centers.shape[0]))
            t2 = int(rng.integers(0, self.centers.shape[0]))
            base = tuple(int(x) for x in (rng.random(F) < 0.5))
            flip = tuple(v if i != f else 1 - v for i, v in enumerate(base))
            ka, kb = (t1, base), (t1, flip)
            kc, kd = (t2, base), (t2, flip)
            if all(k in sig for k in (ka, kb, kc, kd)):
                a = int(rng.choice(sig[ka]))
                b = int(rng.choice(sig[kb]))
                c = int(rng.choice(sig[kc]))
                d = int(rng.choice(sig[kd]))
                if len({a, b, c, d}) == 4:
                    quads.append((a, b, c, d))
        return np.array(quads, dtype=np.int64).reshape(-1, 4)

    def categorization_benchmark(self, n_words: int = 400, seed: int = 13, top_words: int | None = None):
        rng = np.random.default_rng(seed)
        hi = top_words or self.vocab_size
        words = rng.choice(hi, size=min(n_words, hi), replace=False)
        return words, self.topics[words]
