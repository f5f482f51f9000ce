"""The whole slice — divide → train → ALiR merge → evaluate — through the
port's ``run_pipeline(engine="fused", device="cpu")`` against the JAX
package's ``run_pipeline(engine="pallas_fused")`` (Pallas in interpret
mode) on one corpus and seed; then the port alone against the thresholds
of ``tests/test_system.py::test_full_pipeline_learns_semantics``."""

import numpy as np
import pytest

from repro.core import async_trainer as j_async
from repro.core import driver as jdriver
from repro.core.sgns import SGNSConfig as JCfg
from repro.data.corpus import SemanticCorpusModel
from repro_torch.core import async_trainer as t_async
from repro_torch.core import driver as tdriver
from repro_torch.core.sgns import SGNSConfig as TCfg
from repro_torch.eval.benchmarks import BenchmarkSuite, evaluate_all

# Per-chunk losses and final tables after 24 steps: the port and the
# reference take the same ids and keys; only the float reduction order
# differs (a few ulps per step on O(1e-2) entries).
LOSS_RTOL = 1e-5
TABLE_ATOL = 1e-5
MERGE_ATOL = 1e-4


def _recording(monkeypatch, cls, log):
    orig = cls.epoch

    def epoch(self, params, centers, contexts, neg_table, key, step0=0):
        params, losses = orig(self, params, centers, contexts, neg_table, key, step0)
        log.append((np.asarray(centers), np.asarray(contexts), np.asarray(losses)))
        return params, losses

    monkeypatch.setattr(cls, "epoch", epoch)


def _align(A, B):
    u, _, vt = np.linalg.svd(A.T @ B)
    return A @ (u @ vt)


def test_pipeline_matches_reference_pallas_fused(monkeypatch):
    gen = SemanticCorpusModel.create(vocab_size=300, seed=0)
    corpus = gen.generate(num_sentences=1500, seed=1)
    kw = dict(strategy="shuffle", num_workers=3, epochs=2, batch_size=128, window=5,
              max_vocab=None, max_steps_per_epoch=12, steps_per_chunk=6, seed=3,
              merge_methods=("concat", "alir_pca"))
    jlog, tlog = [], []
    _recording(monkeypatch, j_async.AsyncShardTrainer, jlog)
    _recording(monkeypatch, t_async.AsyncShardTrainer, tlog)
    jres = jdriver.run_pipeline(corpus, 300, cfg=JCfg(vocab_size=0, dim=16, negatives=5),
                                engine="pallas_fused", **kw)
    tres = tdriver.run_pipeline(corpus, 300, cfg=TCfg(vocab_size=0, dim=16, negatives=5),
                                engine="fused", device="cpu", **kw)

    assert len(jlog) == len(tlog) == 4                  # 2 epochs x 2 chunks
    for (jc, jx, jl), (tc, tx, tl), tcl in zip(jlog, tlog, tres.chunk_losses):
        np.testing.assert_array_equal(tc, jc)           # chunks bitwise
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        np.testing.assert_array_equal(tcl, tl)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=LOSS_RTOL)
    assert tres.timings["steps_per_epoch"] == jres.timings["steps_per_epoch"]

    np.testing.assert_array_equal(tres.union_vocab.word_ids, jres.union_vocab.word_ids)
    np.testing.assert_array_equal(tres.stacked.mask.numpy(), np.asarray(jres.stacked.mask))
    W_t, W_j = tres.stacked.models.numpy(), np.asarray(jres.stacked.models)
    assert np.abs(W_t - W_j).max() <= TABLE_ATOL

    for method in ("concat", "alir_pca"):
        (te, tv), (je, jv) = tres.merged[method], jres.merged[method]
        np.testing.assert_array_equal(tv, jv)
        if method == "alir_pca":                        # eigh's sign gauge
            te = _align(te, je)
        np.testing.assert_allclose(te, je, rtol=0, atol=MERGE_ATOL)


@pytest.fixture(scope="module")
def world():
    gen = SemanticCorpusModel.create(vocab_size=1000, seed=0)
    corpus = gen.generate(num_sentences=10_000, seed=1)
    suite = BenchmarkSuite.from_model(gen, top_words=700)
    return gen, corpus, suite


def test_port_pipeline_learns_semantics(world):
    """The done criterion of the main path: the port alone passes the
    thresholds of test_full_pipeline_learns_semantics."""
    gen, corpus, suite = world
    cfg = TCfg(vocab_size=0, dim=48, window=5, negatives=5)
    res = tdriver.run_pipeline(corpus, 1000, strategy="shuffle", num_workers=4,
                               cfg=cfg, epochs=5, batch_size=512, window=5,
                               max_vocab=None, merge_methods=("alir_pca", "average"),
                               device="cpu")
    emb, valid = res.merged["alir_pca"]
    s = evaluate_all(emb, valid, res.union_vocab, suite)
    assert s["similarity"] > 0.05, s
    assert s["categorization"] > 0.15, s     # 16 topics → chance ≈ 0.10
    assert res.losses[-1] < res.losses[0] * 0.8
    emb_a, valid_a = res.merged["average"]
    s_avg = evaluate_all(emb_a, valid_a, res.union_vocab, suite)
    assert s["similarity"] >= s_avg["similarity"] - 0.02
