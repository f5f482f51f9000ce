"""The rest of the port's divide phase and the paper's theory tools against
the JAX package: the Fig. 1 / Theorem 1–2 functions of
``core/distributions.py``, ``coverage_stats``, the one-table samplers
``NegativeSampler`` and ``AliasSampler``, ``WorkerStream.batches``,
``HostShardPlan.all_hosts``/``describe`` and ``stacked_pair_batches``.

Integer outputs (ids, batches, plans) are compared bitwise; floats are the
same numpy expressions on the same inputs, held to 1e-12 relative.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import distributions as jdist
from repro.core.sampling import coverage_stats as j_coverage
from repro.core.sampling import sample_sentence_indices
from repro.data import pairs as jpairs
from repro.data import pipeline as jpipe
from repro.data.corpus import SemanticCorpusModel as JGen
from repro.data.vocab import build_vocab as j_build_vocab
from repro_torch.core import distributions as tdist
from repro_torch.core.sampling import coverage_stats as t_coverage
from repro_torch.data import pairs as tpairs
from repro_torch.data import pipeline as tpipe
from repro_torch.data.corpus import SemanticCorpusModel as TGen
from repro_torch.data.vocab import build_vocab as t_build_vocab

RTOL = 1e-12
RAW_V = 300


@pytest.fixture(scope="module", params=(0, 3))
def corpora(request):
    s = request.param
    j = JGen.create(vocab_size=RAW_V, seed=s).generate(num_sentences=600, seed=s + 1)
    t = TGen.create(vocab_size=RAW_V, seed=s).generate(num_sentences=600, seed=s + 1)
    return j, t


def _subsets(j, t, strategy, n=4):
    for w in range(n):
        idx = sample_sentence_indices(j.num_sentences, strategy, 1 / n, w, n, seed=2)
        yield j.select(idx), t.select(idx)


@pytest.mark.parametrize("strategy", ("equal", "random"))
def test_unigram_and_dense_kl_match(corpora, strategy):
    j, t = corpora
    jref, tref = jdist.unigram_distribution(j, RAW_V), tdist.unigram_distribution(t, RAW_V)
    np.testing.assert_allclose(tref, jref, rtol=RTOL, atol=0)
    for js, ts in _subsets(j, t, strategy):
        ju, tu = jdist.unigram_distribution(js, RAW_V), tdist.unigram_distribution(ts, RAW_V)
        np.testing.assert_allclose(tu, ju, rtol=RTOL, atol=0)
        assert tdist.kl_divergence_dense(tu, tref) == pytest.approx(
            jdist.kl_divergence_dense(ju, jref), rel=RTOL)


@pytest.mark.parametrize("window", (1, 3))
def test_bigram_and_sparse_kl_match(corpora, window):
    j, t = corpora
    jref = jdist.bigram_distribution(j, RAW_V, window=window)
    tref = tdist.bigram_distribution(t, RAW_V, window=window)
    assert list(tref) == list(jref)                       # same keys, same order
    np.testing.assert_allclose(list(tref.values()), list(jref.values()), rtol=RTOL, atol=0)
    for js, ts in _subsets(j, t, "random"):
        jb = jdist.bigram_distribution(js, RAW_V, window=window)
        tb = tdist.bigram_distribution(ts, RAW_V, window=window)
        assert list(tb) == list(jb)
        assert tdist.kl_divergence_sparse(tb, tref) == pytest.approx(
            jdist.kl_divergence_sparse(jb, jref), rel=RTOL)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_alias_implied_probs_match(seed):
    p = np.random.default_rng(seed).zipf(1.4, 257).astype(np.float64)
    p /= p.sum()
    prob, alias = tdist.build_alias_table(p)
    jprob, jalias = jdist.build_alias_table(p)
    np.testing.assert_array_equal(prob, jprob)
    np.testing.assert_array_equal(alias, jalias)
    got = tdist.alias_implied_probs(prob, alias)
    np.testing.assert_allclose(got, jdist.alias_implied_probs(jprob, jalias), rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose(got, p, atol=1e-12)        # the table is exact


@pytest.mark.parametrize("rate,length", ((0.1, 100), (0.5, 3), (0.01, 20.5)))
def test_theorem2_threshold_matches(rate, length):
    assert tdist.theorem2_threshold(rate, length) == pytest.approx(
        jdist.theorem2_threshold(rate, length), rel=RTOL)


@pytest.mark.parametrize("rate", (0.0, 1.0, -0.2))
def test_theorem2_threshold_rejects_the_reference_rates(rate):
    with pytest.raises(ValueError, match="rate must be in"):
        jdist.theorem2_threshold(rate, 10)
    with pytest.raises(ValueError, match="rate must be in"):
        tdist.theorem2_threshold(rate, 10)


@pytest.mark.parametrize("strategy", ("equal", "random", "shuffle"))
def test_coverage_stats_equal(strategy):
    idxs = [sample_sentence_indices(500, strategy, 0.2, w, 5, epoch=1, seed=4)
            for w in range(5)]
    assert t_coverage(idxs, 500) == j_coverage(idxs, 500)


def _counts(seed, V=120):
    c = np.random.default_rng(seed).zipf(1.3, V).astype(np.float64)
    c[[3, 17, 18]] = 0                                    # never-seen rows
    return c


@pytest.mark.parametrize("seed", (0, 5))
def test_one_table_samplers_draw_the_references_ids(seed):
    counts = _counts(seed)
    jn, tn = jpairs.NegativeSampler(counts), tpairs.NegativeSampler(counts, device="cpu")
    ja, ta = jpairs.AliasSampler(counts), tpairs.AliasSampler(counts, device="cpu")
    np.testing.assert_array_equal(tn.cdf.numpy(), np.asarray(jn.cdf))
    np.testing.assert_array_equal(tn.probs.numpy(), np.asarray(jn.probs))
    np.testing.assert_array_equal(ta.prob.numpy(), np.asarray(ja.prob))
    np.testing.assert_array_equal(ta.alias.numpy(), np.asarray(ja.alias))
    assert set(ta.table) == {"prob", "alias"}
    for k, shape in ((seed, (64, 5)), (seed + 9, (7,)), (seed + 2**33, (3, 4, 5))):
        key = jax.random.PRNGKey(k)
        for j, t in ((jn, tn), (ja, ta)):
            got = t.sample(np.asarray(key), shape)
            assert got.dtype == torch.int32 and tuple(got.shape) == shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(j.sample(key, shape)))


def test_samplers_live_on_the_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (tpairs.NegativeSampler, tpairs.AliasSampler):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(_counts(0))


def _streams(pkg, corpus, vocab, n=3, **kw):
    return pkg.make_worker_streams(corpus, vocab, num_workers=n, strategy="shuffle",
                                   window=4, seed=7, **kw)


@pytest.mark.parametrize("max_pairs", (None, 333))
def test_worker_stream_batches_bitwise(corpora, max_pairs):
    j, t = corpora
    jv, tv = j_build_vocab(j, RAW_V, min_count=2), t_build_vocab(t, RAW_V, min_count=2)
    for js, ts in zip(_streams(jpipe, j, jv), _streams(tpipe, t, tv)):
        for epoch in (0, 1):
            jb = list(js.batches(epoch, 64, max_pairs=max_pairs))
            tb = list(ts.batches(epoch, 64, max_pairs=max_pairs))
            assert len(tb) == len(jb) > 0
            for (jc, jx), (tc, tx) in zip(jb, tb):
                np.testing.assert_array_equal(tc, jc)
                np.testing.assert_array_equal(tx, jx)


@pytest.mark.parametrize("num_batches,batch", ((5, 32), (2, 200)))
def test_stacked_pair_batches_bitwise(corpora, num_batches, batch):
    j, t = corpora
    jv, tv = j_build_vocab(j, RAW_V, min_count=2), t_build_vocab(t, RAW_V, min_count=2)
    jc, jx = jpipe.stacked_pair_batches(_streams(jpipe, j, jv), 1, batch, num_batches)
    tc, tx = tpipe.stacked_pair_batches(_streams(tpipe, t, tv), 1, batch, num_batches)
    assert tc.shape == (3, num_batches, batch)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tx, jx)


@pytest.mark.parametrize("hosts,workers", ((1, 1), (3, 10), (4, 4), (5, 3)))
def test_host_plans_and_descriptions_equal(hosts, workers):
    jp = jpipe.HostShardPlan.all_hosts(hosts, workers)
    tp = tpipe.HostShardPlan.all_hosts(hosts, workers)
    assert [p.describe() for p in tp] == [p.describe() for p in jp]
    assert [list(p.workers) for p in tp] == [list(p.workers) for p in jp]
    assert sorted(w for p in tp for w in p.workers) == list(range(workers))
