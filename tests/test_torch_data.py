"""The port's host data path against the JAX package's: corpus, vocabs,
noise and alias tables, sentence samples, pairs, worker streams, chunk
streams (with ``start_chunk=``), epoch schedules and the driver's keys —
all bitwise equal — plus the port's prefetch pipeline."""

import threading
import time

import numpy as np
import pytest
import torch

from repro.core import distributions as jdist
from repro.core import driver as jdriver
from repro.core.sampling import sample_sentence_indices as j_indices
from repro.core.schedule import plan_epoch as j_plan_epoch
from repro.data import pairs as jpairs
from repro.data import pipeline as jpipe
from repro.data.corpus import SemanticCorpusModel as JGen
from repro.data.vocab import build_vocab as j_build_vocab, union_vocab as j_union
from repro_torch.core import distributions as tdist
from repro_torch.core import driver as tdriver
from repro_torch.core.sampling import sample_sentence_indices as t_indices
from repro_torch.core.schedule import plan_epoch as t_plan_epoch
from repro_torch.data import pairs as tpairs
from repro_torch.data import pipeline as tpipe
from repro_torch.data.corpus import SemanticCorpusModel as TGen
from repro_torch.data.vocab import build_vocab as t_build_vocab, union_vocab as t_union

RAW_V = 400
STRATEGIES = ("shuffle", "random", "equal")


@pytest.fixture(scope="module")
def corpora():
    j = JGen.create(vocab_size=RAW_V, seed=0).generate(num_sentences=1200, seed=1)
    t = TGen.create(vocab_size=RAW_V, seed=0).generate(num_sentences=1200, seed=1)
    return j, t


def _vocab_equal(a, b):
    np.testing.assert_array_equal(a.word_ids, b.word_ids)
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.lookup, b.lookup)


def test_corpus_and_gold_benchmarks_bitwise():
    jg, tg = JGen.create(vocab_size=300, seed=3), TGen.create(vocab_size=300, seed=3)
    for f in ("latents", "topics", "features", "zipf_probs", "centers", "offsets_f"):
        np.testing.assert_array_equal(getattr(jg, f), getattr(tg, f))
    jc, tc = jg.generate(200, seed=4), tg.generate(200, seed=4)
    np.testing.assert_array_equal(jc.tokens, tc.tokens)
    np.testing.assert_array_equal(jc.offsets, tc.offsets)
    np.testing.assert_array_equal(jg.analogy_benchmark(20, seed=5),
                                  tg.analogy_benchmark(20, seed=5))


@pytest.mark.parametrize("min_count,max_size", ((1, None), (3, 200), (10, 50)))
def test_vocab_bitwise(corpora, min_count, max_size):
    jc, tc = corpora
    jv = j_build_vocab(jc, RAW_V, min_count=min_count, max_size=max_size)
    tv = t_build_vocab(tc, RAW_V, min_count=min_count, max_size=max_size)
    _vocab_equal(jv, tv)
    sub = [np.arange(0, 600), np.arange(500, 1200)]
    _vocab_equal(j_union([j_build_vocab(jc.select(s), RAW_V) for s in sub], RAW_V),
                 t_union([t_build_vocab(tc.select(s), RAW_V) for s in sub], RAW_V))


@pytest.mark.parametrize("a", (1.0, 1.3))
def test_alias_table_bitwise(a):
    p = np.arange(1, 3001, dtype=np.float64) ** -a
    p = p / p.sum()
    for j, t in zip(jdist.build_alias_table(p), tdist.build_alias_table(p)):
        np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("kind", ("cdf", "alias"))
def test_noise_tables_bitwise(corpora, kind):
    jc, _ = corpora
    counts = [np.bincount(jc.select(np.arange(k, 1200, 3)).tokens, minlength=RAW_V)
              for k in range(3)]
    counts[2] = counts[0]          # shared builds must stack like fresh ones
    jt = jpairs.stack_noise_tables(counts, kind=kind)
    tt = tpairs.stack_noise_tables(counts, kind=kind)
    if kind == "cdf":
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        assert tt.dtype == torch.float32
    else:
        for k in ("prob", "alias"):
            np.testing.assert_array_equal(np.asarray(jt[k]), tt[k].numpy())
        assert tt["prob"].dtype == torch.float32 and tt["alias"].dtype == torch.int32
    np.testing.assert_array_equal(jpairs.unigram_noise_probs(counts[0]),
                                  tpairs.unigram_noise_probs(counts[0]))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sentence_samples_bitwise(strategy):
    for w in range(3):
        for epoch in (0, 1):
            np.testing.assert_array_equal(
                j_indices(1000, strategy, 0.3, w, 3, epoch=epoch, seed=5),
                t_indices(1000, strategy, 0.3, w, 3, epoch=epoch, seed=5))


@pytest.mark.parametrize("subsample_t", (None, 1e-3))
def test_extract_pairs_bitwise(corpora, subsample_t):
    jc, tc = corpora
    jv, tv = j_build_vocab(jc, RAW_V), t_build_vocab(tc, RAW_V)
    for seed in (0, np.random.SeedSequence((1, 2, 3))):
        j = jpairs.extract_pairs(jc, jv, window=4, subsample_t=subsample_t, seed=seed)
        t = tpairs.extract_pairs(tc, tv, window=4, subsample_t=subsample_t, seed=seed)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(a, b)


def _streams(pkg_pipe, build_vocab, corpus, strategy):
    vocab = build_vocab(corpus, RAW_V)
    return pkg_pipe.make_worker_streams(corpus, vocab, num_workers=3,
                                        strategy=strategy, window=4, seed=9)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_worker_streams_bitwise(corpora, strategy):
    jc, tc = corpora
    js = _streams(jpipe, j_build_vocab, jc, strategy)
    ts = _streams(tpipe, t_build_vocab, tc, strategy)
    for j, t in zip(js, ts):
        for a, b in zip(j.pairs(1), t.pairs(1)):
            np.testing.assert_array_equal(a, b)
        jb = list(j.pair_blocks(0, sentences_per_block=100))
        tb = list(t.pair_blocks(0, sentences_per_block=100))
        assert len(jb) == len(tb)
        for (a, b), (c, d) in zip(jb, tb):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
        assert j.count_pairs(0, 100, max_pairs=500) == t.count_pairs(0, 100, max_pairs=500)


@pytest.mark.parametrize("start_chunk", (0, 2, 5))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_chunk_stream_bitwise(corpora, strategy, start_chunk):
    """Including wrap-arounds (the chunks outrun one pass of a worker's
    sample) and the resume fast-forward."""
    jc, tc = corpora
    kw = dict(batch_size=64, steps_per_chunk=8, sentences_per_block=128)
    jst = jpipe.PairChunkStream(_streams(jpipe, j_build_vocab, jc, strategy), **kw)
    tst = tpipe.PairChunkStream(_streams(tpipe, t_build_vocab, tc, strategy), **kw)
    jchunks = list(jst.chunks(1, num_chunks=8, start_chunk=start_chunk))
    tchunks = list(tst.chunks(1, num_chunks=8, start_chunk=start_chunk))
    assert len(jchunks) == len(tchunks) == 8 - start_chunk
    for (a, b), (c, d) in zip(jchunks, tchunks):
        assert c.shape == (3, 8, 64) and c.dtype == np.int32
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_host_shard_plan_matches(corpora):
    for P in (1, 2, 3):
        for p in range(P):
            j, t = jpipe.HostShardPlan(p, P, 7), tpipe.HostShardPlan(p, P, 7)
            assert (j.start, j.stop, list(j.workers)) == (t.start, t.stop, list(t.workers))
    plan = tpipe.HostShardPlan.for_runtime(3)
    assert (plan.process_index, plan.process_count) == (0, 1)
    with pytest.raises(ValueError):
        tpipe.HostShardPlan(0, 0, 3)


@pytest.mark.parametrize("args", ((1000, 128, 3, 16, None), (5000, 64, 2, 7, 20),
                                  (100, 512, 1, 128, None), (999, 10, 4, 3, 50)))
def test_plan_epoch_bitwise(args):
    pairs, batch, epochs, spc, cap = args
    assert (j_plan_epoch(pairs, batch, epochs, spc, max_steps_per_epoch=cap).__dict__
            == t_plan_epoch(pairs, batch, epochs, spc, max_steps_per_epoch=cap).__dict__)


def test_driver_keys_and_numpy_streams_bitwise():
    for seed, stream, epoch in ((0, 0, 0), (1, 0, 1000), (2, 2, 7)):
        np.testing.assert_array_equal(np.asarray(jdriver._epoch_key(seed, stream, epoch)),
                                      tdriver._epoch_key(seed, stream, epoch))
        np.testing.assert_array_equal(jdriver._epoch_rng(seed, stream, epoch).integers(0, 2**62, 4),
                                      tdriver._epoch_rng(seed, stream, epoch).integers(0, 2**62, 4))
    for w in range(4):
        np.testing.assert_array_equal(np.asarray(jdriver.worker_chunk_key(3, 1, 2, 4, w)),
                                      tdriver.worker_chunk_key(3, 1, 2, 4, w))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_prepare_training_bitwise(corpora, strategy):
    from repro.core.sgns import SGNSConfig as JCfg
    from repro_torch.core.sgns import SGNSConfig as TCfg

    jc, tc = corpora
    kw = dict(epochs=2, batch_size=64, window=4, max_vocab=None, base_min_count=6,
              max_steps_per_epoch=30, steps_per_chunk=8, sentences_per_block=128)
    js = jdriver.prepare_training(jc, RAW_V, strategy, 3, JCfg(vocab_size=0, dim=8),
                                  engine="pallas_fused", **kw)
    ts = tdriver.prepare_training(tc, RAW_V, strategy, 3, TCfg(vocab_size=0, dim=8),
                                  engine="fused", **kw)
    assert js.cfg.vocab_size == ts.cfg.vocab_size
    assert js.sched.__dict__ == ts.sched.__dict__
    np.testing.assert_array_equal(js.mask, ts.mask)
    _vocab_equal(js.union_vocab, ts.union_vocab)
    for k in ("prob", "alias"):
        np.testing.assert_array_equal(np.asarray(js.neg_table[k]), ts.neg_table[k].numpy())


# ------------------------------------------------------------------ prefetch
def _source(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise ValueError("exploded mid-stream")
        yield (np.full((2, 3, 4), i, np.int32), np.full((2, 3, 4), -i, np.int32))


def _no_producer_alive():
    deadline = time.time() + 5.0
    while (any(t.name == "prefetch_chunks" and t.is_alive() for t in threading.enumerate())
           and time.time() < deadline):
        time.sleep(0.02)
    return not any(t.name == "prefetch_chunks" and t.is_alive()
                   for t in threading.enumerate())


@pytest.mark.parametrize("device", (None, "cpu"))
def test_prefetch_preserves_order_and_values(device):
    got = list(tpipe.prefetch_chunks(_source(5), depth=2, device=device))
    assert len(got) == 5
    for i, (c, x) in enumerate(got):
        if device is None:
            assert isinstance(c, np.ndarray)
        else:
            assert isinstance(c, torch.Tensor) and c.device.type == "cpu"
        assert int(c.reshape(-1)[0]) == i and int(x.reshape(-1)[0]) == -i


def test_prefetch_propagates_errors_and_validates_depth():
    it = tpipe.prefetch_chunks(_source(5, fail_at=1), depth=2, device="cpu")
    next(it)
    with pytest.raises(ValueError, match="exploded mid-stream"):
        next(it)
    with pytest.raises(ValueError, match="depth"):
        tpipe.prefetch_chunks(iter([]), depth=0)


def test_prefetch_error_delivered_even_when_queue_full():
    got = []
    with pytest.raises(ValueError, match="exploded mid-stream"):
        for c, _ in tpipe.prefetch_chunks(_source(5, fail_at=3), depth=1):
            time.sleep(0.1)
            got.append(int(c.reshape(-1)[0]))
    assert got == [0, 1, 2]


def test_prefetch_abandoned_or_raising_consumer_joins_producer():
    it = tpipe.prefetch_chunks(_source(1000), depth=2, device="cpu")
    next(it)
    it.close()
    assert _no_producer_alive()

    with pytest.raises(RuntimeError, match="consumer bug"):
        for _ in tpipe.prefetch_chunks(_source(1000), depth=2):
            raise RuntimeError("consumer bug")
    assert _no_producer_alive()
