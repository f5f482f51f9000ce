"""The benchmark's frozen copies against the port's own plain versions on
tiny cases (threefry, the draws, the init, the SGNS step, ALiR, the divide
phase) and the frozen counts against counts made by hand."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import corpus as data
from portbench.harness import counts as yard
from portbench.reference import alir as ref_alir
from portbench.reference import sgns as ref
from portbench.reference import threefry
from repro_torch import prng
from repro_torch.core import sgns as port_sgns
from repro_torch.core.merge import StackedModels, get_merger
from repro_torch.data import pairs as port_pairs
from repro_torch.kernels import sgns_fused

KEY = threefry.PRNGKey(2**33 + 77)


def test_keys_match_the_port():
    assert np.array_equal(threefry.split(KEY, 5), prng.split(KEY, 5))
    assert np.array_equal(threefry.fold_in(KEY, 123456), prng.fold_in(KEY, 123456))
    assert np.array_equal(threefry.fold_in(KEY, np.arange(4))[3], prng.fold_in(KEY, 3))
    keys = prng.split(KEY, 3)
    assert np.array_equal(threefry.step_keys(keys, 4), prng.step_keys(keys, 4))


def test_bits_uniforms_normals_match_the_port_at_any_rows():
    k0, k1 = threefry.key_words(KEY, "cpu")
    index = torch.tensor([0, 5, 2**32 + 3, 77], dtype=torch.int64)
    whole = prng.random_bits(KEY, (2**32 + 8,), start=0, stop=8)
    assert torch.equal(threefry.random_bits(k0, k1, index[:2]), whole[index[:2]])
    u = prng.uniform(KEY, (100,), -0.001, 0.001)
    assert torch.equal(threefry.uniform(k0, k1, torch.arange(100), -0.001, 0.001), u)
    assert torch.equal(threefry.normal(k0, k1, torch.arange(50)), prng.normal(KEY, (50,)))


def test_init_rows_are_those_of_the_port_init():
    n, V, d = 3, 40, 8
    keys = prng.split(KEY, n)
    full = torch.stack([port_sgns.init_params(k, port_sgns.SGNSConfig(V, d), device="cpu")["W"]
                        for k in keys])
    rows = torch.tensor([0, 39, 40 + 7, 2 * 40 + 21], dtype=torch.int64)
    assert torch.equal(ref.init_rows(KEY, n, V, d, rows), full.view(n * V, d)[rows])
    assert torch.equal(ref.init_tables(KEY, n, V, d, "cpu", rows_a_call=7), full)


def _tables(V=50, n=2, seed=0):
    rng = np.random.default_rng(seed)
    counts = [rng.integers(0, 30, V) for _ in range(n)]
    al = [data.noise_alias(c) for c in counts]
    return counts, {"prob": torch.from_numpy(np.stack([a[0] for a in al])),
                    "alias": torch.from_numpy(np.stack([a[1] for a in al]))}


def test_draws_match_the_port():
    counts, table = _tables()
    seeds = prng.split(KEY, 2)
    ids = ref.draw_alias(seeds, table["prob"], table["alias"], 16, 5)
    port = sgns_fused.sample_negatives_plain(sgns_fused.seed_tensor(seeds), table["prob"],
                                             table["alias"], (16, 5))
    assert torch.equal(ids, port.long())
    cdf = torch.from_numpy(np.stack([data.noise_cdf(c) for c in counts]))
    port_cdf = port_pairs.stack_noise_tables(counts, kind="cdf")
    assert torch.equal(cdf, port_cdf)
    assert torch.equal(ref.draw_cdf(seeds, cdf, 16, 5),
                       port_pairs.sample_negatives_cdf(cdf, seeds, (16, 5)).long())


def test_alias_tables_match_the_port():
    counts, table = _tables()
    port = port_pairs.stack_noise_tables(counts, kind="alias")
    assert torch.equal(table["prob"], port["prob"]) and torch.equal(table["alias"], port["alias"])


def test_step_matches_the_port_plain_step():
    n, V, d, B, K = 2, 50, 8, 12, 5
    _, table = _tables(V, n)
    rng = np.random.default_rng(3)
    cen = torch.from_numpy(rng.integers(0, V, (n, B)).astype(np.int32))
    ctx = torch.from_numpy(rng.integers(0, V, (n, B)).astype(np.int32))
    seeds = prng.split(KEY, n)
    W = torch.rand(n, V, d) * 0.1
    C = torch.rand(n, V, d) * 0.1
    params = {"W": W.clone(), "C": C.clone()}
    _, loss, _ = sgns_fused.sgns_fused_step_plain(params, cen, ctx, table,
                                                  sgns_fused.seed_tensor(seeds), 0.025, negatives=K)
    off = (torch.arange(n) * V)[:, None]
    negs = ref.draw_alias(seeds, table["prob"], table["alias"], B, K)
    Wf, Cf = W.view(n * V, d).clone(), C.view(n * V, d).clone()
    ref_loss = ref.sgns_step_(Wf, Cf, cen.long() + off, ctx.long() + off,
                              negs + off[:, :, None], 0.025)
    torch.testing.assert_close(Wf.view(n, V, d), params["W"], atol=1e-7, rtol=0)
    torch.testing.assert_close(Cf.view(n, V, d), params["C"], atol=1e-7, rtol=0)
    torch.testing.assert_close(ref_loss, port_sgns.worker_mean(loss), rtol=1e-6, atol=0)


def test_linear_lr_matches_the_port():
    cfg = port_sgns.SGNSConfig(10, lr=0.025, lr_min=1e-4)
    for step in (0, 1, 50, 99, 100, 150):
        assert ref.linear_lr(step, 100, 0.025, 1e-4) == port_sgns.linear_lr(step, 100, cfg)


def test_alir_matches_the_port_merger():
    rng = np.random.default_rng(5)
    n, V, d = 3, 60, 6
    base = torch.from_numpy(rng.normal(size=(V, d)).astype(np.float32))
    Q = [torch.linalg.qr(torch.from_numpy(rng.normal(size=(d, d)).astype(np.float32)))[0]
         for _ in range(n)]
    models = torch.stack([base @ q + 0.01 * torch.randn(V, d) for q in Q])
    mask = torch.from_numpy(rng.random((n, V)) < 0.8)
    mask[:, :5] = True
    res = get_merger("alir", device="cpu", seed=9).merge(StackedModels(models, mask))
    Y, valid, Ws = ref_alir.alir(models, mask, threefry.PRNGKey(9))
    assert torch.equal(valid, res.valid)
    torch.testing.assert_close(Y, res.emb, atol=1e-5, rtol=0)
    torch.testing.assert_close(Ws, res.transforms, atol=1e-5, rtol=0)
    gap, R = ref_alir.row_gap(res.emb, Y, valid)
    assert gap < 1e-4 and torch.allclose(R, torch.eye(d), atol=1e-4)


def test_row_gap_sees_a_rotation_as_no_gap_and_a_changed_row_as_one():
    rng = np.random.default_rng(1)
    Y = torch.from_numpy(rng.normal(size=(40, 5)).astype(np.float32))
    q = torch.linalg.qr(torch.from_numpy(rng.normal(size=(5, 5)).astype(np.float32)))[0]
    valid = torch.ones(40, dtype=torch.bool)
    assert ref_alir.row_gap(Y @ q, Y, valid)[0] < 1e-5
    bad = Y.clone()
    bad[3] = -bad[3]
    assert ref_alir.row_gap(bad, Y, valid)[0] > 0.5


def test_divide_phase_matches_the_port():
    from repro_torch.core.driver import build_worker_vocabs
    from repro_torch.data.corpus import SemanticCorpusModel
    from repro_torch.data.pipeline import PairChunkStream, make_worker_streams

    model = data.SemanticCorpusModel.create(1500, num_topics=8, seed=4)
    corpus = model.generate(2000, seed=5)
    port_model = SemanticCorpusModel.create(vocab_size=1500, num_topics=8, seed=4)
    port_corpus = port_model.generate(2000, seed=5)
    assert np.array_equal(corpus.tokens, port_corpus.tokens)
    assert np.array_equal(corpus.select(np.array([3, 3, 0])).tokens,
                          port_corpus.select(np.array([3, 3, 0])).tokens)
    for strategy in ("shuffle", "random"):
        vocabs, union, mask = data.build_worker_vocabs(corpus, 1500, strategy, 3, 1 / 3, 1500, 10, 6)
        pv, punion, pmask = build_worker_vocabs(port_corpus, 1500, strategy, 3, 1 / 3,
                                                max_vocab=1500, base_min_count=10, seed=6)
        assert np.array_equal(mask, pmask) and np.array_equal(union.word_ids, punion.word_ids)
        c, x = data.pair_pool(corpus, vocabs, strategy, 1 / 3, 5, 1e-4, 6, 6, 32)
        streams = [make_worker_streams(port_corpus, pv[w], 3, strategy, 1 / 3, window=5,
                                       subsample_t=1e-4, seed=6)[w] for w in range(3)]
        pc, px = next(PairChunkStream(streams, 32, 6).chunks(0, 1))
        assert np.array_equal(c, pc) and np.array_equal(x, px)


def test_rank_vocab_keeps_every_word_in_prior_order():
    model = data.SemanticCorpusModel.create(500, num_topics=4, seed=1)
    corpus = model.generate(200, seed=2)
    v = data.rank_vocab(corpus, model)
    assert v.size == 500 and v.counts.sum() == corpus.num_tokens
    assert np.all(np.diff(model.zipf_probs[v.word_ids]) <= 0)
    assert np.array_equal(v.lookup[v.word_ids], np.arange(500))


def test_step_bytes_and_flops_by_hand():
    centers = torch.tensor([[1, 1, 2], [0, 0, 0]])
    contexts = torch.tensor([[3, 4, 4], [1, 2, 3]])
    ids = torch.tensor([[[3], [5], [6]], [[1], [1], [9]]])
    # W rows: {1, 2} + {0}; C rows: {3, 4, 5, 6} + {1, 2, 3, 9}
    rows = 3 + 8
    d = 4
    want = 2 * rows * d * 4 + 2 * 3 * 12 + 2 * 3 * 1 * 8 + 2 * 8
    assert yard.step_bytes(centers, contexts, ids, d) == want
    assert yard.sgns_model_flops(10, 5, 500) == 6 * 10 * 6 * 500
    least, tb, tf = yard.least_step_seconds(3.35e12, 67e12 / 2)
    assert (least, tb, tf) == (1.0, 1.0, 0.5)


def test_step_bytes_is_the_port_count():
    from repro_torch.launch import roofline

    rng = np.random.default_rng(8)
    c = torch.from_numpy(rng.integers(0, 30, (3, 16)))
    x = torch.from_numpy(rng.integers(0, 30, (3, 16)))
    ids = torch.from_numpy(rng.integers(0, 30, (3, 16, 5)))
    assert yard.step_bytes(c, x, ids, 50) == roofline.step_bytes(c, x, ids, 50)
    assert yard.PEAK_FLOPS == roofline.PEAK_FLOPS and yard.HBM_BW == roofline.HBM_BW


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_step_runs_in_both_precisions(dtype):
    W = torch.full((4, 3), 0.01, dtype=dtype)
    C = torch.zeros((4, 3), dtype=dtype)
    loss = ref.sgns_step_(W, C, torch.tensor([[0, 1]]), torch.tensor([[2, 3]]),
                          torch.tensor([[[1], [0]]]), 0.025)
    assert loss.dtype == torch.float32 and torch.all(C[2:] != 0)
