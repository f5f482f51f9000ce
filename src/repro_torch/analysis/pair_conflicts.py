"""How often word2vec's per-pair order makes a pair wait for the one before.

    PYTHONPATH=src python -m repro_torch.analysis.pair_conflicts
    PYTHONPATH=src python -m repro_torch.analysis.pair_conflicts --steps 8

K4b (``csrc/sgns_fused_hbm.cu``, ``sequential=True``) walks each worker's
batch pair by pair: a pair reads its rows (its center's W row, its
context's and negatives' C rows) as every earlier pair left them, and
writes them all. It loads pair p + 1's rows while pair p is reduced and
forwards pair p's new values to the rows they equal. This module counts,
on the ``hbm`` configuration's shuffled batches (``chip_smoke.py``'s:
``examples/train_w2v_100m.py``'s corpus and model, 10 workers, B = 1024,
K = 5, one epoch cut to 64 steps) with K1's draw of the negatives:

* the share of pairs whose rows meet the rows the previous pair wrote:
  what forwarding at prefetch depth 1 serves (the rest read memory);
* the same for the pair two back, and for either of the two: what a
  depth-2 prefetch would have to forward;
* the lengths of runs of consecutive pairs whose W rows and C rows are
  pairwise disjoint (cut greedily from each batch's first pair): pairs in
  such a run could run at the same time and still give word2vec's bits.

A count of the data, not a device measurement: it runs on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def pair_conflicts(centers, contexts, ids) -> dict:
    """Counts over each worker's batch, pairs in order: ``centers``,
    ``contexts`` ``(n, B)`` and ``ids`` ``(n, B, K)`` integer arrays (or
    tensors). Returns ``{"pairs", "meet_prev", "meet_prev2",
    "meet_either", "runs"}``: the number of pairs after each batch's first,
    how many of them meet the rows pair p - 1 wrote, those pair p - 2
    wrote, those either wrote, and the run lengths (an int array, one
    entry per run, summing to n·B)."""
    cen, ctx, neg = (np.asarray(a) for a in (centers, contexts, ids))
    n, B = cen.shape
    c_rows = np.concatenate([ctx[..., None], neg], axis=-1)      # (n, B, K + 1)
    meet = {1: 0, 2: 0, "either": 0}
    runs = []
    for w in range(n):
        cw = [set(r.tolist()) for r in c_rows[w]]
        ww = cen[w].tolist()
        hit1 = [False] + [ww[p] == ww[p - 1] or bool(cw[p] & cw[p - 1]) for p in range(1, B)]
        hit2 = [False, False] + [ww[p] == ww[p - 2] or bool(cw[p] & cw[p - 2])
                                 for p in range(2, B)]
        meet[1] += sum(hit1)
        meet[2] += sum(hit2)
        meet["either"] += sum(a or b for a, b in zip(hit1, hit2))
        seen_w, seen_c, length = set(), set(), 0
        for p in range(B):
            if ww[p] in seen_w or seen_c & cw[p]:
                runs.append(length)
                seen_w, seen_c, length = set(), set(), 0
            seen_w.add(ww[p])
            seen_c |= cw[p]
            length += 1
        runs.append(length)
    return {"pairs": n * (B - 1), "meet_prev": meet[1], "meet_prev2": meet[2],
            "meet_either": meet["either"], "runs": np.asarray(runs, dtype=np.int64)}


def summarize(counts: list[dict]) -> dict:
    """Shares and the run-length distribution over several batches."""
    pairs = sum(c["pairs"] for c in counts)
    runs = np.concatenate([c["runs"] for c in counts])
    covered = runs.sum()
    out = {"batches": len(counts), "pairs_after_first": pairs}
    for key in ("meet_prev", "meet_prev2", "meet_either"):
        out[key] = sum(c[key] for c in counts) / pairs
    q = np.percentile(runs, [10, 50, 90])
    out["runs"] = {"count": int(runs.size), "mean": float(runs.mean()),
                   "p10": float(q[0]), "median": float(q[1]), "p90": float(q[2]),
                   "max": int(runs.max()),
                   # the share of pairs that sit in runs of at least L pairs
                   "pairs_in_runs_of_at_least": {
                       str(L): float(runs[runs >= L].sum() / covered)
                       for L in (2, 4, 8, 16, 32)}}
    return out


def hbm_batches(steps: int = 64, num_workers: int = 10, batch_size: int = 1024,
                negatives: int = 5, vocab: int = 100_000, sentences: int = 120_000):
    """Yields ``(centers (n, B), contexts (n, B), ids (n, B, K))`` of each
    step of the ``hbm`` configuration, in the trainer's order, with the
    negatives of K1's plain draw from the trainer's seeds."""
    from repro_torch import prng
    from repro_torch.core import driver
    from repro_torch.core.sgns import SGNSConfig
    from repro_torch.data.corpus import SemanticCorpusModel
    from repro_torch.kernels.sgns_fused import sample_negatives_plain, seed_tensor

    corpus = SemanticCorpusModel.create(vocab_size=vocab, num_topics=64, seed=0) \
        .generate(num_sentences=sentences, seed=1)
    cfg = SGNSConfig(vocab_size=0, dim=500, window=5, negatives=negatives)
    setup = driver.prepare_training(
        corpus, vocab, "shuffle", num_workers, cfg, epochs=1, batch_size=batch_size,
        window=5, max_vocab=vocab, base_min_count=10, max_steps_per_epoch=steps,
        steps_per_chunk=32, engine="fused_hbm")
    sched, table = setup.sched, setup.neg_table
    stream = setup.plan.chunk_stream(setup.streams, batch_size=batch_size,
                                     steps_per_chunk=sched.chunk_steps,
                                     sentences_per_block=setup.sentences_per_block)
    ep_key = driver._epoch_key(setup.seed, driver._STREAM_ASYNC_DATA, 0)
    for k, (cen, ctx) in enumerate(stream.chunks(0, sched.num_chunks)):
        keys = prng.split(prng.fold_in(ep_key, k), num_workers)
        S = cen.shape[1]
        seeds = seed_tensor(prng.step_keys(keys, S).transpose(1, 0, 2))
        for i in range(S):
            ids = sample_negatives_plain(seeds[i], table["prob"], table["alias"],
                                         (batch_size, negatives))
            yield np.asarray(cen[:, i]), np.asarray(ctx[:, i]), ids.numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=64)
    args = ap.parse_args(argv)
    counts = [pair_conflicts(*b) for b in hbm_batches(steps=args.steps)]
    print(json.dumps(summarize(counts), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
