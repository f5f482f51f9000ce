"""Quickstart: the paper's divide → async-train → merge pipeline, tiny.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The counterpart of ``examples/quickstart.py``: trains 4 SGNS sub-models
fully asynchronously (the ``fused`` engine) on Shuffle samples of a
synthetic corpus, merges them with ALiR, and evaluates against the corpus
generator's gold semantics. Runs on the GPU unless ``--device cpu``.
"""

import argparse

from repro_torch.core.driver import run_pipeline
from repro_torch.core.sgns import SGNSConfig
from repro_torch.data.corpus import SemanticCorpusModel
from repro_torch.eval.benchmarks import BenchmarkSuite, evaluate_all


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run here)")
    args = ap.parse_args(argv)

    gen = SemanticCorpusModel.create(vocab_size=1200, seed=0)
    corpus = gen.generate(num_sentences=12_000, seed=1)
    suite = BenchmarkSuite.from_model(gen, top_words=800)

    res = run_pipeline(
        corpus,
        raw_vocab_size=1200,
        strategy="shuffle",          # the paper's best divide strategy
        num_workers=4,
        cfg=SGNSConfig(vocab_size=0, dim=48, window=5, negatives=5),
        epochs=4,
        batch_size=512,
        window=5,
        max_vocab=None,
        merge_methods=("alir_pca", "concat", "average"),
        device=args.device,
    )
    print(f"trained 4 async sub-models in {res.timings['train_s']:.1f}s "
          f"({res.timings['steps_per_epoch']} steps/epoch); "
          f"losses {['%.2f' % l for l in res.losses]}")
    for method, (emb, valid) in res.merged.items():
        s = evaluate_all(emb, valid, res.union_vocab, suite)
        print(f"{method:10s} similarity ρ={s['similarity']:.3f}  "
              f"analogy={s['analogy']:.3f}  purity={s['categorization']:.3f}")
    print("(expect alir_pca ≥ average — alignment before averaging is "
          "the paper's Merge-phase point)")


if __name__ == "__main__":
    main()
