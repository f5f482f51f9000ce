"""End-to-end driver at the paper's model scale: a ~100M-parameter SGNS
model (vocab 100k × dim 500 input table) trained for a few hundred steps
per async worker, merged with ALiR, evaluated, checkpointed.

    PYTHONPATH=src python -m repro_torch.examples.train_w2v_100m [--steps 600]

The counterpart of ``examples/train_w2v_100m.py``, on the GPU unless
``--device cpu``. Ingestion is the streaming pipeline: pairs are
extracted block-of-sentences at a time into fixed-shape chunks and
prefetched to the device while it trains. The per-step compute is an
update engine (``--engine``, the port's or the JAX package's names): the
default ``fused`` runs the whole step, its negative draw included, in one
CUDA launch (K2); ``fused_hbm`` chains pair blocks in one launch (K4a);
``fused_pipe`` and ``fused_tiered`` are K5 and K6 (``--ring-depth``,
``--hot-rows``); ``sparse:alias`` is the plain torch step.
"""

import argparse
import os
import tempfile
import time

from repro_torch.checkpoint import save_checkpoint
from repro_torch.core.driver import gather_submodels, train_submodels
from repro_torch.core.engine import get_engine, port_engine_spec
from repro_torch.core.merge import merge as merge_models
from repro_torch.core.sgns import SGNSConfig
from repro_torch.data.corpus import SemanticCorpusModel
from repro_torch.device import resolve_device
from repro_torch.eval.benchmarks import BenchmarkSuite, evaluate_all
from repro_torch.launch.mesh import multihost_train_kwargs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600,
                    help="steps per worker per epoch")
    ap.add_argument("--vocab", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=500)
    ap.add_argument("--workers", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--engine", default="fused",
                    help="update engine (dense | sparse | rowgrad | fused | "
                         "fused_hbm | fused_pipe | fused_tiered, or the JAX "
                         "package's names; optional ':cdf'/':alias' suffix)")
    ap.add_argument("--hot-rows", type=int, default=None,
                    help="fused_tiered: hot-prefix rows per table (default 256)")
    ap.add_argument("--ring-depth", type=int, default=None,
                    help="fused_pipe/_tiered: row ring slots (default 2)")
    ap.add_argument("--steps-per-chunk", type=int, default=128,
                    help="steps per fixed-shape streamed chunk")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="chunk prefetch depth (host/device overlap)")
    ap.add_argument("--processes", type=int, default=None,
                    help="training processes (default: the torch.distributed "
                         "world size); each trains only its block of workers, "
                         "the merge gathers them (see launch/train_sgns.py)")
    ap.add_argument("--process-index", type=int, default=None,
                    help="this process's index (default: RANK)")
    ap.add_argument("--save", default=os.path.join(tempfile.gettempdir(),
                                                   "w2v_100m.npz"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run here)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)     # before the corpus: fail fast

    overrides = {k: v for k, v in (("hot_rows", args.hot_rows),
                                   ("ring_depth", args.ring_depth))
                 if v is not None}
    engine = get_engine(port_engine_spec(args.engine), **overrides)
    processes, train_kw = multihost_train_kwargs(
        args.workers, args.processes, process_index=args.process_index, device=device)

    print(f"model: 2 × {args.vocab} × {args.dim} = "
          f"{2*args.vocab*args.dim/1e6:.0f}M parameters")
    gen = SemanticCorpusModel.create(vocab_size=args.vocab, num_topics=64,
                                     seed=0)
    corpus = gen.generate(num_sentences=120_000, seed=1)
    print(f"corpus: {corpus.num_sentences} sentences, "
          f"{corpus.num_tokens/1e6:.1f}M tokens")
    suite = BenchmarkSuite.from_model(gen, top_words=min(20_000, args.vocab))

    cfg = SGNSConfig(vocab_size=0, dim=args.dim, window=5, negatives=5)
    res = train_submodels(
        corpus, args.vocab, strategy="shuffle", num_workers=args.workers,
        cfg=cfg, epochs=args.epochs, batch_size=1024, window=5,
        max_vocab=args.vocab, base_min_count=10,
        max_steps_per_epoch=args.steps, engine=engine,
        steps_per_chunk=args.steps_per_chunk, prefetch=args.prefetch,
        process_count=processes, device=device, **train_kw)
    res = gather_submodels(res)     # the merge phase: every rank holds all n
    print(f"async training: {res.timings['train_s']:.1f}s total "
          f"({res.timings['train_s']/args.workers:.1f}s/worker projected "
          f"parallel), losses {['%.3f' % l for l in res.losses]}")

    t0 = time.perf_counter()
    emb, valid = merge_models(res.stacked, "alir_pca", out_dim=args.dim,
                              device=device)
    emb, valid = emb.cpu().numpy(), valid.cpu().numpy()
    print(f"ALiR merge of {args.workers} × ({res.union_vocab.size}, "
          f"{args.dim}) sub-models: {time.perf_counter()-t0:.1f}s")

    scores = evaluate_all(emb, valid, res.union_vocab, suite)
    print(f"merged model: sim ρ={scores['similarity']:.3f} "
          f"analogy={scores['analogy']:.3f} "
          f"purity={scores['categorization']:.3f}")
    if train_kw.get("process_index", 0) == 0:
        save_checkpoint(args.save, {"embedding": emb,
                                    "word_ids": res.union_vocab.word_ids})
        print(f"checkpoint → {args.save}")


if __name__ == "__main__":
    main()
