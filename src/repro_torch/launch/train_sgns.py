"""The paper's training driver: divide → async train → merge → evaluate,
then optionally publish and save.

  PYTHONPATH=src python -m repro_torch.launch.train_sgns \\
      --strategy shuffle --workers 10 --epochs 6 --dim 64 \\
      --sentences 30000 --merge alir_pca concat pca \\
      --publish artifacts/ --save merged.npz

The counterpart of ``repro.launch.train_sgns``, with the same flags,
names and defaults but for these:

* ``--device`` (new): ``cuda`` by default — the run raises without a GPU
  unless ``--device cpu`` is given.
* ``--engine`` defaults to ``fused`` (the port's main path, K2) and takes
  the port's names (``dense``, ``sparse``, ``rowgrad``, ``fused``,
  ``fused_hbm``, ``fused_pipe``, ``fused_tiered``) or the JAX package's
  (``pallas``, ``pallas_fused``, ...), with an optional ``:cdf``/``:alias``
  sampler suffix. ``--baseline`` trains the synchronized baseline with the
  same engine.
* ``--vmem-budget-mb`` is a budget of shared memory a CTA
  (:mod:`repro_torch.analysis.vmem`), by default the H100's opt-in 227 KiB
  (0.2216796875 MiB) where the reference's is a TPU core's 16 MiB of VMEM;
  0 reports without enforcing. The ``vmem:`` line is printed either way.
* ``--processes P --process-index I`` trains this process's block of
  workers only (:func:`repro_torch.launch.mesh.multihost_train_kwargs`): run
  P copies of the command under ``torchrun`` (``RANK``/``WORLD_SIZE``/
  ``MASTER_ADDR``/``MASTER_PORT``), or with ``REPRO_TORCH_INIT_METHOD=
  file:///path/store`` and an index each. Training makes no collective;
  the merge phase gathers the sub-models to every rank, and rank 0 alone
  prints the baseline, publishes and saves. NCCL with a card a rank, gloo
  over host copies with several ranks on one card or on the CPU.

``--elastic-state DIR`` trains the sub-models through the elastic runner
(:func:`repro_torch.elastic.train_submodels_elastic`, one worker at a time
on the resolved device) with ``(params, cursor)`` checkpoints in ``DIR``
every ``--ckpt-every`` chunks; re-running the command resumes each worker
from its last checkpoint (``--no-resume`` starts afresh), and on a finished
state directory trains nothing. Either package's CLI resumes the other's
state directory.

``--publish DIR`` folds the sub-models through the incremental ALiR
merger and publishes versioned artifacts, in the JAX package's format, to
``DIR``; serve them with ``python -m repro_torch.launch.serve --artifact
DIR``.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.analysis.vmem import (
    DEFAULT_VMEM_BUDGET_BYTES, check_vmem_budget, estimate_vmem)
from repro_torch.checkpoint import save_checkpoint
from repro_torch.core.driver import apply_merges, run_pipeline, train_sync_baseline
from repro_torch.core.engine import get_engine, port_engine_spec
from repro_torch.core.sgns import SGNSConfig
from repro_torch.data.corpus import SemanticCorpusModel
from repro_torch.data.pipeline import HostShardPlan
from repro_torch.device import resolve_device
from repro_torch.eval.benchmarks import BenchmarkSuite, evaluate_all
from repro_torch.launch.mesh import multihost_train_kwargs


def build_parser() -> argparse.ArgumentParser:
    """The reference's parser, plus ``--device`` (see the module doc)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--strategy", default="shuffle",
                    choices=("equal", "random", "shuffle"))
    ap.add_argument("--workers", type=int, default=10)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--window", type=int, default=5)
    ap.add_argument("--negatives", type=int, default=5)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--vocab", type=int, default=2000)
    ap.add_argument("--sentences", type=int, default=30000)
    ap.add_argument("--merge", nargs="+",
                    default=("concat", "pca", "alir_pca"),
                    help="merge methods to apply (see "
                         "repro_torch.core.merge.MERGE_METHODS; alir_tree is "
                         "the log-depth reduction-tree merge)")
    ap.add_argument("--merge-fan-in", type=int, default=2,
                    help="reduction-tree arity for the alir_tree merge "
                         "(>= 2; depth = ceil(log_fan_in(workers)))")
    ap.add_argument("--merge-shard", type=int, default=1,
                    help="ALiR Gram-accumulation row-block count — a "
                         "static dial: the bits depend on the count")
    ap.add_argument("--baseline", action="store_true",
                    help="also train the synchronized baseline (same engine)")
    ap.add_argument("--engine", default="fused",
                    help="update engine: dense | sparse | rowgrad | fused | "
                         "fused_hbm | fused_pipe | fused_tiered (or the JAX "
                         "package's names: pallas, pallas_fused, ...), "
                         "optionally ':cdf'/':alias' (e.g. sparse:alias)")
    ap.add_argument("--hot-rows", type=int, default=None,
                    help="fused_tiered: rows of the frequency-sorted id "
                         "prefix kept hot per table (default 256; 0 = pure "
                         "pipeline)")
    ap.add_argument("--ring-depth", type=int, default=None,
                    help="fused_pipe/_tiered: row-buffer ring slots (default 2)")
    ap.add_argument("--processes", type=int, default=None,
                    help="training processes (default: the torch.distributed "
                         "world size, 1 without a group); each extracts and "
                         "trains only its HostShardPlan block of workers")
    ap.add_argument("--process-index", type=int, default=None,
                    help="this process's index (default: RANK)")
    ap.add_argument("--vmem-budget-mb", type=float,
                    default=DEFAULT_VMEM_BUDGET_BYTES / 2 ** 20,
                    help="reject engine configs whose shared memory a CTA "
                         "(repro_torch.analysis.vmem) exceeds this budget "
                         "before training starts (0 = report only; default "
                         "the H100's opt-in 227 KiB)")
    ap.add_argument("--elastic-state", default=None, metavar="DIR",
                    help="preemption-tolerant training with per-worker "
                         "checkpoints in DIR (resumes from them)")
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="elastic checkpoint cadence in chunks (default 1)")
    ap.add_argument("--no-resume", action="store_true",
                    help="with --elastic-state: ignore existing "
                         "checkpoints and train from scratch")
    ap.add_argument("--save", default=None, help="checkpoint path (.npz)")
    ap.add_argument("--publish", default=None, metavar="DIR",
                    help="incrementally ALiR-fold the sub-models and "
                         "publish versioned merged-table artifacts to "
                         "DIR (serve with `python -m repro_torch.launch.serve "
                         "--artifact DIR`)")
    ap.add_argument("--publish-every", type=int, default=1,
                    help="publish a table version every k folded "
                         "sub-models (default 1: a version per worker)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without one "
                         "unless 'cpu' is given)")
    return ap


def main(argv=None):
    """Run the CLI; returns the :class:`~repro_torch.core.driver.PipelineResult`
    for callers that drive it in-process."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # engine-dial overrides only when set: passing hot_rows/ring_depth
    # to an engine without those fields is a clear TypeError
    overrides = {k: v for k, v in (("hot_rows", args.hot_rows),
                                   ("ring_depth", args.ring_depth))
                 if v is not None}
    engine = get_engine(port_engine_spec(args.engine), **overrides)
    # fail fast on a config whose kernels would not fit the card, before
    # any corpus generation or training happens
    shape = dict(vocab_size=args.vocab, dim=args.dim, negatives=args.negatives,
                 batch=args.batch, workers=-(-args.workers // (args.processes or 1)))
    est = (check_vmem_budget(engine, budget_bytes=int(args.vmem_budget_mb * 2 ** 20),
                             **shape)
           if args.vmem_budget_mb else estimate_vmem(engine, **shape))
    print(f"vmem: {est.summary()}")
    processes, train_kw = (1, {}) if args.elastic_state else multihost_train_kwargs(
        args.workers, args.processes, process_index=args.process_index, device=device)
    lead = train_kw.get("process_index", 0) == 0
    if processes > 1:
        plan = HostShardPlan(train_kw["process_index"], processes, args.workers)
        print(f"ingestion: {plan.describe()}")

    gen = SemanticCorpusModel.create(vocab_size=args.vocab, seed=0)
    corpus = gen.generate(num_sentences=args.sentences, seed=1)
    suite = BenchmarkSuite.from_model(gen, top_words=int(args.vocab * 0.6))
    cfg = SGNSConfig(vocab_size=0, dim=args.dim, window=args.window,
                     negatives=args.negatives)

    if args.elastic_state:
        from repro_torch.elastic import train_submodels_elastic

        res = train_submodels_elastic(
            corpus, args.vocab, args.strategy, args.workers, cfg,
            state_dir=args.elastic_state, resume=not args.no_resume,
            ckpt_every=args.ckpt_every, epochs=args.epochs,
            batch_size=args.batch, rate=args.rate, window=args.window,
            max_vocab=None, base_min_count=20, engine=engine, device=device)
        res = apply_merges(res, tuple(args.merge), out_dim=cfg.dim,
                           fan_in=args.merge_fan_in, shard=args.merge_shard)
    else:
        res = run_pipeline(
            corpus, args.vocab, strategy=args.strategy,
            num_workers=args.workers, cfg=cfg, epochs=args.epochs,
            batch_size=args.batch, rate=args.rate,
            window=args.window, max_vocab=None, base_min_count=20,
            merge_methods=tuple(args.merge),
            merge_fan_in=args.merge_fan_in, merge_shard=args.merge_shard,
            engine=engine, device=device, process_count=processes, **train_kw)
    print(f"strategy={args.strategy} workers={args.workers} "
          f"engine={engine.describe()} "
          f"train={res.timings['train_s']:.1f}s "
          f"steps/epoch={res.timings['steps_per_epoch']} "
          f"losses={['%.3f' % l for l in res.losses]}")
    for m, (emb, valid) in res.merged.items():
        scores = evaluate_all(emb, valid, res.union_vocab, suite)
        print(f"  {m:10s} sim={scores['similarity']:.3f}"
              f"({scores['similarity_oov']}) "
              f"ana={scores['analogy']:.3f}({scores['analogy_oov']}) "
              f"cat={scores['categorization']:.3f}"
              f"({scores['categorization_oov']}) "
              f"merge={res.timings.get('merge_%s_s' % m, 0):.2f}s")

    if not lead:        # rank 0 alone reports the baseline, publishes and saves
        return res
    if args.baseline:
        params, vocab, info = train_sync_baseline(
            corpus, args.vocab, cfg, epochs=args.epochs,
            batch_size=args.batch, window=args.window, max_vocab=None,
            engine=engine, device=device)
        emb = params["W"].cpu().numpy()
        scores = evaluate_all(emb, np.ones(vocab.size, bool), vocab, suite)
        print(f"  sync-base  sim={scores['similarity']:.3f} "
              f"ana={scores['analogy']:.3f} "
              f"cat={scores['categorization']:.3f} "
              f"train={info['train_s']:.1f}s")

    if args.publish:
        from repro_torch.serve import publish_incremental
        from repro_torch.serve.publish import submodel_arrivals
        versions, final = publish_incremental(
            submodel_arrivals(res.stacked), args.publish,
            word_ids=res.union_vocab.word_ids,
            publish_every=args.publish_every,
            meta={"strategy": args.strategy}, device=device)
        print(f"published {len(versions)} incremental table version(s) → "
              f"{args.publish} (latest v{versions[-1]}, "
              f"{int(final.valid.sum())} rows valid); serve: "
              f"python -m repro_torch.launch.serve --artifact {args.publish} "
              f"--query <ids>")

    if args.save:
        best = args.merge[-1]
        emb, valid = res.merged[best]
        save_checkpoint(args.save, {"embedding": emb, "valid": valid,
                                    "word_ids": res.union_vocab.word_ids},
                        extra={"method": best, "strategy": args.strategy})
        print(f"saved merged embedding → {args.save}")
    return res


if __name__ == "__main__":
    main()
