"""Run the port's static-analysis passes.

``python -m repro_torch.analysis [PASS ...] [--device cpu]`` runs, in
order (all four by default, as the reference's runner):

1. **dma_model** — the launches' phase order (K2/K4a and K5/K6) over the
   bounded space of workers, blocks and group sizes, the apply items of
   real ids, and the block planner's hazards against an oracle
   (:mod:`repro_torch.analysis.dma_model`); CPU only.
2. **contracts** — zero collectives over one chunk and the ``(V, d)``
   tables updated in place, for every registered engine × sampler, on the
   GPU unless ``--device cpu``; and the ``@zipf50k`` planner traffic
   against the committed ``BENCH_wallclock.json``.
3. **vmem** — every engine's shared memory a CTA at the paper's shape
   (300k × 500, K = 5, B = 1024) within the H100's opt-in 227 KiB, with its
   kernels resident as their launches need
   (:mod:`repro_torch.analysis.vmem`); CPU only.
4. **lint** — the repo-specific AST rules RL001–RL004 over
   ``src/repro_torch``.

Exit status is nonzero if any pass fails.
"""

from __future__ import annotations

import argparse
import sys
import time

PASSES = ("dma_model", "contracts", "vmem", "lint")


def _run_contracts(args) -> bool:
    from repro_torch.analysis import contracts

    argv = ["--baseline", args.baseline]
    if args.device:
        argv += ["--device", args.device]
    return contracts.main(argv) == 0


def _run_dma_model(args) -> bool:
    from repro_torch.analysis import dma_model

    return dma_model.main([]) == 0


def _run_vmem(args) -> bool:
    from repro_torch.analysis import vmem

    return vmem.main([]) == 0


def _run_lint(args) -> bool:
    from repro_torch.analysis import lint_rules

    return lint_rules.main(["src/repro_torch"]) == 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("passes", nargs="*", default=list(PASSES),
                    help=f"passes to run (default: {' '.join(PASSES)})")
    ap.add_argument("--device", default=None,
                    help="torch device for contracts (default: the GPU)")
    ap.add_argument("--baseline", default="BENCH_wallclock.json",
                    help="bench baseline for the traffic cross-check")
    args = ap.parse_args(argv)
    names = [p.replace("-", "_") for p in args.passes]
    unknown = [p for p in names if p not in PASSES]
    if unknown:
        ap.error(f"unknown passes {unknown}; choose from {', '.join(PASSES)}")

    runners = {"dma_model": _run_dma_model, "contracts": _run_contracts,
               "vmem": _run_vmem, "lint": _run_lint}
    failed = []
    for name in names:
        print(f"== {name} ==")
        t0 = time.perf_counter()
        ok = runners[name](args)
        print(f"== {name}: {'OK' if ok else 'FAILED'} ({time.perf_counter() - t0:.1f}s) ==")
        if not ok:
            failed.append(name)
    if failed:
        print(f"static analysis FAILED: {', '.join(failed)}")
        return 1
    print("static analysis: all passes OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
