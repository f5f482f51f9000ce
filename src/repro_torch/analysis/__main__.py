"""Run the port's static-analysis passes.

``python -m repro_torch.analysis [PASS ...] [--device cpu]`` runs, in
order (both by default):

1. **contracts** — zero collectives over one chunk and the ``(V, d)``
   tables updated in place, for every registered engine × sampler, on the
   GPU unless ``--device cpu``; and the ``@zipf50k`` planner traffic
   against the committed ``BENCH_wallclock.json``.
2. **lint** — the repo-specific AST rules RL001–RL004 over
   ``src/repro_torch``.

The reference's two other passes, ``dma_model`` and ``vmem``, are not
ported yet: asking for either exits non-zero and says so. Exit status is
nonzero if any pass fails.
"""

from __future__ import annotations

import argparse
import sys
import time

PASSES = ("contracts", "lint")
NOT_PORTED = ("dma_model", "vmem")


def _run_contracts(args) -> bool:
    from repro_torch.analysis import contracts

    argv = ["--baseline", args.baseline]
    if args.device:
        argv += ["--device", args.device]
    return contracts.main(argv) == 0


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
    waiting = [p for p in names if p in NOT_PORTED]
    if waiting:
        print(f"{', '.join(waiting)}: not ported yet (ROADMAP.md queue 1 item 7); "
              f"the port runs {', '.join(PASSES)}", file=sys.stderr)
        return 2
    unknown = [p for p in names if p not in PASSES]
    if unknown:
        ap.error(f"unknown passes {unknown}; choose from {', '.join(PASSES)}")

    runners = {"contracts": _run_contracts, "lint": _run_lint}
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
