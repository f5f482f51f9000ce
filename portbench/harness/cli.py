"""One run of one cell: set-up, a measured window, the check against the
plain reference, and the result's last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` they are its per-layer ones, each read by
``metrics/<name>.py`` from the run's record: the measured window is
followed by one of the traffic's ``trace_seconds`` under
``torch.profiler`` (the record keeps the measured window's counts under
``measured``). Either way the run checks what its
timed path produced, prints every number compared beside its limit as the
last lines of standard error and, last on standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")

#: Exit codes of runs that print no result.
NO_CHIP, FORBIDDEN_LOADED, NO_PROGRAM = 3, 4, 5


def clock() -> float:
    """Seconds since boot (the clock a process's start time is kept in)."""
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """When this process started, on :func:`clock` (Linux keeps it in
    ticks of 10 ms); now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return clock()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark never loads."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(spec, workload: str, seed: int, seconds: float, trace: bool, device,
             started: float) -> dict:
    """Runs one cell on ``device`` and returns the result object."""
    import torch

    from portbench.harness.trace import Tracer, breakdown, busy_us, window_us

    cell = spec.cell(workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    limits = spec.limits(workload)
    cuda = device.type == "cuda"
    drive = spec.drive(traffic).Drive(config, traffic, seed, device)
    drive.setup()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = clock() - started
    measured = drive.window(seconds, Tracer(False, device))
    if trace:
        counted = drive.counts()
        tracer = Tracer(True, device)
        tracer.start()
        drive.window(min(seconds, traffic["trace_seconds"]), tracer)
        tracer.stop()
        record = tracer.record({**drive.counts(), "measured": counted})
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    drive.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = drive.check()
    if set(readings) != set(limits):
        raise RuntimeError(f"the check read {sorted(readings)}, the limits name {sorted(limits)}")
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in sorted(readings)}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    if trace:
        for m in spec.per_layer(workload):
            value = spec.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**measured, "setup_s": setup_s}
        for m in spec.end_to_end(workload):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(measured["attempted"]), "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = busy_us(record) / 1e6
        dev["window_s"] = window_us(record) / 1e6
        result["breakdown"] = breakdown(record)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be non-negative")

    from portbench.harness.spec import ROOT, Spec

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"portbench: the program (src/repro_torch) is not in {ROOT}", file=sys.stderr)
        return NO_PROGRAM
    spec = Spec.load()
    cell = spec.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return NO_CHIP
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), device,
                      started)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: modules that must not load were loaded: {loaded}", file=sys.stderr)
        return FORBIDDEN_LOADED
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
