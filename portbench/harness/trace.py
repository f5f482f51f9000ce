"""The traced run's record: ``torch.profiler`` over the measured window,
exported as a Chrome trace and read back as plain lists, plus the
benchmark's own spans (``record_function`` around its calls into the port)
and counts.

A record is a dict:

* ``window``: ``(t0, t1)`` µs, the ``portbench.window`` span;
* ``device``: ``[(ts, dur, name)]`` kernels, copies and sets on the card
  inside the window;
* ``spans``: ``{name: [(ts, dur)]}`` of the benchmark's ``portbench.*`` spans;
* ``runtime``: ``[(ts, dur, name)]`` CUDA runtime and driver calls on the host;
* ``host``: ``[(ts, dur, name)]`` the host's operator events;
* ``counts``: what the drive counted (steps, pairs, merges, least step time).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

import torch

WINDOW = "portbench.window"
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
_RUNTIME_CATS = {"cuda_runtime", "cuda_driver"}
#: Host calls that wait for the device.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cuStreamSynchronize", "cuCtxSynchronize", "cudaMemcpy", "cudaMemcpyAsync")


class Tracer:
    """``torch.profiler`` over one window when ``on``; spans are no-ops
    otherwise. ``span(name)`` marks a call into the port."""

    def __init__(self, on: bool, device: torch.device):
        self.on = on
        self.device = device
        self._prof = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def start(self) -> None:
        if not self.on:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> None:
        if self._prof is not None:
            self._prof.__exit__(None, None, None)

    def record(self, counts: dict) -> dict:
        """Export the trace to a temporary file, read it and delete it."""
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return parse(events, counts)


def parse(events: list[dict], counts: dict) -> dict:
    """A record from Chrome-trace events (``ph == "X"``)."""
    spans: dict[str, list] = {}
    device, runtime, host = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith("portbench."):
            spans.setdefault(name, []).append((ts, dur))
        elif cat in _DEVICE_CATS:
            device.append((ts, dur, name))
        elif cat in _RUNTIME_CATS:
            runtime.append((ts, dur, name))
        elif cat == "cpu_op":
            host.append((ts, dur, name))
    if WINDOW not in spans:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    t0, d = spans[WINDOW][0]
    t1 = t0 + d
    device = [(max(ts, t0), min(ts + dur, t1) - max(ts, t0), name)
              for ts, dur, name in device if ts < t1 and ts + dur > t0]
    return {"window": (t0, t1), "device": device, "spans": spans,
            "runtime": runtime, "host": host, "counts": counts}


def merged(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, length)`` intervals as sorted ``(start, end)``."""
    out: list[list[float]] = []
    for s, d in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s + d)
        else:
            out.append([s, s + d])
    return [(s, e) for s, e in out]


def busy_us(record: dict) -> float:
    """µs of the window in which some operation ran on the device."""
    return sum(e - s for s, e in merged((ts, d) for ts, d, _ in record["device"]))


def window_us(record: dict) -> float:
    t0, t1 = record["window"]
    return t1 - t0


def idle_share(record: dict):
    """The traced window's share with no operation on the device, %; None
    where nothing ran there."""
    if not record["device"]:
        return None
    return 100.0 * (1.0 - busy_us(record) / window_us(record))


def idle_gaps(record: dict) -> list[tuple[float, float]]:
    """The window's stretches with nothing on the device, ``(start, end)``."""
    t0, t1 = record["window"]
    gaps, at = [], t0
    for s, e in merged((ts, d) for ts, d, _ in record["device"]):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < t1:
        gaps.append((at, t1))
    return gaps


#: Idle stretches shorter than this are counted together, unlabelled.
SHORT_GAP_US = 20.0


def _host_label(starts: list, host: list, s: float, e: float) -> str:
    """The innermost host operator running at the middle of ``[s, e)``
    (looking back over the 256 operators that started last), or
    ``"python"`` where none runs."""
    m = 0.5 * (s + e)
    best, best_d = "python", float("inf")
    i = bisect.bisect_right(starts, m)
    for ts, d, name in host[max(0, i - 256):i]:
        if ts + d > m and d < best_d:
            best, best_d = name, d
    return best


def breakdown(record: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, each ``[[name, seconds], ...]``, longest first."""
    ops: dict[str, float] = {}
    for _, d, name in record["device"]:
        ops[name] = ops.get(name, 0.0) + d
    host = sorted(record["host"])
    starts = [ts for ts, _, _ in host]
    gaps: dict[str, float] = {}
    short = f"gaps under {SHORT_GAP_US:g} us"
    for s, e in idle_gaps(record):
        label = short if e - s < SHORT_GAP_US else _host_label(starts, host, s, e)
        gaps[label] = gaps.get(label, 0.0) + (e - s)

    def ranked(d: dict) -> list:
        return [[k[:160], v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}
