"""Host µs a training step: the host's time inside the benchmark's
``portbench.epoch`` spans (its calls of ``AsyncShardTrainer.epoch``), less
the time blocked in CUDA calls that wait for the device, over the window's
steps."""

from portbench.harness.trace import SYNC_CALLS


def read(record):
    spans = sorted(record["spans"].get("portbench.epoch", []))
    steps = record["counts"].get("steps")
    if not spans or not steps:
        return None
    total = sum(d for _, d in spans)
    blocked, i = 0.0, 0
    for ts, d, name in sorted(record["runtime"]):
        if not name.startswith(SYNC_CALLS):
            continue
        while i < len(spans) and spans[i][0] + spans[i][1] < ts:
            i += 1
        if i < len(spans) and spans[i][0] <= ts and ts + d <= spans[i][0] + spans[i][1]:
            blocked += d
    return (total - blocked) / steps
