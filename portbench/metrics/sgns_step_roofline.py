"""The SGNS step's share of its roofline, %: the step's least time (the
frozen ``step_bytes`` of its ids over the HBM peak, or its flops over the
float32 peak where that is larger) over the device's busy time a step,
every device operation of the window counted, whatever kernels run it."""

from portbench.harness.trace import busy_us


def read(record):
    c = record["counts"]
    busy = busy_us(record)
    if not record["device"] or not c.get("steps") or "least_step_s" not in c:
        return None
    return 100.0 * c["least_step_s"] * c["steps"] / (busy / 1e6)
