"""The whole training window's share of the chip's peak, %: the step's
least time at the binding peak (bytes over the HBM peak, or flops over the
float32 peak where larger) times the steps of the measured window, over
its wall."""


def read(record):
    c = record["counts"].get("measured", {})
    if not record["device"] or not c.get("steps") or "least_step_s" not in c:
        return None
    return 100.0 * c["least_step_s"] * c["steps"] / c["wall_s"]
