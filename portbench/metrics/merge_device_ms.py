"""Device busy ms a merge: the union of the device's operations in the
traced window over the merges completed in it."""

from portbench.harness.trace import busy_us


def read(record):
    merges = record["counts"].get("merges")
    if not record["device"] or not merges:
        return None
    return busy_us(record) / 1e3 / merges
