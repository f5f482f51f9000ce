"""Vose alias tables for the noise distribution (numpy; the port's own
copy of the alias-table part of ``repro.core.distributions``, with
bitwise-equal outputs)."""

from __future__ import annotations

import numpy as np


def build_alias_table(probs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vose's alias method: O(V) build, O(1) draw.

    Returns ``(prob, alias)`` with ``prob`` float64 in [0, 1] and
    ``alias`` int32, such that drawing ``i ~ U{0..V-1}``, ``u ~ U[0,1)``
    and returning ``i`` if ``u < prob[i]`` else ``alias[i]`` samples
    exactly from ``probs``.
    """
    p = np.asarray(probs, dtype=np.float64)
    if p.ndim != 1 or len(p) == 0:
        raise ValueError("probs must be a non-empty 1-D array")
    if (p < 0).any():
        raise ValueError("probs must be non-negative")
    s = p.sum()
    if s <= 0:
        raise ValueError("probs must sum to a positive value")
    V = len(p)
    scaled = p * (V / s)
    prob = np.ones(V, dtype=np.float64)
    alias = np.arange(V, dtype=np.int32)
    # Partition into under-/over-full buckets and pair them off.
    small = [i for i in range(V) if scaled[i] < 1.0]
    large = [i for i in range(V) if scaled[i] >= 1.0]
    while small and large:
        lo = small.pop()
        hi = large.pop()
        prob[lo] = scaled[lo]
        alias[lo] = hi
        scaled[hi] = (scaled[hi] + scaled[lo]) - 1.0
        (small if scaled[hi] < 1.0 else large).append(hi)
    # Leftovers are exactly full up to float rounding.
    for i in small + large:
        prob[i] = 1.0
        alias[i] = i
    return prob, alias

