"""Carry parameters and noise tables between numpy and the port's tensors.

The JAX package's parameters are ``{"W", "C"}`` dicts of arrays, single
``(V, d)`` or stacked ``(n, V, d)``, and its alias tables are
``{"prob", "alias"}`` dicts; ``np.asarray`` turns either into numpy.
These helpers start the port from exactly that state (a copy, on the
requested device) and bring the port's state back.
"""

from __future__ import annotations

import numpy as np
import torch


def from_jax_params(params_np: dict, device="cpu") -> dict:
    """``{"W", "C"}`` numpy (or array-like) → float32 tensors on
    ``device`` (copied; the source is never aliased)."""
    return {k: torch.tensor(np.asarray(v, dtype=np.float32), device=device)
            for k, v in params_np.items()}


def from_jax_table(table_np: dict, device="cpu") -> dict:
    """``{"prob", "alias"}`` → float32 / int32 tensors on ``device``."""
    return {"prob": torch.tensor(np.asarray(table_np["prob"], dtype=np.float32),
                                 device=device),
            "alias": torch.tensor(np.asarray(table_np["alias"], dtype=np.int32),
                                  device=device)}


def to_numpy(params: dict) -> dict:
    """Tensors (any device) → numpy arrays, per key."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
