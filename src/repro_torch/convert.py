"""Carry parameters and noise tables between numpy and the port's tensors.

The JAX package's parameters are ``{"W", "C"}`` dicts of arrays, single
``(V, d)`` or stacked ``(n, V, d)``, and its alias tables are
``{"prob", "alias"}`` dicts; ``np.asarray`` turns either into numpy.
These helpers start the port from exactly that state (a copy, on the
requested device) and bring the port's state back. The LLM model's
parameter pytree (``repro.models.Model.init``) and decode cache go across
too: :func:`from_jax_model_params`, :func:`to_jax_cache`.
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


def _jax_layer_params(params_np: dict, cfg) -> list:
    """The reference's per-layer parameter dicts in layer order: prefix
    layers, then cycle c's position j (``params[...][c]`` of the stacked
    cycle arrays) at ``len(prefix) + c·len(cycle_codes) + j``."""
    stack = params_np["stack"]
    layers = list(stack["prefix"])
    if stack["cycle"] is not None:
        for c in range(cfg.resolved_num_cycles):
            for j in range(len(cfg.cycle_codes)):
                layers.append(_tree_index(stack["cycle"][str(j)], c))
    return layers


def _tree_index(tree, c: int):
    if isinstance(tree, dict):
        return {k: _tree_index(v, c) for k, v in tree.items()}
    return np.asarray(tree)[c]


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        else:
            # an RMSNorm's scale is a bare array in the reference's tree
            out[name + ".scale" if k in ("norm", "norm2", "final_norm") else name] = v
    return out


def from_jax_model_params(cfg, params_np: dict, device="cpu"):
    """``repro.models.Model(cfg).init(key)``'s pytree, as numpy (or
    array-likes), → the port's :class:`repro_torch.models.Model` on
    ``device`` with exactly those values (copied). Raises if a parameter of
    either side has no counterpart or another shape."""
    from repro_torch.models import Model

    model = Model(cfg, device=device)
    flat = {k: params_np[k] for k in ("embed", "final_norm", "lm_head") if k in params_np}
    flat = _flatten(flat)
    for i, layer in enumerate(_jax_layer_params(params_np, cfg)):
        flat.update(_flatten(layer, f"layers.{i}."))
    ours = dict(model.named_parameters())
    if set(flat) != set(ours):
        raise ValueError(f"parameters differ: only in the reference's tree "
                         f"{sorted(set(flat) - set(ours))}, only in the port's "
                         f"{sorted(set(ours) - set(flat))}")
    with torch.no_grad():
        for name, p in ours.items():
            src = torch.tensor(np.asarray(flat[name]))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(p.shape)}")
            p.copy_(src)
    return model


def to_jax_cache(cfg, cache: list) -> dict:
    """The port's per-layer decode cache → the reference's layout, as
    numpy: ``{"prefix": [per-layer dict], "cycle": {str(j): stacked over
    cycles} or None}``."""
    layers = [{k: v.detach().cpu().numpy() for k, v in c.items()} for c in cache]
    P = len(cfg.prefix_codes)
    cycle = None
    if cfg.resolved_num_cycles:
        n = len(cfg.cycle_codes)
        cycle = {str(j): {k: np.stack([layers[P + c * n + j][k]
                                       for c in range(cfg.resolved_num_cycles)])
                          for k in layers[P + j]}
                 for j in range(n)}
    return {"prefix": layers[:P], "cycle": cycle}
