"""Carry parameters and noise tables between numpy and the port's tensors.

The JAX package's parameters are ``{"W", "C"}`` dicts of arrays, single
``(V, d)`` or stacked ``(n, V, d)``, and its alias tables are
``{"prob", "alias"}`` dicts; ``np.asarray`` turns either into numpy.
These helpers start the port from exactly that state (a copy, on the
requested device) and bring the port's state back. The LLM model's
parameter pytree (``repro.models.Model.init``), its optimizer states and
its decode cache go across too: :func:`from_jax_model_params`,
:func:`to_jax_model_params`, :func:`from_jax_opt_state`,
:func:`to_jax_opt_state`, :func:`to_jax_cache`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


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


def from_jax_model_params(cfg, params_np: dict, device="cpu"):
    """``repro.models.Model(cfg).init(key)``'s pytree, as numpy (or
    array-likes), → the port's :class:`repro_torch.models.Model` on
    ``device`` with exactly those values (copied), ready to serve or to
    train. Raises ``ValueError`` if a parameter of either side has no
    counterpart or another shape."""
    from repro_torch.models import Model

    return Model(cfg, device=device).load_param_tree(params_np)


def to_jax_model_params(model) -> dict:
    """The port's :class:`repro_torch.models.Model` → the reference's
    parameter pytree as numpy, the cycle's leaves stacked over cycles (the
    inverse of :func:`from_jax_model_params`)."""
    return _numpy_tree(model.param_tree())


def to_jax_opt_state(state):
    """An optimizer state (``repro_torch.optim``: ``sgd``, ``adamw``,
    ``adafactor``), tensors on any device → numpy. Each optimizer's state
    is already the reference's tree (the parameters as
    :meth:`~repro_torch.models.Model.param_tree` lays them out), so this is
    the tree, leaf by leaf."""
    return _numpy_tree(state)


def _numpy_tree(tree):
    # copies, also of CPU tensors: a later training step changes none of them
    return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy(), tree)


def from_jax_opt_state(state_np, device="cpu"):
    """The reference's optimizer state (numpy or array-likes) → tensors on
    ``device`` (copied, dtypes kept): the inverse of
    :func:`to_jax_opt_state`."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device), state_np)


def to_jax_cache(cfg, cache: list) -> dict:
    """The port's per-layer decode cache → the reference's layout, as
    numpy: ``{"prefix": [per-layer dict], "cycle": {str(j): stacked over
    cycles} or None}``. Every kind goes across under its own keys: ``k``/
    ``v`` (and ``cross_k``/``cross_v``), ``c_kv``/``k_rope``, ``conv``/
    ``h``, ``C``/``n``/``m`` and ``h``/``c``/``n``/``m``."""
    # copies, also of CPU tensors: the next decode step writes the caches in place
    layers = [{k: v.detach().to("cpu", copy=True).numpy() for k, v in c.items()}
              for c in cache]
    P = len(cfg.prefix_codes)
    cycle = None
    if cfg.resolved_num_cycles:
        n = len(cfg.cycle_codes)
        cycle = {str(j): {k: np.stack([layers[P + c * n + j][k]
                                       for c in range(cfg.resolved_num_cycles)])
                          for k in layers[P + j]}
                 for j in range(n)}
    return {"prefix": layers[:P], "cycle": cycle}
