"""Optimizers — the counterpart of ``repro.optim.optimizers``.

* ``sgd``       — plain SGD (+momentum);
* ``adamw``     — float32 moments + decoupled weight decay;
* ``adafactor`` — factored second moment, no first moment.

Each is an ``(init, update)`` pair of plain functions over a tree of
tensors (dicts, lists, ``None``; :mod:`repro_torch.tree`): ``init(params)
-> state`` and ``update(grads, state, params, step) -> (params, state)``,
both returning new tensors and leaving their inputs as they were. The
state trees are the reference's (``{"m", "v"}``, ``{"mu"}`` or ``{}``, and
per parameter ``{"vr", "vc"}`` or ``{"v"}``), so a checkpoint of either
package resumes in the other. The arithmetic follows the reference's line
by line: its float32 casts, its order of operations, and its step
scalars (AdamW's bias corrections, Adafactor's ``beta``) rounded to
float32 as the reference's ``(step + 1).astype(float32)`` makes them.

:meth:`repro_torch.models.Model.make_train_step` gives the optimizer the
reference's parameter tree, the cycle's parameters stacked over cycles:
Adafactor factors and clips a stacked tensor as a whole, so the layout is
part of its arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.sharding import ctx as shctx
from repro_torch.tree import tree_map, tree_unzip


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable   # (grads, state, params, step) -> (new_params, new_state)


def _f32_pow(base: float, exponent) -> np.float32:
    """``base ** exponent`` in float32, as the reference computes a weakly
    typed Python float raised to a float32 array."""
    return np.power(np.float32(base), np.float32(exponent))


def sgd(lr: float = 0.01, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, step):
        del step
        if momentum == 0.0:
            new = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
            return new, state
        mu = tree_map(lambda m, g: momentum * m + g.to(m.dtype), state["mu"], grads)
        new = tree_map(lambda p, m: p - lr * m.to(p.dtype), params, mu)
        return new, {"mu": mu}

    return Optimizer("sgd", init, update)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        def z32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(z32, params), "v": tree_map(z32, params)}

    def update(grads, state, params, step):
        t = np.float32(int(step) + 1)
        bc1 = float(np.float32(1.0) - _f32_pow(b1, t))
        bc2 = float(np.float32(1.0) - _f32_pow(b2, t))

        def upd(p, g, m, v):
            g32 = g.float()
            m_ = b1 * m + (1 - b1) * g32
            v_ = b2 * v + (1 - b2) * g32 * g32
            upd_ = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            p_ = p.float() - lr * (upd_ + weight_decay * p.float())
            return p_.to(p.dtype), m_, v_

        new_p, new_m, new_v = tree_unzip(
            tree_map(upd, params, grads, state["m"], state["v"]), 3)
        return new_p, {"m": new_m, "v": new_v}

    return Optimizer("adamw", init, update)


def adafactor(lr: float = 1e-2, eps: float = 1e-30,
              decay: float = 0.8, clip_threshold: float = 1.0) -> Optimizer:
    """Factored second-moment only (Shazeer & Stern): state for an (n, m)
    matrix is n + m floats instead of 2·n·m; leading axes (the reference's
    stacked cycles) are batch axes of the factoring."""

    def _factored(shape):
        return len(shape) >= 2

    def init(params):
        def one(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}
        return tree_map(one, params)

    def update(grads, state, params, step):
        t = np.float32(int(step) + 1)
        beta32 = np.float32(1.0) - _f32_pow(t, -decay)
        beta, one_minus_beta = float(beta32), float(np.float32(1.0) - beta32)

        def one(p, g, s):
            g32 = g.float()
            g2 = g32 * g32 + eps
            if _factored(p.shape):
                # under a mesh, in the layout of the gradient's reductions
                # (sharding.ctx.placed_as; the identity without one)
                row, col = g2.mean(-1), g2.mean(-2)
                vr = beta * shctx.placed_as(s["vr"], row) + one_minus_beta * row
                vc = beta * shctx.placed_as(s["vc"], col) + one_minus_beta * col
                r = vr / torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
                u = g32 / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :] + 1e-30)
                ns = {"vr": shctx.placed_as(vr, s["vr"]), "vc": shctx.placed_as(vc, s["vc"])}
            else:
                v = beta * s["v"] + one_minus_beta * g2
                u = g32 / (torch.sqrt(v) + 1e-30)
                ns = {"v": v}
            rms_u = torch.sqrt((u * u).mean() + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            return (p.float() - lr * u).to(p.dtype), ns

        return tree_unzip(tree_map(one, params, grads, state), 2)

    return Optimizer("adafactor", init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"sgd": sgd, "adamw": adamw, "adafactor": adafactor}[name](**kw)
