"""Wrappers around K3 with the JAX package's ``kernels/ops.py`` contract.

``sgns_row_grads`` is a drop-in for :func:`repro_torch.core.sgns
.sparse_row_grads` (mean loss, per-row gradients); ``make_row_grad_fn``
is the ``row_grad_fn`` seam of ``train_step_sparse``; ``sgns_apply_step``
is the whole gather → kernel → scatter-add step on one model. The
reference's padding of d to 128 lanes and of the batch to its VMEM block
is not carried over: K3 takes any shape.
"""

from __future__ import annotations

import torch

from repro_torch.core.sgns import train_step_sparse
from repro_torch.kernels import ref
from repro_torch.kernels.sgns_update import sgns_row_grads as _row_grads


def sgns_row_grads(w: torch.Tensor, c_pos: torch.Tensor, c_neg: torch.Tensor):
    """Kernel-backed row grads on gathered rows ``w``, ``c_pos`` ``(B, D)``,
    ``c_neg`` ``(B, K, D)``. Returns ``(mean_loss, dW (B, D), dC_pos (B, D),
    dC_neg (B, K, D))`` — sum-loss gradients, the mean loss (Σ loss / B)
    for reporting."""
    loss, d_w, d_cp, d_cn = _row_grads(w.contiguous(), c_pos.contiguous(),
                                       c_neg.contiguous())
    return loss.sum() / w.shape[0], d_w, d_cp, d_cn


def make_row_grad_fn():
    """``row_grad_fn`` for :func:`repro_torch.core.sgns.train_step_sparse`
    (the reference's TPU dials ``interpret`` and ``block_b`` have no
    counterpart, so this is :func:`sgns_row_grads` itself)."""
    return sgns_row_grads


def sgns_apply_step(params: dict, centers: torch.Tensor, contexts: torch.Tensor,
                    negatives: torch.Tensor, lr: float):
    """One model's step: gather → K3 → accumulating scatter-add (W at
    centers, then C at contexts, then C at negatives). Returns ``(new
    tables, mean loss)``."""
    return train_step_sparse(params, centers, contexts, negatives, lr,
                             row_grad_fn=sgns_row_grads)


# Re-export the oracle so tests can ask one module for both sides.
sgns_row_grads_ref = ref.sgns_row_grads_ref
