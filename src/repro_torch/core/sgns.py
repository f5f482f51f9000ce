"""SGNS (skip-gram with negative sampling) — the paper's base model, in torch.

word2vec's SGNS objective (Eq. 1 of the paper):

    log σ(w·c) + Σ_{k} E_{c'~P_D^{3/4}} log σ(−w·c')

The counterpart of ``repro.core.sgns``: manual per-row gradients and an
accumulating scatter-add (``train_step_sparse``), the linear learning
rate, and word2vec's initialization W ~ U(−0.5/d, 0.5/d), C = 0, drawn
through :mod:`repro_torch.prng` so that it is bitwise equal to the
reference's from the same key.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng


@dataclass(frozen=True)
class SGNSConfig:
    vocab_size: int
    dim: int = 500            # paper: 500 dims
    window: int = 10          # paper: 10 each side
    negatives: int = 5        # word2vec default k
    lr: float = 0.025         # word2vec default initial alpha
    lr_min: float = 1e-4
    seed: int = 0


def init_params(key, cfg: SGNSConfig, device="cpu") -> dict:
    """``{"W": U(−0.5/d, 0.5/d), "C": 0}`` of shape ``(V, d)`` from a
    ``(2,)`` uint32 key."""
    kw, _ = prng.split(key)
    w = prng.uniform(kw, (cfg.vocab_size, cfg.dim), -0.5 / cfg.dim,
                     0.5 / cfg.dim, device=device)
    c = torch.zeros((cfg.vocab_size, cfg.dim), dtype=torch.float32,
                    device=device)
    return {"W": w, "C": c}


def sparse_row_grads_per_pair(w: torch.Tensor, c_pos: torch.Tensor,
                              c_neg: torch.Tensor):
    """Per-pair losses and per-row gradients of the *sum* SGNS loss on
    gathered rows w (B,d), c_pos (B,d), c_neg (B,K,d).

    Returns (loss (B,), dW_rows (B,d), dC_pos_rows (B,d),
    dC_neg_rows (B,K,d)).
    """
    s_pos = (w * c_pos).sum(-1)
    s_neg = torch.einsum("bd,bkd->bk", w, c_neg)
    loss = -F.logsigmoid(s_pos) - F.logsigmoid(-s_neg).sum(-1)
    g_pos = torch.sigmoid(s_pos) - 1.0
    g_neg = torch.sigmoid(s_neg)
    d_w = g_pos[:, None] * c_pos + torch.einsum("bk,bkd->bd", g_neg, c_neg)
    d_cp = g_pos[:, None] * w
    d_cn = g_neg[..., None] * w[:, None, :]
    return loss, d_w, d_cp, d_cn


def sparse_row_grads(w, c_pos, c_neg):
    """(mean_loss, dW_rows, dC_pos_rows, dC_neg_rows)."""
    loss, d_w, d_cp, d_cn = sparse_row_grads_per_pair(w, c_pos, c_neg)
    return loss.mean(), d_w, d_cp, d_cn


def train_step_sparse(params: dict, centers: torch.Tensor,
                      contexts: torch.Tensor, negatives: torch.Tensor,
                      lr: float, row_grad_fn=sparse_row_grads):
    """Gather → row grads → accumulating scatter-add, in the reference's
    order (W at centers, then C at contexts, then C at negatives).
    Returns new tables, like the reference; duplicate ids accumulate."""
    centers, contexts = centers.long(), contexts.long()
    negatives = negatives.long()
    w = params["W"][centers]
    c_pos = params["C"][contexts]
    c_neg = params["C"][negatives]
    loss, d_w, d_cp, d_cn = row_grad_fn(w, c_pos, c_neg)
    neg_lr = -float(np.float32(lr))
    W = params["W"].index_add(0, centers, neg_lr * d_w)
    C = params["C"].index_add(0, contexts, neg_lr * d_cp)
    C = C.index_add_(0, negatives.reshape(-1),
                     neg_lr * d_cn.reshape(-1, d_cn.shape[-1]))
    return {"W": W, "C": C}, loss


def linear_lr(step: int, total_steps: int, cfg: SGNSConfig) -> np.float32:
    """word2vec's linearly decaying alpha, in float32 with the
    reference's expression: ``max(lr·(1 − clip(step/total, 0, 1)), lr_min)``."""
    f32 = np.float32
    frac = np.clip(f32(step) / f32(max(total_steps, 1)), f32(0.0), f32(1.0))
    return np.maximum(f32(cfg.lr) * (f32(1.0) - frac), f32(cfg.lr_min))


def embedding_matrix(params: dict) -> torch.Tensor:
    """The word representation the paper evaluates (input vectors W)."""
    return params["W"]
