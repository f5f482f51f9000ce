"""Pure-torch oracles for the kernels (the allclose references)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sgns_row_grads_ref(w: torch.Tensor, c_pos: torch.Tensor,
                       c_neg: torch.Tensor):
    """Fused SGNS forward+backward on gathered rows (sum-loss semantics).

    w (B, D), c_pos (B, D), c_neg (B, K, D)  →
    (per_pair_loss (B,), dW (B, D), dC_pos (B, D), dC_neg (B, K, D)).

    Computed in float32 regardless of input dtype; outputs cast back.
    """
    dt = w.dtype
    w32, cp32, cn32 = w.float(), c_pos.float(), c_neg.float()
    s_pos = (w32 * cp32).sum(-1)                          # (B,)
    s_neg = torch.einsum("bd,bkd->bk", w32, cn32)         # (B, K)
    loss = F.softplus(-s_pos) + F.softplus(s_neg).sum(-1)
    g_pos = torch.sigmoid(s_pos) - 1.0                    # (B,)
    g_neg = torch.sigmoid(s_neg)                          # (B, K)
    d_w = g_pos[:, None] * cp32 + torch.einsum("bk,bkd->bd", g_neg, cn32)
    d_cp = g_pos[:, None] * w32
    d_cn = g_neg[..., None] * w32[:, None, :]
    return loss, d_w.to(dt), d_cp.to(dt), d_cn.to(dt)
