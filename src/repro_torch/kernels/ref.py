"""Pure-torch oracles for the kernels (the allclose references): the
row gradients of K3 and the sliding-window decode of K7."""

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


def swa_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     chunk: int = 512) -> torch.Tensor:
    """What K7 computes, in torch: one query token per sequence attends a
    full ring-buffer KV cache.

    q (B, H, D), k/v (B, W, Hkv, D) with ``H % Hkv == 0`` → (B, H, D) in
    q's dtype. Query head ``h`` reads KV head ``h // (H // Hkv)`` (the
    grouping of ``repro.models.attention._sdpa``); with ``Hkv == H`` this is
    ``repro.kernels.ref.swa_decode_ref``. Scores are ``(q·k)·(1/sqrt(D))``
    in float32, the TPU kernel's multiply (the jnp oracle divides by
    ``sqrt(D)``). ``chunk`` only carries the kernel's precondition
    ``W % chunk == 0``; a plain softmax has no chunks.
    """
    B, H, D = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    if W % chunk != 0:
        raise ValueError(f"window {W} not divisible by chunk {chunk}")
    if H % Hkv != 0:
        raise ValueError(f"{H} query heads do not group over {Hkv} KV heads")
    qg = q.reshape(B, Hkv, H // Hkv, D).float()
    s = torch.einsum("bgrd,bwgd->bgrw", qg, k.float()) * (1.0 / D ** 0.5)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrw,bwgd->bgrd", p, v.float())
    return out.reshape(B, H, D).to(q.dtype)


def swa_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The reference's ``swa_decode_ref(q, k, v)``: q (B, H, D), k/v (B, W,
    H, D) holding exactly the window → (B, H, D) in q's dtype, float32
    scores. :func:`swa_decode_plain` at one chunk of the whole window (it
    also takes ``H % Hkv == 0`` grouped KV heads)."""
    return swa_decode_plain(q, k, v, chunk=k.shape[1])
