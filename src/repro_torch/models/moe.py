"""Mixture-of-Experts FFN with GShard-style capacity dispatch — the
counterpart of ``repro.models.moe`` (``init_moe``, ``moe_forward``: :class:`MoE`).

Used by qwen3-moe (128 experts, top 8), deepseek-v2-lite (64 routed, top
6, 2 shared) and jamba (16, top 2). The reference's fixed-shape dispatch:
a float32 router, softmax, top-k renormalised, the Switch aux loss, each
assignment's position in its expert by a cumulative sum in token-major
order, assignments past ``capacity`` dropped, the kept ones copied into
``(G, E, C, d)`` buffers, every expert's SwiGLU on its buffer, and each
token's k outputs weighted and summed.

Integer routing is reproduced exactly: ``top_k`` is a stable descending
sort (``jax.lax.top_k`` puts the lower index first among equal
probabilities; ``torch.topk`` does not promise an order), positions are an
integer cumsum. No float atomics: every kept assignment owns its (expert,
slot); the dropped ones go to one row past the buffer, which is cut off
(the reference adds their zero contribution into the clipped slot, which
changes nothing), and the combine reads a zero row for them and adds a
token's k contributions in k order. :func:`expert_slots`, :func:`dispatch`
and :func:`combine` take a block of the experts: all of them here, each
rank's own under a mesh (``sharding.ctx.ExpertBlocks``).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import prng
from repro_torch.models.layers import MLP, dense_param, frozen
from repro_torch.sharding import ctx as shctx


class MoE(nn.Module):
    """``init_moe``'s parameters from ``split(key, 5)``: ``router`` ``(d, E)``
    float32 from [0]; ``gate``, ``up`` ``(E, d, f)`` and ``down`` ``(E, f,
    d)`` as ``0.02·normal`` from [1], [2], [3]; with shared experts
    ``shared``, an MLP of width ``(d_ff_shared or f)·num_shared`` from [4].
    ``key`` None leaves them uninitialised."""

    def __init__(self, key, d_model: int, d_ff_expert: int, num_experts: int, top_k: int,
                 dtype, num_shared: int = 0, d_ff_shared: int | None = None, device="cpu"):
        super().__init__()
        self.num_experts, self.top_k = num_experts, top_k
        ks = prng.split(key, 5) if key is not None else (None,) * 5
        E, d, f = num_experts, d_model, d_ff_expert
        self.router = dense_param(ks[0], d, E, torch.float32, device)
        for name, k, shape in (("gate", ks[1], (E, d, f)), ("up", ks[2], (E, d, f)),
                               ("down", ks[3], (E, f, d))):
            w = ((prng.normal(k, shape, device) * 0.02).to(dtype) if k is not None else
                 torch.empty(shape, dtype=dtype, device=device))
            setattr(self, name, frozen(w))
        self.shared = (MLP(ks[4], d, (d_ff_shared or d_ff_expert) * num_shared, dtype, device)
                       if num_shared else None)

    def forward(self, x: torch.Tensor, capacity_factor: float = 1.25,
                groups: int | None = None, routes: list | None = None):
        """``moe_forward``: x (B, S, d) → (out (B, S, d), aux loss).
        ``groups``: the reference's dispatch groups (None → one a batch shard
        of the enabled mesh context, else 1); the tokens split into G groups
        when N % G == 0 and N >= G. The (G, E, C, d) buffers are pinned G →
        data, E → model and the tokens to the batch axes, as the reference's
        (:mod:`repro_torch.sharding.ctx`: the identity without a mesh); under
        a mesh of more than one rank, each rank builds and reads only its
        block (``ctx.ExpertBlocks``), as GSPMD lays out the reference's
        vmapped scatter and gather. ``routes``, if a list, gets each call's ``top_idx``
        and ``keep`` (integer outputs the tests and the card's checks
        compare)."""
        B, S, d = x.shape
        N = B * S
        E, k = self.num_experts, self.top_k
        if groups is None:
            groups = shctx.batch_shard_count() if shctx.enabled() else 1
        G = groups if N % groups == 0 and N >= groups else 1
        Ng = N // G
        xt = shctx.shard_batch(x.reshape(G, Ng, d))
        r = route(self.router, xt, E, k, capacity_factor)
        if routes is not None:
            routes.append({"top_idx": r["top_idx"], "keep": r["keep"]})
        C, keep, flat_e, pos = r["capacity"], r["keep"], r["flat_e"], r["pos"]
        Nk = Ng * k
        # under a mesh: each rank's (G/·, E/·, C, d) block (sharding.ctx)
        blocks = shctx.expert_blocks(xt, flat_e, pos, keep, E, C, k)
        if blocks is None:
            dest = expert_slots(flat_e, pos, keep, 0, E, C)
            buf = shctx.shard_group_experts(dispatch(xt, dest, k, E, C))
        else:
            buf = blocks.dispatch(xt)
        h = (torch.nn.functional.silu(torch.einsum("gecd,edf->gecf", buf, self.gate))
             * torch.einsum("gecd,edf->gecf", buf, self.up))
        out_buf = shctx.shard_group_experts(torch.einsum("gecf,efd->gecd", h, self.down))
        w = (r["top_vals"].reshape(G, Nk).float() * keep.float()).to(x.dtype)
        combined = combine(out_buf, w, dest, k)[0] if blocks is None else blocks.combine(out_buf, w)
        combined = shctx.shard_batch(combined)
        if self.shared is not None:
            combined = combined + self.shared(xt)
        return combined.reshape(B, S, d), r["aux"]


def expert_slots(flat_e, pos, keep, e0: int, El: int, C: int) -> torch.Tensor:
    """Each assignment's row ``(G·Nk,)`` of the flattened ``(G·El·C + 1, d)``
    buffer of experts ``e0 … e0 + El − 1`` (``(G, Nk)`` routes): its slot
    ``(g, e − e0, pos)`` if it is kept and its expert lies in the block,
    else the one row past the buffer (``e0 = 0``, ``El = E``: every expert)."""
    G = flat_e.shape[0]
    inside = keep & (flat_e >= e0) & (flat_e < e0 + El)
    g = torch.arange(G, device=flat_e.device)[:, None] * (El * C)
    return torch.where(inside, g + (flat_e - e0) * C + pos, G * El * C).reshape(-1)


def dispatch(xt, dest, k: int, El: int, C: int):
    """The ``(G, El, C, d)`` buffer of ``xt`` ``(G, Ng, d)``'s assignments
    (token-major, k a token) written to their ``dest`` rows; the row past
    the buffer, which takes the others, is dropped."""
    G, Ng, d = xt.shape
    tok = torch.arange(Ng, device=xt.device).repeat_interleave(k)        # (Ng·k,)
    rows = xt.new_zeros((G * El * C + 1, d)).index_put((dest,), xt[:, tok].reshape(-1, d))
    return rows[:-1].reshape(G, El, C, d)


def dispatch_grad(g_buf, dest, k: int):
    """:func:`dispatch`'s gradient for ``xt``: each assignment's row of
    ``g_buf`` (a zero row past it), a token's k added."""
    G, El, C, d = g_buf.shape
    rows = torch.cat([g_buf.reshape(-1, d), g_buf.new_zeros((1, d))])[dest]
    return rows.view(G, -1, k, d).sum(2)


def combine(out_buf, w, dest, k: int):
    """Each assignment's row of ``out_buf`` ``(G, El, C, d)`` (a zero row
    where ``dest`` is past it: dropped, or of another block's expert) times
    its weight ``w`` ``(G, Ng·k)``, a token's k of them added in k order:
    ``(G, Ng, d)``, and the rows read ``(G·Ng·k, d)``."""
    G, El, C, d = out_buf.shape
    vals = torch.cat([out_buf.reshape(-1, d), out_buf.new_zeros((1, d))])[dest]
    contrib = (vals * w.reshape(-1, 1)).reshape(G, -1, k, d)
    combined = contrib[:, :, 0]
    for j in range(1, k):
        combined = combined + contrib[:, :, j]
    return combined, vals


def combine_grad(g, vals, w, dest, k: int, shape):
    """:func:`combine`'s gradients from the output's ``g`` ``(G, Ng, d)``:
    ``out_buf``'s ``shape`` ``(G, El, C, d)`` and ``w``'s ``(G, Ng·k)``."""
    G, El, C, d = shape
    tok = torch.arange(g.shape[1], device=g.device).repeat_interleave(k)
    grows = g[:, tok].reshape(-1, d)                                     # (G·Ng·k, d)
    gbuf = g.new_zeros((G * El * C + 1, d)).index_put((dest,), grows * w.reshape(-1, 1))
    return gbuf[:-1].view(shape), (grows * vals).sum(-1).view(G, -1)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, the lower index
    first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, xt: torch.Tensor, num_experts: int, k: int,
          capacity_factor: float) -> dict:
    """The reference's routing on ``xt`` (G, Ng, d): ``probs`` (G, Ng, E),
    ``top_vals``/``top_idx`` (G, Ng, k) renormalised, the Switch ``aux``
    loss, ``capacity``, and per assignment (G, Ng·k, token-major) its
    expert ``flat_e``, position ``pos`` and ``keep`` (pos < capacity)."""
    G, Ng, _ = xt.shape
    E = num_experts
    logits = xt.float() @ router
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = top_k(probs, k)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True)
    me = probs.mean(dim=(0, 1))
    one_hot_k = torch.nn.functional.one_hot(top_idx, E).float()            # (G,Ng,k,E)
    ce = one_hot_k.sum(2).mean(dim=(0, 1))
    aux = E * (me * ce).sum()
    capacity = int(max(1, round(capacity_factor * Ng * k / E)))
    flat_e = top_idx.reshape(G, Ng * k)
    one_hot_e = torch.nn.functional.one_hot(flat_e, E)                     # int64
    pos = ((one_hot_e.cumsum(1) - 1) * one_hot_e).sum(-1)                  # (G, Nk)
    return {"probs": probs, "top_vals": top_vals, "top_idx": top_idx, "aux": aux,
            "capacity": capacity, "flat_e": flat_e, "pos": pos, "keep": pos < capacity}
