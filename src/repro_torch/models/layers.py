"""Shared building blocks: initializers, RMSNorm, the SwiGLU MLP, RoPE and
the LM loss — the counterparts of ``repro.models.layers`` (``dense_init``,
``embed_init``, ``rms_norm``, ``init_rms``, ``init_mlp``/``mlp``,
``rope_angles``, ``apply_rope``, ``mrope_angles``, ``text_mrope_positions``,
``lm_loss``).

Weights keep the reference's ``(in, out)`` layout and are applied as
``x @ w``, so a converted parameter is a copy and the tests compare like
with like. Draws go through :mod:`repro_torch.prng` from the same keys as
the reference's (``normal``'s uniforms are bitwise ``jax.random``'s; its
erfinv differs in the last ulps, ``PERF.md`` §2).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import prng
from repro_torch.sharding import ctx as shctx


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------
def dense_init(key, fan_in: int, fan_out: int, dtype, device="cpu") -> torch.Tensor:
    scale = (2.0 / (fan_in + fan_out)) ** 0.5
    return (prng.normal(key, (fan_in, fan_out), device) * scale).to(dtype)


def embed_init(key, vocab: int, dim: int, dtype, device="cpu") -> torch.Tensor:
    return (prng.normal(key, (vocab, dim), device) * 0.02).to(dtype)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter created without gradients: serving takes none (and its
    tensors go to numpy as they are). Training turns them on
    (:meth:`repro_torch.models.Model.make_train_step`)."""
    return nn.Parameter(t, requires_grad=False)


def dense_param(key, fan_in: int, fan_out: int, dtype, device="cpu") -> nn.Parameter:
    """``dense_init`` from ``key``, or an uninitialised ``(fan_in,
    fan_out)`` parameter for a converter to fill when ``key`` is None."""
    w = (dense_init(key, fan_in, fan_out, dtype, device) if key is not None else
         torch.empty((fan_in, fan_out), dtype=dtype, device=device))
    return frozen(w)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale


class RMSNorm(nn.Module):
    """``rms_norm`` with its ``(dim,)`` scale (``init_rms``: ones)."""

    def __init__(self, dim: int, eps: float, dtype, device="cpu"):
        super().__init__()
        self.eps = eps
        self.scale = frozen(torch.ones((dim,), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps)


# ---------------------------------------------------------------------------
# SwiGLU MLP (llama-family FFN)
# ---------------------------------------------------------------------------
def mlp(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
        down: torch.Tensor) -> torch.Tensor:
    """``silu(x @ gate) * (x @ up) @ down``: gate, up ``(d, d_ff)``, down
    ``(d_ff, d)``."""
    return (torch.nn.functional.silu(x @ gate) * (x @ up)) @ down


class MLP(nn.Module):
    """``init_mlp``'s parameters, drawn from ``key`` as the reference
    draws them (``split(key, 3)``: gate, up, down), or uninitialised when
    ``key`` is None."""

    def __init__(self, key, d_model: int, d_ff: int, dtype, device="cpu"):
        super().__init__()
        k1, k2, k3 = prng.split(key, 3) if key is not None else (None,) * 3
        self.gate = dense_param(k1, d_model, d_ff, dtype, device)
        self.up = dense_param(k2, d_model, d_ff, dtype, device)
        self.down = dense_param(k3, d_ff, d_model, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(x, self.gate, self.up, self.down)


# ---------------------------------------------------------------------------
# RoPE (rotate-half, as the reference's ``jnp.split`` into halves)
# ---------------------------------------------------------------------------
def _freqs(half: int, theta: float, device) -> torch.Tensor:
    exponent = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exponent)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) → cos/sin (..., S, head_dim/2), float32."""
    ang = positions.float()[..., None] * _freqs(head_dim // 2, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions_3d: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple[int, int, int]):
    """Qwen2-VL's multimodal RoPE (arXiv:2409.12191): ``positions_3d`` (3, B,
    S) temporal/height/width ids; ``sections`` give the head_dim/2
    frequency bands to (t, h, w) in order and sum to head_dim // 2. Band j
    takes its angle from the axis that owns it. → cos/sin (B, S, half)."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    dev = positions_3d.device
    ang_per_axis = positions_3d.float()[..., None] * _freqs(half, theta, dev)  # (3,B,S,half)
    band = torch.cat([torch.full((s,), i, dtype=torch.int64, device=dev)
                      for i, s in enumerate(sections)])
    ang = ang_per_axis[band, :, :, torch.arange(half, device=dev)]             # (half,B,S)
    ang = ang.permute(1, 2, 0)
    return torch.cos(ang), torch.sin(ang)


def text_mrope_positions(batch: int, seq: int, start: int = 0, device="cpu") -> torch.Tensor:
    """For pure-text spans all three M-RoPE axes share the position id:
    (3, batch, seq) int32."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None] + start
    return pos.to(torch.int32).expand(batch, seq)[None].expand(3, batch, seq)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, D/2) or (S, D/2)."""
    dt = x.dtype
    x1, x2 = x.float().chunk(2, dim=-1)
    if cos.dim() == 2:      # (S, D/2)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                   # (B, S, D/2)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------------------
# Cross-entropy LM loss
# ---------------------------------------------------------------------------
def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy. logits (B, S, V) already aligned with
    labels (B, S) (the caller shifts). The reference's formulation: the
    log-sum-exp in float32 over the whole (padded) vocabulary, minus the
    picked logit, the mask's mean with ``max(sum, 1)``. The reference picks
    the logit as a one-hot sum so that GSPMD keeps a vocabulary-sharded
    axis sharded; the port gathers it, and on a mesh
    (:mod:`repro_torch.sharding.ctx`) computes both terms from each rank's
    vocabulary block (:func:`~repro_torch.sharding.ctx.vocab_parallel_ll`),
    the bits of this formula on one rank."""
    lg = logits.float()
    ll = shctx.vocab_parallel_ll(lg, labels) if shctx.enabled() else None
    if ll is None:
        ll = lg.gather(-1, labels[..., None].long())[..., 0] - torch.logsumexp(lg, dim=-1)
    if mask is None:
        return -ll.mean()
    m = mask.float()
    return -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)
