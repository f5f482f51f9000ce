"""Architecture assembly: the layer stack, the full-sequence forward of
training, and decode's caches and one-token step — the counterpart of
``repro.models.transformer``'s ``init_layer`` (mixers ``A``/``S``, FFN
``D``: :class:`Layer`), ``Ctx`` (:class:`ForwardCtx` for the forward,
:class:`Ctx` for decode), ``apply_layer_forward`` (:meth:`Layer.forward`),
``_make_ctx_forward`` (:func:`make_ctx_forward`, plain RoPE),
``run_stack_forward``, ``forward_logits`` (the dense branch),
``apply_layer_decode`` (:meth:`Layer.decode`), ``init_stack``
(:func:`layer_keys`), ``init_layer_cache`` and ``init_cache``
(:func:`init_cache`) and ``decode_step``; ``init_model`` is
:class:`repro_torch.models.Model`'s constructor.

The reference scans the cycle over stacked parameters (``lax.scan``);
the port runs the same layers as a Python loop over an ``nn.ModuleList``,
prefix first, then cycle by cycle, and draws each layer's weights from the
key the reference's scan slice gets (``split`` trees, ``jax.vmap`` over
the cycle keys: a vmapped draw equals the per-key draw). Where the
reference wraps the scan's body in ``jax.checkpoint`` (``cfg.remat``: each
cycle; ``cfg.remat_per_layer``: each layer inside it), the forward wraps
the same spans in ``torch.utils.checkpoint.checkpoint``; recomputing
changes no value. The reference's ``sharding.ctx.shard_batch`` is a no-op
without a mesh; the port runs on one device and has no counterpart.
Caches are a list of per-layer ``{"k", "v"}`` dicts in layer order,
updated in place; :func:`repro_torch.convert.to_jax_cache` gives the
reference's layout.

Ported: the dense GQA family (llama3-8b, qwen1.5-0.5b, smollm-360m,
h2o-danube-1.8b). Anything else raises ``NotImplementedError`` when the
model is built.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import GQA, decode_mask, init_gqa_cache
from repro_torch.models.layers import MLP, RMSNorm, rope_angles

_NOT_PORTED = "not ported yet (ROADMAP.md queue 1 item 12)"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port cannot build yet:
    layers other than a GQA mixer (``A``/``S``) with a dense FFN (``D``),
    encoder-decoder, frontends, M-RoPE."""
    if cfg.encoder_layers:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder {_NOT_PORTED}")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend {_NOT_PORTED}")
    if cfg.rope_kind != "rope":
        raise NotImplementedError(f"{cfg.name}: {cfg.rope_kind} {_NOT_PORTED}")
    for code in set(cfg.layer_codes()):
        mixer, ffn = cfg.parse_code(code)
        if mixer not in ("A", "S") or ffn != "D":
            raise NotImplementedError(f"{cfg.name}: layer code {code!r} {_NOT_PORTED}")


# ---------------------------------------------------------------------------
# Contexts threaded through the layers: the forward's and a decode step's
# ---------------------------------------------------------------------------
@dataclass
class ForwardCtx:
    rope_cos_sin: tuple             # rope_angles at the positions, (B, S, hd/2) each
    window: int | None = None       # effective SWA window


def make_ctx_forward(cfg: ModelConfig, B: int, S: int, positions=None,
                     device="cpu") -> ForwardCtx:
    """``_make_ctx_forward`` for plain RoPE: positions ``(B, S)`` (default
    ``arange(S)`` on every row) → their RoPE angles."""
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
    return ForwardCtx(rope_cos_sin=rope_angles(positions, cfg.resolved_head_dim,
                                               cfg.rope_theta),
                      window=cfg.attention_window)


@dataclass
class Ctx:
    pos: int                        # tokens so far (a Python int)
    rope_cos_sin: tuple             # rope_angles at pos, (B, 1, hd/2) each
    mask: torch.Tensor              # the step's decode_mask, shared by the layers
    window: int | None = None       # effective SWA window
    swa_kernel: bool = True         # full rings through K7


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
class Layer(nn.Module):
    """``init_layer`` for a GQA mixer (``A``/``S``) and a dense SwiGLU FFN
    (``D``): ``norm``, ``attn`` from ``split(key, 4)[0]``, ``norm2`` and
    ``ffn`` from ``split(key, 4)[1]``."""

    def __init__(self, key, cfg: ModelConfig, device="cpu"):
        super().__init__()
        keys = prng.split(key, 4) if key is not None else (None,) * 4
        dt = getattr(torch, cfg.dtype)
        d = cfg.d_model
        self.norm = RMSNorm(d, cfg.norm_eps, dt, device)
        self.attn = GQA(keys[0], d, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                        dt, qkv_bias=cfg.qkv_bias, device=device)
        self.norm2 = RMSNorm(d, cfg.norm_eps, dt, device)
        self.ffn = MLP(keys[1], d, cfg.d_ff, dt, device)

    def forward(self, x: torch.Tensor, ctx: ForwardCtx) -> torch.Tensor:
        """``apply_layer_forward``: x (B, S, d) → (B, S, d) (a dense layer's
        aux loss is the reference's 0.0, and is left out)."""
        x = x + self.attn(self.norm(x), ctx.rope_cos_sin, ctx.window)
        return x + self.ffn(self.norm2(x))

    def decode(self, cache: dict, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        """``apply_layer_decode``: x (B, 1, d) → (B, 1, d); the layer's
        cache is updated in place."""
        h = self.norm(x)
        y = self.attn.decode(cache, h, ctx.pos, rope_cos_sin=ctx.rope_cos_sin,
                             mask=ctx.mask, window=ctx.window, swa_kernel=ctx.swa_kernel)
        x = x + y
        return x + self.ffn(self.norm2(x))


def layer_keys(key, cfg: ModelConfig) -> list:
    """Each layer's key, in layer order, as ``init_stack`` derives them:
    ``kp, kc = split(key)``; prefix layer i gets ``split(kp, max(P, 1))[i]``;
    cycle c's keys are ``split(split(kc, n_cycles)[c], len(cycle_codes))``."""
    kp, kc = prng.split(key)
    prefix = list(prng.split(kp, max(len(cfg.prefix_codes), 1))[:len(cfg.prefix_codes)])
    cycle = []
    n_cycles = cfg.resolved_num_cycles
    if n_cycles:
        for kcyc in prng.split(kc, n_cycles):
            cycle += list(prng.split(kcyc, len(cfg.cycle_codes)))
    return prefix + cycle


def run_stack_forward(model, x: torch.Tensor, ctx: ForwardCtx) -> torch.Tensor:
    """The prefix layers, then each cycle: with ``cfg.remat`` a cycle is
    recomputed in the backward pass (the reference's ``jax.checkpoint`` of
    the scan's body), with ``cfg.remat_per_layer`` each layer inside it too
    (the two nest, as the reference's do)."""
    cfg = model.cfg
    P, n = len(cfg.prefix_codes), len(cfg.cycle_codes)
    for layer in model.layers[:P]:
        x = layer(x, ctx)

    def one_layer(layer, xx):
        if cfg.remat_per_layer:
            return checkpoint(layer, xx, ctx, use_reentrant=False)
        return layer(xx, ctx)

    def body(xx, cycle):
        for layer in cycle:
            xx = one_layer(layer, xx)
        return xx

    for c in range(cfg.resolved_num_cycles):
        cycle = model.layers[P + c * n:P + (c + 1) * n]
        x = checkpoint(body, x, cycle, use_reentrant=False) if cfg.remat else body(x, cycle)
    return x


def forward_logits(model, batch: dict):
    """Full-sequence forward of ``model`` (a :class:`repro_torch.models.Model`)
    on ``{"tokens" (B, S) int[, "positions" (B, S)]}``. Returns (logits
    (B, S, Vp) over the padded vocabulary, the aux loss (0.0 for a dense
    model), the loss mask (B, S) of ones)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = torch.nn.functional.embedding(tokens, model.embed)
    mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    ctx = make_ctx_forward(model.cfg, B, S, batch.get("positions"), x.device)
    x = run_stack_forward(model, x, ctx)
    x = model.final_norm(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x @ model.head, aux, mask


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> list:
    """One ``{"k", "v"}`` cache per layer, in layer order, on ``device`` (the
    GPU unless ``device="cpu"``); window layers hold at most the window."""
    device = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    if cfg.attention_window is not None:
        cache_len = min(cache_len, cfg.attention_window)
    return [init_gqa_cache(batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim, dt,
                           device) for _ in cfg.layer_codes()]


def decode_step(model, cache: list, token: torch.Tensor, pos: int, *,
                swa_kernel: bool = True):
    """``model`` (a :class:`repro_torch.models.Model`) on token (B, 1) int
    at ``pos``, a Python int. Returns (logits (B, 1, Vp), cache), the cache
    updated in place."""
    cfg = model.cfg
    B = token.shape[0]
    x = torch.nn.functional.embedding(token, model.embed)
    p1 = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    ctx = Ctx(pos=pos, rope_cos_sin=rope_angles(p1, cfg.resolved_head_dim, cfg.rope_theta),
              mask=decode_mask(cache[0]["k"].shape[1], pos, cfg.attention_window, x.device),
              window=cfg.attention_window, swa_kernel=swa_kernel)
    for layer, c in zip(model.layers, cache):
        x = layer.decode(c, x, ctx)
    x = model.final_norm(x)
    return x @ model.head, cache
