"""Architecture assembly: the layer stack, the full-sequence forward of
training, and decode's caches and one-token step — the counterpart of
``repro.models.transformer``'s ``init_layer`` (every mixer ``A S L M m s
C`` and FFN ``D E`` or none: :class:`Layer`), ``Ctx`` (:class:`ForwardCtx`
for the forward, :class:`Ctx` for decode), ``apply_layer_forward``
(:meth:`Layer.forward`), ``_make_ctx_forward`` (:func:`make_ctx_forward`,
RoPE or M-RoPE), ``run_stack_forward``, ``forward_logits`` (decoder-only,
vision and encoder-decoder branches), ``apply_layer_decode``
(:meth:`Layer.decode`), ``init_stack`` (:func:`layer_keys`),
``init_layer_cache``, ``init_cache``, ``decode_step`` and
``prefill_encoder``; ``init_model`` is :class:`repro_torch.models.Model`'s
constructor, its encoder :class:`Encoder`.

The reference scans the cycle over stacked parameters (``lax.scan``);
the port runs the same layers as a Python loop over an ``nn.ModuleList``,
prefix first, then cycle by cycle (:func:`repro_torch.models.loops.trips`,
which the dry run counts), and draws each layer's weights from the
key the reference's scan slice gets (``split`` trees, ``jax.vmap`` over
the cycle keys: a vmapped draw equals the per-key draw). Where the
reference wraps the scan's body in ``jax.checkpoint`` (``cfg.remat``: each
cycle; ``cfg.remat_per_layer``: each layer inside it), the forward wraps
the same spans in ``torch.utils.checkpoint.checkpoint``; recomputing
changes no value. The reference's ``sharding.ctx.shard_batch`` hooks sit
at the same places, and each layer (the embedding and the head too) runs
with its weights gathered over ``data`` (:func:`repro_torch.sharding.ctx
.gathered_params`: the FSDP all-gather GSPMD inserts for the reference);
both are the identity unless a mesh context is enabled and the tensors are
DTensors.
Caches are a list of per-layer dicts in layer order (``{"k", "v"}``, with
``"cross_k"``/``"cross_v"`` for ``C``; ``{"c_kv", "k_rope"}``; ``{"conv",
"h"}``; ``{"C", "n", "m"}``; ``{"h", "c", "n", "m"}``), updated in place;
:func:`repro_torch.convert.to_jax_cache` gives the reference's layout.

Parity notes, mirrored rather than fixed: the reference's encoder calls
``gqa_forward`` with its default ``causal=True``, so its "bidirectional"
encoder masks causally, and so does the port's; the encoder-decoder
forward runs the decoder's cycle only (the prefix, empty for every
config, is skipped), as the reference's does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import loops
from repro_torch.models.attention import GQA, MLA, decode_mask, init_gqa_cache, init_mla_cache
from repro_torch.models.layers import MLP, RMSNorm, mrope_angles, rope_angles
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import (
    MLSTM, SLSTM, Mamba, init_mamba_cache, init_mlstm_state, init_slstm_state,
)
from repro_torch.sharding import ctx as shctx


# ---------------------------------------------------------------------------
# Contexts threaded through the layers: the forward's and a decode step's
# ---------------------------------------------------------------------------
@dataclass
class ForwardCtx:
    cfg: ModelConfig
    positions: torch.Tensor         # (B, S) (with M-RoPE its temporal axis): MLA's RoPE
    rope_cos_sin: tuple             # (B, S, hd/2) each: GQA's RoPE or M-RoPE
    window: int | None = None       # effective SWA window
    enc_out: torch.Tensor | None = None   # the encoder's output: C layers' cross K/V
    routes: list | None = None      # MoE routes, when recorded


def make_ctx_forward(cfg: ModelConfig, B: int, S: int, positions=None, device="cpu",
                     routes: list | None = None) -> ForwardCtx:
    """``_make_ctx_forward``: positions ``(B, S)`` (default ``arange(S)`` on
    every row), or ``(3, B, S)`` for M-RoPE (a ``(B, S)`` given to an
    M-RoPE model is broadcast to its three axes) → their angles."""
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
    if cfg.rope_kind == "mrope":
        if positions.dim() == 2:
            positions = positions[None].expand(3, B, S)
        rope = mrope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta,
                            cfg.mrope_sections)
        pos2d = positions[0]
    else:
        rope = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
        pos2d = positions
    return ForwardCtx(cfg=cfg, positions=pos2d, rope_cos_sin=rope,
                      window=cfg.attention_window, routes=routes)


@dataclass
class Ctx:
    cfg: ModelConfig
    pos: int                        # tokens so far (a Python int)
    rope_cos_sin: tuple             # the step's RoPE (or M-RoPE) angles, (B, 1, hd/2) each
    window: int | None = None       # effective SWA window
    swa_kernel: bool = True         # full rings through K7
    routes: list | None = None      # MoE routes, when recorded
    masks: dict = field(default_factory=dict)

    def mask(self, cache_len: int, device) -> torch.Tensor:
        """The step's :func:`decode_mask` for a cache of ``cache_len`` slots,
        made once a step for each length."""
        if cache_len not in self.masks:
            self.masks[cache_len] = decode_mask(cache_len, self.pos, self.window, device)
        return self.masks[cache_len]


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
class Layer(nn.Module):
    """``init_layer`` for one layer code: ``norm``; the mixer from ``split(key,
    4)[0]`` — ``attn`` (GQA for ``A``/``S``/``C``, MLA for ``L``) or
    ``mixer`` (Mamba ``M``, mLSTM ``m``, sLSTM ``s``); for ``C`` also
    ``norm_x`` and ``cross`` (a GQA) from ``[2]``; the FFN from ``[1]`` —
    ``norm2`` and ``ffn`` (SwiGLU ``D`` or MoE ``E``), or none."""

    def __init__(self, key, code: str, cfg: ModelConfig, device="cpu"):
        super().__init__()
        mixer, ffn = cfg.parse_code(code)
        self.code, self.mixer_kind, self.ffn_kind = code, mixer, ffn
        keys = prng.split(key, 4) if key is not None else (None,) * 4
        dt = getattr(torch, cfg.dtype)
        d = cfg.d_model
        self.norm = RMSNorm(d, cfg.norm_eps, dt, device)
        if mixer in ("A", "S", "C"):
            gqa = dict(d_model=d, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
                       head_dim=cfg.resolved_head_dim, dtype=dt, qkv_bias=cfg.qkv_bias,
                       device=device)
            self.attn = GQA(keys[0], **gqa)
            if mixer == "C":
                self.norm_x = RMSNorm(d, cfg.norm_eps, dt, device)
                self.cross = GQA(keys[2], **gqa)
        elif mixer == "L":
            self.attn = MLA(keys[0], d, cfg.num_heads, kv_lora_rank=cfg.mla.kv_lora_rank,
                            head_dim=cfg.resolved_head_dim,
                            rope_head_dim=cfg.mla.rope_head_dim, dtype=dt,
                            rope_theta=cfg.rope_theta, device=device)
        elif mixer == "M":
            self.mixer = Mamba(keys[0], d, d_inner=cfg.ssm.expand * d, d_state=cfg.ssm.d_state,
                               d_conv=cfg.ssm.d_conv, dt_rank=cfg.ssm.dt_rank, dtype=dt,
                               device=device)
        elif mixer == "m":
            self.mixer = MLSTM(keys[0], d, cfg.num_heads, expand=cfg.ssm.mlstm_expand,
                               dtype=dt, device=device)
        else:   # "s" (parse_code admits no other)
            self.mixer = SLSTM(keys[0], d, cfg.num_heads, dt, device)
        if ffn == "D":
            self.norm2 = RMSNorm(d, cfg.norm_eps, dt, device)
            self.ffn = MLP(keys[1], d, cfg.d_ff, dt, device)
        elif ffn == "E":
            m = cfg.moe
            self.norm2 = RMSNorm(d, cfg.norm_eps, dt, device)
            self.ffn = MoE(keys[1], d, m.d_ff_expert, m.num_experts, m.top_k, dt,
                           num_shared=m.num_shared, d_ff_shared=m.d_ff_shared, device=device)

    def _ffn(self, x, cfg, routes):
        if self.ffn_kind == "D":
            return x + self.ffn(self.norm2(x)), None
        if self.ffn_kind == "E":
            y, aux = self.ffn(self.norm2(x), capacity_factor=cfg.moe.capacity_factor,
                              groups=cfg.moe.groups, routes=routes)
            return x + y, aux
        return x, None

    def forward(self, x: torch.Tensor, ctx: ForwardCtx):
        """``apply_layer_forward``: x (B, S, d) → (x, the layer's aux loss or
        None where the reference's is its constant 0.0)."""
        cfg, mixer = ctx.cfg, self.mixer_kind
        h = self.norm(x)
        if mixer in ("A", "S", "C"):
            y = self.attn(h, ctx.rope_cos_sin, ctx.window)
        elif mixer == "L":
            y = self.attn(h, ctx.positions, ctx.window)
        elif mixer == "M":
            y = self.mixer(h)
        elif mixer == "m":
            y = self.mixer(h, chunk=cfg.ssm.mlstm_chunk)
        else:
            y = self.mixer(h, segment=cfg.ssm.slstm_segment)
        x = x + y
        if mixer == "C":
            kv = self.cross.encode_kv(ctx.enc_out)
            x = x + self.cross.cross(self.norm_x(x), kv["k"], kv["v"])
        return self._ffn(x, cfg, ctx.routes)

    def decode(self, cache: dict, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        """``apply_layer_decode``: x (B, 1, d) → (B, 1, d); the layer's cache
        is updated in place."""
        mixer = self.mixer_kind
        h = self.norm(x)
        if mixer in ("A", "S", "C"):
            y = self.attn.decode(cache, h, ctx.pos, rope_cos_sin=ctx.rope_cos_sin,
                                 mask=ctx.mask(cache["k"].shape[1], x.device),
                                 window=ctx.window, swa_kernel=ctx.swa_kernel)
        elif mixer == "L":
            y = self.attn.decode(cache, h, ctx.pos,
                                 mask=ctx.mask(cache["c_kv"].shape[1], x.device),
                                 window=ctx.window, absorb=True)
        else:
            y = self.mixer.decode(cache, h)
        x = x + y
        if mixer == "C":
            x = x + self.cross.cross(self.norm_x(x), cache["cross_k"], cache["cross_v"])
        return self._ffn(x, ctx.cfg, ctx.routes)[0]


def layer_keys(key, prefix_codes, cycle_codes, n_cycles: int) -> list:
    """Each layer's key, in layer order, as ``init_stack`` derives them:
    ``kp, kc = split(key)``; prefix layer i gets ``split(kp, max(P, 1))[i]``;
    cycle c's keys are ``split(split(kc, n_cycles)[c], len(cycle_codes))``."""
    kp, kc = prng.split(key)
    prefix = list(prng.split(kp, max(len(prefix_codes), 1))[:len(prefix_codes)])
    cycle = []
    if n_cycles:
        for kcyc in prng.split(kc, n_cycles):
            cycle += list(prng.split(kcyc, len(cycle_codes)))
    return prefix + cycle


def build_layers(key, cfg: ModelConfig, prefix_codes, cycle_codes, n_cycles: int,
                 device) -> nn.ModuleList:
    codes = list(prefix_codes) + list(cycle_codes) * n_cycles
    keys = (layer_keys(key, prefix_codes, cycle_codes, n_cycles) if key is not None
            else (None,) * len(codes))
    return nn.ModuleList(Layer(k, c, cfg, device) for k, c in zip(keys, codes))


class Encoder(nn.Module):
    """``init_model``'s ``params["enc"]``: an ``A-D`` stack of
    ``cfg.encoder_layers`` cycles drawn from ``key`` (``split(key, 6)[3]``
    of the model's key) and its own ``final_norm``."""

    def __init__(self, key, cfg: ModelConfig, device="cpu"):
        super().__init__()
        self.layers = build_layers(key, cfg, (), ("A-D",), cfg.encoder_layers, device)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, getattr(torch, cfg.dtype),
                                  device)


def _add_aux(total, a):
    return total if a is None else total + a


def _layer_then_shard(layer, x, ctx):
    with shctx.gathered_params(layer):
        x, a = layer(x, ctx)
    return shctx.shard_batch(x), a


def run_stack_forward(layers, cfg: ModelConfig, x: torch.Tensor, ctx: ForwardCtx,
                      n_prefix: int, n_cycle: int, n_cycles: int):
    """The prefix layers, then each cycle: with ``cfg.remat`` a cycle is
    recomputed in the backward pass (the reference's ``jax.checkpoint`` of
    the scan's body), with ``cfg.remat_per_layer`` each layer inside it too
    (the two nest, as the reference's do). Returns (x, the summed aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = shctx.shard_batch(x)
    for layer in layers[:n_prefix]:
        x, a = _layer_then_shard(layer, x, ctx)
        aux = _add_aux(aux, a)

    def one_layer(layer, xx):
        if cfg.remat_per_layer:
            return checkpoint(_layer_then_shard, layer, xx, ctx, use_reentrant=False)
        return _layer_then_shard(layer, xx, ctx)

    def body(xx, au, cycle):
        for layer in cycle:
            xx, a = one_layer(layer, xx)
            au = _add_aux(au, a)
        return xx, au

    def cycle_of(c):
        return layers[n_prefix + c * n_cycle:n_prefix + (c + 1) * n_cycle]

    def trip(carry, c):
        xx, au = carry
        return (checkpoint(body, xx, au, cycle_of(c), use_reentrant=False) if cfg.remat
                else body(xx, au, cycle_of(c))), None

    box = [(x, aux)]
    del x, aux
    (x, aux), _ = loops.trips(trip, box, n_cycles,
                              params=lambda c: list(cycle_of(c).parameters()))
    return x, aux


def encode(model, frames: torch.Tensor) -> torch.Tensor:
    """The encoder on ``frames`` (B, Se, d) → its normed output (B, Se, d):
    plain RoPE at positions 0..Se−1, no window, causal (the reference's)."""
    cfg = model.cfg
    B, Se, _ = frames.shape
    ctx = make_ctx_forward(cfg, B, Se, device=frames.device)
    ctx.window = None
    x, _ = run_stack_forward(model.enc.layers, cfg, frames, ctx, 0, 1, cfg.encoder_layers)
    return model.enc.final_norm(x)


def forward_logits(model, batch: dict, routes: list | None = None):
    """Full-sequence forward of ``model`` (a :class:`repro_torch.models.Model`)
    on ``{"tokens" (B, S)[, "positions"]}``, ``{"tokens", "patch_embeds"
    (B, P, d)}`` (vision: the patches before the tokens) or ``{"frames" (B,
    Se, d), "tokens"}`` (encoder-decoder). Returns (logits (B, S, Vp) over
    the padded vocabulary, the aux loss summed over the layers, the loss
    mask (B, S): zeros over the patches, else ones). ``routes``: a list
    that gets every MoE layer's routes."""
    cfg = model.cfg
    tokens = batch["tokens"]
    B, S = tokens.shape
    with shctx.gathered_params(model, recurse=False):
        x = torch.nn.functional.embedding(tokens, model.embed)
    dev = x.device
    mask = torch.ones((B, S), dtype=torch.float32, device=dev)
    if cfg.encoder_layers:
        ctx = make_ctx_forward(cfg, B, S, device=dev, routes=routes)
        ctx.enc_out = encode(model, batch["frames"])
        # the cycle only, as the reference's enc-dec branch runs it
        x, aux = run_stack_forward(model.layers[len(cfg.prefix_codes):], cfg, x, ctx, 0,
                                   len(cfg.cycle_codes), cfg.resolved_num_cycles)
    else:
        pe = batch.get("patch_embeds")
        if cfg.frontend == "vision" and pe is not None:
            x = torch.cat([pe.to(x.dtype), x], dim=1)
            mask = torch.cat([torch.zeros((B, pe.shape[1]), dtype=torch.float32, device=dev),
                              mask], dim=1)
        ctx = make_ctx_forward(cfg, B, x.shape[1], batch.get("positions"), dev, routes)
        x, aux = run_stack_forward(model.layers, cfg, x, ctx, len(cfg.prefix_codes),
                                   len(cfg.cycle_codes), cfg.resolved_num_cycles)
    x = model.final_norm(x)
    with shctx.gathered_params(model, recurse=False):
        logits = x @ model.head
    return shctx.shard_batch(logits, model_dim=-1), aux, mask


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_layer_cache(code: str, cfg: ModelConfig, batch: int, cache_len: int, dtype,
                     enc_len: int | None = None, device="cpu") -> dict:
    """``init_layer_cache``: one layer's zero cache."""
    mixer, _ = cfg.parse_code(code)
    d = cfg.d_model
    if mixer in ("A", "S", "C"):
        c = init_gqa_cache(batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim, dtype,
                           device)
        if mixer == "C":
            c["cross_k"] = torch.zeros((batch, enc_len, cfg.num_kv_heads,
                                        cfg.resolved_head_dim), dtype=dtype, device=device)
            c["cross_v"] = torch.zeros_like(c["cross_k"])
        return c
    if mixer == "L":
        return init_mla_cache(batch, cache_len, cfg.mla.kv_lora_rank, cfg.mla.rope_head_dim,
                              dtype, device)
    if mixer == "M":
        return init_mamba_cache(batch, cfg.ssm.expand * d, cfg.ssm.d_state, cfg.ssm.d_conv,
                                dtype, device)
    if mixer == "m":
        di = cfg.ssm.mlstm_expand * d
        return init_mlstm_state(batch, cfg.num_heads, di // cfg.num_heads, device)
    return init_slstm_state(batch, cfg.num_heads, d // cfg.num_heads, device)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, enc_len: int | None = None,
               device=None) -> list:
    """One cache per layer, in layer order, on ``device`` (the GPU unless
    ``device="cpu"``); attention layers (``A S C L``) of a windowed model
    hold at most the window; ``C`` layers also hold ``enc_len`` cross
    K/V slots."""
    device = resolve_device(device)
    dt = getattr(torch, cfg.dtype)

    def cl(code):
        mixer, _ = cfg.parse_code(code)
        if mixer in ("A", "S", "C", "L") and cfg.attention_window is not None:
            return min(cache_len, cfg.attention_window)
        return cache_len

    return [init_layer_cache(c, cfg, batch, cl(c), dt, enc_len, device)
            for c in cfg.layer_codes()]


def decode_step(model, cache: list, token: torch.Tensor, pos: int, *,
                swa_kernel: bool = True, routes: list | None = None):
    """``model`` (a :class:`repro_torch.models.Model`) on token (B, 1) int
    at ``pos``, a Python int. Returns (logits (B, 1, Vp), cache), the cache
    updated in place. M-RoPE models take the text position on all three
    axes."""
    cfg = model.cfg
    B = token.shape[0]
    with shctx.gathered_params(model, recurse=False):
        x = shctx.shard_batch(torch.nn.functional.embedding(token, model.embed))
    p1 = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.rope_kind == "mrope":
        rope = mrope_angles(p1[None].expand(3, B, 1), cfg.resolved_head_dim, cfg.rope_theta,
                            cfg.mrope_sections)
    else:
        rope = rope_angles(p1, cfg.resolved_head_dim, cfg.rope_theta)
    ctx = Ctx(cfg=cfg, pos=pos, rope_cos_sin=rope, window=cfg.attention_window,
              swa_kernel=swa_kernel, routes=routes)
    n_prefix = len(cfg.prefix_codes)
    for i, (layer, c) in enumerate(zip(model.layers, cache)):
        with shctx.gathered_params(layer):
            x = layer.decode(c, x, ctx)
        if i >= n_prefix:       # the reference pins the scanned cycle's layers
            x = shctx.shard_batch(x)
    x = model.final_norm(x)
    with shctx.gathered_params(model, recurse=False):
        return x @ model.head, cache


def prefill_encoder(model, frames: torch.Tensor, cache: list) -> list:
    """Run the encoder on ``frames`` (B, Se, d) and put each decoder ``C``
    layer's cross K/V of its output into that layer's cache (the cycle's
    layers, as the reference fills them). Returns the cache."""
    enc_out = encode(model, frames)
    for layer, c in zip(model.layers[len(model.cfg.prefix_codes):],
                        cache[len(model.cfg.prefix_codes):]):
        if layer.mixer_kind == "C":
            with shctx.gathered_params(layer.cross):
                kv = layer.cross.encode_kv(enc_out)
            c["cross_k"], c["cross_v"] = kv["k"], kv["v"]
    return cache
