"""GQA attention (optionally sliding-window): the full-sequence forward of
training and one-token decode — the counterpart of
``repro.models.attention``'s ``init_gqa``, ``_project_qkv``, ``_sdpa``,
``causal_mask``, ``gqa_forward``, ``init_gqa_cache`` and ``gqa_decode``.

The forward (:meth:`GQA.forward`) is the reference's: projections, RoPE,
the additive ``causal_mask`` and ``_sdpa``'s float32 scores, all outside
any Pallas kernel there, as torch ops here.

Caches, as the reference's:

* full attention — k/v ``(B, S_max, Hkv, hd)``, the token at ``pos`` in
  slot ``pos``;
* sliding window — a ring ``(B, W, Hkv, hd)``, the token at ``pos`` in
  slot ``pos % W``.

* MLA (DeepSeek-V2) — the compressed cache ``c_kv (B, S, r_kv)`` and
  the decoupled rope key ``k_rope (B, S, hd_rope)``.

Once a window layer's ring is full (``pos >= W − 1``: from there the
reference's mask ``(idx <= slot) | (pos >= W)`` marks every slot valid),
its attention is exactly K7's function, and :meth:`GQA.decode` computes
it with K7 (:func:`repro_torch.kernels.swa_decode.swa_decode`). Every
other step takes the plain masked ``_sdpa``, which the reference computes
outside any Pallas kernel too.

Also here: cross-attention (``cross_forward``, ``encode_kv``:
:meth:`GQA.cross`, :meth:`GQA.encode_kv`) and MLA (``init_mla``,
``_mla_qk``, ``mla_attend``, ``mla_forward``, ``init_mla_cache``,
``mla_decode``: :class:`MLA`), both torch ops, as the reference's are
outside any kernel. MLA's forward expands K/V (``absorb=False``); its
decode attends over the compressed cache with W_UK/W_UV absorbed.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch import prng
from repro_torch.kernels.swa_decode import swa_decode
from repro_torch.models.layers import apply_rope, dense_param, frozen, rope_angles
from repro_torch.sharding import ctx as shctx

NEG_INF = -1e30
#: K7's window chunk on the decode path: the TPU kernel's default, or the
#: largest divisor of a shorter ring below it.
RING_CHUNK = 512


def ring_chunk(W: int) -> int:
    """The largest divisor of the ring length ``W`` that is at most
    :data:`RING_CHUNK` (K7 needs ``W % chunk == 0``)."""
    return next(c for c in range(min(W, RING_CHUNK), 0, -1) if W % c == 0)


def _sdpa(q, k, v, mask):
    """q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D), GQA by head grouping (query head h
    reads KV head h // (Hq // Hkv)). mask (Sq,Sk) or (B,1,Sq,Sk) additive,
    or None."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    q, k, v = shctx.shard_attention(q, k, v)
    qf = q.reshape(B, Sq, Hkv, rep, D).float()
    # scores (b, h, q, r, k): a query position ahead of its group, so that
    # the batched matmul's merged (q, r) dim keeps a sharded q in blocks
    s = torch.einsum("bqhrd,bkhd->bhqrk", qf, k.float())
    s = s / math.sqrt(D)
    if mask is not None:
        mask = mask[None, None, :, None] if mask.dim() == 2 else mask[:, :, :, None]
        s = s + mask
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqrk,bkhd->bqhrd", p, v.float())
    o = shctx.shard_like(o.reshape(B, Sq, Hq, D), q)
    return shctx.shard_heads(o).to(q.dtype)


def causal_mask(Sq: int, Sk: int, window: int | None = None, offset: int = 0,
                device="cpu") -> torch.Tensor:
    """Additive (Sq, Sk) float32 mask; query i attends keys j with
    j <= i+offset and (window is None or j > i+offset-window)."""
    qi = torch.arange(Sq, device=device)[:, None] + offset
    kj = torch.arange(Sk, device=device)[None, :]
    ok = kj <= qi
    if window is not None:
        ok &= kj > qi - window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def decode_mask(cache_len: int, pos: int, window: int | None, device) -> torch.Tensor:
    """The reference's additive ``(1, cache_len)`` decode mask at ``pos``."""
    idx = torch.arange(cache_len, device=device)
    if window is not None:
        valid = idx <= pos % cache_len
        if pos >= cache_len:
            valid = torch.ones_like(valid)
    else:
        valid = idx <= pos
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32)[None, :]


def init_gqa_cache(batch, cache_len, n_kv, head_dim, dtype, device="cpu") -> dict:
    return {"k": torch.zeros((batch, cache_len, n_kv, head_dim), dtype=dtype, device=device),
            "v": torch.zeros((batch, cache_len, n_kv, head_dim), dtype=dtype, device=device)}


class GQA(nn.Module):
    """``init_gqa``'s parameters — ``wq`` ``(d, H·hd)``, ``wk``, ``wv``
    ``(d, Hkv·hd)``, ``wo`` ``(H·hd, d)``, zero biases with ``qkv_bias`` —
    drawn from ``key`` as the reference draws them (``split(key, 4)``), or
    left uninitialised for a converter to fill when ``key`` is None."""

    def __init__(self, key, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 dtype, qkv_bias: bool = False, device="cpu"):
        super().__init__()
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        shapes = ((d_model, n_heads * head_dim), (d_model, n_kv * head_dim),
                  (d_model, n_kv * head_dim), (n_heads * head_dim, d_model))
        ks = prng.split(key, 4) if key is not None else (None,) * 4
        for name, k, (fan_in, fan_out) in zip(("wq", "wk", "wv", "wo"), ks, shapes):
            setattr(self, name, dense_param(k, fan_in, fan_out, dtype, device))
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            b = (frozen(torch.zeros((width * head_dim,), dtype=dtype, device=device))
                 if qkv_bias else None)
            self.register_parameter(name, b)

    def project_qkv(self, x):
        B, S, _ = x.shape
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if self.bq is not None:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = shctx.shard_head_proj(q, self.n_heads, over_positions=True)
        k, v = shctx.shard_head_proj(k, self.n_kv), shctx.shard_head_proj(v, self.n_kv)
        return (q.reshape(B, S, self.n_heads, self.head_dim),
                k.reshape(B, S, self.n_kv, self.head_dim),
                v.reshape(B, S, self.n_kv, self.head_dim))

    def forward(self, x: torch.Tensor, rope_cos_sin, window: int | None = None) -> torch.Tensor:
        """``gqa_forward`` (causal): x (B, S, d) → (B, S, d). ``rope_cos_sin``
        is ``rope_angles`` at the tokens' positions (the reference derives
        it from ``positions`` and ``rope_theta`` when it is not given; the
        port's context always gives it), ``window`` the SWA window."""
        B, S, _ = x.shape
        q, k, v = self.project_qkv(x)
        cos, sin = rope_cos_sin
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        o = _sdpa(q, k, v, causal_mask(S, S, window, device=x.device))
        o = shctx.shard_o_proj(o.reshape(B, S, self.n_heads * self.head_dim), self.n_heads)
        return o @ self.wo

    def decode(self, cache: dict, x: torch.Tensor, pos: int, *, rope_cos_sin, mask,
               window: int | None = None, swa_kernel: bool = True) -> torch.Tensor:
        """One-token decode: x (B, 1, d), ``pos`` a Python int (tokens so
        far), ``rope_cos_sin`` the step's ``rope_angles`` and ``mask`` its
        :func:`decode_mask`. Returns (B, 1, d).

        Full attention: ``cache_len == S_max``, slot ``pos``. Sliding
        window: ``cache_len == window`` (or less), slot ``pos % cache_len``
        (ring). Unlike the reference, which returns new cache arrays, the
        token's k and v are written **in place** into ``cache``.

        With ``window`` set and the ring full (``pos >= cache_len − 1``),
        the attention runs K7 (``swa_kernel=False`` takes the plain masked
        ``_sdpa`` instead: the path a run holds K7's against).
        """
        B = x.shape[0]
        cache_len = cache["k"].shape[1]
        q, k, v = self.project_qkv(x)
        cos, sin = rope_cos_sin
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        slot = pos % cache_len if window is not None else pos
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        if window is not None and swa_kernel and pos >= cache_len - 1:
            o = swa_decode(q[:, 0].contiguous(), cache["k"], cache["v"],
                           chunk=ring_chunk(cache_len))[:, None]
        else:
            o = _sdpa(q, cache["k"], cache["v"], mask)
        return o.reshape(B, 1, self.n_heads * self.head_dim) @ self.wo

    # ------------------------------------------------------------ cross-attention
    def encode_kv(self, enc_out: torch.Tensor) -> dict:
        """``encode_kv``: the encoder output (B, Se, d) → its cross K/V
        ``{"k", "v"}`` (B, Se, Hkv, hd) through this layer's ``wk``/``wv``."""
        B, Se, _ = enc_out.shape
        k, v = enc_out @ self.wk, enc_out @ self.wv
        if self.bk is not None:
            k, v = k + self.bk, v + self.bv
        return {"k": k.reshape(B, Se, self.n_kv, self.head_dim),
                "v": v.reshape(B, Se, self.n_kv, self.head_dim)}

    def cross(self, x: torch.Tensor, enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
        """``cross_forward``: x (B, Sq, d) attends the encoder's K/V with no
        mask and no RoPE."""
        B, Sq, _ = x.shape
        q = x @ self.wq
        if self.bq is not None:
            q = q + self.bq
        o = _sdpa(q.reshape(B, Sq, self.n_heads, self.head_dim), enc_k, enc_v, None)
        return o.reshape(B, Sq, self.n_heads * self.head_dim) @ self.wo


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434)
# ---------------------------------------------------------------------------
def init_mla_cache(batch, cache_len, kv_lora_rank, rope_head_dim, dtype, device="cpu") -> dict:
    return {"c_kv": torch.zeros((batch, cache_len, kv_lora_rank), dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, cache_len, rope_head_dim), dtype=dtype,
                                  device=device)}


class MLA(nn.Module):
    """``init_mla``'s parameters from ``split(key, 7)``: ``wq_nope`` ``(d,
    H·hd)``, ``wq_rope`` ``(d, H·hr)``, ``w_dkv`` ``(d, r)``, ``w_uk`` and
    ``w_uv`` ``(r, H·hd)``, ``w_krope`` ``(d, hr)``, ``wo`` ``(H·hd, d)``
    (V2-Lite: no query compression). ``key`` None leaves them
    uninitialised."""

    def __init__(self, key, d_model: int, n_heads: int, *, kv_lora_rank: int, head_dim: int,
                 rope_head_dim: int, dtype, rope_theta: float = 1e4, device="cpu"):
        super().__init__()
        self.n_heads, self.head_dim, self.rope_head_dim = n_heads, head_dim, rope_head_dim
        self.rope_theta = rope_theta
        H, hd, hr, r = n_heads, head_dim, rope_head_dim, kv_lora_rank
        shapes = (("wq_nope", d_model, H * hd), ("wq_rope", d_model, H * hr),
                  ("w_dkv", d_model, r), ("w_uk", r, H * hd), ("w_uv", r, H * hd),
                  ("w_krope", d_model, hr), ("wo", H * hd, d_model))
        ks = prng.split(key, 7) if key is not None else (None,) * 7
        for (name, fan_in, fan_out), k in zip(shapes, ks):
            setattr(self, name, dense_param(k, fan_in, fan_out, dtype, device))

    def qk(self, x: torch.Tensor, positions: torch.Tensor):
        """``_mla_qk``: the queries' no-rope and rope parts, the compressed
        ``c_kv`` and the shared rope key, RoPE from ``positions`` (B, S)."""
        B, S, _ = x.shape
        H, hd, hr = self.n_heads, self.head_dim, self.rope_head_dim
        q_nope = (x @ self.wq_nope).reshape(B, S, H, hd)
        q_rope = (x @ self.wq_rope).reshape(B, S, H, hr)
        cos, sin = rope_angles(positions, hr, self.rope_theta)
        q_rope = apply_rope(q_rope, cos, sin)
        c_kv = x @ self.w_dkv
        k_rope = apply_rope((x @ self.w_krope).reshape(B, S, 1, hr), cos, sin)[:, :, 0]
        return q_nope, q_rope, c_kv, k_rope

    def attend(self, q_nope, q_rope, c_kv, k_rope, mask, absorb: bool) -> torch.Tensor:
        """``mla_attend``: scores and the combine either through expanded
        K/V (naive) or with W_UK/W_UV absorbed into the query and output
        (over the compressed cache). Scale 1/sqrt(hd + hr)."""
        B, Sq = q_nope.shape[:2]
        H, hd = self.n_heads, self.head_dim
        scale = 1.0 / torch.sqrt(torch.tensor(hd + q_rope.shape[-1], dtype=torch.float32,
                                              device=q_nope.device))
        w_uk = self.w_uk.reshape(-1, H, hd).float()
        w_uv = self.w_uv.reshape(-1, H, hd).float()
        ckv = c_kv.float()
        if absorb:
            q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_uk)
            s = torch.einsum("bqhr,bkr->bhqk", q_lat, ckv)
        else:
            k_nope = torch.einsum("bkr,rhd->bkhd", ckv, w_uk)
            s = torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope)
        s = s + torch.einsum("bqhr,bkr->bhqk", q_rope.float(), k_rope.float())
        s = s * scale
        if mask is not None:
            s = s + (mask[None, None] if mask.dim() == 2 else mask)
        p = torch.softmax(s, dim=-1)
        if absorb:
            o_lat = torch.einsum("bhqk,bkr->bqhr", p, ckv)
            o = torch.einsum("bqhr,rhd->bqhd", o_lat, w_uv)
        else:
            v = torch.einsum("bkr,rhd->bkhd", ckv, w_uv)
            o = torch.einsum("bhqk,bkhd->bqhd", p, v)
        return o.reshape(B, Sq, H * hd).to(q_nope.dtype) @ self.wo

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int | None = None,
                absorb: bool = False) -> torch.Tensor:
        """``mla_forward``: x (B, S, d), positions (B, S) → (B, S, d), causal
        (and windowed with ``window``)."""
        S = x.shape[1]
        q_nope, q_rope, c_kv, k_rope = self.qk(x, positions)
        return self.attend(q_nope, q_rope, c_kv, k_rope,
                           causal_mask(S, S, window, device=x.device), absorb)

    def decode(self, cache: dict, x: torch.Tensor, pos: int, *, mask,
               window: int | None = None, absorb: bool = True) -> torch.Tensor:
        """``mla_decode``: x (B, 1, d) at ``pos`` (a Python int); the token's
        ``c_kv`` and ``k_rope`` written in place into slot ``pos`` (``pos %
        cache_len`` with a window); ``mask`` the step's :func:`decode_mask`
        for this cache's length."""
        B = x.shape[0]
        cache_len = cache["c_kv"].shape[1]
        p1 = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q_nope, q_rope, c_kv_new, k_rope_new = self.qk(x, p1)
        slot = pos % cache_len if window is not None else pos
        cache["c_kv"][:, slot] = c_kv_new[:, 0].to(cache["c_kv"].dtype)
        cache["k_rope"][:, slot] = k_rope_new[:, 0].to(cache["k_rope"].dtype)
        return self.attend(q_nope, q_rope, cache["c_kv"], cache["k_rope"], mask, absorb)
