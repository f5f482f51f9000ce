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

Once a window layer's ring is full (``pos >= W − 1``: from there the
reference's mask ``(idx <= slot) | (pos >= W)`` marks every slot valid),
its attention is exactly K7's function, and :meth:`GQA.decode` computes
it with K7 (:func:`repro_torch.kernels.swa_decode.swa_decode`). Every
other step takes the plain masked ``_sdpa``, which the reference computes
outside any Pallas kernel too. MLA and cross-attention are not ported yet
(``ROADMAP.md`` queue 1 item 12).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch import prng
from repro_torch.kernels.swa_decode import swa_decode
from repro_torch.models.layers import apply_rope, dense_param, frozen

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
    qf = q.reshape(B, Sq, Hkv, rep, D).float()
    s = torch.einsum("bqhrd,bkhd->bhrqk", qf, k.float())
    s = s / math.sqrt(D)
    if mask is not None:
        mask = mask[None, None, None] if mask.dim() == 2 else mask[:, :, None]
        s = s + mask
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhrqk,bkhd->bqhrd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


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
        return o.reshape(B, S, self.n_heads * self.head_dim) @ self.wo

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
