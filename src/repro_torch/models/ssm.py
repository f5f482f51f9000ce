"""State-space and recurrent mixers: Mamba (Jamba), sLSTM and mLSTM
(xLSTM) — the counterpart of ``repro.models.ssm``: ``init_mamba``,
``_mamba_conv_full``, ``_mamba_dbc``, ``mamba_forward``,
``init_mamba_cache``, ``mamba_decode`` (:class:`Mamba`); ``init_slstm``,
``_slstm_step``, ``init_slstm_state``, ``slstm_forward``, ``slstm_decode``
(:class:`SLSTM`); ``init_mlstm``, ``init_mlstm_state``, ``_mlstm_step``,
``_mlstm_qkv``, ``_mlstm_chunk_scan``, ``mlstm_forward``, ``mlstm_decode``
(:class:`MLSTM`).

All three carry a fixed-size state per sequence (the decode "cache"). The
reference computes them outside any Pallas kernel; so does the port, with
torch ops. Where the reference scans (``lax.scan``), the port loops in
Python; where it remats a scan's body (``jax.checkpoint``: Mamba's and
mLSTM's chunks, sLSTM's segments), the port checkpoints the same span
when a gradient is being taken (recomputing changes no value).

Mamba's recurrence h_t = dA_t·h_{t−1} + dBx_t is an
``lax.associative_scan`` in the reference; torch has none, so the port
scans by recursive doubling (log2 c levels of one multiply-add each over
the chunk). Its rounding differs from XLA's tree: ``PERF.md`` §2 states
the bound.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.models import loops
from repro_torch.models.layers import dense_param, frozen, rms_norm
from repro_torch.sharding import ctx as shctx

_EPS = 1e-6     # the reference's rms_norm default inside the xLSTM mixers


def _maybe_checkpoint(fn, *args):
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _normal_param(key, shape, scale: float, dtype, device) -> nn.Parameter:
    w = ((prng.normal(key, shape, device) * scale).to(dtype) if key is not None else
         torch.empty(shape, dtype=dtype, device=device))
    return frozen(w)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------
def init_mamba_cache(batch, d_inner, d_state, d_conv, dtype, device="cpu") -> dict:
    return {"conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype, device=device),
            "h": torch.zeros((batch, d_inner, d_state), dtype=torch.float32, device=device)}


def linear_scan(dA: torch.Tensor, dBx: torch.Tensor) -> torch.Tensor:
    """h_t = dA_t·h_{t−1} + dBx_t along axis 1 from h_{−1} = 0, by recursive
    doubling: at offset o every t ≥ o combines (a_{t−o}, b_{t−o}) into
    (a_t, b_t) as (a_{t−o}·a_t, a_t·b_{t−o} + b_t), the reference's
    ``_selective_scan_combine``."""
    a, b = dA, dBx
    c, off = a.shape[1], 1
    while off < c:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
        if off * 2 < c:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


class Mamba(nn.Module):
    """``init_mamba``'s parameters from ``split(key, 6)``: ``in_proj`` ``(d,
    2·di)`` [0], ``conv_w`` ``(d_conv, di)`` as ``0.1·normal`` [1], ``conv_b``
    zeros, ``x_proj`` ``(di, dt_rank + 2·ds)`` [2], ``dt_proj`` ``(dt_rank,
    di)`` [3], ``dt_bias`` −4, ``A_log`` = log(1..ds) on every row
    (float32), ``D`` ones (float32), ``out_proj`` ``(di, d)`` [5]."""

    def __init__(self, key, d_model: int, *, d_inner: int, d_state: int = 16,
                 d_conv: int = 4, dt_rank: int | None = None, dtype, device="cpu"):
        super().__init__()
        self.d_inner, self.d_state = d_inner, d_state
        self.dt_rank = dt_rank = dt_rank or max(1, d_model // 16)
        ks = prng.split(key, 6) if key is not None else (None,) * 6
        self.in_proj = dense_param(ks[0], d_model, 2 * d_inner, dtype, device)
        self.conv_w = _normal_param(ks[1], (d_conv, d_inner), 0.1, dtype, device)
        self.conv_b = frozen(torch.zeros((d_inner,), dtype=dtype, device=device))
        self.x_proj = dense_param(ks[2], d_inner, dt_rank + 2 * d_state, dtype, device)
        self.dt_proj = dense_param(ks[3], dt_rank, d_inner, dtype, device)
        self.dt_bias = frozen(torch.full((d_inner,), -4.0, dtype=dtype, device=device))
        # log(1..ds) by numpy's float32 log on the host (the same bits on any
        # device): XLA's bits for every d_state of the registry (both are an
        # ulp above the correctly rounded log(7))
        A_log = np.log(np.arange(1, d_state + 1, dtype=np.float32))
        self.A_log = frozen(torch.from_numpy(np.tile(A_log[None], (d_inner, 1))).to(device))
        self.D = frozen(torch.ones((d_inner,), dtype=torch.float32, device=device))
        self.out_proj = dense_param(ks[5], d_inner, d_model, dtype, device)

    def _dbc(self, xs):
        """``_mamba_dbc``: (dt, B, C) in float32."""
        proj = xs @ self.x_proj
        dt_in, B_, C_ = torch.split(proj, [self.dt_rank, self.d_state, self.d_state], dim=-1)
        dt = F.softplus(dt_in @ self.dt_proj + self.dt_bias)
        return dt.float(), B_.float(), C_.float()

    def forward(self, x: torch.Tensor, chunk: int = 512) -> torch.Tensor:
        """``mamba_forward``: x (B, S, d) → (B, S, d). With ``chunk`` dividing
        S > chunk, the scan runs chunk by chunk, the state carried across
        (the reference's chunked branch); else in one go. ``chunk`` is the
        reference's default: no config sets it."""
        B, S, _ = x.shape
        xs, z = (x @ self.in_proj).chunk(2, dim=-1)
        w = self.conv_w
        pad = F.pad(xs, (0, 0, w.shape[0] - 1, 0))
        xs = F.silu(sum(pad[:, i:i + S] * w[i] for i in range(w.shape[0])) + self.conv_b)
        dt, B_, C_ = self._dbc(xs)
        A = -torch.exp(self.A_log)

        def seg(xs_c, dt_c, B_c, C_c, h0):
            dA = torch.exp(dt_c[..., None] * A)                                  # (B,c,di,ds)
            dBx = (dt_c * xs_c.float())[..., None] * B_c[:, :, None, :]
            dBx = torch.cat([(dBx[:, 0] + dA[:, 0] * h0)[:, None], dBx[:, 1:]], dim=1)
            h = linear_scan(dA, dBx)
            return (h * C_c[:, :, None, :]).sum(-1), h[:, -1]

        h0 = torch.zeros((B, self.d_inner, self.d_state), dtype=torch.float32,
                         device=x.device)
        if chunk and S % chunk == 0 and S > chunk:
            def trip(h, c):
                sl = slice(c * chunk, (c + 1) * chunk)
                y_c, h = _maybe_checkpoint(seg, xs[:, sl], dt[:, sl], B_[:, sl], C_[:, sl], h)
                return h, y_c

            box = [h0]
            del h0
            h0, ys = loops.trips(trip, box, S // chunk)
            y = torch.cat(ys, dim=1)
        else:
            y, _ = seg(xs, dt, B_, C_, h0)
        y = y + self.D * xs.float()
        y = y.to(x.dtype) * F.silu(z)
        return y @ self.out_proj

    def decode(self, cache: dict, x: torch.Tensor) -> torch.Tensor:
        """``mamba_decode``: x (B, 1, d) → (B, 1, d); the cache's ``conv``
        history and ``h`` replaced by the step's."""
        xs, z = (x[:, 0] @ self.in_proj).chunk(2, dim=-1)
        hist = torch.cat([cache["conv"], xs[:, None]], dim=1)
        xs_c = F.silu((hist * self.conv_w[None]).sum(1) + self.conv_b)
        dt, B_, C_ = self._dbc(xs_c[:, None])
        dt, B_, C_ = dt[:, 0], B_[:, 0], C_[:, 0]
        A = -torch.exp(self.A_log)
        dA = torch.exp(dt[..., None] * A)
        h = dA * cache["h"] + (dt * xs_c.float())[..., None] * B_[:, None, :]
        y = (h * C_[:, None, :]).sum(-1) + self.D * xs_c.float()
        y = y.to(x.dtype) * F.silu(z)
        cache["conv"], cache["h"] = hist[:, 1:], h
        return (y @ self.out_proj)[:, None]


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def init_slstm_state(batch, n_heads, dh, device="cpu") -> dict:
    z = lambda: torch.zeros((batch, n_heads, dh), dtype=torch.float32, device=device)  # noqa: E731
    return {"h": z(), "c": z(), "n": z(), "m": z()}


class SLSTM(nn.Module):
    """``init_slstm``'s parameters from ``split(key, 3)``: ``w_in`` ``(d,
    4d)`` [0] (z, i, f, o pre-activations), ``r`` ``(4, H, dh, dh)`` as
    ``0.02·normal`` [1], ``b`` zeros, ``out_proj`` ``(d, d)`` [2], ``norm``
    ones (a raw array, as in the reference's tree)."""

    def __init__(self, key, d_model: int, n_heads: int, dtype, device="cpu"):
        super().__init__()
        self.n_heads, self.dh = n_heads, d_model // n_heads
        ks = prng.split(key, 3) if key is not None else (None,) * 3
        self.w_in = dense_param(ks[0], d_model, 4 * d_model, dtype, device)
        self.r = _normal_param(ks[1], (4, n_heads, self.dh, self.dh), 0.02, dtype, device)
        self.b = frozen(torch.zeros((4 * d_model,), dtype=dtype, device=device))
        self.out_proj = dense_param(ks[2], d_model, d_model, dtype, device)
        self.norm = frozen(torch.ones((d_model,), dtype=dtype, device=device))

    def step(self, carry, pre):
        """``_slstm_step``: carry (h, c, n, m) each (B, H, dh) float32; pre
        (B, 4d) the input pre-activations."""
        h, c, n, m = carry
        B = pre.shape[0]
        pre = pre.reshape(B, 4, self.n_heads, self.dh).float()
        rec = torch.einsum("bhd,ghde->bghe", h, self.r.float())
        z_t = torch.tanh(pre[:, 0] + rec[:, 0])
        i_t = pre[:, 1] + rec[:, 1]
        f_t = pre[:, 2] + rec[:, 2]
        o_t = torch.sigmoid(pre[:, 3] + rec[:, 3])
        m_new = torch.maximum(f_t + m, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(f_t + m - m_new)
        c_new = f_p * c + i_p * z_t
        n_new = f_p * n + i_p
        h_new = o_t * c_new / torch.clamp(torch.abs(n_new), min=1.0)
        return h_new, c_new, n_new, m_new

    def _scan(self, pre, *carry):
        """Steps over pre's axis 1 from the carry (h, c, n, m): (the last
        carry..., hs (B, c, H, dh)). The carry comes as four tensors, which a
        checkpoint saves as it saves any (a tuple it would hold by reference,
        outside the saved-tensor hooks of an enclosing checkpoint)."""
        def trip(c, t):
            c = self.step(c, pre[:, t])
            return c, c[0]

        box = [carry]
        del carry
        carry, hs = loops.trips(trip, box, pre.shape[1])
        return (*carry, torch.stack(hs, dim=1))

    def forward(self, x: torch.Tensor, segment: int = 64) -> torch.Tensor:
        """``slstm_forward``: the input matmul hoisted, then the recurrence
        over S; with ``segment`` dividing S > segment, segment by segment
        (each recomputed in the backward pass, as the reference's remat)."""
        B, S, d = x.shape
        st = init_slstm_state(B, self.n_heads, self.dh, x.device)
        carry = (st["h"], st["c"], st["n"], st["m"])
        pre = shctx.shard_head_proj(x @ self.w_in + self.b, 4)      # (z, i, f, o)
        if segment and S % segment == 0 and S > segment:
            def trip(c, s):
                *c, hs_s = _maybe_checkpoint(self._scan, pre[:, s * segment:(s + 1) * segment],
                                             *c)
                return tuple(c), hs_s

            box = [carry]
            del carry
            carry, parts = loops.trips(trip, box, S // segment)
            hs = torch.cat(parts, dim=1)
        else:
            *_, hs = self._scan(pre, *carry)
        # the heads merged, whole on a model axis that does not divide them
        y = shctx.shard_head_proj(hs.reshape(B, S, d), self.n_heads).to(x.dtype)
        return rms_norm(y, self.norm, _EPS) @ self.out_proj

    def decode(self, cache: dict, x: torch.Tensor) -> torch.Tensor:
        """``slstm_decode``: x (B, 1, d) → (B, 1, d); the state replaced."""
        B, _, d = x.shape
        pre = shctx.shard_head_proj(x[:, 0] @ self.w_in + self.b, 4)
        new = self.step((cache["h"], cache["c"], cache["n"], cache["m"]), pre)
        cache.update(zip(("h", "c", "n", "m"), new))
        y = new[0].reshape(B, 1, d).to(x.dtype)
        return rms_norm(y, self.norm, _EPS) @ self.out_proj


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def init_mlstm_state(batch, n_heads, dh, device="cpu") -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, n_heads, dh, dh), **f32),
            "n": torch.zeros((batch, n_heads, dh), **f32),
            "m": torch.zeros((batch, n_heads), **f32)}


def mlstm_step(carry, qkv_if, dh: int):
    """``_mlstm_step``: one stabilised step, the forget gate in log-sigmoid
    space, the read-out's denominator max(|n·q|, exp(−m))."""
    C, n, m = carry
    q, k, v, i_t, f_t = qkv_if
    lf = F.logsigmoid(f_t)
    m_new = torch.maximum(lf + m, i_t)
    i_p = torch.exp(i_t - m_new)[..., None]
    f_p = torch.exp(lf + m - m_new)[..., None]
    kn = k / math.sqrt(dh)
    C_new = f_p[..., None] * C + i_p[..., None] * (v[..., None] * kn[..., None, :])
    n_new = f_p * n + i_p * kn
    num = torch.einsum("bhde,bhe->bhd", C_new, q)
    den = torch.maximum(torch.abs((n_new * q).sum(-1)), torch.exp(-m_new))[..., None]
    return (C_new, n_new, m_new), num / den


def mlstm_chunk_scan(q, k, v, i_pre, f_pre, chunk: int) -> torch.Tensor:
    """``_mlstm_chunk_scan``: the chunkwise-parallel stabilised mLSTM, equal
    to scanning :func:`mlstm_step` over S. Within a chunk the output is a
    causal (c × c) attention-like product with a decay matrix; the (dh ×
    dh) state is carried across chunk boundaries only. q, k, v (B, S, H,
    dh), i_pre/f_pre (B, S, H) → hs (B, S, H, dh)."""
    B, S, H, dh = q.shape
    kn = k / math.sqrt(dh)
    lf = F.logsigmoid(f_pre)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))

    def chunk_body(C0, n0, m0, qb, kb, vb, lib, lfb):
        b = torch.cumsum(lfb, dim=1)                                       # (B,c,H)
        g = torch.cummax(torch.maximum(m0[:, None], lib - b), dim=1).values
        m = b + g
        inter_w = torch.exp(m0[:, None] + b - m)
        inter_h = torch.einsum("bhde,bche->bchd", C0, qb)
        inter_n = torch.einsum("bhe,bche->bch", n0, qb)
        logD = b[:, :, None] + (lib - b)[:, None, :] - m[:, :, None]
        D = torch.where(causal[None, :, :, None], torch.exp(logD), 0.0)
        scores = torch.einsum("bchd,bshd->bcsh", qb, kb)
        intra_h = torch.einsum("bcsh,bshd->bchd", D * scores, vb)
        intra_n = torch.einsum("bcsh,bcsh->bch", D, scores)
        num = inter_w[..., None] * inter_h + intra_h
        nq = inter_w * inter_n + intra_n
        den = torch.maximum(torch.abs(nq), torch.exp(-m))[..., None]
        h = num / den
        bc, mc = b[:, -1], m[:, -1]
        w0 = torch.exp(m0 + bc - mc)
        ws = torch.exp(bc[:, None] - b + lib - mc[:, None])
        C_new = w0[..., None, None] * C0 + torch.einsum("bch,bchd,bche->bhde", ws, vb, kb)
        n_new = w0[..., None] * n0 + torch.einsum("bch,bchd->bhd", ws, kb)
        return C_new, n_new, mc, h

    st = init_mlstm_state(B, H, dh, q.device)

    def trip(cnm, c):
        sl = slice(c * chunk, (c + 1) * chunk)
        *cnm, h = _maybe_checkpoint(chunk_body, *cnm, q[:, sl], kn[:, sl], v[:, sl],
                                    i_pre[:, sl], lf[:, sl])
        return tuple(cnm), h

    _, hs = loops.trips(trip, [(st["C"], st["n"], st["m"])], S // chunk)
    return torch.cat(hs, dim=1)


class MLSTM(nn.Module):
    """``init_mlstm``'s parameters from ``split(key, 7)``: ``up`` ``(d, 2·di)``
    [0], ``wq``, ``wk``, ``wv`` ``(di, di)`` [1]–[3], ``w_if`` ``(di, 2H)``
    [4], ``norm`` ones ``(di,)`` (a raw array), ``down`` ``(di, d)`` [6];
    di = expand·d."""

    def __init__(self, key, d_model: int, n_heads: int, *, expand: int = 2, dtype,
                 device="cpu"):
        super().__init__()
        di = expand * d_model
        self.n_heads, self.di, self.dh = n_heads, di, di // n_heads
        ks = prng.split(key, 7) if key is not None else (None,) * 7
        self.up = dense_param(ks[0], d_model, 2 * di, dtype, device)
        self.wq = dense_param(ks[1], di, di, dtype, device)
        self.wk = dense_param(ks[2], di, di, dtype, device)
        self.wv = dense_param(ks[3], di, di, dtype, device)
        self.w_if = dense_param(ks[4], di, 2 * n_heads, dtype, device)
        self.norm = frozen(torch.ones((di,), dtype=dtype, device=device))
        self.down = dense_param(ks[6], di, d_model, dtype, device)

    def qkv(self, xs):
        """``_mlstm_qkv``: q, k, v (B, S, H, dh) and the i, f pre-activations
        (B, S, H), float32."""
        B, S, _ = xs.shape
        H, dh = self.n_heads, self.dh
        q, k, v = (shctx.shard_head_proj(xs @ w, H).reshape(B, S, H, dh).float()
                   for w in (self.wq, self.wk, self.wv))
        if_pre = (xs @ self.w_if).reshape(B, S, 2, H).float()
        return q, k, v, if_pre[:, :, 0], if_pre[:, :, 1]

    def forward(self, x: torch.Tensor, chunk: int = 256) -> torch.Tensor:
        """``mlstm_forward``: chunkwise when ``chunk`` divides S > chunk,
        else the step scan."""
        B, S, _ = x.shape
        xs, z = (x @ self.up).chunk(2, dim=-1)
        q, k, v, i_pre, f_pre = self.qkv(xs)
        if chunk and S % chunk == 0 and S > chunk:
            hs = mlstm_chunk_scan(q, k, v, i_pre, f_pre, chunk)
        else:
            st = init_mlstm_state(B, self.n_heads, self.dh, x.device)

            def trip(carry, t):
                return mlstm_step(carry, (q[:, t], k[:, t], v[:, t], i_pre[:, t], f_pre[:, t]),
                                  self.dh)

            _, hs = loops.trips(trip, [(st["C"], st["n"], st["m"])], S)
            hs = torch.stack(hs, dim=1)
        # the heads merged, whole on a model axis that does not divide them
        # (the gradient back there before its split, a view of each block)
        y = shctx.shard_head_proj(hs.reshape(B, S, self.di), self.n_heads).to(x.dtype)
        y = rms_norm(y, self.norm, _EPS) * F.silu(z)
        return y @ self.down

    def decode(self, cache: dict, x: torch.Tensor) -> torch.Tensor:
        """``mlstm_decode``: x (B, 1, d) → (B, 1, d); the state replaced."""
        B = x.shape[0]
        xs, z = (x[:, 0] @ self.up).chunk(2, dim=-1)
        q, k, v, i_pre, f_pre = self.qkv(xs[:, None])
        (C, n, m), h = mlstm_step((cache["C"], cache["n"], cache["m"]),
                                  (q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0]),
                                  self.dh)
        cache.update(C=C, n=n, m=m)
        y = h.reshape(B, 1, self.di).to(x.dtype)
        y = rms_norm(y, self.norm, _EPS) * F.silu(z[:, None])
        return y @ self.down
