"""The plain SGNS step (word2vec's skip-gram with negative sampling) for n
sub-models at once, with both negative draws and word2vec's init.

Frozen copies, at commit 69e108eca3b3, of what the port computes:

* the step: ``src/repro_torch/core/sgns.py`` (``train_step_sparse_``: row
  gradients from the pre-step tables, then the accumulating apply at W
  [centers], C[contexts], C[negatives]) with the per-pair loss and row
  gradients of ``src/repro_torch/kernels/sgns_update.py``
  (``sgns_row_grads_plain``), and ``linear_lr``;
* K2's draw: ``src/repro_torch/kernels/sgns_fused.py`` (``mix32``,
  ``counter_uniforms``, ``alias_draw_from_counters``): two counters a draw,
  row-major from 0, hashed with each worker's step seed;
* the CDF draw: ``src/repro_torch/data/pairs.py`` (``sample_negatives_cdf``:
  threefry uniforms under each worker's step seed, ``searchsorted(right=
  True)`` into its CDF);
* the init: ``src/repro_torch/core/sgns.py`` (``init_params``: W ~ U(−0.5/d,
  0.5/d) under ``split(key)[0]``, C = 0) with each worker's key split off
  the init key, as ``AsyncShardTrainer.init`` does.

Tables here are flat ``(R, d)``: any set of rows of the n stacked tables,
addressed by row keys ``w·V + r``. The loss reduction, the sum order of the
dot products and the addends of a duplicated row follow torch's ordinary
ops, not the kernels' order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import threefry

_MASK = 0xFFFFFFFF


def linear_lr(step: int, total_steps: int, lr: float, lr_min: float) -> np.float32:
    """word2vec's linearly decaying alpha in float32."""
    f32 = np.float32
    frac = np.clip(f32(step) / f32(max(total_steps, 1)), f32(0.0), f32(1.0))
    return np.maximum(f32(lr) * (f32(1.0) - frac), f32(lr_min))


def chunk_step_seeds(key, n: int, steps: int) -> np.ndarray:
    """``(n, steps, 2)`` uint32 seeds: worker w's subkeys of the chain that
    starts at ``split(key, n)[w]``, one a step of the chunk."""
    return threefry.step_keys(threefry.split(key, n), steps)


# ---------------------------------------------------------------------------
# Negative draws
# ---------------------------------------------------------------------------
def _mulmod32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulmod32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _counter_uniforms(s0: torch.Tensor, s1: torch.Tensor, counters: torch.Tensor):
    bits = _mix32((_mix32(counters ^ s0) + s1) & _MASK)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def draw_alias(seeds: np.ndarray, prob: torch.Tensor, alias: torch.Tensor,
               B: int, K: int) -> torch.Tensor:
    """K2's negatives: ``(n, B, K)`` int64 ids, worker w drawing from its
    alias table ``prob[w]``, ``alias[w]`` under its seed ``seeds[w]``."""
    n, V = prob.shape
    s0, s1 = threefry.key_words(seeds, prob.device)
    s0, s1 = s0[:, None], s1[:, None]
    base = torch.arange(B * K, dtype=torch.int64, device=prob.device)[None]
    u_idx = _counter_uniforms(s0, s1, (base * 2) & _MASK)
    u_acc = _counter_uniforms(s0, s1, (base * 2 + 1) & _MASK)
    scaled = u_idx * torch.tensor(float(V), dtype=torch.float32, device=prob.device)
    idx = torch.clamp_max(scaled.to(torch.int64), V - 1)
    p = torch.gather(prob, 1, idx)
    a = torch.gather(alias.long(), 1, idx)
    return torch.where(u_acc < p, idx, a).view(n, B, K)


def draw_cdf(seeds: np.ndarray, cdf: torch.Tensor, B: int, K: int) -> torch.Tensor:
    """The CDF sampler's negatives: ``(n, B, K)`` int64 ids, worker w's
    threefry uniforms under ``seeds[w]`` through its CDF ``cdf[w]``."""
    n, V = cdf.shape
    k0, k1 = threefry.key_words(seeds, cdf.device)
    index = torch.arange(B * K, dtype=torch.int64, device=cdf.device)[None]
    u = threefry.uniform(k0[:, None], k1[:, None], index)
    idx = torch.searchsorted(cdf, u, right=True)
    return torch.clamp(idx, 0, V - 1).view(n, B, K)


def draw(kind: str, seeds: np.ndarray, table, B: int, K: int) -> torch.Tensor:
    """Negatives of one step by the sampler ``kind`` (``alias``: K2's
    counter hash; ``cdf``: threefry uniforms)."""
    if kind == "alias":
        return draw_alias(seeds, table["prob"], table["alias"], B, K)
    if kind == "cdf":
        return draw_cdf(seeds, table, B, K)
    raise ValueError(f"unknown sampler {kind!r}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def worker_init_words(init_key, n: int, device):
    """Each worker's W key words ``(n,)`` twice: ``split(split(init_key,
    n)[w])[0]``."""
    kw = threefry.split(threefry.split(init_key, n), 2)[:, 0]
    return threefry.key_words(kw, device)


def init_rows(init_key, n: int, V: int, d: int, rows: torch.Tensor) -> torch.Tensor:
    """Rows ``rows`` (int64 keys ``w·V + r``) of the n stacked initial W
    tables, ``(len(rows), d)`` float32: bitwise those rows of the whole
    ``U(−0.5/d, 0.5/d)`` draw of each worker."""
    k0, k1 = worker_init_words(init_key, n, rows.device)
    w, r = rows // V, rows % V
    index = r[:, None] * d + torch.arange(d, dtype=torch.int64, device=rows.device)
    return threefry.uniform(k0[w][:, None], k1[w][:, None], index, -0.5 / d, 0.5 / d)


def init_tables(init_key, n: int, V: int, d: int, device, rows_a_call: int = 8192):
    """The n whole initial W tables ``(n, V, d)`` float32, drawn a block of
    rows at a time."""
    W = torch.empty((n, V, d), dtype=torch.float32, device=device)
    flat = W.view(n * V, d)
    for a in range(0, n * V, rows_a_call):
        rows = torch.arange(a, min(a + rows_a_call, n * V), dtype=torch.int64, device=device)
        flat[a:a + len(rows)] = init_rows(init_key, n, V, d, rows)
    return W


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------
def sgns_step_(W: torch.Tensor, C: torch.Tensor, rw: torch.Tensor, rx: torch.Tensor,
               rn: torch.Tensor, lr: float) -> torch.Tensor:
    """One SGNS step of n workers on flat tables ``W``, ``C`` ``(R, d)``,
    **in place**: rows ``rw`` (centers), ``rx`` (contexts) ``(n, B)`` and
    ``rn`` (negatives) ``(n, B, K)``. The gradients of the summed loss come
    from the pre-step rows; ``table[row] −= lr·grad`` adds each pair's
    gradient, duplicates accumulating. Returns each worker's mean loss
    ``(n,)`` in float32. Works in the tables' dtype."""
    n, B = rw.shape
    d = W.shape[1]
    w, cp, cn = W[rw], C[rx], C[rn]                       # (n,B,d), (n,B,d), (n,B,K,d)
    s_pos = (w * cp).sum(-1)
    s_neg = (w[:, :, None, :] * cn).sum(-1)
    loss = F.softplus(-s_pos) + F.softplus(s_neg).sum(-1)
    g_pos = torch.sigmoid(s_pos) - 1.0
    g_neg = torch.sigmoid(s_neg)
    d_w = g_pos[..., None] * cp + (g_neg[..., None] * cn).sum(-2)
    d_cp = g_pos[..., None] * w
    d_cn = g_neg[..., None] * w[:, :, None, :]
    step = -float(np.float32(lr))
    W.index_put_((rw.reshape(-1),), (step * d_w).reshape(-1, d), accumulate=True)
    C.index_put_((rx.reshape(-1),), (step * d_cp).reshape(-1, d), accumulate=True)
    C.index_put_((rn.reshape(-1),), (step * d_cn).reshape(-1, d), accumulate=True)
    return loss.mean(-1).float()
