"""K5: the SGNS step as a chain of pair blocks in one launch — the CUDA
kernel's wrapper, its plain torch versions, and the reference's block
planner.

Replaces the JAX package's ``_pipe_kernel`` (``repro/kernels/
sgns_fused_pipe.py``, engine ``pallas_fused_pipe``). Source:
``repro_torch/csrc/sgns_fused_pipe.cu`` (+ ``sgns_pipe.cuh``). The
reference gathers each block's unique rows once into a ring of VMEM slots,
applies all its updates there and writes each row back once. Its result is
the chain of K4a (``sgns_fused_hbm``, ``sequential=False``) at the same
``block_pairs``, bit for bit: the same negatives, the same dot products,
each row's addends in the same order. On the card the kernel computes that
chain in place in the tables, in one persistent launch for all workers.

* :func:`sgns_fused_pipe_step` — on the card: K1's draw, K4a's stable
  (block, row) sort of each table's touched rows (:func:`~repro_torch
  .kernels.sgns_fused_hbm.block_sorts`), then one K5 launch
  (:func:`run_chain`). On the CPU: :func:`sgns_fused_pipe_step_plain`.
* :func:`sgns_fused_pipe_step_plain` — the reference's algorithm in torch:
  :func:`plan_blocks`, then :func:`run_plan_plain` (per block, gather each
  unique row into a buffer, update the buffer, write it back).
* :func:`run_chain_plain` — the kernel's algorithm in torch: the sorted
  runs applied to the rows in place; bitwise :func:`run_plan_plain`.
* :func:`plan_blocks` — the reference's planner, worker-batched, in torch
  (sorts and ``searchsorted``): per block the sorted unique rows of each
  table, every pair's position in them, and the hazard flags of the
  reference's ring. Integer-exact: equal to ``jax.vmap`` of the
  reference's ``plan_blocks`` (whose pair mask is the rule the kernels
  read off a pair's index: a pair is real iff its index is below ``B``).
  It serves the plain version and the row-traffic count
  (:func:`plan_row_traffic`); the card's path needs no plan.

The tiered kernel K6 (``sgns_fused_tiered``) shares the plain versions and
the launch (:func:`run_chain`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.sgns_fused import (
    LAUNCHES, MAX_NEGATIVES, _check, _entry, _kernel_device, _ptr, _raise_on,
    _stream, sample_negatives)
from repro_torch.kernels.sgns_fused_hbm import block_sorts, pick_block_pairs

NUM_SLOTS = 2   # the reference's default ring depth (the planner's look-behind)
# The launch's shape (``csrc/sgns_pipe.cuh``): warps a CTA, a warp's stage,
# addend chunks staged ahead, sorted positions an apply item, CTAs a group.
CHAIN_WARPS, CHAIN_STAGE_BYTES, CHAIN_AHEAD, CHAIN_WINDOW, CHAIN_MIN_GROUP = 8, 14336, 8, 16, 8


def chain_smem(d: int, K: int, vec: int) -> int:
    """Dynamic shared memory a CTA of K5/K6 takes (``launch_chain``): a
    warp's stage holds as many column steps of a pair's K + 2 rows as
    ``CHAIN_STAGE_BYTES`` allows (at least one, at most the whole row), or
    2 ``CHAIN_AHEAD`` addend chunks, whichever is larger."""
    step_floats = (K + 2) * 32 * vec
    steps = -(-d // (32 * vec))
    stage_steps = max(1, min(steps, CHAIN_STAGE_BYTES // 4 // step_floats))
    stage_floats = max(stage_steps * step_floats, 2 * CHAIN_AHEAD * 32 * vec)
    return CHAIN_WARPS * stage_floats * 4


def chain_geometry(n: int, d: int, B: int, K: int, blk: int, capacity: int,
                   vec: int = 4) -> tuple[int, int]:
    """``(group_ctas, groups)`` of K5/K6's launch on a card holding
    ``capacity`` of its CTAs at once (``launch_chain``)."""
    blk = max(1, min(int(blk), B))
    chunks = -(-d // (32 * vec))
    items = (-(-blk * (K + 1) // CHAIN_WINDOW) + -(-blk // CHAIN_WINDOW)) * chunks
    cap = -(-max(blk, items) // CHAIN_WARPS)
    per = max(capacity // n, CHAIN_MIN_GROUP)
    per = min(per, cap, capacity)
    return per, min(n, capacity // per)


def chain_items(rows: np.ndarray, d: int, vec: int = 4, s0: int = 0) -> np.ndarray:
    """K5/K6's apply items of one block's sorted list ``rows``, in the
    format of :func:`~repro_torch.kernels.sgns_block_step.apply_items`:
    ``(m, 4)`` rows of (first position + ``s0``, positions, first column,
    columns). Window ``i`` of ``CHAIN_WINDOW`` positions takes every run
    whose head lies in it, each whole, in chunks of 32 ``vec`` columns; a
    window with no head takes none (``apply_item``)."""
    rows = np.asarray(rows)
    N = len(rows)
    head = np.ones(N, dtype=bool)
    head[1:] = rows[1:] != rows[:-1]
    starts = np.flatnonzero(head)
    ends = np.append(starts[1:], N)
    span = 32 * vec
    items = []
    for w0 in range(0, N, CHAIN_WINDOW):
        mine = (starts >= w0) & (starts < w0 + CHAIN_WINDOW)
        if not mine.any():
            continue
        first, last = int(starts[mine][0]), int(ends[mine][-1])
        items += [(s0 + first, last - first, c * span, span) for c in range(-(-d // span))]
    return np.array(items, dtype=np.int64).reshape(-1, 4)


# ---------------------------------------------------------------------------
# Block planner
# ---------------------------------------------------------------------------
class PipelinePlan(NamedTuple):
    """Per-block metadata of one step, for n workers at once.

    Every field has a leading worker axis ``n`` and a block axis
    ``nblocks``: ``nblocks`` blocks of ``blk`` pairs (the batch is padded
    to whole blocks with its *first* pair; a padded pair, index ``>= B``
    in the batch, updates nothing). ``R_W = blk`` and ``R_C = blk·(K+1)``
    are the slot capacities. With a hot tier (``hot_rows > 0``) the unique sets,
    counts and hazards cover cold rows only (ids ``>= hot_rows``); a hot
    element's position points at a pad slot of its buffer.
    """

    uw: torch.Tensor       # (n, nb, R_W) int32 — sorted unique cold center rows, padded with V
    uc: torch.Tensor       # (n, nb, R_C) int32 — sorted unique cold context ∪ negative rows
    n_w: torch.Tensor      # (n, nb) int32 — valid rows in uw
    n_c: torch.Tensor      # (n, nb) int32 — valid rows in uc
    w_pos: torch.Tensor    # (n, nb, blk) int32 — pair j's center → uw slot
    cp_pos: torch.Tensor   # (n, nb, blk) int32 — pair j's context → uc slot
    cn_pos: torch.Tensor   # (n, nb, blk·K) int32 — pair j's k-th negative → uc slot
    hazard: torch.Tensor   # (n, nb) int32 — touched(b) ∩ written(b-1 .. b-(S-1)) ≠ ∅
    cen: torch.Tensor      # (n, nb, blk) int32 — blocked center ids
    ctx: torch.Tensor      # (n, nb, blk) int32 — blocked context ids
    neg: torch.Tensor      # (n, nb, blk·K) int32 — blocked negative ids

    @property
    def nblocks(self) -> int:
        return self.uw.shape[1]

    @property
    def block_pairs(self) -> int:
        return self.w_pos.shape[2]


def _pad_to_blocks(x: torch.Tensor, nblocks: int, blk: int) -> torch.Tensor:
    """``(n, B, ...)`` → ``(n, nblocks, blk, ...)``, padding with each
    worker's first element."""
    n, B = x.shape[:2]
    pad = nblocks * blk - B
    if pad:
        x = torch.cat([x, x[:, :1].expand(n, pad, *x.shape[2:])], dim=1)
    return x.reshape(n, nblocks, blk, *x.shape[2:])


def _unique_rows(ids: torch.Tensor, vocab_size: int):
    """Per-block sorted unique ids of ``ids`` ``(n, nb, R)``, padded with
    ``vocab_size`` (V marks entries already routed to the hot tier and is
    never counted): ``(u (n, nb, R), count (n, nb))``."""
    s, _ = torch.sort(ids, dim=-1)
    first = torch.cat([torch.ones_like(s[..., :1], dtype=torch.bool),
                       s[..., 1:] != s[..., :-1]], dim=-1)
    count = (first & (s < vocab_size)).sum(-1, dtype=torch.int32)
    # a stable sort floats the first occurrences to the front, still in
    # ascending order; the duplicate and sentinel tail is overwritten with V
    order = torch.argsort((~first).to(torch.int8), dim=-1, stable=True)
    u = torch.gather(s, -1, order)
    col = torch.arange(s.shape[-1], device=s.device)
    return torch.where(col < count[..., None], u, vocab_size), count


def _lookup(u: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Each id's slot in its block's unique set (``searchsorted`` left),
    clamped to the last slot: a hot id (the V sentinel) lands on the
    first pad slot, or on the last slot when a block has no padding (and
    then no hot ids)."""
    pos = torch.searchsorted(u, ids, side="left")
    return torch.clamp_max(pos, u.shape[-1] - 1).to(torch.int32)


def plan_blocks(centers: torch.Tensor, contexts: torch.Tensor,
                negatives: torch.Tensor, vocab_size: int, block_pairs: int, *,
                hot_rows: int = 0, ring_depth: int = NUM_SLOTS) -> PipelinePlan:
    """Plan one step's pair blocks for every worker: ``centers``,
    ``contexts`` ``(n, B)``, ``negatives`` ``(n, B, K)`` int32. Splits the
    batch into ``blk``-pair blocks (padded with the first pair), routes ids
    ``< hot_rows`` to the hot tier (out of the unique sets and the hazard
    sets), dedups each block's cold rows per table, maps every pair
    element to its slot, and flags the blocks whose cold touched set meets
    any of the previous ``ring_depth - 1`` blocks' written sets."""
    n, B = centers.shape
    K = negatives.shape[-1]
    blk = pick_block_pairs(B, block_pairs)
    nblocks = -(-B // blk)
    V = int(vocab_size)
    device = centers.device

    cen = _pad_to_blocks(centers.to(torch.int32), nblocks, blk)
    ctx = _pad_to_blocks(contexts.to(torch.int32), nblocks, blk)
    neg = _pad_to_blocks(negatives.to(torch.int32), nblocks, blk)
    negf = neg.reshape(n, nblocks, blk * K)

    def cold(ids):
        if hot_rows <= 0:
            return ids
        return torch.where(ids < hot_rows, V, ids)

    uw, n_w = _unique_rows(cold(cen), V)
    c_rows = torch.cat([cold(ctx), cold(negf)], dim=-1)
    uc, n_c = _unique_rows(c_rows, V)
    w_pos = _lookup(uw, cold(cen))
    c_pos = _lookup(uc, c_rows)

    # written(b) == touched(b) per table, and W rows only meet W writes
    def hit(u, m):
        prev, cur = u[:, :-m].contiguous(), u[:, m:].contiguous()
        idx = torch.clamp_max(torch.searchsorted(prev, cur, side="left"),
                              u.shape[-1] - 1)
        found = torch.gather(prev, -1, idx) == cur
        return (found & (cur < V)).any(-1)

    hz = torch.zeros((n, nblocks), dtype=torch.bool, device=device)
    for m in range(1, min(ring_depth, nblocks)):
        hz[:, m:] |= hit(uw, m) | hit(uc, m)
    return PipelinePlan(
        uw=uw, uc=uc, n_w=n_w, n_c=n_c, w_pos=w_pos,
        cp_pos=c_pos[..., :blk].contiguous(), cn_pos=c_pos[..., blk:].contiguous(),
        hazard=hz.to(torch.int32), cen=cen, ctx=ctx, neg=negf)


def plan_row_traffic(plan: PipelinePlan, hot_rows: int = 0) -> int:
    """The reference's row transfers for one step under ``plan``, summed
    over workers: each valid cold row one gather and one write-back, and
    each worker's hot prefix of ``hot_rows`` rows in and out once per step
    for both tables. K5 moves the cold rows so; K6 leaves its hot rows in
    place and moves no prefix."""
    n = plan.n_w.shape[0]
    return 2 * int(plan.n_w.sum() + plan.n_c.sum()) + 4 * int(hot_rows) * n


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------
def _gather_slots(table: torch.Tensor, u: torch.Tensor, b: int) -> torch.Tensor:
    """Block b's slot rows ``(n, R, d)`` of the stacked ``table``; pad
    slots (id V) read row V − 1 and are never written back."""
    n, V, d = table.shape
    off = torch.arange(n, device=u.device)[:, None] * V
    idx = (torch.clamp_max(u[:, b].long(), V - 1) + off).reshape(-1)
    return table.reshape(n * V, d)[idx].view(n, -1, d)


def _write_back(table: torch.Tensor, u: torch.Tensor, count: torch.Tensor,
                buf: torch.Tensor, b: int) -> None:
    """Each worker's valid slots ``[0, count)`` of block b back to their
    rows, once."""
    n, V, d = table.shape
    valid = torch.arange(u.shape[-1], device=u.device) < count[:, b, None]
    off = torch.arange(n, device=u.device)[:, None] * V
    rows = (u[:, b].long() + off)[valid]
    table.view(n * V, d).index_copy_(0, rows, buf[valid])


def run_plan_plain(params: dict, plan: PipelinePlan, lr: float, B: int, *,
                   hot_rows: int = 0) -> torch.Tensor:
    """The step K5 (``hot_rows == 0``) or K6 computes from ``plan``, in
    torch. Per block: gather each valid cold row once into a buffer,
    compute the real pairs' grads from the buffer rows (and, with a hot
    tier, from a hot copy of the first ``hot_rows`` rows plus a spill row
    at index ``hot_rows``), add them in reference order — W at centers; C
    at contexts, then at negatives — into the buffer and into the hot
    copy (each element's update lands on its own tier and on the other
    side's write-off slot), then write the valid slots back once. The hot
    copy goes back after the last block. Padded pairs update nothing.
    Updates ``params`` in place; returns the loss ``(n, B)``."""
    from repro_torch.core.sgns import sparse_row_grads_per_pair

    W, C = params["W"], params["C"]
    n, V, d = W.shape
    blk = plan.block_pairs
    K = plan.neg.shape[-1] // blk
    kH = int(hot_rows)
    RW, RC = plan.uw.shape[-1], plan.uc.shape[-1]
    device = W.device
    neg_lr = -float(np.float32(lr))
    loss = torch.empty((n, B), dtype=torch.float32, device=device)
    if kH:
        spill = torch.zeros((n, 1, d), dtype=torch.float32, device=device)
        hot_w = torch.cat([W[:, :kH], spill], dim=1).reshape(n * (kH + 1), d)
        hot_c = torch.cat([C[:, :kH], spill], dim=1).reshape(n * (kH + 1), d)
        h_off = torch.arange(n, device=device)[:, None] * (kH + 1)
    w_off = torch.arange(n, device=device)[:, None] * RW
    c_off = torch.arange(n, device=device)[:, None] * RC
    for b in range(plan.nblocks):
        nv = min(blk, B - b * blk)
        buf_w = _gather_slots(W, plan.uw, b).reshape(n * RW, d)
        buf_c = _gather_slots(C, plan.uc, b).reshape(n * RC, d)
        wp = (plan.w_pos[:, b, :nv].long() + w_off).reshape(-1)
        cp = (plan.cp_pos[:, b, :nv].long() + c_off).reshape(-1)
        cn = (plan.cn_pos[:, b, :nv * K].long() + c_off).reshape(-1)
        w, c_pos, c_neg = buf_w[wp], buf_c[cp], buf_c[cn]
        if kH:
            ids = [plan.cen[:, b, :nv], plan.ctx[:, b, :nv], plan.neg[:, b, :nv * K]]
            hot = [(i < kH).reshape(-1) for i in ids]
            h_idx = [(torch.where(i < kH, i, kH).long() + h_off).reshape(-1)
                     for i in ids]
            w = torch.where(hot[0][:, None], hot_w[h_idx[0]], w)
            c_pos = torch.where(hot[1][:, None], hot_c[h_idx[1]], c_pos)
            c_neg = torch.where(hot[2][:, None], hot_c[h_idx[2]], c_neg)
        pair_loss, d_w, d_cp, d_cn = sparse_row_grads_per_pair(
            w, c_pos, c_neg.view(n * nv, K, d))
        loss[:, b * blk:b * blk + nv] = pair_loss.view(n, nv)
        u_w, u_cp = neg_lr * d_w, neg_lr * d_cp
        u_cn = neg_lr * d_cn.reshape(-1, d)
        buf_w.index_add_(0, wp, u_w)
        buf_c.index_add_(0, cp, u_cp)
        buf_c.index_add_(0, cn, u_cn)
        if kH:
            hot_w.index_add_(0, h_idx[0], u_w)
            hot_c.index_add_(0, h_idx[1], u_cp)
            hot_c.index_add_(0, h_idx[2], u_cn)
        _write_back(W, plan.uw, plan.n_w, buf_w.view(n, RW, d), b)
        _write_back(C, plan.uc, plan.n_c, buf_c.view(n, RC, d), b)
    if kH:
        W[:, :kH] = hot_w.view(n, kH + 1, d)[:, :kH]
        C[:, :kH] = hot_c.view(n, kH + 1, d)[:, :kH]
    return loss


def sgns_fused_pipe_step_plain(params: dict, centers: torch.Tensor,
                               contexts: torch.Tensor, table: dict,
                               seeds: torch.Tensor, lr: float, *,
                               negatives: int = 5, block_pairs: int = 256,
                               ring_depth: int = NUM_SLOTS):
    """The step K5 computes, in torch: the step's draw, the plan, then
    :func:`run_plan_plain`. Updates ``params`` in place; returns
    ``(params, loss (n, B), ids (n, B, K))``."""
    from repro_torch.kernels.sgns_fused import sample_negatives_plain

    B = centers.shape[1]
    ids = sample_negatives_plain(seeds, table["prob"], table["alias"], (B, negatives))
    plan = plan_blocks(centers, contexts, ids, params["W"].shape[1], block_pairs,
                       ring_depth=ring_depth)
    return params, run_plan_plain(params, plan, lr, B), ids


def run_chain_plain(params: dict, centers: torch.Tensor, contexts: torch.Tensor,
                    ids: torch.Tensor, runs: tuple, lr: float, blk: int) -> torch.Tensor:
    """The step K5 and K6 compute from the block sorts ``runs``
    (:func:`~repro_torch.kernels.sgns_fused_hbm.block_sorts`), in torch, as
    the kernel does: per block of ``blk`` pairs, the pairs' grads from the
    table rows as of block start, then the C runs and the W runs added to
    their rows in place, each in sorted order — a row's element order (W
    at centers; C at contexts, then at negatives). The hot tier changes no
    value, so this is K6's function at every ``hot_rows``. Updates
    ``params`` in place; returns the loss ``(n, B)``."""
    from repro_torch.core.sgns import sparse_row_grads_per_pair

    W, C = params["W"], params["C"]
    n, V, d = W.shape
    B, K = centers.shape[1], ids.shape[-1]
    w_keys, w_perm, c_keys, c_perm = runs
    device = W.device
    neg_lr = -float(np.float32(lr))
    loss = torch.empty((n, B), dtype=torch.float32, device=device)
    off = torch.arange(n, device=device)[:, None] * V
    worker = torch.arange(n, device=device)[:, None]
    Wf, Cf = W.view(n * V, d), C.view(n * V, d)
    for p0 in range(0, B, blk):
        nb = min(blk, B - p0)
        cen = (centers[:, p0:p0 + nb].long() + off).reshape(-1)
        ctx = (contexts[:, p0:p0 + nb].long() + off).reshape(-1)
        neg = (ids[:, p0:p0 + nb].reshape(n, nb * K).long() + off).reshape(-1)
        pair_loss, d_w, d_cp, d_cn = sparse_row_grads_per_pair(
            Wf[cen], Cf[ctx], Cf[neg].view(n * nb, K, d))
        loss[:, p0:p0 + nb] = pair_loss.view(n, nb)
        # each table's addends by element: C's index concat(contexts, ids)
        # (x < B: the context of pair x; else negative x - B = p·K + k)
        u_c = torch.cat([(neg_lr * d_cp).view(n, nb, d),
                         (neg_lr * d_cn).reshape(n, nb * K, d)], 1)
        s0, s1 = p0 * (K + 1), (p0 + nb) * (K + 1)
        x = c_perm[:, s0:s1]
        el = torch.where(x < B, x - p0, nb + x - B - p0 * K)
        Cf.index_add_(0, (c_keys[:, s0:s1].long() + off).reshape(-1),
                      u_c[worker, el].reshape(-1, d))
        u_w = (neg_lr * d_w).view(n, nb, d)
        Wf.index_add_(0, (w_keys[:, p0:p0 + nb].long() + off).reshape(-1),
                      u_w[worker, w_perm[:, p0:p0 + nb] - p0].reshape(-1, d))
    return loss


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------
def run_chain(params: dict, centers: torch.Tensor, contexts: torch.Tensor,
              ids: torch.Tensor, runs: tuple, lr: float, blk: int, *,
              hot_rows: int = 0) -> torch.Tensor:
    """Launch K5 (``hot_rows == 0``) or K6 once for every worker on the
    step's draw ``ids`` ``(n, B, K)`` and block sorts ``runs``
    (:func:`~repro_torch.kernels.sgns_fused_hbm.block_sorts` at ``blk``):
    one persistent launch walks each worker's blocks in place in the
    tables, a group of CTAs a worker. Updates ``params`` in place; returns
    the loss ``(n, B)``."""
    W, C = params["W"], params["C"]
    device = W.device
    _kernel_device(device)
    n, V, d = W.shape
    B, K = centers.shape[1], ids.shape[-1]
    kH = int(hot_rows)
    name = "sgns_fused_tiered" if kH else "sgns_fused_pipe"
    symbol = "sgns_tiered_launch" if kH else "sgns_pipe_launch"
    w_keys, w_perm, c_keys, c_perm = runs
    f32 = dict(dtype=torch.float32, device=device)
    loss = torch.empty((n, B), **f32)
    coef = torch.empty((n, blk, K + 1), **f32)
    dW = torch.empty((n, blk, d), **f32)
    wrows = torch.empty((n, blk, d), **f32)
    arrive = torch.empty((n,), dtype=torch.int32, device=device)
    vec4 = int(d % 4 == 0 and W.data_ptr() % 16 == 0 and C.data_ptr() % 16 == 0)
    fn = _entry(name, symbol)
    with torch.cuda.device(device):
        err = fn(_ptr(W), _ptr(C), _ptr(loss), _ptr(centers), _ptr(contexts), _ptr(ids),
                 _ptr(w_keys), _ptr(w_perm), _ptr(c_keys), _ptr(c_perm), _ptr(coef),
                 _ptr(dW), _ptr(wrows), _ptr(arrive), n, V, d, B, K, blk, kH,
                 -float(np.float32(lr)), vec4, _stream(device))
    _raise_on(err, f"{name}_step")
    LAUNCHES[f"{name}_step"] += 1
    return loss


def check_step_args(params: dict, centers: torch.Tensor, contexts: torch.Tensor,
                    table: dict, seeds: torch.Tensor, negatives: int,
                    block_pairs: int, ring_depth: int) -> None:
    """The argument checks of the block-chain wrappers (K5, K6)."""
    W, C = params["W"], params["C"]
    device = W.device
    n, V, d = W.shape
    B = centers.shape[-1]
    if not 1 <= int(negatives) <= MAX_NEGATIVES:
        raise ValueError(f"negatives must be in [1, {MAX_NEGATIVES}], got {negatives}")
    if int(block_pairs) < 1:
        raise ValueError(f"block_pairs must be >= 1, got {block_pairs}")
    if int(ring_depth) < 2:
        raise ValueError(f"ring_depth must be >= 2, got {ring_depth}")
    _check(W, "W", torch.float32, (n, V, d), device)
    _check(C, "C", torch.float32, (n, V, d), device)
    _check(centers, "centers", torch.int32, (n, B), device)
    _check(contexts, "contexts", torch.int32, (n, B), device)
    _check(table["prob"], "prob", torch.float32, (n, V), device)
    _check(table["alias"], "alias", torch.int32, (n, V), device)
    _check(seeds, "seeds", torch.int32, (n, 2), device)


def sgns_fused_pipe_step(params: dict, centers: torch.Tensor,
                         contexts: torch.Tensor, table: dict, seeds: torch.Tensor,
                         lr: float, *, negatives: int = 5, block_pairs: int = 256,
                         ring_depth: int = NUM_SLOTS):
    """K5: one SGNS step for every worker as a chain of pair blocks.
    ``params`` ``{"W", "C"}`` ``(n, V, d)`` float32 are
    updated **in place**; ``centers``/``contexts`` ``(n, B)`` int32 ids in
    ``[0, V)`` (not bounds-checked; the trainer checks each chunk);
    ``table`` the stacked ``{"prob", "alias"}`` alias tables; ``seeds``
    ``(n, 2)``; ``lr`` the step's learning rate; ``ring_depth`` the
    reference's ring depth (>= 2): the plain version's hazard look-behind.
    It never changes the result, and the card's path, which has no ring,
    takes no note of it.

    Returns ``(params, loss (n, B), ids (n, B, K))``, bitwise those of
    :func:`~repro_torch.kernels.sgns_fused_hbm.sgns_fused_hbm_step` at the
    same ``block_pairs`` on the card.
    """
    check_step_args(params, centers, contexts, table, seeds, negatives, block_pairs,
                    ring_depth)
    device = params["W"].device
    if device.type == "cpu":
        return sgns_fused_pipe_step_plain(params, centers, contexts, table, seeds, lr,
                                          negatives=int(negatives),
                                          block_pairs=block_pairs,
                                          ring_depth=ring_depth)
    return params, *chain_step(params, centers, contexts, table, seeds, lr,
                               negatives=int(negatives), block_pairs=block_pairs)


def chain_step(params: dict, centers: torch.Tensor, contexts: torch.Tensor,
               table: dict, seeds: torch.Tensor, lr: float, *, negatives: int,
               block_pairs: int, hot_rows: int = 0):
    """The card's path of K5 and K6: K1's draw, K4a's two block sorts, one
    :func:`run_chain` launch. Returns ``(loss (n, B), ids (n, B, K))``."""
    device = params["W"].device
    _kernel_device(device)
    B = centers.shape[-1]
    ids = sample_negatives(seeds, table["prob"], table["alias"], (B, negatives))
    blk = pick_block_pairs(B, block_pairs)
    runs = block_sorts(centers, contexts, ids, blk, params["W"].shape[1])
    return run_chain(params, centers, contexts, ids, runs, lr, blk, hot_rows=hot_rows), ids
