"""The launch that K2 (``sgns_fused_step``) and K4a (``sgns_fused_hbm_step``
with ``sequential=False``) share, its shape, and the plain mirrors of its
draw and its apply items.

Source: ``repro_torch/csrc/sgns_block_step.cuh`` (included by
``sgns_fused_step.cu`` and ``sgns_fused_hbm.cu``). One persistent
cooperative launch runs a step's chain of pair blocks for every worker,
the negative draw included: a group of CTAs a worker; in the first phase
some of the group's CTAs sort each (block, table) list of the worker's
touched rows while the others make the worker's draw (written out for the
wrappers to return) and then run the first block's pairs, each pair warp
drawing its own negatives again; then, per block, the pairs phase, a group
barrier, the applies, a group barrier. K2 is the chain with one block of
all B pairs.

What the CPU can check lies here, in Python:

* :func:`list_rows` — a sort task's list in element order, its negatives
  drawn at their counters as the launch's draw pass draws them;
* :func:`geometry` — groups, CTAs a group and the sorting CTAs, as the
  launch is sized (``SMEM_BYTES`` of dynamic shared memory a CTA);
* :func:`apply_items` — the apply's item rule: whole runs of a sorted list
  and a column chunk, a run of at least ``SPLIT_RUNS`` addends on its own
  in chunks of 32 columns, the shorter runs grouped by the window of 32
  positions their heads lie in.

The in-launch sort is checked on the card, bitwise against
:func:`~repro_torch.kernels.sgns_fused_hbm.block_sorts` (``scratch=True``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

WARPS = 8                  # warps a CTA
WARP_BYTES = 14336         # a warp's shared-memory region
SMEM_BYTES = WARPS * WARP_BYTES
STATIC_SMEM_BYTES = 8 * 4 * 8 + 4 * 8   # the ring's mbarriers and the scan's warp sums
STAGES = 4                 # apply ring stages a warp
NARROW = 32                # columns of a hot run's chunk
ITEM_WINDOW = 32           # sorted positions whose short runs share an item
MIN_GROUP = 8              # CTAs a worker's group has at least, where the card has them
CTAS_PER_SM = 2
#: Runs of at least this many addends are applied in chunks of 32 columns
#: (``kSplitRuns`` in the kernel, a compile-time constant).
SPLIT_RUNS = 32


def list_rows(centers: torch.Tensor, contexts: torch.Tensor, table: dict,
              seeds: torch.Tensor, K: int, blk: int, b: int, c_table: bool) -> torch.Tensor:
    """The rows of block ``b``'s C list (``c_table``) or W list, ``(n, N)``
    int32 in element order, as a sort task loads them: W, the block's
    centers; C, its contexts, then its negatives, element ``e >= nb`` the
    draw pass's draw at counter ``p0 K + (e - nb)`` (``index_of(e) - B``)
    under each worker's seed and alias table."""
    from repro_torch.kernels.sgns_fused import alias_draw_from_counters

    n, B = centers.shape
    p0 = b * blk
    nb = min(blk, B - p0)
    if not c_table:
        return centers[:, p0:p0 + nb]
    e = torch.arange(nb, nb * (K + 1), dtype=torch.int64, device=centers.device)
    negs = alias_draw_from_counters(seeds, table["prob"], table["alias"],
                                    (p0 * K + e - nb).expand(n, -1))
    return torch.cat([contexts[:, p0:p0 + nb], negs], 1)


class Geometry(NamedTuple):
    blk: int             # pairs a block (clamped to B)
    nblocks: int
    group_ctas: int      # CTAs a worker's group
    groups: int          # groups (a group takes workers g, g + groups, ...)
    sorters: int         # CTAs of a group that sort in the first phase


def geometry(n: int, d: int, B: int, K: int, blk: int, sms: int, vec4: bool = True) -> Geometry:
    """The launch's shape on a card of ``sms`` SMs holding ``CTAS_PER_SM``
    CTAs each: about (CTAs the card holds) / n CTAs a worker, at least
    ``MIN_GROUP``, at most what a block's pairs or apply windows can use;
    half a group's CTAs (at most one a sort task) sort in the first phase."""
    blk = max(1, min(int(blk), B))
    nblocks = -(-B // blk)
    capacity = CTAS_PER_SM * sms
    chunks = -(-d // (4 * 32 if vec4 else 32))
    items = (-(-blk * (K + 1) // ITEM_WINDOW) + -(-blk // ITEM_WINDOW)) * chunks
    cap = -(-max(blk, items) // WARPS)
    per = max(capacity // n, MIN_GROUP)
    per = max(1, min(per, cap, capacity))
    groups = min(n, capacity // per)
    sorters = min(2 * nblocks, max(1, per // 2))
    return Geometry(blk, nblocks, per, groups, sorters)


def apply_items(rows: np.ndarray, d: int, vec4: bool = True, split: int = SPLIT_RUNS,
                s0: int = 0) -> np.ndarray:
    """The apply items of one block's sorted list ``rows`` (its rows in
    sorted order), as the kernel makes them: ``(m, 4)`` int rows of
    (first position + ``s0``, positions, first column, columns a chunk), in
    list order. An item holds whole runs: a run of at least ``split``
    addends on its own, in chunks of 32 columns; otherwise the runs whose
    heads share a window of 32 positions, in chunks of 32·4 columns (32 on
    the scalar path, which takes no narrower chunks). A group of short runs
    also ends where a long run begins, and a long run's successor starts a
    new group."""
    rows = np.asarray(rows)
    N = len(rows)
    T = split if vec4 else 1 << 30
    wide = 128 if vec4 else 32
    cw, cn = -(-d // wide), -(-d // NARROW)

    def head(q):
        return q == 0 or rows[q] != rows[q - 1]

    def long_head(q):
        return T <= N - q and rows[q + T - 1] == rows[q]

    def starts(q):
        if not head(q):
            return False
        if q == 0 or long_head(q):
            return True
        if q >= T and rows[q - T] == rows[q - 1]:
            return True
        ws = q & ~(ITEM_WINDOW - 1)
        return q == ws or (not head(ws) and rows[ws] == rows[q - 1])

    items = []
    for q in range(N):
        if not starts(q):
            continue
        if long_head(q):
            end = q + 1
            while end < N and rows[end] == rows[q]:
                end += 1
            width, chunks = NARROW, cn
        else:
            ws = q & ~(ITEM_WINDOW - 1)
            end = q + 1
            while end < N and not (head(end) and (end >= ws + ITEM_WINDOW or long_head(end))):
                end += 1
            width, chunks = wide, cw
        items += [(s0 + q, end - q, c * width, width) for c in range(chunks)]
    return np.array(items, dtype=np.int64).reshape(-1, 4)


@functools.lru_cache(maxsize=8)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _align(x: int, a: int = 256) -> int:
    return -(-x // a) * a


def sort_need(N: int) -> int:
    """Bytes a sort task of ``N`` entries takes (csrc's ``sort_need``): its
    rows, three int arrays and the digit counters. A task whose need exceeds
    ``SMEM_BYTES`` sorts in its slice of global scratch (``sort_mem``)."""
    return 16 * N + 16 * WARPS * 32 * 4


def sort_task_bytes(blk: int, K: int) -> int:
    """Each sort task's slice of ``sort_mem``: a block's C list, aligned."""
    return _align(sort_need(blk * (K + 1)))


def launch_scratch(n: int, d: int, B: int, K: int, geo: Geometry) -> dict:
    """The device scratch one launch takes, ``{name: (dtype, shape)}``, in
    the order :func:`run_block_step` lays it out in one buffer."""
    blk, nblocks = geo.blk, geo.nblocks
    Lc = B * (K + 1)
    item_cap = blk * (K + 1) * -(-d // NARROW)
    return {
        "coef": (torch.float32, (n, blk, K + 1)), "dW": (torch.float32, (n, blk, d)),
        "wrows": (torch.float32, (n, blk, d)), "w_rows": (torch.int32, (n, B)),
        "w_perm": (torch.int64, (n, B)), "c_rows": (torch.int32, (n, Lc)),
        "c_perm": (torch.int64, (n, Lc)), "items": (torch.int32, (n, nblocks, 2, item_cap, 4)),
        "n_items": (torch.int32, (n, nblocks, 2)),
        "counters": (torch.int32, (geo.groups + n * (nblocks + 1),)),
        "sort_mem": (torch.uint8, (n, 2 * nblocks, sort_task_bytes(blk, K))),
    }


def run_block_step(lib: str, symbol: str, counter: str, params: dict, centers: torch.Tensor,
                   contexts: torch.Tensor, table: dict, seeds: torch.Tensor, lr: float,
                   blk: int, K: int, *, scratch: bool = False):
    """One launch of K2 (``lib="sgns_fused_step"``, ``blk >= B``) or K4a
    (``lib="sgns_fused_hbm"``), which draws the step's ``K`` negatives a
    pair from the alias ``table`` under ``seeds`` itself: updates
    ``params`` in place, adds one to ``LAUNCHES[counter]`` and returns the
    loss ``(n, B)`` and the draw ``(n, B, K)``; with ``scratch``, also the
    launch's sorted lists ``(w_rows, w_perm, c_rows, c_perm)``
    (``block_sorts``' layout) and its items ``(n, nblocks, 2, cap, 4)`` with
    their counts ``(n, nblocks, 2)``."""
    from repro_torch.kernels.sgns_fused import (
        LAUNCHES, _entry, _kernel_device, _ptr, _raise_on, _stream)

    W, C = params["W"], params["C"]
    device = W.device
    _kernel_device(device)
    n, V, d = W.shape
    B = centers.shape[1]
    vec4 = d % 4 == 0 and W.data_ptr() % 16 == 0 and C.data_ptr() % 16 == 0
    geo = geometry(n, d, B, K, blk, _sms(device), vec4)
    blk, nblocks = geo.blk, geo.nblocks
    item_cap = blk * (K + 1) * -(-d // NARROW)
    sort_bytes = sort_task_bytes(blk, K)
    parts = launch_scratch(n, d, B, K, geo)
    offsets, total = {}, 0
    for name, (dt, shape) in parts.items():
        offsets[name] = total
        total = _align(total + int(np.prod(shape)) * dt.itemsize)
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    loss = torch.empty((n, B), dtype=torch.float32, device=device)
    ids = torch.empty((n, B, K), dtype=torch.int32, device=device)
    base = buf.data_ptr()
    ptr = {k: ctypes.c_void_p(base + off) for k, off in offsets.items()}
    fn = _entry(lib, symbol)
    with torch.cuda.device(device):
        err = fn(_ptr(W), _ptr(C), _ptr(loss), _ptr(centers), _ptr(contexts), _ptr(ids),
                 _ptr(seeds), _ptr(table["prob"]), _ptr(table["alias"]), ptr["w_rows"], ptr["w_perm"], ptr["c_rows"], ptr["c_perm"], ptr["coef"],
                 ptr["dW"], ptr["wrows"], ptr["items"], ptr["n_items"], ptr["counters"],
                 ptr["sort_mem"], sort_bytes, item_cap, n, V, d, B, K, blk, geo.group_ctas,
                 geo.groups, geo.sorters, -float(np.float32(lr)), int(vec4),
                 _stream(device))
    _raise_on(err, counter)
    LAUNCHES[counter] += 1
    if not scratch:
        return loss, ids

    def view(name):
        dt, shape = parts[name]
        nbytes = int(np.prod(shape)) * dt.itemsize
        return buf[offsets[name]:offsets[name] + nbytes].view(dt).view(shape)

    lists = tuple(view(k) for k in ("w_rows", "w_perm", "c_rows", "c_perm"))
    return loss, ids, lists, view("items"), view("n_items")
