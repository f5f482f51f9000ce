"""Roofline terms on the H100: the SGNS cases ``dryrun_sgns`` measures on
one card, and the LLM dry run's per-rank rows — the counterpart of
``repro.launch.roofline``.

Three terms per case, each the least time of one rank (a card):

    compute    = flops / peak FLOP/s of the case's dtype
                 (989.4e12 bfloat16 on the tensor cores, 67e12 float32)
    memory     = bytes / 3.35e12 B/s (HBM3)
    collective = collective bytes / 450e9 B/s (NVLink, each way a card),
                 the bytes of groups that span pods / 50e9 B/s (one
                 400 Gb/s NIC a card)

The peaks are NVIDIA's data sheet's for the H100 SXM at 700 W (dense,
without sparsity). The LLM rows take their flops, bytes and collectives
from :mod:`repro_torch.launch.op_cost` (a rank's dispatched ops: the
reference reads them from the compiled HLO) and their peak bytes from its
live-storage count (the reference's ``memory_analysis``). For the SGNS
cases every term is **counted** from the case's shapes and data (the least
the function must do, whatever its schedule) and set beside the case's
measured device time. :func:`step_bytes` is the least-bytes model of one
fused step (each distinct touched row of each table read once and written
once, the ids, the loss, the draw's table entries and seeds), shared with
``chip_smoke.py``'s kernel bounds. The reference's HLO text parser
(``parse_collectives``' regexes) has no input here: the collectives come
counted by kind (:class:`CollectiveStats`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from repro_torch.tree import tree_paths

PEAK_FLOPS = 67e12          # float32 FLOP/s an H100 SXM, outside the tensor cores
PEAK_FLOPS_BY_DTYPE = {"float32": PEAK_FLOPS, "bfloat16": 989.4e12}
HBM_BW = 3.35e12            # bytes/s an H100 SXM
NVLINK_BW = 450e9           # bytes/s each way a card (900 GB/s in all)
DCN_BW = 50e9               # bytes/s a card between nodes (one 400 Gb/s NIC)


def unique_rows(ids: torch.Tensor) -> int:
    """Distinct rows per worker of ``ids`` ``(n, ...)``, summed over workers."""
    return sum(int(ids[w].unique().numel()) for w in range(ids.shape[0]))


def step_bytes(centers: torch.Tensor, contexts: torch.Tensor, ids: torch.Tensor,
               d: int) -> int:
    """The least bytes one step of K2's function moves, whatever its
    schedule (K2, K4, K5, K6): each distinct row of each table read once
    and written once, the ids and the loss, the draw's table entries and
    seeds. ``centers``/``contexts`` ``(n, B)``, ``ids`` ``(n, B, K)``."""
    n, B, K = ids.shape
    rows = unique_rows(centers) + unique_rows(torch.cat([contexts, ids.view(n, -1)], 1))
    return 2 * rows * d * 4 + n * B * (4 + 4 + 4) + n * B * K * 8 + n * 8


def sgns_model_flops(pairs: int, negatives: int, dim: int) -> float:
    """The reference's model flops: 2 tables × (K + 1) dot products
    forward and backward, ``6 · pairs · (K + 1) · d``."""
    return 6.0 * pairs * (negatives + 1) * dim


@dataclass
class CollectiveStats:
    bytes_by_op: dict = field(default_factory=dict)
    count_by_op: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())


@dataclass
class Roofline:
    """One case's terms a rank (a card): the reference's fields, the dtype
    whose peak bounds the compute, the matmul-class flops
    (``op_cost``'s), and a measured device time where there is one."""

    arch: str
    shape: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float = 0.0
    collectives: CollectiveStats = field(default_factory=CollectiveStats)
    peak_memory_per_chip: float = 0.0
    model_flops: float = 0.0           # 6·N_active·D global (2·… inference)
    dcn_bytes_per_chip: float = 0.0    # collectives whose group spans pods
    matmul_flops_per_chip: float = 0.0
    dtype: str = "float32"
    measured_s: float | None = None    # the device's busy time (None: not measured)

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS_BY_DTYPE[self.dtype]

    @property
    def memory_s(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def collective_s(self) -> float:
        nvlink = self.collective_bytes_per_chip - self.dcn_bytes_per_chip
        return nvlink / NVLINK_BW + self.dcn_bytes_per_chip / DCN_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def flops_utilization(self) -> float:
        """MODEL_FLOPS / counted flops (global): how much of the traced
        compute is 'useful'; catches remat and redundancy."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "flops_util": self.flops_utilization,
            "hbm_gb_per_chip": self.peak_memory_per_chip / 2**30,
            "collective_ops": dict(self.collectives.count_by_op),
            "collective_bytes_by_op": dict(self.collectives.bytes_by_op),
            "dcn_bytes_per_chip": self.dcn_bytes_per_chip,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "matmul_flops_per_chip": self.matmul_flops_per_chip,
            "dtype": self.dtype, "bound_s": self.bound_s, "measured_s": self.measured_s,
            "bound_share": (self.bound_s / self.measured_s if self.measured_s else None),
        }


def analyze(arch: str, shape: str, cost, chips: int, model_flops: float = 0.0,
            peak_memory: float | None = None, dtype: str = "float32") -> Roofline:
    """The roofline of a rank from an :class:`repro_torch.launch.op_cost
    .Cost` of one traced step (its ``peak_bytes`` unless ``peak_memory``
    is given)."""
    coll = CollectiveStats(bytes_by_op=dict(cost.coll_bytes),
                           count_by_op={k: int(v) for k, v in cost.coll_counts.items()})
    return Roofline(
        arch=arch, shape=shape, chips=chips, flops_per_chip=cost.flops,
        bytes_per_chip=cost.bytes, collective_bytes_per_chip=float(coll.total_bytes),
        collectives=coll,
        peak_memory_per_chip=float(cost.peak_bytes if peak_memory is None else peak_memory),
        model_flops=model_flops, dcn_bytes_per_chip=cost.dcn_bytes,
        matmul_flops_per_chip=cost.matmul_flops, dtype=dtype)


# ---------------------------------------------------------------------------
def count_params(tree) -> int:
    """Elements of every leaf of a parameter tree (tensors, meta ones too)."""
    return sum(math.prod(leaf.shape) for leaf in tree_paths(tree).values())


def active_params(cfg, params_tree) -> float:
    """Active parameter count (MoE: only top_k of num_experts count)."""
    total = 0.0
    for path, leaf in tree_paths(params_tree).items():
        n = math.prod(leaf.shape)
        names = path.split("/")
        if cfg.moe is not None and len(leaf.shape) >= 3 and any(
                x in ("gate", "up", "down") for x in names) and (
                leaf.shape[-3] == cfg.moe.num_experts or
                (len(leaf.shape) >= 4 and leaf.shape[-3] == cfg.moe.num_experts)):
            n = n * cfg.moe.top_k / cfg.moe.num_experts
        total += n
    return total


def model_flops_for(cfg, params_tree, shape) -> float:
    """6·N_active·D (training) or 2·N_active·D (inference fwd only)."""
    n_active = active_params(cfg, params_tree)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n_active * tokens


def format_table(rows: list[dict]) -> str:
    """The reference's table; when a row carries a measured device time
    (``dryrun_sgns`` on a card), two more columns: it, and the bound's
    share of it."""
    measured = any(r.get("measured_s") is not None for r in rows)
    hdr = (f"{'arch':24s} {'shape':12s} {'chips':>5s} {'compute_s':>11s} "
           f"{'memory_s':>11s} {'collect_s':>11s} {'dominant':>10s} "
           f"{'MF/HLO':>7s} {'HBM GB':>7s}")
    if measured:
        hdr += f" {'measured_s':>12s} {'bound/meas':>10s}"
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        line = (f"{r['arch']:24s} {r['shape']:12s} {r['chips']:5d} "
                f"{r['compute_s']:11.3e} {r['memory_s']:11.3e} "
                f"{r['collective_s']:11.3e} {r['dominant']:>10s} "
                f"{r['flops_util']:7.3f} {r['hbm_gb_per_chip']:7.2f}")
        if measured:
            meas, share = r.get("measured_s"), r.get("bound_share")
            line += (f" {'not measured' if meas is None else f'{meas:.3e}':>12s}"
                     f" {'' if share is None else f'{share:.3f}':>10s}")
        lines.append(line)
    return "\n".join(lines)
