"""Roofline terms of the paper's workload on one H100: what ``dryrun_sgns``
reports beside each case's measured device time.

The counterpart of the SGNS half of ``repro.launch.roofline``. The
reference reads its flops and bytes from the compiled HLO and its
collective bytes by parsing the HLO text, at TPU v5e peaks; torch has no
HLO, so here every term is **counted** from the case's shapes and data
(the least the function must do, whatever its schedule) and divided by the
H100's published peaks (NVIDIA's data sheet, SXM, 700 W):

    compute    = flops / 67e12 FLOP/s (float32 outside the tensor cores)
    memory     = bytes / 3.35e12 B/s (HBM3)
    collective = collective bytes / 450e9 B/s (NVLink, each way a card)

:func:`step_bytes` is the least-bytes model of one fused step (each
distinct touched row of each table read once and written once, the ids,
the loss, the draw's table entries and seeds), shared with
``chip_smoke.py``'s kernel bounds. The HLO half of the reference's module
(``analyze``, ``hlo_cost``) belongs to the seed's LLM scaffolding
(``ROADMAP.md`` queue 1 item 12) and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

PEAK_FLOPS = 67e12          # float32 FLOP/s an H100 SXM, outside the tensor cores
HBM_BW = 3.35e12            # bytes/s an H100 SXM
NVLINK_BW = 450e9           # bytes/s each way a card (900 GB/s in all)


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
class Roofline:
    """One case's counted terms on one card, and its measured device time."""

    arch: str
    shape: str
    flops: float
    bytes: float
    collective_bytes: float = 0.0
    collective_ops: dict = field(default_factory=dict)        # name -> count recorded
    collective_bytes_by_op: dict = field(default_factory=dict)
    measured_s: float | None = None     # the device's busy time (None: not measured)
    model_flops: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> dict:
        return {"arch": self.arch, "shape": self.shape,
                "compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "dominant": self.dominant,
                "bound_s": self.bound_s, "model_flops": self.model_flops,
                "flops": self.flops, "bytes": self.bytes,
                "collective_bytes": self.collective_bytes,
                "collective_ops": dict(self.collective_ops),
                "collective_bytes_by_op": dict(self.collective_bytes_by_op),
                "measured_s": self.measured_s,
                "bound_share": (self.bound_s / self.measured_s
                                if self.measured_s else None)}


def format_table(rows: list[dict]) -> str:
    hdr = (f"{'arch':24s} {'shape':10s} {'compute_s':>11s} {'memory_s':>11s} "
           f"{'collect_s':>11s} {'dominant':>10s} {'measured_s':>11s} {'bound/meas':>10s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        meas = "not measured" if r["measured_s"] is None else f"{r['measured_s']:.3e}"
        share = "" if r["bound_share"] is None else f"{r['bound_share']:.3f}"
        lines.append(f"{r['arch']:24s} {r['shape']:10s} {r['compute_s']:11.3e} "
                     f"{r['memory_s']:11.3e} {r['collective_s']:11.3e} "
                     f"{r['dominant']:>10s} {meas:>11s} {share:>10s}")
    return "\n".join(lines)
