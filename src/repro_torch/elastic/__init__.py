"""Elastic, preemption-tolerant training (the counterpart of ``repro.elastic``).

Deterministic mid-epoch checkpoint/resume (:mod:`~repro_torch.elastic.cursor`,
:mod:`~repro_torch.elastic.store`), seeded fault injection over the
in-process multi-host simulation (:mod:`~repro_torch.elastic.faults`),
per-worker elastic training with work-stealing
(:mod:`~repro_torch.elastic.runner`), and — via the ``Merger`` registry's
quorum/deadline dials — merge-from-whatever-finished. The tables stay on
the GPU unless ``device="cpu"`` is given.
"""

from repro_torch.elastic.cursor import WorkerCursor
from repro_torch.elastic.faults import FaultEvent, FaultSchedule
from repro_torch.elastic.runner import (
    ElasticRunner, SimulationResult, merge_finished, simulate_elastic,
    train_submodels_elastic)
from repro_torch.elastic.store import WorkerStateStore

__all__ = [
    "WorkerCursor", "WorkerStateStore", "FaultEvent", "FaultSchedule",
    "ElasticRunner", "SimulationResult", "merge_finished",
    "simulate_elastic", "train_submodels_elastic",
]
