"""Contract certifier for the registered engines: what the program
actually dispatches, read from ``torch.profiler``.

The counterpart of ``repro.analysis.contracts``. Torch has no HLO to walk,
so the certificates run the code and read the profile:

* :class:`CollectiveRecorder` / :func:`count_collective_ops` — run a region
  under ``torch.profiler.profile`` (CPU activity, plus CUDA activity when a
  GPU is present) and count the collectives it made: dispatcher ops in the
  ``c10d::`` namespace (every ``torch.distributed`` collective dispatches
  one, whatever the backend) and device kernels whose name contains
  ``nccl``. Only op and kernel names count: a ``record_function`` label or
  a string that mentions a collective does not.
* :func:`certify_zero_collective` — the paper's headline property, zero
  parameter synchronization in training: raises :class:`ContractViolation`
  on any collective.
* :func:`certify_tables_in_place` — the counterpart of
  ``certify_table_aliasing``: one engine step keeps both ``(V, d)`` tables
  in their storage (same ``data_ptr()`` and shape, the returned tables the
  same storages, the update landed in them) and makes no table-shaped copy
  of ``V·d`` elements or more.
* :func:`certify_bench_traffic` — recomputes the ``@zipf50k`` planner row
  traffic with :mod:`repro_torch.analysis.workloads` and certifies it
  equals the committed ``BENCH_wallclock.json`` rows (read only).

``repro_torch.core.async_trainer.assert_no_collectives`` and
``count_collective_ops`` delegate here.

Standalone: ``python -m repro_torch.analysis.contracts [--device cpu]``
certifies every registered engine × sampler (the GPU by default).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch

#: The ``c10d::`` dispatcher ops the ``torch.distributed`` collectives
#: record, seen in the profiler on torch 2.13 with gloo (the CPU) and
#: NCCL (the GPU) alike: the op is the backend-independent dispatcher
#: entry; the backend shows only as a ``gloo:``/``nccl:`` label beside it.
#: Any ``c10d::`` op counts, listed or not.
C10D_COLLECTIVE_OPS = (
    "c10d::allreduce_", "c10d::allreduce_coalesced_", "c10d::allgather_",
    "c10d::_allgather_base_", "c10d::allgather_coalesced_",
    "c10d::allgather_into_tensor_coalesced_", "c10d::reduce_scatter_",
    "c10d::_reduce_scatter_base_", "c10d::reduce_scatter_tensor_coalesced_",
    "c10d::alltoall_", "c10d::alltoall_base_", "c10d::broadcast_",
    "c10d::reduce_", "c10d::gather_", "c10d::scatter_", "c10d::send",
    "c10d::recv_", "c10d::barrier",
)


class ContractViolation(AssertionError):
    """A certified contract does not hold. Subclasses AssertionError, as
    the reference's does."""


def _on_device(ev) -> bool:
    return ev.device_type() == torch.autograd.DeviceType.CUDA


def collective_counts(events) -> dict[str, int]:
    """Collectives by name in a profile's raw events
    (``prof.profiler.kineto_results.events()``): ``c10d::`` ops on the
    host, kernels whose name contains ``nccl`` on the device. User
    annotations (``record_function`` labels, among them the backends' own
    ``gloo:``/``nccl:`` labels, on the host or the device) are not ops and
    never count."""
    out: dict[str, int] = {}
    for ev in events:
        if ev.is_user_annotation():
            continue
        name = ev.name()
        if (name.startswith("c10d::") and not _on_device(ev)) or \
                (_on_device(ev) and "nccl" in name.lower()):
            out[name] = out.get(name, 0) + 1
    return out


class CollectiveRecorder:
    """Context manager: profile the block and count its collectives.

    ``cuda`` — also record device activity (default: when a GPU is
    present). After the block, :attr:`counts` holds the collectives by
    name, :attr:`device_kernels` the number of device events (kernels
    and copies) seen in all, so a caller can tell that device activity was
    recorded, and :attr:`device_busy_us` the union of their intervals. The
    raw events are read directly: building the profiler's Python event tree
    would cost seconds a run."""

    def __init__(self, cuda: bool | None = None):
        self.cuda = torch.cuda.is_available() if cuda is None else bool(cuda)
        self.counts: dict[str, int] = {}
        self.device_kernels = 0
        self.device_busy_us = 0.0
        self._prof = None

    def __enter__(self) -> "CollectiveRecorder":
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        events = self._prof.profiler.kineto_results.events()
        self.counts = collective_counts(events)
        spans = sorted((ev.start_ns(), ev.end_ns()) for ev in events
                       if _on_device(ev) and not ev.is_user_annotation())
        self.device_kernels = len(spans)
        busy, end = 0, None
        for s, f in spans:
            if end is None or s > end:
                busy += f - s
                end = f
            elif f > end:
                busy += f - end
                end = f
        self.device_busy_us = busy / 1e3


def count_collective_ops(fn, *args, cuda: bool | None = None, **kwargs) -> dict[str, int]:
    """Collectives by name that ``fn(*args, **kwargs)`` makes."""
    with CollectiveRecorder(cuda) as rec:
        fn(*args, **kwargs)
    return rec.counts


def certify_zero_collective(fn_or_counts, label: str = "") -> dict[str, int]:
    """Certify a region made zero collectives: ``fn_or_counts`` is a
    callable (run under :class:`CollectiveRecorder`) or counts already
    recorded. Returns the (empty) counts; raises :class:`ContractViolation`
    on any hit."""
    hits = (count_collective_ops(fn_or_counts) if callable(fn_or_counts)
            else dict(fn_or_counts))
    hits = {k: v for k, v in hits.items() if v}
    if hits:
        where = f" [{label}]" if label else ""
        raise ContractViolation(
            f"zero-collective contract violated{where}: found "
            f"{dict(sorted(hits.items()))}")
    return hits


# ---------------------------------------------------------------------------
# The (V, d) tables updated in place.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InPlaceReport:
    engine: str
    vocab_size: int
    dim: int
    tables_in_place: int          # tables kept in their storage and updated there
    largest_copy: int             # elements of the largest table-shaped copy (0: none)


def _noise_table(kind: str, V: int, n: int, device):
    from repro_torch.data.pairs import stack_noise_tables

    counts = (np.arange(V, 0, -1) ** 2).astype(np.int64)        # frequency-sorted
    table = stack_noise_tables([counts] * n, kind=kind)
    return ({k: v.to(device) for k, v in table.items()} if isinstance(table, dict)
            else table.to(device))


def _ids(V: int, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, V, size=shape).astype(np.int32)


def _table_copy_elements(events, V: int, n: int, d: int) -> int:
    """Elements of the largest table-shaped ``aten::copy_`` in a profile:
    a destination of at least ``V·d`` elements with a ``V`` (or ``n·V``)
    axis. Clones, ``contiguous`` and device moves all copy through
    ``copy_``; copies of a step's gathered rows have no such axis."""
    largest = 0
    for e in events:
        if e.name != "aten::copy_" or not e.input_shapes or not e.input_shapes[0]:
            continue
        shape = [int(x) for x in e.input_shapes[0]]
        numel = int(np.prod(shape))
        if numel >= V * d and (V in shape or n * V in shape):
            largest = max(largest, numel)
    return largest


def certify_tables_in_place(engine_spec, *, vocab_size: int = 150, dim: int = 32,
                            negatives: int = 4, batch: int = 64, num_workers: int = 2,
                            total_steps: int = 100, device=None) -> InPlaceReport:
    """Run one step of ``engine_spec`` on ``num_workers`` stacked ``(V, d)``
    tables on ``device`` (the GPU unless ``"cpu"``) and certify the update
    is genuinely in place: both tables keep their ``data_ptr()`` and shape,
    the step returns the same storages, both changed there, and the profile
    shows no table-shaped copy of ``V·d`` elements or more. A step that copies or re-lays out the
    tables fails with an "aliasing" :class:`ContractViolation`."""
    from repro_torch import prng
    from repro_torch.core.engine import get_engine
    from repro_torch.core.sgns import SGNSConfig
    from repro_torch.device import resolve_device
    from repro_torch.kernels.sgns_fused import seed_tensor

    dev = resolve_device(device)
    engine = get_engine(engine_spec)
    cfg = SGNSConfig(vocab_size=vocab_size, dim=dim, negatives=negatives)
    engine.validate(vocab_size=vocab_size)
    step = engine.make_step(cfg, total_steps)
    n, V, d = num_workers, vocab_size, dim
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {k: 0.1 * torch.rand((n, V, d), generator=gen, device=dev) - 0.05
              for k in ("W", "C")}
    before = {k: (t.data_ptr(), tuple(t.shape), t.clone()) for k, t in params.items()}
    table = _noise_table(engine.table_kind, V, n, dev)
    centers = torch.from_numpy(_ids(V, (n, batch), 1)).to(dev)
    contexts = torch.from_numpy(_ids(V, (n, batch), 2)).to(dev)
    seeds = seed_tensor(prng.split(prng.PRNGKey(3), n), dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        out, _ = step(params, centers, contexts, table, seeds, 0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    largest = _table_copy_elements(prof.events(), V, n, d)
    kept = 0
    problems = []
    for k, (ptr, shape, old) in before.items():
        got = out[k]
        same = (params[k].data_ptr() == ptr and tuple(params[k].shape) == shape
                and got.data_ptr() == ptr and tuple(got.shape) == shape
                and got.untyped_storage().data_ptr() == params[k].untyped_storage().data_ptr())
        if not same:
            problems.append(f"{k} returned at {tuple(got.shape)} in another storage")
        elif torch.equal(params[k], old):
            problems.append(f"{k} unchanged in its storage")
        else:
            kept += 1
    if largest >= V * d:
        problems.append(f"the step copied a table of {largest} elements (V·d = {V * d})")
    rep = InPlaceReport(engine.describe(), V, d, kept, largest)
    if problems:
        raise ContractViolation(
            f"table-aliasing contract violated [{rep.engine}]: "
            + "; ".join(problems) + " — the (V, d) tables are not updated in place")
    return rep


# ---------------------------------------------------------------------------
# Whole-engine certification (one chunk collective-free + tables in place).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class EngineContractReport:
    engine: str
    zero_collective: bool
    device_kernels: int           # device kernels the chunk launched (0 on the CPU)
    in_place: InPlaceReport


def certify_engine_contracts(engine_spec, *, vocab_size: int = 150, dim: int = 32,
                             negatives: int = 4, steps: int = 4, batch: int = 64,
                             num_workers: int = 2, device=None) -> EngineContractReport:
    """Zero collectives over one chunk of ``steps`` steps through
    :meth:`AsyncShardTrainer.epoch`, and the tables in place over one step,
    for one engine on ``device`` (the GPU unless ``"cpu"``). Raises
    :class:`ContractViolation`."""
    from repro_torch import prng
    from repro_torch.core.async_trainer import AsyncShardTrainer
    from repro_torch.core.engine import get_engine
    from repro_torch.core.sgns import SGNSConfig

    engine = get_engine(engine_spec)
    tr = AsyncShardTrainer(cfg=SGNSConfig(vocab_size=vocab_size, dim=dim,
                                          negatives=negatives),
                           num_workers=num_workers, total_steps=steps, engine=engine,
                           device=device)
    params = tr.init(prng.PRNGKey(0))
    table = _noise_table(engine.table_kind, vocab_size, num_workers, tr.device)
    shape = (num_workers, steps, batch)
    centers, contexts = _ids(vocab_size, shape, 4), _ids(vocab_size, shape, 5)
    with CollectiveRecorder(tr.device.type == "cuda") as rec:
        tr.epoch(params, centers, contexts, table, prng.PRNGKey(1))
    certify_zero_collective(rec.counts, label=f"{engine.describe()} chunk")
    rep = certify_tables_in_place(engine, vocab_size=vocab_size, dim=dim,
                                  negatives=negatives, batch=batch,
                                  num_workers=num_workers, device=tr.device)
    return EngineContractReport(engine.describe(), True, rec.device_kernels, rep)


def engine_matrix(vocab_size: int) -> list:
    """Every registered engine × its samplers: ``dense``, ``sparse`` and
    ``rowgrad`` on ``cdf`` and ``alias``; the fused family on ``alias``,
    ``fused_hbm`` in blocks and sequential, ``fused_tiered``'s hot tier
    fitted inside ``vocab_size``."""
    from repro_torch.core.engine import ENGINE_NAMES, get_engine

    out = []
    for name in ENGINE_NAMES:
        if name in ("dense", "sparse", "rowgrad"):
            out += [get_engine(f"{name}:{s}") for s in ("cdf", "alias")]
        elif name == "fused_tiered":
            out.append(get_engine(name, hot_rows=min(256, vocab_size // 4)))
        else:
            out.append(get_engine(name))
        if name == "fused_hbm":
            out.append(get_engine(name, sequential=True))
    return out


# ---------------------------------------------------------------------------
# Planner-predicted row traffic vs the committed bench baseline.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TrafficReport:
    engine: str
    predicted_rows: int
    baseline_rows: int


def certify_bench_traffic(baseline_path: str = "BENCH_wallclock.json", *,
                          device=None) -> list[TrafficReport]:
    """Recompute the ``@zipf50k`` per-step row traffic with the port's
    planner on ``device`` (the GPU unless ``"cpu"``) and certify it matches
    the rows of the committed baseline (only read): the planner and the
    gated numbers cannot drift apart silently."""
    from repro_torch.analysis.workloads import ZIPF50K, zipf50k_row_traffic

    with open(baseline_path) as f:
        rows = {r["engine"]: r for r in json.load(f)
                if "hbm_rows_per_step" in r}
    if not rows:
        raise ContractViolation(
            f"no @zipf50k traffic rows found in {baseline_path}")
    reports = []
    for name, hot in (("pallas_fused_pipe", 0),
                      ("pallas_fused_tiered", ZIPF50K["HOT"])):
        key = f"{name}@zipf50k"
        if key not in rows:
            raise ContractViolation(f"baseline row {key!r} missing from "
                                    f"{baseline_path}")
        predicted = zipf50k_row_traffic(hot_rows=hot, device=device)
        baseline = int(rows[key]["hbm_rows_per_step"])
        if predicted != baseline:
            raise ContractViolation(
                f"DMA-traffic contract violated [{key}]: planner predicts "
                f"{predicted} rows/step, committed baseline carries "
                f"{baseline}")
        reports.append(TrafficReport(key, predicted, baseline))
    return reports


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default="BENCH_wallclock.json")
    ap.add_argument("--skip-traffic", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the plain versions)")
    args = ap.parse_args(argv)
    V = 150
    ok = True
    for eng in engine_matrix(V):
        label = eng.describe() + (" sequential" if getattr(eng, "sequential", False) else "")
        try:
            certify_engine_contracts(eng, vocab_size=V, steps=2, batch=32,
                                     device=args.device)
            print(f"contracts: {label:24s} zero-collective ✓  tables-in-place ✓")
        except ContractViolation as e:
            ok = False
            print(f"contracts: {label:24s} FAILED: {e}")
    if not args.skip_traffic:
        try:
            for r in certify_bench_traffic(args.baseline, device=args.device):
                print(f"contracts: {r.engine:24s} planner traffic "
                      f"{r.predicted_rows} rows/step == baseline ✓")
        except (ContractViolation, FileNotFoundError) as e:
            ok = False
            print(f"contracts: traffic FAILED: {e}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
