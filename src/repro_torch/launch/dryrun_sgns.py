"""The paper's own workload at its production width, run on one card: SGNS
word-embedding training at vocab 300k × dim 500 (``configs/sgns_wiki.py``),
each case with its collectives counted, its device time measured and its
roofline row.

The counterpart of ``repro.launch.dryrun_sgns``, with its cases and flags
plus ``--device``. The reference lowers each case over a 256-chip mesh
without running it; torch has no program to lower, so the port runs each
case for ``--steps`` steps of Zipf(1) ids drawn from a seed, on this
process's share of the workers (one worker a card by default, as the
reference gives one a chip), under
:class:`~repro_torch.analysis.contracts.CollectiveRecorder`:

  async              — ``sparse`` (the reference's ``sparse``, the inverse-CDF draw)
  async_alias        — ``sparse:alias``
  async_pallas       — ``rowgrad`` (K3)
  async_fused        — ``fused`` (K2, the draw inside its launch)
  async_fused_hbm    — ``fused_hbm`` (K4a)
  async_fused_pipe   — ``fused_pipe`` (K1 + K5)
  async_fused_tiered — ``fused_tiered`` (K1 + K6)

  Every async case prints its ``vmem:`` line (:mod:`repro_torch.analysis.vmem`)
  and is asserted to make **zero** collectives.

  sync               — one shared table, the dense gradient all-reduced
                       every step (the paper's strawman: W's and C's
                       gradients, 1.2 GB a step at this width), in a
                       process group of one (NCCL on the card), negatives
                       drawn by the ``fused`` engine's draw (K1);
  local_sgd_k        — parameters averaged every k steps (k = 8, 64): 1/k of
                       the sync case's bytes; local steps by K2;
  merge_alir_iter    — one ALiR iteration over the sub-models, its Grams
                       through ``sharding/merge.py: mesh_sharded_gram`` (one
                       ``all_gather``).

Usage: python -m repro_torch.launch.dryrun_sgns [--json out.json]
       [--cases async,async_alias,...] [--workers N --steps S --batch B]
       [--processes P] [--plan-only] [--vmem-budget-mb MB] [--device cpu]

``--plan-only`` prints the per-process ingestion plans and runs nothing.
On the CPU (``--device cpu``) the cases run their kernels' plain versions;
the tests run them at a small width by replacing :data:`SGNS_CFG`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.analysis.contracts import CollectiveRecorder, certify_zero_collective
from repro_torch.configs.sgns_wiki import CONFIG as SGNS_CFG
from repro_torch.core.engine import get_engine, port_engine_spec
from repro_torch.launch import roofline as rl

WORKERS = 1          # sub-models on this card (the reference: one a chip)
STEPS = 128          # steps a case runs
BATCH = 1024         # pairs a worker a step
SYNC_ENGINE = "fused"   # the synchronous cases' draw (K1) and local steps (K2)

ASYNC_ENGINES = {    # the reference's engine names, resolved by port_engine_spec
    "async": "sparse",
    "async_alias": "sparse:alias",
    "async_pallas": "pallas",
    "async_fused": "pallas_fused",
    "async_fused_hbm": "pallas_fused_hbm",
    "async_fused_pipe": "pallas_fused_pipe",
    "async_fused_tiered": "pallas_fused_tiered",
}
CASES = (*ASYNC_ENGINES, "sync", "local_sgd_8", "local_sgd_64", "merge_alir_iter")


def _zipf(V: int, shape, seed: int) -> np.ndarray:
    p = 1.0 / np.arange(1, V + 1)
    return np.random.default_rng(seed).choice(V, size=shape, p=p / p.sum()).astype(np.int32)


def _noise_counts(V: int) -> np.ndarray:
    """Frequency-sorted Zipf(1) counts: the vocabulary's noise table."""
    return (10_000_000 // np.arange(1, V + 1)).astype(np.int64) + 1


@contextmanager
def _world_of_one(device):
    """The default process group if one exists, else a group of one
    (NCCL on the card, gloo on the CPU) through a file store, destroyed on
    exit."""
    if dist.is_initialized():
        yield dist.group.WORLD
        return
    root = tempfile.mkdtemp(prefix="dryrun_sgns_")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(root, "store"), 1),
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)


def _measure(fn, device):
    """``fn()`` under the collective recorder: (result, counts, the
    device's busy seconds; None off the card: a CPU run measures no device)."""
    with CollectiveRecorder(cuda=device.type == "cuda") as rec:
        out = fn()
    busy = rec.device_busy_us / 1e6 if device.type == "cuda" else None
    return out, {k: v for k, v in rec.counts.items() if v}, busy


def _per_step_us(device_s, steps: int):
    return None if device_s is None else device_s / max(steps, 1) * 1e6


def run_async(case: str, n: int, steps: int, batch: int, device,
              vmem_budget_mb: float = 0.0) -> dict:
    """One async case: ``n`` sub-models at :data:`SGNS_CFG`'s width train
    ``steps`` steps; zero collectives certified."""
    from repro_torch.analysis.vmem import check_vmem_budget, estimate_vmem
    from repro_torch.core.async_trainer import AsyncShardTrainer
    from repro_torch.data.pairs import stack_noise_tables
    from repro_torch.kernels import sgns_fused

    cfg = SGNS_CFG
    V, d, K = cfg.vocab_size, cfg.dim, cfg.negatives
    engine = get_engine(port_engine_spec(ASYNC_ENGINES[case]))
    shape = dict(vocab_size=V, dim=d, negatives=K, batch=batch, workers=n)
    if vmem_budget_mb:
        est = check_vmem_budget(
            engine, budget_bytes=int(vmem_budget_mb * 2 ** 20), **shape,
            device_budget_bytes=(torch.cuda.get_device_properties(device).total_memory
                                 if device.type == "cuda" else None))
    else:
        est = estimate_vmem(engine, **shape)
    print(f"   vmem: {est.summary()}", flush=True)
    trainer = AsyncShardTrainer(cfg=cfg, num_workers=n, total_steps=steps, engine=engine,
                                device=device)
    params = trainer.init(prng.PRNGKey(cfg.seed))
    table = trainer.device_table(stack_noise_tables([_noise_counts(V)] * n,
                                                    kind=engine.table_kind))
    centers, contexts = (torch.from_numpy(_zipf(V, (n, steps, batch), s)) for s in (1, 2))
    key = prng.PRNGKey(3)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    sgns_fused.reset_launch_counts()
    (params, losses), counts, device_s = _measure(
        lambda: trainer.epoch(params, centers, contexts, table, key), device)
    launches = {k: v for k, v in sgns_fused.LAUNCHES.items() if v}
    # every async engine keeps the paper's headline property
    certify_zero_collective(counts, f"sgns/{case}")
    if not torch.isfinite(losses).all():
        raise RuntimeError(f"{case}: non-finite losses")
    # the least bytes each step's function moves, from the negatives it drew
    seeds = sgns_fused.seed_tensor(prng.step_keys(prng.split(key, n), steps)
                                   .transpose(1, 0, 2), device)
    nbytes = 0
    for s in range(steps):
        ids = engine.sample(table, seeds[s], (batch, K)).to(torch.int32)
        nbytes += rl.step_bytes(centers[:, s].to(device), contexts[:, s].to(device), ids, d)
    flops = rl.sgns_model_flops(n * batch * steps, K, d)
    r = rl.Roofline(f"sgns-{case}", f"steps{steps}", 1, flops, nbytes, measured_s=device_s,
                    model_flops=flops)
    row = {**r.row(), "case": case, "engine": engine.describe(), "workers": n,
           "launches": launches, "device_us_per_step": _per_step_us(device_s, steps),
           "vmem": est.summary(), "loss": float(losses.mean())}
    del params, trainer, table
    return row


def run_sync(case: str, n: int, steps: int, batch: int, device) -> dict:
    """``sync``, ``local_sgd_k`` or ``merge_alir_iter`` in the default
    process group (a group of one when there is none): the collectives
    recorded, their bytes counted."""
    from repro_torch.core import sgns
    from repro_torch.core.async_trainer import make_periodic_sync_epoch, make_sync_epoch
    from repro_torch.data.pairs import stack_noise_tables
    from repro_torch.kernels import sgns_fused

    cfg = SGNS_CFG
    V, d, K = cfg.vocab_size, cfg.dim, cfg.negatives
    table_bytes = V * d * 4
    sgns_fused.reset_launch_counts()
    with _world_of_one(device) as group:
        world = dist.get_world_size(group)
        if case == "merge_alir_iter":
            from repro_torch.core.merge import _alir_iteration

            m = max(n, 2)
            gen = torch.Generator(device=device).manual_seed(0)
            models = 0.1 * torch.randn((m, V, d), generator=gen, device=device)
            Y = 0.1 * torch.randn((V, d), generator=gen, device=device)
            mask = torch.ones((m, V), dtype=torch.bool, device=device)
            (Y_new, disp, _), counts, device_s = _measure(
                lambda: _alir_iteration(Y, models, mask, world, group), device)
            if not torch.isfinite(Y_new).all():
                raise RuntimeError("merge_alir_iter: non-finite consensus")
            coll = {"all_gather": world * m * d * d * 4}
            flops = 4.0 * m * V * d * d
            nbytes = (2 * m + 2) * table_bytes
            pairs, steps, extra = 0, 1, {"models": m, "disp": float(disp)}
        else:
            engine = get_engine(SYNC_ENGINE)
            table = stack_noise_tables([_noise_counts(V)], kind=engine.table_kind)
            table = {k: v[0] for k, v in table.items()}
            params = sgns.init_params(prng.PRNGKey(cfg.seed), cfg, device=device)
            key = prng.PRNGKey(3)
            if case == "sync":
                c, x = (torch.from_numpy(_zipf(V, (steps, n * batch), s)) for s in (1, 2))
                fn = make_sync_epoch(cfg, table, steps, group=group, engine=engine,
                                     device=device)
                syncs, per_sync = steps, 2 * table_bytes + 4
            else:
                k = int(case.rsplit("_", 1)[1])
                steps = max(steps // k, 1) * k
                c, x = (torch.from_numpy(_zipf(V, (steps // k, k, n * batch), s))
                        for s in (1, 2))
                fn = make_periodic_sync_epoch(cfg, table, steps, k, num_workers=n,
                                              group=group, engine=engine, device=device)
                syncs, per_sync = steps // k, 2 * table_bytes
            (params, losses), counts, device_s = _measure(
                lambda: fn(params, c, x, key, 0), device)
            if not torch.isfinite(losses).all():
                raise RuntimeError(f"{case}: non-finite losses")
            coll = {"all_reduce": syncs * per_sync + (4 * steps if case != "sync" else 0)}
            pairs = n * batch * steps
            flops = rl.sgns_model_flops(pairs, K, d)
            # the dense apply: each table read, its gradient written and read,
            # the table written, every step (local SGD: n copies, a mean a sync)
            nbytes = steps * 2 * table_bytes * 4 * (1 if case == "sync" else n)
            extra = {"loss": float(losses.mean())}
    launches = {k: v for k, v in sgns_fused.LAUNCHES.items() if v}
    r = rl.Roofline(f"sgns-{case}",
                    "iter1" if case == "merge_alir_iter" else f"steps{steps}", 1, flops,
                    nbytes, sum(coll.values()), rl.CollectiveStats(coll, counts),
                    model_flops=rl.sgns_model_flops(pairs, K, d), measured_s=device_s)
    return {**r.row(), "case": case, "workers": n, "launches": launches,
            "device_us_per_step": _per_step_us(device_s, steps),
            "collective_bytes_per_step": sum(coll.values()) / max(steps, 1), **extra}


def run(case: str, workers: int = WORKERS, steps: int = STEPS, batch: int = BATCH,
        vmem_budget_mb: float = 0.0, device=None) -> dict:
    """One case on ``device`` (the GPU unless ``"cpu"``); returns its row."""
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    t0 = time.perf_counter()
    if case in ASYNC_ENGINES:
        row = run_async(case, workers, steps, batch, device, vmem_budget_mb)
    elif case in CASES:
        row = run_sync(case, workers, steps, batch, device)
    else:
        raise ValueError(f"unknown case {case!r}; choose from {', '.join(CASES)}")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    row["wall_s"] = time.perf_counter() - t0
    measured = ("device time not measured (no card)" if row["measured_s"] is None else
                f"measured {row['measured_s']:.3e}s on the device "
                f"({row['device_us_per_step']:.1f} us/step)")
    print(f"== sgns/{case}: compute={row['compute_s']:.3e}s memory={row['memory_s']:.3e}s"
          f" collective={row['collective_s']:.3e}s → {row['dominant']} | {measured}"
          f" | collectives={row['collective_ops']} | launches={row['launches']}",
          flush=True)
    return row


def print_ingestion_plans(workers: int, processes: int, steps: int,
                          batch: int) -> list:
    """Per-process ingestion plans for the run's worker count: which workers
    each process extracts and trains. Pure planning: any ``--processes``
    can be printed from one process."""
    from repro_torch.data.pipeline import HostShardPlan

    plans = HostShardPlan.all_hosts(processes, workers)
    print(f"== ingestion plan: {workers} workers over {processes} host(s)")
    for plan in plans:
        block_mb = plan.num_local * steps * batch * 4 * 2 / 1e6  # c + x int32
        print(f"   {plan.describe()} — chunk block "
              f"({plan.num_local}, {steps}, {batch}) ×2 int32 "
              f"= {block_mb:.1f} MB/chunk")
    owned = sorted(w for p in plans for w in p.workers)
    assert owned == list(range(workers)), "plans must cover each worker once"
    return plans


def compare_sampler_paths(rows: list[dict]) -> None:
    """Each async engine beside ``async`` (the CDF draw): its measured
    device time and its memory term, both zero-collective."""
    by_case = {r["arch"]: r for r in rows}
    base = by_case.get("sgns-async")
    for other in ("sgns-async_alias", "sgns-async_pallas", "sgns-async_fused",
                  "sgns-async_fused_hbm", "sgns-async_fused_pipe",
                  "sgns-async_fused_tiered"):
        r = by_case.get(other)
        if not (base and r):
            continue
        dm = r["memory_s"] / max(base["memory_s"], 1e-30)
        dt = ("not measured" if r["measured_s"] is None or not base["measured_s"]
              else f"×{r['measured_s'] / base['measured_s']:.3f}")
        print(f"-- {other[5:]} vs async (cdf draw): device time {dt}, "
              f"memory ×{dm:.3f} (both zero-collective)")


def main(argv=None):
    from repro_torch.data.pipeline import HostShardPlan
    from repro_torch.launch.mesh import world

    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--cases",
                    default="async,async_alias,sync,local_sgd_8,"
                            "local_sgd_64,merge_alir_iter",
                    help="comma list; also available: async_pallas, "
                         "async_fused, async_fused_hbm, async_fused_pipe, "
                         "async_fused_tiered")
    ap.add_argument("--workers", type=int, default=WORKERS)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--processes", type=int, default=None,
                    help="processes to plan for (default: the torch.distributed "
                         "world size; any count can be printed); this process "
                         "runs its share of the workers")
    ap.add_argument("--plan-only", action="store_true",
                    help="print the per-process ingestion plans and exit "
                         "(no case runs)")
    ap.add_argument("--vmem-budget-mb", type=float, default=0.0,
                    help="reject async cases whose shared memory a CTA exceeds "
                         "this budget, or whose step does not fit the card's "
                         "memory (0 = report only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without one "
                         "unless 'cpu' is given)")
    args = ap.parse_args(argv)
    rank, size = world()
    processes = args.processes if args.processes is not None else size
    plans = print_ingestion_plans(args.workers, processes, args.steps, args.batch)
    if args.plan_only:
        assert plans, "ingestion planning produced no per-process plans"
        return []
    from repro_torch.device import resolve_device

    n = HostShardPlan(min(rank, processes - 1), processes, args.workers).num_local
    with _world_of_one(resolve_device(args.device)):     # one group for every case
        rows = [run(c, max(n, 1), args.steps, args.batch, args.vmem_budget_mb, args.device)
                for c in args.cases.split(",")]
    compare_sampler_paths(rows)
    print(rl.format_table(rows))
    if args.json:
        existing = json.load(open(args.json)) if os.path.exists(args.json) else []
        with open(args.json, "w") as f:
            json.dump(existing + rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
