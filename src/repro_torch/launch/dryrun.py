"""Multi-pod dry run: trace every (arch × shape × mesh) case per rank on a
simulated 256- or 512-rank mesh — the counterpart of ``repro.launch.dryrun``.

The reference compiles each case for 512 placeholder host devices and
reads ``memory_analysis()`` and ``cost_analysis()``. The port joins a
**fake process group** of 256 (16 × 16) or 512 (2 × 16 × 16) ranks in this
process (it sends nothing: this process plays rank 0) and runs the real
step on DTensors whose local shards are ``meta`` tensors (shapes and dtypes,
no storage; DTensor propagates its shapes on fake tensors of its own). Meta
shards give the same counts as ``FakeTensorMode`` shards (llama3-8b ×
``train_4k`` cut to 2 and 4 layers, on the CPU) at a third of the host
time: meta ops dispatch in C++. For each case it builds the model on
``meta``, places the parameters, the optimizer state (train), the batch
(``Model.example_batch(shape, concrete=False)``) and the caches (decode)
with :mod:`repro_torch.sharding.rules`' specs, runs ``make_train_step``
with the arch's optimizer and the reference's microbatch halving, the
prefill forward, or one decode step against a full-length cache, under
:func:`repro_torch.sharding.ctx.use_mesh_constraints`, and prints per rank:
the peak live bytes (against the card's 80 GB), :mod:`repro_torch.launch
.op_cost`'s flops, bytes and collectives, and the roofline row. Every
number is counted on the host, none measured on a device. The loops that
mirror the reference's scans run a few trips each and charge the others
(:func:`repro_torch.launch.op_cost.counted_loops`, the same counts as the
unrolled trace), as the reference's HLO walker multiplies a ``while`` body
by its trips.

The reference's decode program has no Pallas call (``repro.models`` never
calls ``swa_decode``), so the dry run traces ``decode_step(...,
swa_kernel=False)``: the plain masked attention.

The fake group lives in its own process: run this module as a command.

  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod] --json out.json
  python -m repro_torch.launch.dryrun --rank-rule deepseek-v2-lite-16b
  python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b --shape train_4k \
      --layers 1 --allocations 1
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from contextlib import nullcontext
from dataclasses import replace

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.registry import config_for_shape, supports_shape
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as rl
from repro_torch.models import Model
from repro_torch.optim import get_optimizer
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding.rules import (
    abstract_mesh, batch_axes, cache_spec, data_spec, local_shape, to_placements,
    tree_param_specs)
from repro_torch.tree import tree_map

CARD_BYTES = 80e9     # an H100's device memory


def join_fake_group(world_size: int) -> None:
    """Join a fake process group of ``world_size`` ranks as rank 0 (no
    communication: its collectives only shape their outputs)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


class SkipCase(Exception):
    pass


def _meta_dtensor(t: torch.Tensor, spec: tuple, mesh):
    """A DTensor of ``t``'s global shape and dtype placed by ``spec``, its
    local shard a fresh ``meta`` tensor (a shape and a dtype, no storage)."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(local_shape(tuple(t.shape), spec, mesh), dtype=t.dtype, device="meta")
    return DTensor.from_local(local, mesh, to_placements(spec, mesh), run_check=False)


def _shards(mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return math.prod(int(sizes[a]) for a in batch_axes(mesh))


class Case:
    """One case, built: the model with meta DTensor parameters, its step's
    meta DTensor inputs, and :meth:`run`, which traces the step under a
    :class:`~repro_torch.launch.op_cost.CostMode` and returns it."""

    def __init__(self, kind, model, mesh, step, inputs):
        self.kind, self.model, self.mesh = kind, model, mesh
        self.step, self.inputs = step, inputs

    def run(self, mode: op_cost.CostMode | None = None,
            counted: bool = False) -> op_cost.CostMode:
        """``counted``: each loop that mirrors a reference scan runs a few
        trips and charges the rest (:func:`~repro_torch.launch.op_cost
        .counted_loops`), which counts what the unrolled trace counts."""
        mode = op_cost.CostMode(pod_ranks=_pod_ranks(self.mesh)) if mode is None else mode
        with shctx.use_mesh_constraints(self.mesh, mode=mode), (
                op_cost.counted_loops(mode) if counted else nullcontext()):
            mode.track([p for p in self.model.parameters()])
            mode.track(self.inputs)
            self.step()
        return mode


def _pod_ranks(mesh):
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        return None
    return mesh.size() // int(mesh.mesh.shape[names.index("pod")])


def build_case(arch_id: str, shape, mesh, *, variant: str = "baseline", cfg=None):
    """Returns ``(case, meta)`` for one (arch, shape, mesh) case: ``shape`` a
    name of ``SHAPES`` (or an :class:`InputShape`), ``cfg`` the arch's
    config unless given (a reduced one, say). Raises :class:`SkipCase`
    where the reference skips."""
    shape_name = shape if isinstance(shape, str) else shape.name
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get_config(arch_id) if cfg is None else cfg
    ok, why = supports_shape(cfg, shape_name)
    if not ok:
        raise SkipCase(why)
    cfg = config_for_shape(cfg, shape_name).with_overrides(dtype="bfloat16")
    if variant != "baseline":
        cfg = apply_variant(cfg, variant, shape_name)
    model = Model(cfg, device="meta")
    params_meta = model.param_tree()
    meta = {
        "arch": arch_id, "shape": shape_name, "variant": variant,
        "params": rl.count_params(params_meta),
        "active_params": rl.active_params(cfg, params_meta),
        "model_flops": rl.model_flops_for(cfg, params_meta, shape),
    }
    if shape.kind == "train":
        opt = get_optimizer(cfg.train_optimizer)
        opt_meta = opt.init(params_meta)
        batch_meta = model.example_batch(shape, concrete=False)
        # the per-microbatch batch must stay divisible by the batch shards
        # (pod × data), as the reference halves it for GSPMD
        mb = cfg.train_microbatches
        while mb > 1 and (shape.global_batch % mb or
                          (shape.global_batch // mb) % _shards(mesh)):
            mb //= 2
        meta["microbatches"] = max(mb, 1)
    elif shape.kind == "prefill":
        batch_meta = model.example_batch(shape, concrete=False)
    else:
        B = shape.global_batch
        cache_len = model.decode_cache_len(shape)
        enc_len = shape.seq_len if cfg.encoder_layers else None
        cache_meta = model.init_cache(B, cache_len, enc_len=enc_len)
        meta["cache_len"] = cache_len
    specs = model.param_specs(mesh, cfg.fsdp)
    model.set_params({name: _meta_dtensor(model.get_parameter(name), spec, mesh)
                      for name, spec in specs.items()})
    if shape.kind == "train":
        opt_state = tree_map(lambda t, s: _meta_dtensor(t, s, mesh), opt_meta,
                             tree_param_specs(opt_meta, mesh, cfg.fsdp))
        batch = {k: _meta_dtensor(v, data_spec(tuple(v.shape), mesh), mesh)
                 for k, v in batch_meta.items()}
        train_step = model.make_train_step(opt, microbatches=meta["microbatches"])
        state = {"opt": opt_state}

        def step():
            state["opt"], _ = train_step(state["opt"], batch, 0)

        inputs = [opt_state, batch]
    elif shape.kind == "prefill":
        batch = {k: _meta_dtensor(v, data_spec(tuple(v.shape), mesh), mesh)
                 for k, v in batch_meta.items()}

        def step():
            with torch.no_grad():
                model.forward_logits(batch)

        inputs = [batch]
    else:
        cache = tree_map(lambda t: _meta_dtensor(t, cache_spec(tuple(t.shape), mesh), mesh),
                         cache_meta)
        token = _meta_dtensor(torch.empty((B, 1), dtype=torch.int32, device="meta"),
                              data_spec((B, 1), mesh), mesh)
        pos = shape.seq_len - 1

        def step():
            model.decode_step(cache, token, pos, swa_kernel=False)

        inputs = [cache, token]
    return Case(shape.kind, model, mesh, step, inputs), meta


# ---------------------------------------------------------------------------
# Variants for §Perf hillclimbing (beyond-paper optimizations).
# ---------------------------------------------------------------------------
def apply_variant(cfg, variant: str, shape_name: str):
    if variant == "no_remat":
        return cfg.with_overrides(remat=False)
    if variant == "remat_per_layer":
        return cfg.with_overrides(remat_per_layer=True)
    if variant == "no_fsdp":          # pure TP × DP (no ZeRO-3 regather)
        return cfg.with_overrides(fsdp=False)
    if variant == "seq_mlstm":        # xlstm pre-optimization baseline
        return cfg.with_overrides(
            ssm=replace(cfg.ssm, mlstm_chunk=0, slstm_segment=0))
    if variant == "no_slstm_segment":
        return cfg.with_overrides(ssm=replace(cfg.ssm, slstm_segment=0))
    if variant.startswith("mlstm_chunk_"):
        return cfg.with_overrides(
            ssm=replace(cfg.ssm, mlstm_chunk=int(variant.rsplit("_", 1)[1])))
    if variant == "more_microbatch":
        return cfg.with_overrides(
            train_microbatches=cfg.train_microbatches * 2)
    if variant == "less_microbatch":
        return cfg.with_overrides(
            train_microbatches=max(1, cfg.train_microbatches // 2))
    if variant == "ungrouped_moe":   # pre-optimization MoE dispatch
        return cfg.with_overrides(moe=replace(cfg.moe, groups=1))
    if variant.startswith("capacity_"):
        f = float(variant.split("_", 1)[1])
        return cfg.with_overrides(moe=replace(cfg.moe, capacity_factor=f))
    raise ValueError(f"unknown variant {variant!r}")


# ---------------------------------------------------------------------------
# The rank rule: a rank's matmul flops x ranks = the unsharded count, but for
# the matmuls of weights the specs keep whole on ``model``, which each of the
# axis's ranks repeats.
# ---------------------------------------------------------------------------
#: The archs it is held on (dense, MoE + MLA, grouped attention 4:1) and its
#: two cases, reduced on a fake 4 x 4 group: every dim divides.
RANK_RULE_ARCHS = ("smollm-360m", "deepseek-v2-lite-16b", "llama3-8b")
RANK_RULE_RANKS = 16
RANK_RULE_RTOL = 0.01
#: the most the repeats of the excused matmuls may add, a share of the
#: unsharded count
RANK_RULE_EXCUSED_MAX = 0.05


def _rank_rule_shapes():
    from repro_torch.configs.shapes import InputShape

    return (InputShape("p", 32, 16, "prefill"), InputShape("t", 32, 16, "train"))


def unsharded_matmul_flops(arch_id: str, kind: str, microbatches: int = 1,
                           cfg=None) -> float:
    """The matmul flops of the rank rule's ``kind`` case of reduced
    ``arch_id`` (or of ``cfg``) traced on ``meta`` without a mesh."""
    cfg = (get_config(arch_id).reduced() if cfg is None else cfg).with_overrides(
        dtype="bfloat16")
    model = Model(cfg, device="meta")
    shape = next(s for s in _rank_rule_shapes() if s.kind == kind)
    batch = model.example_batch(shape, concrete=False)
    with op_cost.CostMode() as mode:
        if kind == "prefill":
            with torch.no_grad():
                model.forward_logits(batch)
        else:
            opt = get_optimizer(cfg.train_optimizer)
            model.make_train_step(opt, microbatches=microbatches)(
                opt.init(model.param_tree()), batch, 0)
    return mode.cost.matmul_flops


def excused_matmul_flops(arch_id: str, kind: str, cfg=None) -> float:
    """The most that reduced ``arch_id``'s products with weights whole on
    ``model`` cost unsharded in the rank rule's ``kind`` case: the matrices
    whose spec on the rule's 4 x 4 mesh (:meth:`Model.param_specs`) names no
    ``model`` axis — deepseek's latent and rope down-projections and its
    router; none in the dense archs — each applied to every token, 2 flops
    a weight, once in a prefill and at most four times in a train step (the
    forward, its recomputation, the input's and the weight's gradients).
    ``cfg`` in place of the reduced config where given."""
    model = Model(get_config(arch_id).reduced() if cfg is None else cfg, device="meta")
    side = math.isqrt(RANK_RULE_RANKS)
    mesh = abstract_mesh((side, side), ("data", "model"))

    def axes(spec):
        return {a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))}

    weights = sum(model.get_parameter(n).numel() for n, spec in model.param_specs(mesh).items()
                  if model.get_parameter(n).dim() == 2 and "model" not in axes(spec))
    shape = next(s for s in _rank_rule_shapes() if s.kind == kind)
    return (1 if kind == "prefill" else 4) * 2 * shape.global_batch * shape.seq_len * weights


def rank_rule(arch_id: str, cfg=None) -> dict:
    """Reduced ``arch_id``'s prefill and train step on a fake group of 16
    ranks (4 x 4), per case: a rank's matmul flops, the unsharded count,
    the excused flops (:func:`excused_matmul_flops`), the microbatches and
    the points replicated where no rule placed them (``fallbacks``);
    ``cfg`` in place of the reduced config where given. Joins the fake
    group: run it in a process of its own (``--rank-rule``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        join_fake_group(RANK_RULE_RANKS)
    side = math.isqrt(RANK_RULE_RANKS)
    mesh = DeviceMesh("cpu", torch.arange(RANK_RULE_RANKS).view(side, side),
                      mesh_dim_names=("data", "model"))
    cfg = get_config(arch_id).reduced() if cfg is None else cfg
    out = {}
    for shape in _rank_rule_shapes():
        case, meta = build_case(arch_id, shape, mesh, cfg=cfg)
        mode = case.run()
        mb = meta.get("microbatches", 1)
        out[shape.kind] = {"per_rank": mode.cost.matmul_flops, "microbatches": mb,
                           "unsharded": unsharded_matmul_flops(arch_id, shape.kind, mb, cfg),
                           "excused": excused_matmul_flops(arch_id, shape.kind, cfg),
                           "fallbacks": dict(mode.fallbacks)}
    return out


def rank_rule_holds(c: dict) -> bool:
    """One case of :func:`rank_rule`: a rank's matmul flops x 16 within
    ``RANK_RULE_RTOL`` of the unsharded count, or above it by at most what
    the excused products add when each of ``model``'s 4 ranks repeats them
    (3 x their flops), that at most ``RANK_RULE_EXCUSED_MAX`` of the count;
    nothing replicated where no rule placed it."""
    u = c["unsharded"]
    over = RANK_RULE_RANKS * c["per_rank"] - u
    room = (math.isqrt(RANK_RULE_RANKS) - 1) * c["excused"]
    return (-RANK_RULE_RTOL * u <= over <= room + RANK_RULE_RTOL * u
            and room <= RANK_RULE_EXCUSED_MAX * u
            and not c["fallbacks"])


# ---------------------------------------------------------------------------
def watch_outputs(mode: op_cost.CostMode, keep) -> list:
    """Records, in the list it returns, each tensor ``t`` that the rank's
    ops (local or collective, not DTensor's shape propagation) output under
    ``mode`` where ``keep(func, t, new)`` holds, ``new`` whether ``t`` is a
    new storage (not a view's or an in-place op's): ``(op, shape, dtype,
    bytes, live bytes after it)``."""
    seen, local_op = [], mode.local_op

    def watched(func, args, kwargs):
        out = local_op(func, args, kwargs)
        if not mode._paused:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            alias = [r.alias_info is not None for r in func._schema.returns]
            alias = alias if len(alias) == len(outs) else alias[:1] * len(outs)
            for t, a in zip(outs, alias):
                if isinstance(t, torch.Tensor) and keep(func, t, not (func.is_view or a)):
                    seen.append((str(func), tuple(t.shape), str(t.dtype).split(".")[-1],
                                 t.numel() * t.element_size(), mode._live))
        return out

    mode.local_op = watched
    return seen


def run_case(arch_id: str, shape_name: str, *, multi_pod: bool,
             variant: str = "baseline", verbose: bool = True, mesh=None,
             layers: int | None = None, allocations_gb: float | None = None) -> dict:
    """One case's roofline row (and its printout with ``verbose``):
    ``layers`` cuts the arch's depth, ``allocations_gb`` lists the outputs
    of at least that many GB (1e9 bytes) the rank's ops make (also in the
    row, ``allocations``). Each loop that mirrors a reference scan is
    traced as a few trips with the rest charged
    (:func:`~repro_torch.launch.op_cost.counted_loops`: the same counts as
    the unrolled trace)."""
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None else mesh
    chips = mesh.size()
    cfg = get_config(arch_id).with_overrides(num_layers=layers) if layers else None
    t0 = time.perf_counter()
    case, meta = build_case(arch_id, shape_name, mesh, variant=variant, cfg=cfg)
    t1 = time.perf_counter()
    mode = op_cost.CostMode(pod_ranks=_pod_ranks(mesh))
    allocs = None if not allocations_gb else watch_outputs(
        mode, lambda f, t, new: new and t.numel() * t.element_size() >= allocations_gb * 1e9)
    case.run(mode, counted=True)
    t2 = time.perf_counter()
    cost = mode.cost
    r = rl.analyze(arch_id, shape_name, cost, chips, model_flops=meta["model_flops"],
                   dtype="bfloat16")
    row = r.row()
    row.update(variant=variant, multi_pod=multi_pod, layers=layers,
               params=meta["params"], active_params=meta["active_params"],
               build_s=t1 - t0, trace_s=t2 - t1, ops=cost.ops,
               fallbacks=dict(mode.fallbacks),
               fallback_reasons={op: dict(w) for op, w in mode.reasons.items()},
               microbatches=meta.get("microbatches"),
               fits=cost.peak_bytes <= CARD_BYTES)
    if allocs is not None:
        row["allocations"] = [[op, list(shape), dt, n] for op, shape, dt, n, _ in allocs]
    if verbose:
        mesh_name = "x".join(str(int(s)) for s in mesh.mesh.shape)
        cut = f", {layers} layers" if layers else ""
        print(f"== {arch_id} × {shape_name} ({mesh_name}, variant={variant}{cut})")
        print(f"   params={meta['params']/1e9:.2f}B "
              f"active={meta['active_params']/1e9:.2f}B "
              f"build={t1-t0:.1f}s trace={t2-t1:.1f}s ({cost.ops} ops a rank"
              + (f", {meta['microbatches']} microbatches" if "microbatches" in meta else "")
              + (", decode_step(swa_kernel=False)" if case.kind == "decode" else "") + ")")
        print(f"   peak live bytes/rank (counted): {cost.peak_bytes / 1e9:.3f} GB of "
              f"{CARD_BYTES / 1e9:.0f} GB → {'fits' if row['fits'] else 'DOES NOT FIT'}")
        print(f"   op_cost: flops/rank={cost.flops:.3e} (matmul {cost.matmul_flops:.3e}) "
              f"bytes/rank={cost.bytes:.3e}")
        print(f"   collectives: {r.collectives.count_by_op} "
              f"bytes/rank={r.collective_bytes_per_chip:.3e} dcn={r.dcn_bytes_per_chip:.3e}")
        print(f"   replicated where DTensor had no rule: {dict(mode.fallbacks) or 'none'}")
        for op, whys in mode.reasons.items():
            for why, n in whys.items():
                print(f"     {op} x {n}: {why}")
        print(f"   roofline: compute={r.compute_s:.3e}s memory={r.memory_s:.3e}s"
              f" collective={r.collective_s:.3e}s → {r.dominant}-bound; "
              f"MODEL/counted flops={r.flops_utilization:.3f}")
        if allocs is not None:
            print(f"   outputs of >= {allocations_gb} GB a rank (count × op shape dtype GB, "
                  f"the most live after one):")
            groups: dict = {}
            for op, shape, dt, n, live in allocs:
                g = groups.setdefault((op, shape, dt, n), [0, 0])
                g[0], g[1] = g[0] + 1, max(g[1], live)
            for (op, shape, dt, n), (k, live) in sorted(groups.items(), key=lambda i: -i[0][3]):
                print(f"     {k} × {op} {shape} {dt} {n / 1e9:.3f} (live {live / 1e9:.3f})")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCH_IDS} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {tuple(SHAPES)} or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--json", default=None, help="append rows to this file")
    ap.add_argument("--rank-rule", default=None, metavar="ARCH",
                    help="print the rank rule's cases of reduced ARCH as one JSON line "
                         "(a fake group of 16) and exit 1 if one fails")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut each arch to this many layers (full width)")
    ap.add_argument("--allocations", type=float, default=None, metavar="GB",
                    help="list the outputs of at least GB (1e9 bytes) a rank's ops make")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    if args.rank_rule:
        got = rank_rule(args.rank_rule)
        print(json.dumps(got))
        sys.exit(0 if all(rank_rule_holds(c) for c in got.values()) else 1)

    if not dist.is_initialized():
        join_fake_group(512 if args.multi_pod else 256)
    archs = ARCH_IDS if args.arch == "all" else (args.arch,)
    shapes = tuple(SHAPES) if args.shape == "all" else (args.shape,)

    rows = []
    for a in archs:
        for s in shapes:
            try:
                rows.append(run_case(a, s, multi_pod=args.multi_pod,
                                     variant=args.variant, layers=args.layers,
                                     allocations_gb=args.allocations))
            except SkipCase as e:
                print(f"== {a} × {s}: SKIP ({e})")
                rows.append({"arch": a, "shape": s, "skipped": str(e),
                             "variant": args.variant,
                             "multi_pod": args.multi_pod})
            except Exception:
                print(f"== {a} × {s}: FAILED")
                traceback.print_exc()
                rows.append({"arch": a, "shape": s, "failed": True,
                             "variant": args.variant,
                             "multi_pod": args.multi_pod})
    if args.json:
        existing = []
        if os.path.exists(args.json):
            with open(args.json) as f:
                existing = json.load(f)
        with open(args.json, "w") as f:
            json.dump(existing + rows, f, indent=1)
    ok_rows = [r for r in rows if "compute_s" in r]
    if ok_rows:
        print()
        print(rl.format_table(ok_rows))
    failed = [r for r in rows if r.get("failed")]
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
