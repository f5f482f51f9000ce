"""A per-rank cost model of one traced step — the counterpart of
``repro.launch.hlo_cost``.

The reference walks the compiled HLO: it multiplies ``while`` bodies by
their trip counts, recurses into fusions, and charges HBM traffic at
fusion boundaries. Torch has no HLO. Eager dispatch already unrolls every
loop (the microbatches, remat's recompute, the recurrences), and every
aten op is a launch of its own, so the counterpart is a model of the ops
as they are dispatched, counted by a ``TorchDispatchMode``
(:class:`CostMode`):

* flops — ``torch.utils.flop_counter``'s formulas for the matmul-class ops
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions, SDPA), kept apart
  as ``matmul_flops``; for every other op the reference's rule: ``|out|``
  for an elementwise op, plus the input's elements for a reduction;
* bytes — each op's operand and output bytes (each op reads its inputs
  from and writes its outputs to device memory: no fusion in eager mode),
  with views and metadata free, as the reference's ``ELEMENTWISE_FREE``;
  gathers and slices read only what they return (2·|out| bytes), as the
  reference's ``dynamic-slice``/``gather``;
* collectives — the ``c10d`` and ``_c10d_functional`` ops (and DTensor's
  ``shard_dim_alltoall``) by kind, each charged ``max(out, operand)``
  bytes, the reference's output-shape rule; ``dcn_bytes`` for those whose
  group spans more than one pod;
* peak bytes — the most bytes live at once in the storages the step's
  inputs and ops hold (the counterpart of ``memory_analysis``).

Under DTensor the mode is a :class:`repro_torch.sharding.ctx.ShardedDispatch`:
it sees DTensor ops first and passes them through DTensor, so what it
counts are the **local** shards' ops and the collectives DTensor issues —
a rank's work. (A mode entered around DTensor code without this would see
global shapes: ``FlopCounterMode`` over a DTensor matmul counts the whole
mesh's flops.) The ops DTensor runs on global-shape fake tensors to
propagate shapes are not counted.

The reference's HLO-text parser (``parse_module``, ``_OP_LINE``,
``HloCostModel``, ``top_collectives``) has no input in the port and is not
copied; its dtype table is (:func:`shape_elems_bytes`).
"""

from __future__ import annotations

import math
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from repro_torch.sharding.ctx import ShardedDispatch

_DTYPE_BYTES = {
    "pred": 1, "s2": 1, "u2": 1, "s4": 1, "u4": 1,
    "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e3m4": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

# torch dtypes under the reference's (HLO's) names
TORCH_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.uint32: "u32", torch.float32: "f32",
    torch.int64: "s64", torch.float64: "f64", torch.complex64: "c64",
    torch.complex128: "c128",
}

# a collective op's name → its kind in the reference's spelling
_COLLECTIVE_KINDS = (("reduce_scatter", "reduce-scatter"), ("all_gather", "all-gather"),
                     ("allgather", "all-gather"), ("all_reduce", "all-reduce"),
                     ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
                     ("alltoall", "all-to-all"), ("broadcast", "collective-broadcast"))
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "_dtensor")

_aten = torch.ops.aten
# no data moves: allocation without a write, metadata, detach
_FREE = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten.detach.default,
    _aten.alias.default, _aten.lift_fresh.default, _aten._local_scalar_dense.default,
    _aten.sym_size.int, _aten.sym_stride.int, _aten.sym_numel.default,
    _aten.sym_storage_offset.default, _aten.is_nonzero.default,
}
# read only what they return (the reference's dynamic-slice / gather)
_GATHERS = {
    _aten.index.Tensor, _aten.index_select.default, _aten.gather.default,
    _aten.embedding.default, _aten.slice_scatter.default, _aten.select_scatter.default,
}
# moves without arithmetic (the reference's copy/concatenate/sort/… class)
_MOVES = {
    _aten.clone.default, _aten._to_copy.default, _aten.copy_.default, _aten.copy.default,
    _aten.cat.default, _aten.stack.default, _aten.constant_pad_nd.default,
    _aten.repeat.default, _aten.sort.default, _aten.sort.stable, _aten.topk.default,
    _aten.expand_copy.default, _aten.permute_copy.default, _aten.transpose_copy.int,
    _aten.flip.default, _aten.roll.default, _aten.fill_.Scalar, _aten.zero_.default,
    _aten.zeros.default, _aten.ones.default, _aten.full.default, _aten.zeros_like.default,
    _aten.ones_like.default, _aten.full_like.default, _aten.new_zeros.default,
    _aten.new_ones.default, _aten.new_full.default, _aten.arange.default,
    _aten.arange.start, _aten.arange.start_step, _aten.repeat_interleave.Tensor,
    _aten.repeat_interleave.self_int,
}
# reductions: |out| + the input's elements
_REDUCTIONS = {
    _aten.sum.default, _aten.sum.dim_IntList, _aten.mean.default, _aten.mean.dim,
    _aten.amax.default, _aten.amin.default, _aten.max.default, _aten.min.default,
    _aten.max.dim, _aten.min.dim, _aten.logsumexp.default, _aten.prod.default,
    _aten.var.correction, _aten.std.correction, _aten.argmax.default,
    _aten.argmin.default, _aten.any.default, _aten.all.default, _aten.any.dim,
    _aten.all.dim, _aten.linalg_vector_norm.default, _aten._softmax.default,
    _aten._log_softmax.default,
}


def shape_elems_bytes(shape, dtype) -> tuple[int, int]:
    """Elements and bytes of a ``shape`` tensor of ``dtype`` (a torch dtype
    or the reference's name: ``bf16``, ``f8e4m3fn``…)."""
    name = TORCH_DTYPE_NAMES.get(dtype, dtype)
    elems = math.prod(int(d) for d in shape)
    return elems, elems * _DTYPE_BYTES[name]


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: dict = field(default_factory=dict)
    coll_counts: dict = field(default_factory=dict)
    dcn_bytes: float = 0.0
    warnings: list = field(default_factory=list)
    matmul_flops: float = 0.0       # the matmul-class ops' share of ``flops``
    peak_bytes: float = 0.0         # the most bytes live at once
    ops: int = 0                    # ops dispatched (each an eager launch)
    bytes_by_op: dict = field(default_factory=dict)   # aten op name → bytes

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += mult * other.flops
        self.bytes += mult * other.bytes
        self.dcn_bytes += mult * other.dcn_bytes
        self.matmul_flops += mult * other.matmul_flops
        self.ops += int(mult * other.ops)
        for k, v in other.bytes_by_op.items():
            self.bytes_by_op[k] = self.bytes_by_op.get(k, 0.0) + mult * v
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + mult * v
        for k, v in other.coll_counts.items():
            self.coll_counts[k] = self.coll_counts.get(k, 0.0) + mult * v
        self.warnings.extend(other.warnings)

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll_bytes.values())


def _tensors(x):
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective_kind(func) -> str | None:
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._schema.name.split("::")[-1]
    for key, kind in _COLLECTIVE_KINDS:
        if key in name:
            return kind
    return None


class CostMode(ShardedDispatch):
    """Counts the ops dispatched while it is on the stack into ``cost``
    (:class:`Cost`), per rank: enter it around a step (as the ``mode`` of
    :func:`repro_torch.sharding.ctx.use_mesh_constraints` under a mesh).
    :meth:`track` adds tensors that exist before the step (parameters,
    optimizer state, batch, caches) to the live bytes. ``pod_ranks``: the
    ranks a pod holds (a collective whose group spans two pods is charged to
    ``dcn_bytes``; None: no pods)."""

    def __init__(self, pod_ranks: int | None = None):
        super().__init__()
        self.cost = Cost()
        self.pod_ranks = pod_ranks
        self._live = 0
        self._seen: weakref.WeakSet = weakref.WeakSet()
        self._groups: dict = {}
        self._paused = 0

    # ---------------------------------------------------------------- memory
    def track(self, tree) -> None:
        """Count the storages under ``tree`` (tensors or DTensors, in any
        nesting of dicts, lists and tuples) as live."""
        from torch.distributed.tensor import DTensor

        def leaves(x):
            if isinstance(x, dict):
                for v in x.values():
                    yield from leaves(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    yield from leaves(v)
            elif isinstance(x, DTensor):
                yield x.to_local()
            elif isinstance(x, torch.Tensor):
                yield x

        for t in leaves(tree):
            self._alloc(t)

    def _alloc(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        self._seen.add(st)
        n = st.nbytes()
        self._live += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self._live -= n

    # ---------------------------------------------------------------- counting
    def __enter__(self):
        _patch_propagator(self)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        _unpatch_propagator(self)
        return out

    def local_op(self, func, args, kwargs):
        out = func(*args, **kwargs)
        if self._paused:
            return out
        self._count(func, args, kwargs, out)
        returns = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for i, o in enumerate(outs):
            aliased = i < len(returns) and returns[i].alias_info is not None
            if isinstance(o, torch.Tensor) and not aliased and not func.is_view:
                self._alloc(o)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c = self.cost
        if func in _FREE or func.is_view or func.namespace == "prim":
            return
        kind = _collective_kind(func)
        if kind is None and func.namespace in _COLLECTIVE_NAMESPACES:
            return                      # wait_tensor and the like
        c.ops += 1
        before = c.bytes
        ins = sum(_nbytes(t) for t in _tensors((args, kwargs)))
        outs = sum(_nbytes(t) for t in _tensors(out))
        if kind is not None:
            moved = max(outs, ins)
            c.coll_bytes[kind] = c.coll_bytes.get(kind, 0.0) + moved
            c.coll_counts[kind] = c.coll_counts.get(kind, 0.0) + 1
            if self._spans_pods(args, kwargs):
                c.dcn_bytes += moved
            c.bytes += ins + outs
        else:
            self._count_compute(func, args, kwargs, out, ins, outs)
        name = func._schema.name.split("::")[-1]
        c.bytes_by_op[name] = c.bytes_by_op.get(name, 0.0) + (c.bytes - before)

    def _count_compute(self, func, args, kwargs, out, ins, outs) -> None:
        from torch.utils.flop_counter import flop_registry

        c = self.cost
        out_elems = sum(t.numel() for t in _tensors(out))
        packet = func.overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            c.flops += f
            c.matmul_flops += f
            c.bytes += ins + outs
        elif func in _GATHERS:
            c.bytes += 2 * outs
        elif func in _MOVES:
            c.bytes += ins + outs
        else:
            c.flops += out_elems
            if func in _REDUCTIONS:
                c.flops += sum(t.numel() for t in _tensors(args[:1]))
            c.bytes += ins + outs

    def _spans_pods(self, args, kwargs) -> bool:
        if not self.pod_ranks:
            return False
        names = [a for a in list(args) + list(kwargs.values()) if isinstance(a, str)]
        if not names:
            return False
        name = names[-1]
        if name not in self._groups:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import _resolve_process_group

            ranks = dist.get_process_group_ranks(_resolve_process_group(name))
            self._groups[name] = len({r // self.pod_ranks for r in ranks}) > 1
        return self._groups[name]


# DTensor runs each new op once on global-shape fake tensors to propagate
# its output's shape; those ops are no rank's work. The propagator's entry
# is wrapped while a CostMode is on the stack so that it pauses counting.
_PROPAGATE = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
_ACTIVE: list = []


def _patch_propagator(mode: CostMode) -> None:
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    _ACTIVE.append(mode)
    if len(_ACTIVE) > 1:
        return
    for name in _PROPAGATE:
        orig = ShardingPropagator.__dict__.get(name)
        if orig is None:
            continue

        def wrapped(self, *a, __orig=orig, **k):
            with _pause_all():
                return __orig(self, *a, **k)

        wrapped._repro_orig = orig
        setattr(ShardingPropagator, name, wrapped)
        break


def _unpatch_propagator(mode: CostMode) -> None:
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    _ACTIVE.remove(mode)
    if _ACTIVE:
        return
    for name in _PROPAGATE:
        fn = ShardingPropagator.__dict__.get(name)
        if fn is not None and hasattr(fn, "_repro_orig"):
            setattr(ShardingPropagator, name, fn._repro_orig)


@contextmanager
def _pause_all():
    for m in _ACTIVE:
        m._paused += 1
    try:
        yield
    finally:
        for m in _ACTIVE:
            m._paused -= 1
