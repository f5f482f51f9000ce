"""A per-rank cost model of one traced step — the counterpart of
``repro.launch.hlo_cost``.

The reference walks the compiled HLO: it multiplies ``while`` bodies by
their trip counts, recurses into fusions, and charges HBM traffic at
fusion boundaries. Torch has no HLO. Eager dispatch unrolls every loop
(the microbatches, remat's recompute, the recurrences), and every aten op
is a launch of its own, so the counterpart is a model of the ops as they
are dispatched, counted by a ``TorchDispatchMode`` (:class:`CostMode`);
:func:`counted_loops`, which the dry run turns on, runs a few trips of
each loop that mirrors a reference scan and charges the rest:

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
propagate shapes, or to derive a rule through an op's decomposition, are
not counted.

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

from repro_torch.sharding.ctx import ShardedDispatch, _wrap

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

    def copy(self) -> "Cost":
        return Cost(self.flops, self.bytes, dict(self.coll_bytes), dict(self.coll_counts),
                    self.dcn_bytes, [], self.matmul_flops, self.peak_bytes, self.ops,
                    dict(self.bytes_by_op))

    def since(self, before: "Cost") -> "Cost":
        """The work counted since ``before`` (a :meth:`copy` of this cost)."""
        def diff(a, b):
            out = {k: v - b.get(k, 0.0) for k, v in a.items()}
            return {k: v for k, v in out.items() if v}

        return Cost(self.flops - before.flops, self.bytes - before.bytes,
                    diff(self.coll_bytes, before.coll_bytes),
                    diff(self.coll_counts, before.coll_counts),
                    self.dcn_bytes - before.dcn_bytes, [],
                    self.matmul_flops - before.matmul_flops, 0.0, self.ops - before.ops,
                    diff(self.bytes_by_op, before.bytes_by_op))

    def work(self) -> tuple:
        """The counted work, for comparing two spans: every sum but the peak."""
        return (self.flops, self.matmul_flops, self.bytes, self.dcn_bytes, self.ops,
                sorted(self.coll_bytes.items()), sorted(self.coll_counts.items()),
                sorted(self.bytes_by_op.items()))


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
# its output's shape, and (torch 2.13) derives the placements of an op it
# has no rule for by running its decomposition on meta tensors; those ops
# are no rank's work. Each such entry is wrapped while a CostMode is on the
# stack so that it pauses counting: the first that exists of each group.
_PROPAGATE = (("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
               ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")),
              ("torch.distributed.tensor._decompositions", "DecompShardingStrategy",
               ("propagate_strategy",)))
_ACTIVE: list = []


def _propagators():
    import importlib

    for module, cls, names in _PROPAGATE:
        try:
            owner = getattr(importlib.import_module(module), cls)
        except (ImportError, AttributeError):
            continue
        name = next((n for n in names if n in owner.__dict__), None)
        if name is not None:
            yield owner, name


def _patch_propagator(mode: CostMode) -> None:
    _ACTIVE.append(mode)
    if len(_ACTIVE) > 1:
        return
    for owner, name in _propagators():
        orig = owner.__dict__[name]

        def wrapped(self, *a, __orig=orig, **k):
            with _pause_all():
                return __orig(self, *a, **k)

        wrapped._repro_orig = orig
        setattr(owner, name, wrapped)


def _unpatch_propagator(mode: CostMode) -> None:
    _ACTIVE.remove(mode)
    if _ACTIVE:
        return
    for owner, name in _propagators():
        fn = owner.__dict__[name]
        if hasattr(fn, "_repro_orig"):
            setattr(owner, name, fn._repro_orig)


@contextmanager
def _pause_all():
    for m in _ACTIVE:
        m._paused += 1
    try:
        yield
    finally:
        for m in _ACTIVE:
            m._paused -= 1


# ---------------------------------------------------------------------------
# Counted loops: the counterpart of the reference's ``while`` body counted
# once and multiplied by its trip count.
# ---------------------------------------------------------------------------
#: loops of fewer trips run every trip
COUNTED_MIN_TRIPS = 4
# a skipped span's probe storage -> the finalizer that frees its phantom bytes
_PHANTOMS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


@contextmanager
def counted_loops(mode: CostMode):
    """Within the block, each loop of :func:`repro_torch.models.loops.trips`
    (the layer cycles, the microbatches, Mamba's chunks, sLSTM's segments
    and steps, mLSTM's chunks and steps) of ``n`` >= ``COUNTED_MIN_TRIPS``
    trips runs trips 0, 1 and n − 1 and charges trips 2 … n − 2 to ``mode``
    as copies of trip 1 — the dry run's mode; off by default, and never on
    in a real run. What a traced step counts equals the unrolled trace:

    * the forward work (flops, matmul flops, bytes, collectives by kind,
      ops) of trip 1, added ``n − 3`` times where the skipped trips would
      run (so a checkpoint's recompute charges them again);
    * the backward work of trip 1 (remat's recompute in it), ``n − 3``
      times at its end: trip 1, as every trip after the first in the
      backward pass, adds its gradients to those of shared tensors;
    * memory: the skipped trips' outputs and final carry are fresh tensors
      of the templates' storage sizes, and the bytes each trip keeps (the
      live bytes trip 1 adds) a phantom, live while autograd would hold the
      skipped trips' saved tensors: it is tied to a probe tensor saved for
      the backward pass (held by the graph, dropped by a checkpoint's
      forward, held again by its recompute) and freed where the skipped
      trips' backward would run, which then makes the gradients of their
      carry and of their own parameters (``params``: the skipped cycles'
      weights get gradients laid out as trip n − 1's, for the optimizer).
      The live bytes at each trip boundary are the unrolled trace's, so
      the peak is too: reached in a real trip, or in a skipped backward
      window at trip 1's rise (:class:`_Backward`).

    It hides no failure: trips whose parameters or carry differ in shape,
    placement, dtype, layout or ``requires_grad``, a trip n − 1 whose
    forward work, kept bytes or peak differ from trip 1's, or bytes kept
    outside autograd raise ``RuntimeError``."""
    from repro_torch.models import loops

    def counted(body, carry, n, params):
        return _CountedLoop(mode, body, n, params).run(carry)

    with loops.counting(counted):
        yield


def _leaves(tree):
    from torch.utils._pytree import tree_flatten

    return tree_flatten(tree)


def _local(t):
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def _meta(t) -> tuple:
    """What a stand-in of ``t`` needs: its DTensor spec (or None), its local
    shape, stride, offset, storage bytes, dtype, device; and its
    ``requires_grad`` (compared, not built)."""
    from torch.distributed.tensor import DTensor

    spec = ((t.device_mesh, tuple(t.placements), tuple(t.shape), tuple(t.stride()))
            if isinstance(t, DTensor) else None)
    loc = _local(t)
    return (spec, tuple(loc.shape), tuple(loc.stride()), loc.storage_offset(),
            loc.untyped_storage().nbytes(), loc.dtype, loc.device, t.requires_grad)


def _signature(ts) -> list:
    return [None if t is None else (str(m[0][1:]) if m[0] else None,) + m[1:]
            for t in ts for m in [None if t is None else _meta(t)]]


def _stand_in(meta):
    """A fresh tensor of ``meta``'s layout on a storage of its size (its
    allocation counted as live, no op charged)."""
    spec, shape, stride, offset, nbytes, dtype, device, _ = meta
    base = torch.empty(-(-nbytes // dtype.itemsize), dtype=dtype, device=device)
    loc = base.as_strided(shape, stride, offset)
    return loc if spec is None else _wrap(loc, spec[0], spec[1], spec[2], spec[3])


class _Trip:
    """One real trip's record: its forward work, the live bytes it adds and
    its peak above its start."""

    def __init__(self):
        self.work = None
        self.keep = self.peak = 0.0


class _Backward:
    """The backward pass of a counted loop, read by its markers. A trip's
    gradients reach the trips before it through a marker on their outputs,
    where they add up with the other gradients of those outputs (a y that
    is also the carry): trip t's window runs from the start of its own
    outputs' marker to the start of trip t − 1's, and holds its nodes and
    that addition for trip t − 1's outputs — what each trip's backward
    holds, unrolled. Trip 1's window, less the addition that the skipped
    span's gradients made at trip 1's outputs (dispatched, not skipped), is
    charged for the skipped trips. Trip n − 1, whose carry may have no
    gradient, is no template: the skipped windows' peak is trip 1's peak
    above its start, from the highest of their starts (linear between the
    first skipped window's, where the span's backward starts, and trip
    1's)."""

    def __init__(self, mode, skip):
        self.mode, self.skip = mode, skip
        self.grads = None            # metadata of trip n − 1's input gradients
        self.param_grads = []        # … and of its own parameters' gradients
        self.handles = []            # the hooks that read them
        self._after_skipped = self._window = self._added = None
        self._span_start = None      # live bytes where the skipped windows start

    def last_input(self, gs):        # trip n − 1's input gradients, before the span
        self.grads = [None if g is None else _meta(g) for g in gs]

    def skipped_start(self):
        self._span_start = self.mode._live

    def skipped_done(self):
        self._after_skipped = self.mode.cost.copy()

    def trip1_start(self, gs):
        mode = self.mode
        if self._after_skipped is not None:
            self._added = mode.cost.since(self._after_skipped)
        self._window = mode.cost.copy()
        self._start, self._peak = mode._live, mode.cost.peak_bytes
        mode.cost.peak_bytes = mode._live

    def trip1_end(self, gs):
        if self._window is None:
            return
        mode = self.mode
        cost = mode.cost
        rise = cost.peak_bytes - self._start
        cost.peak_bytes = max(self._peak, cost.peak_bytes)
        if self._span_start is not None:
            step = (self._start - self._span_start) / self.skip
            cost.peak_bytes = max(cost.peak_bytes,
                                  max(self._span_start, self._start - step) + rise)
        cost.add(cost.since(self._window), self.skip)
        if self._added is not None:
            cost.add(self._added, -1)
        self._window = None


class _Mark(torch.autograd.Function):
    """The identity on a trip's tensors; its backward calls ``hook`` with
    their gradients (at a trip's outputs: where the trip's backward starts,
    the gradients of those outputs added up; at its input: once every node
    of the trip has run, by the engine's order)."""

    @staticmethod
    def forward(ctx, hook, *ts):
        ctx.set_materialize_grads(False)
        ctx.hook = hook
        return ts

    @staticmethod
    def backward(ctx, *gs):
        ctx.hook(gs)
        return (None, *gs)


def _marked(tree, hook):
    """``tree`` with its tensors that need gradients through one :class:`_Mark`
    (a tensor twice stays one); ``hook`` gets the gradients of all its
    tensor leaves, in order (None for one without)."""
    from torch.utils._pytree import tree_unflatten

    flat, spec = _leaves(tree)
    uniq = list({id(t): t for t in flat
                 if isinstance(t, torch.Tensor) and t.requires_grad}.values())
    if not uniq:
        return tree
    pos = {id(t): k for k, t in enumerate(uniq)}
    at = [pos.get(id(t)) if isinstance(t, torch.Tensor) else None for t in flat]
    at = [a for a, t in zip(at, flat) if isinstance(t, torch.Tensor)]

    def each(gs):
        hook([None if k is None else gs[k] for k in at])

    out = _Mark.apply(each, *uniq)
    return tree_unflatten([out[pos[id(t)]] if id(t) in pos else t for t in flat], spec)


class _Skipped(torch.autograd.Function):
    """Trips 2 … n − 2: charges their forward work, returns stand-ins of
    their outputs and of the carry after them, and saves ``probe`` (whose
    storage the phantom of their kept bytes is tied to); its backward frees
    the phantom and returns gradients laid out as trip n − 1's input
    gradients and as the skipped trips' parameters."""

    @staticmethod
    def forward(ctx, loop, probe, *inputs):
        ctx.set_materialize_grads(False)
        ctx.loop = loop
        ctx.save_for_backward(probe)
        loop.mode.cost.add(loop.first.work, loop.skip)
        return tuple(_stand_in(m) for m in loop.out_metas)

    @staticmethod
    def backward(ctx, *gs):
        (probe,) = ctx.saved_tensors
        loop = ctx.loop
        loop.bwd.skipped_start()
        fin = _PHANTOMS.pop(probe.untyped_storage(), None)
        if fin is not None:
            fin()
        for h in loop.bwd.handles:
            h.remove()
        carry = loop.bwd.grads or [None] * len(loop.carry_metas)
        # a parameter's gradient laid out as trip n − 1's same parameter's
        # (a replicated weight's is a partial sum over the batch axes)
        own = loop.bwd.param_grads
        metas = list(carry) + [None if not m[-1] else own[k % len(own)] or m
                               for k, m in enumerate(loop.param_metas)]
        grads = tuple(None if m is None else _stand_in(m) for m in metas)
        loop.bwd.skipped_done()
        return (None, None) + grads


class _CountedLoop:
    def __init__(self, mode, body, n, params):
        self.mode, self.body, self.n, self.params = mode, body, n, params
        self.skip = n - 3

    def run(self, box):
        from torch.utils._pytree import tree_unflatten

        n, body, mode = self.n, self.body, self.mode
        carry = box.pop()
        if n < COUNTED_MIN_TRIPS:
            ys = []
            for i in range(n):
                carry, y = body(carry, i)
                ys.append(y)
            return carry, ys
        if self.params is not None:
            sigs = [_signature(self.params(i)) for i in range(n)]
            if any(s != sigs[1] for s in sigs[1:]):
                raise RuntimeError("counted loop: the trips' parameters differ")
        self.bwd = bwd = _Backward(mode, self.skip)
        carry, y = body(carry, 0)
        needs = torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in _leaves((carry, y))[0])
        carry, y = _marked((carry, y), bwd.trip1_end)
        ys = [y]
        # trip 1, the template
        self.first = _Trip()
        live = mode._live
        self.carry_in = _signature(_leaves(carry)[0])
        carry, y = self._trip(carry, 1, self.first)
        if not needs and torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad for t in _leaves((carry, y))[0]):
            raise RuntimeError("counted loop: trip 1's outputs need gradients, trip 0's none")
        carry, y = _marked((carry, y), bwd.trip1_start)
        ys.append(y)
        self.first.keep = mode._live - live
        # trips 2 … n − 2
        flat, spec = _leaves(carry)
        if any(not isinstance(t, torch.Tensor) for t in flat):
            raise RuntimeError("counted loop: a carry of tensors only")
        if _signature(flat) != self.carry_in:
            raise RuntimeError("counted loop: the carry changes from trip to trip")
        yflat, yspec = _leaves(y)
        # a y that is a carry tensor (sLSTM's h) is, after the last skipped
        # trip, that trip's carry: the carry stand-in itself
        alias = [next((j for j, c in enumerate(flat) if c is t), None) for t in yflat]
        keys = [_local(t).untyped_storage()._cdata for t in flat + yflat
                if isinstance(t, torch.Tensor)]
        if len(set(keys)) != len(keys) - sum(a is not None for a in alias):
            raise RuntimeError("counted loop: outputs that share a storage")
        self.carry_metas = [_meta(t) for t in flat]
        ymetas = [_meta(t) if isinstance(t, torch.Tensor) else None for t in yflat]
        plan = [[("carry", alias[i]) if alias[i] is not None and k == self.skip - 1 else
                 ("out", ymetas[i]) if ymetas[i] is not None else ("none", None)
                 for i in range(len(yflat))] for k in range(self.skip)]
        self.out_metas = self.carry_metas + [m for trip in plan for kind, m in trip
                                             if kind == "out"]
        own = [p for k in range(2, n - 1) for p in (self.params(k) if self.params else ())]
        self.param_metas = [_meta(p) for p in own]
        probe = torch.empty(0, dtype=torch.uint8, device="meta")
        held = weakref.ref(probe)
        stores = [weakref.ref(_local(t).untyped_storage()) for t in flat]
        live = mode._live
        outs = list(_Skipped.apply(self, probe, *flat, *own))
        del probe, flat, carry, own, y
        nc = len(self.carry_metas)
        cflat, rest = outs[:nc], iter(outs[nc:])
        # a carry tensor its own trip saves outlives the next trip: the last
        # skipped trip's stand-in is kept until the span's backward, as the
        # probe is (trip 1's own carry tells which: it is still stored)
        kept = [t for t, st in zip(cflat, stores) if st() is not None]
        carry = tree_unflatten(cflat, spec)
        for trip in plan:
            ys.append(tree_unflatten([cflat[m] if kind == "carry" else
                                      next(rest) if kind == "out" else None
                                      for kind, m in trip], yspec))
        del outs, rest, cflat
        phantom = live + self.skip * self.first.keep - mode._live
        if phantom < 0 or (phantom and held() is None):
            raise RuntimeError(f"counted loop: {phantom:+.0f} bytes of the skipped trips are "
                               f"kept outside autograd")
        if held() is not None:
            st = held().untyped_storage()
            mode._live += phantom
            mode.cost.peak_bytes = max(mode.cost.peak_bytes, mode._live)

            def release(n=phantom, kept=kept):
                mode._free(n)
                kept.clear()

            _PHANTOMS[st] = weakref.finalize(st, release)
        del kept
        # trip n − 1, checked against trip 1; its parameters' gradients laid
        # out as the skipped trips' will be
        if self.params is not None and torch.is_grad_enabled():
            last = self.params(n - 1)
            bwd.param_grads = [None] * len(last)

            def seen(k):
                def hook(g):
                    bwd.param_grads[k] = _meta(g)
                return hook

            bwd.handles = [p.register_hook(seen(k)) for k, p in enumerate(last)
                           if p.requires_grad]
            del last
        self.last = _Trip()
        live = mode._live
        carry = _marked(carry, bwd.last_input)
        carry, y = self._trip(carry, n - 1, self.last)
        ys.append(y)
        self.last.keep = mode._live - live
        a, b = self.first, self.last
        if (a.work.work(), a.keep, a.peak) != (b.work.work(), b.keep, b.peak):
            raise RuntimeError(f"counted loop: trip {n - 1} differs from trip 1 "
                               f"(kept {b.keep} vs {a.keep}, peak {b.peak} vs {a.peak})")
        self.body = self.params = None
        return carry, ys

    def _trip(self, carry, i, rec):
        """Trip ``i`` with its forward work and peak recorded in ``rec``."""
        mode = self.mode
        start, peak = mode._live, mode.cost.peak_bytes
        mode.cost.peak_bytes = start
        before = mode.cost.copy()
        try:
            carry, y = self.body(carry, i)
        finally:
            rec.peak = mode.cost.peak_bytes - start
            mode.cost.peak_bytes = max(peak, mode.cost.peak_bytes)
        rec.work = mode.cost.since(before)
        return carry, y
