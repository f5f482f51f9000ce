"""Activation sharding-constraint context — the counterpart of
``repro.sharding.ctx``.

The reference pins activations with ``with_sharding_constraint`` at layer
boundaries so that GSPMD keeps the batch dim sharded through
gather-heavy graphs. The port's counterpart redistributes: when the
context is enabled over a ``DeviceMesh`` and ``x`` is a DTensor, each hook
below ``redistribute``s ``x`` to the placements of the spec the
reference's hook would name (dims it leaves ``None`` replicated). On a
plain tensor, or with the context disabled (the default: every SGNS path,
every test without a mesh), each hook is the identity.

Where GSPMD decides for the reference, the port decides here, once:

* :class:`ShardedDispatch` (entered by :func:`use_mesh_constraints`) runs
  every DTensor op through DTensor, plain tensors among its operands taken
  as replicated; where DTensor has no rule for an op at its operands'
  placements, it redistributes them to ``Replicate`` (an all-gather, as
  GSPMD's would be) and runs the op again, counting each such point in
  ``fallbacks``; partial sums entering a matmul are reduced first, and
  DTensor's masked partials (a vocabulary-parallel embedding or gather)
  at once;
* :func:`gathered_params` gathers a layer's FSDP-sharded weights over
  ``data`` for the layer's use (the reference's per-use all-gather);
* :func:`shard_attention`, :func:`shard_like` and :func:`shard_heads` pin
  grouped attention, whose reshape DTensor cannot shard as GSPMD does.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.sharding.rules import axis_names, to_placements

_STATE: dict = {"enabled": False, "batch_axes": ("data",), "sizes": {}, "mesh": None}

_aten = torch.ops.aten
# a partial sum entering one of these is reduced first: multiplied as a
# partial, it would need the other operand whole on that mesh dim (every
# rank doing the whole product), where GSPMD and Megatron reduce after the
# row-parallel matmul and keep the weights sharded
_MATMULS = (_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm)
_VIEWS = (_aten.view.default, _aten._unsafe_view.default, _aten.reshape.default)


class ShardedDispatch(TorchDispatchMode):
    """A dispatch mode over DTensor programs. Ops on plain tensors go to
    :meth:`local_op` (the identity here; :class:`repro_torch.launch.op_cost
    .CostMode` counts them): with the mode on the stack, these are the
    local shards' ops that DTensor runs, and its collectives. An op on
    DTensors goes through DTensor with plain tensor operands made
    replicated DTensors; where DTensor has no rule for the operands'
    placements, they are redistributed to ``Replicate`` and the op runs
    again, ``fallbacks[op name]`` counting each such point."""

    def __init__(self):
        super().__init__()
        self.fallbacks: dict[str, int] = {}
        self.reasons: dict[str, str] = {}     # op → the first line of its first error
        self._inside = False

    def local_op(self, func, args, kwargs):
        return func(*args, **kwargs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate

        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return self.local_op(func, args, kwargs)
        if self._inside:
            return NotImplemented      # DTensor's own dispatch, with this mode on the stack
        mesh = next(a.device_mesh for a in tree_leaves((args, kwargs)) if isinstance(a, DTensor))
        rep = [Replicate()] * mesh.ndim

        def replicated(a):
            if isinstance(a, DTensor) or not isinstance(a, torch.Tensor):
                return a
            return DTensor.from_local(a, mesh, rep, run_check=False)

        args, kwargs = self._inside_dtensor(lambda: tree_map(replicated, (args, kwargs)))
        if func.overloadpacket in _MATMULS:
            args, kwargs = self._inside_dtensor(lambda: tree_map(_reduced, (args, kwargs)))
        try:
            return self._inside_dtensor(lambda: _reduce_masked(func(*args, **kwargs)))
        except (RuntimeError, NotImplementedError, IndexError) as e:
            # No rule for these placements, or a rule whose bookkeeping needs
            # data (under fake tensors). Replicated operands are always valid:
            # if the op fails on them too, that error is raised.
            reason = str(e).strip().splitlines()[0] if str(e).strip() else type(e).__name__
        if func in _VIEWS:
            out = self._inside_dtensor(lambda: _block_view(args[0], args[1]))
            if out is not None:
                return out
        name = str(func)
        self.fallbacks[name] = self.fallbacks.get(name, 0) + 1
        self.reasons.setdefault(name, reason[:200])

        def gathered(a):
            if isinstance(a, DTensor) and tuple(a.placements) != tuple(rep):
                return a.redistribute(mesh, rep)
            return a

        def local(t):
            return t.to_local() if isinstance(t, DTensor) else t

        def wrapped(t):
            if not isinstance(t, torch.Tensor):
                return t
            return DTensor.from_local(t, mesh, rep, run_check=False)

        def retry():
            a, k = tree_map(gathered, (args, kwargs))
            try:
                return _reduce_masked(func(*a, **k))
            except (RuntimeError, NotImplementedError):
                # no rule even replicated: the op on the whole values,
                # which every rank now holds, its outputs replicated
                la, lk = tree_map(local, (a, k))
                return tree_map(wrapped, func(*la, **lk))

        return self._inside_dtensor(retry)

    def _inside_dtensor(self, fn):
        """``fn()`` with this mode on the stack again, DTensor ops passed to
        DTensor: the local ops it runs come back to :meth:`local_op`."""
        self._inside = True
        try:
            with self:
                return fn()
        finally:
            self._inside = False


def _reshape_groups(a: list, b: list) -> list:
    """The dims a row-major reshape from ``a`` to ``b`` merges or splits
    together: ``[(dims of a, dims of b), ...]`` with equal products."""
    groups, i, j = [], 0, 0
    while i < len(a) or j < len(b):
        ins, outs, pa, pb = [], [], 1, 1
        while True:
            if i < len(a) and (pa < pb or not ins or (pa == pb and a[i] == 1)):
                ins.append(i)
                pa *= a[i]
                i += 1
            elif j < len(b) and (pb < pa or not outs or (pa == pb and b[j] == 1)):
                outs.append(j)
                pb *= b[j]
                j += 1
            else:
                break
        groups.append((ins, outs))
    return groups


def _block_view(t, shape):
    """``t`` (a DTensor) viewed as ``shape`` without moving data, where every
    sharded dim is the first of more than one element in its reshape group
    and the group's first such output dim divides by its shard count: the
    blocks each rank holds are then blocks of that output dim (a reshape
    keeps row-major order). ``None`` where that does not hold. Some
    DTensor versions refuse such views (a split of a sharded dim)."""
    from torch.distributed.tensor import DTensor, Shard

    a = list(t.shape)
    b = list(shape)
    if -1 in b:
        b[b.index(-1)] = math.prod(a) // math.prod(d for d in b if d != -1)
    if math.prod(a) != math.prod(b):
        return None
    first = {}
    for ins, outs in _reshape_groups(a, b):
        big_in = [d for d in ins if a[d] > 1]
        big_out = [d for d in outs if b[d] > 1]
        if big_in and big_out:
            first[big_in[0]] = big_out[0]
    sizes = t.device_mesh.mesh.shape
    placements, ways = [], {}
    for md, p in enumerate(t.placements):
        if isinstance(p, Shard):
            if type(p) is not Shard or p.dim not in first:
                return None
            placements.append(Shard(first[p.dim]))
            ways[first[p.dim]] = ways.get(first[p.dim], 1) * int(sizes[md])
        else:
            placements.append(p)
    if any(b[d] % n for d, n in ways.items()):
        return None
    local_shape = [d // ways.get(i, 1) for i, d in enumerate(b)]
    local = t.to_local()
    if math.prod(local.shape) != math.prod(local_shape):
        return None
    return DTensor.from_local(local.reshape(local_shape), t.device_mesh, placements,
                              run_check=False)


def _reduced(t):
    """A DTensor's partial sums reduced (all-reduced to ``Replicate``)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor) or not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, tuple(Replicate() if p.is_partial() else p
                                               for p in t.placements))


def _reduce_masked(out):
    """Outputs with a masked partial (DTensor's vocabulary-parallel
    ``embedding``/``gather``: each rank's rows, zeros elsewhere) reduced
    to ``Replicate`` on those mesh dims at once: DTensor keeps the mask of
    the op that made it, and a later view (the loss's ``[..., 0]``) leaves
    it the wrong shape."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(t):
        if not isinstance(t, DTensor):
            return t
        pl = tuple(Replicate() if type(p).__name__ == "_MaskPartial" else p
                   for p in t.placements)
        return t if pl == tuple(t.placements) else t.redistribute(t.device_mesh, pl)

    return tree_map(one, out)


def enable(mesh) -> None:
    names = axis_names(mesh)
    _STATE["enabled"] = True
    _STATE["batch_axes"] = tuple(a for a in ("pod", "data") if a in names)
    _STATE["sizes"] = dict(zip(names, (int(s) for s in mesh.mesh.shape)))
    _STATE["mesh"] = mesh


def disable() -> None:
    _STATE["enabled"] = False
    _STATE["mesh"] = None


@contextmanager
def use_mesh_constraints(mesh, mode: ShardedDispatch | None = None):
    """Enable the hooks over ``mesh`` and run the block under ``mode`` (a
    fresh :class:`ShardedDispatch` unless given), which it yields."""
    mode = ShardedDispatch() if mode is None else mode
    enable(mesh)
    try:
        with mode:
            yield mode
    finally:
        disable()


def _size(axes) -> int:
    return math.prod(_STATE["sizes"].get(a, 1) for a in axes)


def _constrain(x, spec: list):
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(_STATE["mesh"], to_placements(tuple(spec), _STATE["mesh"]))


def shard_batch(x, model_dim: int | None = None):
    """Constrain dim0 to the batch axes (when divisible); optionally
    constrain ``model_dim`` to the model axis."""
    if not _STATE["enabled"]:
        return x
    ba = _STATE["batch_axes"]
    spec = [None] * x.ndim
    if x.shape[0] % _size(ba) == 0 and x.shape[0] >= _size(ba):
        spec[0] = ba
    if model_dim is not None:
        md = model_dim % x.ndim
        if x.shape[md] % _size(("model",)) == 0 and spec[md] is None:
            spec[md] = "model"
    return _constrain(x, spec)


def shard_experts(x):
    """Constrain dim0 (experts) to the model axis (expert parallelism)."""
    if not _STATE["enabled"]:
        return x
    if x.shape[0] % _size(("model",)) == 0:
        return _constrain(x, ["model"] + [None] * (x.ndim - 1))
    return x


def shard_seq(x, seq_dim: int = 1):
    """Constrain a sequence dim over 'data' (flash-decoding-style cache)."""
    if not _STATE["enabled"]:
        return x
    spec = [None] * x.ndim
    if x.shape[seq_dim] % _size(("data",)) == 0:
        spec[seq_dim] = "data"
    return _constrain(x, spec)


def shard_group_experts(x):
    """(G, E, C, d) MoE dispatch buffers: G→data, E→model (dual-sharded)."""
    if not _STATE["enabled"]:
        return x
    spec = [None] * x.ndim
    if x.shape[0] % _size(("data",)) == 0:
        spec[0] = "data"
    if x.ndim > 1 and x.shape[1] % _size(("model",)) == 0:
        spec[1] = "model"
    return _constrain(x, spec)


def shard_attention(q, k, v):
    """Grouped attention's operands, queries ``(B, Sq, H, D)`` and
    keys/values ``(B, Sk, Hkv, D)``: the batch over the batch axes (when
    divisible); the model axis over the heads when it divides the KV heads
    (the query heads then split by KV head), else over the query positions
    (keys and values whole on it). GSPMD splits one mesh axis over both
    head dims of the grouped reshape (8 KV heads × 2 of a 16-way axis); a
    DTensor placement cannot, and an unpinned reshape leaves DTensor
    replicating the attention over the axis. The port's own hook: the
    reference needs none."""
    if not _STATE["enabled"]:
        return q, k, v
    B, Sq, H, _ = q.shape
    Hkv = k.shape[2]
    ba, m = _STATE["batch_axes"], _size(("model",))
    qspec, kspec = [None] * 4, [None] * 4
    if B % _size(ba) == 0 and B >= _size(ba):
        qspec[0] = kspec[0] = ba
    if Hkv % m == 0:
        qspec[2] = kspec[2] = "model"
    elif Sq % m == 0 and Sq >= m:
        qspec[1] = "model"
    return _constrain(q, qspec), _constrain(k, kspec), _constrain(v, kspec)


def shard_heads(o):
    """Attention's output ``(B, S, H, D)``: the batch over the batch axes,
    the heads over the model axis when it divides them (else whole on it),
    ready for the row-parallel output projection."""
    if not _STATE["enabled"]:
        return o
    ba, m = _STATE["batch_axes"], _size(("model",))
    spec = [None] * 4
    if o.shape[0] % _size(ba) == 0 and o.shape[0] >= _size(ba):
        spec[0] = ba
    if o.shape[2] % m == 0:
        spec[2] = "model"
    return _constrain(o, spec)


def shard_like(x, ref):
    """``x`` placed as ``ref`` (two DTensors of one shape; else ``x``): the
    attention's output as its queries were, so that the gradient reaches
    the grouped reshape in a placement it can split."""
    from torch.distributed.tensor import DTensor

    if not _STATE["enabled"] or not isinstance(x, DTensor) or not isinstance(ref, DTensor):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


@contextmanager
def gathered_params(module, recurse: bool = True):
    """The block with ``module``'s parameters (its own only, unless
    ``recurse``) gathered over the ``data`` axis: each DTensor parameter
    sharded there (the FSDP shard of :func:`~repro_torch.sharding.rules
    .param_spec`) is replaced, for the block, by its redistribution to
    ``Replicate`` on ``data``, its other placements kept (tensor and expert
    parallel). It is the all-gather GSPMD inserts before the reference's
    weights are used; the gradient flows back through it to the shard (a
    reduce-scatter). The identity when the context is disabled."""
    if not _STATE["enabled"]:
        yield
        return
    from torch.distributed.tensor import DTensor, Replicate

    names = axis_names(_STATE["mesh"])
    swapped = []
    for owner in (module.modules() if recurse else (module,)):
        for name, p in owner._parameters.items():
            if not isinstance(p, DTensor):
                continue
            pl = tuple(Replicate() if n == "data" else q for n, q in zip(names, p.placements))
            if pl != tuple(p.placements):
                swapped.append((owner, name, p))
                owner._parameters[name] = p.redistribute(p.device_mesh, pl)
    try:
        yield
    finally:
        for owner, name, p in swapped:
            owner._parameters[name] = p


def data_axis_size() -> int:
    return _size(("data",))


def batch_shard_count() -> int:
    """Total batch-dim shards (pod × data on the multi-pod mesh)."""
    return _size(_STATE["batch_axes"])


def enabled() -> bool:
    return bool(_STATE["enabled"])
