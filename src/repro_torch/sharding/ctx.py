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

* :class:`ShardedDispatch` (entered by :func:`use_mesh_constraints`)
  applies the port's own rules first, the same decision on every torch
  version — views, advanced indexing, pointwise operands, and ops it runs
  on the blocks (one-operand pointwise ops, scans, scatters, pads, flips,
  ``log_sigmoid_backward``, the embedding's gradient on each rank's
  vocabulary block) — then
  runs the op through DTensor, plain tensors among its operands taken as
  replicated; where DTensor has no rule for an op at its operands'
  placements, it redistributes them to ``Replicate`` (an all-gather, as
  GSPMD's would be) and runs the op again, counting each such point in
  ``fallbacks``; partial sums entering a matmul are reduced first, and
  DTensor's masked partials (a vocabulary-parallel embedding or gather)
  at once;
* :func:`gathered_params` gathers a layer's FSDP-sharded weights over
  ``data`` for the layer's use (the reference's per-use all-gather);
* :func:`shard_head_proj`, :func:`shard_attention`, :func:`shard_like`,
  :func:`shard_heads` and :func:`shard_o_proj` pin grouped attention and
  the xLSTM's head splits, whose reshapes DTensor cannot shard as GSPMD
  does;
* :func:`vocab_parallel_ll` computes the LM loss's log-likelihood from
  each rank's block of the vocabulary;
* :class:`ExpertBlocks` builds and reads the MoE's dispatch buffers on each
  rank's (group, expert) block;
* :func:`placed_as` puts Adafactor's factored statistics in the layout of
  their gradient's reductions.
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
_INDEX_PUTS = (_aten.index_put.default, _aten.index_put_.default)


class ShardedDispatch(TorchDispatchMode):
    """A dispatch mode over DTensor programs. Ops on plain tensors go to
    :meth:`local_op` (the identity here; :class:`repro_torch.launch.op_cost
    .CostMode` counts them): with the mode on the stack, these are the
    local shards' ops that DTensor runs, and its collectives. An op on
    DTensors goes through DTensor with plain tensor operands made
    replicated DTensors; where DTensor has no rule for the operands'
    placements, they are redistributed to ``Replicate`` and the op runs
    again, ``fallbacks[op name]`` counting each such point and
    ``reasons[op name][reason]`` each cause (the first line of the error
    DTensor raised)."""

    def __init__(self):
        super().__init__()
        self.fallbacks: dict[str, int] = {}
        self.reasons: dict[str, dict] = {}    # op → {first line of its error: points}
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
        # the port's own rules first: the same decision on every torch version
        if func in _VIEWS:
            out = self._inside_dtensor(lambda: _block_view(args[0], args[1], func))
            if out is not None:
                return out
        if func in _INDEX_PUTS or func is _aten.index.Tensor:
            out = self._inside_dtensor(lambda: _port_indexing(func, args, kwargs))
            if out is not None:
                return out
        if func is _aten.embedding_dense_backward.default:
            out = self._inside_dtensor(lambda: _embedding_backward_on_blocks(args, kwargs))
            if out is not None:
                return out
        if func in _ELEMENTWISE:
            out = self._inside_dtensor(lambda: _elementwise_on_blocks(func, args, kwargs))
            if out is not None:
                return out
        if func.overloadpacket in _MATMULS:
            args, kwargs = self._inside_dtensor(lambda: tree_map(_reduced, (args, kwargs)))
        elif func in _SCATTERS or func in _SCANS or func in _ALONG_DIMS:
            rule = (_scan_on_blocks if func in _SCANS else
                    _pad_on_blocks if func is _aten.constant_pad_nd.default else
                    _flip_on_blocks if func is _aten.flip.default else _scatter_on_blocks)
            out = self._inside_dtensor(lambda: rule(func, args, kwargs))
            if out is not None:
                return out
        elif torch.Tag.pointwise in func.tags:
            out = self._inside_dtensor(lambda: _pointwise_on_blocks(func, args, kwargs))
            if out is not None:
                return out
            args = self._inside_dtensor(lambda: _pointwise_operands(func, args, kwargs))
            out = self._inside_dtensor(lambda: _broadcast_on_blocks(func, args, kwargs))
            if out is not None:
                return out
        try:
            plain_args, plain_kwargs, strided = self._inside_dtensor(
                lambda: _unstride(func, args, kwargs))
            return self._inside_dtensor(lambda: _restride(
                _reduce_masked(func(*plain_args, **plain_kwargs)), strided))
        except (RuntimeError, NotImplementedError, IndexError) as e:
            # No rule for these placements, or a rule whose bookkeeping needs
            # data (under fake tensors). Replicated operands are always valid:
            # if the op fails on them too, that error is raised.
            reason = str(e).strip().splitlines()[0] if str(e).strip() else type(e).__name__
        name = str(func)
        self.fallbacks[name] = self.fallbacks.get(name, 0) + 1
        why = self.reasons.setdefault(name, {})
        why[reason[:200]] = why.get(reason[:200], 0) + 1

        def gathered(a):
            if isinstance(a, DTensor) and tuple(a.placements) != tuple(rep):
                return _moved(a, rep)
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


def _moved(t, placements):
    """DTensor ``t`` redistributed to ``placements`` inside the dispatch
    (below autograd, which records the op, not its operands' moves), from
    an alias that does not require grad: DTensor 2.11 detaches in place the
    output of a move of a tensor that requires grad under no grad (a
    backward pass), an op it has no rule for. The alias keeps ``t``'s spec
    (a ``detach`` op would rebuild it, and 2.11 would read a view's
    ``_StridedShard`` as a shard order)."""
    from torch.distributed.tensor import DTensor

    if t.requires_grad:
        t = DTensor(t._local_tensor, t._spec, requires_grad=False)
    return t.redistribute(t.device_mesh, placements)


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


def _strided(dim: int, split_factor: int):
    from torch.distributed.tensor.placement_types import _StridedShard

    return _StridedShard(dim, split_factor=split_factor)


def _shard_of(p):
    """``(dim, split_factor)`` of a ``Shard`` (factor 1) or ``_StridedShard``
    placement; ``None`` for any other placement."""
    from torch.distributed.tensor import Shard

    if type(p) is Shard:
        return p.dim, 1
    if type(p).__name__ == "_StridedShard":
        return p.dim, int(p.split_factor)
    return None


def _dim_digits(t):
    """Each dim of DTensor ``t``'s global index as a row-major list of
    digits ``[radix, owner, dim, kind]``: ``owner`` the mesh dim whose
    coordinate the digit is (its radix that mesh dim's size), or ``None``
    for a digit of the local block. Built by applying the placements in
    mesh order, as DTensor does: ``Shard`` chunks the local extent,
    ``_StridedShard(sf)`` chunks each of its ``sf`` pieces. ``kind`` marks
    the two uneven cases (``torch.chunk``'s sizes): ``"chunk"``, a dim one
    mesh dim shards unevenly (one digit, its local extent the rank's own),
    and ``"whole"``, any other uneven dim (one digit, owned by the tuple of
    its mesh dims, that only moves as a whole dim). ``None`` where a
    placement is not a shard, replicate or partial one."""
    digits = [[[n, None, d, None]] for d, n in enumerate(t.shape)]
    sizes = t.device_mesh.shape       # no ops (its .mesh tensor is built by ops)
    shards = {}
    for m, p in enumerate(t.placements):
        if p.is_replicate() or p.is_partial():
            continue
        if _shard_of(p) is None:
            return None
        shards.setdefault(_shard_of(p)[0], []).append(m)
    local = t._local_tensor.shape
    for d, ms in shards.items():
        dd = digits[d]
        for m in ms:
            if not _split_digit(dd, m, int(sizes[m]), _shard_of(t.placements[m])[1], d):
                if len(ms) == 1 and t.shape[d] > 1:
                    digits[d] = [[t.shape[d], m, d, "chunk", local[d]]]
                else:
                    digits[d] = [[t.shape[d], tuple(ms), d, "whole"]]
                break
    return digits


def _split_digit(dd: list, m: int, n: int, sf: int, d: int) -> bool:
    """Mesh dim ``m`` (size ``n``) chunking dim ``d``'s digits ``dd`` in
    place, after ``sf`` pieces of its local digits; False where the local
    digits do not factor so."""
    i, acc = 0, 1
    while True:
        while i < len(dd) and dd[i][1] is not None:
            i += 1
        if acc == sf:
            break
        if i == len(dd) or sf % acc:
            return False
        r, need = dd[i][0], sf // acc
        if r <= need:
            if need % r:
                return False
            acc *= r
        else:
            if r % need:
                return False
            dd[i:i + 1] = [[need, None, d, None], [r // need, None, d, None]]
            acc = sf
        i += 1
    if i == len(dd):
        if n != 1:
            return False
        dd.append([1, m, d, None])
    elif dd[i][0] % n == 0:
        dd[i:i + 1] = [[n, m, d, None], [dd[i][0] // n, None, d, None]]
    else:
        return False
    return True


def _view_placements(t, shape):
    """The placements and the local shape that view DTensor ``t`` as
    ``shape`` without moving data, or ``None``: the port's own view rule,
    the same on every torch version. Each reshape group's digits
    (:func:`_dim_digits`) are laid out over its output dims in row-major
    order (a local digit may split; a mesh dim's may not; an uneven one
    must end its output dim, or be all of it), and a mesh dim's placement
    is read off its output dim: ``Shard`` where no digit still to be
    chunked precedes its own, else ``_StridedShard`` with their product as
    the split factor — what torch 2.13's ``_view_ops`` gives, also its
    ``_StridedShard`` of factor 1 for a sharded non-first dim of a
    flattening."""
    from torch.distributed.tensor import Shard

    a, b = list(t.shape), list(shape)
    if -1 in b:
        b[b.index(-1)] = math.prod(a) // math.prod(d for d in b if d != -1)
    if math.prod(a) != math.prod(b):
        return None
    digits = _dim_digits(t)
    if digits is None:
        return None
    out_digits = [[] for _ in b]
    flatten_first = {}       # output dim -> the first input dim of its flattening
    for ins, outs in _reshape_groups(a, b):
        seq = []         # adjacent local digits merged: any factoring of them is a layout
        for x in (x for d in ins for x in digits[d] if x[0] != 1 or x[1] is not None):
            if seq and x[1] is None and x[3] is None and seq[-1][1] is None \
                    and seq[-1][3] is None:
                seq[-1] = [seq[-1][0] * x[0]] + seq[-1][1:]
            else:
                seq.append(list(x))
        big_in = [d for d in ins if a[d] > 1]
        big_out = [o for o in outs if b[o] > 1]
        if len(big_out) == 1 and len(big_in) > 1:
            flatten_first[big_out[0]] = big_in[0]
        for k, o in enumerate(outs):
            acc, last = 1, k == len(outs) - 1
            while seq and (acc < b[o] or (seq[0][0] == 1 and (last or b[o] == 1))):
                x = seq[0]
                r, own, kind = x[0], x[1], x[3]
                if kind == "whole" and (acc != 1 or r != b[o]):
                    return None
                if acc * r <= b[o] and b[o] % (acc * r) == 0:
                    if kind == "chunk" and acc * r != b[o]:
                        return None
                    out_digits[o].append(seq.pop(0))
                    acc *= r
                elif own is None and b[o] % acc == 0 and r % (b[o] // acc) == 0:
                    need = b[o] // acc
                    out_digits[o].append([need] + x[1:])
                    seq[0] = [r // need] + x[1:]
                    acc = b[o]
                else:
                    return None
            if acc != b[o]:
                return None
        if seq:
            return None
    placements = []
    for m, p in enumerate(t.placements):
        if _shard_of(p) is None:
            placements.append(p)
            continue
        o, k = next((o, k) for o, od in enumerate(out_digits) for k, x in enumerate(od)
                    if x[1] == m or (isinstance(x[1], tuple) and m in x[1]))
        od = out_digits[o]
        if od[k][3] == "whole":          # the dim moved whole: its placements with it
            placements.append(type(p)(o) if _shard_of(p)[1] == 1 else _strided(o, p.split_factor))
            continue
        sf = math.prod(x[0] for x in od[:k]
                       if x[1] is None or (not isinstance(x[1], tuple) and x[1] > m))
        strided = sf > 1 or flatten_first.get(o, od[k][2]) != od[k][2]
        placements.append(_strided(o, sf) if strided else Shard(o))
    local_shape = [math.prod(x[4] if x[3] == "chunk" else x[0] for x in od
                             if x[1] is None or x[3] in ("chunk", "whole")) for od in out_digits]
    if any(x[3] == "whole" for od in out_digits for x in od):
        local_shape = [t._local_tensor.shape[od[0][2]] if od and od[0][3] == "whole" else n
                       for od, n in zip(out_digits, local_shape)]
    return placements, local_shape, b


def _block_view(t, shape, func=_aten.reshape.default):
    """``t`` viewed as ``shape`` by :func:`_view_placements`, its local
    block reshaped in place of DTensor's rule; ``None`` where the rule has
    no layout."""
    got = _view_placements(t, shape)
    if got is None:
        return None
    placements, local_shape, b = got
    local = t._local_tensor
    if math.prod(local.shape) != math.prod(local_shape):
        return None
    try:            # the local op DTensor's own rule runs
        out = func(local, local_shape)
    except RuntimeError:
        out = local.reshape(local_shape)
    stride = _view_strides(list(t.shape), list(t.stride()), b) or _contiguous_strides(b)
    return _wrap(out, t.device_mesh, placements, b, stride)


def _view_strides(shape: list, stride: list, new: list):
    """The strides of a view of a ``shape``/``stride`` tensor as ``new``
    (ATen's ``computeStride``), or ``None`` where it has none."""
    if math.prod(shape) == 0 or not shape:
        return None
    out = [0] * len(new)
    view_d, base, t_numel, v_numel = len(new) - 1, stride[-1], 1, 1
    for d in range(len(shape) - 1, -1, -1):
        t_numel *= shape[d]
        if d == 0 or (shape[d - 1] != 1 and stride[d - 1] != t_numel * base):
            while view_d >= 0 and (v_numel < t_numel or new[view_d] == 1):
                out[view_d] = v_numel * base
                v_numel *= new[view_d]
                view_d -= 1
            if v_numel != t_numel:
                return None
            if d > 0:
                base, t_numel, v_numel = stride[d - 1], 1, 1
    return tuple(out) if view_d == -1 else None


def _wrap(local, mesh, placements, shape, stride, strided: bool = True):
    """A DTensor of ``local`` blocks with ``placements``, global ``shape``
    and ``stride``; a ``_StridedShard`` among them keeps the meaning a view
    gives it (its split factor's pieces, not a shard order), as DTensor's
    own view rule marks it."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta

    meta = TensorMeta(torch.Size(shape), tuple(stride), local.dtype)
    spec = (DTensorSpec(mesh, tuple(placements), tensor_meta=meta,
                        use_strided_shard_as_shard_order=False)
            if strided and any(_is_strided(p) for p in placements)
            else DTensorSpec(mesh, tuple(placements), tensor_meta=meta))
    return DTensor(local, spec, requires_grad=False)


def _contiguous_strides(shape) -> tuple:
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))


def _gather_on(t, m: int):
    """DTensor ``t`` made whole on mesh dim ``m`` (an all-gather there)."""
    from torch.distributed.tensor import Replicate

    if t.placements[m].is_replicate():
        return t
    return _moved(t, [Replicate() if k == m else p for k, p in enumerate(t.placements)])


def _port_indexing(func, args, kwargs):
    """Advanced indexing — ``index`` (a gather, ``self[indices]``) and
    ``index_put``/``index_put_`` (``self[indices] = values``) — on the
    blocks, the port's rule, mesh dim by mesh dim, the same on every torch
    version (some have no rule for a ``None`` index, the backward of the
    MoE dispatch's ``xt[:, tok]``, or for the MoE combine's ``(group,
    slot)`` gather at decode):

    * a mesh dim that shards the index tensors on one dim of their
      broadcast: a gather's output is sharded there (whole indices cut
      alike, ``self`` gathered where an indexed dim of it is sharded); a
      write gathers its indices and values there and writes whole;
    * one that shards ``self`` on a dim the indices slice (``None``) or
      leave: the output follows it (a write's whole values cut alike), and
      so does a write's whole ``self`` where the values are sharded on such
      a dim;
    * one on which everything is whole: ``self``'s last dim, if no index
      addresses it and it divides, is cut there (no data moves), as torch
      2.13's DTensor places these ops.

    The indexed dims must be adjacent, the placements shards or replicas;
    a ``self`` sharded on an indexed dim with whole indices (a
    vocabulary-parallel lookup) and anything else is left to DTensor
    (``None``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    put = func in _INDEX_PUTS
    self_t, indices = args[0], list(args[1])
    values = args[2] if put else None
    accumulate = (args[3] if len(args) > 3 else kwargs.get("accumulate", False)) if put else None
    if not isinstance(self_t, DTensor):
        return None
    mesh = self_t.device_mesh
    where = [i for i, ix in enumerate(indices) if ix is not None]
    if not where or where != list(range(where[0], where[-1] + 1)):
        return None
    idx = [indices[i] if isinstance(indices[i], DTensor) else
           DTensor.from_local(indices[i], mesh, [Replicate()] * mesh.ndim, run_check=False)
           for i in where]
    operands = [self_t] + idx + ([values] if isinstance(values, DTensor) else [])
    if any(not (p.is_replicate() or type(p) is Shard) for t in operands for p in t.placements):
        return None
    first, last = where[0], where[-1]
    nb = max(t.dim() for t in idx)
    bshape = torch.broadcast_shapes(*(t.shape for t in idx))
    res = list(self_t.shape[:first]) + list(bshape) + list(self_t.shape[last + 1:])

    def self_to_res(d):          # a dim of self the indices do not address → the result's
        return None if first <= d <= last else d if d < first else d - (last - first + 1) + nb

    def res_to_self(r):
        return r if r < first else None if r < first + nb else r - nb + (last - first + 1)

    voff = len(res) - values.dim() if put else 0
    # a plan per mesh dim: ("gather", o) the indices sharded on result dim o;
    # ("follow", r) self or the values sharded on result dim r; None whole
    plan = []
    for m in range(mesh.ndim):
        ps = self_t.placements[m]
        pv = values.placements[m] if put and isinstance(values, DTensor) else Replicate()
        ix_dims = {first + p.dim + nb - t.dim() for t in idx for p in [t.placements[m]]
                   if p.is_shard()}
        if len(ix_dims) > 1:
            return None
        if ix_dims:
            if ps.is_shard() and self_to_res(ps.dim) is not None:
                return None
            plan.append(("gather", ix_dims.pop()))
        elif ps.is_shard():
            r = self_to_res(ps.dim)
            if r is None or (put and pv.is_shard() and pv.dim + voff != r):
                return None                  # a lookup of a sharded dim: DTensor's
            plan.append(("follow", r))
        elif pv.is_shard():
            if res_to_self(pv.dim + voff) is None or values.shape[pv.dim] != res[pv.dim + voff]:
                return None
            plan.append(("follow", pv.dim + voff))
        else:
            plan.append(None)
    # where an operand is gathered, cut self's last dim first on the mesh dims
    # where all is whole (less to move), as torch 2.13's DTensor does
    gathers = any(p is not None and p[0] == "gather" and
                  (put or self_t.placements[m].is_shard()) for m, p in enumerate(plan))
    last_dim = self_t.dim() - 1
    r_last = self_to_res(last_dim)
    out_pl = [None] * mesh.ndim
    for m, p in enumerate(plan):
        if p is not None or func is _aten.index_put_.default or not gathers or \
                r_last is None or self_t.shape[last_dim] % mesh.shape[m] or \
                any(q.is_shard() and q.dim == last_dim for q in self_t.placements):
            continue
        self_t = _cut(self_t, m, last_dim)
        if put and isinstance(values, DTensor) and 0 <= r_last - voff < values.dim() \
                and values.shape[r_last - voff] > 1:
            values = _cut(values, m, r_last - voff)
        out_pl[m] = Shard(last_dim if put else r_last)
    for m, p in enumerate(plan):
        if self_t is None or values is None and put:
            return None
        if p is None:
            out_pl[m] = out_pl[m] or Replicate()
        elif p[0] == "gather":
            if self_t.placements[m].is_shard():
                self_t = _gather_on(self_t, m)
            if put:
                idx = [_gather_on(t, m) for t in idx]
                if isinstance(values, DTensor):
                    values = _gather_on(values, m)
                out_pl[m] = Replicate()
                continue
            o = p[1]
            idx = [_cut(t, m, o - first - (nb - t.dim()))
                   if t.placements[m].is_replicate() and t.shape[o - first - (nb - t.dim())] > 1
                   else t for t in idx]
            out_pl[m] = Shard(o)
        else:
            r = p[1]
            if self_t.placements[m].is_replicate():      # the values' blocks: self cut alike
                self_t = _cut(self_t, m, res_to_self(r))
            if put and isinstance(values, DTensor) and values.placements[m].is_replicate() \
                    and 0 <= r - voff < values.dim() and values.shape[r - voff] > 1:
                values = _cut(values, m, r - voff)
            out_pl[m] = Shard(res_to_self(r)) if put else Shard(r)
    if self_t is None or values is None and put or any(t is None for t in idx):
        return None
    if func is _aten.index_put_.default and tuple(out_pl) != tuple(args[0].placements):
        return None
    local_idx = [None] * len(indices)
    for i, t in zip(where, idx):
        local_idx[i] = t._local_tensor
    if put:
        vloc = values._local_tensor if isinstance(values, DTensor) else values
        out = func(self_t._local_tensor, local_idx, vloc, accumulate)
        if func is _aten.index_put_.default:
            return args[0]
        shape = self_t.shape
    else:
        out = func(self_t._local_tensor, local_idx)
        shape = torch.Size(res)
    return _wrap(out, mesh, out_pl, shape, _contiguous_strides(shape))


def _block_start(mesh, dims, block: int) -> int:
    """This rank's first index along a tensor dim cut into blocks of
    ``block`` over the mesh dims ``dims`` (in mesh order, the first
    outermost, as DTensor chunks a dim several mesh dims shard)."""
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    first = 0
    for m in dims:
        first = first * mesh.shape[m] + coord[m]
    return first * block


def _embedding_backward_on_blocks(args, kwargs):
    """``embedding_dense_backward`` of the vocabulary-parallel lookup on the
    blocks, the port's rule (DTensor's makes each rank's gradient the whole
    ``(V, d)`` table, a partial sum over the batch axes). The forward's
    output was reduced to whole on the mesh dims that cut the vocabulary,
    so the gradient and the indices come whole there: on each such mesh
    dim (of more than one rank, dividing V) the output is cut on the
    vocabulary rows, each rank scatter-adding only the tokens of its own
    block (the others to a row past it, dropped); a mesh dim that shards
    the indices and the gradient on one batch dim makes it a partial sum,
    one that shards the gradient's features alone cuts its columns. The
    result is the layout GSPMD gives the reference's scatter-add; the
    partial sums are reduce-scattered to the FSDP shard where the gathered
    weight's gradient returns to the parameter. ``None`` (DTensor's rule)
    where it does not apply."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    grad, idx, V = args[0], args[1], int(args[2])
    pad = args[3] if len(args) > 3 else kwargs.get("padding_idx", -1)
    freq = args[4] if len(args) > 4 else kwargs.get("scale_grad_by_freq", False)
    if freq or not isinstance(grad, DTensor) or not isinstance(idx, DTensor):
        return None
    mesh = grad.device_mesh
    out_pl, vocab = [], []
    for m in range(mesh.ndim):
        pg, pi = grad.placements[m], idx.placements[m]
        if pg.is_replicate() and pi.is_replicate():
            if mesh.shape[m] > 1:
                vocab.append(m)
            out_pl.append(Shard(0) if mesh.shape[m] > 1 else pg)
        elif type(pg) is Shard and type(pi) is Shard and pg.dim == pi.dim:
            out_pl.append(Partial())
        elif type(pg) is Shard and pg.dim == grad.dim() - 1 and pi.is_replicate():
            out_pl.append(Shard(1))
        else:
            return None
    n = math.prod(mesh.shape[m] for m in vocab)
    if not vocab or V % n:
        return None
    Vb = V // n
    first = _block_start(mesh, vocab, Vb)
    lg, li = grad._local_tensor, idx._local_tensor
    local = li - first
    inside = (local >= 0) & (local < Vb)
    if pad is not None and pad >= 0:
        inside = inside & (li != pad)
    local = torch.where(inside, local, Vb)
    out = _aten.embedding_dense_backward.default(lg, local, Vb + 1, Vb, False)[:Vb]
    shape = (V, grad.shape[-1])
    return _wrap(out, mesh, out_pl, shape, _contiguous_strides(shape))


def _is_strided(p) -> bool:
    return type(p).__name__ == "_StridedShard"


# ops whose output dims are their input's, moved or not, each rank's block
# kept: a strided layout passes them as it is
_STRUCTURAL = {_aten.detach.default, _aten.transpose.int, _aten.permute.default,
               _aten.t.default, _aten.clone.default, _aten._to_copy.default,
               _aten.alias.default}
# a matmul's operands' strided dims (None: whole) where each rank's blocks
# line up: the batch dims, the contracted dims, or one free dim with the
# other operand whole
_STRIDED_MATMULS = {_aten.bmm.default: ((0, 0), (2, 1), (1, None), (None, 2)),
                    _aten.mm.default: ((1, 0), (0, None), (None, 1))}


def _strided_aligned(func, tensors, m) -> bool:
    """Whether ``func`` may run with the operands' ``_StridedShard`` on mesh
    dim ``m`` taken as a ``Shard`` of the same dim (each rank's blocks line
    up, whatever rows they hold)."""
    dims = tuple(t.placements[m].dim if _is_strided(t.placements[m]) else None
                 for t in tensors)
    if func in _STRIDED_MATMULS:
        return len(tensors) == 2 and dims in _STRIDED_MATMULS[func] and all(
            _is_strided(p) or p.is_replicate() for p in (t.placements[m] for t in tensors))
    if None in dims:
        return False
    if func in _STRUCTURAL:
        return len(tensors) == 1
    if torch.Tag.pointwise in func.tags:
        nd = max(t.dim() for t in tensors)
        out = [d + nd - t.dim() for d, t in zip(dims, tensors)]
        return len(set(out)) == 1 and len({t.shape[d] for d, t in zip(dims, tensors)}) == 1
    return False


def _unstride(func, args, kwargs):
    """Operands without ``_StridedShard`` placements, which DTensor versions
    treat differently (a view's strided blocks, or a shard order): on a
    mesh dim where every DTensor operand is strided alike and ``func``
    keeps each rank's blocks together (:func:`_strided_aligned`), they are
    relabelled ``Shard`` for DTensor and :func:`_restride` relabels the
    outputs back; on any other mesh dim they are gathered there first.
    Returns ``(args, kwargs, {mesh dim: split factor relabelled})``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    tensors = [a for a in tree_leaves((args, kwargs)) if isinstance(a, DTensor)]
    marked = {m for t in tensors for m, p in enumerate(t.placements) if _is_strided(p)}
    if not marked:
        return args, kwargs, {}
    relabel, gather = {}, set()
    for m in marked:
        pls = [t.placements[m] for t in tensors]
        sfs = {p.split_factor for p in pls if _is_strided(p)}
        if len(sfs) == 1 and _strided_aligned(func, tensors, m):
            relabel[m] = sfs.pop()
        else:
            gather.add(m)

    def plain(a):
        if not isinstance(a, DTensor):
            return a
        pl = list(a.placements)
        if any(m in relabel for m in range(len(pl))):
            pl = [Shard(p.dim) if m in relabel and _is_strided(p) else p
                  for m, p in enumerate(pl)]
            a = _wrap(a._local_tensor, a.device_mesh, pl, a.shape, a.stride(), strided=False)
        if any(m in gather and _is_strided(p) for m, p in enumerate(pl)):
            a = _moved(a, [Replicate() if m in gather and _is_strided(p) else p
                           for m, p in enumerate(pl)])
        return a

    args, kwargs = tree_map(plain, (args, kwargs))
    return args, kwargs, relabel


def _restride(out, relabel: dict):
    """``out``'s placements on the relabelled mesh dims made strided again
    (:func:`_unstride`); an output DTensor made whole there is refused."""
    from torch.distributed.tensor import DTensor

    if not relabel:
        return out

    def one(t):
        if not isinstance(t, DTensor):
            return t
        pl = list(t.placements)
        for m, sf in relabel.items():
            if pl[m].is_shard():
                pl[m] = _strided(pl[m].dim, sf)
            elif not pl[m].is_partial():
                raise RuntimeError("a strided layout was gathered under a relabelled shard")
        return _wrap(t._local_tensor, t.device_mesh, pl, t.shape, t.stride())

    return tree_map(one, out)


def _cut(t, m: int, d: int):
    """DTensor ``t``, whole on mesh dim ``m``, cut to ``Shard(d)`` there on
    its own blocks (this rank's chunk of dim ``d``, within the chunks of the
    mesh dims before ``m`` that shard it: no data moves); ``None`` where a
    later mesh dim shards dim ``d`` already, or its blocks do not divide
    evenly."""
    from torch.distributed.tensor import Shard

    if t is None:
        return None
    n = t.device_mesh.shape[m]
    local = t._local_tensor
    if any(_shard_of(p) and _shard_of(p)[0] == d and (k > m or type(p) is not Shard)
           for k, p in enumerate(t.placements)) or local.shape[d] % n:
        return None
    size = local.shape[d] // n
    coord = t.device_mesh.get_coordinate()
    c = coord[m] if coord is not None else 0
    pl = [Shard(d) if k == m else p for k, p in enumerate(t.placements)]
    return _wrap(local.narrow(d, c * size, size), t.device_mesh, pl, t.shape, t.stride())


_ADDITIVE = {_aten.add.Tensor, _aten.sub.Tensor}
# elementwise ops without the pointwise tag that DTensor has no strategy for
_ELEMENTWISE = (_aten.log_sigmoid_backward.default,)


def _elementwise_on_blocks(func, args, kwargs):
    """An elementwise op DTensor has no strategy for (``log_sigmoid_backward``:
    the mLSTM forget gate's, whose saved input is a partial sum) run on the
    blocks: its tensor operands of the first's shape placed as the first,
    partial sums reduced (to a shard where the first is sharded: a
    reduce-scatter), the output placed alike; others (an empty buffer)
    passed as their blocks. ``None`` where the first is not a DTensor of
    shards and replicas."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    first = args[0]
    if not isinstance(first, DTensor) or kwargs:
        return None
    pl = [Replicate() if p.is_partial() else p for p in first.placements]
    if any(not (p.is_replicate() or type(p) is Shard) for p in pl):
        return None
    local = []
    for a in args:
        if isinstance(a, DTensor):
            if a.shape == first.shape and tuple(a.placements) != tuple(pl):
                a = _moved(a, pl)
            a = a._local_tensor
        local.append(a)
    out = func(*local)
    return _wrap(out, first.device_mesh, pl, first.shape, _contiguous_strides(first.shape))


def _pointwise_on_blocks(func, args, kwargs):
    """A pointwise op of one DTensor (its other arguments no tensors) with
    no partial placement run on its block, the output placed as the
    operand: what DTensor does where it has a rule for the op, the same on
    every version (2.11 has none for some, ``softplus`` among them, and
    runs their decompositions, each step an op). ``None`` where it does
    not apply."""
    from torch.distributed.tensor import DTensor

    if len(args) < 1 or not isinstance(args[0], DTensor) or func._schema.is_mutable \
            or any(isinstance(a, torch.Tensor) for a in tree_leaves((args[1:], kwargs))):
        return None
    t = args[0]
    if any(p.is_partial() for p in t.placements) or len(func._schema.returns) != 1:
        return None
    out = func(t._local_tensor, *args[1:], **kwargs)
    if not isinstance(out, torch.Tensor) or out.shape != t._local_tensor.shape:
        return None
    stride = t.stride() if out.stride() == t._local_tensor.stride() else _contiguous_strides(t.shape)
    return _wrap(out, t.device_mesh, t.placements, t.shape, stride)


def _linear_partial(p) -> bool:
    return type(p).__name__ == "Partial" and p.reduce_op in ("sum", "avg")


def _pointwise_operands(func, args, kwargs):
    """The operands of a pointwise op of two DTensors placed so that every
    torch version decides the op alike, mesh dim by mesh dim (``args``
    unchanged where it does not apply). DTensor 2.11 follows one operand's
    placements, by shard count, then rank, then order; 2.13 costs the
    redistributions of each choice. The port keeps the Megatron layout, in
    which activations stay whole on ``model`` between the row-parallel
    reduction and the next column-parallel product:

    * one operand sharded on a dim the other, replicated, spans: the
      smaller operand is made to follow the larger — gathered if it is the
      sharded one (the RMSNorm weight's product: 2.13 cut the activation),
      else cut (no data moves);
    * one operand sharded, the other a partial sum: the partial sum
      reduce-scattered to the shard's dim (all-reduced where it broadcasts
      there) — 2.11 has no rule for it (jamba's ``S(1) + P`` adds);
    * one operand whole, the other a partial sum: the partial sum reduced
      (the residual ``add``: 2.13 kept it partial; 2.11 reduces or keeps it
      by the operands' order);
    * two partial sums in any op but a sum or difference (where they stay
      partial on every version): both reduced.

    Partial sums and means count alike. In-place and out variants, strided
    layouts and other partial kinds are left to DTensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    where = [i for i, a in enumerate(args) if isinstance(a, DTensor)]
    if len(where) != 2 or kwargs or func._schema.is_mutable:
        return args
    ts = [args[i] for i in where]
    if ts[0].device_mesh != ts[1].device_mesh or any(
            not (p.is_replicate() or type(p) is Shard or _linear_partial(p))
            for t in ts for p in t.placements):
        return args
    nd = len(torch.broadcast_shapes(ts[0].shape, ts[1].shape))
    pl = [list(t.placements) for t in ts]

    def spans(k, i):          # operand k's dim at broadcast dim i, None where it broadcasts
        j = i - (nd - ts[k].dim())
        return j if j >= 0 and ts[k].shape[j] > 1 else None

    for m in range(ts[0].device_mesh.ndim):
        p = [pl[0][m], pl[1][m]]
        sharded = [k for k in (0, 1) if type(p[k]) is Shard]
        partial = [k for k in (0, 1) if _linear_partial(p[k])]
        if len(sharded) == 1:
            s, o = sharded[0], 1 - sharded[0]
            j = spans(o, p[s].dim + nd - ts[s].dim())
            if p[o].is_replicate() and j is not None:
                if ts[s].numel() < ts[o].numel():
                    pl[s][m] = Replicate()
                else:
                    pl[o][m] = Shard(j)
            elif partial:
                pl[o][m] = Shard(j) if j is not None else Replicate()
        elif len(partial) == 1 and not sharded or len(partial) == 2 and func not in _ADDITIVE:
            for k in partial:
                pl[k][m] = Replicate()
    out = list(args)
    for i, t, new in zip(where, ts, pl):
        if new != list(t.placements):
            out[i] = _moved(t, new)
    return tuple(out)


def _broadcast_on_blocks(func, args, kwargs):
    """A pointwise op of two DTensors where, on some mesh dim, one is
    sharded on a dim along which the other, replicated, broadcasts (size 1:
    Adafactor's outer product of its row and column factors) run on the
    blocks, the output sharded as each operand is: no data moves. DTensor
    2.13 places it so; 2.11 gathered the sharded operand (its output 16
    times a rank's block). ``None`` where no mesh dim is such, or a
    placement is partial or strided, or the blocks do not line up."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    where = [i for i, a in enumerate(args) if isinstance(a, DTensor)]
    if len(where) != 2 or kwargs or func._schema.is_mutable or len(func._schema.returns) != 1:
        return None
    ts = [args[i] for i in where]
    mesh = ts[0].device_mesh
    if ts[1].device_mesh != mesh or any(not (p.is_replicate() or type(p) is Shard)
                                        for t in ts for p in t.placements):
        return None
    shape = torch.broadcast_shapes(ts[0].shape, ts[1].shape)
    nd = len(shape)

    def size(k, i):               # operand k's extent along output dim i (1: broadcast)
        j = i - (nd - ts[k].dim())
        return ts[k].shape[j] if j >= 0 else 1

    out_pl, broadcast = [], False
    for m in range(mesh.ndim):
        dims = [p.dim + nd - t.dim() if p.is_shard() else None
                for t, p in ((t, t.placements[m]) for t in ts)]
        sharded = [d for d in dims if d is not None]
        if not sharded:
            out_pl.append(Replicate())
        elif len(sharded) == 2:
            if dims[0] != dims[1] or size(0, dims[0]) != size(1, dims[0]):
                return None
            out_pl.append(Shard(dims[0]))
        else:
            k = 1 - dims.index(sharded[0])
            if size(k, sharded[0]) != 1:
                return None
            broadcast = True
            out_pl.append(Shard(sharded[0]))
    if not broadcast:
        return None
    local = list(args)
    for i, t in zip(where, ts):
        local[i] = t._local_tensor
    out = func(*local)
    want = list(shape)
    for m, p in enumerate(out_pl):
        if p.is_shard():
            if want[p.dim] % mesh.shape[m]:
                return None
            want[p.dim] //= mesh.shape[m]
    if list(out.shape) != want:
        return None
    return _wrap(out, mesh, out_pl, shape, _contiguous_strides(shape))


_SCATTERS = (_aten.scatter.src, _aten.scatter.value, _aten.scatter_add.default)


def _scatter_on_blocks(func, args, kwargs):
    """``scatter`` (``.src``, ``.value``, ``scatter_add``) of an index (and
    source) sharded on dims other than the scattered one, run on the blocks:
    a whole ``self`` is cut alike (no data moves), the op runs on each
    rank's blocks and the output keeps their placements — the same on
    every version (2.11's ``sort`` backward scatters into a plain ``zeros``
    of the whole shape, and its DTensor gathers all three operands for a
    scatter). ``None`` where it does not apply."""
    from torch.distributed.tensor import DTensor, Shard

    self_t, dim, index = args[0], args[1], args[2]
    src = args[3] if len(args) > 3 and isinstance(args[3], DTensor) else None
    if not isinstance(self_t, DTensor) or not isinstance(index, DTensor) \
            or self_t.shape != index.shape or (src is not None and src.shape != index.shape):
        return None
    dim %= self_t.dim()
    pl = list(index.placements)
    if any(not (p.is_replicate() or type(p) is Shard and p.dim != dim) for p in pl) \
            or (src is not None and list(src.placements) != pl) \
            or any(not (q.is_replicate() or q == p) for p, q in zip(pl, self_t.placements)):
        return None
    if list(self_t.placements) != pl:
        self_t = _moved(self_t, pl)
    rest = (src._local_tensor,) if src is not None else tuple(args[3:])
    out = func(self_t._local_tensor, dim, index._local_tensor, *rest, **kwargs)
    return _wrap(out, self_t.device_mesh, pl, self_t.shape, _contiguous_strides(self_t.shape))


_SCANS = (_aten.cumsum.default, _aten.cumprod.default, _aten.logcumsumexp.default,
          _aten.cummax.default, _aten.cummin.default)


def _scan_on_blocks(func, args, kwargs):
    """A scan (``cumsum``, ``cummax``, …) along a dim no mesh dim shards,
    nothing partial, run on the blocks, each output placed as the input
    (2.11 has no rule for ``cummax``: the mLSTM's chunkwise stabiliser).
    ``None`` where it does not apply."""
    from torch.distributed.tensor import DTensor

    t = args[0]
    if not isinstance(t, DTensor):
        return None
    dim = args[1] % t.dim()
    if any(not p.is_replicate() and (_shard_of(p) is None or _shard_of(p)[0] == dim)
           for p in t.placements):
        return None
    out = func(t._local_tensor, *args[1:], **kwargs)
    wrap = lambda o: _wrap(o, t.device_mesh, t.placements, t.shape, _contiguous_strides(t.shape))
    return tuple(map(wrap, out)) if isinstance(out, (tuple, list)) else wrap(out)


# ops along some dims, run on the blocks where no mesh dim shards those
_ALONG_DIMS = (_aten.constant_pad_nd.default, _aten.flip.default)


def _flip_on_blocks(func, args, kwargs):
    """``flip`` of dims no mesh dim shards, run on the blocks, the output
    placed as the input, partial sums kept (a flip is linear): 2.11 has no
    rule for it (``cumsum``'s backward flips the mLSTM's gate sums).
    ``None`` where it does not apply."""
    from torch.distributed.tensor import DTensor

    t = args[0]
    if not isinstance(t, DTensor):
        return None
    dims = {d % t.dim() for d in args[1]}
    if any(not (p.is_replicate() or _linear_partial(p)) and
           (_shard_of(p) is None or _shard_of(p)[0] in dims) for p in t.placements):
        return None
    out = func(t._local_tensor, *args[1:], **kwargs)
    return _wrap(out, t.device_mesh, t.placements, t.shape, _contiguous_strides(t.shape))


def _pad_on_blocks(func, args, kwargs):
    """``constant_pad_nd`` on the blocks where no padded dim is sharded and
    nothing is partial, the output placed as the input (2.11 has no rule
    for it: the Mamba convolution's causal pad gathered the activation).
    ``None`` where it does not apply."""
    from torch.distributed.tensor import DTensor

    t, pad = args[0], list(args[1])
    if not isinstance(t, DTensor):
        return None
    padded = {t.dim() - 1 - i // 2 for i, n in enumerate(pad) if n}
    if any(not p.is_replicate() and (p.is_partial() or _shard_of(p) is None
                                     or _shard_of(p)[0] in padded) for p in t.placements):
        return None
    out = func(t._local_tensor, pad, *args[2:], **kwargs)
    shape = list(t.shape)
    for i in range(0, len(pad), 2):
        shape[t.dim() - 1 - i // 2] += pad[i] + pad[i + 1]
    return _wrap(out, t.device_mesh, t.placements, shape, _contiguous_strides(shape))


def _reduced(t):
    """A DTensor's partial sums reduced (all-reduced to ``Replicate``)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor) or not any(p.is_partial() for p in t.placements):
        return t
    return _moved(t, tuple(Replicate() if p.is_partial() else p
                                               for p in t.placements))


def _reduce_masked(out):
    """Outputs with a masked partial (DTensor's vocabulary-parallel
    ``embedding``/``gather``: each rank's rows, zeros elsewhere) reduced
    to ``Replicate`` on those mesh dims at once: DTensor keeps the mask of
    the op that made it, and a later view leaves it the wrong shape."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(t):
        if not isinstance(t, DTensor):
            return t
        pl = tuple(Replicate() if type(p).__name__ == "_MaskPartial" else p
                   for p in t.placements)
        return t if pl == tuple(t.placements) else _moved(t, pl)

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


def split_microbatches(x, n: int):
    """``x`` (B, ...) split into ``n`` microbatches, ``(n, B/n, ...)``.
    Where the batch shards do not divide the split (the reference's
    ``(256@data) → (8, 32)``: a microbatch lies on 2 of 16 ranks), the
    batch is gathered over the batch axes first and the split is a view of
    the whole; each microbatch then goes back on the batch axes
    (:func:`shard_batch`). Every version decides the same; the identity's
    reshape without a mesh. The port's own hook: the reference's split is
    GSPMD's. Its gather is the port's decision, not a point replicated where
    no rule placed it, so the dry run counts none for it (``fallbacks``)."""
    from torch.distributed.tensor import DTensor, Replicate

    shape = (n, x.shape[0] // n) + tuple(x.shape[1:])
    if _STATE["enabled"] and isinstance(x, DTensor) and _view_placements(x, shape) is None:

        x = x.redistribute(x.device_mesh, [Replicate() if p.is_shard() and p.dim == 0 else p
                                           for p in x.placements])
    return x.reshape(shape)


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
    return _constrain(x, _group_expert_spec(x.shape))


def _group_expert_spec(shape) -> list:
    spec = [None] * len(shape)
    if shape[0] % _size(("data",)) == 0:
        spec[0] = "data"
    if len(shape) > 1 and shape[1] % _size(("model",)) == 0:
        spec[1] = "model"
    return spec


class ExpertBlocks:
    """The MoE's dispatch and combine on each rank's ``(G/·, E/·, C, d)``
    block, the port's rule for the reference's vmapped scatter and gather
    under ``shard_group_experts`` (GSPMD never holds the buffer whole, and
    each group's combine stays local). The arithmetic is the mesh-less
    layer's (:func:`repro_torch.models.moe.dispatch`, :func:`~repro_torch
    .models.moe.combine`) on the rank's block of experts; this class places
    it. The buffer takes the placements :func:`shard_group_experts` names;
    the tokens and the routing take its group placements, whole on the mesh
    dims that cut the experts. A rank writes the kept assignments whose
    expert lies in its block, so the forward dispatch moves no data; the
    combine reads each assignment's output from the block that holds it (a
    zero row elsewhere), a partial sum over the expert mesh dims that the
    caller's :func:`shard_batch` all-reduces (N·d/G a rank). The backward
    passes mirror them: the tokens' gradient a partial sum over the expert
    mesh dims, the buffer's gradient written into its block. Integer
    routing is the caller's, unchanged."""

    def __init__(self, xt, flat_e, pos, keep, num_experts: int, capacity: int, k: int):
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.models import moe

        self.mesh = mesh = xt.device_mesh
        G, self.Ng, d = xt.shape
        E, C = num_experts, capacity
        self.bpl = to_placements(_group_expert_spec((G, E, C, d)), mesh)
        self.tpl = [Shard(0) if p == Shard(0) else Replicate() for p in self.bpl]
        self.edims = [m for m, p in enumerate(self.bpl) if p == Shard(1)]
        self.shape = (G, E, C, d)
        self.k = k
        self.El = El = E // math.prod(mesh.shape[m] for m in self.edims)
        fe, ps, kp = (_moved(t, self.tpl)._local_tensor for t in (flat_e, pos, keep))
        self.dest = moe.expert_slots(fe, ps, kp, _block_start(mesh, self.edims, El), El, C)

    def dispatch(self, xt):
        """The ``(G, E, C, d)`` buffer of ``xt`` ``(G, Ng, d)``'s kept
        assignments, at :func:`shard_group_experts`' placements."""
        return _ExpertDispatch.apply(xt.redistribute(self.mesh, self.tpl), self)

    def combine(self, out_buf, w):
        """Each token's k outputs of ``out_buf`` ``(G, E, C, d)`` weighted by
        ``w`` ``(G, Ng·k)`` and added in k order: ``(G, Ng, d)``, a partial
        sum over the expert mesh dims."""
        return _ExpertCombine.apply(_moved(out_buf, self.bpl) if out_buf.placements !=
                                    tuple(self.bpl) else out_buf,
                                    w.redistribute(self.mesh, self.tpl), self)

    def wrap_block(self, local):
        return _wrap(local, self.mesh, self.bpl, self.shape, _contiguous_strides(self.shape))

    def partial_tokens(self, local, shape):
        from torch.distributed.tensor import Partial

        pl = [Partial() if m in self.edims else p for m, p in enumerate(self.tpl)]
        return _wrap(local, self.mesh, pl, shape, _contiguous_strides(shape))


class _ExpertDispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xt, blocks):
        from repro_torch.models import moe

        ctx.blocks = b = blocks
        return b.wrap_block(moe.dispatch(xt._local_tensor, b.dest, b.k, b.El, b.shape[2]))

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models import moe

        b = ctx.blocks
        gx = moe.dispatch_grad(_moved(g, b.bpl)._local_tensor, b.dest, b.k)
        return b.partial_tokens(gx, (b.shape[0], b.Ng, b.shape[3])), None


class _ExpertCombine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out_buf, w, blocks):
        from repro_torch.models import moe

        b = blocks
        ob, wl = out_buf._local_tensor, w._local_tensor
        combined, vals = moe.combine(ob, wl, b.dest, b.k)
        ctx.blocks, ctx.local_shape = b, ob.shape
        ctx.save_for_backward(vals, wl)
        return b.partial_tokens(combined, (b.shape[0], b.Ng, b.shape[3]))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        from repro_torch.models import moe

        b = ctx.blocks
        vals, wl = ctx.saved_tensors
        whole = [Replicate() if m in b.edims else p for m, p in enumerate(b.tpl)]
        gl = _moved(g, whole)._local_tensor                           # (Gl, Ng, d)
        gbuf, gw = moe.combine_grad(gl, vals, wl, b.dest, b.k, ctx.local_shape)
        return b.wrap_block(gbuf), b.partial_tokens(gw, (b.shape[0], gw.shape[1])), None


def expert_blocks(xt, flat_e, pos, keep, num_experts: int, capacity: int, k: int):
    """An :class:`ExpertBlocks` for the MoE's tokens ``xt`` ``(G, Ng, d)``
    and routes (each ``(G, Ng·k)``) under an enabled mesh context of more
    than one rank; ``None`` otherwise (the caller's own dispatch: without a
    mesh, and on the 1 × 1 smoke mesh, where it is bitwise the mesh-less
    run's)."""
    from torch.distributed.tensor import DTensor

    if not _STATE["enabled"] or not isinstance(xt, DTensor) or xt.device_mesh.size() == 1:
        return None
    return ExpertBlocks(xt, flat_e, pos, keep, num_experts, capacity, k)


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


def shard_head_proj(x, n: int, over_positions: bool = False):
    """A projection ``(B, S, n·D)`` (or ``(B, n·D)``) before its split into
    ``n`` heads (or gates): when the model axis does not divide ``n``, the
    batch over the batch axes and, with ``over_positions``, the positions
    over the model axis where it divides them (the layout
    :func:`shard_attention` gives the queries then), else whole on it (the
    layout it gives keys and values; a recurrence's inputs) — so that the
    split is a view of each rank's block (a shard of the ``n·D`` features
    over more ranks than heads, or over ranks that cut a head, is not).
    The identity when the model axis divides ``n``. The port's own hook:
    the reference needs none."""
    m = _size(("model",))
    if not _STATE["enabled"] or n % m == 0:
        return x
    ba = _STATE["batch_axes"]
    spec = [None] * x.ndim
    if x.shape[0] % _size(ba) == 0 and x.shape[0] >= _size(ba):
        spec[0] = ba
    if over_positions and x.ndim > 2 and x.shape[1] % m == 0 and x.shape[1] >= m:
        spec[1] = "model"
    return _constrain(x, spec)


def shard_o_proj(x, n_heads: int):
    """Attention's output ``(B, S, H·D)`` entering the output projection,
    when the model axis does not divide the heads: the batch over the
    batch axes and the ``H·D`` features over the model axis (where it
    divides them; else whole on it), the row-parallel layout. The output
    comes over positions (:func:`shard_heads`), so this is an all-to-all,
    and its backward returns the gradient to positions before the split
    into heads, a view of each rank's block there (the projection's
    backward cuts the features, which a head does not divide). Left whole,
    every rank of the axis would repeat the projection's weight gradient.
    The identity when the model axis divides the heads. The port's own
    hook: the reference needs none."""
    m = _size(("model",))
    if not _STATE["enabled"] or n_heads % m == 0:
        return x
    ba = _STATE["batch_axes"]
    spec = [None] * x.ndim
    if x.shape[0] % _size(ba) == 0 and x.shape[0] >= _size(ba):
        spec[0] = ba
    if x.shape[-1] % m == 0:
        spec[-1] = "model"
    return _constrain(x, spec)


def shard_heads(o):
    """Attention's output ``(B, S, H, D)``: the batch over the batch axes,
    the heads over the model axis when it divides them, ready for the
    row-parallel output projection; else the positions over it, as
    :func:`shard_attention` placed the queries (where it divides them;
    else whole on it), for :func:`shard_o_proj`."""
    if not _STATE["enabled"]:
        return o
    ba, m = _STATE["batch_axes"], _size(("model",))
    spec = [None] * 4
    if o.shape[0] % _size(ba) == 0 and o.shape[0] >= _size(ba):
        spec[0] = ba
    if o.shape[2] % m == 0:
        spec[2] = "model"
    elif o.shape[1] % m == 0 and o.shape[1] >= m:
        spec[1] = "model"
    return _constrain(o, spec)


def shard_like(x, ref):
    """``x`` placed as ``ref`` (two DTensors of one shape; else ``x``): the
    attention's output as its queries were, so that the gradient reaches
    the grouped reshape in a placement it can split."""
    from torch.distributed.tensor import DTensor

    if not _STATE["enabled"] or not isinstance(x, DTensor) or not isinstance(ref, DTensor):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def placed_as(x, ref):
    """``x`` redistributed to ``ref``'s placements, ``ref``'s partial sums
    read as replicas (two DTensors of one rank); else ``x``. The port's own
    hook: Adafactor's factored statistics are combined in the layout their
    gradient's reductions give (the state's spec, the reference's, is
    another: mixing the two leaves each version of DTensor to pick where
    the gradient-sized update goes, and one gathers it whole)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or not isinstance(ref, DTensor) or x.dim() != ref.dim():
        return x
    pl = [Replicate() if p.is_partial() else p for p in ref.placements]
    return x if list(x.placements) == pl else x.redistribute(ref.device_mesh, pl)


class _VocabParallelLL(torch.autograd.Function):
    """Each token's log-likelihood ``picked − logsumexp`` from its rank's
    block of the logits, the vocabulary cut on the mesh dims ``vocab``
    (:func:`vocab_parallel_ll`): forward and backward on the local blocks,
    the (B, S) all-reduces between them the only collectives."""

    @staticmethod
    def forward(ctx, lg, labels, vocab, out_pl):
        from torch.distributed.tensor import Partial, Replicate

        mesh, pl = lg.device_mesh, list(lg.placements)
        local, lab = lg._local_tensor, labels._local_tensor
        Vb = local.shape[-1]
        first = _block_start(mesh, vocab, Vb)       # this rank's first vocabulary row

        def reduced(t, op):
            part = [Partial(op) if m in vocab else p for m, p in enumerate(out_pl)]
            d = _wrap(t, mesh, part, tuple(lg.shape[:-1]) + tuple(t.shape[2:]),
                      _contiguous_strides(tuple(lg.shape[:-1]) + tuple(t.shape[2:])))
            return d.redistribute(mesh, [Replicate() if m in vocab else p
                                         for m, p in enumerate(out_pl)])._local_tensor

        # torch.logsumexp's own steps (its max made inf-safe, then the sum of
        # exp(lg - max), its log plus the max): on one rank, its bits
        mx = reduced(local.amax(-1, keepdim=True), "max")
        mx = mx.masked_fill(mx.abs() == math.inf, 0)
        lse = reduced((local - mx).exp_().sum(-1), "sum").log_().add_(mx[..., 0])
        idx = lab.long() - first
        inside = (idx >= 0) & (idx < Vb)
        idx = idx.clamp(0, Vb - 1)[..., None]
        picked = reduced(torch.where(inside, local.gather(-1, idx)[..., 0], 0.0), "sum")
        ctx.saved = (local, lse, idx, inside, mesh, pl, lg.shape, lg.stride(), out_pl)
        ll = picked - lse
        return _wrap(ll, mesh, out_pl, lg.shape[:-1], _contiguous_strides(lg.shape[:-1]))

    @staticmethod
    def backward(ctx, g):
        local, lse, idx, inside, mesh, pl, shape, stride, out_pl = ctx.saved
        g = _moved(g, out_pl)._local_tensor
        # logsumexp's backward (-g · exp(lg - lse)), then the pick's (+g at
        # the label): the sum autograd forms without a mesh
        d = (local - lse[..., None]).exp_().mul_(-g[..., None])
        d.scatter_add_(-1, idx, torch.where(inside, g, -0.0)[..., None])
        return _wrap(d, mesh, pl, shape, stride), None, None, None


def vocab_parallel_ll(lg, labels):
    """The LM loss's per-token log-likelihood ``picked − logsumexp(lg)``
    (float32 logits ``lg`` (B, S, V), ``labels`` (B, S)) with the
    vocabulary kept sharded, as GSPMD lays out the reference's select
    (``repro.models.layers.lm_loss``): each rank's block gives its max, its
    sum of ``exp(lg − max)`` and its share of the picked logit, each
    all-reduced over the mesh dims that cut the vocabulary; the backward is
    the block's softmax times ``−g`` plus ``g`` at the label. DTensor's own
    rule for ``logsumexp`` gathers the whole vocabulary (and a clone of a
    pod's batch on 2 x 16 x 16). The batch and sequence keep the logits'
    shards, the labels placed alike; ``None`` where ``lg`` is not a DTensor
    (the caller's plain formula). On one rank the bits are torch's
    ``logsumexp`` and ``gather``'s. The port's own rule: the reference
    needs none."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(lg, DTensor):
        return None
    last = lg.dim() - 1
    pl = [p if p.is_replicate() or type(p) is Shard else Replicate() for p in lg.placements]
    vocab = [m for m, p in enumerate(pl) if p.is_shard() and p.dim == last]
    if lg.shape[-1] % math.prod(lg.device_mesh.shape[m] for m in vocab):
        pl = [Replicate() if m in vocab else p for m, p in enumerate(pl)]
        vocab = []
    if pl != list(lg.placements):
        lg = lg.redistribute(lg.device_mesh, pl)
    out_pl = [Replicate() if m in vocab else p for m, p in enumerate(pl)]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, lg.device_mesh,
                                    [Replicate()] * lg.device_mesh.ndim, run_check=False)
    labels = labels.redistribute(lg.device_mesh, out_pl)
    return _VocabParallelLL.apply(lg, labels, tuple(vocab), out_pl)


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
