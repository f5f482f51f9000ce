"""Logical-axis sharding rules → partition specs, with the divisibility
fallback — the counterpart of ``repro.sharding.rules``.

Mesh axes: ``data`` (FSDP/batch), ``model`` (tensor/expert parallel),
optionally ``pod`` (pure data parallel across pods: only the gradient
all-reduce crosses the inter-node network).

A **spec** is a plain tuple with the reference's ``PartitionSpec`` entries,
one a tensor dim: ``None`` (replicated), an axis name, or a tuple of two or
more names (the dim split over their product, the first outermost); a
one-name tuple is written as the name, as ``PartitionSpec`` normalises it. Parameters are
matched by the name of their leaf in the reference's parameter tree
(:meth:`repro_torch.models.Model.param_tree`): ``wq``, ``down``,
``embed``… Any proposed axis whose size does not divide its dim is
dropped (replicated), which lets one rule table serve 15-head smollm and
64-head jamba alike. Cycle-stacked leaves (a leading ``num_cycles`` dim,
under ``cycle`` in the path) get a ``None`` in front.

:func:`to_placements` maps a spec onto DTensor placements on a
``torch.distributed.device_mesh.DeviceMesh`` (and :func:`to_spec` back);
:func:`with_sharding` turns a tree of tensors, real or fake, into DTensors
with those placements. Every spec function also takes an
:func:`abstract_mesh`, which needs no device and no process group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.tree import tree_map

# name → proposed spec for the *unstacked* param
# ("data" on the fan-in/d_model-ish dim = FSDP; "model" on the
# head/ffn/vocab dim = tensor parallel; experts (3D) = expert parallel)
_RULES_2D = {
    "embed": ("model", "data"),       # (V, d): vocab-sharded
    "lm_head": ("data", "model"),     # (d, V)
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    "wq_nope": ("data", "model"),
    "wq_rope": ("data", "model"),
    "w_dkv": ("data", None),
    "w_uk": (None, "model"),
    "w_uv": (None, "model"),
    "w_krope": ("data", None),
    "gate": ("data", "model"),
    "up": ("data", "model"),
    "down": ("model", "data"),
    "in_proj": ("data", "model"),
    "out_proj": ("model", "data"),
    "x_proj": ("model", None),
    "dt_proj": (None, "model"),
    "w_if": ("model", None),
    "w_in": ("data", "model"),
    "router": ("data", None),
    "conv_w": (None, "model"),
    "A_log": ("model", None),
}

_RULES_3D_EXPERT = {  # (E, in, out)
    "gate": ("model", "data", None),
    "up": ("model", "data", None),
    "down": ("model", None, "data"),
}

_VEC_SHARD_MIN = 4096  # 1-D params smaller than this are replicated

_OPT_LEAVES = ("m", "v", "vr", "vc", "mu")   # optimizer-state leaves above a param


@dataclass(frozen=True)
class AbstractMesh:
    """A device-free mesh: ``axis_names`` and ``shape`` (name → size),
    enough for every spec function."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def abstract_mesh(axis_sizes: tuple[int, ...], axis_names: tuple[str, ...]) -> AbstractMesh:
    """The reference's ``abstract_mesh``: axis sizes and names, no devices."""
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} sizes for {len(axis_names)} axis names")
    return AbstractMesh(tuple(axis_names), tuple(int(s) for s in axis_sizes))


def axis_names(mesh) -> tuple:
    """The axis names of an :class:`AbstractMesh` or a ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _axis_sizes(mesh) -> dict[str, int]:
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(axis_names(mesh), (int(s) for s in mesh.mesh.shape)))


def _spec(*entries) -> tuple:
    """A spec from its entries, a one-name tuple written as the name, as
    ``PartitionSpec`` normalises it (``(("data",), None)`` → ``("data",
    None)``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def _check(spec: tuple, shape: tuple, sizes: dict) -> tuple:
    out = []
    for ax, dim in zip(spec, shape):
        if ax is None:
            out.append(None)
            continue
        size = math.prod(sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,)))
        out.append(ax if dim % size == 0 and dim >= size else None)
    return _spec(*out)


def param_spec(path: tuple[str, ...], shape: tuple[int, ...], mesh,
               fsdp: bool = True) -> tuple:
    """The spec of the parameter (or optimizer-state leaf) at ``path`` (the
    reference tree's keys, list indices as strings) of global ``shape``."""
    sizes = _axis_sizes(mesh)
    shape = tuple(shape)
    stacked = "cycle" in path
    # the param's own name: last path element not an optimizer-state leaf
    leaf_names = [p for p in path if p not in _OPT_LEAVES]
    name = leaf_names[-1] if leaf_names else ""
    core_shape = shape[1:] if stacked and len(shape) > 1 else shape
    nd = len(core_shape)

    if name in ("gate", "up", "down") and nd == 3:
        rule = _RULES_3D_EXPERT[name]
    elif name in _RULES_2D and nd == 2:
        rule = _RULES_2D[name]
    elif name == "r" and nd == 4:
        # sLSTM recurrent (4, H, dh, dh): replicated — it is small, and
        # sharding it puts a collective inside every step of the recurrence.
        rule = (None, None, None, None)
    elif nd == 1:
        rule = ("model",) if core_shape[0] >= _VEC_SHARD_MIN else (None,)
    else:
        # fallback: shard the largest divisible dim over 'model'
        rule = [None] * nd
        order = sorted(range(nd), key=lambda i: -core_shape[i])
        for i in order:
            if core_shape[i] % sizes.get("model", 1) == 0 and core_shape[i] >= sizes.get("model", 1):
                rule[i] = "model"
                break
        rule = tuple(rule)

    if not fsdp:
        # pure tensor-parallel: drop the 'data' weight shard (no per-use
        # re-gather; weights replicated across the data axis)
        rule = tuple(None if ax == "data" else ax for ax in rule)
    spec = _check(rule, core_shape, sizes)
    if stacked and len(shape) > len(core_shape):
        spec = (None,) + spec
    return spec


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and ``None``, the path
    spelled as the reference's (``jax`` key paths: dict keys, list indices
    as strings)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(path, tree)


def tree_param_specs(tree, mesh, fsdp: bool = True):
    """The spec tree of a parameter or optimizer-state tree (of tensors or
    anything with ``.shape``)."""
    return _map_with_path(lambda path, leaf: param_spec(path, tuple(leaf.shape), mesh,
                                                        fsdp=fsdp), tree)


# ---------------------------------------------------------------------------
# Activations / batches / caches
# ---------------------------------------------------------------------------
def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def data_spec(shape: tuple[int, ...], mesh) -> tuple:
    """Input-batch arrays: dim0 = global batch over (pod, data)."""
    sizes = _axis_sizes(mesh)
    ba = batch_axes(mesh)
    n = math.prod(sizes[a] for a in ba)
    if not shape:
        return ()
    if shape[0] % n == 0 and shape[0] >= n:
        return _spec(ba, *([None] * (len(shape) - 1)))
    return (None,) * len(shape)


def cache_spec(shape: tuple[int, ...], mesh) -> tuple:
    """KV caches / recurrent state: batch over data axes when divisible,
    else the sequence dim over 'data' (flash-decoding style); the largest
    remaining divisible feature dim over 'model'."""
    sizes = _axis_sizes(mesh)
    ba = batch_axes(mesh)
    nb = math.prod(sizes[a] for a in ba)
    nd = len(shape)
    spec: list = [None] * nd
    if nd and shape[0] % nb == 0 and shape[0] >= nb:
        spec[0] = ba
    elif nd > 1 and shape[1] % sizes.get("data", 1) == 0 and shape[1] > sizes.get("data", 1):
        spec[1] = "data"
    m = sizes.get("model", 1)
    free = [i for i in range(nd) if spec[i] is None]
    for i in sorted(free, key=lambda i: -shape[i]):
        if shape[i] % m == 0 and shape[i] >= m and shape[i] > 1:
            spec[i] = "model"
            break
    return _spec(*spec)


def tree_data_specs(tree, mesh):
    return _map_with_path(lambda _, leaf: data_spec(tuple(leaf.shape), mesh), tree)


def tree_cache_specs(tree, mesh):
    return _map_with_path(lambda _, leaf: cache_spec(tuple(leaf.shape), mesh), tree)


# ---------------------------------------------------------------------------
# Specs ↔ DTensor placements
# ---------------------------------------------------------------------------
def to_placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements (one a mesh dim) of ``spec`` on the
    ``DeviceMesh`` ``mesh``: a mesh dim named in tensor dim i's entry is
    ``Shard(i)``, any other ``Replicate()``. A dim split over several axes
    lists them outermost first, in the mesh's order, as JAX orders them
    (``(("pod", "data"), None)`` → ``Shard(0)`` on pod and on data, pod
    outer)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    placements = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} lists its axes out of the mesh's "
                             f"order {names}")
        for i in idx:
            if placements[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims of {spec!r}")
            placements[i] = Shard(dim)
    return tuple(placements)


def to_spec(placements, mesh, ndim: int) -> tuple:
    """The spec of ``placements`` on ``mesh`` for a tensor of ``ndim`` dims:
    :func:`to_placements`' inverse (``Shard`` and ``Replicate`` only)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    entries: list = [[] for _ in range(ndim)]
    for name, p in zip(names, placements):
        if isinstance(p, Shard):
            entries[p.dim % ndim].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} on {name!r} has no spec")
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e) for e in entries)


def with_sharding(tree, specs, mesh):
    """A tree of tensors (real or fake, each the full global tensor on every
    rank) → DTensors with ``specs``' placements on ``mesh``. Each rank keeps
    its own shard of its own copy (``src_data_rank=None``): nothing is
    sent, so the ranks must hold the same values (a seeded init)."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        return distribute_tensor(t, mesh, to_placements(spec, mesh), src_data_rank=None)

    return tree_map(one, tree, specs)


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """The shape of rank 0's shard of a ``shape`` tensor under ``spec``
    (every spec this module makes divides its dims evenly)."""
    sizes = _axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        out.append(-(-dim // math.prod(sizes[a] for a in axes)))
    return tuple(out)
