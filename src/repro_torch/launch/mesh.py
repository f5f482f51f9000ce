"""Process groups for multi-process training.

The counterpart of ``repro.launch.mesh``'s worker-mesh helpers. The
reference runs one SPMD program over a ``worker`` mesh and assembles the
global ``(n, ...)`` arrays from each host's block; the port runs one process
per card (or several on one card), each training only its
:class:`~repro_torch.data.pipeline.HostShardPlan` block of workers on its
own device with **no collective**, and a process group exists only for the
merge phase's gathers.

* :func:`make_worker_group` — joins (or checks) the default process group:
  ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` as ``torchrun``
  sets them, or ``$REPRO_TORCH_INIT_METHOD`` (for example
  ``file:///path/to/store``, a file store on a shared disk). NCCL when each
  rank has a card of its own; gloo over host copies when ranks share a card
  (NCCL refuses two ranks on one device) or run on the CPU.
* :func:`multihost_train_kwargs` — the CLIs' ``--processes`` resolved, and
  the ``train_submodels`` arguments a multi-process run needs.
* :func:`assemble_worker_array` — this process's ``(plan.num_local, ...)``
  block on its device (nothing is exchanged: each rank keeps its own).

* :func:`make_production_mesh` — the reference's 16 × 16 ``("data",
  "model")`` mesh (2 × 16 × 16 with ``"pod"``) as a ``DeviceMesh`` over the
  default group that exists: a fake group of 256 or 512 ranks for the dry
  run (:mod:`repro_torch.launch.dryrun`), or a real group on a cluster.
* :func:`make_smoke_mesh` — a 1 × 1 ``("data", "model")`` mesh over one
  device, in a group of one (the LLM trainer's ``mesh=``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

INIT_METHOD_ENV = "REPRO_TORCH_INIT_METHOD"
GROUP_TIMEOUT_S = 600      # a rank waits this long for the others to join


def world() -> tuple[int, int]:
    """``(rank, world size)`` of the default process group, ``(0, 1)``
    when none is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def worker_backend(device, processes: int) -> str:
    """``nccl`` when the ranks run on cards of their own, else ``gloo``
    (the CPU, or several ranks on one card). Refuses CUDA's MPS, under
    which the kernels' cooperative persistent launches, each sized to what
    the card holds at once, could wait on each other for ever."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo"
    shared = processes > torch.cuda.device_count()
    if shared and (os.environ.get("CUDA_MPS_PIPE_DIRECTORY")
                   or os.environ.get("CUDA_MPS_ACTIVE_THREAD_PERCENTAGE")):
        raise RuntimeError(
            "several ranks share a card under MPS: the kernels' cooperative launches "
            "take the whole card each and could deadlock; run without MPS "
            "(default time-slicing) or one rank a card")
    return "gloo" if shared else "nccl"


def make_worker_group(processes: int | None = None, process_index: int | None = None, *,
                      device=None, store=None):
    """The process group of a multi-process run: the default group,
    initialised here if it is not yet. ``processes``/``process_index``
    default to ``WORLD_SIZE``/``RANK``; the rendezvous is ``store`` (a
    ``torch.distributed.Store``), ``$REPRO_TORCH_INIT_METHOD`` or ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``), in that order. Raises
    when the group cannot be formed or does not match ``processes``: a
    multi-process run never goes on alone."""
    from datetime import timedelta

    from repro_torch.device import resolve_device

    if dist.is_initialized():
        rank, size = world()
        if processes is not None and size != processes:
            raise RuntimeError(f"the process group has {size} ranks, not {processes}")
        if process_index is not None and rank != process_index:
            raise RuntimeError(f"this process is rank {rank}, not {process_index}")
        return dist.group.WORLD
    size = int(processes if processes is not None else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_index if process_index is not None else os.environ.get("RANK", 0))
    if not 0 <= rank < size:
        raise ValueError(f"process index {rank} outside [0, {size})")
    device = resolve_device(device)
    backend = worker_backend(device, size)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count()
        torch.cuda.set_device(local)
    kw = dict(backend=backend, rank=rank, world_size=size,
              timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = os.environ.get(INIT_METHOD_ENV, "env://")
    dist.init_process_group(**kw)
    return dist.group.WORLD


def multihost_train_kwargs(num_workers: int, processes: int | None = None, *,
                           process_index: int | None = None, device=None
                           ) -> tuple[int, dict]:
    """Resolve a CLI ``--processes`` value (``None``: the world size of the
    default group, 1 without one) and the extra ``train_submodels``
    arguments a multi-process run needs: the group the merge phase gathers
    over, formed here (:func:`make_worker_group`). Shared by ``train_sgns``
    and ``train_w2v_100m``."""
    if processes is None:
        processes = world()[1]
    kwargs: dict = {}
    if processes > 1:
        group = make_worker_group(processes, process_index, device=device)
        kwargs = dict(group=group, process_index=dist.get_rank(group))
    return processes, kwargs


def assemble_worker_array(plan, local, device) -> torch.Tensor:
    """This process's ``(plan.num_local, ...)`` block of worker-leading data
    (a tensor or an array) on ``device``. Each rank keeps its own block: no
    rank ever holds another's chunk, and nothing is exchanged. Multi-process
    plans are checked to split evenly (:meth:`HostShardPlan.validate_for_mesh`)."""
    t = local if isinstance(local, torch.Tensor) else torch.from_numpy(np.asarray(local))
    if t.shape[0] != plan.num_local:
        raise ValueError(f"local block has {t.shape[0]} worker rows; {plan.describe()} "
                         f"expects {plan.num_local}")
    if plan.process_count > 1:
        plan.validate_for_mesh()
    return t.to(device)


def _mesh_device_type() -> str:
    """The device type of a mesh over the default group: ``cpu`` for a fake
    group (its tensors are fake: nothing is allocated, nothing is sent) or
    a gloo one, ``cuda`` for NCCL."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh: 16 × 16 = 256 ranks, ``("data",
    "model")``; with ``multi_pod`` 2 × 16 × 16 = 512, ``("pod", "data",
    "model")``. Built over the default process group, which must exist and
    have that many ranks (it never creates one)."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"the production mesh needs a default process group of {n} ranks "
                           f"(world size now {world()[1]}): join the cluster's, or a fake "
                           f"group for a dry run")
    return DeviceMesh(_mesh_device_type(), torch.arange(n).view(shape), mesh_dim_names=axes)


def make_smoke_mesh(device=None):
    """A 1 × 1 ``("data", "model")`` mesh over ``device`` (the GPU unless
    ``"cpu"``): the default group if it has one rank, else a group of one
    formed here (NCCL on a card, gloo on the CPU; an in-process store)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    elif dist.get_world_size() != 1:
        raise RuntimeError(f"the smoke mesh needs a group of one; the default group has "
                           f"{dist.get_world_size()} ranks")
    return DeviceMesh(dev.type, torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))
