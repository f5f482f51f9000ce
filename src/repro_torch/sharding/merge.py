"""The merge phase's sharded Gram reduction across a process group.

The counterpart of ``repro.sharding.merge``, and the **one intended
collective of the system**: training makes no ``torch.distributed`` call.
When the ALiR Gram accumulation (:func:`repro_torch.core.merge.sharded_gram`)
runs over a process group, each rank computes the row-block partials of
the rows it owns, and one ``all_gather_into_tensor`` of the ``(S, d, e)``
partials (tiny next to the ``(V, d)`` tables) lets every rank reduce them
in the same ascending block order. The partials do not depend on where
they are computed and the reduction order is fixed, so
``mesh_sharded_gram(A, B, group, num_shards=S)`` is bitwise
``sharded_gram(A, B, S)`` on any world size that divides S.

A multi-process run (:func:`repro_torch.core.driver.train_submodels` with
``process_count > 1``) trains each rank's block of workers with no
collective; :func:`gather_worker_blocks` then brings every rank's block of
sub-models to every rank for the merge, one ``all_gather`` a tensor.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.merge import gram_block_partials, reduce_gram_partials


def mesh_sharded_gram(A: torch.Tensor, B: torch.Tensor, group, *,
                      num_shards: int | None = None) -> torch.Tensor:
    """``AᵀB`` computed over the ranks of ``group``: rank r takes the
    contiguous row slice r of ``A`` and ``B`` (``(..., V, d)`` and ``(...,
    V, e)``, the same full tables on every rank; leading dims are a batch,
    such as ALiR's n models), computes its ``num_shards / world`` block
    partials, all-gathers the ``(num_shards, ..., d, e)`` stack in one call
    and reduces it in ascending block order.

    ``num_shards`` defaults to the world size and must be a multiple of
    it; the rows must divide evenly into ``num_shards`` (pad upstream).
    """
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    S = int(num_shards) if num_shards is not None else world
    if S % world:
        raise ValueError(f"num_shards {S} must be a multiple of the world "
                         f"size {world}")
    V = A.shape[-2]
    if V % S:
        raise ValueError(f"rows {V} must divide evenly into {S} shards "
                         f"(pad upstream)")
    rows = V // world
    own = slice(rank * rows, (rank + 1) * rows)
    parts = gram_block_partials(A[..., own, :], B[..., own, :], S // world)
    parts = parts.movedim(-3, 0).contiguous()             # blocks first
    gathered = parts.new_empty((S, *parts.shape[1:]))
    # the merge phase's one collective
    dist.all_gather_into_tensor(gathered, parts, group=group)
    return reduce_gram_partials(gathered.movedim(0, -3))


def gather_worker_blocks(local: torch.Tensor, group) -> torch.Tensor:
    """Every rank's equal-shaped ``(num_local, ...)`` block of
    worker-leading data, concatenated in rank order (``(n, ...)``) on
    ``local``'s device: one ``all_gather``. Under gloo the blocks travel as
    host copies (several ranks may share one card, which NCCL refuses)."""
    world = dist.get_world_size(group)
    host = local.is_cuda and dist.get_backend(group) == "gloo"
    src = (local.cpu() if host else local).contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    # the merge phase's gather of the sub-models
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(local.device)
