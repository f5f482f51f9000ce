"""The Train phase — zero-collective asynchronous sub-model training.

The counterpart of ``repro.core.async_trainer``. The paper's reducers
each train one SGNS sub-model with **no parameter synchronization**; here
the n sub-models are stacked ``(n, V, d)`` tables on one device and the
worker axis lives in the kernel grid: one engine step (one K2 or K4 call,
or one batched gather → row grads → scatter for ``dense``, ``sparse``
and ``rowgrad``, worker w's ids offset by ``w·V``) advances all n workers
by one micro-batch. Nothing in the train path calls ``torch.distributed``.

Random streams follow the reference exactly: each worker's chunk key is
split off the chunk key, and each step's seed is the ``sub`` of a
``key, sub = split(key)`` chain (``lax.scan`` in the reference). The
port derives a chunk's ``(n, S, 2)`` seed words on the host with
:mod:`repro_torch.prng` and copies them to the device once per chunk.
Every engine consumes the same per-step ``(n, 2)`` words: the fused
kernels as their counter-hash seed, the ``jax.random`` samplers as each
worker's key.

The synchronized baselines (:func:`make_sync_epoch`, the paper's
Hogwild/MLLib stand-in, and :func:`make_periodic_sync_epoch`, local SGD)
share one table. The reference runs them over a ``worker`` mesh with
``psum``/``pmean``; here the mesh's devices are an optional
``torch.distributed`` process group (``all_reduce``), and the periodic
sync's devices are also a leading axis of ``n`` stacked copies in one
process. Without a group they make no collective call.

:func:`assert_no_collectives` and :func:`count_collective_ops` check that
claim on whatever a region dispatches (``repro_torch.analysis.contracts``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.core import sgns
from repro_torch.core.engine import get_engine
from repro_torch.core.sgns import SGNSConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.sgns_fused import seed_tensor
from repro_torch.spans import span


def make_worker_epoch(cfg: SGNSConfig, total_steps: int, engine="fused"):
    """Returns ``epoch_fn(params, centers (n,S,B), contexts (n,S,B),
    neg_table, keys (n,2), step0) -> (params, losses (n,S))``.

    ``params`` (stacked ``(n, V, d)``) are updated in place; ``keys``
    are the workers' uint32 chunk keys; ``neg_table`` holds each
    worker's own noise table in the layout ``engine.table_kind`` names.
    """
    step = get_engine(engine).make_step(cfg, total_steps)

    def epoch_fn(params, centers, contexts, neg_table, keys, step0):
        with span("repro_torch.epoch"):
            device = params["W"].device
            n, S, _ = centers.shape
            with span("repro_torch.epoch.keys"):
                seeds = seed_tensor(prng.step_keys(keys, S).transpose(1, 0, 2),
                                    device)                   # (S, n, 2)
            with span("repro_torch.epoch.stage"):
                # step-major, so each step's (n, B) slice is contiguous
                cen = centers.to(device).transpose(0, 1).contiguous()
                ctx = contexts.to(device).transpose(0, 1).contiguous()
            with span("repro_torch.epoch.bounds"):
                # the kernels index the tables with these ids unchecked: one
                # host sync per chunk keeps a bad chunk from reading out of bounds
                lo, hi = torch.stack([torch.minimum(cen.min(), ctx.min()),
                                      torch.maximum(cen.max(), ctx.max())]).tolist()
                if lo < 0 or hi >= cfg.vocab_size:
                    raise ValueError(f"chunk ids span [{lo}, {hi}], outside the "
                                     f"vocabulary [0, {cfg.vocab_size})")
            losses = torch.empty((S, n), dtype=torch.float32, device=device)
            for i in range(S):
                params, losses[i] = step(params, cen[i], ctx[i], neg_table,
                                         seeds[i], step0 + i)
            return params, losses.T

    return epoch_fn


@dataclass
class AsyncShardTrainer:
    """Trains n sub-models fully asynchronously on one device.

    ``engine`` — an :class:`repro_torch.core.engine.UpdateEngine` or
    spec string (``"fused"``, ``"fused_hbm"``, ``"rowgrad:cdf"``,
    ``"sparse:alias"``, ``"dense"``) that owns the per-step compute.
    ``device`` — where the tables live; ``None`` is the GPU (raising
    without one), ``"cpu"`` runs the kernels' plain versions.
    ``plan`` — a :class:`repro_torch.data.pipeline.HostShardPlan` over
    ``num_workers``: this process trains only its block of workers
    ``[plan.start, plan.stop)``, so the stacked tables are ``(plan.num_local,
    V, d)``; each worker's init and step keys are still split off the
    global keys by its global id, so its draws do not depend on the split.
    """

    cfg: SGNSConfig
    num_workers: int
    total_steps: int
    engine: object = "fused"
    device: object = None
    plan: object = None

    def __post_init__(self):
        self.engine = get_engine(self.engine)
        self.engine.validate(vocab_size=self.cfg.vocab_size, dim=self.cfg.dim,
                             negatives=self.cfg.negatives)
        self.device = resolve_device(self.device)
        if self.plan is not None and self.plan.num_workers != self.num_workers:
            raise ValueError(f"plan covers {self.plan.num_workers} workers, the trainer "
                             f"{self.num_workers}")
        self._epoch = None

    @property
    def workers(self) -> range:
        """The global ids of the workers this trainer stacks."""
        return range(self.num_workers) if self.plan is None else self.plan.workers

    def init(self, key) -> dict:
        """Stacked ``{"W", "C"}`` ``(n_local, V, d)``: worker i's tables are
        ``init_params(split(key, n)[i])`` for each of :attr:`workers`."""
        keys = prng.split(key, self.num_workers)[self.workers.start:self.workers.stop]
        V, d = self.cfg.vocab_size, self.cfg.dim
        W = torch.empty((len(keys), V, d), dtype=torch.float32, device=self.device)
        for i, k in enumerate(keys):
            W[i] = sgns.init_params(k, self.cfg, device=self.device)["W"]
        C = torch.zeros_like(W)
        return {"W": W, "C": C}

    def device_chunk(self, centers, contexts):
        """This process's ``(plan.num_local, S, B)`` chunk blocks on the
        trainer's device (:func:`repro_torch.launch.mesh.assemble_worker_array`:
        each process keeps its own block; nothing is exchanged)."""
        if self.plan is None:
            return _tensor(centers).to(self.device), _tensor(contexts).to(self.device)
        from repro_torch.launch.mesh import assemble_worker_array

        return (assemble_worker_array(self.plan, centers, self.device),
                assemble_worker_array(self.plan, contexts, self.device))

    def device_table(self, neg_table):
        """This process's rows of the stacked noise tables (``(n, V)`` leaves,
        all workers' or already the plan's ``(num_local, V)``) on the
        trainer's device."""
        def local(a):
            a = _tensor(a)
            if self.plan is not None and a.shape[0] == self.num_workers:
                a = a[self.plan.start:self.plan.stop]
            if self.plan is None:
                return a.to(self.device)
            from repro_torch.launch.mesh import assemble_worker_array

            return assemble_worker_array(self.plan, a, self.device)

        if isinstance(neg_table, dict):
            return {k: local(v) for k, v in neg_table.items()}
        return local(neg_table)

    def _epoch_fn(self):
        if self._epoch is None:
            self._epoch = make_worker_epoch(self.cfg, self.total_steps,
                                            engine=self.engine)
        return self._epoch

    def epoch(self, params, centers, contexts, neg_table, key, step0=0):
        """params: (n,V,d) dict, updated in place; centers/contexts:
        (n,S,B) int32 tensors or arrays; neg_table: (n,V) CDFs or
        {'prob','alias'} of (n,V), as ``engine.table_kind`` says, on the
        trainer's device; key: the chunk's (2,) key. Under a ``plan``, n is
        ``plan.num_local`` and worker i takes ``split(key, num_workers)[
        plan.start + i]``. Returns ``(params, losses (n, S))``."""
        keys = prng.split(key, self.num_workers)[self.workers.start:self.workers.stop]
        return self._epoch_fn()(params, _tensor(centers), _tensor(contexts),
                                neg_table, keys, int(step0))

    def worker_epoch(self, params, centers, contexts, neg_table, key, step0=0):
        """One worker's chunk: params ``(V, d)`` tables (updated in
        place), centers/contexts ``(S, B)``, the worker's own ``(V,)``
        table(s), and ``key`` the exact per-(worker, chunk) key the stacked
        :meth:`epoch` would have split out for it. Returns
        ``(params, losses (S,))``."""
        stacked = {k: v.unsqueeze(0) for k, v in params.items()}
        table = ({k: v.unsqueeze(0) for k, v in neg_table.items()}
                 if isinstance(neg_table, dict) else neg_table.unsqueeze(0))
        keys = np.asarray(key, dtype=np.uint32)[None]
        _, losses = self._epoch_fn()(stacked, _tensor(centers)[None],
                                     _tensor(contexts)[None], table, keys,
                                     int(step0))
        return params, losses[0]


# ---------------------------------------------------------------------------
# Synchronized baselines: one shared table
# ---------------------------------------------------------------------------
def _rank_world(group) -> tuple[int, int]:
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _stacked_table(neg_table, n: int, device):
    """One vocabulary's ``(V,)`` table(s) as ``n`` contiguous copies ``(n,
    V)`` on ``device`` (every worker draws from the shared table)."""
    if isinstance(neg_table, dict):
        return {k: _tensor(v).to(device).expand(n, -1).contiguous()
                for k, v in neg_table.items()}
    return _tensor(neg_table).to(device).expand(n, -1).contiguous()


def _batch_part(ids, device, parts: int, part: int) -> torch.Tensor:
    """``ids`` ``(..., B)`` → the contiguous slice ``part`` of ``parts``
    along the batch axis (a worker's share under the reference's batch
    sharding)."""
    t = _tensor(ids).to(device)
    B = t.shape[-1]
    if B % parts:
        raise ValueError(f"batch {B} does not split over {parts} workers")
    b = B // parts
    return t[..., part * b:(part + 1) * b].contiguous()


def make_sync_epoch(cfg: SGNSConfig, neg_table, total_steps: int, group=None,
                    engine="dense", device=None):
    """One shared table; per-step gradient synchronization. Returns
    ``epoch_fn(params, centers (S, B), contexts (S, B), key, step0) ->
    (params, losses (S,))``, ``params`` ``{"W", "C"}`` of ``(V, d)`` on
    ``device`` (the GPU unless ``device="cpu"``).

    Each step splits the key as the reference's scan does, draws ``(B,
    K)`` negatives with ``engine.sample`` from the vocabulary's ``neg_table``
    (layout ``engine.table_kind``), takes the dense gradient of
    :func:`sgns.sum_loss_fn` and applies ``p − lr·g``: only the engine's
    draw is used, since the gradient must be dense for the all-reduce.
    With a process ``group``, rank r trains on slice r of the batch and the
    gradients are ``all_reduce``d (sum) and the loss averaged — the
    reference's ``psum``/``pmean`` over its ``worker`` axis, the per-step
    collective the paper eliminates."""
    engine = get_engine(engine)
    device = resolve_device(device)
    table = _stacked_table(neg_table, 1, device)
    rank, world = _rank_world(group)

    def step(params, c_b, x_b, seed, i):
        negs = engine.sample(table, seed, (c_b.shape[0], cfg.negatives))[0]
        lr32 = float(sgns.linear_lr(i, total_steps, cfg))
        sum_loss, grads = sgns.sum_loss_grads(params, c_b, x_b, negs)
        loss = sum_loss / c_b.shape[0]
        if group is not None:
            for g in grads.values():
                dist.all_reduce(g, group=group)
            dist.all_reduce(loss, group=group)
            loss = loss / world
        return {k: params[k] - lr32 * g for k, g in grads.items()}, loss

    def epoch_fn(params, centers, contexts, key, step0):
        cen = _batch_part(centers, device, world, rank)
        ctx = _batch_part(contexts, device, world, rank)
        S = cen.shape[0]
        seeds = seed_tensor(prng.step_keys(key, S), device)      # (S, 2)
        losses = torch.empty(S, dtype=torch.float32, device=device)
        for i in range(S):
            params, losses[i] = step(params, cen[i], ctx[i], seeds[i:i + 1],
                                     int(step0) + i)
        return params, losses

    return epoch_fn


def make_periodic_sync_epoch(cfg: SGNSConfig, neg_table, total_steps: int,
                             sync_every: int, num_workers: int = 1, *, group=None,
                             engine="dense", device=None):
    """One shared table; parameters *averaged* across workers every
    ``sync_every`` steps (local SGD) instead of gradients every step.
    Returns ``epoch_fn(params, centers (outer, sync_every, B), contexts,
    key, step0) -> (params, losses (outer, sync_every))``, ``params`` the
    ``(V, d)`` tables after the last average.

    The reference's devices on the ``worker`` axis are ``num_workers``
    stacked ``(n, V, d)`` copies of the table here (times the ranks of
    ``group``, if given): worker w of rank r trains on slice ``r·n + w`` of
    the batch, and between syncs every copy takes the ``engine``'s own
    worker-batched step (with ``fused``, one K2 launch for all n). Every
    worker steps with **the same seed**, since the reference's key is
    replicated. A sync replaces every copy by the mean over the worker
    axis (``all_reduce`` and a division by the world size across ranks,
    as ``pmean``); the losses are that mean over workers too."""
    engine = get_engine(engine)
    engine.validate(vocab_size=cfg.vocab_size, dim=cfg.dim, negatives=cfg.negatives)
    device = resolve_device(device)
    n = int(num_workers)
    if n < 1 or sync_every < 1:
        raise ValueError(f"need num_workers >= 1 and sync_every >= 1, got "
                         f"{num_workers} and {sync_every}")
    table = _stacked_table(neg_table, n, device)
    step = engine.make_step(cfg, total_steps)
    rank, world = _rank_world(group)

    def pmean(t: torch.Tensor) -> torch.Tensor:
        t = t.mean(dim=0)
        if group is not None:
            dist.all_reduce(t, group=group)
            t = t / world
        return t

    def epoch_fn(params, centers, contexts, key, step0):
        outer, k = centers.shape[:2]
        if k != sync_every:
            raise ValueError(f"centers (outer, sync_every, B) has {k} steps "
                             f"between syncs, expected {sync_every}")
        parts = [(_batch_part(centers, device, world * n, rank * n + w),
                  _batch_part(contexts, device, world * n, rank * n + w))
                 for w in range(n)]
        cen = torch.stack([c for c, _ in parts], dim=2)    # (outer, k, n, b)
        ctx = torch.stack([x for _, x in parts], dim=2)
        seeds = seed_tensor(prng.step_keys(key, outer * k), device)
        # copies (never views: the caller's tables stay as they were)
        stacked = {name: p.to(device).repeat(n, 1, 1) for name, p in params.items()}
        losses = torch.empty((outer, k), dtype=torch.float32, device=device)
        for o in range(outer):
            for j in range(k):
                i = o * k + j
                stacked, loss = step(stacked, cen[o, j], ctx[o, j], table,
                                     seeds[i].expand(n, 2).contiguous(),
                                     int(step0) + i)
                losses[o, j] = loss.mean()
            params = {name: pmean(t) for name, t in stacked.items()}
            for name, t in stacked.items():
                t.copy_(params[name].expand_as(t))
        if group is not None:
            dist.all_reduce(losses, group=group)
            losses = losses / world
        return params, losses

    return epoch_fn


def count_collective_ops(fn, *args, **kwargs) -> dict[str, int]:
    """Collectives by name that ``fn(*args, **kwargs)`` dispatches
    (``c10d::`` ops, NCCL kernels on the card); delegates to
    :func:`repro_torch.analysis.contracts.count_collective_ops`."""
    from repro_torch.analysis import contracts

    return contracts.count_collective_ops(fn, *args, **kwargs)


def assert_no_collectives(fn_or_counts, label: str = "") -> dict[str, int]:
    """Raise (a :class:`~repro_torch.analysis.contracts.ContractViolation`,
    an ``AssertionError``) if a callable, or counts already recorded, made
    any collective; delegates to
    :func:`repro_torch.analysis.contracts.certify_zero_collective`."""
    from repro_torch.analysis import contracts

    return contracts.certify_zero_collective(fn_or_counts, label)


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))


def _mean_loss(chunk_losses) -> float:
    """Scalar epoch loss from the list of per-chunk ``(n, S)`` losses."""
    return float(torch.cat(list(chunk_losses), dim=-1).mean())
