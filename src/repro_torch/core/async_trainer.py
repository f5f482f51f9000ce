"""The Train phase — zero-collective asynchronous sub-model training.

The counterpart of ``repro.core.async_trainer``. The paper's reducers
each train one SGNS sub-model with **no parameter synchronization**; here
the n sub-models are stacked ``(n, V, d)`` tables on one device and the
worker axis lives in the kernel grid: one engine step (one K2 call)
advances all n workers by one micro-batch. Nothing in the train path
calls ``torch.distributed``.

Random streams follow the reference exactly: each worker's chunk key is
split off the chunk key, and each step's seed is the ``sub`` of a
``key, sub = split(key)`` chain (``lax.scan`` in the reference). The
port derives a chunk's ``(n, S, 2)`` seed words on the host with
:mod:`repro_torch.prng` and copies them to the device once per chunk.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import sgns
from repro_torch.core.engine import get_engine
from repro_torch.core.sgns import SGNSConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.sgns_fused import seed_tensor


def make_worker_epoch(cfg: SGNSConfig, total_steps: int, engine="fused"):
    """Returns ``epoch_fn(params, centers (n,S,B), contexts (n,S,B),
    neg_table, keys (n,2), step0) -> (params, losses (n,S))``.

    ``params`` (stacked ``(n, V, d)``) are updated in place; ``keys``
    are the workers' uint32 chunk keys; ``neg_table`` holds each
    worker's own noise table in the layout ``engine.table_kind`` names.
    """
    step = get_engine(engine).make_step(cfg, total_steps)

    def epoch_fn(params, centers, contexts, neg_table, keys, step0):
        device = params["W"].device
        n, S, _ = centers.shape
        seeds = seed_tensor(prng.step_keys(keys, S).transpose(1, 0, 2),
                            device)                       # (S, n, 2)
        # step-major, so each step's (n, B) slice is contiguous
        cen = centers.to(device).transpose(0, 1).contiguous()
        ctx = contexts.to(device).transpose(0, 1).contiguous()
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
    spec string (``"fused"``) that owns the per-step compute.
    ``device`` — where the tables live; ``None`` is the GPU (raising
    without one), ``"cpu"`` runs the kernels' plain versions.
    """

    cfg: SGNSConfig
    num_workers: int
    total_steps: int
    engine: object = "fused"
    device: object = None

    def __post_init__(self):
        self.engine = get_engine(self.engine)
        self.engine.validate(vocab_size=self.cfg.vocab_size)
        self.device = resolve_device(self.device)
        self._epoch = None

    def init(self, key) -> dict:
        """Stacked ``{"W", "C"}`` ``(n, V, d)``: worker i's tables are
        ``init_params(split(key, n)[i])``."""
        keys = prng.split(key, self.num_workers)
        V, d = self.cfg.vocab_size, self.cfg.dim
        W = torch.empty((self.num_workers, V, d), dtype=torch.float32,
                        device=self.device)
        for i, k in enumerate(keys):
            W[i] = sgns.init_params(k, self.cfg, device=self.device)["W"]
        C = torch.zeros_like(W)
        return {"W": W, "C": C}

    def _epoch_fn(self):
        if self._epoch is None:
            self._epoch = make_worker_epoch(self.cfg, self.total_steps,
                                            engine=self.engine)
        return self._epoch

    def epoch(self, params, centers, contexts, neg_table, key, step0=0):
        """params: (n,V,d) dict, updated in place; centers/contexts:
        (n,S,B) int32 tensors or arrays; neg_table: {'prob','alias'} of
        (n,V) on the trainer's device; key: the chunk's (2,) key.
        Returns ``(params, losses (n, S))``."""
        keys = prng.split(key, self.num_workers)
        return self._epoch_fn()(params, _tensor(centers), _tensor(contexts),
                                neg_table, keys, int(step0))

    def worker_epoch(self, params, centers, contexts, neg_table, key, step0=0):
        """One worker's chunk: params ``(V, d)`` tables (updated in
        place), centers/contexts ``(S, B)``, the worker's own ``(V,)``
        table, and ``key`` the exact per-(worker, chunk) key the stacked
        :meth:`epoch` would have split out for it. Returns
        ``(params, losses (S,))``."""
        stacked = {k: v.unsqueeze(0) for k, v in params.items()}
        table = {k: v.unsqueeze(0) for k, v in neg_table.items()}
        keys = np.asarray(key, dtype=np.uint32)[None]
        _, losses = self._epoch_fn()(stacked, _tensor(centers)[None],
                                     _tensor(contexts)[None], table, keys,
                                     int(step0))
        return params, losses[0]


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))


def _mean_loss(chunk_losses) -> float:
    """Scalar epoch loss from the list of per-chunk ``(n, S)`` losses."""
    return float(torch.cat(list(chunk_losses), dim=-1).mean())
