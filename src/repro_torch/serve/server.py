"""The embedding query server.

The counterpart of ``repro.serve.server``. One :class:`EmbeddingServer`
owns the read path end to end: external word ids map to table rows
(store), hot rows come from the LRU, misses ride a coalesced batch
dispatch, and sub-model-space queries reconstruct absent rows on the fly
— the paper's robustness claim (``reconstruct_missing``) as a per-query
serving feature.

A coalesced batch is one upload of its row ids, one ``index_select`` on
the device per query space (plus the reconstruction's matrix product),
and one device-to-host copy of all its vectors; the cache holds host rows.

Query spaces:

* **merged** (default) — rows of the ALiR consensus table ``Y``;
* **sub-model** (``submodel=worker_id``) — rows in that worker's own
  coordinate space: present rows are the worker's trained vectors
  (requires the artifact's ``models`` sidecar), absent rows are
  reconstructed as ``Y[row] @ W_i.T`` from the stored alignment maps.
"""

from __future__ import annotations

import asyncio

import numpy as np
import torch

from repro_torch.data.vocab import UNK
from repro_torch.serve.batcher import CoalescingBatcher, ServeConfig
from repro_torch.serve.cache import LRUCache
from repro_torch.serve.store import ArtifactStore, DeviceTable

MERGED = -1   # the merged-consensus query space (sentinel "submodel")


class EmbeddingServer:
    """Batched asyncio lookups over a published artifact.

    Args:
        store: an :class:`ArtifactStore` (or a path, for convenience).
        cfg: coalescing window / batch cap / concurrency / cache size.
        device: the store's device when ``store`` is a path (the GPU
            unless ``"cpu"``).

    All lookups for all spaces flow through one batcher and one cache,
    keyed by ``(space, row)`` — a reconstruction is cached exactly like
    a plain row. ``refresh()`` hot-swaps to a newer table version and
    drops the cache; row ids are stable across versions (the union
    vocabulary is fixed before training), so in-flight keys stay valid.
    """

    def __init__(self, store: ArtifactStore | str, cfg: ServeConfig = ServeConfig(), *,
                 device=None):
        self.store = (ArtifactStore(store, device=device) if isinstance(store, str)
                      else store)
        self.cfg = cfg
        self.cache = LRUCache(cfg.cache_rows)
        self.batcher = CoalescingBatcher(self._gather, cfg)

    # ------------------------------------------------------------------ query
    async def embed_ids(self, raw_ids, submodel: int | None = None) -> dict:
        """Embed external (raw) word ids.

        Args:
            raw_ids: sequence of raw word ids (the corpus namespace —
                what ``Vocab.word_ids`` holds per table row).
            submodel: a worker id for sub-model-space vectors; ``None``
                for the merged consensus.

        Returns:
            ``{"vectors": (B, d) float32 numpy, "found": (B,) bool,
            "version": int}``. Ids unknown to the vocabulary or not yet
            covered by any folded sub-model come back zero with
            ``found=False`` — a serving miss, never an error.
        """
        rows = self.store.rows_of(np.asarray(raw_ids, dtype=np.int64))
        return await self.embed_rows(rows, submodel=submodel)

    async def embed_rows(self, rows, submodel: int | None = None) -> dict:
        """Embed table-row ids directly (see :meth:`embed_ids`)."""
        table = self.store.table
        rows = np.asarray(rows, dtype=np.int64)
        space = MERGED if submodel is None else self._axis_of(submodel)
        valid = table.valid_host
        found = (rows != UNK) & (rows >= 0) & (rows < len(valid))
        found = found & valid[np.clip(rows, 0, len(valid) - 1)]
        out = np.zeros((len(rows), table.dim), dtype=np.float32)

        async def one(i: int, row: int):
            key = (space, row)
            vec = self.cache.get(key)
            if vec is None:
                vec = await self.batcher.submit(key)
                self.cache.put(key, vec)
            out[i] = vec

        await asyncio.gather(*(one(i, int(r)) for i, r in enumerate(rows)
                               if found[i]))
        return {"vectors": out, "found": found, "version": table.version}

    def _axis_of(self, worker_id: int) -> int:
        """Map a worker id to its sub-model axis index in the artifact."""
        table = self.store.table
        if table.mask is None:
            raise ValueError(
                "artifact has no per-sub-model mask — published without "
                "sub-model sidecars; sub-model-space queries unavailable")
        if table.worker_ids is None:
            axis = int(worker_id)
        else:
            hits = np.flatnonzero(table.worker_ids == worker_id)
            if len(hits) == 0:
                raise KeyError(
                    f"worker {worker_id} not in this artifact's fold "
                    f"(has {table.worker_ids.tolist()})")
            axis = int(hits[0])
        if not 0 <= axis < table.mask.shape[0]:
            raise KeyError(f"sub-model axis {axis} out of range")
        return axis

    # --------------------------------------------------------------- dispatch
    def _gather(self, keys) -> dict:
        """The batched lookup behind the coalescer: group the deduped
        ``(space, row)`` keys by space, upload every row id at once, one
        gather (or reconstruction) per space on the device, and one copy
        of the whole batch back to the host."""
        table = self.store.table
        by_space: dict[int, list[int]] = {}
        for space, row in keys:
            by_space.setdefault(space, []).append(row)
        rows = torch.tensor([r for rs in by_space.values() for r in rs],
                            dtype=torch.int64).to(table.emb.device)
        parts, start = [], 0
        for space, rs in by_space.items():
            r = rows[start:start + len(rs)]
            start += len(rs)
            parts.append(table.emb.index_select(0, r) if space == MERGED
                         else self._reconstruct(table, space, r))
        vecs = torch.cat(parts).float().cpu().numpy()
        out, i = {}, 0
        for space, rs in by_space.items():
            for row in rs:
                out[(space, row)] = vecs[i].copy()     # the cache owns its rows
                i += 1
        return out

    @staticmethod
    def _reconstruct(table: DeviceTable, axis: int, rows: torch.Tensor) -> torch.Tensor:
        """Sub-model-space rows on the device: the worker's own vector
        where present, ``Y[row] @ W_i.T`` where absent
        (``reconstruct_missing``, served)."""
        if table.transforms is None:
            raise ValueError(
                "artifact has no alignment transforms — publish with "
                "transforms=alir_transforms(...) to serve reconstructions")
        present = table.mask[axis].index_select(0, rows)
        rec = torch.matmul(table.emb.index_select(0, rows), table.transforms[axis].T)
        if table.models is None:
            # an error check only: with the sidecar no batch waits on it
            if bool(present.any()):
                raise ValueError(
                    "rows present in this sub-model need the artifact's "
                    "`models` sidecar (publish_table(..., models=...)); "
                    "only absent rows are reconstructable from Y and W_i")
            return rec
        return torch.where(present[:, None], table.models[axis].index_select(0, rows), rec)

    # ------------------------------------------------------------- lifecycle
    def refresh(self) -> bool:
        """Hot-swap to the newest published version (drops the cache).
        Returns True when a swap happened."""
        if self.store.refresh():
            self.cache.clear()
            return True
        return False

    async def drain(self) -> None:
        """Flush pending coalesced batches and wait for them."""
        await self.batcher.drain()

    def stats(self) -> dict:
        """Batcher latency/batch stats + cache hit rate + live version."""
        return {**self.batcher.stats(),
                "cache_hit_rate": self.cache.hit_rate,
                "cache_rows": len(self.cache),
                "version": self.store.version}
