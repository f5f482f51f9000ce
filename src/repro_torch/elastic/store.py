"""Disk-backed per-worker checkpoint store for elastic training.

The counterpart of ``repro.elastic.store``: a thin, typed layer over
:mod:`repro_torch.checkpoint.io`'s worker-state publisher, in the
reference's byte format, so each package resumes from the other's state
directory. Each worker owns its own versioned artifact directory
(``worker_0000/``, ``worker_0001/``, …) under one state root, so any
number of workers checkpoint concurrently without sharing a manifest
writer, and the atomic publish-then-manifest ordering makes a kill at
any instant leave the previous complete ``(params, cursor)`` pair
loadable — never a torn one.

Tables may be handed to :meth:`WorkerStateStore.save` as tensors on any
device (copied to the host for the write) or as arrays; :meth:`load`
returns numpy arrays, which the caller moves to its device.
"""

from __future__ import annotations

from repro_torch.checkpoint.io import (
    gc_orphans, load_manifest, load_worker_state, publish_worker_state,
    worker_state_dir)
from repro_torch.elastic.cursor import WorkerCursor


class WorkerStateStore:
    """Atomic, versioned ``(params, cursor)`` checkpoints per worker."""

    def __init__(self, state_dir: str):
        self.state_dir = str(state_dir)

    # ------------------------------------------------------------ writes
    def save(self, cursor: WorkerCursor, params: dict) -> int:
        """Checkpoint one worker; returns the new state version. The
        cursor names the NEXT chunk to train, so saving after chunk k
        stores ``chunk=k+1`` (or the next epoch's chunk 0)."""
        return publish_worker_state(self.state_dir, cursor.worker,
                                    dict(params), cursor.to_meta())

    # ------------------------------------------------------------- reads
    def load(self, worker: int) -> tuple[dict, WorkerCursor, int] | None:
        """Last complete checkpoint of ``worker`` as
        ``(params, cursor, version)`` (numpy tables), or ``None`` on a
        fresh start."""
        state = load_worker_state(self.state_dir, worker)
        if state is None:
            return None
        params, cursor_meta, version = state
        return params, WorkerCursor.from_meta(cursor_meta), version

    def cursor(self, worker: int) -> WorkerCursor | None:
        """Just the cursor of the last complete checkpoint (straggler
        detection / progress probes), read from the manifest without
        pulling the tables off disk."""
        manifest = load_manifest(worker_state_dir(self.state_dir, worker))
        if manifest is None or not manifest["versions"]:
            return None
        latest = {e["version"]: e for e in manifest["versions"]}[manifest["latest"]]
        return WorkerCursor.from_meta(latest["cursor"])

    def finished_workers(self, num_workers: int, epochs: int) -> list[int]:
        """Workers whose stored cursor says every epoch is trained —
        the merge phase's arrival set."""
        out = []
        for w in range(num_workers):
            cur = self.cursor(w)
            if cur is not None and cur.done(epochs):
                out.append(w)
        return out

    # --------------------------------------------------------------- gc
    def gc(self, num_workers: int) -> list[str]:
        """Sweep crash debris (:func:`repro_torch.checkpoint.io.gc_orphans`)
        from every worker directory; returns removed file names."""
        removed = []
        for w in range(num_workers):
            removed.extend(gc_orphans(worker_state_dir(self.state_dir, w)))
        return removed
