"""Artifact directory → always-complete table on the device, hot-swappable.

The counterpart of ``repro.serve.store``. The store is the reader half of
the atomic-publish contract in :mod:`repro_torch.checkpoint.io`: it only
ever opens table files the manifest names, so it never observes a partial
write. A loaded version is one :class:`DeviceTable`: the arrays a batch
gathers from on the device, the indexes that turn a query into rows on
the host. :meth:`ArtifactStore.refresh` swaps in a newer version with one
reference assignment — queries in flight keep the table they started
with.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.checkpoint.io import load_manifest, load_table
from repro_torch.data.vocab import UNK
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class DeviceTable:
    """One published version, ready to serve.

    ``emb``, ``valid``, ``mask``, ``transforms`` and ``models`` (the
    :class:`~repro_torch.checkpoint.io.ServableTable` fields, ``None`` when
    not published) are tensors on the store's device. ``valid_host``,
    ``worker_ids`` and ``raw_to_row`` (raw word id → row, or ``None``
    without ``word_ids``) stay numpy: every request reads them before it
    joins a batch, and a device read there would wait on the device once
    per request.
    """

    version: int
    meta: dict
    emb: torch.Tensor
    valid: torch.Tensor
    mask: torch.Tensor | None
    transforms: torch.Tensor | None
    models: torch.Tensor | None
    valid_host: np.ndarray
    worker_ids: np.ndarray | None
    raw_to_row: np.ndarray | None

    @property
    def dim(self) -> int:
        """Embedding dimensionality of the published table."""
        return int(self.emb.shape[1])


def _raw_to_row(word_ids: np.ndarray | None) -> np.ndarray | None:
    """raw word id → table row (or UNK), from the artifact's ``word_ids``;
    ``None`` when the artifact was published without one (queries are
    then already row ids)."""
    if word_ids is None:
        return None
    word_ids = np.asarray(word_ids)
    lookup = np.full(int(word_ids.max()) + 1, UNK, dtype=np.int32)
    lookup[word_ids] = np.arange(len(word_ids), dtype=np.int32)
    return lookup


class ArtifactStore:
    """A live view over a versioned artifact directory.

    Args:
        artifact_dir: directory :func:`repro_torch.checkpoint.publish_table`
            (or the JAX package's) writes to.
        version: pin a specific version (``refresh`` then never moves);
            default tracks the manifest's latest.
        device: where the table lives (the GPU unless ``"cpu"``).

    Attributes:
        table: the current :class:`DeviceTable`.
    """

    def __init__(self, artifact_dir: str, version: int | None = None, *, device=None):
        self.artifact_dir = artifact_dir
        self.device = resolve_device(device)
        self._pinned = version
        self.table: DeviceTable = self._load(version)

    def _load(self, version: int | None) -> DeviceTable:
        t = load_table(self.artifact_dir, version)

        def dev(a, dtype=None):
            return None if a is None else torch.from_numpy(a).to(self.device, dtype)

        return DeviceTable(
            version=t.version, meta=t.meta, emb=dev(t.emb), valid=dev(t.valid),
            mask=dev(t.mask, torch.bool), transforms=dev(t.transforms),
            models=dev(t.models), valid_host=t.valid,
            worker_ids=None if t.worker_ids is None else np.asarray(t.worker_ids),
            raw_to_row=_raw_to_row(t.word_ids))

    @property
    def version(self) -> int:
        """Version of the currently loaded table."""
        return self.table.version

    def latest_available(self) -> int | None:
        """The manifest's latest published version (cheap poll)."""
        manifest = load_manifest(self.artifact_dir)
        return manifest["latest"] if manifest else None

    def refresh(self) -> bool:
        """Reload if a newer version has been published (and the store
        is not pinned). Returns True when the table was swapped."""
        if self._pinned is not None:
            return False
        latest = self.latest_available()
        if latest is None or latest <= self.table.version:
            return False
        self.table = self._load(latest)
        return True

    def rows_of(self, raw_ids: np.ndarray) -> np.ndarray:
        """Map external (raw) word ids to table rows; unknown → UNK.

        With no ``word_ids`` in the artifact the query namespace *is*
        row space: out-of-range ids map to UNK."""
        raw_ids = np.asarray(raw_ids)
        lookup = self.table.raw_to_row
        if lookup is None:
            rows = raw_ids.astype(np.int32, copy=True)
            rows[(rows < 0) | (rows >= len(self.table.valid_host))] = UNK
            return rows
        rows = np.full(raw_ids.shape, UNK, dtype=np.int32)
        ok = (raw_ids >= 0) & (raw_ids < len(lookup))
        rows[ok] = lookup[raw_ids[ok]]
        return rows
