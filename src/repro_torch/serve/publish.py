"""Incremental merge → versioned artifact: the train→serve bridge.

The counterpart of ``repro.serve.publish``. The trainer's output is a
stack of sub-models; this module folds them through a
:class:`~repro_torch.core.merge.Merger` (any registry entry — the flat
``"alir"`` solver or the ``"alir_tree"`` reduction tree) **as they
arrive** and atomically publishes one artifact version per fold. A
serving process pointed at the directory picks up each version via
``refresh()`` — the first workers' embeddings are live while the rest
are still training; the final fold (cold, canonical order) is bitwise
the batch merge.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch.checkpoint.io import publish_table
from repro_torch.core.merge import MergeResult, Merger, alir_transforms, get_merger


def submodel_arrivals(stacked, order: Iterable[int] | None = None
                      ) -> Iterator[tuple[int, torch.Tensor, torch.Tensor]]:
    """Yield ``(worker_id, model, mask)`` from a trained
    :class:`~repro_torch.core.merge.StackedModels` (tensors on its device)
    — in ``order`` if given (simulating an out-of-order finish), else
    worker order."""
    for w in (range(stacked.n) if order is None else order):
        yield int(w), stacked.models[int(w)], stacked.mask[int(w)]


def publish_incremental(
    arrivals,
    artifact_dir: str,
    *,
    word_ids: np.ndarray | None = None,
    publish_every: int = 1,
    include_models: bool = True,
    final_cold_fold: bool = True,
    merger: Merger | str | None = None,
    meta: dict | None = None,
    device=None,
) -> tuple[list[int], MergeResult]:
    """Fold arriving sub-models and publish a table version per fold.

    Args:
        arrivals: iterable of ``(worker_id, model (V, d), mask (V,))``
            — a :func:`submodel_arrivals` generator over a trained
            stack, or a live queue drained as workers finish.
        artifact_dir: target directory (created if needed); versions
            are monotonic across runs into the same directory.
        word_ids: raw word id per union-vocab row
            (``union_vocab.word_ids``) — published so the server can
            answer raw-id queries.
        publish_every: publish after every k-th arrival (the last
            arrival always publishes).
        include_models: ship the folded sub-models as an artifact
            sidecar so sub-model-space queries can serve *present* rows
            too; turn off at production vocab where ``n·V·d`` dwarfs
            the table and only reconstruction (absent rows) is needed.
        final_cold_fold: finish with ``fold(warm=False)`` — the
            canonical solve that is bitwise the batch merge regardless
            of arrival order.
        merger: a :class:`~repro_torch.core.merge.Merger` instance or
            registry name (default ``"alir"``).
        meta: extra manifest fields for every published version.
        device: the device of a merger built from a name (the GPU
            unless ``"cpu"``).

    Returns:
        ``(published version numbers, final MergeResult)``.
    """
    merger = get_merger(merger if merger is not None else "alir", device=device)
    versions: list[int] = []
    fold = None
    arrivals = list(arrivals)
    if not arrivals:
        raise ValueError("no sub-model arrivals to publish")
    for k, (worker_id, model, mask) in enumerate(arrivals):
        last = k == len(arrivals) - 1
        result = merger.add(worker_id, model, mask)
        fold = result if result is not None else fold
        if last and final_cold_fold:
            fold = merger.fold(warm=False)
        if fold is None:
            continue  # late arrival before any fold — nothing servable yet
        if last or (k + 1) % publish_every == 0:
            versions.append(_publish_fold(
                merger, fold, artifact_dir, word_ids=word_ids,
                include_models=include_models,
                meta={**(meta or {}), "final": last}))
    return versions, fold


def _publish_fold(merger: Merger, fold: MergeResult,
                  artifact_dir: str, *, word_ids, include_models: bool,
                  meta: dict) -> int:
    stacked = merger.stacked()
    # ALiR mergers carry the worker→consensus maps in the result (the
    # tree merger's are composed down the tree); fall back to a direct
    # Procrustes solve for mergers that don't.
    Ws = (fold.transforms if fold.transforms is not None
          else alir_transforms(stacked, fold.Y))
    return publish_table(
        artifact_dir, fold.Y, fold.valid, word_ids=word_ids,
        worker_ids=np.asarray(fold.worker_ids, dtype=np.int32),
        mask=stacked.mask, transforms=Ws,
        models=stacked.models if include_models else None,
        meta={"merge": f"{merger.name}_incremental",
              "n_folded": merger.n_folded, **meta})
