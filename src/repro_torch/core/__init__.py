"""Core — divide / train / merge, in torch.

* :mod:`repro_torch.core.sampling`       — EQUAL PARTITIONING / RANDOM SAMPLING / SHUFFLE
* :mod:`repro_torch.core.sgns`           — SGNS objective, init, dense and sparse steps, LR schedule
* :mod:`repro_torch.core.engine`         — UpdateEngine registry (``dense|sparse|rowgrad|fused|fused_hbm|fused_pipe|fused_tiered``)
* :mod:`repro_torch.core.schedule`       — epoch/chunk/total-steps derivation
* :mod:`repro_torch.core.async_trainer`  — zero-collective async training; the synchronous baselines;
  ``assert_no_collectives`` / ``count_collective_ops``
* :mod:`repro_torch.core.driver`         — the end-to-end pipeline; the sync baseline end to end
* :mod:`repro_torch.core.merge`          — the Merger registry: Concat / PCA / averaging / ALiR
* :mod:`repro_torch.core.merge_tree`     — the reduction-tree ALiR merge
* :mod:`repro_torch.core.distributions`  — unigram/bigram KL tools, Theorem 2, Vose alias tables

The package exports the names ``repro.core`` exports, each the port's
counterpart; ``merge_embeddings`` is :func:`repro_torch.core.merge.merge`
(``repro_torch.core.merge`` stays the submodule).
"""

import importlib

# name -> (submodule, attribute), imported on first use: async_trainer imports
# the kernels, which import core.sgns, so an eager import here would be circular
_EXPORTS = {
    **{n: ("sgns", n) for n in ("SGNSConfig", "init_params", "loss_fn", "embedding_matrix")},
    **{n: ("sampling", n) for n in ("sample_sentence_indices", "STRATEGIES")},
    **{n: ("engine", n) for n in ("UpdateEngine", "get_engine", "ENGINE_NAMES")},
    **{n: ("schedule", n) for n in ("EpochSchedule", "plan_epoch")},
    **{n: ("async_trainer", n) for n in ("AsyncShardTrainer", "make_sync_epoch",
                                         "assert_no_collectives", "count_collective_ops")},
    **{n: ("merge", n) for n in (
        "StackedModels", "stack_models", "Merger", "MergeConfig", "MergeResult",
        "get_merger", "MERGER_NAMES", "merge_alir", "merge_concat", "merge_pca",
        "merge_average", "orthogonal_procrustes", "reconstruct_missing", "MERGE_METHODS")},
    "merge_embeddings": ("merge", "merge"),
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        module, attr = _EXPORTS[name]
        value = getattr(importlib.import_module(f"{__name__}.{module}"), attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
