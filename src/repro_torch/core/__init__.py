"""Core — divide / train / merge, in torch.

* :mod:`repro_torch.core.sampling`       — EQUAL PARTITIONING / RANDOM SAMPLING / SHUFFLE
* :mod:`repro_torch.core.sgns`           — SGNS objective, init, dense and sparse steps, LR schedule
* :mod:`repro_torch.core.engine`         — UpdateEngine registry (``dense|sparse|rowgrad|fused|fused_hbm|fused_pipe|fused_tiered``)
* :mod:`repro_torch.core.schedule`       — epoch/chunk/total-steps derivation
* :mod:`repro_torch.core.async_trainer`  — zero-collective async training; the synchronous baselines;
  ``assert_no_collectives`` / ``count_collective_ops`` (re-exported here)
* :mod:`repro_torch.core.driver`         — the end-to-end pipeline; the sync baseline end to end
* :mod:`repro_torch.core.merge`          — the Merger registry: Concat / PCA / averaging / ALiR
* :mod:`repro_torch.core.merge_tree`     — the reduction-tree ALiR merge
* :mod:`repro_torch.core.distributions`  — unigram/bigram KL tools, Theorem 2, Vose alias tables
"""

__all__ = ["assert_no_collectives", "count_collective_ops"]


def __getattr__(name):
    # re-exported lazily: async_trainer imports the kernels, which import
    # core.sgns, so an eager import here would be circular
    if name in __all__:
        from repro_torch.core import async_trainer
        return getattr(async_trainer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
