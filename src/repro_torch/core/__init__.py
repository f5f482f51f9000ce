"""Core — divide / train / merge, in torch.

* :mod:`repro_torch.core.sampling`       — EQUAL PARTITIONING / RANDOM SAMPLING / SHUFFLE
* :mod:`repro_torch.core.sgns`           — SGNS objective, init, dense and sparse steps, LR schedule
* :mod:`repro_torch.core.engine`         — UpdateEngine registry (``dense|sparse|rowgrad|fused|fused_hbm|fused_pipe|fused_tiered``)
* :mod:`repro_torch.core.schedule`       — epoch/chunk/total-steps derivation
* :mod:`repro_torch.core.async_trainer`  — zero-collective async training
* :mod:`repro_torch.core.driver`         — the end-to-end pipeline
* :mod:`repro_torch.core.merge`          — Concat / PCA / averaging / ALiR
* :mod:`repro_torch.core.distributions`  — Vose alias tables
"""
