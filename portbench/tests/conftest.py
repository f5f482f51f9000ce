"""Tiny cells for the benchmark's CPU tests: the benchmark's own drives and
metric readers, with small configurations, traffic and limits written to a
temporary folder (``tiny_spec``); ``cuda``-marked tests skip without a
card."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIG = {
    "name": "tiny",
    "corpus": {"vocab_size": 2000, "num_topics": 8, "num_features": 4, "latent_dim": 12,
               "zipf_a": 1.05, "beta": 4.0, "num_sentences": 3000, "mean_sentence_len": 20},
    "division": {"strategy": "shuffle", "vocabulary": "union", "rate": 0.34, "num_workers": 3,
                 "base_min_count": 10, "max_vocab": 2000},
    "sgns": {"dim": 16, "window": 5, "negatives": 5, "batch": 64, "lr": 0.025,
             "lr_min": 0.0001, "subsample_t": 0.0001, "epochs": 3},
    "reduced": [],
}
TINY_TRAFFIC = {
    "fused": {"drive": "train", "engine": "fused", "sampler": "alias", "steps_per_chunk": 4,
              "pool_chunks": 2, "trace_seconds": 0.5},
    "rowgrad": {"drive": "train", "engine": "rowgrad:cdf", "sampler": "cdf",
                "steps_per_chunk": 4, "pool_chunks": 2, "trace_seconds": 0.5},
    "alir": {"drive": "merge", "merger": "alir", "strategy": "random", "epochs": 1,
             "max_iters": 10, "tol": 1e-4, "sampled_merges": 2, "trace_seconds": 0.5},
}
TRAIN_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4,
                "nonfinite_window_losses": 0.0}
MERGE_LIMITS = {"valid_mismatch": 0.0, "merge_row_gap": 1e-3, "merge_map_gap": 1e-3}


def cuda_available() -> bool:
    import torch

    return torch.cuda.is_available()


@pytest.fixture
def needs_cuda():
    if not cuda_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def tiny_spec(tmp_path):
    """A spec with cells ``tiny.fused``, ``tiny.rowgrad`` and ``tiny.merge``
    over the tiny configuration, and the benchmark's real metric readers
    and end-to-end and per-layer entries."""
    from portbench.harness.spec import Spec

    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    data = tmp_path / "data"
    for sub in ("configs", "traffic", "limits"):
        (data / sub).mkdir(parents=True)
    for sub in ("metrics", "drives"):
        shutil.copytree(ROOT / "portbench" / sub, data / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (data / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    for name, t in TINY_TRAFFIC.items():
        (data / "traffic" / f"{name}.json").write_text(json.dumps(t))
    cells = {"tiny.fused": "fused", "tiny.rowgrad": "rowgrad", "tiny.merge": "alir"}
    for cell, traffic in cells.items():
        limits = MERGE_LIMITS if traffic == "alir" else TRAIN_LIMITS
        (data / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    train = [c for c, t in cells.items() if t != "alir"]
    spec = {
        "run_seconds": 1,
        "configs": [{"name": "tiny", "file": "configs/tiny.json", "reduced": []}],
        "workloads": [{"name": c, "config": "tiny", "traffic": t, "chips": 1}
                      for c, t in cells.items()],
        "end_to_end": [dict(m, workloads=train if m["name"] == "train_pairs_per_s"
                            else ["tiny.merge"]) if "workloads" in m else m
                       for m in real["end_to_end"]],
        "per_layer": [dict(m, workloads=train if m["moves"] == "train_pairs_per_s"
                           else ["tiny.merge"]) for m in real["per_layer"]],
    }
    return Spec(spec, root=data, data=data)
