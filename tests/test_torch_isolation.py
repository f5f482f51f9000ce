"""The port stands alone: importing it loads neither ``jax`` nor ``repro``,
no source of it (or ``chip_smoke.py``) imports them, and its entry points
refuse to fall back to the CPU when no GPU is present."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT)], "repro_torch."))


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for m in ("repro_torch.prng", "repro_torch.convert", "repro_torch.core.driver",
              "repro_torch.core.merge", "repro_torch.core.async_trainer",
              "repro_torch.kernels.sgns_fused", "repro_torch.eval.benchmarks",
              "repro_torch.data.pipeline"):
        assert m in mods


def test_importing_every_port_module_loads_no_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_entry_points_refuse_to_run_on_the_cpu_by_default(monkeypatch):
    """Without a GPU and without device="cpu", nothing quietly trains or
    merges on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.core.async_trainer import AsyncShardTrainer
    from repro_torch.core.driver import run_pipeline, train_submodels
    from repro_torch.core.merge import merge, stack_models
    from repro_torch.core.sgns import SGNSConfig
    from repro_torch.data.corpus import SemanticCorpusModel

    corpus = SemanticCorpusModel.create(vocab_size=50, seed=0).generate(40, seed=1)
    cfg = SGNSConfig(vocab_size=0, dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_submodels(corpus, 50, "shuffle", 2, cfg, epochs=1, batch_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_pipeline(corpus, 50, num_workers=2, cfg=cfg, epochs=1, batch_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AsyncShardTrainer(cfg=SGNSConfig(vocab_size=10, dim=8), num_workers=2,
                          total_steps=1)
    import numpy as np
    stacked = stack_models([np.zeros((5, 2), np.float32)], [np.ones(5, bool)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        merge(stacked, "concat", out_dim=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AsyncShardTrainer(cfg=SGNSConfig(vocab_size=10, dim=8), num_workers=2,
                          total_steps=1, device="cuda")


def test_version_and_package_data():
    assert repro_torch.__version__
    for f in ("counter_prng.cuh", "sample_negatives.cu", "sgns_fused_step.cu"):
        assert (PORT / "csrc" / f).exists()
