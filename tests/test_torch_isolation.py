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
              "repro_torch.data.pipeline", "repro_torch.kernels.sgns_update",
              "repro_torch.kernels.ops", "repro_torch.kernels.sgns_fused_hbm",
              "repro_torch.kernels.ref", "repro_torch.kernels.sgns_fused_pipe",
              "repro_torch.kernels.sgns_fused_tiered", "repro_torch.analysis.workloads",
              "repro_torch.configs", "repro_torch.configs.base", "repro_torch.configs.shapes",
              "repro_torch.configs.registry", "repro_torch.configs.h2o_danube_1_8b",
              "repro_torch.configs.sgns_wiki", "repro_torch.kernels.swa_decode",
              "repro_torch.models", "repro_torch.models.layers",
              "repro_torch.models.attention", "repro_torch.models.transformer",
              "repro_torch.models.model", "repro_torch.launch.decode_llm",
              "repro_torch.core.merge_tree", "repro_torch.core.distributions",
              "repro_torch.sharding", "repro_torch.sharding.merge",
              "repro_torch.checkpoint", "repro_torch.checkpoint.io", "repro_torch.serve",
              "repro_torch.serve.cache", "repro_torch.serve.batcher", "repro_torch.serve.store",
              "repro_torch.serve.server", "repro_torch.serve.tcp", "repro_torch.serve.publish",
              "repro_torch.launch.train_sgns", "repro_torch.launch.serve",
              "repro_torch.examples", "repro_torch.examples.quickstart",
              "repro_torch.examples.train_w2v_100m", "repro_torch.examples.serve_decode",
              "repro_torch.elastic", "repro_torch.elastic.cursor", "repro_torch.elastic.store",
              "repro_torch.elastic.faults", "repro_torch.elastic.runner",
              "repro_torch.analysis.contracts", "repro_torch.analysis.lint_rules",
              "repro_torch.analysis.__main__", "repro_torch.core", "repro_torch.core.async_trainer",
              "repro_torch.optim", "repro_torch.optim.optimizers", "repro_torch.tree",
              "repro_torch.launch.train", "repro_torch.examples.async_embeddings_for_llm",
              "repro_torch.models.moe", "repro_torch.models.ssm",
              "repro_torch.sharding.rules", "repro_torch.sharding.ctx",
              "repro_torch.launch.dryrun", "repro_torch.launch.op_cost",
              "repro_torch.launch.mesh", "repro_torch.launch.roofline"):
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


def test_the_package_exports_load_no_jax_or_repro():
    """Every name the port's packages export (the reference's ``__all__``
    of core, data, eval, kernels and analysis: ``tests/test_torch_api.py``),
    each resolved in a fresh process, loads neither ``jax`` nor ``repro``."""
    code = (
        "import importlib, sys\n"
        "for pkg in ('core', 'data', 'eval', 'kernels', 'analysis'):\n"
        "    m = importlib.import_module('repro_torch.' + pkg)\n"
        "    for name in m.__all__:\n"
        "        getattr(m, name)\n"
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


def test_constructors_and_the_slice_entry_points_refuse_the_cpu_by_default(monkeypatch):
    """The public constructors and this slice's entry points raise without
    a GPU unless they are given device="cpu"."""
    import numpy as np
    from repro_torch import configs, prng
    from repro_torch.core.async_trainer import make_periodic_sync_epoch, make_sync_epoch
    from repro_torch.core.driver import train_sync_baseline
    from repro_torch.core.merge import IncrementalAlirMerger, get_merger, merge_concat
    from repro_torch.core.merge import stack_models
    from repro_torch.core.merge_tree import TreeAlirMerger
    from repro_torch.core.sgns import SGNSConfig, init_params
    from repro_torch.data.corpus import SemanticCorpusModel
    from repro_torch.data.pairs import AliasSampler, NegativeSampler
    from repro_torch.models import Model
    from repro_torch.models.transformer import init_cache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SGNSConfig(vocab_size=10, dim=8)
    llm = configs.get_config("h2o-danube-1.8b").reduced()
    corpus = SemanticCorpusModel.create(vocab_size=50, seed=0).generate(40, seed=1)
    table = np.linspace(0.1, 1.0, 10).astype(np.float32)
    stacked = stack_models([np.zeros((5, 2), np.float32)], [np.ones(5, bool)])
    calls = [
        lambda: init_params(prng.PRNGKey(0), cfg),
        lambda: Model(llm, prng.PRNGKey(0)),
        lambda: init_cache(llm, 1, 4),
        lambda: Model(configs.get_config("deepseek-v2-lite-16b").reduced(), prng.PRNGKey(0)),
        lambda: init_cache(configs.get_config("seamless-m4t-large-v2").reduced(), 1, 4,
                           enc_len=2),
        lambda: make_sync_epoch(cfg, table, 4),
        lambda: make_periodic_sync_epoch(cfg, table, 4, sync_every=2),
        lambda: train_sync_baseline(corpus, 50, SGNSConfig(vocab_size=0, dim=8), epochs=1),
        lambda: get_merger("alir"),
        lambda: get_merger("alir_tree"),
        lambda: IncrementalAlirMerger(),
        lambda: TreeAlirMerger(),
        lambda: merge_concat(stacked),
        lambda: NegativeSampler(np.ones(10)),
        lambda: AliasSampler(np.ones(10)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert init_params(prng.PRNGKey(0), cfg, device="cpu")["W"].device.type == "cpu"
    assert init_cache(llm, 1, 4, device="cpu")[0]["k"].device.type == "cpu"


def test_serving_launchers_and_examples_refuse_the_cpu_by_default(monkeypatch, tmp_path):
    """The store, the server, the publisher, both CLIs and the three
    examples raise without a GPU unless they are given the CPU."""
    import numpy as np
    from repro_torch.checkpoint import publish_table
    from repro_torch.examples import quickstart, serve_decode, train_w2v_100m
    from repro_torch.launch import serve, train_sgns
    from repro_torch.serve import ArtifactStore, EmbeddingServer, publish_incremental

    art = str(tmp_path / "art")
    publish_table(art, np.ones((4, 2), np.float32), np.ones(4, bool))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrivals = [(0, np.ones((4, 2), np.float32), np.ones(4, bool))]
    calls = [
        lambda: ArtifactStore(art),
        lambda: EmbeddingServer(art),
        lambda: publish_incremental(arrivals, str(tmp_path / "pub")),
        lambda: train_sgns.main(["--workers", "2", "--epochs", "1", "--vocab", "50",
                                 "--sentences", "40"]),
        lambda: serve.main(["--artifact", art, "--query", "1"]),
        lambda: quickstart.main([]),
        lambda: train_w2v_100m.main([]),
        lambda: serve_decode.main([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert ArtifactStore(art, device="cpu").table.emb.device.type == "cpu"


def test_lm_training_entry_points_refuse_the_cpu_by_default(monkeypatch):
    """The LM launcher (function and CLI) and the example that feeds it the
    paper's embeddings raise without a GPU unless given the CPU."""
    from repro_torch.examples import async_embeddings_for_llm
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: train.train("smollm-360m", reduced=True, steps=1, batch=1, seq=8, lr=1e-3,
                            ckpt_dir=None, ckpt_every=1),
        lambda: train.main(["--arch", "smollm-360m", "--reduced", "--steps", "1"]),
        lambda: async_embeddings_for_llm.main([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_version_and_package_data():
    assert repro_torch.__version__
    for f in ("counter_prng.cuh", "sample_negatives.cu", "sgns_fused_step.cu",
              "sgns_step.cuh", "sgns_row_grads.cu", "sgns_fused_hbm.cu", "swa_decode.cu"):
        assert (PORT / "csrc" / f).exists()
