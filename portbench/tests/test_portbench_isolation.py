"""What the benchmark loads and when it refuses to run: no JAX, no JAX
package, no ``benchmarks/`` (by whole top-level names); no result without
a card or without the program."""

from __future__ import annotations

import shutil
import subprocess
import sys
import textwrap

import pytest

from conftest import ROOT, cuda_available
from portbench.harness import cli


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    for name in ("jax", "jaxlib", "flax", "repro", "benchmarks"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert "repro" not in cli.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core.merge", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert cli.forbidden_modules() == ["jax", "repro"]


def test_a_run_loads_the_port_and_nothing_forbidden(tmp_path):
    """Every cell kind run end to end in a fresh process, every module of the
    benchmark imported: ``repro_torch`` is loaded, nothing forbidden is."""
    script = textwrap.dedent(f"""
        import sys, pathlib
        sys.path[0:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}, {str(ROOT / 'portbench' / 'tests')!r}]
        import torch
        import conftest
        from portbench import control
        from portbench.drives import merge, train
        from portbench.harness import cli, corpus, counts, spec, trace
        from portbench.reference import alir, sgns, threefry
        s = conftest.tiny_spec._fixture_function(pathlib.Path({str(tmp_path)!r}))
        for cell in ("tiny.fused", "tiny.rowgrad", "tiny.merge"):
            r = cli.run_cell(s, cell, 5, 0.2, cell == "tiny.merge", torch.device("cpu"), cli.clock())
            assert r["correct"], r
        for m in s.spec["per_layer"]:
            s.reader(m["name"])
        for t in ("fused", "alir"):
            s.drive(s.traffic(t))
        assert "repro_torch" in sys.modules
        print("FORBIDDEN", cli.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def _run_py(cwd, *args):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    if cuda_available():
        pytest.skip("a CUDA device is present")
    out = _run_py(ROOT, "--workload", "w2v100m.fused", "--seed", "1", "--seconds", "1",
                  "--trace", "0")
    assert out.returncode == cli.NO_CHIP and out.stdout == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path, "--workload", "w2v100m.fused", "--seed", "1", "--seconds", "1",
                  "--trace", "0")
    assert out.returncode == cli.NO_PROGRAM and out.stdout == ""
