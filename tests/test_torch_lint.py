"""The port's AST lint (``repro_torch.analysis.lint_rules``) and the
``python -m repro_torch.analysis`` runner, mirroring ``tests/test_analysis.py``'s
lint tests in torch spellings.

Parity rule: the reference's four reproducibility rules hold over
``src/repro_torch``. Each rule is flagged in its torch spelling (RL001
arithmetic seeds into ``manual_seed``/``Generator().manual_seed``/
``SeedSequence``; RL002 ``torch.searchsorted`` without ``right=``/``side=``
and the left side in ``data/``; RL003 ``torch.rand*`` without
``generator=``, legacy ``np.random``, stdlib ``random`` and wall-clock
seeds in ``core/``, ``kernels/`` and ``elastic/``; RL004 any
``torch.distributed`` collective in the train path and ``elastic/``); the
pragma suppresses, the scopes limit, ``core/async_trainer.py`` and
``sharding/merge.py`` stay exempt; the real tree is clean; and the runner
exits 0 on it, and runs the ``dma_model`` and ``vmem`` passes.
"""

import contextlib
import io

import pytest

from repro_torch.analysis import __main__ as runner
from repro_torch.core.engine import SparseEngine
from repro_torch.analysis.lint_rules import run_lint


def _write(tmp_path, rel, text):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)
    return p


def _by_rule(root):
    out = {}
    for f in run_lint(root):
        out.setdefault(f.rule, []).append(f)
    return out


def test_lint_flags_each_rule_in_torch_spellings(tmp_path):
    _write(tmp_path, "core/seeds.py",
           "import torch\n"
           "import numpy as np\n"
           "def f(seed, worker):\n"
           "    torch.manual_seed(seed + worker)\n"
           "    g = torch.Generator().manual_seed(seed * 31 + worker)\n"
           "    return np.random.SeedSequence(seed + 1), g\n")
    _write(tmp_path, "data/draw.py",
           "import torch\n"
           "def g(cdf, u):\n"
           "    return torch.searchsorted(cdf, u)\n"
           "def h(cdf, u):\n"
           "    return torch.searchsorted(cdf, u, side='left')\n"
           "def k(cdf, u):\n"
           "    return torch.searchsorted(cdf, u, right=False)\n")
    _write(tmp_path, "kernels/rng.py",
           "import time\n"
           "import random\n"
           "import numpy as np\n"
           "import torch\n"
           "def f(x, gen):\n"
           "    a = torch.rand(3)\n"
           "    b = torch.randint(0, 5, (3,))\n"
           "    c = torch.randn(3, generator=gen)\n"
           "    x.uniform_()\n"
           "    np.random.seed(0)\n"
           "    torch.manual_seed(int(time.time()))\n"
           "    return random.random(), a, b, c\n")
    _write(tmp_path, "elastic/coll.py",
           "import torch.distributed as dist\n"
           "from torch.distributed import all_gather_into_tensor as agit\n"
           "def f(x, out):\n"
           "    dist.all_reduce(x)\n"
           "    agit(out, x)\n"
           "    return torch.gather(x, 0, x)\n")
    _write(tmp_path, "core/engine.py",
           "import torch\n"
           "def f(x):\n"
           "    torch.distributed.broadcast(x, 0)\n")
    by_rule = _by_rule(tmp_path)
    assert set(by_rule) == {"RL001", "RL002", "RL003", "RL004"}
    assert len(by_rule["RL001"]) == 3      # manual_seed, Generator().manual_seed, SeedSequence
    assert len(by_rule["RL002"]) == 3      # missing side, left side, right=False in data/
    # rand and randint without a generator, uniform_, np.random.seed, stdlib
    # random, the wall-clock seed; randn with generator= passes
    assert len(by_rule["RL003"]) == 6
    assert sorted((f.path, f.line) for f in by_rule["RL004"]) == [
        ("core/engine.py", 3), ("elastic/coll.py", 4), ("elastic/coll.py", 5)]


def test_lint_pragma_suppresses_and_scoping_limits(tmp_path):
    _write(tmp_path, "core/ok.py",
           "import torch\n"
           "x = torch.rand(3)  # repro-lint: ignore[RL003] a test fixture's noise\n"
           "y = torch.rand(3, generator=torch.Generator().manual_seed(0))\n")
    # the same hazards outside core/, kernels/, elastic/ are out of scope
    _write(tmp_path, "analysis/timing.py",
           "import numpy as np\n"
           "import torch\n"
           "import torch.distributed as dist\n"
           "np.random.seed(0)\n"
           "x = torch.randn(4)\n"
           "def f(x):\n"
           "    dist.all_reduce(x)\n")
    assert run_lint(tmp_path) == []
    # the sync baselines and the merge's Gram may name collectives
    for rel in ("core/async_trainer.py", "sharding/merge.py"):
        _write(tmp_path, rel,
               "import torch.distributed as dist\n"
               "def f(x):\n"
               "    dist.all_reduce(x)\n")
    assert run_lint(tmp_path) == []
    # a pragma for another rule does not suppress this one
    _write(tmp_path, "kernels/bad.py",
           "import torch\n"
           "x = torch.rand(3)  # repro-lint: ignore[RL002]\n")
    assert [f.rule for f in run_lint(tmp_path)] == ["RL003"]


def test_lint_real_tree_is_clean():
    assert [str(f) for f in run_lint("src/repro_torch")] == []


def _main(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = runner.main(argv)
    return rc, out.getvalue() + err.getvalue()


def test_analysis_runner_passes_on_the_tree(monkeypatch):
    """python -m repro_torch.analysis --device cpu runs contracts and lint
    and exits 0. The engine matrix and the traffic certificate are each
    tested in test_torch_contracts.py; here two engines and the committed
    traffic rows stand in for them, to keep the runner's test short."""
    from repro_torch.analysis import contracts
    from repro_torch.core.engine import get_engine

    monkeypatch.setattr(contracts, "engine_matrix",
                        lambda V: [get_engine("sparse"), get_engine("fused")])
    monkeypatch.setattr(contracts, "certify_bench_traffic", lambda path, device=None: [
        contracts.TrafficReport("pallas_fused_pipe@zipf50k", 91_386, 91_386)])
    rc, text = _main(["--device", "cpu"])
    assert rc == 0, text
    assert text.count("zero-collective ✓  tables-in-place ✓") == 2
    assert "static analysis: all passes OK" in text
    assert "lint: 0 findings in src/repro_torch: OK" in text
    monkeypatch.setattr(contracts, "engine_matrix", lambda V: [CopyingStep()])
    rc, text = _main(["contracts", "--device", "cpu"])
    assert rc == 1 and "FAILED" in text and "aliasing" in text


class CopyingStep(SparseEngine):
    """An engine whose step returns copies of the tables."""

    def make_step(self, cfg, total_steps):
        inner = super().make_step(cfg, total_steps)

        def step(params, c, x, table, seeds, i):
            params, loss = inner(params, c, x, table, seeds, i)
            return {k: v.clone() for k, v in params.items()}, loss

        return step


def test_analysis_runner_refuses_the_passes_not_ported_yet():
    """The two passes the runner once refused now run (the name kept from
    when they were refused): ``dma_model`` and ``vmem`` certify the port,
    and an unknown pass still exits non-zero."""
    rc, text = _main(["dma_model", "vmem"])
    assert rc == 0, text
    assert "dma_model: " in text and "launch schedules" in text and "OK" in text
    assert text.count("vmem: ") >= 7 and "REJECTED" not in text
    rc, text = _main(["dma-model"])
    assert rc == 0 and "== dma_model: OK" in text
    rc, text = _main(["lint"])
    assert rc == 0 and "== contracts" not in text
    with pytest.raises(SystemExit):
        _main(["nope"])
