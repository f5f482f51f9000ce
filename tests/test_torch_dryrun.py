"""``repro_torch.launch.dryrun_sgns`` and ``launch/roofline.py`` on the CPU.

* ``--plan-only`` prints the reference's ingestion plans, line for line,
  for several worker and process counts, and runs nothing;
* every case runs at a small width (``SGNS_CFG`` replaced: V = 600, d =
  16) on ``--device cpu``: the async cases make zero collectives and print
  their ``vmem:`` line, ``sync`` three all-reduces a step, ``local_sgd_k``
  two a sync and one an epoch, ``merge_alir_iter`` one all-gather; each
  row's collective bytes are the counted ones; no device time is claimed
  for a CPU run; the flags are the reference's plus ``--device``;
* the merge case's Gram through the process group is bitwise the local
  one; ``step_bytes`` counts distinct rows (``chip_smoke.py``'s bounds).
"""

import contextlib
import io
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.launch import dryrun_sgns as jdry
from repro_torch.core.merge import _alir_iteration
from repro_torch.launch import dryrun_sgns as D
from repro_torch.launch import roofline as rl

SMALL = dict(vocab_size=600, dim=16)


def _out(fn, *a) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = fn(*a)
    return r, buf.getvalue()


@pytest.mark.parametrize("workers,processes", [(16, 8), (4, 4), (10, 3), (1, 1), (3, 8)])
def test_plan_only_prints_the_reference_plans(workers, processes):
    argv = ["--cases", "async", "--workers", str(workers), "--steps", "4", "--batch", "64",
            "--processes", str(processes), "--plan-only"]
    rows, ours = _out(D.main, argv)
    _, ref = _out(jdry.main, argv)
    assert rows == [] and ours == ref
    assert ours.count("host ") == processes


@pytest.fixture(scope="module")
def rows():
    """Every case at a small width on the CPU, 8 steps of 64 pairs, 2 workers."""
    real = D.SGNS_CFG
    D.SGNS_CFG = replace(real, **SMALL)
    try:
        out, text = _out(D.main, ["--cases", ",".join(D.CASES), "--steps", "8", "--batch",
                                  "64", "--workers", "2", "--device", "cpu",
                                  "--vmem-budget-mb", "0.2216796875"])
    finally:
        D.SGNS_CFG = real
    return {r["case"]: r for r in out}, text


def test_every_case_runs_with_its_collectives(rows):
    rows, text = rows
    assert set(rows) == set(D.CASES)
    for case in D.ASYNC_ENGINES:
        assert rows[case]["collective_ops"] == {}
        assert rows[case]["collective_bytes_per_chip"] == 0
        assert np.isfinite(rows[case]["loss"]) and rows[case]["workers"] == 2
    assert text.count("   vmem: ") == len(D.ASYNC_ENGINES)
    V, d = SMALL["vocab_size"], SMALL["dim"]
    assert rows["sync"]["collective_ops"] == {"c10d::allreduce_": 3 * 8}
    assert rows["sync"]["collective_bytes_per_chip"] == 8 * (2 * V * d * 4 + 4)
    assert rows["local_sgd_8"]["collective_ops"] == {"c10d::allreduce_": 2 * 1 + 1}
    assert rows["local_sgd_64"]["shape"] == "steps64"        # whole sync periods
    assert rows["local_sgd_64"]["collective_bytes_per_chip"] == 2 * V * d * 4 + 4 * 64
    assert rows["merge_alir_iter"]["collective_ops"] == {"c10d::_allgather_base_": 1}
    assert rows["merge_alir_iter"]["collective_bytes_per_chip"] == 2 * d * d * 4
    # bytes per step: 1/k of the sync case's, as the reference's docstring says
    per = {c: rows[c]["collective_bytes_per_step"] for c in ("sync", "local_sgd_8")}
    assert per["local_sgd_8"] < per["sync"] / 7


def test_no_device_time_is_claimed_on_the_cpu(rows):
    rows, text = rows
    for r in rows.values():
        assert r["measured_s"] is None and r["device_us_per_step"] is None
        assert r["bound_s"] == max(r["compute_s"], r["memory_s"], r["collective_s"])
        assert r["dominant"] in ("compute", "memory", "collective")
    assert "not measured" in text and "us/step" not in text
    assert "-- async_alias vs async (cdf draw): device time not measured" in text


def test_the_async_rows_count_the_step_bytes(rows):
    rows, _ = rows
    K, d = 5, SMALL["dim"]
    pairs = 2 * 64 * 8
    for case in D.ASYNC_ENGINES:
        r = rows[case]
        assert r["flops_per_chip"] == rl.sgns_model_flops(pairs, K, d)
        # at least the ids and losses; at most every row of both tables each step
        assert 8 * 2 * 64 * (12 + 8 * K) < r["bytes_per_chip"] <= 8 * (
            2 * 2 * 2 * SMALL["vocab_size"] * d * 4 + 2 * 64 * 100)


def test_budget_rejects_an_async_case(monkeypatch):
    from repro_torch.analysis.vmem import VmemBudgetError

    monkeypatch.setattr(D, "SGNS_CFG", replace(D.SGNS_CFG, **SMALL))
    with pytest.raises(VmemBudgetError, match="budget exceeded"):
        _out(D.main, ["--cases", "async_fused", "--steps", "2", "--batch", "64",
                      "--device", "cpu", "--vmem-budget-mb", "0.05"])


def test_flags_are_the_reference_ones_plus_device(monkeypatch):
    import argparse

    seen = []

    def grab(self, args=None, namespace=None):
        seen.append({a.dest: a.default for a in self._actions if a.dest != "help"})
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    for mod in (D, jdry):
        with pytest.raises(SystemExit):
            mod.main([])
    ours, ref = seen
    assert set(ours) - set(ref) == {"device"} and set(ref) <= set(ours)
    assert ours["cases"] == ref["cases"]


def test_merge_gram_through_the_group_is_the_local_one(tmp_path):
    import torch.distributed as dist

    g = torch.Generator().manual_seed(0)
    models = torch.randn((3, 40, 8), generator=g)
    Y = torch.randn((40, 8), generator=g)
    mask = torch.rand((3, 40), generator=g) > 0.2
    want = _alir_iteration(Y, models, mask, 4)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1), rank=0,
                            world_size=1)
    try:
        got = _alir_iteration(Y, models, mask, 4, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_step_bytes_counts_distinct_rows():
    c = torch.tensor([[1, 1, 2], [3, 4, 5]], dtype=torch.int32)
    x = torch.tensor([[2, 2, 2], [3, 3, 3]], dtype=torch.int32)
    ids = torch.tensor([[[7], [7], [1]], [[9], [9], [9]]], dtype=torch.int32)
    # W rows {1, 2} + {3, 4, 5}; C rows {2, 7, 1} + {3, 9}
    assert rl.unique_rows(c) == 5 and rl.unique_rows(torch.cat([x, ids.view(2, -1)], 1)) == 5
    assert rl.step_bytes(c, x, ids, 4) == 2 * 10 * 4 * 4 + 2 * 3 * 12 + 2 * 3 * 8 + 2 * 8
