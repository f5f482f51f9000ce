"""The control and the planted faults at a size a test run holds: each
comes out not correct by at least one compared number. On the card the
same readings come from ``portbench/control.py`` at the cells' own sizes;
the ``cuda`` test runs the tiny cells there end to end."""

from __future__ import annotations

import pytest
import torch

from portbench import control
from portbench.harness import cli

SEEDS = (2**31 + 5, 2**33 + 6, 3)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["tiny.fused", "tiny.rowgrad"])
def test_control_and_faults_fail_a_training_cell(tiny_spec, cell, seed):
    limits = tiny_spec.limits(cell)
    readings = control.readings(tiny_spec, cell, seed, torch.device("cpu"))
    assert set(readings) == {"control_bfloat16", "fault_half_batch", "fault_unchanged"}
    for variant, r in readings.items():
        assert any(r[k] > limits[k] for k in r), (variant, r)
    assert readings["fault_unchanged"]["change_gap"] == 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_altered_row_fails_the_merge_cell(tiny_spec, seed):
    limits = tiny_spec.limits("tiny.merge")
    readings = control.readings(tiny_spec, "tiny.merge", seed, torch.device("cpu"))
    r = readings["fault_altered_row"]
    assert r["merge_row_gap"] > limits["merge_row_gap"]
    # TF32 exists only on the card: the CPU's control reads as the reference
    assert readings["control_tf32"]["merge_row_gap"] <= limits["merge_row_gap"]


@pytest.mark.cuda
def test_tf32_control_fails_the_merge_cell_on_the_card(tiny_spec, needs_cuda):
    readings = control.readings(tiny_spec, "tiny.merge", SEEDS[0], torch.device("cuda"))
    limits = tiny_spec.limits("tiny.merge")
    assert any(v > limits[k] for k, v in readings["control_tf32"].items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.fused", "tiny.rowgrad", "tiny.merge"])
def test_tiny_cells_on_the_card(tiny_spec, needs_cuda, cell):
    res = cli.run_cell(tiny_spec, cell, SEEDS[1], 0.5, False, torch.device("cuda", 0), cli.clock())
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
