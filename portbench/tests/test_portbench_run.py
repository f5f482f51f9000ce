"""Whole runs of tiny cells on the CPU (the port's plain versions): the
result's last line, the check against the reference, the traced run."""

from __future__ import annotations

import json

import pytest
import torch

from portbench.harness import cli

CELLS = ("tiny.fused", "tiny.rowgrad", "tiny.merge")
SEED = 2**33 + 12345


def run(spec, cell, trace=False, seed=SEED, seconds=0.3):
    return cli.run_cell(spec, cell, seed, seconds, trace, torch.device("cpu"), cli.clock())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_spec, cell):
    res = run(tiny_spec, cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert res["attempted"] > 0 and res["failed"] == 0
    wanted = {m["name"] for m in tiny_spec.end_to_end(cell)}
    assert set(res["metrics"]) == wanted and "setup_s" in wanted
    assert all(m["value"] > 0 for m in res["metrics"].values())
    json.dumps(res)


@pytest.mark.parametrize("cell", ("tiny.fused", "tiny.merge"))
def test_traced_run_reports_per_layer_metrics_it_can_read(tiny_spec, cell):
    """On the CPU nothing runs on a device: the device metrics are left out
    of the line, the host's are read, and the breakdown is there."""
    res = run(tiny_spec, cell, trace=True)
    assert res["correct"]
    assert set(res) == {"correct", "attempted", "failed", "metrics", "device", "breakdown",
                        "checks"}
    assert res["device"]["window_s"] > 0 and res["device"]["busy_s"] == 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    names = set(res["metrics"])
    assert names <= {m["name"] for m in tiny_spec.per_layer(cell)}
    if cell == "tiny.fused":
        assert names == {"host_us_per_step.train"}


# --- the timed path broken underneath: each fault comes out not correct ---
def _fused_fault(kind):
    from repro_torch.kernels import sgns_fused

    real = sgns_fused.sgns_fused_step

    def step(params, centers, contexts, table, seeds, lr, *, negatives=5):
        if kind == "unchanged":
            copy = {k: v.clone() for k, v in params.items()}
            _, loss, ids = real(copy, centers, contexts, table, seeds, lr, negatives=negatives)
            return params, loss, ids
        if kind == "half_batch":
            h = centers.shape[1] // 2
            return real(params, centers[:, :h].contiguous(), contexts[:, :h].contiguous(),
                        table, seeds, lr, negatives=negatives)
        params, loss, ids = real(params, centers, contexts, table, seeds, lr, negatives=negatives)
        loss = loss.clone()
        loss[0, 0] += 1.0                       # an answer altered where it is produced
        return params, loss, ids

    return sgns_fused, "sgns_fused_step", step


def _rowgrad_unchanged():
    from repro_torch.core import sgns

    real = sgns.train_step_sparse_

    def step(params, *args, **kwargs):
        return real({k: v.clone() for k, v in params.items()}, *args, **kwargs)

    return sgns, "train_step_sparse_", step


def _merge_altered_row():
    import dataclasses

    from repro_torch.core.merge import AlirMerger

    real = AlirMerger.merge

    def merge(self, stacked, **kw):
        res = real(self, stacked, **kw)
        emb = res.emb.clone()
        row = int(res.valid.nonzero()[0])
        emb[row] = -emb[row]
        return dataclasses.replace(res, emb=emb)

    return AlirMerger, "merge", merge


FAULTS = {
    "fused_unchanged": ("tiny.fused", lambda: _fused_fault("unchanged"), "change_gap"),
    "fused_half_batch": ("tiny.fused", lambda: _fused_fault("half_batch"), "grad_gap"),
    "fused_altered_loss": ("tiny.fused", lambda: _fused_fault("altered"), "loss_gap"),
    "rowgrad_unchanged": ("tiny.rowgrad", _rowgrad_unchanged, "change_gap"),
    "merge_altered_row": ("tiny.merge", _merge_altered_row, "merge_row_gap"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(tiny_spec, monkeypatch, fault):
    cell, patch, number = FAULTS[fault]
    monkeypatch.setattr(*patch())
    res = run(tiny_spec, cell)
    assert not res["correct"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]
