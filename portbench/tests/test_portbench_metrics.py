"""Each per-layer reader on a record made by hand, the trace's reductions,
and the readers' silence where there is nothing to read."""

from __future__ import annotations

import pytest

from portbench.harness import trace

RECORD = {
    "window": (0.0, 1000.0),
    "device": [(0.0, 100.0, "k2"), (50.0, 100.0, "k2"), (500.0, 100.0, "add")],
    "spans": {"portbench.window": [(0.0, 1000.0)],
              "portbench.epoch": [(0.0, 400.0), (400.0, 400.0)]},
    "runtime": [(100.0, 50.0, "cudaStreamSynchronize"), (450.0, 20.0, "cudaLaunchKernel"),
                (900.0, 30.0, "cudaMemcpyAsync")],
    "host": [(150.0, 300.0, "aten::add"), (600.0, 390.0, "aten::slice")],
    "counts": {"steps": 10, "least_step_s": 1e-5, "wall_s": 0.001, "merges": 2,
               "measured": {"steps": 10, "least_step_s": 1e-5, "wall_s": 0.001}},
}


@pytest.mark.parametrize("metric,want", [
    ("device_idle_share.train", 75.0),
    ("device_idle_share.merge", 75.0),
    ("sgns_step_roofline", 40.0),
    ("train_mfu", 10.0),
    ("host_us_per_step.train", 75.0),
    ("merge_device_ms", 0.125),
])
def test_reader_on_a_hand_made_record(tiny_spec, metric, want):
    assert tiny_spec.reader(metric)(RECORD) == pytest.approx(want)


def test_train_mfu_reads_the_measured_window_not_the_traced_one(tiny_spec):
    rec = dict(RECORD, counts={**RECORD["counts"],
                               "measured": {"steps": 20, "least_step_s": 1e-5, "wall_s": 0.004}})
    assert tiny_spec.reader("train_mfu")(rec) == pytest.approx(5.0)
    traced_only = dict(RECORD, counts={k: v for k, v in RECORD["counts"].items()
                                       if k != "measured"})
    assert tiny_spec.reader("train_mfu")(traced_only) is None


@pytest.mark.parametrize("metric", ["device_idle_share.train", "sgns_step_roofline",
                                    "train_mfu", "merge_device_ms", "host_us_per_step.train"])
def test_reader_finds_nothing_and_returns_nothing(tiny_spec, metric):
    empty = {"window": (0.0, 1.0), "device": [], "spans": {}, "runtime": [], "host": [],
             "counts": {}}
    assert tiny_spec.reader(metric)(empty) is None


def test_busy_gaps_and_breakdown():
    assert trace.busy_us(RECORD) == 250.0
    assert trace.idle_gaps(RECORD) == [(150.0, 500.0), (600.0, 1000.0)]
    b = trace.breakdown(RECORD)
    assert b["device_ops"][0] == ["k2", 200.0 / 1e6]      # summed, overlaps and all
    assert dict(b["idle_gaps"]) == {"aten::add": 350.0 / 1e6, "aten::slice": 400.0 / 1e6}


def test_parse_clips_device_work_to_the_window():
    events = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 10, "dur": 100},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 20},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 105, "dur": 20},
              {"ph": "X", "cat": "kernel", "name": "late", "ts": 200, "dur": 5},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 1},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 11, "dur": 3},
              {"ph": "i", "cat": "kernel", "name": "instant", "ts": 50}]
    rec = trace.parse(events, {"steps": 1})
    assert rec["window"] == (10.0, 110.0)
    assert rec["device"] == [(10.0, 10.0, "k"), (105.0, 5.0, "k")]
    assert rec["runtime"] == [(12.0, 1.0, "cudaLaunchKernel")]
    with pytest.raises(RuntimeError):
        trace.parse(events[1:], {})
