"""``BENCHMARK.json`` against its contract, and the lookups by name: a cell,
a traffic mix or a per-layer metric added as new files is found."""

from __future__ import annotations

import json
import re
import statistics

import pytest
import torch

from conftest import ROOT
from portbench.harness.spec import PACKAGE, Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert entry["file"].startswith("portbench/")
    body = json.loads((ROOT / entry["file"]).read_text())
    assert body["name"] == entry["name"]
    assert body["reduced"] == entry["reduced"] and body["source"] == entry["source"]
    for text in (entry["source"], entry["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_entry(cell):
    spec = Spec.load()
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and cell["chips"] == 1
    assert len(cell["why"]) <= 200
    spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    assert hasattr(spec.drive(traffic), "Drive")
    assert all(v >= 0 for v in spec.limits(cell["name"]).values())
    e2e = {m["name"] for m in spec.end_to_end(cell["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer(cell["name"])


def test_metrics_entries():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (PACKAGE / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_four_chip_cells_within_share():
    four = sum(c["chips"] == 4 for c in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_run_seconds_fit_a_full_check():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_new_files_are_found_by_name(tiny_spec):
    """A later cell adds a traffic file, a limits file and a metric reader,
    and an entry each: the harness finds them without a code change."""
    data = tiny_spec.data
    traffic = json.loads((data / "traffic" / "fused.json").read_text())
    traffic["steps_per_chunk"] = 2
    (data / "traffic" / "fused_short.json").write_text(json.dumps(traffic))
    (data / "limits" / "tiny.short.json").write_text((data / "limits" / "tiny.fused.json").read_text())
    (data / "metrics" / "steps_seen.py").write_text(
        "def read(record):\n    return float(record['counts']['steps'])\n")
    tiny_spec.spec["workloads"].append({"name": "tiny.short", "config": "tiny",
                                        "traffic": "fused_short", "chips": 1})
    tiny_spec.spec["end_to_end"][0]["workloads"].append("tiny.short")
    tiny_spec.spec["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                                        "source": "program_counter", "layer": "trainer",
                                        "moves": "train_pairs_per_s",
                                        "workloads": ["tiny.short"]})
    assert tiny_spec.traffic(tiny_spec.cell("tiny.short")["traffic"])["steps_per_chunk"] == 2
    assert tiny_spec.limits("tiny.short")["loss_gap"] > 0
    assert "steps_seen" in [m["name"] for m in tiny_spec.per_layer("tiny.short")]
    assert "steps_seen" not in [m["name"] for m in tiny_spec.per_layer("tiny.fused")]
    assert tiny_spec.reader("steps_seen")({"counts": {"steps": 7}}) == 7.0


def test_a_new_drive_is_found_by_name_and_runs(tiny_spec):
    """A later cell that drives another entry of the program adds
    ``drives/<name>.py`` and a traffic file that names it."""
    from portbench.harness import cli

    data = tiny_spec.data
    (data / "drives" / "replay.py").write_text(
        "from portbench.drives.train import Drive as _Train, control_readings  # noqa: F401\n"
        "class Drive(_Train):\n"
        "    pass\n")
    traffic = json.loads((data / "traffic" / "fused.json").read_text())
    (data / "traffic" / "replay.json").write_text(json.dumps(dict(traffic, drive="replay")))
    (data / "limits" / "tiny.replay.json").write_text((data / "limits" / "tiny.fused.json").read_text())
    tiny_spec.spec["workloads"].append({"name": "tiny.replay", "config": "tiny",
                                        "traffic": "replay", "chips": 1})
    tiny_spec.spec["end_to_end"][0]["workloads"].append("tiny.replay")
    module = tiny_spec.drive(tiny_spec.traffic("replay"))
    assert module.Drive.__name__ == "Drive" and module.__file__.endswith("replay.py")
    res = cli.run_cell(tiny_spec, "tiny.replay", 7, 0.2, False, torch.device("cpu"), cli.clock())
    assert res["correct"] and res["attempted"] > 0
    with pytest.raises(FileNotFoundError):
        tiny_spec.drive({"drive": "missing"})


def test_metric_without_workloads_goes_where_its_end_to_end_is(tiny_spec):
    tiny_spec.spec["per_layer"].append({"name": "device_idle_share.train", "unit": "%",
                                        "better": "lower", "source": "device_trace",
                                        "layer": "device", "moves": "merge_s"})
    names = [m["name"] for m in tiny_spec.per_layer("tiny.merge")]
    assert names.count("device_idle_share.train") == 1
    assert all(m["moves"] == "train_pairs_per_s" for m in tiny_spec.per_layer("tiny.fused"))


def test_spread_is_statistics_quartiles():
    """The spread rule the bounds are set by (PERF.md): the distance between
    the quartiles of ``statistics.quantiles(n=4)``, over the median."""
    values = [1.0, 1.02, 0.99, 1.01, 1.0, 0.98]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert 0 < (q3 - q1) / statistics.median(values) < 0.05
