"""Finds what a cell names, by name: its configuration file, its traffic
mix (``traffic/<name>.json``), the drive that mix names
(``drives/<drive>.py``), its limits (``limits/<cell>.json``) and the
reader of each per-layer metric (``metrics/<metric>.py``), all under the
benchmark's root. Adding a cell, a traffic mix, a drive or a metric adds
files and entries; no code here changes."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]          # portbench/
ROOT = PACKAGE.parent                                  # the checkout


class Spec:
    """``BENCHMARK.json`` and the data files beside it. ``data`` is the
    folder that holds ``configs/``, ``traffic/``, ``drives/``, ``limits/``
    and ``metrics/`` (the benchmark's own folder unless a test gives another);
    configuration files are named by ``BENCHMARK.json`` relative to
    ``root``."""

    def __init__(self, spec: dict, root: Path = ROOT, data: Path = PACKAGE):
        self.spec, self.root, self.data = spec, Path(root), Path(data)

    @classmethod
    def load(cls, path: Path = ROOT / "BENCHMARK.json", data: Path = PACKAGE) -> "Spec":
        path = Path(path)
        return cls(json.loads(path.read_text()), root=path.parent, data=data)

    @property
    def run_seconds(self) -> int:
        return int(self.spec["run_seconds"])

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in self.spec['workloads']]}")

    def config(self, name: str) -> dict:
        entry = next((c for c in self.spec["configs"] if c["name"] == name), None)
        if entry is None:
            raise KeyError(f"no configuration {name!r} in BENCHMARK.json")
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.data / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.data / "limits" / f"{cell}.json").read_text())

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics read in this cell's traced run: those that
        list it, and those without a list whose ``moves`` it reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]

    def _module(self, kind: str, name: str):
        """The module ``<kind>/<name>.py`` of the data folder."""
        path = self.data / kind / f"{name}.py"
        mod_name = f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or spec.loader is None or not path.is_file():
            raise FileNotFoundError(f"no module for {kind} {name!r} at {path}")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod          # dataclasses look their module up there
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str):
        """The ``read(record)`` function of ``metrics/<metric>.py``."""
        return self._module("metrics", metric).read

    def drive(self, traffic: dict):
        """The module ``drives/<drive>.py`` that the traffic mix names: its
        ``Drive`` class and its ``control_readings``."""
        return self._module("drives", traffic["drive"])
