"""What a run reads, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells, their
configuration and traffic, and the metrics. Everything that belongs to one
of them is a file of its own under ``benchmark/``:

- ``configs/<config>.json``: the configuration (its file is named in
  ``BENCHMARK.json``);
- ``workloads/<cell>.json``: what the cell adds: the limits of its output
  check and how many of its steps the traced run records;
- ``traffic/<traffic>.json``: the traffic mix, whose ``kind`` names the
  general generator and runner ``traffic/<kind>.py``;
- ``metrics/<metric>.py``: the reader of one per-layer metric, a function
  ``read(run)`` that returns a number or None.

A later cell, configuration, traffic mix or metric is new files and new
entries in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = "benchmark"


def _load_module(path: Path, name: str) -> ModuleType:
    if name in sys.modules and getattr(sys.modules[name], "__file__", None) == str(path):
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The benchmark as a checkout at ``root`` describes it."""

    def __init__(self, root):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.is_file():
            raise FileNotFoundError(f"no BENCHMARK.json in {self.root}")
        self.doc = json.loads(path.read_text())
        self.dir = self.root / BENCH_DIR

    def _json(self, *parts: str) -> dict:
        path = self.dir.joinpath(*parts)
        if not path.is_file():
            raise FileNotFoundError(f"{path} is missing")
        return json.loads(path.read_text())

    def cell(self, name: str) -> dict:
        """The cell's entry of ``BENCHMARK.json`` merged with its own file."""
        entries = [w for w in self.doc["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return {**self._json("workloads", f"{name}.json"), **entries[0]}

    def config(self, name: str) -> dict:
        entries = [c for c in self.doc["configs"] if c["name"] == name]
        if not entries:
            raise KeyError(f"no config {name!r} in BENCHMARK.json")
        return json.loads((self.root / entries[0]["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def kind(self, kind: str) -> ModuleType:
        return _load_module(self.dir / "traffic" / f"{kind}.py", f"bench_traffic_{kind}")

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.doc["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.doc["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]

    def reader(self, metric: str) -> ModuleType:
        return _load_module(self.dir / "metrics" / f"{metric}.py",
                            "bench_metric_" + metric.replace(".", "_").replace("-", "_"))

    def readers(self, cell: str) -> Dict[str, ModuleType]:
        return {m["name"]: self.reader(m["name"]) for m in self.per_layer(cell)}
