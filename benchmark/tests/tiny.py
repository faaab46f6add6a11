"""A copy of the benchmark at a size the CPU runs in seconds: the same
cells, metrics and code, with the configurations and traffic shrunk (and the
dense budget lowered so that the larger problem still routes to PCG)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _edit(path: Path, fn) -> None:
    doc = json.loads(path.read_text())
    fn(doc)
    path.write_text(json.dumps(doc, indent=1))


def tiny_root(tmp: Path) -> Path:
    """A checkout-like root under ``tmp``: BENCHMARK.json and benchmark/."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    b = tmp / "benchmark"
    _edit(b / "configs" / "sift-fountain100.json", lambda d: d["scene"].update(
        n_views=5, slots=512, valid_slots=[384, 448], n_points=1500))
    _edit(b / "configs" / "bal-venice.json",
          lambda d: d["reconstructor"].update(ba_dense_w_max_elems=500_000))
    _edit(b / "traffic" / "bal-problem-1778-993923.json",
          lambda d: d.update(cameras=16, points=2000, observations=6000))
    _edit(b / "traffic" / "bal-problem-52-64053.json",
          lambda d: d.update(cameras=10, points=400, observations=1200))
    return tmp
