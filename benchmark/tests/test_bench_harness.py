"""The harness: every cell, configuration and metric loads from its file;
BENCHMARK.json keeps to the contract; a new cell and metric are picked up
from new files alone; every cell runs end to end on the CPU at a tiny size;
the generators repeat per seed and hit the published counts.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import pytest
import torch

from benchmark import run as bench_run
from benchmark.spec import Bench
from benchmark.tests.tiny import REPO, tiny_root

CELLS = ["match100-k4096", "ba-venice1778-pcg", "ba-venice52-dense"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return Bench(tiny_root(tmp_path_factory.mktemp("tiny")))


def test_every_cell_config_traffic_and_metric_loads():
    bench = Bench(REPO)
    assert sorted(w["name"] for w in bench.doc["workloads"]) == sorted(CELLS)
    for name in CELLS:
        cell = bench.cell(name)
        config = bench.config(cell["config"])
        assert config["name"] == cell["config"] and config["reduced"] == []
        traffic = bench.traffic(cell["traffic"])
        assert hasattr(bench.kind(traffic["kind"]), "Runner")
        assert set(cell["limits"]) and int(cell["trace_steps"]) >= 1
        assert {m["name"] for m in bench.end_to_end(name)} >= {"setup_s"}
        assert len(bench.end_to_end(name)) >= 2 and bench.per_layer(name)
        for reader in bench.readers(name).values():
            assert callable(reader.read)


def test_benchmark_json_keeps_to_the_contract():
    doc = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(doc) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert doc["paths"] == ["benchmark"] and doc["command"][1] == "benchmark/run.py"
    assert isinstance(doc["run_seconds"], int) and 1 <= doc["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (doc["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = []
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file() and c["file"].startswith("benchmark/")
        names.append(c["name"])
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names
        for k in ("name", "traffic"):
            assert NAME.match(w[k]), w[k]
        names.append(w["name"])
    e2e = {m["name"] for m in doc["end_to_end"]}
    for m in doc["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    assert "setup_s" in e2e
    for m in doc["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
        names.append(m["name"])
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for n in names:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)
    for entry in doc["configs"] + doc["workloads"] + doc["per_layer"]:
        for k in ("why", "layer", "source"):
            if k in entry:
                assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k] and "\t" not in entry[k]
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for f in (REPO / "benchmark").rglob("*"):
        if "__pycache__" not in f.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(f.relative_to(REPO))), f


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_cpu(tiny, name):
    out = bench_run.run_cell(tiny, name, seed=2 ** 31 + 11, seconds=0.2, trace=False,
                             device="cpu", t0=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in tiny.end_to_end(name)}
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"


def test_traced_run_gives_breakdown_and_counters(tiny):
    out = bench_run.run_cell(tiny, "ba-venice52-dense", seed=5, seconds=0.1, trace=True,
                             device="cpu", t0=time.perf_counter())
    assert out["correct"]
    assert out["metrics"]["lm_iterations.ba"]["value"] >= 1
    assert out["device"]["window_s"] > 0 and set(out["breakdown"]) == {"device_ops",
                                                                      "idle_gaps"}


def test_new_cell_and_metric_are_picked_up_from_new_files(tmp_path):
    root = tiny_root(tmp_path)
    b = root / "benchmark"
    (b / "traffic" / "throwaway-pairs.json").write_text(json.dumps(
        {"kind": "match_passes", "warmup_passes": 0}))
    (b / "workloads" / "throwaway-cell.json").write_text(json.dumps(
        {"trace_steps": 1, "limits": {"slot_mismatch": 0.01}}))
    (b / "metrics" / "throwaway_pairs.match.py").write_text(
        "def read(run):\n    return run.counters['pairs'] * run.counters['traced_passes']\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "throwaway-cell", "config": "sift-fountain100",
                             "traffic": "throwaway-pairs", "chips": 1, "why": "a test"})
    doc["end_to_end"][0]["workloads"].append("throwaway-cell")
    doc["per_layer"].append({"name": "throwaway_pairs.match", "unit": "pairs",
                             "better": "higher", "source": "program_counter",
                             "layer": "device", "moves": "match_pairs_per_s",
                             "workloads": ["throwaway-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    bench = Bench(root)
    out = bench_run.run_cell(bench, "throwaway-cell", seed=3, seconds=0.1, trace=True,
                             device="cpu", t0=time.perf_counter())
    assert out["correct"] and out["metrics"]["throwaway_pairs.match"]["value"] == 10.0
    out = bench_run.run_cell(bench, "throwaway-cell", seed=3, seconds=0.1, trace=False,
                             device="cpu", t0=time.perf_counter())
    assert set(out["metrics"]) == {"match_pairs_per_s", "setup_s"}


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_the_run_fails(tmp_path):
    root = tiny_root(tmp_path)
    code = ("import sys, time; sys.path.insert(0, sys.argv[1]); import benchmark.run as r; "
            "from benchmark.spec import Bench; "
            "r.run_cell(Bench(sys.argv[1]), 'match100-k4096', 1, 0.1, False, 'cpu')")
    p = subprocess.run([sys.executable, "-c", code, str(root)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "reconstructor_tpu_torch" in p.stderr


def test_forbidden_modules_are_named_by_whole_top_level_name(monkeypatch):
    assert "reconstructor_tpu_torch" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert bench_run.forbidden_modules() == ["jax"]


def test_match_scene_repeats_per_seed_and_has_the_published_slots():
    from benchmark.reference.match import fitted_width
    from benchmark.traffic.match_passes import make_scene
    scene = Bench(REPO).config("sift-fountain100")["scene"]
    a = make_scene(scene, 2 ** 31 + 5, torch.device("cpu"))
    b = make_scene(scene, 2 ** 31 + 5, torch.device("cpu"))
    c = make_scene(scene, 6, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["desc"], c["desc"])
    assert tuple(a["desc"].shape) == (100, 4096, 128) and fitted_width(a["mask"]) == 3840
    assert sorted(a["valid"].tolist()) == sorted(c["valid"].tolist())
    # valid slots are a prefix of each view's slots
    assert torch.equal(a["mask"].sum(1), a["valid"])
    assert bool(a["mask"][torch.arange(100), a["valid"] - 1].all())


def _bal(name):
    bench = Bench(REPO)
    return bench.config("bal-venice")["scene"], bench.traffic(name)


def test_bal_problem_52_repeats_per_seed_and_has_the_published_counts():
    from benchmark.traffic.ba_solves import make_problem
    scene, counts = _bal("bal-problem-52-64053")
    a = make_problem(scene, counts, 2 ** 31 + 9, torch.device("cpu"))
    b = make_problem(scene, counts, 2 ** 31 + 9, torch.device("cpu"))
    live = a["live"]
    assert live.cams.shape[0] == 52 and live.pts.shape[0] == 64053
    assert live.obs_cam.numel() == 347173 and int(a["obs_mask"].sum()) == 347173
    assert torch.unique(live.obs_pt).numel() == 64053
    assert int(torch.bincount(live.obs_pt).min()) >= 2
    assert all(torch.equal(x, y) for x, y in zip(live, b["live"]))
    assert tuple(a["cam_params"].shape) == (64, 12) and a["points"].shape[0] == 65536


@pytest.mark.cuda
def test_bal_problem_1778_has_the_published_counts():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the full problem is too large for a CPU test")
    from benchmark.traffic.ba_solves import make_problem
    scene, counts = _bal("bal-problem-1778-993923")
    live = make_problem(scene, counts, 17, torch.device("cuda"))["live"]
    assert live.cams.shape[0] == 1778 and live.pts.shape[0] == 993923
    assert live.obs_cam.numel() == 5001946
    assert torch.unique(live.obs_pt).numel() == 993923


def test_bal_solve_is_the_same_work_on_every_seed(tiny):
    """Two seeds: the same LM iterations and the same final cost, bit for bit
    (the CPU path sums in observation order, as the card's kernels do)."""
    runs = []
    for seed in (5, 2 ** 31 + 7):
        cell = tiny.cell("ba-venice1778-pcg")
        traffic = tiny.traffic(cell["traffic"])
        r = tiny.kind(traffic["kind"]).Runner(cell=cell, config=tiny.config(cell["config"]),
                                              traffic=traffic, seed=seed,
                                              device=torch.device("cpu"))
        r.setup()
        r.step()
        runs.append((r.iterations[-1], r.result[2]))
    assert runs[0] == runs[1]
