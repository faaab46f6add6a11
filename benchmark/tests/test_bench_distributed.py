"""The ``ba_distributed`` kind (the cell ``ba-final13682-dist4``) on a world of
4 gloo ranks on the CPU, at a tiny size: rank 0 is the harness's process,
ranks 1-3 are its workers. It steps, stops and judges correct; a killed
worker makes the run fail soon instead of hanging; the collectives' two
readers give None on a trace without the program's ``mesh.all_sum`` span or
byte counter (the program before they existed) and their numbers on one
with them.

    python -m pytest benchmark/tests/test_bench_distributed.py -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from benchmark import roofline_collectives
from benchmark import run as bench_run
from benchmark.spec import Bench
from benchmark.tests.tiny import REPO, _edit, tiny_root
from benchmark.trace import TraceData

CELL = "ba-final13682-dist4"
METRICS = ["allreduce_ms_per_cg_iter.dist", "allreduce_busbw_pct.dist"]


def tiny_dist_root(tmp):
    root = tiny_root(tmp)
    _edit(root / "benchmark" / "traffic" / "bal-problem-13682-4456117.json",
          lambda d: d.update(cameras=16, points=800, observations=2400))
    return root


def test_the_cell_states_final_13682_and_its_four_ranks():
    bench = Bench(REPO)
    cell = bench.cell(CELL)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    assert cell["chips"] == 4 and traffic["ranks"] == 4 and traffic["kind"] == "ba_distributed"
    assert (traffic["cameras"], traffic["points"], traffic["observations"]) == (
        13682, 4456117, 28987644)
    assert config["problem"] == {k: traffic[k] for k in ("cameras", "points", "observations")}
    assert config["reduced"] == [] and config["backend"] == traffic["backend"] == "nccl"
    venice = bench.config("bal-venice")
    for k in ("reconstructor", "scene", "camera_model", "precision", "reference_settings"):
        assert config[k] == venice[k], k
    assert set(cell["limits"]) == {"cost_excess", "cost_report", "reproj_gap_px"}
    assert set(bench.readers(CELL)) == {"lm_iterations.ba", *METRICS}


def test_tiny_cell_steps_stops_and_judges_correct(tmp_path):
    bench = Bench(tiny_dist_root(tmp_path))
    out = bench_run.run_cell(bench, CELL, seed=2 ** 31 + 13, seconds=0.1, trace=True,
                             device="cpu", t0=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4
    assert out["metrics"]["lm_iterations.ba"]["value"] >= 2
    # gloo on the CPU: spans, and no device kernels to read
    assert out["metrics"]["allreduce_ms_per_cg_iter.dist"]["value"] > 0
    assert "allreduce_busbw_pct.dist" not in out["metrics"]
    assert not list((tmp_path / "build" / "bench_rendezvous").glob("*"))
    # the same solve in the untraced run: the same iterations, same checks
    again = bench_run.run_cell(bench, CELL, seed=7, seconds=0.1, trace=False, device="cpu",
                               t0=time.perf_counter())
    assert again["correct"] and set(again["metrics"]) == {"ba_solve_s", "setup_s"}
    assert again["checks"] == out["checks"]


KILL = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
from benchmark import run as r
from benchmark.spec import Bench
bench = Bench(sys.argv[1])
kind = bench.kind("ba_distributed")
setup = kind.Runner.setup
def setup_then_kill(self):
    setup(self)
    self.procs[0].kill()
    self.procs[0].wait()
kind.Runner.setup = setup_then_kill
r.run_cell(bench, "ba-final13682-dist4", 5, 0.1, False, "cpu")
"""


def test_a_killed_worker_fails_the_run_instead_of_hanging(tmp_path):
    root = tiny_dist_root(tmp_path)
    t = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", KILL, str(root)], cwd=root,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "Error" in p.stderr, p.stderr[-2000:]
    assert time.perf_counter() - t < 240


def read(metric, trace, **counters):
    return Bench(REPO).reader(metric).read(SimpleNamespace(cell=CELL, trace=trace,
                                                           counters=counters))


def span(s, e, name):
    return (float(s), float(e), name, "user_annotation")


def kernel(s, e, name):
    return (float(s), float(e), name, "kernel")


def test_collective_readers_without_the_program_span_and_counter_give_none():
    host = [span(0, 100, "ba.pcg.cg_iteration"), span(100, 200, "ba.pcg.cg_iteration")]
    dev = [kernel(10, 30, "ncclDevKernel_AllReduce_Sum_f32_RING_SIMPLE")]
    bare = TraceData(window=(0.0, 1000.0), device=dev, host=host)
    assert read("allreduce_ms_per_cg_iter.dist", bare, ranks=4, allreduce_bytes=None) is None
    assert read("allreduce_busbw_pct.dist", bare, ranks=4, allreduce_bytes=None) is None
    assert read("allreduce_busbw_pct.dist", None, ranks=4, allreduce_bytes=1e6) is None
    no_kernel = TraceData(window=(0.0, 1000.0), device=[kernel(0, 5, "gemv")], host=host)
    assert read("allreduce_busbw_pct.dist", no_kernel, ranks=4, allreduce_bytes=1e6) is None


def test_collective_readers_with_the_span_and_counter():
    host = [span(0, 100, "ba.pcg.cg_iteration"), span(100, 200, "ba.pcg.cg_iteration"),
            span(20, 30, "mesh.all_sum"), span(120, 126, "mesh.all_sum"),
            span(990, 1010, "mesh.all_sum")]                     # cut at the window's end
    dev = [kernel(10, 30, "ncclDevKernel_AllReduce_Sum_f32_RING_SIMPLE"),
           kernel(40, 60, "ncclDevKernel_AllReduce_Sum_f32_RING_SIMPLE"),
           kernel(60, 90, "ncclDevKernel_Broadcast_RING_SIMPLE"), kernel(0, 5, "gemv")]
    t = TraceData(window=(0.0, 1000.0), device=dev, host=host)
    # (10 + 6) us over 2 CG iterations
    assert read("allreduce_ms_per_cg_iter.dist", t) == pytest.approx(8e-3)
    nbytes = 4.5e6
    got = read("allreduce_busbw_pct.dist", t, ranks=4, allreduce_bytes=nbytes)
    # 1.5 x 4.5 MB over 40 us of all-reduce kernels, against 450 GB/s
    assert got == pytest.approx(100.0 * 1.5 * nbytes / 40e-6 / 450e9)
    assert roofline_collectives.ring_allreduce_link_bytes(nbytes, 1) == 0.0
