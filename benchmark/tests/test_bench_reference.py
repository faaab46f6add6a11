"""The plain references against the port's CPU path at a tiny size, their
controls, and the faults that a check must catch: each fault is planted
under the timed path of a whole run (the harness's look for a chip skipped)
and the run must come out not correct.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.control import readings
from benchmark.reference import precision
from benchmark.spec import Bench
from benchmark.tests.tiny import tiny_root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return Bench(tiny_root(tmp_path_factory.mktemp("tiny")))


def test_roundings():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0 - 2 ** -12, 0.1])
    t = precision.round_tf32(x)
    # 10 mantissa bits, nearest even
    assert t.tolist()[:3] == [1.0, 1.0 + 2 ** -9, -3.0]
    assert abs(t[3].item() - 0.1) <= 0.1 * 2 ** -11
    assert precision.round_fp8(torch.tensor([0.1, 1000.0])).tolist() == [0.1015625, 448.0]
    assert precision.round_bf16(torch.tensor([1.0 + 2 ** -9])).item() == 1.0


@pytest.mark.parametrize("name", ["match100-k4096", "ba-venice1778-pcg", "ba-venice52-dense"])
def test_reference_agrees_with_the_port_and_the_control_does_not(tiny, name):
    """The port's CPU path reads near 0 against the reference; the control
    (the reference in the precision below the configuration's) reads far
    above it on at least one number."""
    r = readings(tiny, name, seed=21, device="cpu")
    prog, ctrl = r["program"], r["control"]
    if name.startswith("match"):
        limit = tiny.cell(name)["limits"]["slot_mismatch"]
        assert prog["slot_mismatch"] <= limit < ctrl["slot_mismatch"]
        assert prog["matched_slots"] > 100
    else:
        assert prog["cost_excess"] < 1e-3 and prog["reproj_gap_px"] < 0.05
        assert prog["cost_report"] < 1e-5
        assert ctrl["cost_report"] > 10 * prog["cost_report"]
        assert ctrl["cost_excess"] > 10 * max(prog["cost_excess"], 0.0)


def _run(bench, name):
    return bench_run.run_cell(bench, name, seed=33, seconds=0.1, trace=False, device="cpu",
                              t0=time.perf_counter())


# --- faults under the matcher --------------------------------------------

def test_match_pass_that_leaves_the_state_unchanged_is_caught(tiny, monkeypatch):
    from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
    monkeypatch.setattr(IncrementalReconstructor, "match_features",
                        lambda self, state, filter=True: None)
    assert not _run(tiny, "match100-k4096")["correct"]


def test_match_half_the_pairs_left_out_is_caught(tiny, monkeypatch):
    from reconstructor_tpu_torch.parallel import sharding
    orig = sharding.match_and_gate_sharded

    def half(mesh, desc, kmask, xy, pair_idx, **kw):
        mi, cnt = orig(mesh, desc, kmask, xy, pair_idx, **kw)
        h = mi.shape[0] // 2
        mi, cnt = mi.clone(), cnt.clone()
        mi[h:], cnt[h:] = -1, 0
        return mi, cnt
    monkeypatch.setattr(sharding, "match_and_gate_sharded", half)
    assert not _run(tiny, "match100-k4096")["correct"]


def test_match_answer_altered_where_produced_is_caught(tiny, monkeypatch):
    from reconstructor_tpu_torch.matching import gated
    orig = gated.match_and_gate

    def altered(*a, **kw):
        mi, cnt = orig(*a, **kw)
        mi = mi.clone()
        hit = (mi >= 0) & (torch.arange(mi.shape[1]) % 8 == 0)
        mi[hit] = (mi[hit] + 1) % 256
        return mi, cnt
    monkeypatch.setattr(gated, "match_and_gate", altered)
    assert not _run(tiny, "match100-k4096")["correct"]


# --- faults under the BA solvers -------------------------------------------

def _solver(name):
    from reconstructor_tpu_torch.ba import distributed, lm as ba_lm
    return (distributed, "solve_pcg") if "pcg" in name else (ba_lm, "solve")


BA = ["ba-venice1778-pcg", "ba-venice52-dense"]


@pytest.mark.parametrize("name", BA)
def test_ba_solve_that_returns_its_state_unchanged_is_caught(tiny, monkeypatch, name):
    from reconstructor_tpu_torch.ba import lm as ba_lm
    mod, attr = _solver(name)
    orig = getattr(mod, attr)

    def unchanged(prob, **kw):
        res = orig(prob, **kw)
        return ba_lm.BAResult(cam_params=prob.cam_params, points=prob.points,
                              cost_initial=res.cost_initial, cost_final=res.cost_initial,
                              iterations=res.iterations)
    monkeypatch.setattr(mod, attr, unchanged)
    assert not _run(tiny, name)["correct"]


@pytest.mark.parametrize("name", BA)
def test_ba_half_the_observations_left_out_is_caught(tiny, monkeypatch, name):
    mod, attr = _solver(name)
    orig = getattr(mod, attr)

    def half(prob, **kw):
        mask = prob.obs_mask.clone()
        live = torch.nonzero(mask)[:, 0]
        mask[live[live.numel() // 2:]] = False
        kw.pop("host_obs", None)
        if "host_obs" in orig.__code__.co_varnames:
            kw["host_obs"] = (prob.obs_pt.numpy(), prob.obs_cam.numpy(), mask.numpy())
        return orig(prob._replace(obs_mask=mask), **kw)
    monkeypatch.setattr(mod, attr, half)
    assert not _run(tiny, name)["correct"]


@pytest.mark.parametrize("name", BA)
def test_ba_answer_altered_where_produced_is_caught(tiny, monkeypatch, name):
    mod, attr = _solver(name)
    orig = getattr(mod, attr)

    def altered(prob, **kw):
        res = orig(prob, **kw)
        pts = res.points.clone()
        pts[::7, 2] += 0.05
        return res._replace(points=pts)
    monkeypatch.setattr(mod, attr, altered)
    assert not _run(tiny, name)["correct"]


def test_ba_reported_cost_altered_is_caught(tiny, monkeypatch):
    mod, attr = _solver("ba-venice52-dense")
    orig = getattr(mod, attr)

    def altered(prob, **kw):
        res = orig(prob, **kw)
        return res._replace(cost_final=res.cost_final * 0.99)
    monkeypatch.setattr(mod, attr, altered)
    assert not _run(tiny, "ba-venice52-dense")["correct"]


def test_match_reference_replays_the_programs_draws(tiny):
    """Two passes of the program: the check of the second replays the first
    pass's draws before its own (a wrong count reads a mismatch)."""
    from benchmark.reference import match as ref_match
    a = ref_match.raw_draws((3, 4, 8), torch.device("cpu"), torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    b = ref_match.raw_draws((3, 4, 8), torch.device("cpu"), g)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert not torch.equal(b, ref_match.raw_draws((3, 4, 8), torch.device("cpu"), g))
    assert np.all(a.numpy() >= 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["match100-k4096", "ba-venice1778-pcg", "ba-venice52-dense"])
def test_control_fails_on_the_card(tiny, name):
    """The same readings through the card's path (kernel 1 in bf16, kernels 5
    and 6), at the tiny size; the cells' own sizes run through
    ``benchmark/control.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = readings(tiny, name, seed=22, device="cuda")
    prog, ctrl = r["program"], r["control"]
    limits = tiny.cell(name)["limits"]
    assert all(prog[k] <= v for k, v in limits.items()), prog
    assert any(ctrl[k] > v for k, v in limits.items()), ctrl


def test_ba_reference_solve_is_kept_and_read_back(tiny, tmp_path, monkeypatch):
    """The float64 reference solve is made once a checkout: the second call
    reads it back (the solver is not called) and gives the same solution; a
    problem that differs is solved anew."""
    from benchmark.reference import ba as ref_ba
    cell = tiny.cell("ba-venice52-dense")
    config, traffic = tiny.config(cell["config"]), tiny.traffic(cell["traffic"])
    kind = tiny.kind(traffic["kind"])
    monkeypatch.setattr(kind, "REFERENCE_CACHE", tmp_path / "cache")
    live = kind.make_problem(config["scene"], traffic, traffic["problem_seed"],
                             torch.device("cpu"))["live"]
    from reconstructor_tpu_torch.config import ReconstructorConfig
    st = kind.settings(ReconstructorConfig(**config["reconstructor"]), traffic["cameras"])
    first = kind.reference_solve(live, st)
    assert len(list((tmp_path / "cache").glob("ba_*.pt"))) == 1
    solve = ref_ba.solve
    monkeypatch.setattr(ref_ba, "solve", lambda *a, **k: pytest.fail("solved again"))
    again = kind.reference_solve(live, st)
    assert torch.equal(first.cams, again.cams) and torch.equal(first.pts, again.pts)
    assert first.cost == again.cost and first.iterations == again.iterations
    monkeypatch.setattr(ref_ba, "solve", solve)
    moved = live._replace(uv=live.uv + 0.5)
    assert kind.reference_solve(moved, st).cost != first.cost
    assert len(list((tmp_path / "cache").glob("ba_*.pt"))) == 2
