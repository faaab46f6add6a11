"""The port's spans on its hot path, on the CPU: ``utils/profiling.annotate``
costs one check with no profiler; under ``profiling.trace`` a match pass and
the two BA solvers record their ``match.*`` and ``ba.*`` spans, nested as
the benchmark's readers expect; the stage timer and the CLI's ``--trace``
put the stage names beside them; and nothing computed changes."""

import contextlib
import json
from collections import defaultdict

import numpy as np
import pytest
import torch

from reconstructor_tpu_torch import cli
from reconstructor_tpu_torch.ba import distributed, lm as ba_lm
from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.eval import synth
from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
from reconstructor_tpu_torch.scripts import exp_ba
from reconstructor_tpu_torch.utils import profiling
from reconstructor_tpu_torch.utils.timing import TimeLogger

import torch_parity  # noqa: F401  (sets the worker's torch thread count)

CHUNK = 4


def spans_of(logdir):
    """name -> sorted [(start, end)] of the trace's annotations."""
    out = defaultdict(list)
    for e in json.load(open(logdir / profiling.TRACE_FILE))["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            out[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    return {k: sorted(v) for k, v in out.items()}


def inside(inner, outer):
    """Each interval of ``inner`` lies in one of ``outer``."""
    return all(any(s0 <= s and e <= e0 for s0, e0 in outer) for s, e in inner)


def feature_state():
    state, _, _ = synth.make_synthetic_state(n_views=5, n_points=300, h=240, w=320,
                                             clutter=16, seed=3)
    return state


def reconstructor(state):
    cfg = ReconstructorConfig(max_keypoints=state.max_keypoints, match_chunk_pairs=CHUNK,
                              fundamental_num_hypotheses=64)
    return IncrementalReconstructor(cfg, device="cpu", verbose=False)


@pytest.fixture(scope="module")
def problem():
    prob, _ = exp_ba.make_problem(np.random.default_rng(0), 6, 300, device="cpu")
    return prob


def test_annotate_without_a_profiler_is_the_shared_no_op():
    a, b = profiling.annotate("ba.trial"), profiling.annotate("match.chunk")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = profiling.annotate("ba.trial")
        assert on is not a and isinstance(on, torch.profiler.record_function)
    assert profiling.annotate("ba.trial") is a


def test_a_match_pass_records_its_spans_and_the_same_tables(tmp_path):
    state = feature_state()
    rec = reconstructor(state)
    with profiling.trace(str(tmp_path), device="cpu"):
        rec.match_features(state)
    sp = spans_of(tmp_path)
    n_pairs = len(rec.select_pairs(state))
    chunks = -(-n_pairs // CHUNK)
    assert len(sp["match.pass"]) == 1 and len(sp["match.tables"]) == 1
    assert len(sp["match.chunk"]) == chunks >= 2
    assert len(sp["match.knn"]) == len(sp["match.fgate"]) == chunks
    for stage in ("sample", "hypotheses", "refit"):
        assert len(sp[f"match.fgate.{stage}"]) == chunks
        assert inside(sp[f"match.fgate.{stage}"], sp["match.fgate"])
    for name in ("match.knn", "match.fgate"):
        assert inside(sp[name], sp["match.chunk"]), name
    for name in ("match.chunk", "match.tables"):
        assert inside(sp[name], sp["match.pass"]), name
    # the same draws without a profiler give the same tables
    plain = feature_state()
    reconstructor(plain).match_features(plain)
    assert state.matches and sorted(state.matches) == sorted(plain.matches)
    assert all(np.array_equal(state.matches[k], plain.matches[k]) for k in plain.matches)


@pytest.mark.parametrize("solver", ["pcg", "dense", "dense_compact"])
def test_a_solve_records_its_spans_and_the_same_result(solver, problem, tmp_path):
    def solve():
        if solver == "pcg":
            return distributed.solve_pcg(problem, max_iters=6)
        return ba_lm.solve(problem, max_iters=6, compact=solver == "dense_compact")

    with profiling.trace(str(tmp_path), device="cpu"):
        traced = solve()
    sp = spans_of(tmp_path)
    its = int(traced.iterations)
    assert its >= 2
    assert len(sp["ba.solve"]) == 1 and len(sp["ba.layout"]) == 1
    assert len(sp["ba.lm_iteration"]) == len(sp["ba.blocks"]) == its
    assert len(sp["ba.trial"]) >= its
    assert inside(sp["ba.layout"] + sp["ba.lm_iteration"], sp["ba.solve"])
    assert inside(sp["ba.blocks"] + sp["ba.trial"], sp["ba.lm_iteration"])
    if solver == "pcg":
        # every trial's CG loop stops at a host read every 16 iterations or at 64
        cg = sp["ba.pcg.cg_iteration"]
        assert inside(cg, sp["ba.trial"])
        per_trial = [sum(s <= c0 and c1 <= e for c0, c1 in cg) for s, e in sp["ba.trial"]]
        assert all(n % distributed._CG_CHECK == 0 or n == 64 for n in per_trial), per_trial
        assert sum(per_trial) == len(cg)
    else:
        assert "ba.pcg.cg_iteration" not in sp
        assert len(sp["ba.trial"]) == its           # one damped trial an iteration
    plain = solve()
    assert int(plain.iterations) == its
    for a, b in zip(traced[:4], plain[:4]):
        assert torch.equal(a, b)


def test_stage_timer_names_its_stages_in_the_trace(tmp_path):
    timer = TimeLogger()
    with profiling.trace(str(tmp_path), device="cpu"):
        with timer.event("feature matching"):
            with timer.event("adding new view"):
                pass
    sp = spans_of(tmp_path)
    assert inside(sp["adding new view"], sp["feature matching"])
    assert set(timer.totals()) == {"feature matching", "adding new view"}


def test_cli_trace_writes_the_run_with_stages_and_spans(tmp_path, monkeypatch):
    """``--trace DIR`` wraps the run: the stage the driver times and the
    program's spans inside it land in ``DIR/trace.json``; without it no
    trace is written."""
    def reconstruct(self, img_folder, out_folder=None, **kw):
        state = feature_state()
        with self.timer.event("feature matching"):
            self.match_features(state)
        return state

    monkeypatch.setattr(IncrementalReconstructor, "reconstruct", reconstruct)
    args = [str(tmp_path / "imgs"), str(tmp_path / "out"), "--device", "cpu", "--quiet"]
    assert cli.main(args + ["--trace", str(tmp_path / "tr")]) == 0
    sp = spans_of(tmp_path / "tr")
    assert len(sp["match.pass"]) == 1
    assert inside(sp["match.pass"], sp["feature matching"])
    assert cli.main(args) == 0
    assert not (tmp_path / "out" / profiling.TRACE_FILE).exists()
