"""The port's rank-scaling scripts on the CPU: ``scripts/bench_scaling.py``
with worlds of 1 and 2 gloo ranks at 8 images x 64 keypoints and BA 5
cameras / 200 points (every key of the report, the 2-rank match and gated
tables equal to the 1-rank ones, one BA cost, iteration count and cost
trace on every rank of a world), its rank checks on given reports, its BA
problem against ``tests/test_ba.py``'s, and ``diag_scaling``'s two-term
fit on given times and its replicated pieces."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from reconstructor_tpu_torch.scripts import bench_scaling, diag_scaling

from torch_parity import time_limit  # (also: two torch threads per worker)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_ba import make_ba_problem  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.multiprocess
def test_bench_scaling_one_and_two_gloo_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "reconstructor_tpu_torch.scripts.bench_scaling", "8", "64",
         "--ranks", "1,2", "--device", "cpu", "--reps", "2", "--ba-cams", "5",
         "--ba-points", "200", "--timeout", "120"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["ok"] and res["problems"] == []
    assert (res["num_images"], res["keypoints"], res["pairs"]) == (8, 64, 28)
    assert (res["ba_cams"], res["ba_points"], res["ba_obs"]) == (5, 200, 1000)
    assert res["device"] == "cpu" and res["backend"] == "gloo" and res["ranks"] == [1, 2]
    for n in (1, 2):
        for k in ("knn_pairs_per_s", "gated_pairs_per_s", "ba_solve_s", "knn_retained",
                  "gated_retained", "ba_retained", "knn_efficiency", "gated_efficiency",
                  "ba_efficiency"):
            assert res[f"{k}_{n}dev"] > 0, (k, n)
    assert res["knn_retained_1dev"] == res["ba_retained_1dev"] == 1.0
    one, two = res["workers"]["1"], res["workers"]["2"]
    assert [w["rank"] for w in two] == [0, 1] and len(one) == 1
    for w in two:
        assert w["knn_sha256"] == one[0]["knn_sha256"]
        assert w["gated_sha256"] == one[0]["gated_sha256"]
        assert w["ba_cost_final"] == two[0]["ba_cost_final"]
        assert w["ba_iterations"] == two[0]["ba_iterations"]
        assert w["ba_cost_trace"] == two[0]["ba_cost_trace"]
        assert len(w["ba_cost_trace"]) == 10         # max_iters, padded with the final cost
        assert len(w["knn_s"]) == len(w["gated_s"]) == len(w["ba_s"]) == 2
    assert one[0]["knn_matches"] >= 0 and one[0]["gated_inliers"] >= 0
    assert one[0]["knn_kernel_launches"] == 0        # the plain matcher on the CPU
    for w in one + two:
        assert w["ba_cost_final"] < w["ba_cost_initial"] / 100
    assert os.listdir(tmp_path) == []            # the script writes no file


@pytest.mark.parametrize("key,value", [("knn_sha256", "b"), ("gated_sha256", "b"),
                                       ("ba_cost_final", 1.5), ("ba_iterations", 4),
                                       ("ba_cost_trace", [2.0, 1.0])])
def test_summarise_flags_ranks_that_disagree(key, value):
    rank = {"pairs": 28, "knn_s": [0.1], "gated_s": [0.2], "ba_s": [0.3],
            "knn_sha256": "a", "gated_sha256": "a", "ba_cost_final": 1.0,
            "ba_iterations": 3, "ba_cost_trace": [2.0, 1.5]}
    worlds = {1: {"ok": True, "workers": [rank]},
              2: {"ok": True, "workers": [rank, dict(rank)]}}
    assert bench_scaling.summarise(worlds)["problems"] == []
    worlds[2]["workers"][1][key] = value
    res = bench_scaling.summarise(worlds)
    assert not res["ok"] and len(res["problems"]) == 1
    assert res["problems"][0].startswith("2 ranks: the ranks end with different")


def test_ba_problem_is_the_jax_tests():
    got = bench_scaling.make_ba_problem(np.random.default_rng(1), 6, 50)
    ref, _, _ = make_ba_problem(np.random.default_rng(1), n_cams=6, n_pts=50)
    for name, a, b in zip(ref._fields, got, ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "obs_uv":        # the two packages' rotations round differently
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_diag_fit_on_given_times():
    # exactly two-term: every world on the line
    f = diag_scaling.fit({1: 1.0, 2: 1.5, 4: 2.5})
    assert f["S"] == pytest.approx(0.5) and f["R"] == pytest.approx(0.5)
    assert f["pred"] == pytest.approx({1: 1.0, 2: 1.5, 4: 2.5})
    assert all(abs(e) < 1e-12 for e in f["rel_err"].values())
    # the middle world off the line: fit through the ends, error at 2
    f = diag_scaling.fit({1: 2.0, 2: 1.0, 4: 2.6})
    assert f["R"] == pytest.approx(0.2) and f["S"] == pytest.approx(1.8)
    assert f["pred"][2] == pytest.approx(2.2)
    assert f["rel_err"][2] == pytest.approx((1.0 - 2.2) / 1.0)
    # one world: no slope
    f = diag_scaling.fit({1: 0.7})
    assert f["R"] == 0.0 and f["S"] == 0.7


@time_limit(60)
def test_replicated_pieces_on_the_cpu():
    rep = diag_scaling.replicated_pieces(5, 200, "cpu", iters=2, reps=1)
    assert set(rep) == {"hpp_inverse", "block_jacobi", "cg_vectors", "total"}
    assert all(v > 0 for v in rep.values())
    assert rep["total"] == pytest.approx(sum(v for k, v in rep.items() if k != "total"))


@time_limit(60)
def test_diagnose_on_given_times():
    res = diag_scaling.diagnose({1: 1.0, 2: 1.5}, "cpu", 5, 200)
    assert res["S"] == pytest.approx(0.5) and res["R"] == pytest.approx(0.5)
    assert set(res["replicated_s_10it"]) == {"hpp_inverse", "block_jacobi", "cg_vectors",
                                             "total"}
    assert res["R_direct_10it"] == res["replicated_s_10it"]["total"] > 0
    assert res["R_direct_share_of_1rank"] == pytest.approx(res["R_direct_10it"] / 1.0)
    assert "card" not in res
