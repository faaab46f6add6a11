"""The port's BA scripts on the CPU: ``scripts/exp_ba.py``'s synthetic
problem against the JAX package's for the same generator (integers and
the arrays built before any rotation equal, projections within 1e-3 px:
the two rotations round differently in float32), and ``profile_ba``,
``profile_ba_latency`` and ``profile_pcg_path`` at a tiny size, with their
keys checked."""

import json
import os
import sys

import jax
import numpy as np
import pytest

from reconstructor_tpu_torch.scripts import exp_ba, profile_ba, profile_ba_latency, profile_pcg_path

import torch_parity  # noqa: F401  (two torch threads per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("C,L,C_pad,L_pad", [(10, 2000, 16, 2048), (6, 300, 16, 512)])
def test_make_problem_matches_the_jax_script(C, L, C_pad, L_pad):
    sys.path.insert(0, REPO)
    jax.config.update("jax_platforms", "cpu")
    from scripts import exp_ba as jexp
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    pj, Oj = jexp.make_problem(rng_j, C, L, None, C_pad=C_pad, L_pad=L_pad)
    pt, Ot = exp_ba.make_problem(rng_t, C, L, None, device="cpu", C_pad=C_pad, L_pad=L_pad)
    assert Ot == Oj
    for k in pj._fields:
        a, b = np.asarray(getattr(pj, k)), getattr(pt, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k == "obs_uv":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-3)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
    # both generators drew the same numbers
    assert rng_j.integers(1 << 30) == rng_t.integers(1 << 30)


def test_time_to_cost_reads_both_traces():
    t = {"cost": 10.0, "s_per_iter": 0.5, "cost_trace": np.array([50.0, 12.0, 10.0, 10.0])}
    n = {"cost": 11.0, "total_s": 9.0, "cost_trace": np.array([40.0, 11.0, 11.0]),
         "time_trace": np.array([1.0, 2.0, 3.0])}
    assert exp_ba.time_to_cost(t, n) == (1.5, 2.0)


def test_exp_ba_times_the_solvers_on_a_tiny_problem(capsys):
    import json
    assert exp_ba.main(["--sizes", "tiny", "--iters", "3", "--repeat", "1", "--device", "cpu",
                        "--solvers", "lm,pcg"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["size"] == "tiny" and res["device"] == "cpu"
    for s in ("lm", "pcg"):
        assert res[s]["iters"] == 3 and res[s]["cost"] < res[s]["cost0"]
        assert set(res[s]) == {"total_s", "iters", "s_per_iter", "cost0", "cost"}


def test_profile_ba_pieces():
    prob = profile_ba.problem("tiny", "cpu")
    res = profile_ba.profile(prob, "tiny", reps=1)
    assert res["device"] == "cpu" and res["C"] == 16 and res["live_points"] == 300
    keys = {"lm_layout", "lm_solve_20", "lm_per_iter", "lm_normal_blocks", "lm_jacobians",
            "lm_camera_reductions", "lm_point_reductions", "lm_damped_schur_step", "lm_cost",
            "pcg_solve_20", "pcg_per_iter", "pcg_layouts", "pcg_blocks", "pcg_schur_matvec"}
    for lay, widths in (("cam", (12, 144)), ("pt", (3, 9))):
        for W in widths:
            keys |= {f"seg_sum_{lay}_w{W}_kernel", f"seg_sum_{lay}_w{W}_index_add"}
    assert set(res["ms"]) == keys
    for k, v in res["ms"].items():
        if k.endswith("_kernel"):
            assert v == "not measured", k       # the kernel runs only on the card
        else:
            assert v > 0, k
    assert res["busy"] == {"lm_solve_20": "not measured", "pcg_solve_20": "not measured"}


def test_profile_ba_latency_fit(capsys):
    import json
    assert profile_ba_latency.main(["--problem", "tiny", "--iters", "2,4", "--repeats", "1",
                                    "--rs", "2", "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["iterations_run"] == {"2": 2, "4": 4}
    assert set(res["wall_s"]) == {"2", "4"} and res["s_per_iter"] > 0
    assert set(res["launch_latency"]) == {"median_s", "min_s", "max_s"}
    assert set(res["back_to_back"]) == {"2"}
    assert res["device"] == "cpu" and res["observations"] > 0


def test_profile_ba_latency_pcg_solver_runs_its_budget():
    prob = profile_ba.problem("tiny", "cpu")
    res = profile_ba_latency.measure(prob, profile_ba_latency.solver("pcg"), iters=(2,),
                                     repeats=1, rs=())
    assert res["iterations_run"] == {"2": 2} and "s_per_iter" not in res


def test_profile_pcg_path_tiny(capsys):
    """5 rendered views through the PCG-routed path, alone and with
    ``mesh=`` at a world of one (gloo): one end state; a 10-camera street
    problem to the noise floor; the PCG pieces of the ``tiny`` problem."""
    assert profile_pcg_path.main(
        ["--device", "cpu", "--mesh", "--views", "5", "--height", "192", "--width", "256",
         "--street-reps", "1", "--street-cams", "10", "--street-points", "2000",
         "--problems", "tiny", "--reps", "2"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    pcg, mesh = res["path"]["pcg"], res["path"]["mesh"]
    assert pcg["registered"] == mesh["registered"] == 5
    assert pcg["ba_calls"]["pcg"] > 0 and pcg["ba_calls"]["dense"] == 0
    assert mesh["ba_calls"]["distributed"] == pcg["ba_calls"]["pcg"]
    assert mesh["state_sha256"] == pcg["state_sha256"]
    # on the CPU the wrappers run their plain versions: no kernel launches
    assert pcg["launches"] == {"cuda_segsum": 0, "cuda_schur": 0}
    assert res["street"]["rms_px"] <= 1.1 * 0.5 and len(res["street"]["wall_s"]) == 1
    tiny = res["pieces"]["tiny"]
    assert {"pcg_per_iter", "pcg_schur_matvec"} <= set(tiny["ms"])
    for k in ("matvec", "cg_iteration"):
        assert tiny[k]["host_ms"] > 0 and tiny[k]["device_ms"] == "not measured"
    assert tiny["wrapper_host_us"] == {"seg_sum": "not measured", "ytu_sum": "not measured"}
