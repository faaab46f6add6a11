"""Implicit-Schur PCG bundle adjustment of the PyTorch port against the JAX
package, on the CPU; the driver's routing to it; and the CPU BA yardsticks
(``eval/ba_baseline.py``, ``eval/ba_native.py``) against the JAX package's
copies.

Both solvers take the same damped steps in float32, but the per-observation
products and sums round in another order, so PCG's approximate solves
drift apart over the iterations: final costs are held within rtol 1e-3 and
iteration counts within 2 of each other."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reconstructor_tpu.ba import distributed as jdist, lm as jlm
from reconstructor_tpu.eval import ba_baseline as jbase, ba_native as jnative
from reconstructor_tpu_torch.ba import distributed as tdist, lm as tlm
from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.eval import ba_baseline as tbase, ba_native as tnative, synth
from reconstructor_tpu_torch.io import native
from reconstructor_tpu_torch.pipeline import incremental
from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor

import torch_parity  # noqa: F401  (two torch threads per worker)
from test_ba import make_ba_problem

FOUNTAIN = "out/ba_problem_final.npz"


def arrays(prob):
    return {k: np.array(v) for k, v in prob._asdict().items()}


def both(arrs, **kw):
    """The JAX solve (complete before the port starts), then the port's."""
    rj = jdist.solve_pcg(jlm.BAProblem(**{k: jnp.array(v) for k, v in arrs.items()}), **kw)
    jax.block_until_ready(rj)
    rt = tdist.solve_pcg(tlm.BAProblem(**{k: torch.tensor(v) for k, v in arrs.items()}), **kw)
    return rj, rt


@pytest.mark.parametrize("case", ["noisy", "noisy_levenberg", "fountain"])
def test_solve_pcg_equals_jax(case):
    # measured final costs (JAX / port) and LM iterations: noisy 4 x 100
    # problem, 0.5 px noise, marquardt: 62.00412 / 62.00406, 10 / 12;
    # levenberg with Huber 3 px: 62.00426 / 62.00418, 10 / 9; the fountain
    # problem (32 x 16384, 24 live cameras), Huber 3 px, 10 iterations:
    # 2086.244 / 2086.165 (3.8e-5 apart), 10 / 10
    if case == "fountain":
        z = np.load(FOUNTAIN)
        arrs = {k: np.array(z[k]) for k in z.files}
        kw = dict(max_iters=10, huber_delta=3.0, ftol=1e-6)
    else:
        prob, _, _ = make_ba_problem(np.random.default_rng(5), n_cams=4, n_pts=100,
                                     px_noise=0.5)
        arrs = arrays(prob)
        kw = dict(max_iters=30)
        if case == "noisy_levenberg":
            kw.update(huber_delta=3.0, damping="levenberg")
    rj, rt = both(arrs, **kw)
    np.testing.assert_allclose(float(rt.cost_initial), float(rj.cost_initial), rtol=1e-5)
    np.testing.assert_allclose(float(rt.cost_final), float(rj.cost_final), rtol=1e-3)
    assert abs(rt.iterations - int(rj.iterations)) <= 2, (rt.iterations, int(rj.iterations))
    assert float(rt.cost_final) < 0.98 * float(rt.cost_initial)
    assert torch.isfinite(rt.cam_params).all() and torch.isfinite(rt.points).all()


def test_converges_like_dense_schur():
    """tests/test_distributed.py::test_pcg_matches_dense_schur on the port:
    both solvers reach the noise-free problem's floor."""
    prob, _, _ = make_ba_problem(np.random.default_rng(1), n_cams=4, n_pts=100)
    tprob = tlm.BAProblem(**{k: torch.tensor(v) for k, v in arrays(prob).items()})
    dense = tlm.solve(tprob, max_iters=30)
    pcg = tdist.solve_pcg(tprob, max_iters=30, cg_iters=100, cg_tol=1e-8)
    O = tprob.obs_uv.shape[0]
    for r in (dense, pcg):
        assert np.sqrt(2 * float(r.cost_final) / O) < 0.1


def test_gauge_camera_unchanged():
    """tests/test_distributed.py::test_gauge_respected on the port."""
    prob, _, _ = make_ba_problem(np.random.default_rng(3), n_cams=4, n_pts=64)
    arrs = arrays(prob)
    res = tdist.solve_pcg(tlm.BAProblem(**{k: torch.tensor(v) for k, v in arrs.items()}),
                          max_iters=10)
    np.testing.assert_array_equal(res.cam_params[0].numpy(), arrs["cam_params"][0])
    np.testing.assert_array_equal(res.cam_params[1, 3:6].numpy(), arrs["cam_params"][1, 3:6])


def test_pcg_frozen_state_is_the_early_exit():
    """The port's CG runs its budget with the state frozen once converged:
    its x is the JAX early exit's, and every budget past the exit
    iteration gives the same bits."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((48, 48))
    A = (A @ A.T + 48 * np.eye(48)).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    d = np.diag(A).copy()
    At, bt, dt = torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(d)

    def cg(n):
        return tdist._pcg(lambda v: At @ v, bt, lambda r: r / dt, n, 1e-5)
    xt = cg(64)
    xj = jdist._pcg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                    lambda r: r / jnp.asarray(d), 64, 1e-5)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-5)
    exit_at = next(n for n in range(1, 65) if torch.equal(cg(n), xt))
    assert 1 < exit_at < 40
    for n in range(exit_at, 65):
        assert torch.equal(cg(n), xt), n


def test_routing_rule():
    cfg = ReconstructorConfig()
    # 100 cameras x 100,000 points (padded to 112 x 131072) pass the 3e8
    # budget; the 25-view scene's BAs (32 x 4096) do not
    assert incremental.uses_pcg(cfg, 112, 131072)
    assert not incremental.uses_pcg(cfg, 32, 4096)
    assert incremental.uses_pcg(cfg.with_(ba_solver="pcg"), 32, 4096)
    assert incremental.uses_pcg(cfg.with_(ba_dense_w_max_elems=1), 16, 256)


def test_dispatch_over_the_budget(monkeypatch):
    """tests/test_integration.py::TestBASolverDispatch on the port: a
    budget of one element sends every BA through solve_pcg, and the run
    still registers 6/6 with under 1% ATE."""
    calls = []
    real = tdist.solve_pcg

    def counted(prob, **kw):
        calls.append(kw["max_iters"])
        return real(prob, **kw)
    monkeypatch.setattr(tdist, "solve_pcg", counted)
    state, gt_poses, _ = synth.make_synthetic_state(n_views=6, n_points=200, clutter=24, seed=3)
    cfg = ReconstructorConfig(max_keypoints=state.max_keypoints, focal_px=520.0,
                              ba_dense_w_max_elems=1)
    state = IncrementalReconstructor(cfg, verbose=False, device="cpu").reconstruct_from_state(state)
    assert len(state.registered) == 6
    assert len(calls) >= 4 + cfg.final_refinement_rounds
    res = synth.pose_ate(state.poses, gt_poses)
    assert res["ate_rmse_normalized"] < 0.01, res


def _live_problem():
    prob, _, _ = make_ba_problem(np.random.default_rng(0), n_cams=4, n_pts=60, px_noise=0.5)
    a = arrays(prob)
    return a["cam_params"], a["points"], a["obs_cam"], a["obs_pt"], a["obs_uv"], a["cam_free"]


def test_scipy_baseline_equals_jax():
    cams, pts, oc, op, uv, _ = _live_problem()
    rj = jbase.time_scipy_ba(cams, pts, oc, op, uv, max_iters=5)
    rt = tbase.time_scipy_ba(cams, pts, oc, op, uv, max_iters=5)
    for k in ("iters", "cost_initial", "cost_final"):
        assert rt[k] == rj[k], k
    assert rt["cost_final"] < rt["cost_initial"]


def test_native_baseline_equals_jax():
    """The same library through either package's loader gives the same
    solve; where it does not load, the port raises."""
    cams, pts, oc, op, uv, free = _live_problem()
    if not native.available():
        with pytest.raises(RuntimeError):
            tnative.solve_native_ba(cams, pts, oc, op, uv, free, max_iters=5)
        return
    rj = jnative.solve_native_ba(cams, pts, oc, op, uv, free, max_iters=5, num_threads=1)
    rt = tnative.solve_native_ba(cams, pts, oc, op, uv, free, max_iters=5, num_threads=1)
    assert rt["iters"] == rj["iters"]
    assert rt["cost_final"] == rj["cost_final"]
    np.testing.assert_array_equal(rt["cam_params"], rj["cam_params"])
    np.testing.assert_array_equal(rt["points"], rj["points"])
