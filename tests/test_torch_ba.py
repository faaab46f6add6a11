"""Dense-Schur bundle adjustment of the PyTorch port against the JAX
package, on the CPU, on the saved fountain BA problem
(``out/ba_problem_final.npz``: 24 live cameras, 10,715 landmarks, 37,891
observations) and on a small synthetic scene."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reconstructor_tpu.ba import lm as jlm
from reconstructor_tpu_torch.ba import lm as tlm

import torch_parity  # noqa: F401  (sets the worker's torch thread count)

FOUNTAIN = "out/ba_problem_final.npz"


def load(path):
    z = np.load(path)
    return ({k: np.array(z[k]) for k in z.files})


@pytest.fixture(scope="module")
def fountain_solves():
    arrs = load(FOUNTAIN)
    kw = dict(max_iters=10, huber_delta=3.0)
    # each package gets its own copies; the JAX result is complete before
    # the port starts (jnp.asarray may alias numpy memory on the CPU)
    rj = jlm.solve(jlm.BAProblem(**{k: jnp.array(v) for k, v in arrs.items()}), **kw)
    jax.block_until_ready(rj)
    rt = tlm.solve(tlm.BAProblem(**{k: torch.tensor(v) for k, v in arrs.items()}), **kw)
    return rj, rt


def test_fountain_cost_trace(fountain_solves):
    rj, rt = fountain_solves
    # same damped steps in float32: the costs (~2e3, summed over 38k
    # observations) agree to 1e-5 relative at every iteration
    np.testing.assert_allclose(float(rt.cost_initial), float(rj.cost_initial), rtol=1e-5)
    np.testing.assert_allclose(rt.cost_trace.numpy(), np.asarray(rj.cost_trace), rtol=1e-5)
    np.testing.assert_allclose(float(rt.cost_final), float(rj.cost_final), rtol=1e-5)
    assert rt.iterations == int(rj.iterations)
    assert float(rt.cost_final) < 0.99 * float(rt.cost_initial)


def test_fountain_parameters(fountain_solves):
    rj, rt = fountain_solves
    cam_j, cam_t = np.asarray(rj.cam_params), rt.cam_params.numpy()
    # rotations / translations to 1e-4, focal lengths (~600 px) to 1e-2 px
    np.testing.assert_allclose(cam_t[:, :6], cam_j[:, :6], atol=1e-4)
    np.testing.assert_allclose(cam_t[:, 6:8], cam_j[:, 6:8], atol=1e-2)
    np.testing.assert_allclose(cam_t[:, 8:], cam_j[:, 8:], atol=1e-5)
    # landmarks up to ~30 units from the origin: 1e-3
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points), atol=1e-3)


def test_host_layouts_equal():
    arrs = load(FOUNTAIN)
    op, oc, om = arrs["obs_pt"], arrs["obs_cam"], arrs["obs_mask"]
    for a, b in zip(jlm.landmark_major_layout(op, oc, om, 16384),
                    tlm.landmark_major_layout(op, oc, om, 16384)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jlm.coupling_gather_table(op, oc, om, 32, 16384),
                                  tlm.coupling_gather_table(op, oc, om, 32, 16384))
    for c in (2, 9, 10, 25):
        np.testing.assert_array_equal(np.asarray(jlm.make_cam_free_mask(c)),
                                      tlm.make_cam_free_mask(c))
    cj, uj, ucj, nj = jlm.compact_problem(
        jlm.BAProblem(**{k: jnp.asarray(v) for k, v in arrs.items()}))
    ct, ut, uct, nt = tlm.compact_problem(
        tlm.BAProblem(**{k: torch.from_numpy(v) for k, v in arrs.items()}))
    assert nj == nt
    np.testing.assert_array_equal(uj, ut)
    np.testing.assert_array_equal(ucj, uct)
    for f in jlm.BAProblem._fields:
        np.testing.assert_array_equal(np.asarray(getattr(cj, f)), getattr(ct, f).numpy())


def test_synthetic_reconverges_uncompacted():
    """A perturbed 5-camera scene re-converges to sub-0.1 px, on the
    ``compact=False`` entry the incremental reconstructor uses."""
    rng = np.random.default_rng(0)
    n_cams, n_pts = 5, 120
    pts = rng.uniform([-2, -2, 5], [2, 2, 9], (n_pts, 3)).astype(np.float32)
    intr = np.array([600.0, 600.0, 320.0, 240.0, 0.0, 0.0], np.float32)
    cams = np.stack([np.concatenate([[0.05 * i, 0.25 * i - 0.5, 0.02 * i],
                                     [1.2 * i - 2.4, 0.1 * i, 0.05 * i], intr])
                     for i in range(n_cams)]).astype(np.float32)
    cam_t = torch.from_numpy(cams)
    obs_cam = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    obs_pt = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    uv = (tlm._resid(cam_t[obs_cam.astype(np.int64)], torch.from_numpy(pts)[obs_pt.astype(np.int64)],
                     torch.zeros(len(obs_cam), 2))).numpy()
    init = cams.copy()
    init[2:, :6] += rng.normal(0, 0.02, (n_cams - 2, 6)).astype(np.float32)
    prob = tlm.BAProblem(
        cam_params=torch.from_numpy(init),
        points=torch.from_numpy(pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)),
        obs_cam=torch.from_numpy(obs_cam), obs_pt=torch.from_numpy(obs_pt),
        obs_uv=torch.from_numpy(uv), obs_mask=torch.ones(len(obs_cam), dtype=torch.bool),
        cam_free=torch.from_numpy(tlm.make_cam_free_mask(n_cams)))
    res = tlm.solve(prob, max_iters=40, compact=False,
                    host_obs=(obs_pt, obs_cam, np.ones(len(obs_cam), bool)))
    rms = np.sqrt(2 * float(res.cost_final) / len(obs_cam))
    assert rms < 0.1, rms
    # gauge: camera 0 fully fixed, camera 1's translation fixed
    np.testing.assert_array_equal(res.cam_params[0].numpy(), init[0])
    np.testing.assert_array_equal(res.cam_params[1, 3:6].numpy(), init[1, 3:6])
