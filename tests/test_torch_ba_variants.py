"""The dense LM's precision options (``block_dtype``, ``schur_precision``)
against the JAX package's ``lm.solve`` on the CPU, the Schur products
on the CPU, and ``scripts/check_ba_variants.py`` at a small size.

The problem is ``tests/test_ba.py``'s compaction case (5 cameras, 60
points, every 7th observation masked, a padding camera and 13 padding
landmarks holding sentinels) with 0.5 px of noise, so that the solves end
on a noise floor rather than at zero.

Tolerances. Run to convergence, every variant's final cost agrees with
the JAX package's within 1e-4 relative: the LM stops where ``ftol`` says,
and near the floor the iteration at which it does moves with the last
bits, so the counts are compared with ``ftol=0`` instead (both run the
whole budget). Over its first 5 iterations the float32 and ``hcc16``
cost traces agree within 1e-4 relative. A bfloat16 coupling
(``bfloat16``, ``w16``) makes the reduced camera system cancel into its
rounding: the step then moves by ~10% with float32 accumulation order
alone (the packages' Schur complements agree within 1e-7 of their scale,
their Cholesky steps do not), so those trajectories are held only at
convergence: states within 2e-3 (cameras) and 1e-2 (points), as the
float32 ones are.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconstructor_tpu.ba import lm as jlm
from reconstructor_tpu_torch.ba import lm as tlm
from reconstructor_tpu_torch.scripts import check_ba_variants

from torch_parity import time_limit  # (also: two torch threads per worker)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_ba import make_ba_problem  # noqa: E402

ITERS = 50
VARIANTS = ([(bd, compact, "high") for bd in ("float32", "bfloat16", "w16", "hcc16")
             for compact in (True, False)]
            + [("float32", True, "highest"), ("float32", True, "default")])


@pytest.fixture(scope="module")
def arrays():
    prob, _, _ = make_ba_problem(np.random.default_rng(11), n_cams=5, n_pts=60, px_noise=0.5)
    om = np.asarray(prob.obs_mask).copy()
    om[::7] = False
    C, L = prob.cam_params.shape[0] + 1, prob.points.shape[0] + 13
    cam = np.zeros((C, 12), np.float32)
    cam[:-1] = np.asarray(prob.cam_params)
    cam[-1] = 123.0
    pts = np.zeros((L, 3), np.float32)
    pts[:-13] = np.asarray(prob.points)
    pts[-1] = 77.0
    free = np.zeros((C, 12), np.float32)
    free[:-1] = np.asarray(prob.cam_free)
    return dict(cam_params=cam, points=pts, obs_cam=np.asarray(prob.obs_cam),
                obs_pt=np.asarray(prob.obs_pt), obs_uv=np.asarray(prob.obs_uv), obs_mask=om,
                cam_free=free)


def solve_both(arrays, **kw):
    rj = jlm.solve(jlm.BAProblem(**{k: jnp.array(v) for k, v in arrays.items()}), **kw)
    jax.block_until_ready(rj)
    rt = tlm.solve(tlm.BAProblem(**{k: torch.tensor(v) for k, v in arrays.items()}), **kw)
    return rj, rt


@time_limit(60)
@pytest.mark.parametrize("block_dtype,compact,precision", VARIANTS)
def test_variant_matches_jax(arrays, block_dtype, compact, precision):
    kw = dict(max_iters=ITERS, compact=compact, block_dtype=block_dtype,
              schur_precision=precision)
    # no early exit: both run the whole budget
    rj, rt = solve_both(arrays, ftol=0.0, **kw)
    assert rt.iterations == int(rj.iterations) == ITERS
    np.testing.assert_allclose(float(rt.cost_initial), float(rj.cost_initial), rtol=1e-6)
    if block_dtype in ("float32", "hcc16"):
        np.testing.assert_allclose(rt.cost_trace.numpy()[:5], np.asarray(rj.cost_trace)[:5],
                                   rtol=1e-4)
    # to convergence
    rj, rt = solve_both(arrays, **kw)
    cj, ct = float(rj.cost_final), float(rt.cost_final)
    np.testing.assert_allclose(ct, cj, rtol=1e-4)
    assert ct < float(rt.cost_initial) / 1000
    cam_j, cam_t = np.asarray(rj.cam_params), rt.cam_params.numpy()
    np.testing.assert_allclose(cam_t[:, :6], cam_j[:, :6], atol=2e-3)
    np.testing.assert_array_equal(cam_t[:, 6:], cam_j[:, 6:])     # intrinsics frozen (< 10)
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points), atol=1e-2)
    # dead landmarks and the padding camera pass through untouched
    np.testing.assert_array_equal(rt.points.numpy()[-13:], arrays["points"][-13:])
    np.testing.assert_array_equal(cam_t[-1], arrays["cam_params"][-1])


def test_bf16_storage_rounds_as_the_jax_package(arrays):
    """With ``w16`` the coupling W is bfloat16 and holds the float32
    coupling's values rounded once; with ``hcc16`` H_cc is the float32 sum
    of rounded blocks; H_pp and g_p stay float32 and equal."""
    prob = tlm.BAProblem(**{k: torch.tensor(v) for k, v in arrays.items()})
    lay = tlm._layout(prob)
    long = prob._replace(obs_cam=prob.obs_cam.long(), obs_pt=prob.obs_pt.long())
    f32 = tlm._normal_blocks(long, lay, prob.cam_params, prob.points, 0.0)
    w16 = tlm._normal_blocks(long, lay, prob.cam_params, prob.points, 0.0, "w16")
    hcc = tlm._normal_blocks(long, lay, prob.cam_params, prob.points, 0.0, "hcc16")
    assert f32[4].dtype == torch.float32 and w16[4].dtype == torch.bfloat16
    assert torch.equal(w16[4], f32[4].to(torch.bfloat16))
    for i in (0, 1, 3):
        assert torch.equal(w16[i], f32[i]) and torch.equal(hcc[i], f32[i])
    assert torch.equal(w16[2], f32[2]) and hcc[4].dtype == torch.float32
    rel = (hcc[2] - f32[2]).abs().max() / f32[2].abs().max()
    assert 0 < rel < 2 ** -8


def test_unknown_values_fail_or_fall_back_as_in_jax(arrays):
    """An unknown ``schur_precision`` raises ValueError in both packages;
    an unknown ``block_dtype`` is float32 in both."""
    for solve, P, asarray in ((jlm.solve, jlm.BAProblem, jnp.array),
                              (tlm.solve, tlm.BAProblem, torch.tensor)):
        prob = P(**{k: asarray(v) for k, v in arrays.items()})
        with pytest.raises(ValueError):
            solve(prob, max_iters=2, schur_precision="bf16x6")
    rj, rt = solve_both(arrays, max_iters=ITERS, block_dtype="float16")
    _, rt32 = solve_both(arrays, max_iters=ITERS)
    assert torch.equal(rt.cost_trace, rt32.cost_trace)
    np.testing.assert_allclose(float(rt.cost_final), float(rj.cost_final), rtol=1e-4)


@pytest.mark.parametrize("precision", tlm.SCHUR_PRECISIONS)
def test_schur_mm_on_the_cpu(precision):
    """On the CPU every precision is the plain float32 product, as XLA:CPU
    computes it; bfloat16 operands (a bf16 ``block_dtype``) are multiplied
    in float32, exactly, and accumulate there; an unknown precision raises."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 300, generator=g) * torch.logspace(-3, 3, 300)
    b = torch.randn(300, 48, generator=g)
    assert torch.equal(tlm.schur_mm(a, b, precision), a @ b)
    assert torch.equal(tlm.schur_mm(a, b[:, 0], precision), a @ b[:, 0])
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    got = tlm.schur_mm(a16, b16, precision)
    assert got.dtype == torch.float32
    assert torch.equal(got, a16.float() @ b16.float())
    with pytest.raises(ValueError):
        tlm.schur_mm(a, b, precision + "x3")


@time_limit(60)
def test_check_ba_variants_script(capsys):
    import json
    assert check_ba_variants.main(["--problems", "tiny", "--reps", "1", "--max-iters", "4",
                                   "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["device"] == "cpu" and len(res["problems"]) == 1
    p = res["problems"][0]
    assert list(p["rows"]) == [tag for tag, _ in check_ba_variants.ROWS]
    for tag, r in p["rows"].items():
        assert r["iterations"] == 4 and r["cost_final"] <= r["cost_initial"]
        assert r["total_ms"] > 0 and r["ms_per_iter"] > 0
        assert r["schur_precision"] == dict(check_ba_variants.ROWS)[tag].get(
            "schur_precision", "high")
    assert p["rows"]["f32 compact"]["cost_final"] < p["rows"]["f32 compact"]["cost_initial"]
    # on the CPU 'high' and 'highest' are the same product
    assert p["high_vs_highest_rel"] == 0.0
