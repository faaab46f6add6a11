"""Independent CPU bundle-adjustment baseline (Ceres stand-in).

The reference's BA is Ceres DENSE_SCHUR on 4 CPU threads
(BundleAdjuster.cpp:131-142). Ceres is not available in this image, so
the honest CPU baseline is scipy's sparse trust-region LM
(``least_squares(method='trf', tr_solver='lsmr')``) with an *analytic
sparse Jacobian* over the exact same residual
(BundleAdjuster.h:26-58: angle-axis rotation, additive shared radial
distortion) and the exact same problem instance the TPU solver gets.
This is an established, independently-implemented CPU sparse-BA path —
not our own solver re-timed on CPU — so ``s/iter`` ratios against it
measure solver-vs-solver, not backend-vs-backend.

Timing convention: one "iteration" = one Jacobian evaluation + one
trust-region solve (scipy reports ``njev``), matching Ceres's
iteration = one linearization + one linear solve.

A copy of ``reconstructor_tpu.eval.ba_baseline``: the CPU yardstick for
this package's solvers, independent of torch.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np


def _unpack(x: np.ndarray, C: int, L: int) -> Tuple[np.ndarray, np.ndarray]:
    cams = x[: C * 12].reshape(C, 12)
    pts = x[C * 12:].reshape(L, 3)
    return cams, pts


def _rotate_aa(aa: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Angle-axis rotation (ceres::AngleAxisRotatePoint), batched numpy."""
    theta2 = np.sum(aa * aa, axis=-1, keepdims=True)
    theta = np.sqrt(theta2 + 1e-12)
    w = aa / theta
    cos_t = np.cos(theta)
    sin_t = np.sin(theta)
    w_cross_p = np.cross(w, pts)
    w_dot_p = np.sum(w * pts, axis=-1, keepdims=True)
    rot = pts * cos_t + w_cross_p * sin_t + w * w_dot_p * (1.0 - cos_t)
    small = theta2 < 1e-12
    return np.where(small, pts + np.cross(aa, pts), rot)


def _residuals(x, C, L, obs_cam, obs_pt, obs_uv):
    cams, pts = _unpack(x, C, L)
    cam = cams[obs_cam]
    p = _rotate_aa(cam[:, :3], pts[obs_pt]) + cam[:, 3:6]
    z = np.where(np.abs(p[:, 2]) < 1e-8, 1e-8, p[:, 2])
    xn = p[:, 0] / z
    yn = p[:, 1] / z
    r = xn * xn + yn * yn
    d = cam[:, 10] * r + cam[:, 11] * r * r
    u = cam[:, 6] * (xn + d) + cam[:, 8]
    v = cam[:, 7] * (yn + d) + cam[:, 9]
    return np.concatenate([u - obs_uv[:, 0], v - obs_uv[:, 1]])


def _jac_sparsity(C, L, obs_cam, obs_pt):
    from scipy.sparse import lil_matrix
    O = obs_cam.size
    A = lil_matrix((2 * O, C * 12 + L * 3), dtype=np.int8)
    for k in range(12):
        A[np.arange(O), obs_cam * 12 + k] = 1
        A[np.arange(O) + O, obs_cam * 12 + k] = 1
    for k in range(3):
        A[np.arange(O), C * 12 + obs_pt * 3 + k] = 1
        A[np.arange(O) + O, C * 12 + obs_pt * 3 + k] = 1
    return A


def time_scipy_ba(cam_params: np.ndarray, points: np.ndarray,
                  obs_cam: np.ndarray, obs_pt: np.ndarray,
                  obs_uv: np.ndarray, max_iters: int = 20) -> dict:
    """Run the scipy sparse LM baseline on a (dense-packed) BA problem.

    Inputs are the *live* part of a BAProblem (no padding): cam_params
    (C, 12), points (L, 3), observations as int arrays + uv. Returns
    timing + convergence stats.
    """
    from scipy.optimize import least_squares

    C, L = cam_params.shape[0], points.shape[0]
    x0 = np.concatenate([cam_params.reshape(-1), points.reshape(-1)]).astype(np.float64)
    args = (C, L, obs_cam.astype(np.int64), obs_pt.astype(np.int64),
            obs_uv.astype(np.float64))

    spars = _jac_sparsity(C, L, args[2], args[3])
    t0 = time.time()
    res = least_squares(
        _residuals, x0, args=args, jac_sparsity=spars,
        method="trf", tr_solver="lsmr", x_scale="jac",
        max_nfev=max_iters, verbose=0)
    dt = time.time() - t0
    iters = max(int(res.njev), 1)
    return {
        "total_s": dt,
        "iters": iters,
        "s_per_iter": dt / iters,
        "cost_initial": float(0.5 * np.sum(_residuals(x0, *args) ** 2)),
        "cost_final": float(res.cost),
    }
