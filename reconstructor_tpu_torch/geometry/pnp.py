"""Perspective-n-Point registration: batched P3P or DLT hypotheses + RANSAC + GN.

Replaces ``cv::solvePnPRansac`` (SequentialReconstructor.cpp:591-597:
10,000 adaptive iterations, 4.0 px reprojection threshold, 0.99
confidence):

- minimal solver: Grunert P3P (the default), or the 6-point linear DLT
  in normalized camera coordinates orthogonalized to SO(3) by SVD,
  batched over the whole hypothesis set;
- scoring: one (H, N) reprojection-error evaluation;
- refinement: fixed-iteration Gauss-Newton on the 6-dof pose over all
  inliers (the polish OpenCV applies after RANSAC).
"""

from __future__ import annotations

from typing import Optional

import torch

from reconstructor_tpu_torch.geometry import camera as cam
from reconstructor_tpu_torch.geometry import p3p as p3p_mod
from reconstructor_tpu_torch.geometry import se3, ransac
from reconstructor_tpu_torch.geometry.linalg import smallest_eigvec


def _pnp_dlt(pts3d: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Linear PnP from S >= 6 correspondences, batched.

    pts3d: (..., S, 3) world points; xy: (..., S, 2) normalized image-plane
    coords. Returns (..., 4, 4) world->camera poses with R projected to
    SO(3) and the sign that puts most points in front of the camera.
    """
    X = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], dim=-1)       # (..., S, 4)
    zeros = torch.zeros_like(X)
    x, y = xy[..., 0:1], xy[..., 1:2]
    rows_u = torch.cat([X, zeros, -x * X], dim=-1)                         # (..., S, 12)
    rows_v = torch.cat([zeros, X, -y * X], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)                                # (..., 2S, 12)
    P = smallest_eigvec(A.transpose(-1, -2) @ A).reshape(A.shape[:-2] + (3, 4))

    # resolve the global sign: points must land in front of the camera
    depths = torch.sum(X * P[..., None, 2, :], dim=-1)                    # (..., S)
    P = P * torch.sign(torch.sum(torch.sign(depths), dim=-1) + 0.5)[..., None, None]

    U, sv, Vt = torch.linalg.svd(P[..., :3])
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (U * D[..., None, :]) @ Vt
    scale = (sv[..., 0] + sv[..., 1] + det * sv[..., 2]) / 3.0
    t = P[..., 3] / torch.where(torch.abs(scale) < 1e-12, 1e-12, scale)[..., None]
    return se3.make_pose(R, t)


def _reproj_residual_sq(pose: torch.Tensor, pts3d: torch.Tensor, uv: torch.Tensor,
                        intr: torch.Tensor) -> torch.Tensor:
    """Squared L2 pixel reprojection error per correspondence (OpenCV's
    solvePnPRansac inlier metric); +inf behind the camera.
    pose: (..., 4, 4); pts3d (N, 3); uv (N, 2). Returns (..., N)."""
    pts_cam = pts3d @ pose[..., :3, :3].transpose(-1, -2) + pose[..., None, :3, 3]
    proj = cam.project(intr, pts_cam)
    err = torch.sum((proj - uv) ** 2, dim=-1)
    return torch.where(pts_cam[..., 2] > 0, err, float("inf"))


def _gauss_newton_refine(pose: torch.Tensor, pts3d: torch.Tensor, uv: torch.Tensor,
                         intr: torch.Tensor, weights: torch.Tensor,
                         num_iters: int) -> torch.Tensor:
    """Fixed-iteration damped GN on the 6-dof [angle-axis, t] pose."""
    p = se3.pose_to_params(pose)

    def residuals(p):
        pc = se3.rotate_points_aa(p[:3].expand(pts3d.shape), pts3d) + p[3:6]
        proj = cam.project(intr, pc)
        return ((proj - uv) * weights[:, None]).reshape(-1)

    eye = torch.eye(6, dtype=p.dtype, device=p.device)
    for _ in range(num_iters):
        r = residuals(p)
        J = torch.func.jacfwd(residuals)(p).to(p.dtype)      # (2N, 6)
        H = J.T @ J + 1e-6 * eye
        g = J.T @ r
        p_new = p - torch.linalg.solve(H, g)
        better = torch.sum(residuals(p_new) ** 2) < torch.sum(r ** 2)
        p = torch.where(better, p_new, p)
    return se3.params_to_pose(p)


def solve_pnp_ransac(pts3d: torch.Tensor, uv: torch.Tensor,
                     intr: torch.Tensor, mask: torch.Tensor,
                     thresh_px: float = 4.0, num_hypotheses: int = 2048,
                     refine_iters: int = 10,
                     generator: Optional[torch.Generator] = None,
                     pos: Optional[torch.Tensor] = None, minimal: str = "p3p"):
    """Full PnP RANSAC + polish.

    ``minimal='p3p'`` (default) samples 3-point Grunert hypotheses — up to
    4 candidate poses each, all scored; at low inlier ratios that is the
    difference between w^3 and w^6 clean samples, and it is
    cv::solvePnPRansac's default minimal solver. ``minimal='dlt6'`` takes
    the linear 6-point path. ``pos``: optional (H, 3) or (H, 6) raw draws
    (see geometry.ransac).

    Returns (pose (4,4), inlier_mask (N,), num_inliers).
    """
    thr = thresh_px * thresh_px
    if minimal == "p3p":
        bearings_all = cam.unproject(intr, uv)
        bearings_all = bearings_all / torch.clamp(
            torch.linalg.norm(bearings_all, dim=-1, keepdim=True), min=1e-12)
        idx = ransac.sample_minimal_sets(mask, num_hypotheses, 3, generator, pos)
        poses4 = p3p_mod.p3p_grunert(pts3d[idx], bearings_all[idx])     # (H, 4, 4, 4)
        models = poses4.reshape(-1, 4, 4)
        res = _reproj_residual_sq(models, pts3d, uv, intr)
        res = torch.where(torch.isnan(res), float("inf"), res)
        inliers = (res < thr) & mask[None, :]
        best = torch.argmax(torch.sum(inliers, dim=-1))
        pose = models[best]
        pose = torch.where(torch.any(torch.isnan(pose)),
                           torch.eye(4, dtype=pose.dtype, device=pose.device), pose)
        inl = inliers[best]
    elif minimal == "dlt6":
        xy = cam.unproject(intr, uv)[:, :2]
        solver = lambda p3, p2, u: _pnp_dlt(p3, p2)                          # noqa: E731
        residual = lambda pose, p3, p2, u: _reproj_residual_sq(pose, p3, u, intr)  # noqa: E731
        pose, inl, _ = ransac.ransac(
            (pts3d, xy, uv), mask, solver, residual, sample_size=6,
            num_hypotheses=num_hypotheses, inlier_thresh=thr, generator=generator, pos=pos)
    else:
        raise ValueError(f"minimal must be 'p3p' or 'dlt6', got {minimal!r}")

    w = inl.to(pts3d.dtype)
    pose = _gauss_newton_refine(pose, pts3d, uv, intr, w, refine_iters)
    err = _reproj_residual_sq(pose, pts3d, uv, intr)
    inl = (err < thr) & mask
    return pose, inl, torch.sum(inl)
