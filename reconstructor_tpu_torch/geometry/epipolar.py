"""Epipolar geometry: fundamental/essential estimation and pose recovery.

Capability parity with the reference's ``GeometricFilter``
(GeometricFilter.cpp:10-61, backed by OpenCV RANSAC) and
``essentialMatToPose``/``cv::recoverPose``
(SequentialReconstructor.cpp:284-317), as batched fixed-shape tensor code:

- 8-point linear estimation with Hartley normalization as the minimal
  solver, batched over thousands of hypotheses at once (see
  geometry.ransac for the fixed-budget design).
- Sampson distance scoring over all correspondences per hypothesis — one
  (H, N) batched computation.
- Essential-matrix pose recovery testing all four (R, t) decompositions by
  cheirality counting, identical in effect to cv::recoverPose.

Functions with a leading hypothesis axis take ``(H, ...)`` inputs where
``reconstructor_tpu`` vmapped a per-sample function.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from reconstructor_tpu_torch.geometry import camera as cam
from reconstructor_tpu_torch.geometry import se3, ransac, triangulation
from reconstructor_tpu_torch.geometry.linalg import smallest_eigvec, project_rank2


def _hartley_T(c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[[s,0,-s cx],[0,s,-s cy],[0,0,1]] for batched centroid c (..., 2)
    and scale s (...)."""
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    return torch.stack([
        torch.stack([s, z, -s * c[..., 0]], dim=-1),
        torch.stack([z, s, -s * c[..., 1]], dim=-1),
        torch.stack([z, z, o], dim=-1)], dim=-2)


def _normalize_points(pts: torch.Tensor):
    """Hartley normalization: zero centroid, mean distance sqrt(2).

    pts: (..., N, 2). Returns (pts_norm, T (..., 3, 3)) with p_norm = T @ p_h.
    """
    centroid = torch.mean(pts, dim=-2)
    d = torch.linalg.norm(pts - centroid[..., None, :], dim=-1)
    scale = math.sqrt(2.0) / torch.clamp(torch.mean(d, dim=-1), min=1e-12)
    T = _hartley_T(centroid, scale)
    pts_n = (pts - centroid[..., None, :]) * scale[..., None, None]
    return pts_n, T


def _essential_svd_project(M: torch.Tensor) -> torch.Tensor:
    """Project to the essential manifold: singular values (s, s, 0)."""
    U, S, Vt = torch.linalg.svd(M)
    s = (S[..., 0] + S[..., 1]) / 2.0
    Sn = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    return (U * Sn[..., None, :]) @ Vt


def _fro_normalize(M: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(M.reshape(M.shape[:-2] + (9,)), dim=-1)
    return M / torch.clamp(n, min=1e-12)[..., None, None]


def _eight_point(pts1: torch.Tensor, pts2: torch.Tensor,
                 rank2_project: bool, essential: bool) -> torch.Tensor:
    """Linear 8-point solve for F (or E) from (..., S, 2) correspondences.

    Returns (..., 3, 3) M with x2^T M x1 = 0, via the nullspace of the 9x9
    normal matrix.
    """
    p1n, T1 = _normalize_points(pts1)
    p2n, T2 = _normalize_points(pts2)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    ones = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], dim=-1)
    M = smallest_eigvec(A.transpose(-1, -2) @ A).reshape(A.shape[:-2] + (3, 3))
    T2t = T2.transpose(-1, -2)
    if rank2_project and essential:
        M = _essential_svd_project(T2t @ M @ T1)
    elif rank2_project:
        # SVD-free truncation in the *normalized* frame (Hartley's
        # formulation keeps the singular values balanced)
        M = T2t @ project_rank2(M) @ T1
    else:
        M = T2t @ M @ T1
    return _fro_normalize(M)


def sampson_distance(M: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) distance.

    M: (..., 3, 3); pts: (N, 2). Returns (..., N).
    """
    p1 = torch.cat([pts1, torch.ones_like(pts1[:, :1])], dim=-1)
    p2 = torch.cat([pts2, torch.ones_like(pts2[:, :1])], dim=-1)
    Mp1 = p1 @ M.transpose(-1, -2)          # (..., N, 3) = M @ p1
    Mtp2 = p2 @ M                           # (..., N, 3) = M^T @ p2
    e = torch.sum(p2 * Mp1, dim=-1)
    denom = Mp1[..., 0] ** 2 + Mp1[..., 1] ** 2 + Mtp2[..., 0] ** 2 + Mtp2[..., 1] ** 2
    return (e * e) / torch.clamp(denom, min=1e-12)


def estimate_fundamental(pts1: torch.Tensor, pts2: torch.Tensor, mask: torch.Tensor,
                         thresh_px: float = 3.0, num_hypotheses: int = 2048,
                         generator: Optional[torch.Generator] = None,
                         pos: Optional[torch.Tensor] = None):
    """RANSAC fundamental matrix (GeometricFilter.cpp:39-61 equivalent).

    The Sampson distance is compared with thresh_px^2. ``pos``: optional
    (H, 8) raw draws (see geometry.ransac). Returns (F, inlier_mask,
    num_inliers).
    """
    thresh = thresh_px * thresh_px
    solver = lambda p1, p2: _eight_point(p1, p2, rank2_project=True, essential=False)  # noqa: E731
    F, inl, cnt = ransac.ransac(
        (pts1, pts2), mask, solver, sampson_distance, sample_size=8,
        num_hypotheses=num_hypotheses, inlier_thresh=thresh, generator=generator, pos=pos)
    return _refit_if_better(F, inl, cnt, pts1, pts2, mask, thresh, essential=False)


def _refit_if_better(M_best, inl_best, cnt_best, pts1, pts2, mask, thresh,
                     essential: bool):
    """All-inlier least-squares refit, kept only if it scores at least as
    many inliers as the RANSAC-best minimal model (in float32 the refit's
    9x9 nullspace can come out worse than the clean minimal solve)."""
    M_refit = _refit(pts1, pts2, inl_best, essential=essential)
    inl_refit = (sampson_distance(M_refit, pts1, pts2) < thresh) & mask
    cnt_refit = torch.sum(inl_refit)
    better = cnt_refit >= cnt_best
    return (torch.where(better, M_refit, M_best), torch.where(better, inl_refit, inl_best),
            torch.maximum(cnt_refit, cnt_best))


def _refit(pts1, pts2, mask, essential: bool) -> torch.Tensor:
    """Masked least-squares 8-point refit over all inliers, with a
    weighted Hartley normalisation."""
    w = mask.to(pts1.dtype)[:, None]
    wsum = torch.clamp(torch.sum(w), min=1.0)
    c1 = torch.sum(pts1 * w, dim=0) / wsum
    c2 = torch.sum(pts2 * w, dim=0) / wsum
    s1 = math.sqrt(2.0) / torch.clamp(
        torch.sum(torch.linalg.norm(pts1 - c1, dim=-1) * w[:, 0]) / wsum, min=1e-12)
    s2 = math.sqrt(2.0) / torch.clamp(
        torch.sum(torch.linalg.norm(pts2 - c2, dim=-1) * w[:, 0]) / wsum, min=1e-12)
    p1n = (pts1 - c1) * s1
    p2n = (pts2 - c2) * s2
    x1, y1 = p1n[:, 0], p1n[:, 1]
    x2, y2 = p2n[:, 0], p2n[:, 1]
    ones = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], dim=-1) * w
    M = smallest_eigvec(A.T @ A).reshape(3, 3)
    T1 = _hartley_T(c1, s1)
    T2t = _hartley_T(c2, s2).T
    if essential:
        M = _essential_svd_project(T2t @ M @ T1)
    else:
        # rank-2 projection in the normalized frame (see _eight_point)
        M = T2t @ project_rank2(M) @ T1
    return _fro_normalize(M)


def _mean_focal(intr1, intr2):
    return (intr1[cam.FX] + intr1[cam.FY] + intr2[cam.FX] + intr2[cam.FY]) / 4.0


def estimate_essential(uv1: torch.Tensor, uv2: torch.Tensor, intr1: torch.Tensor,
                       intr2: torch.Tensor, mask: torch.Tensor, thresh_px: float = 1.0,
                       num_hypotheses: int = 2048,
                       generator: Optional[torch.Generator] = None,
                       pos: Optional[torch.Tensor] = None):
    """RANSAC essential matrix in normalized camera coordinates
    (GeometricFilter.cpp:10-37 equivalent). The pixel threshold goes to
    the normalized plane by the mean focal length, as OpenCV does.
    ``pos``: optional (H, 8) raw draws. Returns (E, inlier_mask,
    num_inliers)."""
    x1 = cam.unproject(intr1, uv1)[:, :2]
    x2 = cam.unproject(intr2, uv2)[:, :2]
    thresh = (thresh_px / _mean_focal(intr1, intr2)) ** 2
    solver = lambda p1, p2: _eight_point(p1, p2, rank2_project=True, essential=True)  # noqa: E731
    E, inl, cnt = ransac.ransac(
        (x1, x2), mask, solver, sampson_distance, sample_size=8,
        num_hypotheses=num_hypotheses, inlier_thresh=thresh, generator=generator, pos=pos)
    return _refit_if_better(E, inl, cnt, x1, x2, mask, thresh, essential=True)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def two_view_depths(R: torch.Tensor, t: torch.Tensor, x1h: torch.Tensor,
                    x2h: torch.Tensor):
    """Closed-form two-view depths (no SVD): X = z1 x1 in cam1 and
    z2 x2 = R (z1 x1) + t; crossing with x2 eliminates z2:
        z1 = -(x2 x t) . (x2 x R x1) / |x2 x R x1|^2.
    R: (..., 3, 3); t: (..., 3); x1h/x2h: (N, 3). Returns (z1, z2) (..., N).
    """
    Rx1 = x1h @ R.transpose(-1, -2)                       # (..., N, 3)
    c_rx = _cross(x2h, Rx1)
    c_t = _cross(x2h, t[..., None, :])
    z1 = -torch.sum(c_t * c_rx, dim=-1) / torch.clamp(
        torch.sum(c_rx * c_rx, dim=-1), min=1e-12)
    z2 = torch.sum((z1[..., None] * Rx1 + t[..., None, :]) * x2h, dim=-1) / torch.clamp(
        torch.sum(x2h * x2h, dim=-1), min=1e-12)
    return z1, z2


def decompose_essential(E: torch.Tensor):
    """E (..., 3, 3) -> four candidate (R, t) with det(R)=+1, |t|=1."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return (R1, t), (R1, -t), (R2, t), (R2, -t)


def essential_from_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """E = [t]_x R, Frobenius-normalized."""
    return _fro_normalize(se3.hat(t) @ R)


def pose_support(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                 sampson_thresh, mask: Optional[torch.Tensor] = None):
    """Cheirality-aware residual for E-RANSAC scoring, batched over E
    (..., 3, 3).

    Sampson distance alone cannot tell the members of a near-planar
    scene's E family apart, but only the true (R, t) puts (nearly) all
    correspondences in front of both cameras. For each of E's four
    decompositions this computes closed-form depths and returns, for the
    best candidate, the Sampson distance where cheirality holds and +inf
    where it fails. Returns (residual (..., N), best candidate (...)).
    """
    x1h = torch.cat([x1, torch.ones_like(x1[:, :1])], dim=-1)
    x2h = torch.cat([x2, torch.ones_like(x2[:, :1])], dim=-1)
    d = sampson_distance(E, x1, x2)
    res = []
    for R, t in decompose_essential(E):
        z1, z2 = two_view_depths(R, t, x1h, x2h)
        res.append(torch.where((z1 > 0) & (z2 > 0), d, float("inf")))
    res = torch.stack(res, dim=-2)                           # (..., 4, N)
    ok = res < sampson_thresh
    if mask is not None:
        ok = ok & mask
    best = torch.argmax(torch.sum(ok, dim=-1), dim=-1)       # (...)
    out = torch.gather(res, -2, best[..., None, None].expand(
        best.shape + (1, res.shape[-1])))[..., 0, :]
    return out, best


def _four_point_homography(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Minimal DLT homographies from (..., S>=4, 2) correspondences."""
    p1n, T1 = _normalize_points(p1)
    p2n, T2 = _normalize_points(p2)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    ones = torch.ones_like(x1)
    zeros = torch.zeros_like(x1)
    rows_a = torch.stack([-x1, -y1, -ones, zeros, zeros, zeros,
                          x2 * x1, x2 * y1, x2], dim=-1)
    rows_b = torch.stack([zeros, zeros, zeros, -x1, -y1, -ones,
                          y2 * x1, y2 * y1, y2], dim=-1)
    A = torch.cat([rows_a, rows_b], dim=-2)
    H = smallest_eigvec(A.transpose(-1, -2) @ A).reshape(A.shape[:-2] + (3, 3))
    H = torch.linalg.inv(T2) @ H @ T1
    h22 = H[..., 2, 2]
    return H / torch.where(torch.abs(h22) < 1e-12, 1e-12, h22)[..., None, None]


def homography_transfer_error(H: torch.Tensor, p1: torch.Tensor,
                              p2: torch.Tensor) -> torch.Tensor:
    """Squared forward transfer distance |x2 - H x1|^2, (..., N)."""
    p1h = torch.cat([p1, torch.ones_like(p1[:, :1])], dim=-1)
    q = p1h @ H.transpose(-1, -2)
    w = q[..., 2:]
    q = q[..., :2] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return torch.sum((q - p2) ** 2, dim=-1)


def decompose_homography(H: torch.Tensor):
    """Calibrated homography (3, 3) -> 4 (R, unit t) candidates (Faugeras/
    Ma-Soatto Algorithm 5.2). H maps normalized coords cam1 -> cam2 as
    H = R + t n^T / d; candidates differ by the plane-normal sign
    ambiguity. Degenerate (pure-rotation) cases yield repeated candidates.

    A candidate's t depends on the signs of the singular vectors, which
    are the SVD library's choice: the SVD runs on the host (LAPACK, as in
    the JAX package on the CPU) on every device. With cuSOLVER's signs
    the card's candidates for a near-planar initial pair lost the true
    motion that the CPU's held.
    """
    U, lam, Vt = (x.to(H.device) for x in torch.linalg.svd(H.cpu()))
    l2 = torch.clamp(lam[1], min=1e-12)
    Hn = H / l2
    l1 = lam[0] / l2
    l3 = lam[2] / l2
    v1, v2, v3 = Vt[0], Vt[1], Vt[2]
    denom = torch.sqrt(torch.clamp(l1 * l1 - l3 * l3, min=1e-12))
    a = torch.sqrt(torch.clamp(1.0 - l3 * l3, min=0.0))
    b = torch.sqrt(torch.clamp(l1 * l1 - 1.0, min=0.0))
    u1 = (a * v1 + b * v3) / denom
    u2 = (a * v1 - b * v3) / denom

    def solution(Hn, u):
        U1 = torch.stack([v2, u, torch.linalg.cross(v2, u, dim=-1)], dim=1)
        Hv2 = Hn @ v2
        Hu = Hn @ u
        W1 = torch.stack([Hv2, Hu, torch.linalg.cross(Hv2, Hu, dim=-1)], dim=1)
        R = W1 @ U1.T
        n = torch.linalg.cross(v2, u, dim=-1)
        t = (Hn - R) @ n
        return R, t / torch.clamp(torch.linalg.norm(t), min=1e-12)

    return [solution(Hn, u1), solution(Hn, u2),
            solution(-Hn, u1), solution(-Hn, u2)]


def estimate_relative_pose(uv1: torch.Tensor, uv2: torch.Tensor,
                           intr1: torch.Tensor, intr2: torch.Tensor,
                           mask: torch.Tensor, thresh_px: float = 1.0,
                           num_hypotheses: int = 2048, refine_iters: int = 10,
                           generator: Optional[torch.Generator] = None,
                           pos_e: Optional[torch.Tensor] = None,
                           pos_h: Optional[torch.Tensor] = None):
    """Initial-pair relative pose, planar-safe.

    RANSAC over 8-point essential hypotheses scored by *pose support*
    (epipolar fit + cheirality), plus 4-point homography hypotheses for
    the planar-degenerate regime; the best of the 8 decomposed candidates
    is then refined by Gauss-Newton on the essential manifold. Replaces
    cv::findEssentialMat + cv::recoverPose (GeometricFilter.cpp:26,
    SequentialReconstructor.cpp:303).

    ``pos_e`` (H, 8) and ``pos_h`` (H, 4): optional raw draws for the two
    samplers (``reconstructor_tpu`` draws them from the two halves of
    ``jax.random.split(key)``).

    Returns (pose (4,4) world->cam2 with cam1 at identity, E, inlier
    mask, inlier count).
    """
    x1 = cam.unproject(intr1, uv1)[:, :2]
    x2 = cam.unproject(intr2, uv2)[:, :2]
    thresh = (thresh_px / _mean_focal(intr1, intr2)) ** 2

    solver = lambda p1, p2: _eight_point(p1, p2, rank2_project=True, essential=True)
    residual = lambda E, p1, p2: pose_support(E, p1, p2, thresh, mask)[0]
    E, _, _ = ransac.ransac(
        (x1, x2), mask, solver, residual,
        sample_size=8, num_hypotheses=num_hypotheses, inlier_thresh=thresh,
        generator=generator, pos=pos_e)

    H, _, _ = ransac.ransac(
        (x1, x2), mask, _four_point_homography, homography_transfer_error,
        sample_size=4, num_hypotheses=num_hypotheses, inlier_thresh=thresh,
        generator=generator, pos=pos_h)

    cands = list(decompose_essential(E)) + list(decompose_homography(H))
    x1h = torch.cat([x1, torch.ones_like(x1[:, :1])], dim=-1)
    x2h = torch.cat([x2, torch.ones_like(x2[:, :1])], dim=-1)
    Rs = se3.project_to_so3(torch.stack([R for R, _ in cands]))       # (8, 3, 3)
    ts = torch.stack([t for _, t in cands])
    ts = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True), min=1e-12)
    Ec = essential_from_pose(Rs, ts)
    d = sampson_distance(Ec, x1, x2)                                  # (8, N)
    z1, z2 = two_view_depths(Rs, ts, x1h, x2h)
    front = (z1 > 0) & (z2 > 0)
    counts = torch.sum((d < thresh) & front & mask, dim=-1)
    res_all = torch.where(front, d, float("inf"))
    best = torch.argmax(counts)
    pose0 = se3.make_pose(Rs[best], ts[best])
    inl = (res_all[best] < thresh) & mask

    w = inl.to(x1.dtype)
    pose = refine_relative_pose(pose0, x1, x2, w, num_iters=refine_iters)
    E_ref = essential_from_pose(pose[:3, :3], pose[:3, 3])
    res_ref, _ = pose_support(E_ref, x1, x2, thresh, mask)
    inl_ref = (res_ref < thresh) & mask
    better = torch.sum(inl_ref) >= torch.sum(inl)
    E0 = essential_from_pose(pose0[:3, :3], pose0[:3, 3])
    pose = torch.where(better, pose, pose0)
    E_out = torch.where(better, E_ref, E0)
    inl_out = torch.where(better, inl_ref, inl)
    return pose, E_out, inl_out, torch.sum(inl_out)


def refine_relative_pose(pose: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                         weights: torch.Tensor, num_iters: int = 10) -> torch.Tensor:
    """Gauss-Newton refinement of a relative pose on the essential manifold.

    Minimizes the weighted Sampson distance of E(R, t) over inliers,
    parameterized by [angle-axis(3), t(3)] with t renormalized each step
    (5 effective dof). x1, x2: (N, 2) normalized camera coords.
    """
    p = torch.cat([se3.rotation_to_angle_axis(pose[:3, :3]), pose[:3, 3]])

    def residuals(p):
        R = se3.angle_axis_to_rotation(p[:3])
        t = p[3:] / torch.clamp(torch.linalg.norm(p[3:]), min=1e-12)
        E = essential_from_pose(R, t)
        d = sampson_distance(E, x1, x2)
        return torch.sqrt(d + 1e-18) * weights

    eye = torch.eye(6, dtype=p.dtype, device=p.device)
    for _ in range(num_iters):
        r = residuals(p)
        # (0-dim torch.where under forward AD promotes tangents to float64)
        J = torch.func.jacfwd(residuals)(p).to(p.dtype)      # (N, 6)
        H = J.T @ J + 1e-9 * eye
        g = J.T @ r
        p_new = p - torch.linalg.solve(H, g)
        better = torch.sum(residuals(p_new) ** 2) < torch.sum(r ** 2)
        p = torch.where(better, p_new, p)
    R = se3.angle_axis_to_rotation(p[:3])
    t = p[3:] / torch.clamp(torch.linalg.norm(p[3:]), min=1e-12)
    return se3.make_pose(R, t)


def recover_pose(E: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
                 intr1: torch.Tensor, intr2: torch.Tensor,
                 mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cheirality-disambiguated relative pose from E (cv::recoverPose
    equivalent; SequentialReconstructor.cpp:284-317).

    Returns the (4, 4) pose of camera 2 with camera 1 at identity, chosen
    so the most correspondences triangulate in front of both cameras,
    and the four candidates' counts.
    """
    n = uv1.shape[0]
    eye = torch.eye(4, dtype=E.dtype, device=E.device)
    intrs = torch.stack([intr1.expand(n, 6), intr2.expand(n, 6)], dim=1)
    uvs = torch.stack([uv1, uv2], dim=1)
    m = mask[:, None].expand(n, 2)
    counts, poses = [], []
    for R, t in decompose_essential(E):
        pose2 = se3.make_pose(R, t)
        P = torch.stack([eye.expand(n, 4, 4), pose2.expand(n, 4, 4)], dim=1)
        pts = triangulation.triangulate_batch(P, intrs, uvs, m)
        z1 = pts[:, 2]
        z2 = (pts @ R.T + t)[:, 2]
        ok = (z1 > 0) & (z2 > 0) & mask & torch.all(torch.isfinite(pts), dim=-1)
        counts.append(torch.sum(ok))
        poses.append(pose2)
    counts = torch.stack(counts)
    return torch.stack(poses)[torch.argmax(counts)], counts
