"""Grunert P3P: minimal 3-point absolute pose, batched for RANSAC.

P3P needs three clean correspondences where the 6-point DLT needs six:
at a 30% inlier ratio that is ~55 clean hypotheses of a 2048 budget
instead of ~1-2 (cv::solvePnPRansac's default minimal solver is P3P too).

Per sample, branch-free and batched over the leading axis:
1. Grunert's reduction (Haralick et al., "Review and Analysis of
   Solutions of the Three Point Perspective Pose Estimation Problem") to
   a quartic in the distance ratio v = s3/s1.
2. Quartic roots via fixed-iteration Durand-Kerner in split complex
   arithmetic (finds all 4 roots at once, no data-dependent control).
3. Each admissible real root -> camera-frame point distances -> absolute
   orientation from 3 point pairs by orthonormal-frame alignment.

Returns 4 candidate poses per sample (inadmissible roots yield NaN poses
that score zero inliers downstream).
"""

from __future__ import annotations

import torch

from reconstructor_tpu_torch.geometry import se3


def _dk_quartic_roots(coeffs: torch.Tensor, iters: int = 40):
    """All 4 roots of A4 x^4 + ... + A0 via Durand-Kerner.

    coeffs: (..., 5) [A4, A3, A2, A1, A0]. Returns (re (..., 4), im (..., 4)).
    """
    A4 = coeffs[..., 0]
    scale = torch.where(torch.abs(A4) < 1e-12, torch.sign(A4) * 1e-12 + 1e-12, A4)
    c = coeffs / scale[..., None]
    c1, c2, c3, c4 = (c[..., k, None] for k in range(1, 5))

    def poly(re, im):
        pr, pi = torch.ones_like(re), torch.zeros_like(re)
        for coef in (c1, c2, c3, c4):
            pr, pi = pr * re - pi * im + coef, pr * im + pi * re
        return pr, pi

    # standard D-K seeds: powers of 0.4 + 0.9i (float32 arithmetic, as in
    # the reference implementation)
    sr = torch.tensor(0.4, dtype=coeffs.dtype)
    si = torch.tensor(0.9, dtype=coeffs.dtype)
    re0 = torch.stack([sr, sr * sr - si * si,
                       sr * (sr * sr - 3 * si * si),
                       (sr * sr - si * si) ** 2 - (2 * sr * si) ** 2])
    im0 = torch.stack([si, 2 * sr * si,
                       si * (3 * sr * sr - si * si),
                       2.0 * (sr * sr - si * si) * (2.0 * sr * si)])
    shape = coeffs.shape[:-1] + (4,)
    re = re0.to(coeffs.device).expand(shape).clone()
    im = im0.to(coeffs.device).expand(shape).clone()
    offdiag = ~torch.eye(4, dtype=torch.bool, device=coeffs.device)

    for _ in range(iters):
        pr, pi = poly(re, im)
        dr = re[..., :, None] - re[..., None, :]
        di = im[..., :, None] - im[..., None, :]
        prod_r = torch.ones_like(re)
        prod_i = torch.zeros_like(im)
        for j in range(4):
            take = offdiag[:, j]
            nr = prod_r * dr[..., j] - prod_i * di[..., j]
            ni = prod_r * di[..., j] + prod_i * dr[..., j]
            prod_r = torch.where(take, nr, prod_r)
            prod_i = torch.where(take, ni, prod_i)
        denom = prod_r * prod_r + prod_i * prod_i
        denom = torch.where(denom < 1e-20, 1e-20, denom)
        qr = (pr * prod_r + pi * prod_i) / denom
        qi = (pi * prod_r - pr * prod_i) / denom
        re, im = re - qr, im - qi
    return re, im


def _frame(p: torch.Tensor) -> torch.Tensor:
    """Orthonormal triangle frame (columns) of 3 points p (..., 3, 3)."""
    e1 = p[..., 1, :] - p[..., 0, :]
    e1 = e1 / torch.clamp(torch.linalg.norm(e1, dim=-1, keepdim=True), min=1e-12)
    n = torch.linalg.cross(e1, p[..., 2, :] - p[..., 0, :], dim=-1)
    e3 = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    e2 = torch.linalg.cross(e3, e1, dim=-1)
    return torch.stack([e1, e2, e3], dim=-1)


def _align_three_points(pw: torch.Tensor, pc: torch.Tensor):
    """Rigid transform from 3 world points to 3 camera points:
    R = F_cam @ F_world^T, t = c_cam - R c_world. pw, pc: (..., 3, 3)."""
    R = _frame(pc) @ _frame(pw).transpose(-1, -2)
    t = torch.mean(pc, dim=-2) - (R @ torch.mean(pw, dim=-2)[..., None])[..., 0]
    return R, t


def p3p_grunert(pts3d: torch.Tensor, bearings: torch.Tensor) -> torch.Tensor:
    """Solve P3P for a batch of samples.

    pts3d: (..., 3, 3) world points; bearings: (..., 3, 3) unit rays in the
    camera frame. Returns (..., 4, 4, 4) candidate world->camera poses
    (NaN-filled for inadmissible roots).
    """
    P1, P2, P3 = pts3d[..., 0, :], pts3d[..., 1, :], pts3d[..., 2, :]
    j1, j2, j3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]

    a2 = torch.sum((P2 - P3) ** 2, dim=-1)
    b2 = torch.sum((P1 - P3) ** 2, dim=-1)
    c2 = torch.sum((P1 - P2) ** 2, dim=-1)
    b2 = torch.clamp(b2, min=1e-12)

    cos_a = torch.sum(j2 * j3, dim=-1)
    cos_b = torch.sum(j1 * j3, dim=-1)
    cos_g = torch.sum(j1 * j2, dim=-1)

    A = (a2 - c2) / b2
    B = (a2 + c2) / b2
    C = (b2 - c2) / b2
    D = (b2 - a2) / b2

    A4 = (A - 1.0) ** 2 - 4.0 * (c2 / b2) * cos_a ** 2
    A3 = 4.0 * (A * (1.0 - A) * cos_b
                - (1.0 - B) * cos_a * cos_g
                + 2.0 * (c2 / b2) * cos_a ** 2 * cos_b)
    A2 = 2.0 * (A ** 2 - 1.0
                + 2.0 * A ** 2 * cos_b ** 2
                + 2.0 * C * cos_a ** 2
                - 4.0 * B * cos_a * cos_b * cos_g
                + 2.0 * D * cos_g ** 2)
    A1 = 4.0 * (-A * (1.0 + A) * cos_b
                + 2.0 * (a2 / b2) * cos_g ** 2 * cos_b
                - (1.0 - B) * cos_a * cos_g)
    A0 = (1.0 + A) ** 2 - 4.0 * (a2 / b2) * cos_g ** 2

    re, im = _dk_quartic_roots(torch.stack([A4, A3, A2, A1, A0], dim=-1))
    real_ok = torch.abs(im) < 1e-4 * (1.0 + torch.abs(re))
    v = re                                              # (..., 4)
    ca, cb, cg = cos_a[..., None], cos_b[..., None], cos_g[..., None]
    Ae, b2e = A[..., None], b2[..., None]

    denom_u = 2.0 * (cg - v * ca)
    denom_u = torch.where(torch.abs(denom_u) < 1e-12, 1e-12, denom_u)
    u = ((-1.0 + Ae) * v ** 2 - 2.0 * Ae * cb * v + 1.0 + Ae) / denom_u

    s1_sq = b2e / torch.clamp(1.0 + v ** 2 - 2.0 * v * cb, min=1e-12)
    admissible = real_ok & (s1_sq > 0) & (v > 0) & (u > 0)
    s1 = torch.sqrt(torch.clamp(s1_sq, min=1e-12))
    s2 = u * s1
    s3 = v * s1

    # camera-frame points per root: (..., 4, 3, 3)
    pc = torch.stack([s1[..., None] * j1[..., None, :],
                      s2[..., None] * j2[..., None, :],
                      s3[..., None] * j3[..., None, :]], dim=-2)
    pw = pts3d[..., None, :, :].expand(pc.shape)
    R, t = _align_three_points(pw, pc)
    T = se3.make_pose(R, t)
    return torch.where(admissible[..., None, None], T, float("nan"))
