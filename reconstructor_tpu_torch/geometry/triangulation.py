"""Batched multi-view DLT triangulation.

Capability parity with ``SequentialReconstructor::triangulateMultiView``
(SequentialReconstructor.cpp:396-490): the DLT nullspace comes from the
4x4 normal matrix ``A^T A`` via a batched ``eigh`` over every candidate
landmark at once, with variable observation counts handled by masking
rows out of the accumulation so every landmark has the same static shape.

Acceptance tests mirror the reference exactly: positive depth of the DLT
solution (cpp:427), per-view L1 reprojection error <= max_projection_error
(cpp:437-452) and *all* pairwise triangulation angles >= the minimum
(cpp:455-477).
"""

from __future__ import annotations

import torch

from reconstructor_tpu_torch.geometry import camera as cam
from reconstructor_tpu_torch.geometry import se3

# Matches the reference's hand-typed pi (SequentialReconstructor.cpp:833).
_REF_PI = 3.1415
EIGH_BATCH = 16384       # matrices per eigh call (see triangulate_batch)


def dlt_rows(pose: torch.Tensor, intr: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Two DLT rows per observation: x*P3 - P1 and y*P3 - P2 with P the
    3x4 extrinsics and (x, y) the unprojected feature coordinates
    (SequentialReconstructor.cpp:403-421).

    ``pose``: (..., 4, 4); ``intr``: (..., 6); ``uv``: (..., 2) -> (..., 2, 4).
    """
    P = pose[..., :3, :4]
    xy1 = cam.unproject(intr, uv[..., None, :])[..., 0, :]
    r0 = xy1[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    r1 = xy1[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    return torch.stack([r0, r1], dim=-2)


def triangulate_batch(poses: torch.Tensor, intrs: torch.Tensor, uvs: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """DLT-triangulate N points from up to V observations each.

    poses (N, V, 4, 4), intrs (N, V, 6), uvs (N, V, 2), mask (N, V) bool.
    Returns homogeneous-normalized world points (N, 3).
    """
    rows = dlt_rows(poses, intrs, uvs) * mask[..., None, None]   # (N, V, 2, 4)
    A = rows.reshape(rows.shape[0], -1, 4)
    AtA = A.transpose(-1, -2) @ A
    # eigh raises on non-finite input where the JAX reference returns NaN:
    # solve a zero matrix there and hand back NaN points (gated invalid).
    bad = ~torch.isfinite(AtA).reshape(AtA.shape[0], -1).all(dim=-1)
    AtA = torch.where(bad[:, None, None], 0.0, AtA)
    # cuSOLVER's batched eigensolver behind eigh on a card rejects large
    # batches (CUSOLVER_STATUS_INVALID_VALUE on the 38,444 landmarks of a
    # 70-view scene's retriangulation): solve them in slices
    vecs = torch.cat([torch.linalg.eigh(m)[1] for m in torch.split(AtA, EIGH_BATCH)])
    h = vecs[..., :, 0]
    w = h[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, torch.sign(w) * 1e-12 + 1e-12, w)
    pts = h[..., :3] / w[..., None]
    return torch.where(bad[:, None], float("nan"), pts)


def triangulate(poses: torch.Tensor, intrs: torch.Tensor, uvs: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """DLT-triangulate one point from up to V observations: poses (V, 4,
    4), intrs (V, 6), uvs (V, 2), mask (V,) bool -> world point (3,)."""
    return triangulate_batch(poses[None], intrs[None], uvs[None], mask[None])[0]


def triangulation_angles_deg(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Pairwise ray angles (degrees) between observing cameras.

    ``points``: (N, 3); ``centers``: (N, V, 3). Returns (N, V, V), using
    the reference's pi = 3.1415 (SequentialReconstructor.cpp:833).
    """
    rays = points[:, None, :] - centers
    norms = torch.linalg.norm(rays, dim=-1)
    dots = torch.einsum("nvc,nwc->nvw", rays, rays)
    cos = dots / torch.clamp(norms[:, :, None] * norms[:, None, :], min=1e-12)
    ang = torch.arccos(torch.clamp(cos, -1.0, 1.0))
    return 180.0 * ang / _REF_PI


def triangulate_and_validate(poses: torch.Tensor, intrs: torch.Tensor,
                             uvs: torch.Tensor, mask: torch.Tensor,
                             max_projection_error: float,
                             min_triangulation_angle: float):
    """Batched triangulation + the reference's creation-time acceptance.

    Returns ``(points (N,3), valid (N,))`` where ``valid`` requires a
    finite, positive world-z DLT solution (cpp:427), every masked
    observation within the L1 gate and every observation pair at least
    the minimum angle apart.
    """
    points = triangulate_batch(poses, intrs, uvs, mask)

    pts_cam = torch.einsum("nvij,nj->nvi", poses[..., :3, :3], points) + poses[..., :3, 3]
    err = cam.reprojection_error_l1(intrs, pts_cam[..., None, :], uvs[..., None, :])[..., 0]
    err_ok = torch.all(torch.where(mask, err <= max_projection_error, True), dim=-1)

    centers = se3.camera_center(poses)
    ang = triangulation_angles_deg(points, centers)
    V = mask.shape[-1]
    pair_mask = mask[:, :, None] & mask[:, None, :]
    pair_mask = pair_mask & ~torch.eye(V, dtype=torch.bool, device=mask.device)[None]
    ang_ok = torch.all(torch.where(pair_mask, ang >= min_triangulation_angle, True)
                       .reshape(ang.shape[0], -1), dim=-1)

    finite = torch.all(torch.isfinite(points), dim=-1)
    depth_ok = points[:, 2] > 0
    valid = finite & depth_ok & err_ok & ang_ok & (torch.sum(mask, dim=-1) >= 2)
    return points, valid
