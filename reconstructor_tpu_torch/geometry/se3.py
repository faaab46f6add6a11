"""SE(3) / SO(3) utilities on batched tensors.

The reference stores world->camera rigid transforms as 4x4 Eigen matrices
(``imgIdx2camPose``) and converts to/from angle-axis for Ceres
(BundleAdjuster.cpp:49-57, 160-174). Here poses are plain ``(4, 4)`` or
``(..., 4, 4)`` tensors plus angle-axis 6-vectors ``[aa(3), t(3)]`` used as
the BA parameterization. All ops are shape-polymorphic over leading batch
dims and safe at the small-angle / pi singularities (forward-mode autodiff
passes through them inside the pose refinements).

Convention (same as reference): ``p_cam = R @ p_world + t``; camera center
``c = -R^T t`` (utils.cpp:265).
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector (batched)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def angle_axis_to_rotation(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, Taylor-safe near zero.

    R = I + sin(t)/t * W + (1-cos(t))/t^2 * W^2, W = hat(aa).
    """
    # trailing singleton axes throughout: forward-mode AD (the pose
    # refinements' jacfwd) promotes 0-dim tensors' tangents to float64
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)[..., None]   # (..., 1, 1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    sin_t = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cos_t = torch.where(small, 0.5 - theta2 / 24.0,
                        (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    W = hat(aa)
    W2 = W @ W
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(W.shape)
    return eye + sin_t * W + cos_t * W2


def rotation_to_angle_axis(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues via quaternion extraction (robust near 0 and pi)."""
    return quaternion_to_angle_axis(rotation_to_quaternion(R))


def rotation_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [w, x, y, z], branch-free: the
    four candidate constructions, the best-conditioned one selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=_EPS)) / 2.0
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)

    s1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=_EPS)) * 2
    q1 = torch.stack([(m21 - m12) / s1, s1 / 4, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1)

    s2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=_EPS)) * 2
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, s2 / 4,
                      (m12 + m21) / s2], dim=-1)

    s3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=_EPS)) * 2
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      s3 / 4], dim=-1)

    cond0 = tr > 0
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = torch.where(cond0[..., None], q0,
                    torch.where(cond1[..., None], q1,
                                torch.where(cond2[..., None], q2, q3)))
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    # Canonicalize sign (w >= 0) so angle <= pi.
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quaternion_to_angle_axis(q: torch.Tensor) -> torch.Tensor:
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    sin_half = torch.linalg.norm(xyz, dim=-1)
    angle = 2.0 * torch.atan2(sin_half, w)
    scale = torch.where(sin_half < 1e-8, 2.0, angle / (sin_half + _EPS))
    return xyz * scale[..., None]


def make_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) world->camera pose from R and t."""
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def pose_to_params(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) pose -> (..., 6) [angle-axis, t] (BA parameterization)."""
    aa = rotation_to_angle_axis(T[..., :3, :3])
    return torch.cat([aa, T[..., :3, 3]], dim=-1)


def params_to_pose(p: torch.Tensor) -> torch.Tensor:
    """(..., 6) [angle-axis, t] -> (..., 4, 4) pose."""
    return make_pose(angle_axis_to_rotation(p[..., :3]), p[..., 3:6])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply world->camera transform: p_cam = R p + t.

    ``T``: (..., 4, 4) (or (..., 6) pose params), ``pts``: (..., N, 3).
    """
    if T.shape[-1] == 6:
        R = angle_axis_to_rotation(T[..., :3])
        t = T[..., 3:6]
    else:
        R, t = T[..., :3, :3], T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def rotate_points_aa(aa: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Rotate points directly by an angle-axis vector (no matrix build).

    Equivalent of ceres::AngleAxisRotatePoint (BundleAdjuster.h:34):
        p' = p cos(t) + (w x p) sin(t) + w (w . p)(1 - cos(t)).
    ``aa``: (..., 3); ``pts``: (..., 3) with matching batch dims.
    """
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + _EPS)
    w = aa / theta
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    w_cross_p = torch.linalg.cross(w, pts, dim=-1)
    w_dot_p = torch.sum(w * pts, dim=-1, keepdim=True)
    rotated = pts * cos_t + w_cross_p * sin_t + w * w_dot_p * (1.0 - cos_t)
    small = theta2 < 1e-12
    return torch.where(small, pts + torch.linalg.cross(aa, pts, dim=-1), rotated)


def camera_center(T: torch.Tensor) -> torch.Tensor:
    """Camera center in world frame: c = -R^T t (utils.cpp:265)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return -torch.einsum("...ji,...j->...i", R, t)


def invert_pose(T: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_pose(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def compose(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """T1 @ T2 (apply T2 first)."""
    return T1 @ T2


def project_to_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation matrix to M via SVD (det-corrected)."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.ones(M.shape[:-2] + (3,), dtype=M.dtype, device=M.device)
    D = torch.cat([D[..., :2], det[..., None]], dim=-1)
    return (U * D[..., None, :]) @ Vt
