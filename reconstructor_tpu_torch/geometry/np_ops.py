"""Host-side (numpy) mirrors of the small per-view geometry helpers.

The incremental loop does O(thousand)-element bookkeeping math between
the big device programs: reprojection gates when attaching observations,
angle-axis <-> rotation packing around BA, covisibility counts. Those
arrays live on the host already, so they stay in numpy instead of paying
a device round trip per call. These mirrors implement the exact reference
semantics (Camera.h:59-76 additive shared distortion;
SequentialReconstructor.cpp:852-867 L1 error; BundleAdjuster.cpp:49-57
angle-axis packing) in pure numpy.
"""

from __future__ import annotations

import numpy as np


def project(intr: np.ndarray, pts_cam: np.ndarray) -> np.ndarray:
    """Camera-frame points -> pixels (Camera.h:59-76 parity).

    intr: (6,) or (..., 6); pts_cam: (..., 3) -> (..., 2).
    """
    z = pts_cam[..., 2:3]
    xy = pts_cam[..., :2] / z
    r = np.sum(xy * xy, axis=-1, keepdims=True)
    d = intr[..., 4:5] * r + intr[..., 5:6] * r * r
    xy = xy + d
    f = np.stack([intr[..., 0], intr[..., 1]], axis=-1)
    c = np.stack([intr[..., 2], intr[..., 3]], axis=-1)
    return xy * f + c


def reprojection_error_l1(intr: np.ndarray, pts_cam: np.ndarray,
                          uv_observed: np.ndarray) -> np.ndarray:
    """|du| + |dv| per point (SequentialReconstructor.cpp:852-867)."""
    uv = project(intr, pts_cam)
    return np.sum(np.abs(uv - uv_observed), axis=-1)


def rotation_to_angle_axis(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> angle-axis via quaternion (batched, numpy)."""
    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    eps = 1e-12

    qw0 = np.sqrt(np.maximum(1.0 + tr, eps)) / 2.0
    q0 = np.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                   (m10 - m01) / (4 * qw0)], axis=-1)
    s1 = np.sqrt(np.maximum(1.0 + m00 - m11 - m22, eps)) * 2
    q1 = np.stack([(m21 - m12) / s1, s1 / 4, (m01 + m10) / s1,
                   (m02 + m20) / s1], axis=-1)
    s2 = np.sqrt(np.maximum(1.0 - m00 + m11 - m22, eps)) * 2
    q2 = np.stack([(m02 - m20) / s2, (m01 + m10) / s2, s2 / 4,
                   (m12 + m21) / s2], axis=-1)
    s3 = np.sqrt(np.maximum(1.0 - m00 - m11 + m22, eps)) * 2
    q3 = np.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                   s3 / 4], axis=-1)

    cond0 = (tr > 0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = np.where(cond0, q0, np.where(cond1, q1, np.where(cond2, q2, q3)))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    q = q * np.where(q[..., :1] < 0, -1.0, 1.0)

    w = np.clip(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    sin_half = np.linalg.norm(xyz, axis=-1)
    angle = 2.0 * np.arctan2(sin_half, w)
    scale = np.where(sin_half < 1e-8, 2.0, angle / (sin_half + eps))
    return (xyz * scale[..., None]).astype(np.float32)


def angle_axis_to_rotation(aa: np.ndarray) -> np.ndarray:
    """Rodrigues formula (batched, numpy, Taylor-safe near zero)."""
    aa = np.asarray(aa, np.float64)
    theta2 = np.sum(aa * aa, axis=-1)
    theta = np.sqrt(theta2 + 1e-12)
    small = theta2 < 1e-8
    sin_t = np.where(small, 1.0 - theta2 / 6.0, np.sin(theta) / theta)
    cos_t = np.where(small, 0.5 - theta2 / 24.0,
                     (1.0 - np.cos(theta)) / (theta2 + 1e-12))
    wx, wy, wz = aa[..., 0], aa[..., 1], aa[..., 2]
    zeros = np.zeros_like(wx)
    W = np.stack([
        np.stack([zeros, -wz, wy], axis=-1),
        np.stack([wz, zeros, -wx], axis=-1),
        np.stack([-wy, wx, zeros], axis=-1),
    ], axis=-2)
    W2 = W @ W
    eye = np.broadcast_to(np.eye(3), W.shape)
    R = eye + sin_t[..., None, None] * W + cos_t[..., None, None] * W2
    return R.astype(np.float32)


def camera_center(T: np.ndarray) -> np.ndarray:
    """c = -R^T t (utils.cpp:265), batched."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return -np.einsum("...ji,...j->...i", R, t)
