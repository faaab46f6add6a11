"""Pinhole camera with the reference's (non-standard) radial distortion.

Parity target: reference ``Camera.h``. Intrinsics are a 6-vector
``[fx, fy, cx, cy, k1, k2]`` (the Ceres packing order,
BundleAdjuster.cpp:38-43). Two quirks of the reference are reproduced
deliberately because the whole quality envelope (4 px L1 gates, BA
residuals) is defined in terms of them:

1. Distortion is *additive* and *shared* between x and y
   (Camera.h:64-72): ``d = k1*r + k2*r^2`` with ``r = x^2 + y^2`` and then
   ``x += d; y += d`` — not the usual multiplicative ``x *= (1 + ...)``.
2. Principal point is integer-floored ``width // 2`` (Camera.h:24 with int
   division).

Reprojection error is the L1 sum ``|du| + |dv|``
(SequentialReconstructor.cpp:852-867).
"""

from __future__ import annotations

import math

import numpy as np
import torch

FX, FY, CX, CY, K1, K2 = 0, 1, 2, 3, 4, 5


def make_intrinsics(height, width, focal_px=None, focal_factor: float = 1.2,
                    use_35mm_prior: bool = False) -> np.ndarray:
    """Build a [fx, fy, cx, cy, k1, k2] float32 vector (host numpy: the
    reconstructor builds one per image once).

    - known focal: Camera.h:18-27
    - colmap-style prior: f = focal_factor * max(h, w) (Camera.h:45-54)
    - 35mm-equivalent prior (use_35mm_prior): f = 50mm scaled by the
      sensor/image diagonal ratio (Camera.h:30-42)
    """
    if focal_px is not None:
        fx = fy = float(focal_px)
    elif use_35mm_prior:
        diag35mm = 36.0 ** 2 + 24.0 ** 2
        diag_px = float(width) ** 2 + float(height) ** 2
        fx = fy = 50.0 * math.sqrt(diag_px / diag35mm)
    else:
        fx = fy = focal_factor * float(max(height, width))
    cx = float(int(width) // 2)
    cy = float(int(height) // 2)
    return np.array([fx, fy, cx, cy, 0.0, 0.0], dtype=np.float32)


def distort(xy: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Apply the reference's additive radial distortion on the z=1 plane."""
    r = torch.sum(xy * xy, dim=-1, keepdim=True)
    d = intr[..., None, K1:K1 + 1] * r + intr[..., None, K2:K2 + 1] * r * r
    return xy + d


def project(intr: torch.Tensor, pts_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D points -> pixel coords (Camera.h:59-76).

    ``intr``: (..., 6); ``pts_cam``: (..., N, 3) -> (..., N, 2).
    No cheirality handling here; callers gate on z > 0 themselves, exactly
    like the reference.
    """
    z = pts_cam[..., 2:3]
    xy = pts_cam[..., :2] / z
    xy = distort(xy, intr)
    f = intr[..., None, FX:FY + 1]
    c = intr[..., None, CX:CY + 1]
    return xy * f + c


def unproject(intr: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels -> z=1 camera-plane points (Camera.h:79-93).

    Uses the reference's one-step approximate undistortion (subtract the
    distortion evaluated at the distorted point).
    """
    f = intr[..., None, FX:FY + 1]
    c = intr[..., None, CX:CY + 1]
    xy = (uv - c) / f
    r = torch.sum(xy * xy, dim=-1, keepdim=True)
    d = intr[..., None, K1:K1 + 1] * r + intr[..., None, K2:K2 + 1] * r * r
    xy = xy - d
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def intrinsic_matrix(intr: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) K matrix (Camera.h:96-106)."""
    z = torch.zeros_like(intr[..., FX])
    o = torch.ones_like(z)
    return torch.stack([
        torch.stack([intr[..., FX], z, intr[..., CX]], dim=-1),
        torch.stack([z, intr[..., FY], intr[..., CY]], dim=-1),
        torch.stack([z, z, o], dim=-1)], dim=-2)


def reprojection_error_l1(intr: torch.Tensor, pts_cam: torch.Tensor,
                          uv_observed: torch.Tensor) -> torch.Tensor:
    """|du| + |dv| per point (SequentialReconstructor.cpp:852-867)."""
    uv = project(intr, pts_cam)
    return torch.sum(torch.abs(uv - uv_observed), dim=-1)


def focal_mm_to_px(focal_mm: float, img_dim: float, fov_degrees: float) -> float:
    """35mm-style focal conversion (utils.cpp:152-163, with its pi =
    3.1415 and, as there, ``focal_mm`` unused)."""
    fov_radians = fov_degrees * 3.1415 / 180.0
    return img_dim / (2.0 * math.tan(fov_radians / 2.0))
