"""PLY point-cloud export with the reference's output convention.

Parity target: ``Utils::saveCloud`` (utils.cpp:345-368) — an ASCII PLY in
PCL's dialect containing the colored landmarks followed by one green
(0, 250, 0) point per camera at its center ``-R^T t``
(utils.cpp:254-275). The "before-BA" diagnostic variant paints outlier
landmarks red (253, 0, 0) and then appends the full set again in original
colors — the exact duplication behavior of
landmarksToPclCloud(landmarks, inliers) (utils.cpp:222-252) is NOT
replicated (it double-writes all points, an apparent bug); we write each
landmark once, outliers painted red, which is the evident intent.

The native C++ writer (``native/libreconstructor_native.so`` through
``io/native.py``) writes the file whenever its library loads, as in the
TPU package; the numpy writer is the fallback.
"""

from __future__ import annotations

import numpy as np

from reconstructor_tpu_torch.io import native

_PCL_HEADER = """ply
format ascii 1.0
comment PCL generated
element vertex {n}
property float x
property float y
property float z
property uchar red
property uchar green
property uchar blue
element camera 1
property float view_px
property float view_py
property float view_pz
property float x_axisx
property float x_axisy
property float x_axisz
property float y_axisx
property float y_axisy
property float y_axisz
property float z_axisx
property float z_axisy
property float z_axisz
property float focal
property float scalex
property float scaley
property float centerx
property float centery
property int viewportx
property int viewporty
property float k1
property float k2
end_header
"""

_PCL_CAMERA_LINE = "0 0 0 1 0 0 0 1 0 0 0 1 0 0 0 0 0 0 0 0 0\n"


def camera_centers(poses: np.ndarray) -> np.ndarray:
    """(N, 4, 4) world->cam poses -> (N, 3) centers c = -R^T t."""
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)


def save_cloud(path: str, points: np.ndarray, colors: np.ndarray,
               poses: np.ndarray | None = None,
               inliers: np.ndarray | None = None) -> None:
    """Write landmarks (+ camera-center points) as ASCII PLY.

    points: (N, 3) float; colors: (N, 3) uint8; poses: (C, 4, 4) or None;
    inliers: optional (N,) bool — outliers painted red as in the reference's
    pre-BA diagnostic clouds.
    """
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.uint8).copy()
    if inliers is not None:
        outl = ~np.asarray(inliers, bool)
        colors[outl] = (253, 0, 0)

    if poses is not None and len(poses):
        centers = camera_centers(np.asarray(poses, np.float32))
        cam_colors = np.tile(np.array([[0, 250, 0]], np.uint8), (centers.shape[0], 1))
        pts_all = np.concatenate([points, centers], axis=0)
        col_all = np.concatenate([colors, cam_colors], axis=0)
    else:
        pts_all, col_all = points, colors

    if native.available() and native.write_ply(path, pts_all, col_all):
        return
    n = pts_all.shape[0]
    with open(path, "w") as f:
        f.write(_PCL_HEADER.format(n=n))
        # vectorized row formatting
        xyz = [f"{x:g} {y:g} {z:g}" for x, y, z in pts_all]
        rgb = [f"{r} {g} {b}" for r, g, b in col_all]
        f.write("\n".join(a + " " + b for a, b in zip(xyz, rgb)))
        f.write("\n")
        f.write(_PCL_CAMERA_LINE)


def load_cloud(path: str):
    """Minimal ASCII PLY reader (for tests / golden comparisons).

    Returns (points (N,3) float32, colors (N,3) uint8)."""
    with open(path) as f:
        n = 0
        line = f.readline()
        while line and not line.startswith("end_header"):
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            line = f.readline()
        pts = np.zeros((n, 3), np.float32)
        cols = np.zeros((n, 3), np.uint8)
        for i in range(n):
            parts = f.readline().split()
            pts[i] = [float(v) for v in parts[:3]]
            if len(parts) >= 6:
                cols[i] = [int(float(v)) for v in parts[3:6]]
    return pts, cols
