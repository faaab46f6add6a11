"""Synthetic image rendering for learned-frontend evaluation.

The reference runs SuperPoint/SuperGlue on real photos with pretrained
TorchScript blobs (FeatureSuperPoint.cpp:228-263,
FeatureMatcherSuperglue.cpp:51-101); those blobs are absent from the
snapshot and this environment has no egress, so pretrained weights cannot
exist here. This module provides the substitute evidence path: an exact
analytic renderer for a two-plane "open book" corner scene whose texture
is a field of Gaussian blobs with KNOWN 3D blob centers. A small
training run (scripts/train_frontend.py) fits the real SuperPoint
architecture to detect those blobs and produce matchable descriptors,
and the e2e test reconstructs the scene through
``detector=superpoint, matcher=superglue`` — validating the full
decode -> Sinkhorn -> SfM chain at reconstruction quality with
*structured, trained* weights rather than random ones.

Geometry: plane A is {z = 0, x >= 0} textured by texture A with plane
coordinates (x, y); plane B is {x = 0, z <= 0} textured by texture B
with plane coordinates (-z, y). Cameras sit on an arc in the x > 0,
z > 0 quadrant looking at the corner line, so both planes are visible
and the scene is non-degenerate (non-planar) for PnP and BA.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# world extent of each plane's textured square (plane coords in [0, EXTENT])
EXTENT = 4.0


def make_blob_texture(rng: np.random.Generator, size: int = 256,
                      n_blobs: int = 120, sigma_px: Tuple[float, float] = (3.5, 7.0)):
    """Random Gaussian blob field, values in [0, 1].

    Returns (texture (size, size), blob_xy (n, 2) in *texture pixels*).
    Blob centers are spaced at least 4*sigma_max apart so each one is an
    isolated, NMS-stable detection target.
    """
    tex = np.zeros((size, size), np.float32)
    min_dist = 4.0 * sigma_px[1]
    # rejection sampling into a preallocated array: the same draws and
    # tests as growing a list and converting it on every try, without the
    # conversion that made a 1200-blob texture take half a minute
    placed = np.zeros((n_blobs, 2))
    count = 0
    tries = 0
    while count < n_blobs and tries < n_blobs * 60:
        tries += 1
        c = rng.uniform(8, size - 8, 2)
        if count and (np.linalg.norm(placed[:count] - c, axis=1).min() < min_dist):
            continue
        placed[count] = c
        count += 1
    centers = placed[:count].astype(np.float32)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    for c in centers:
        sig = rng.uniform(*sigma_px)
        amp = rng.uniform(0.55, 1.0) * rng.choice([-1.0, 1.0])
        # Each blob is evaluated inside an 8-sigma window only: beyond it
        # the Gaussian is below exp(-32) ~ 1e-14 of its peak, under float32
        # resolution once the background is added, and the window cuts the
        # 25-view 1024^2 fountain-sized scene from about a minute to seconds.
        r = int(np.ceil(8.0 * sig))
        x0, x1 = max(int(c[0]) - r, 0), min(int(c[0]) + r + 1, size)
        y0, y1 = max(int(c[1]) - r, 0), min(int(c[1]) + r + 1, size)
        d2 = (xs[y0:y1, x0:x1] - c[0]) ** 2 + (ys[y0:y1, x0:x1] - c[1]) ** 2
        tex[y0:y1, x0:x1] += amp * np.exp(-d2 / (2 * sig * sig))
    # low-frequency background so descriptors see context, not just blobs
    coarse = rng.standard_normal((size // 32, size // 32)).astype(np.float32)
    bg = np.kron(coarse, np.ones((32, 32), np.float32))
    k = np.hanning(33)[:, None] * np.hanning(33)[None, :]
    k /= k.sum()
    from numpy.fft import rfft2, irfft2
    pad = np.zeros_like(bg)
    pad[:33, :33] = k
    bg = np.real(irfft2(rfft2(bg) * rfft2(pad), s=bg.shape))
    tex = tex + 0.35 * bg / (np.abs(bg).max() + 1e-9)
    tex = (tex - tex.min()) / (tex.max() - tex.min() + 1e-9)
    return tex, centers


def corner_rig(n_views: int, radius: float = 4.8, elev_jitter: float = 0.4,
               arc_degrees: Tuple[float, float] = (22.0, 64.0),
               rng=None) -> np.ndarray:
    """World-to-camera poses (N, 4, 4) on an arc in the x>0, z>0 quadrant,
    all looking at the corner point (EXTENT/2 height on the fold line)."""
    rng = rng or np.random.default_rng(0)
    target = np.array([EXTENT * 0.45, EXTENT * 0.5, -EXTENT * 0.45])
    angles = np.deg2rad(np.linspace(*arc_degrees, n_views))
    poses = np.zeros((n_views, 4, 4), np.float32)
    for i, a in enumerate(angles):
        center = np.array([radius * np.sin(a),
                           EXTENT * 0.5 + rng.uniform(-elev_jitter, elev_jitter),
                           radius * np.cos(a)], np.float64)
        z = target - center
        z /= np.linalg.norm(z)
        up = np.array([0.0, -1.0, 0.0])
        x = np.cross(up, z); x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        poses[i, :3, :3] = R
        poses[i, :3, 3] = -R @ center
        poses[i, 3, 3] = 1.0
    return poses


def _plane_coords(o: np.ndarray, d: np.ndarray):
    """Ray/two-plane intersection. o: (3,), d: (..., 3) unit rays (world).

    Returns (pa (..., 2), va (...), pb (..., 2), vb (...), use_a (...)):
    plane coords + validity per plane, and which plane the ray hits first.
    """
    eps = 1e-9
    ta = -o[2] / np.where(np.abs(d[..., 2]) < eps, eps, d[..., 2])
    hit_a = o[None, None, :2] + ta[..., None] * d[..., :2]   # (x, y) on z=0
    va = (ta > eps) & (hit_a[..., 0] >= 0) & (hit_a[..., 0] <= EXTENT) \
        & (hit_a[..., 1] >= 0) & (hit_a[..., 1] <= EXTENT)
    tb = -o[0] / np.where(np.abs(d[..., 0]) < eps, eps, d[..., 0])
    hb_z = o[2] + tb * d[..., 2]
    hb_y = o[1] + tb * d[..., 1]
    hit_b = np.stack([-hb_z, hb_y], axis=-1)                 # (-z, y) on x=0
    vb = (tb > eps) & (hit_b[..., 0] >= 0) & (hit_b[..., 0] <= EXTENT) \
        & (hit_b[..., 1] >= 0) & (hit_b[..., 1] <= EXTENT)
    use_a = va & (~vb | (ta <= tb))
    return hit_a, va, hit_b, vb, use_a


def _sample_tex(tex: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Bilinear texture sample; uv in plane coords [0, EXTENT]."""
    size = tex.shape[0]
    p = np.clip(uv / EXTENT * (size - 1), 0, size - 1.001)
    x0 = p[..., 0].astype(np.int32)
    y0 = p[..., 1].astype(np.int32)
    fx = p[..., 0] - x0
    fy = p[..., 1] - y0
    return (tex[y0, x0] * (1 - fx) * (1 - fy) + tex[y0, x0 + 1] * fx * (1 - fy)
            + tex[y0 + 1, x0] * (1 - fx) * fy + tex[y0 + 1, x0 + 1] * fx * fy)


def render_views(poses: np.ndarray, tex_a: np.ndarray, tex_b: np.ndarray,
                 h: int = 160, w: int = 160, focal_px: float = 170.0):
    """Render the corner scene. Returns (images (N, h, w) float32 [0, 1],
    intrinsics (N, 6))."""
    n = poses.shape[0]
    imgs = np.zeros((n, h, w), np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    dirs_cam = np.stack([(xs - w / 2) / focal_px,
                         (ys - h / 2) / focal_px,
                         np.ones_like(xs)], axis=-1)
    for i in range(n):
        R = poses[i, :3, :3].astype(np.float64)
        o = -R.T @ poses[i, :3, 3].astype(np.float64)
        d = dirs_cam @ R          # rays in world frame
        pa, va, pb, vb, use_a = _plane_coords(o, d)
        img = np.full((h, w), 0.45, np.float64)
        img = np.where(vb, _sample_tex(tex_b, pb), img)
        img = np.where(use_a, _sample_tex(tex_a, pa), img)
        imgs[i] = img.astype(np.float32)
    intr = np.tile(np.array([focal_px, focal_px, w // 2, h // 2, 0.0, 0.0],
                            np.float32), (n, 1))
    return imgs, intr


def blob_points_3d(blob_a_px: np.ndarray, blob_b_px: np.ndarray,
                   tex_size: int) -> np.ndarray:
    """Texture-pixel blob centers -> world 3D points on their planes."""
    ca = blob_a_px / (tex_size - 1) * EXTENT
    pa = np.stack([ca[:, 0], ca[:, 1], np.zeros(len(ca))], axis=1)
    cb = blob_b_px / (tex_size - 1) * EXTENT
    pb = np.stack([np.zeros(len(cb)), cb[:, 1], -cb[:, 0]], axis=1)
    return np.concatenate([pa, pb]).astype(np.float32)


def project_points(pts: np.ndarray, pose: np.ndarray, intr: np.ndarray):
    """Project world points with a pinhole (no distortion).

    Returns (uv (P, 2), z (P,))."""
    pc = pts @ pose[:3, :3].T + pose[:3, 3]
    z = pc[:, 2]
    uv = pc[:, :2] / np.maximum(z[:, None], 1e-9) * intr[0] + intr[2:4]
    return uv, z


def visible_gt_keypoints(pts: np.ndarray, pose: np.ndarray, intr: np.ndarray,
                         h: int, w: int, border: int = 6):
    """GT keypoints of one view: projections of blob centers that land
    in-frame AND on the plane half actually facing the camera (the other
    plane occludes nothing in this convex-corner geometry, so an
    in-extent in-front projection is visible by construction)."""
    uv, z = project_points(pts, pose, intr)
    ok = (z > 0.5) & (uv[:, 0] >= border) & (uv[:, 0] < w - border) \
        & (uv[:, 1] >= border) & (uv[:, 1] < h - border)
    return uv, ok


def make_scene(seed: int = 0, n_views: int = 10, h: int = 160, w: int = 160,
               n_blobs: int = 80, tex_size: int = 320,
               focal_px: float = 170.0):
    """One-call scene factory.

    Returns dict with images, intrinsics, gt poses, gt 3D blob points,
    per-view GT projections + visibility.
    """
    rng = np.random.default_rng(seed)
    tex_a, blobs_a = make_blob_texture(rng, tex_size, n_blobs)
    tex_b, blobs_b = make_blob_texture(rng, tex_size, n_blobs)
    poses = corner_rig(n_views, rng=rng)
    imgs, intr = render_views(poses, tex_a, tex_b, h, w, focal_px)
    pts = blob_points_3d(blobs_a, blobs_b, tex_size)
    uvs = np.zeros((n_views, len(pts), 2), np.float32)
    vis = np.zeros((n_views, len(pts)), bool)
    for i in range(n_views):
        uvs[i], vis[i] = visible_gt_keypoints(pts, poses[i], intr[i], h, w)
    return {"images": imgs, "intrinsics": intr, "poses": poses,
            "points": pts, "gt_uv": uvs, "gt_vis": vis,
            "textures": (tex_a, tex_b)}
