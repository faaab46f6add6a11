"""Synthetic-scene generation for ground-truth evaluation and scale tests.

The reference has no quantitative evaluation at all (SURVEY.md §4: its
regression artifact is an eyeballed golden PLY). This module provides the
missing capability: generate a known 3D scene + camera rig, inject exact
(noise-perturbed) projections and matchable descriptors directly into a
``ReconstructionState``, run the pipeline from matching onward
(``IncrementalReconstructor.reconstruct_from_state``), and score the
estimate against ground truth with a similarity (Umeyama) alignment.

Descriptors are random unit vectors per 3D point with per-observation
noise, so the real kNN + ratio-test + epipolar-gate machinery does the
work — nothing about the correspondence is fed to the pipeline. Clutter
features (random descriptors at random positions) exercise outlier
rejection.
"""

from __future__ import annotations

import numpy as np

from reconstructor_tpu_torch.pipeline.state import ReconstructionState


def circular_rig(n_views: int, radius: float = 8.0, height_jitter: float = 0.5,
                 arc_degrees: float = 120.0, rng=None) -> np.ndarray:
    """World-to-camera poses (N, 4, 4) on an arc, all looking at the origin."""
    rng = rng or np.random.default_rng(0)
    angles = np.deg2rad(np.linspace(-arc_degrees / 2, arc_degrees / 2, n_views))
    poses = np.zeros((n_views, 4, 4), np.float32)
    for i, a in enumerate(angles):
        center = np.array([radius * np.sin(a),
                           rng.uniform(-height_jitter, height_jitter),
                           -radius * np.cos(a)], np.float64)
        # camera looks from `center` toward the origin: z axis = -center/|c|
        z = -center / np.linalg.norm(center)
        up = np.array([0.0, -1.0, 0.0])
        x = np.cross(up, z); x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])            # rows = camera axes in world
        t = -R @ center
        poses[i, :3, :3] = R
        poses[i, :3, 3] = t
        poses[i, 3, 3] = 1.0
    return poses


def make_synthetic_state(n_views: int = 20, n_points: int = 800,
                         h: int = 480, w: int = 640, focal_px: float = 520.0,
                         noise_px: float = 0.3, desc_noise: float = 0.05,
                         clutter: int = 64, desc_dim: int = 128,
                         seed: int = 0):
    """Build a feature-level ReconstructionState for a known scene.

    Returns (state, gt_poses (N,4,4), gt_points (P,3)). Feature slot p of
    every view corresponds to 3D point p when visible (masked otherwise);
    the last ``clutter`` slots are random distractors. The pipeline never
    sees this alignment — it must recover correspondence by matching.
    """
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-3.0, -2.0, -3.0], [3.0, 2.0, 3.0],
                      (n_points, 3)).astype(np.float32)
    base_desc = rng.standard_normal((n_points, desc_dim)).astype(np.float32)
    base_desc /= np.linalg.norm(base_desc, axis=1, keepdims=True)

    poses = circular_rig(n_views, rng=rng)
    # round the keypoint capacity up to a multiple of 128 so the fused
    # CUDA top-2 kernel's layout requirement holds (extra slots are masked)
    K = ((n_points + clutter + 127) // 128) * 128
    intr = np.tile(np.array([focal_px, focal_px, w // 2, h // 2, 0.0, 0.0],
                            np.float32), (n_views, 1))
    xy = np.zeros((n_views, K, 2), np.float32)
    desc = np.zeros((n_views, K, desc_dim), np.float32)
    mask = np.zeros((n_views, K), bool)
    for i in range(n_views):
        pc = pts @ poses[i, :3, :3].T + poses[i, :3, 3]
        z = pc[:, 2]
        uv = pc[:, :2] / np.maximum(z[:, None], 1e-6) * focal_px \
            + np.array([w // 2, h // 2], np.float32)
        uv = uv + rng.normal(0, noise_px, uv.shape).astype(np.float32)
        vis = (z > 0.5) & (uv[:, 0] >= 4) & (uv[:, 0] < w - 4) \
            & (uv[:, 1] >= 4) & (uv[:, 1] < h - 4)
        d = base_desc + rng.normal(0, desc_noise,
                                   base_desc.shape).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        xy[i, :n_points] = uv
        desc[i, :n_points] = d
        mask[i, :n_points] = vis
        if clutter:
            ce = n_points + clutter    # slots past ce are masked padding
            xy[i, n_points:ce] = rng.uniform([0, 0], [w - 1, h - 1],
                                             (clutter, 2)).astype(np.float32)
            cd = rng.standard_normal((clutter, desc_dim)).astype(np.float32)
            desc[i, n_points:ce] = cd / np.linalg.norm(cd, axis=1,
                                                       keepdims=True)
            mask[i, n_points:ce] = True

    state = ReconstructionState(
        num_images=n_views, max_keypoints=K,
        xy=xy, desc=desc, kp_mask=mask,
        colors=rng.integers(0, 255, (n_views, K, 3)).astype(np.uint8),
        shapes=np.tile(np.array([h, w], np.int32), (n_views, 1)),
        intrinsics=intr)
    return state, poses, pts


def pose_ate(est_poses: dict, gt_poses: np.ndarray) -> dict:
    """ATE of estimated camera centers vs ground truth (similarity-aligned)."""
    from reconstructor_tpu_torch.eval.ate import umeyama
    ids = sorted(est_poses.keys())
    est = np.stack([-est_poses[i][:3, :3].T @ est_poses[i][:3, 3] for i in ids])
    gt = np.stack([-gt_poses[i, :3, :3].T @ gt_poses[i, :3, 3] for i in ids])
    s, R, t = umeyama(est, gt)
    aligned = s * est @ R.T + t
    err = np.linalg.norm(aligned - gt, axis=1)
    extent = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    return {"ate_rmse": float(np.sqrt((err ** 2).mean())),
            "ate_rmse_normalized": float(np.sqrt((err ** 2).mean()) / extent),
            "num_aligned": len(ids)}
