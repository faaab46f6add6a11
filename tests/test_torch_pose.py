"""Epipolar pose, P3P and PnP of the PyTorch port against the JAX package, on the CPU.

JAX's counter-based PRNG cannot be reproduced in torch, so every port
sampler takes the raw draws as a tensor. These tests draw them with
``jax.random.randint`` from the very key the JAX function splits
internally; both packages then pick the same minimal sets, and inlier
masks are compared index for index where the problem is well posed.
"""

import numpy as np
import jax
import jax.numpy as jnp

from reconstructor_tpu.geometry import epipolar as jepi
from reconstructor_tpu.geometry import p3p as jp3p
from reconstructor_tpu.geometry import se3 as jse3
from reconstructor_tpu.pipeline.incremental import _initial_pose, _pnp
from reconstructor_tpu_torch.geometry import epipolar as tepi
from reconstructor_tpu_torch.geometry import p3p as tp3p
from reconstructor_tpu_torch.geometry import pnp as tpnp

from torch_parity import INTR, draws, t, two_view


class TestEpipolar:
    def test_relative_pose(self):
        rng = np.random.default_rng(4)
        uv1, uv2, pts, R, tr = two_view(rng, n=240, outliers=0.25, noise=0.3)
        mask = np.ones(len(uv1), bool)
        mask[-20:] = False
        key = jax.random.PRNGKey(11)
        H = 256
        pose_j, inl_j, cnt_j = _initial_pose(      # the pipeline's jitted call
            key, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(INTR), jnp.asarray(INTR),
            jnp.asarray(mask), thresh_px=1.0, num_hypotheses=H)
        key_e, key_h = jax.random.split(key)
        pose_t, E_t, inl_t, cnt_t = tepi.estimate_relative_pose(
            t(uv1), t(uv2), t(INTR), t(INTR), t(mask), thresh_px=1.0, num_hypotheses=H,
            pos_e=t(draws(key_e, (H, 8))), pos_h=t(draws(key_h, (H, 4))))
        pose_j = np.asarray(pose_j)
        pose_t = pose_t.numpy()
        # same minimal sets; the winner is refined by 10 Gauss-Newton steps
        # in float32 on both sides: rotation to 1e-3, unit translation 1e-2
        np.testing.assert_allclose(pose_j[:3, :3], pose_t[:3, :3], atol=1e-3)
        np.testing.assert_allclose(pose_j[:3, 3], pose_t[:3, 3], atol=1e-2)
        # and both recover the true motion
        np.testing.assert_allclose(pose_t[:3, :3], R, atol=2e-2)
        assert np.dot(pose_t[:3, 3], tr / np.linalg.norm(tr)) > 0.99
        # inlier sets: the 1 px gate on a refined model; borderline
        # points may flip with float32 rounding: at most 2 of 220
        diff = (np.asarray(inl_j) != inl_t.numpy()).sum()
        assert diff <= 2, diff
        assert abs(int(cnt_j) - int(cnt_t)) <= 2

    def test_decompose_and_recover(self):
        rng = np.random.default_rng(5)
        uv1, uv2, pts, R, tr = two_view(rng, n=100, outliers=0.0, noise=0.0)
        E = np.asarray(jepi.essential_from_pose(jnp.asarray(R), jnp.asarray(tr / np.linalg.norm(tr))))
        mask = np.ones(100, bool)
        pose_j, cnt_j = jepi.recover_pose(jnp.asarray(E), jnp.asarray(uv1), jnp.asarray(uv2),
                                          jnp.asarray(INTR), jnp.asarray(INTR), jnp.asarray(mask))
        pose_t, cnt_t = tepi.recover_pose(t(E), t(uv1), t(uv2), t(INTR), t(INTR), t(mask))
        assert int(np.max(np.asarray(cnt_j))) == int(cnt_t.max()) == 100
        np.testing.assert_allclose(np.asarray(pose_j), pose_t.numpy(), atol=1e-4)
        # homography of a plane: the candidate set contains the true motion
        n_plane = np.array([0.0, 0.0, 1.0])
        Hm = R + np.outer(tr, n_plane) / 7.0
        cands_j = jepi.decompose_homography(jnp.asarray(Hm, jnp.float32))
        cands_t = tepi.decompose_homography(t(Hm.astype(np.float32)))
        for (Rj, tj), (Rt, tt) in zip(cands_j, cands_t):
            np.testing.assert_allclose(np.asarray(Rj), Rt.numpy(), atol=1e-4)
            np.testing.assert_allclose(np.abs(np.asarray(tj)), np.abs(tt.numpy()), atol=1e-4)
        assert min(np.abs(Rt.numpy() - R).max() for Rt, _ in cands_t) < 1e-3


class TestP3PAndPnP:
    def _scene(self, rng, n=150, outliers=0.3):
        pts = rng.uniform([-2, -2, 4], [2, 2, 8], (n, 3)).astype(np.float32)
        aa = np.array([0.05, -0.1, 0.02], np.float32)
        tr = np.array([0.3, -0.2, 0.5], np.float32)
        R = np.asarray(jse3.angle_axis_to_rotation(jnp.asarray(aa)))
        pc = pts @ R.T + tr
        uv = pc[:, :2] / pc[:, 2:] * INTR[:2] + INTR[2:4] + rng.normal(0, 0.5, (n, 2))
        bad = rng.uniform(size=n) < outliers
        uv[bad] = rng.uniform([0, 0], [320, 240], (int(bad.sum()), 2))
        return pts, uv.astype(np.float32), R, tr

    def test_p3p_candidates(self):
        """Grunert's quartic is solved by 40 float32 Durand-Kerner steps.
        For some sample geometries it is ill-conditioned in float32 in
        both packages alike (their candidates for noise-free data sit
        1e-2..1e-1 from the truth), and there the real/complex split and
        the root order follow rounding. Measured on this seed: 2 of 128
        roots classified differently, 88% of candidates within 5e-3.
        Required: >= 95% of roots classified alike, median candidate
        difference <= 1e-4 and >= 85% within 5e-3. Candidates compare as
        sets per sample (the root order may swap). The decision that
        matters, PnP's inlier set, is held exactly in test_pnp_ransac."""
        rng = np.random.default_rng(6)
        pts, uv, R, tr = self._scene(rng, n=60, outliers=0.0)
        idx = np.stack([rng.choice(60, 3, replace=False) for _ in range(32)])
        b = np.concatenate([(uv - INTR[2:4]) / INTR[:2], np.ones((60, 1), np.float32)], 1)
        b = (b / np.linalg.norm(b, axis=1, keepdims=True)).astype(np.float32)
        P_j = np.asarray(jax.vmap(jp3p.p3p_grunert)(jnp.asarray(pts[idx]), jnp.asarray(b[idx])))
        P_t = tp3p.p3p_grunert(t(pts[idx]), t(b[idx])).numpy()
        nan_j = np.isnan(P_j).any((-1, -2))
        nan_t = np.isnan(P_t).any((-1, -2))
        assert (nan_j == nan_t).mean() >= 0.95
        d = np.abs(P_t[:, :, None] - P_j[:, None, :]).max((-1, -2))     # (32, 4, 4)
        err = np.nan_to_num(d, nan=9.0).min(-1)[~nan_t]
        assert np.median(err) <= 1e-4
        assert (err <= 5e-3).mean() >= 0.85

    def test_pnp_ransac(self):
        rng = np.random.default_rng(7)
        pts, uv, R, tr = self._scene(rng)
        mask = np.ones(len(pts), bool)
        mask[-10:] = False
        key = jax.random.PRNGKey(21)
        H = 256
        pose_j, inl_j, cnt_j = _pnp(               # the pipeline's jitted call
            key, jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(INTR), jnp.asarray(mask),
            thresh_px=4.0, num_hypotheses=H, refine_iters=10)
        pose_t, inl_t, cnt_t = tpnp.solve_pnp_ransac(
            t(pts), t(uv), t(INTR), t(mask), thresh_px=4.0, num_hypotheses=H,
            pos=t(draws(key, (H, 3))))
        np.testing.assert_array_equal(np.asarray(inl_j), inl_t.numpy())
        assert int(cnt_j) == int(cnt_t)
        # Gauss-Newton polished poses: rotation 1e-4, translation 1e-3
        np.testing.assert_allclose(np.asarray(pose_j)[:3, :3], pose_t.numpy()[:3, :3], atol=1e-4)
        np.testing.assert_allclose(np.asarray(pose_j)[:3, 3], pose_t.numpy()[:3, 3], atol=1e-3)
        np.testing.assert_allclose(pose_t.numpy()[:3, :3], R, atol=5e-3)
