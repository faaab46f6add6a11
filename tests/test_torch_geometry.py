"""Geometry base of the PyTorch port against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on CPU tensors. Float tolerances are stated per test: both
sides compute in float32, and the differences come only from operation
order (XLA fuses and reassociates), so 1e-5-scale agreement is expected
for O(1) values.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from reconstructor_tpu.geometry import camera as jcam
from reconstructor_tpu.geometry import linalg as jlinalg
from reconstructor_tpu.geometry import se3 as jse3
from reconstructor_tpu.geometry import triangulation as jtri
from reconstructor_tpu_torch.geometry import camera as tcam
from reconstructor_tpu_torch.geometry import linalg as tlinalg
from reconstructor_tpu_torch.geometry import se3 as tse3
from reconstructor_tpu_torch.geometry import triangulation as ttri

from torch_parity import t


def close(a_jax, b_torch, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a_jax), b_torch.numpy(), atol=atol, rtol=rtol)


def random_rotations(rng, n):
    aa = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    aa[0] = 0.0                      # identity (small-angle branch)
    aa[1] = [np.pi - 1e-3, 0, 0]     # near pi
    aa[2] = [1e-6, -2e-6, 0]         # tiny angle
    return aa


class TestSE3:
    def test_rodrigues_roundtrip_matches_jax(self):
        rng = np.random.default_rng(0)
        aa = random_rotations(rng, 64)
        R_j = jse3.angle_axis_to_rotation(jnp.asarray(aa))
        R_t = tse3.angle_axis_to_rotation(t(aa))
        # rotation entries are O(1): float32 agreement to 1e-6
        close(R_j, R_t, atol=1e-6)
        back_j = jse3.rotation_to_angle_axis(R_j)
        back_t = tse3.rotation_to_angle_axis(R_t)
        # inverse near pi is ill-conditioned (d aa / d R ~ 1/sin): 1e-3
        close(back_j, back_t, atol=1e-3)

    @pytest.mark.parametrize("fn", ["pose_to_params", "camera_center", "invert_pose"])
    def test_pose_functions(self, fn):
        rng = np.random.default_rng(1)
        aa = random_rotations(rng, 16)
        tr = rng.normal(0, 3, (16, 3)).astype(np.float32)
        T = np.asarray(jse3.make_pose(jse3.angle_axis_to_rotation(jnp.asarray(aa)),
                                      jnp.asarray(tr)))
        out_j = getattr(jse3, fn)(jnp.asarray(T))
        out_t = getattr(tse3, fn)(t(T))
        # translations up to ~10: relative 1e-5
        close(out_j, out_t, atol=2e-5, rtol=1e-5)

    def test_rotate_points_and_transform(self):
        rng = np.random.default_rng(2)
        aa = random_rotations(rng, 32)
        pts = rng.normal(0, 5, (32, 3)).astype(np.float32)
        close(jse3.rotate_points_aa(jnp.asarray(aa), jnp.asarray(pts)),
              tse3.rotate_points_aa(t(aa), t(pts)), atol=1e-5, rtol=1e-5)
        params = np.concatenate([aa[:1], pts[:1]], axis=1)[0]
        cloud = rng.normal(0, 2, (10, 3)).astype(np.float32)
        close(jse3.transform_points(jnp.asarray(params), jnp.asarray(cloud)),
              tse3.transform_points(t(params), t(cloud)), atol=1e-5, rtol=1e-5)

    def test_project_to_so3(self):
        rng = np.random.default_rng(3)
        M = rng.normal(0, 1, (8, 3, 3)).astype(np.float32)
        R_j = np.asarray(jse3.project_to_so3(jnp.asarray(M)))
        R_t = tse3.project_to_so3(t(M)).numpy()
        # the nearest rotation is unique for generic M; SVD sign choices
        # differ between the libraries but cancel in U D V^T
        np.testing.assert_allclose(R_j, R_t, atol=1e-4)
        np.testing.assert_allclose(np.linalg.det(R_t), 1.0, atol=1e-5)


class TestCamera:
    def test_intrinsics_prior(self):
        for h, w, f in ((384, 512, None), (480, 320, 300.0)):
            np.testing.assert_array_equal(np.asarray(jcam.make_intrinsics(h, w, f)),
                                          tcam.make_intrinsics(h, w, f))

    def test_project_unproject_reprojection(self):
        rng = np.random.default_rng(4)
        intr = np.array([[500, 510, 320, 240, 0.01, -0.002],
                         [600, 600, 256, 192, 0.0, 0.0]], np.float32)
        pts = rng.uniform([-2, -2, 3], [2, 2, 9], (2, 50, 3)).astype(np.float32)
        uv_j = jcam.project(jnp.asarray(intr), jnp.asarray(pts))
        uv_t = tcam.project(t(intr), t(pts))
        # pixels in the hundreds: 1e-4 px
        close(uv_j, uv_t, atol=1e-4)
        close(jcam.unproject(jnp.asarray(intr), uv_j), tcam.unproject(t(intr), uv_t),
              atol=1e-6)
        obs = np.asarray(uv_j) + rng.normal(0, 2, (2, 50, 2)).astype(np.float32)
        close(jcam.reprojection_error_l1(jnp.asarray(intr), jnp.asarray(pts), jnp.asarray(obs)),
              tcam.reprojection_error_l1(t(intr), t(pts), t(obs)), atol=1e-3)
        close(jcam.intrinsic_matrix(jnp.asarray(intr)), tcam.intrinsic_matrix(t(intr)), atol=0)


class TestLinalg:
    def _spd(self, rng, n, batch):
        A = rng.normal(0, 1, (batch, n + 3, n)).astype(np.float32)
        return np.einsum("bki,bkj->bij", A, A) + 0.1 * np.eye(n, dtype=np.float32)

    @pytest.mark.parametrize("n", [6, 9, 12])
    def test_cholesky_and_solve(self, n):
        rng = np.random.default_rng(5)
        A = self._spd(rng, n, 32)
        b = rng.normal(0, 1, (32, n)).astype(np.float32)
        L_j = jlinalg.cholesky_unrolled(jnp.asarray(A))
        L_t = tlinalg.cholesky_unrolled(t(A))
        # same unrolled elimination in the same order: float32 ulps
        close(L_j, L_t, atol=1e-5, rtol=1e-5)
        close(jlinalg.cho_solve_unrolled(L_j, jnp.asarray(b)),
              tlinalg.cho_solve_unrolled(L_t, t(b)), atol=1e-3, rtol=1e-4)

    @pytest.mark.parametrize("n", [9, 12])
    def test_smallest_eigvec(self, n):
        rng = np.random.default_rng(6)
        A = self._spd(rng, n, 32)
        v_j = np.asarray(jlinalg.smallest_eigvec(jnp.asarray(A)))
        v_t = tlinalg.smallest_eigvec(t(A)).numpy()
        # unit vectors from the same deterministic start: same sign
        np.testing.assert_allclose(v_j, v_t, atol=1e-4)

    def test_smallest_eigvec_3x3_and_rank2(self):
        rng = np.random.default_rng(7)
        M = rng.normal(0, 1, (40, 3, 3)).astype(np.float32)
        M[0] = np.diag([2.0, 2.0, 2.0])         # triple eigenvalue
        M[1] = np.diag([1.0, 3.0, 3.0])         # repeated eigenvalue
        S = np.einsum("bki,bkj->bij", M, M)
        import jax
        v_j = np.asarray(jax.vmap(jlinalg.smallest_eigvec_3x3_sym)(jnp.asarray(S)))
        v_t = tlinalg.smallest_eigvec_3x3_sym(t(S)).numpy()
        # closed form: sign is determined by the same cross products;
        # 1e-4 covers the eigenvalue's float32 cancellation
        np.testing.assert_allclose(np.abs((v_j * v_t).sum(-1)), 1.0, atol=1e-4)
        P_j = np.asarray(jax.vmap(jlinalg.project_rank2)(jnp.asarray(M)))
        P_t = tlinalg.project_rank2(t(M)).numpy()
        np.testing.assert_allclose(P_j, P_t, atol=1e-4)


class TestTriangulation:
    def _views(self, rng, n=64, V=4):
        pts = rng.uniform([-2, -2, 5], [2, 2, 9], (n, 3)).astype(np.float32)
        intr = np.array([500, 500, 320, 240, 0.0, 0.0], np.float32)
        aa = np.stack([[0, 0.05 * v - 0.1, 0] for v in range(V)]).astype(np.float32)
        tr = np.stack([[0.4 * v - 0.6, 0, 0] for v in range(V)]).astype(np.float32)
        poses = np.asarray(jse3.make_pose(jse3.angle_axis_to_rotation(jnp.asarray(aa)),
                                          jnp.asarray(tr)))
        pc = np.einsum("vij,nj->nvi", poses[:, :3, :3], pts) + poses[None, :, :3, 3]
        uv = np.asarray(jcam.project(jnp.asarray(intr), jnp.asarray(pc)))
        uv = uv + rng.normal(0, 0.5, uv.shape).astype(np.float32)
        mask = rng.uniform(size=(n, V)) < 0.8
        mask[:, :2] = True
        mask[-1] = [True, False, False, False]      # single view: invalid
        P = np.broadcast_to(poses, (n, V, 4, 4)).copy()
        I = np.broadcast_to(intr, (n, V, 6)).copy()
        return P, I, uv.astype(np.float32), mask

    def test_triangulate_and_validate(self):
        rng = np.random.default_rng(8)
        P, I, uv, mask = self._views(rng)
        xyz_j, ok_j = jtri.triangulate_and_validate(
            jnp.asarray(P), jnp.asarray(I), jnp.asarray(uv), jnp.asarray(mask), 4.0, 1.0)
        xyz_t, ok_t = ttri.triangulate_and_validate(t(P), t(I), t(uv), t(mask), 4.0, 1.0)
        # the validity mask is an index output: equal
        np.testing.assert_array_equal(np.asarray(ok_j), ok_t.numpy())
        # DLT points at depth ~7 from float32 4x4 eigh: 1e-3 relative
        sel = np.asarray(ok_j)
        np.testing.assert_allclose(np.asarray(xyz_j)[sel], xyz_t.numpy()[sel],
                                   rtol=1e-3, atol=1e-3)

    def test_eigh_in_slices(self, monkeypatch):
        """The DLT's eigh runs in slices of ``EIGH_BATCH`` matrices (the
        card's batched eigensolver rejects large batches): slices of 7
        give every point of one call bit for bit, and the JAX result."""
        rng = np.random.default_rng(8)
        P, I, uv, mask = self._views(rng)
        whole = ttri.triangulate_batch(t(P), t(I), t(uv), t(mask))
        monkeypatch.setattr(ttri, "EIGH_BATCH", 7)
        sliced = ttri.triangulate_batch(t(P), t(I), t(uv), t(mask))
        assert torch.equal(torch.isnan(whole), torch.isnan(sliced))
        ok = ~torch.isnan(whole)
        assert torch.equal(whole[ok], sliced[ok])
        xyz_j = np.asarray(jtri.triangulate_batch(jnp.asarray(P), jnp.asarray(I),
                                                  jnp.asarray(uv), jnp.asarray(mask)))
        sel = mask.sum(1) >= 2
        np.testing.assert_allclose(xyz_j[sel], sliced.numpy()[sel], rtol=1e-3, atol=1e-3)

    def test_angles(self):
        rng = np.random.default_rng(9)
        pts = rng.normal(0, 1, (20, 3)).astype(np.float32)
        centers = rng.normal(0, 3, (20, 5, 3)).astype(np.float32)
        a_j = np.asarray(jtri.triangulation_angles_deg(jnp.asarray(pts), jnp.asarray(centers)))
        a_t = ttri.triangulation_angles_deg(t(pts), t(centers)).numpy()
        # off the diagonal, angles to 2e-3 deg; a ray with itself sits at
        # arccos(1 - ulp) ~ sqrt(2 ulp) rad, where float32 rounding alone
        # moves the result by ~0.03 deg (the sweep masks the diagonal)
        off = ~np.eye(5, dtype=bool)[None].repeat(20, 0)
        np.testing.assert_allclose(a_j[off], a_t[off], atol=2e-3)
        np.testing.assert_allclose(np.diagonal(a_j, axis1=1, axis2=2),
                                   np.diagonal(a_t, axis1=1, axis2=2), atol=0.05)
