"""The last public estimators and helpers of the port against the JAX
package on the CPU: RANSAC fundamental and essential matrices with their
guarded all-inlier refit, the 6-point DLT PnP, one-point triangulation,
pose composition, the 35 mm focal conversion and the separable Gaussian
blur.

RANSAC draws are injected: the JAX functions sample from the key they are
given, and the port takes the same raw draws (``torch_parity.draws``), so
both pick the same minimal sets. Inlier masks and counts are compared
index for index; models up to float32 rounding (a fundamental or
essential matrix also up to its sign, which the nullspace leaves free:
F within 1e-4, E within 1e-3 through its SVD projection);
polished poses within 1e-4 (rotation) and 1e-3 (translation), as
``tests/test_torch_pose.py`` holds P3P PnP.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reconstructor_tpu.features import sift as jsift
from reconstructor_tpu.geometry import camera as jcam
from reconstructor_tpu.geometry import epipolar as jepi
from reconstructor_tpu.geometry import pnp as jpnp
from reconstructor_tpu.geometry import ransac as jransac
from reconstructor_tpu.geometry import se3 as jse3
from reconstructor_tpu.geometry import triangulation as jtri
from reconstructor_tpu_torch.features import sift as tsift
from reconstructor_tpu_torch.geometry import camera as tcam
from reconstructor_tpu_torch.geometry import epipolar as tepi
from reconstructor_tpu_torch.geometry import fgate as tfgate
from reconstructor_tpu_torch.geometry import pnp as tpnp
from reconstructor_tpu_torch.geometry import se3 as tse3
from reconstructor_tpu_torch.geometry import triangulation as ttri

from torch_parity import INTR, draws, t, two_view

H = 256


def assert_same_up_to_sign(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    err = min(np.abs(a - b).max(), np.abs(a + b).max())
    assert err <= atol, err


@pytest.mark.parametrize("seed, masked", [(0, False), (1, True)])
def test_estimate_fundamental_matches_jax(seed, masked):
    rng = np.random.default_rng(seed)
    uv1, uv2, *_ = two_view(rng, n=240, outliers=0.25, noise=0.3)
    mask = np.ones(len(uv1), bool)
    if masked:
        mask[::7] = False
    key = jax.random.PRNGKey(3 + seed)
    F_j, inl_j, cnt_j = jepi.estimate_fundamental(
        key, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask), thresh_px=3.0,
        num_hypotheses=H)
    F_t, inl_t, cnt_t = tepi.estimate_fundamental(
        t(uv1), t(uv2), t(mask), thresh_px=3.0, num_hypotheses=H, pos=t(draws(key, (H, 8))))
    np.testing.assert_array_equal(np.asarray(inl_j), inl_t.numpy())
    assert int(cnt_j) == int(cnt_t) > 150
    assert_same_up_to_sign(F_j, F_t.numpy(), 1e-4)


@pytest.mark.parametrize("essential", [False, True])
def test_refit_matches_jax(essential):
    """The all-inlier refit alone, on a given inlier set, and the guard
    that keeps the minimal model when the refit scores fewer inliers."""
    rng = np.random.default_rng(2)
    uv1, uv2, *_ = two_view(rng, n=200, outliers=0.2, noise=0.3)
    x1 = ((uv1 - INTR[2:4]) / INTR[:2]).astype(np.float32)
    x2 = ((uv2 - INTR[2:4]) / INTR[:2]).astype(np.float32)
    inl = np.zeros(200, bool)
    inl[40:] = True
    M_j = jepi._refit(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(inl), essential=essential)
    M_t = tepi._refit(t(x1), t(x2), t(inl), essential=essential)
    assert_same_up_to_sign(M_j, M_t.numpy(), 1e-4)

    thresh = (1.0 / 400.0) ** 2
    bad = np.eye(3, dtype=np.float32)         # a model no point fits: the refit wins
    mask = np.ones(200, bool)
    for M0, inl0, cnt0 in ((bad, inl, 0), (np.asarray(M_j), inl, 10 ** 6)):
        out_j = jepi._refit_if_better(jnp.asarray(M0), jnp.asarray(inl0), jnp.asarray(cnt0),
                                      jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
                                      thresh, essential=essential)
        out_t = tepi._refit_if_better(t(M0), t(inl0), torch.tensor(cnt0), t(x1), t(x2),
                                      t(mask), thresh, essential=essential)
        assert_same_up_to_sign(out_j[0], out_t[0].numpy(), 1e-4)
        np.testing.assert_array_equal(np.asarray(out_j[1]), out_t[1].numpy())
        assert int(out_j[2]) == int(out_t[2])


def test_estimate_essential_and_recover_pose_match_jax():
    # 0.05 px of noise keeps the inliers' Sampson distances far inside the
    # 1 px gate: at 0.2 px one of 240 points sat 0.2% from it, and the two
    # packages' float32 refits (3e-4 apart through the 9x9 nullspace and
    # the SVD projection) put it on either side
    rng = np.random.default_rng(8)
    uv1, uv2, pts, R, tr = two_view(rng, n=240, outliers=0.2, noise=0.05)
    mask = np.ones(len(uv1), bool)
    mask[-15:] = False
    key = jax.random.PRNGKey(1)
    intr = jnp.asarray(INTR)
    E_j, inl_j, cnt_j = jepi.estimate_essential(
        key, jnp.asarray(uv1), jnp.asarray(uv2), intr, intr, jnp.asarray(mask),
        thresh_px=1.0, num_hypotheses=H)
    E_t, inl_t, cnt_t = tepi.estimate_essential(
        t(uv1), t(uv2), t(INTR), t(INTR), t(mask), thresh_px=1.0, num_hypotheses=H,
        pos=t(draws(key, (H, 8))))
    np.testing.assert_array_equal(np.asarray(inl_j), inl_t.numpy())
    assert int(cnt_j) == int(cnt_t) > 150
    assert_same_up_to_sign(E_j, E_t.numpy(), 1e-3)

    pose_j, counts_j = jepi.recover_pose(E_j, jnp.asarray(uv1), jnp.asarray(uv2), intr, intr,
                                         inl_j)
    pose_t, counts_t = tepi.recover_pose(E_t, t(uv1), t(uv2), t(INTR), t(INTR), inl_t)
    np.testing.assert_array_equal(np.sort(np.asarray(counts_j)), np.sort(counts_t.numpy()))
    np.testing.assert_allclose(pose_t.numpy()[:3, :3], np.asarray(pose_j)[:3, :3], atol=1e-4)
    np.testing.assert_allclose(pose_t.numpy()[:3, 3], np.asarray(pose_j)[:3, 3], atol=1e-3)
    np.testing.assert_allclose(pose_t.numpy()[:3, :3], R, atol=2e-2)
    assert np.dot(pose_t.numpy()[:3, 3], tr / np.linalg.norm(tr)) > 0.99


def test_port_fgate_agrees_with_estimate_fundamental():
    """The port's own F-gate against its generic estimator on the same
    draws: the bar of the JAX package's test (``test_features_matching``,
    ``test_matches_generic_path_exactly``), >= 99.9% of slots."""
    rng = np.random.default_rng(3)
    B, K = 3, 512
    pts1 = np.zeros((B, K, 2), np.float32)
    pts2 = np.zeros((B, K, 2), np.float32)
    for b in range(B):
        uv1, uv2, *_ = two_view(rng, n=K, outliers=0.25, noise=0.3)
        pts1[b], pts2[b] = uv1, uv2
    mask = np.ones((B, K), bool)
    mask[1, ::5] = False
    pos = rng.integers(0, 2 ** 31 - 1, (B, H, 8)).astype(np.int32)
    gate = tfgate.filter_pairs_scalarized(t(pts1), t(pts2), t(mask), num_hypotheses=H,
                                          thresh_px=3.0, pos=t(pos)).numpy()
    generic = np.stack([
        ((tepi.sampson_distance(tepi.estimate_fundamental(
            t(pts1[b]), t(pts2[b]), t(mask[b]), thresh_px=3.0, num_hypotheses=H,
            pos=t(pos[b]))[0], t(pts1[b]), t(pts2[b])) < 9.0) & t(mask[b])).numpy()
        for b in range(B)])
    assert (gate == generic).mean() >= 0.999, (gate != generic).sum()
    assert gate.sum() > 0.6 * mask.sum()


def pnp_scene(rng, n=120, outliers=0.15):
    pts = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (n, 3)).astype(np.float32)
    R = np.asarray(jse3.angle_axis_to_rotation(jnp.asarray([0.05, -0.1, 0.03], jnp.float32)))
    tr = np.array([0.3, -0.1, 0.2], np.float32)
    pc = pts @ R.T + tr
    uv = (pc[:, :2] / pc[:, 2:] * INTR[:2] + INTR[2:4] + rng.normal(0, 0.3, (n, 2)))
    bad = rng.uniform(size=n) < outliers
    uv[bad] = rng.uniform([0, 0], [320, 240], (int(bad.sum()), 2))
    return pts, uv.astype(np.float32), R, tr, bad


def test_pnp_dlt6_matches_jax():
    rng = np.random.default_rng(7)
    pts, uv, R, tr, bad = pnp_scene(rng)
    mask = np.ones(len(pts), bool)
    mask[-10:] = False
    key = jax.random.PRNGKey(21)
    pose_j, inl_j, cnt_j = jpnp.solve_pnp_ransac(
        key, jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(INTR), jnp.asarray(mask),
        thresh_px=4.0, num_hypotheses=H, minimal="dlt6")
    pose_t, inl_t, cnt_t = tpnp.solve_pnp_ransac(
        t(pts), t(uv), t(INTR), t(mask), thresh_px=4.0, num_hypotheses=H,
        pos=t(draws(key, (H, 6))), minimal="dlt6")
    np.testing.assert_array_equal(np.asarray(inl_j), inl_t.numpy())
    assert int(cnt_j) == int(cnt_t) > 80
    np.testing.assert_allclose(np.asarray(pose_j)[:3, :3], pose_t.numpy()[:3, :3], atol=1e-4)
    np.testing.assert_allclose(np.asarray(pose_j)[:3, 3], pose_t.numpy()[:3, 3], atol=1e-3)
    np.testing.assert_allclose(pose_t.numpy()[:3, :3], R, atol=5e-3)
    # the minimal solver alone, batched, against the JAX one vmapped, in
    # float64: six points make an exactly determined 12 x 12 system whose
    # float32 nullspace moves by up to ~1e-2 between the two packages'
    # roundings, even on inliers
    idx = np.stack([rng.choice(np.flatnonzero(~bad), 6, replace=False) for _ in range(16)])
    xy = (uv.astype(np.float64) - INTR[2:4]) / INTR[:2]
    with jax.enable_x64(True):
        P_j = np.asarray(jax.vmap(jpnp._pnp_dlt)(jnp.asarray(pts[idx].astype(np.float64)),
                                                 jnp.asarray(xy[idx])))
    P_t = tpnp._pnp_dlt(t(pts[idx].astype(np.float64)), t(xy[idx])).numpy()
    assert P_t.dtype == np.float64
    np.testing.assert_allclose(P_t, P_j, atol=1e-9)
    # p3p stays the default
    with pytest.raises(ValueError):
        tpnp.solve_pnp_ransac(t(pts), t(uv), t(INTR), t(mask), minimal="dlt7")


def rotation_gap_deg(Ra, Rb):
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64)) / np.sqrt(8.0)
    return float(np.degrees(2.0 * np.arcsin(min(d, 1.0))))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pnp_dlt6_on_a_near_planar_registration(dtype):
    """A registration of the rendered 25-view scene's default-path run on
    an H100 (``chip_smoke.py --pnp-replay``: view 3's 927 landmark
    matches; the landmarks' spread is ~1.5% as thick as it is wide),
    through both packages on the card's draws (2,048 hypotheses). In float64 the DLT6 and P3P
    results are the JAX package's to 1e-9. In float32 the P3P results
    still are (1e-4 / 1e-3), but the DLT's 12 x 12 normal matrix
    (condition ~3e8) leaves the winning hypothesis to rounding, so each
    package is held to itself: its DLT6 pose, polished again over its
    DLT6 inliers beside its P3P pose polished likewise, lands on the P3P
    pose (within ``chip_smoke.py``'s 2e-3 degrees and 5e-5 of the
    distance); the gap before that polish is the Gauss-Newton polish's
    weighting by the few inliers of the DLT's hypothesis."""
    z = np.load(os.path.join(os.path.dirname(__file__), "data", "pnp_near_planar.npz"))
    X, uv, intr = (z[k].astype(dtype) for k in ("X", "uv", "intr"))
    mask = np.ones(len(X), bool)
    pos = {m: z[f"pos_{m}"] for m in ("p3p", "dlt6")}
    n_hyp = len(pos["p3p"])
    res_j, res_t = {}, {}
    original = jransac.sample_minimal_sets
    with jax.enable_x64(dtype == np.float64):
        for m in pos:
            def sample(key, msk, num_hypotheses, sample_size, p=pos[m]):
                order = jnp.argsort(~msk.astype(bool))
                return order[jnp.asarray(p) % jnp.maximum(jnp.sum(msk), 1)]
            jransac.sample_minimal_sets = sample
            try:
                pj, ij, _ = jpnp.solve_pnp_ransac(
                    jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(uv), jnp.asarray(intr),
                    jnp.asarray(mask), num_hypotheses=n_hyp, minimal=m)
            finally:
                jransac.sample_minimal_sets = original
            res_j[m] = (np.asarray(pj), np.asarray(ij))
            pt, it, _ = tpnp.solve_pnp_ransac(t(X), t(uv), t(intr), t(mask),
                                              num_hypotheses=n_hyp, pos=t(pos[m]), minimal=m)
            res_t[m] = (pt.numpy(), it.numpy())
        w = res_j["dlt6"][1].astype(dtype)
        polished_j = [np.asarray(jpnp._gauss_newton_refine(
            jnp.asarray(res_j[m][0]), jnp.asarray(X), jnp.asarray(uv), jnp.asarray(intr),
            jnp.asarray(w), 10)) for m in pos]
    assert res_t["p3p"][0].dtype == dtype
    np.testing.assert_array_equal(res_t["p3p"][1], res_j["p3p"][1])
    atol = (1e-9, 1e-9) if dtype == np.float64 else (1e-4, 1e-3)
    for m in (("p3p", "dlt6") if dtype == np.float64 else ("p3p",)):
        np.testing.assert_array_equal(res_t[m][1], res_j[m][1])
        np.testing.assert_allclose(res_t[m][0][:3, :3], res_j[m][0][:3, :3], atol=atol[0])
        np.testing.assert_allclose(res_t[m][0][:3, 3], res_j[m][0][:3, 3], atol=atol[1])
    w = t(res_t["dlt6"][1].astype(dtype))
    polished_t = [tpnp._gauss_newton_refine(t(res_t[m][0]), t(X), t(uv), t(intr), w, 10).numpy()
                  for m in pos]
    dist = float(np.linalg.norm(res_j["p3p"][0][:3, 3]))
    for pa, pb in (polished_j, polished_t):
        assert rotation_gap_deg(pa[:3, :3], pb[:3, :3]) <= 2e-3
        assert np.linalg.norm(pa[:3, :3].T @ pa[:3, 3] - pb[:3, :3].T @ pb[:3, 3]) <= 5e-5 * dist
    for res in (res_j, res_t):
        assert res["p3p"][1].sum() > 900 and res["dlt6"][1].sum() > res["p3p"][1].sum() // 2


def test_triangulate_one_point_matches_jax():
    rng = np.random.default_rng(4)
    X = np.array([0.3, -0.2, 6.0], np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 3)
    poses[1, :3, 3] = [-0.5, 0.0, 0.0]
    poses[2, :3, 3] = [0.4, 0.2, 0.1]
    intrs = np.tile(INTR, (3, 1))
    pc = X[None] + poses[:, :3, 3]
    uvs = (pc[:, :2] / pc[:, 2:] * INTR[:2] + INTR[2:4] + rng.normal(0, 0.2, (3, 2))
           ).astype(np.float32)
    for mask in (np.ones(3, bool), np.array([True, False, True])):
        uvs_m = uvs.copy()
        uvs_m[~mask] = 1e6
        p_j = np.asarray(jtri.triangulate(jnp.asarray(poses), jnp.asarray(intrs),
                                          jnp.asarray(uvs_m), jnp.asarray(mask)))
        p_t = ttri.triangulate(t(poses), t(intrs), t(uvs_m), t(mask)).numpy()
        np.testing.assert_allclose(p_t, p_j, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(p_t, X, atol=0.1)


def test_compose_focal_and_blur_match_jax():
    rng = np.random.default_rng(5)
    aa = rng.normal(0, 0.3, (2, 4, 3)).astype(np.float32)
    tr = rng.normal(0, 1, (2, 4, 3)).astype(np.float32)
    T = np.asarray(jse3.make_pose(jse3.angle_axis_to_rotation(jnp.asarray(aa)), jnp.asarray(tr)))
    np.testing.assert_allclose(tse3.compose(t(T[0]), t(T[1])).numpy(),
                               np.asarray(jse3.compose(jnp.asarray(T[0]), jnp.asarray(T[1]))),
                               rtol=1e-6, atol=1e-6)
    for mm, dim, fov in ((50.0, 512, 60.0), (35.0, 4000, 75.5), (24.0, 160, 90.0)):
        np.testing.assert_allclose(tcam.focal_mm_to_px(mm, dim, fov),
                                   float(jcam.focal_mm_to_px(mm, dim, fov)), rtol=1e-6)
    assert tcam.focal_mm_to_px(0.0, 100.0, 90.0) == 100.0 / (2.0 * np.tan(90.0 * 3.1415 / 360.0))

    for sigma, radius in ((1.6, 5), (0.7, 3)):
        np.testing.assert_allclose(tsift.gaussian_kernel1d(sigma, radius).numpy(),
                                   np.asarray(jsift.gaussian_kernel1d(sigma, radius)),
                                   rtol=1e-6, atol=1e-8)
    img = rng.uniform(0, 1, (2, 24, 40)).astype(np.float32)
    for sigma in (0.5, 1.6, 3.2):
        np.testing.assert_allclose(tsift.gaussian_blur(t(img), sigma).numpy(),
                                   np.asarray(jsift.gaussian_blur(jnp.asarray(img), sigma)),
                                   rtol=1e-5, atol=1e-6)
