"""Golden-cloud ATE of the PyTorch port against the JAX package, on the CPU.

Both are numpy/scipy code; the port reads PLY files through its own
``io/ply.load_cloud``. Input: the in-repo PLY ``out/cloud_fountain_ours.ply``
(PCL dialect, 10,715 landmarks and 25 green camera rows) as the golden
cloud, and estimated centres made from its cameras by a seeded similarity
transform plus noise. Every output agrees within 1e-9."""

import numpy as np
import pytest

from reconstructor_tpu.eval import ate as jate
from reconstructor_tpu.io import ply as jply
from reconstructor_tpu_torch.eval import ate as tate
from reconstructor_tpu_torch.io import ply as tply

GOLDEN = "out/cloud_fountain_ours.ply"


def estimated_centres(seed: int, n: int = 12, noise: float = 0.02):
    """n of the golden cameras in a random similarity frame, with noise."""
    pts, cols = tply.load_cloud(GOLDEN)
    _, cams = tate.split_golden_cloud(pts, cols)
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(cams.shape[0], n, replace=False))
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    q *= np.sign(np.linalg.det(q))
    est = 0.37 * cams[pick].astype(np.float64) @ q.T + rng.normal(0, 1.0, 3)
    return est + rng.normal(0, noise * 0.37, est.shape)


def assert_dicts_close(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-9, err_msg=k)


def test_load_and_split_equal_jax():
    pt, ct = tply.load_cloud(GOLDEN)
    pj, cj = jply.load_cloud(GOLDEN)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(ct, cj)
    assert tate.CAMERA_COLOR == jate.CAMERA_COLOR
    for a, b in zip(tate.split_golden_cloud(pt, ct), jate.split_golden_cloud(pj, cj)):
        np.testing.assert_array_equal(a, b)
    lm, cams = tate.split_golden_cloud(pt, ct)
    assert cams.shape == (25, 3) and lm.shape[0] == pt.shape[0] - 25


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alignment_equals_jax(seed):
    est = estimated_centres(seed)
    pts, cols = tply.load_cloud(GOLDEN)
    _, ref = tate.split_golden_cloud(pts, cols)
    for a, b in zip(tate._pca_frame(est), jate._pca_frame(est)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    for a, b in zip(tate.umeyama(est, ref[:12]), jate.umeyama(est, ref[:12])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    at, rt = tate.align_trajectories_icp(est, ref)
    aj, rj = jate.align_trajectories_icp(est, ref)
    np.testing.assert_allclose(at, aj, rtol=0, atol=1e-9)
    assert abs(rt - rj) <= 1e-9


@pytest.mark.parametrize("seed", [0, 1])
def test_ate_and_floor_equal_jax(seed):
    est = estimated_centres(seed)
    res_t = tate.ate_vs_golden(est, GOLDEN)
    assert_dicts_close(res_t, jate.ate_vs_golden(est, GOLDEN))
    assert res_t["num_ref"] == 25 and res_t["num_est"] == 12
    # 2% noise of a 0.37 scale frame, undone by the similarity: a few
    # percent of the trajectory extent
    assert res_t["ate_rmse_normalized"] < 0.1
    assert "ate_rmse_hungarian_normalized" in res_t
    floor_t = tate.ate_floor_vs_golden(est, GOLDEN)
    assert_dicts_close(floor_t, jate.ate_floor_vs_golden(est, GOLDEN))
    # golden camera points themselves align exactly
    assert floor_t["ate_floor_normalized"] < 1e-6


def test_golden_ate_tracks_pose_ate(tmp_path):
    """The check of ``chip_smoke.py``'s ate phase: a golden PLY written from
    true camera centres (the smoke scene's 25-view rig), estimated centres
    off them by seeded noise in another similarity frame. The golden
    cloud's correspondence-free ATE stays within a factor of 2 of
    ``synth.pose_ate``, which knows the correspondences: nearest-neighbour
    assignment can only flatter as errors approach the camera spacing
    (measured ratio 0.81-1.00 at 0.4-5.3% ATE; 0.46-0.75 at 6-12%)."""
    from reconstructor_tpu_torch.eval import render, synth
    poses = render.corner_rig(25, rng=np.random.default_rng(5))
    centres = tply.camera_centers(poses)
    extent = np.linalg.norm(centres.max(0) - centres.min(0))
    golden = str(tmp_path / "golden.ply")
    tply.save_cloud(golden, np.zeros((10, 3)), np.full((10, 3), 128, np.uint8), poses)
    for level in (0.005, 0.02, 0.05):
        for seed in range(4):
            rng = np.random.default_rng(seed)
            est = centres + rng.normal(0, level * extent / np.sqrt(3), centres.shape)
            q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
            est = 2.3 * est @ (q * np.sign(np.linalg.det(q))).T + 1.0
            est_poses = {i: np.eye(4) for i in range(25)}
            for i in range(25):
                est_poses[i][:3, 3] = -est[i]
            want = synth.pose_ate(est_poses, poses)["ate_rmse_normalized"]
            got = tate.ate_vs_golden(est, golden)["ate_rmse_normalized"]
            assert want / 2 <= got <= 2 * want, (level, seed, got, want)
