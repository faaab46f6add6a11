"""The learned path of the PyTorch port against the JAX package, on the CPU.

The scene and settings of ``tests/test_learned_e2e.py``: eight rendered
160x160 views (``make_scene(seed=21)``) written to disk, the trained
``tests/data/superpoint_synth.npz`` detector, the structured 18-layer
SuperGlue, 256 keypoints, 50 Sinkhorn iterations, a global BA after
every view and one refinement round.

Both reconstructors run the detection stage: their states agree within the
SuperPoint tolerances of ``tests/test_torch_superpoint.py``, with one
allowance. Slots are sorted by score, and where two scores lie within
float32 rounding of each other the two packages may order them
differently (seen here: view 7 holds scores 0.5476396 and 0.5476367,
2.9e-6 apart, and the port's ~1.5e-6 rounding swaps them). So each view
must hold the same keypoints, and a keypoint may sit in another slot only
among scores equal to 1e-4. Then both reconstructors run ``_match_superglue``
over all 28 pairs on the same detected features (the JAX package's), and
the match tables are equal index for index. Then the port alone takes
its own state through the whole reconstruction, so the JAX package's
cost stays at those two stages; it must meet ``test_learned_e2e``'s bar.
"""

import os

import numpy as np
import pytest
from PIL import Image

from reconstructor_tpu.config import ReconstructorConfig as JaxConfig
from reconstructor_tpu.pipeline.incremental import IncrementalReconstructor as JaxRec
from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.eval import render, synth
from reconstructor_tpu_torch.matching import pairs as pairing
from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
from reconstructor_tpu_torch.pipeline.state import ReconstructionState

import torch_parity  # (two torch threads per worker)

WEIGHTS = os.path.join(os.path.dirname(__file__), "data", "superpoint_synth.npz")
SETTINGS = dict(detector="superpoint", superpoint_weights=WEIGHTS,
                matcher="superglue", superglue_weights="structured",
                max_keypoints=256, focal_px=170.0, superglue_sinkhorn_iters=50,
                ba_local_window=0, final_refinement_rounds=1)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    scene = render.make_scene(seed=21, n_views=8, h=160, w=160)
    d = tmp_path_factory.mktemp("learned_scene")
    for i, im in enumerate(scene["images"]):
        arr = np.clip(im * 255.0, 0, 255).astype(np.uint8)
        Image.fromarray(np.stack([arr] * 3, axis=-1)).save(d / f"{i:04d}.png")
    return d, scene


def test_learned_path_equals_jax_then_reconstructs(scene_dir, tmp_path):
    img_dir, scene = scene_dir
    jrec = JaxRec(JaxConfig(**SETTINGS), verbose=False)
    trec = IncrementalReconstructor(ReconstructorConfig(**SETTINGS), verbose=False,
                                    device="cpu")
    js = jrec.detect_features(str(img_dir))
    ts = trec.detect_features(str(img_dir))

    # detection: the same keypoints per view, slots traded only among
    # near-equal scores; floats within SuperPoint's tolerances
    np.testing.assert_array_equal(ts.kp_mask, js.kp_mask)
    assert ts.kp_mask.sum(1).min() > 50
    swapped = 0
    for n in range(8):
        valid = js.kp_mask[n]
        where = {tuple(p): k for k, p in enumerate(js.xy[n][valid])}
        perm = np.array([where[tuple(p)] for p in ts.xy[n][valid]])
        moved = perm != np.arange(perm.size)
        swapped += int(moved.sum())
        np.testing.assert_allclose(js.kp_score[n][perm[moved]], js.kp_score[n][:perm.size][moved],
                                   rtol=1e-4, atol=0)
        np.testing.assert_allclose(ts.kp_score[n][valid], js.kp_score[n][valid][perm],
                                   rtol=1e-4, atol=0)
        np.testing.assert_allclose(ts.desc[n][valid], js.desc[n][valid][perm], atol=1e-4)
        np.testing.assert_array_equal(ts.colors[n][valid], js.colors[n][valid][perm])
    assert swapped <= 4
    np.testing.assert_allclose(ts.intrinsics, js.intrinsics, rtol=1e-6)

    # SuperGlue over all 28 pairs on the same detected features
    pair_idx = pairing.exhaustive_pairs(8)
    assert pair_idx.shape == (28, 2)
    same = ReconstructionState(num_images=8, max_keypoints=256, xy=js.xy, desc=js.desc,
                               kp_mask=js.kp_mask, colors=js.colors, shapes=js.shapes,
                               intrinsics=js.intrinsics, kp_score=js.kp_score)
    jm, jmask = jrec._match_superglue(js, pair_idx)
    tm, tmask = trec._match_superglue(same, pair_idx)
    np.testing.assert_array_equal(tmask, np.asarray(jmask))
    np.testing.assert_array_equal(np.where(tmask, tm, -1), np.where(jmask, jm, -1))
    assert tmask.sum() > 500

    # the port alone through the reconstruction: test_learned_e2e's bar
    state = trec.reconstruct_from_state(ts, out_folder=str(tmp_path / "out"))
    assert len(state.registered) == 8, f"registered {len(state.registered)}/8 views"
    assert state.num_landmarks > 60
    res = synth.pose_ate(state.poses, scene["poses"])
    assert res["ate_rmse_normalized"] < 0.10, res
    assert (tmp_path / "out" / "clouds" / "cloud_final.ply").exists()


def test_cli_runs_the_learned_path(scene_dir, tmp_path, capsys):
    """The command line reaches the learned path with the flags the
    README gives, and ORB with ``--detector orb``. ORB does not initialise
    on this scene in either package (its best pair cannot triangulate), so
    the ORB run takes five views of the smoke scene at a 5.25 degree step
    (``test_torch_orb.py``'s folder, where the JAX package registers 5/5)."""
    import json

    from reconstructor_tpu_torch import cli

    img_dir, _ = scene_dir
    out = tmp_path / "cli_out"
    args = [str(img_dir), str(out), "--device", "cpu", "--detector", "superpoint",
            "--matcher", "superglue", "--superpoint-weights", WEIGHTS,
            "--superglue-weights", "structured", "--max-keypoints", "256",
            "--focal-px", "170", "--local-ba-window", "0", "--final-refinement", "1",
            "--quiet"]
    assert cli.main(args) == 0
    assert "registered 8/8 views" in capsys.readouterr().out
    report = json.loads((out / "report.json").read_text())
    assert report["config"]["detector"] == "superpoint"
    assert report["config"]["superglue_weights"] == "structured"
    assert (out / "clouds" / "cloud_final.ply").exists()

    gray, _ = torch_parity.smoke_views([0, 3, 6, 9, 12])
    orb_dir = tmp_path / "orb_views"
    orb_dir.mkdir()
    for i, im in enumerate(gray):
        Image.fromarray(np.repeat((im * 255).astype(np.uint8)[..., None], 3, -1)).save(
            orb_dir / f"{i:02d}.png")
    orb_out = tmp_path / "orb_out"
    assert cli.main([str(orb_dir), str(orb_out), "--device", "cpu", "--detector", "orb",
                     "--max-keypoints", "1024", "--final-refinement", "1", "--quiet"]) == 0
    assert "registered 5/5 views" in capsys.readouterr().out
    assert json.loads((orb_out / "report.json").read_text())["config"]["detector"] == "orb"
