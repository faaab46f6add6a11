"""Visualisations of the PyTorch port against the JAX package, on the CPU,
and the port's command line with the flags that use them and the
checkpoint / golden-ATE flags.

``draw_pair_matches`` and ``draw_keypoints`` draw the same pixels as the
JAX package's (both PIL); ``render_cloud`` writes a PNG (matplotlib)."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from reconstructor_tpu.utils import viz as jviz
from reconstructor_tpu_torch import cli
from reconstructor_tpu_torch.io import ply
from reconstructor_tpu_torch.utils import viz as tviz

import torch_parity  # noqa: F401  (two torch threads per worker)
from test_integration import render_synthetic_views


def test_draw_pair_matches_equal_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
    xy1 = rng.uniform(0, [80, 60], (25, 2)).astype(np.float32)
    xy2 = rng.uniform(0, [70, 50], (25, 2)).astype(np.float32)
    got = np.asarray(tviz.draw_pair_matches(a, b, xy1, xy2))
    want = np.asarray(jviz.draw_pair_matches(a, b, xy1, xy2))
    assert got.shape == (60, 150, 3)
    np.testing.assert_array_equal(got, want)
    assert (got != np.concatenate([a, np.pad(b, ((0, 10), (0, 0), (0, 0)))], 1)).any()


def test_draw_keypoints_equal_jax():
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    xy = rng.uniform(3, 60, (30, 2)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(tviz.draw_keypoints(rgb, xy)),
                                  np.asarray(jviz.draw_keypoints(rgb, xy)))


def test_render_cloud_writes_png(tmp_path):
    out = str(tmp_path / "render.png")
    tviz.render_cloud("out/cloud_fountain_ours.ply", out)
    with Image.open(out) as im:
        assert im.format == "PNG" and im.size[0] > im.size[1] > 100


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """tests/test_torch_pipeline.py's folder (4 rendered 256x320 views) and
    a golden PLY of its true camera centres (green rows, PCL dialect)."""
    imgs, poses, _, pts = render_synthetic_views(np.random.default_rng(11))
    d = tmp_path_factory.mktemp("views")
    for i, im in enumerate(imgs):
        Image.fromarray((im * 255).astype(np.uint8)).convert("RGB").save(str(d / f"{i:02d}.png"))
    golden = str(d.parent / "golden.ply")
    ply.save_cloud(golden, pts, np.full((len(pts), 3), 128, np.uint8), poses)
    return str(d), golden


def test_cli_checkpoint_resume_ate_and_drawings(scene, tmp_path, capsys):
    folder, golden = scene
    out = str(tmp_path / "out")
    ckpt = str(tmp_path / "state.npz")
    base = [folder, out, "--device", "cpu", "--max-keypoints", "256", "--focal-px", "300",
            "--final-refinement", "1", "--checkpoint", ckpt]
    assert cli.main(base + ["--quiet", "--save-matches", "--render", "--eval-ate", golden]) == 0
    text = capsys.readouterr().out
    assert "registered 4/4 views" in text
    res = json.loads(text[text.index("{"):])
    assert res["num_est"] == 4 and res["num_ref"] == 4
    assert res["ate_rmse_normalized"] < 0.10
    assert os.path.exists(ckpt)
    pairs = sorted(os.listdir(os.path.join(out, "matches")))
    assert pairs and all(p.startswith("pair") and p.endswith(".JPG") for p in pairs)
    assert os.path.getsize(os.path.join(out, "render.png")) > 0

    # --resume continues from the final autosave: nothing left to register
    assert cli.main(base + ["--resume"]) == 0
    text = capsys.readouterr().out
    assert "resumed from" in text and "4 views registered" in text
    assert "registered 4/4 views" in text
