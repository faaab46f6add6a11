"""File input and output of the PyTorch port against the JAX package, on
the CPU.

Both packages decode a JPEG folder through the native libjpeg loader
(``native/libreconstructor_native.so``: DCT-domain prescale, then a
bilinear resize) whenever that library loads, and through PIL otherwise;
both write PLY files through its writer when it loads and through numpy
otherwise. These tests hold the port to the JAX package on whichever
branch this machine takes, and on the numpy writer as well.
"""

import numpy as np
import pytest
from PIL import Image

from reconstructor_tpu.config import ReconstructorConfig as JaxConfig
from reconstructor_tpu.io import images as jax_images
from reconstructor_tpu.io import native as jax_native
from reconstructor_tpu.io import ply as jax_ply
from reconstructor_tpu.pipeline.incremental import IncrementalReconstructor as JaxRec
from reconstructor_tpu_torch.config import ReconstructorConfig as TorchConfig
from reconstructor_tpu_torch.io import images as torch_images
from reconstructor_tpu_torch.io import native as torch_native
from reconstructor_tpu_torch.io import ply as torch_ply
from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor as TorchRec

import torch_parity  # noqa: F401  (sets the worker's torch thread count)

KW = dict(max_keypoints=256)


@pytest.fixture(scope="module")
def jpeg_folder(tmp_path_factory):
    """Three seeded 1536x2048 JPEGs: coarse random colour fields blown up
    bicubically (smooth blobs with corners for SIFT) plus fine noise."""
    rng = np.random.default_rng(41)
    d = tmp_path_factory.mktemp("jpegs")
    for i in range(3):
        coarse = rng.uniform(0, 255, (24, 32, 3)).astype(np.uint8)
        im = np.asarray(Image.fromarray(coarse).resize((2048, 1536), Image.BICUBIC), np.float32)
        im = np.clip(im + rng.normal(0, 4, im.shape), 0, 255).astype(np.uint8)
        Image.fromarray(im).save(str(d / f"{i:02d}.jpg"), quality=90)
    return str(d)


def test_both_packages_take_the_same_branch():
    assert torch_native.available() == jax_native.available()


def test_load_folder_equals_jax(jpeg_folder):
    """Equal decoded pixels, shapes and downscale factor, image by image."""
    want = jax_images.load_folder(jpeg_folder, 512)
    got = torch_images.load_folder(jpeg_folder, 512)
    assert [g.path for g in got] == [w.path for w in want]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (384, 512)
        assert g.downscale == w.downscale
        np.testing.assert_array_equal(g.rgb, w.rgb)
        np.testing.assert_array_equal(g.gray, w.gray)
    if torch_native.available():
        assert all(g.downscale == 1.0 for g in got)     # the native branch's rule


def test_sift_on_the_jpeg_folder_equals_jax(jpeg_folder):
    """The port's folder decode and SIFT give the JAX package's keypoints:
    the same slots, and positions within 1e-4 px on >= 95% of coordinates.
    The two packages' scale spaces differ by float32 rounding (<= 1e-6,
    tests/test_torch_sift.py); on these noisy JPEGs the sub-pixel fit
    amplifies that where the DoG Hessian is nearly singular (measured:
    up to 1.1e-3 px, on 3.5% of coordinates), so every position is held
    within 5e-3 px; descriptors within 1e-4, as in the PNG-folder test
    (measured 2.8e-5)."""
    js = JaxRec(JaxConfig(**KW), verbose=False).detect_features(jpeg_folder)
    ts = TorchRec(TorchConfig(**KW), verbose=False, device="cpu").detect_features(jpeg_folder)
    np.testing.assert_array_equal(ts.kp_mask, js.kp_mask)
    m = ts.kp_mask
    assert m.sum() > 50
    err = np.abs(ts.xy[m] - js.xy[m])
    assert (err <= 1e-4).mean() >= 0.95, (err > 1e-4).mean()
    assert err.max() <= 5e-3, err.max()
    np.testing.assert_allclose(ts.desc[m], js.desc[m], atol=1e-4)
    np.testing.assert_array_equal(ts.colors, js.colors)


@pytest.mark.parametrize("writer", ["as_loaded", "numpy"])
def test_save_cloud_writes_the_same_bytes(tmp_path, monkeypatch, writer):
    """Landmarks with outliers painted red, then green camera centres: the
    same file, byte for byte, from the native writer where it loads and
    from the numpy writer with the library switched off in both."""
    if writer == "numpy":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(torch_native, "available", lambda: False)
    rng = np.random.default_rng(42)
    pts = rng.normal(0, 3, (257, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (257, 3)).astype(np.uint8)
    inl = rng.uniform(size=257) < 0.8
    poses = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    poses[:, :3, 3] = rng.normal(0, 1, (4, 3))
    a, b = str(tmp_path / "jax.ply"), str(tmp_path / "torch.ply")
    jax_ply.save_cloud(a, pts, cols, poses, inl)
    torch_ply.save_cloud(b, pts, cols, poses, inl)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    p, c = torch_ply.load_cloud(b)
    assert p.shape == (261, 3) and (c[-4:] == (0, 250, 0)).all()
