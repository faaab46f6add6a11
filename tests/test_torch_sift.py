"""SIFT frontend of the PyTorch port against the JAX package, on the CPU,
at the shapes of ``__graft_entry__.entry`` (2 images of 128x160, K=128,
6 scales) and on a rendered scene."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from reconstructor_tpu.features import sift as jsift
from reconstructor_tpu_torch.eval import render
from reconstructor_tpu_torch.features import sift as tsift

import torch_parity  # noqa: F401  (sets the worker's torch thread count)


def _inputs(kind):
    if kind == "noise":
        gray = np.random.default_rng(0).uniform(0, 1, (2, 128, 160)).astype(np.float32)
        shapes = np.array([[128, 160], [128, 160]], np.int32)
    else:
        sc = render.make_scene(seed=3, n_views=2, h=128, w=160, n_blobs=300,
                               tex_size=512, focal_px=120.0)
        gray = sc["images"].astype(np.float32)
        gray[1, 100:] = 0.0                          # a padded (smaller) image
        shapes = np.array([[128, 160], [100, 160]], np.int32)
    return gray, shapes


@pytest.fixture(scope="module", params=["noise", "rendered"])
def both(request):
    gray, shapes = _inputs(request.param)
    fj = jsift.detect_and_describe(jnp.asarray(gray), jnp.asarray(shapes),
                                   max_keypoints=128, num_scales=6)
    ft = tsift.detect_and_describe(torch.from_numpy(gray), torch.from_numpy(shapes),
                                   max_keypoints=128, num_scales=6)
    return gray, fj, ft


def test_scale_space_matches(both):
    gray = both[0]
    g_j, s_j = jsift.build_scale_space(jnp.asarray(gray), 6, sigma0=0.8)
    g_t, s_t = tsift.build_scale_space(torch.from_numpy(gray), 6, sigma0=0.8)
    # band matrices are the same float64-composed constants; the two
    # contractions differ only in float32 summation order
    np.testing.assert_allclose(np.asarray(g_j), g_t.numpy(), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(s_j), s_t.numpy())


def test_keypoint_slots_equal(both):
    _, fj, ft = both
    mask = np.asarray(fj.mask)
    # slot order (valid-first, score-descending, lowest index on ties) and
    # the validity mask are index outputs: equal
    np.testing.assert_array_equal(mask, ft.mask.numpy())
    assert mask.sum() > 0
    for m in mask:                                    # valid keypoints are a prefix
        assert not m[m.argmin():].any() or m.all()
    np.testing.assert_allclose(np.asarray(fj.score), ft.score.numpy(), atol=1e-7)
    np.testing.assert_allclose(np.asarray(fj.xy)[mask], ft.xy.numpy()[mask], atol=1e-5)
    np.testing.assert_array_equal(np.asarray(fj.scale), ft.scale.numpy())


def test_descriptors_match(both):
    _, fj, ft = both
    mask = np.asarray(fj.mask)
    dj = np.asarray(fj.desc)[mask]
    dt = ft.desc.numpy()[mask]
    # unit descriptors; the orientation histogram sums in another order,
    # which could flip the dominant bin on an exact tie: require 1e-4 on
    # all of them here (measured ~4e-7)
    np.testing.assert_allclose(dj, dt, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(dt, axis=1), 1.0, atol=1e-5)
    assert not ft.desc.numpy()[~mask].any()          # masked slots are zero
