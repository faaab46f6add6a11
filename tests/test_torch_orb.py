"""The ORB front end of the PyTorch port against the JAX package, on the CPU.

FAST masks and scores, keypoint slots (positions, masks, scores) are
equal bit for bit: every step before the orientation (shifts, threshold
compares, the blur's power-of-two taps, NMS, the stable top-K) rounds the
same way in both. The orientation sums 225 products in another order, so
theta differs in its last bits (measured up to 1.3e-4 rad where the
intensity moments nearly cancel) and a rotated BRIEF sample that lies
within that of a pixel edge can truncate to the next pixel and flip its
bit: 1 of 133,120 bits on the rendered batch below. The tests bound the
flip rate and trace every flipped bit to such a sample.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from reconstructor_tpu.config import ReconstructorConfig as JaxConfig
from reconstructor_tpu.features import orb as jorb
from reconstructor_tpu.pipeline.incremental import IncrementalReconstructor as JaxRec
from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.eval import render, synth
from reconstructor_tpu_torch.features import orb as torb
from reconstructor_tpu_torch.matching import cuda_knn, knn
from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor

import torch_parity
from test_features_matching import make_blob_image


@pytest.fixture(scope="module")
def rendered():
    """Three rendered 192x256 views, detected by both packages."""
    sc = render.make_scene(seed=0, n_views=3, h=192, w=256, n_blobs=200, tex_size=512,
                           focal_px=307.2)
    gray = np.stack(sc["images"]).astype(np.float32)
    shapes = np.array([gray.shape[1:]] * 3, np.int32)
    fj = jorb.detect_and_describe(jnp.asarray(gray), jnp.asarray(shapes), max_keypoints=512)
    ft = torb.detect_and_describe(torch.from_numpy(gray), torch.from_numpy(shapes),
                                  max_keypoints=512)
    return gray, fj, ft


def test_fast_score_equals_jax():
    rng = np.random.default_rng(0)
    gray = rng.uniform(0, 1, (3, 96, 128)).astype(np.float32)
    gray[1] = (gray[1] > 0.5).astype(np.float32)      # hard edges: long arcs
    for thr in (0.06, 0.2):
        cj, sj = jorb.fast_score(jnp.asarray(gray), thr)
        ct, st = torb.fast_score(torch.from_numpy(gray), thr)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert ct.sum() > 100
        # the same 16 absolute differences summed in the same order
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-6)


def test_keypoint_slots_equal_jax(rendered):
    _, fj, ft = rendered
    for f in ("xy", "score", "mask", "scale"):
        np.testing.assert_array_equal(getattr(ft, f).numpy(), np.asarray(getattr(fj, f)), f)
    assert ft.mask.sum() > 300


def test_descriptor_bits_agree_and_flips_are_pixel_edges(rendered):
    gray, fj, ft = rendered
    m = np.asarray(fj.mask)
    dj, dt = np.asarray(fj.desc), ft.desc.numpy()
    assert set(np.unique(dt)) <= {-1 / 16, 0.0, 1 / 16}
    np.testing.assert_array_equal(dt[~m], 0.0)
    agree = (dj == dt)[m].mean()
    assert agree >= 0.999, agree                    # measured 0.9999925

    # orientations of both packages on the same blurred images
    smooth = torch.nn.functional.conv2d(
        torch.nn.functional.conv2d(torch.from_numpy(gray)[:, None],
                                   torch.tensor([[[[0.25, 0.5, 0.25]]]]), padding=(0, 1)),
        torch.tensor([[[[0.25], [0.5], [0.25]]]]), padding=(1, 0))[:, 0]
    th_t = torb._orientation(smooth, ft.xy).numpy()
    th_j = np.asarray(jax.vmap(lambda img, xy: jax.vmap(
        lambda p: jorb._orientation(img, p))(xy))(jnp.asarray(smooth.numpy()), fj.xy))
    np.testing.assert_allclose(th_t[m], th_j[m], rtol=0, atol=1e-3)   # measured 1.3e-4

    # every flipped bit: one of its four samples, placed with either
    # package's theta, truncates to another pixel, the two positions
    # within 1e-3 px (15 px offsets x the theta difference)
    xy = ft.xy.numpy().astype(np.float64)
    P = torb._PATTERN.astype(np.float64)
    for n, k, b in zip(*np.nonzero((dj != dt) & m[..., None])):
        pos = []
        for th in (np.float64(th_j[n, k]), np.float64(th_t[n, k])):
            c, s = np.cos(th), np.sin(th)
            ox, oy = P[b, [0, 2]], P[b, [1, 3]]
            pos.append(np.concatenate([xy[n, k, 0] + c * ox - s * oy,
                                       xy[n, k, 1] + s * ox + c * oy]))
        pj, pt = pos
        crosses = np.trunc(pj) != np.trunc(pt)
        assert crosses.any() and np.abs(pj - pt)[crosses].max() < 1e-3, (n, k, b, pj, pt)


def test_descriptors_are_exact_in_bf16(rendered):
    """Every entry is +-1/16 or 0, so bf16 holds it exactly and the kNN in
    bf16 equals the kNN in f32, ties included (the card's kernel 1 runs
    bf16 on ORB descriptors)."""
    _, _, ft = rendered
    desc = ft.desc.contiguous()
    assert torch.equal(desc.to(torch.bfloat16).float(), desc)
    bias = torch.where(ft.mask, 0.0, 1e30).to(torch.float32)
    pairs = torch.tensor([[0, 1], [0, 2], [1, 2]], dtype=torch.int32)
    out32 = cuda_knn.knn_topk2_plain(desc, bias, pairs)
    out16 = cuda_knn.knn_topk2_plain(desc.to(torch.bfloat16), bias, pairs)
    for a, b in zip(out32, out16):
        assert torch.equal(a, b)


def test_fast_detects_corners():
    """tests/test_features_matching.py::TestOrb on the port."""
    img = np.zeros((96, 96), np.float32)
    img[30:60, 30:60] = 1.0
    feats = torb.detect_and_describe(torch.from_numpy(img)[None],
                                     torch.tensor([[96, 96]], dtype=torch.int32),
                                     max_keypoints=64)
    xy = feats.xy[0][feats.mask[0]].numpy()
    assert xy.shape[0] >= 4
    corners = np.array([[30, 30], [30, 59], [59, 30], [59, 59]], float)
    d = np.linalg.norm(corners[:, None] - xy[None], axis=-1).min(axis=1)
    assert (d < 4.0).mean() >= 0.75


def test_orb_translation_matching():
    """tests/test_features_matching.py::TestOrb on the port."""
    rng = np.random.default_rng(7)
    img, _ = make_blob_image(rng)
    img = (img > 0.4).astype(np.float32)
    dy, dx = 5, 8
    img2 = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
    feats = torb.detect_and_describe(torch.from_numpy(np.stack([img, img2])),
                                     torch.tensor([[128, 160]] * 2, dtype=torch.int32),
                                     max_keypoints=256)
    midx, mmask = knn.match_pair(feats.desc[0], feats.desc[1], feats.mask[0], feats.mask[1],
                                 ratio_thresh=0.9)
    midx, mmask = midx.numpy(), mmask.numpy()
    assert mmask.sum() >= 10
    d = feats.xy[1].numpy()[midx[mmask]] - feats.xy[0].numpy()[mmask]
    good = (np.abs(d - np.array([dx, dy])) <= 1.5).all(axis=1)
    assert good.mean() > 0.7


def test_driver_orb_run_like_jax(tmp_path):
    """The reconstructor with ``detector="orb"`` on five views of the
    smoke scene at a 5.25 degree step (ORB does not initialise at the
    scene's 1.75 degree step, in either package), both packages reading
    the same PNG folder: the same registered views, landmarks within 5%
    (measured 697 and 697), both trajectories close to the rendered one
    (measured 0.37% and 0.21% normalised ATE)."""
    gray, poses = torch_parity.smoke_views([0, 3, 6, 9, 12])
    for i, im in enumerate(gray):
        Image.fromarray(np.repeat((im * 255).astype(np.uint8)[..., None], 3, -1)).save(
            str(tmp_path / f"{i:02d}.png"))
    kw = dict(detector="orb", max_keypoints=1024, ransac_num_hypotheses=256,
              pnp_num_hypotheses=256, fundamental_num_hypotheses=128,
              final_refinement_rounds=1)
    ts = IncrementalReconstructor(ReconstructorConfig(**kw), verbose=False,
                                  device="cpu").reconstruct(str(tmp_path))
    js = JaxRec(JaxConfig(**kw), verbose=False).reconstruct(str(tmp_path))
    assert sorted(ts.registered) == sorted(js.registered) == list(range(5))
    assert abs(ts.num_landmarks - js.num_landmarks) <= 0.05 * js.num_landmarks
    for st in (ts, js):
        assert synth.pose_ate(st.poses, poses)["ate_rmse_normalized"] < 0.02

