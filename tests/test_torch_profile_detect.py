"""The port's SIFT stage profile (``scripts/profile_detect.py``) against
the JAX package on the CPU, on ``test_integration``'s rendered views (2 of
its 4 views of 256x320, ``max_keypoints=256``).

``profile_detect``'s stages equal the same stages built from the JAX
package's ``sift`` functions, as the TPU script builds them: scale space
within 1e-6, the score volume within 1e-7 and equal in support, the top-k
values within 1e-7 and the indices equal (both a stable descending order:
the lowest flat index first among equal scores), the detected slots
equal, positions within 1e-5, descriptors within 1e-4 on the valid slots
and the pitch-resampled levels within 1e-5. ``profile`` times every stage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconstructor_tpu.features import sift as jsift
from reconstructor_tpu_torch.config import ReconstructorConfig as TorchConfig
from reconstructor_tpu_torch.io import images as io_images
from reconstructor_tpu_torch.scripts import profile_detect as tpd

from torch_parity import MEASURE_KW as KW, rendered_folder, time_limit


@pytest.fixture(scope="module")
def detect_batch(tmp_path_factory):
    folder, _, _ = rendered_folder(tmp_path_factory.mktemp("views"))
    gray, shapes, _ = io_images.pad_batch(io_images.load_folder(folder, 512))
    return gray[:2], shapes[:2]


def jax_stages(gray, shapes, cfg):
    """The TPU script's stages (``profile_detect.py:43-96``), built from the
    JAX package's ``sift`` functions."""
    S = cfg.sift_num_scales
    g, s = jnp.asarray(gray), jnp.asarray(shapes)
    gauss, _ = jsift.build_scale_space(g, S, sigma0=cfg.sift_sigma0)
    dog = gauss[:, 1:] - gauss[:, :-1]
    extrema = jsift._neighborhood_extrema(dog)
    contrast_ok = jnp.abs(dog[:, 1:-1]) > cfg.sift_contrast_thresh
    edge_ok = jax.vmap(lambda d: jsift._edge_response_ok(d, cfg.sift_edge_thresh),
                       in_axes=1, out_axes=1)(dog[:, 1:-1])
    score_vol = jnp.where(extrema & contrast_ok & edge_ok, jnp.abs(dog[:, 1:-1]), 0.0)
    pad = jnp.pad(score_vol, ((0, 0), (0, 0), (1, 1), (1, 1)))
    rows = jnp.maximum(jnp.maximum(pad[:, :, :-2, :], pad[:, :, 1:-1, :]), pad[:, :, 2:, :])
    lm = jnp.maximum(jnp.maximum(rows[:, :, :, :-2], rows[:, :, :, 1:-1]), rows[:, :, :, 2:])
    sv = jnp.where(score_vol >= lm, score_vol, 0.0)
    vals, idx = jax.lax.top_k(sv.reshape(sv.shape[0], -1), cfg.max_keypoints)
    xy, _, _, mask, gauss2, sigmas2, s_idx = jsift.detect_keypoints(
        g, s, cfg.max_keypoints, S, cfg.sift_contrast_thresh, cfg.sift_edge_thresh,
        sigma0=cfg.sift_sigma0)
    sigma_list = [cfg.sift_sigma0 * (2.0 ** (i / 3.0)) for i in range(S)]
    desc = jax.vmap(jsift.compute_descriptors, in_axes=(0, 0, 0, None, None))(
        gauss2, xy, s_idx, sigmas2, sigma_list)
    resampled = jax.vmap(lambda gi: jsift._resample_pitch_levels(gi, sigma_list, 1,
                                                                 max(2, S - 2))[0])(gauss2)
    out = {"gauss": gauss, "score_vol": score_vol, "topk_values": vals, "topk_indices": idx,
           "xy": xy, "mask": mask, "s_idx": s_idx, "desc": desc, "resampled": resampled}
    return {k: np.asarray(v) for k, v in out.items()}


@time_limit(60)
def test_sift_stages_equal_jax(detect_batch):
    gray, shapes = detect_batch
    cfg = TorchConfig(**KW)
    ref = jax_stages(gray, shapes, cfg)
    got = {k: v for k, v in tpd.stages(torch.from_numpy(gray), torch.from_numpy(shapes),
                                       cfg).items() if k != "features"}
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_allclose(got["gauss"], ref["gauss"], atol=1e-6)
    np.testing.assert_array_equal(got["score_vol"] > 0, ref["score_vol"] > 0)
    np.testing.assert_allclose(got["score_vol"], ref["score_vol"], atol=1e-7)
    np.testing.assert_allclose(got["topk_values"], ref["topk_values"], atol=1e-7)
    np.testing.assert_array_equal(got["topk_indices"], ref["topk_indices"])
    mask = ref["mask"]
    assert mask.sum() > 300
    np.testing.assert_array_equal(got["mask"], mask)
    np.testing.assert_array_equal(got["s_idx"][mask], ref["s_idx"][mask])
    np.testing.assert_allclose(got["xy"][mask], ref["xy"][mask], atol=1e-5)
    np.testing.assert_allclose(got["desc"][mask], ref["desc"][mask], atol=1e-4)
    np.testing.assert_allclose(got["resampled"], ref["resampled"], atol=1e-5)


def test_profile_detect_times_every_stage(detect_batch):
    gray, shapes = detect_batch
    res = tpd.profile(gray, shapes, TorchConfig(**KW), "cpu", reps=2)
    keys = ("scale_space_ms", "dog_gates_ms", "nms_topk_ms", "detect_ms", "descriptors_ms",
            "resample_ms", "full_ms")
    assert all(np.isfinite(res[k]) and res[k] > 0 for k in keys)
    assert res["imgs_per_s"] > 0


