"""Stage profile of the classic (SIFT) detection path on one batch.

The counterpart of the TPU package's ``scripts/profile_detect.py``: the
fountain batch (25 images padded to one shape) through each stage of
``features/sift.py`` alone, then the whole:

- scale space (``build_scale_space``);
- DoG + gates: the difference of Gaussians, the 26-neighbourhood
  extremum test, the contrast gate and the Hessian edge gate, as a score
  volume;
- NMS + top-k: the 3x3 non-maximum suppression of that volume and the
  top ``max_keypoints`` of each image, by a stable descending sort (the
  lowest flat index first among equal scores, ``lax.top_k``'s order, as
  ``detect_keypoints`` selects);
- detect (all of ``detect_keypoints``);
- descriptors (``compute_descriptors`` on the detected keypoints), and
  the pitch resampling alone (``_resample_pitch_levels``);
- full (``detect_and_describe``), and images/s from it.

Each stage runs twice untimed, then ``reps`` times back to back; the
window closes with a device synchronisation, where the TPU script reads
one element of the result back to the host. ``stages`` returns each
stage's outputs, so a test can hold them against the TPU package's.

``main()`` loads ``reference/data`` inside the repository and stops with
a message naming the folder while the photographs are not there;
``profile`` takes a gray batch and its shapes. Runs on the card unless
given ``--device cpu``.

    python -m reconstructor_tpu_torch.scripts.profile_detect [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Optional

import torch

from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.features import sift
from reconstructor_tpu_torch.scripts import distill_fountain
from reconstructor_tpu_torch.scripts.measure_match100 import sync
from reconstructor_tpu_torch.utils import device as devices


def timeit(fn: Callable, *args, reps: int = 10, warmup: int = 2) -> float:
    """Mean seconds of ``fn(*args)`` over ``reps`` back-to-back calls."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    for _ in range(warmup):
        fn(*args)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    sync(dev)
    return (time.perf_counter() - t0) / reps


def sigma_list(cfg: ReconstructorConfig):
    S = cfg.sift_num_scales
    return [cfg.sift_sigma0 * (2.0 ** (i / 3.0)) for i in range(S)]


def scale_space(gray, cfg: ReconstructorConfig):
    return sift.build_scale_space(gray, cfg.sift_num_scales, sigma0=cfg.sift_sigma0)


def dog_gates(gauss, shapes, cfg: ReconstructorConfig):
    """The score volume (N, S-3, H, W): |DoG| where a voxel is an extremum
    past both gates, else 0 (``shapes`` unused, as in the TPU script)."""
    dog = gauss[:, 1:] - gauss[:, :-1]
    inner = dog[:, 1:-1]
    cand = (sift._neighborhood_extrema(dog) & (torch.abs(inner) > cfg.sift_contrast_thresh)
            & sift._edge_response_ok(inner, cfg.sift_edge_thresh))
    return torch.where(cand, torch.abs(inner), 0.0)


def nms_topk(score_vol, k: int):
    """(values, flat indices) of each image's top ``k`` after 3x3 NMS."""
    pad = torch.nn.functional.pad(score_vol, (1, 1, 1, 1))
    rows = torch.maximum(torch.maximum(pad[:, :, :-2, :], pad[:, :, 1:-1, :]), pad[:, :, 2:, :])
    lm = torch.maximum(torch.maximum(rows[:, :, :, :-2], rows[:, :, :, 1:-1]), rows[:, :, :, 2:])
    sv = torch.where(score_vol >= lm, score_vol, 0.0)
    vals, idx = torch.sort(sv.reshape(sv.shape[0], -1), dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def detect(gray, shapes, cfg: ReconstructorConfig):
    return sift.detect_keypoints(gray, shapes, cfg.max_keypoints, cfg.sift_num_scales,
                                 cfg.sift_contrast_thresh, cfg.sift_edge_thresh,
                                 sigma0=cfg.sift_sigma0)


def descriptors(gauss, xy, s_idx, sigmas, cfg: ReconstructorConfig):
    return sift.compute_descriptors(gauss, xy, s_idx, sigmas, sigma_list(cfg))


def resample(gauss, cfg: ReconstructorConfig):
    return sift._resample_pitch_levels(gauss, sigma_list(cfg), 1,
                                       max(2, cfg.sift_num_scales - 2))[0]


def full(gray, shapes, cfg: ReconstructorConfig):
    return sift.detect_and_describe(
        gray, shapes, max_keypoints=cfg.max_keypoints, num_scales=cfg.sift_num_scales,
        contrast_thresh=cfg.sift_contrast_thresh, edge_thresh=cfg.sift_edge_thresh,
        sigma0=cfg.sift_sigma0)


def stages(gray, shapes, cfg: ReconstructorConfig) -> dict:
    """Every stage's output on one batch (tensors on its device)."""
    gauss, sigmas = scale_space(gray, cfg)
    score_vol = dog_gates(gauss, shapes, cfg)
    vals, idx = nms_topk(score_vol, cfg.max_keypoints)
    xy, scale, score, mask, gauss2, sigmas2, s_idx = detect(gray, shapes, cfg)
    return {"gauss": gauss, "score_vol": score_vol, "topk_values": vals, "topk_indices": idx,
            "xy": xy, "score": score, "mask": mask, "s_idx": s_idx,
            "desc": descriptors(gauss2, xy, s_idx, sigmas2, cfg),
            "resampled": resample(gauss2, cfg), "features": full(gray, shapes, cfg)}


def profile(gray, shapes, cfg: ReconstructorConfig, device: devices.DeviceLike = None,
            reps: int = 10, log: Optional[Callable[[str], None]] = None) -> dict:
    """Milliseconds of each stage on the (N, H, W) gray batch, and images/s
    of the whole. ``gray`` and ``shapes`` are numpy or tensors."""
    dev = devices.resolve(device)
    gray = torch.as_tensor(gray, device=dev)
    shapes = torch.as_tensor(shapes, device=dev)
    N, H, W = gray.shape
    say = log or (lambda m: None)
    say(f"batch ({N},{H},{W}) scales={cfg.sift_num_scales} K={cfg.max_keypoints}")
    out = {"batch": [N, H, W]}

    def stage(key, label, fn, *args, r=reps):
        out[key] = timeit(fn, *args, reps=r) * 1e3
        say(f"{label:17s}{out[key]:8.2f} ms")
    stage("scale_space_ms", "scale space:", scale_space, gray, cfg)
    gauss, _ = scale_space(gray, cfg)
    stage("dog_gates_ms", "DoG+gates:", dog_gates, gauss, shapes, cfg)
    score_vol = dog_gates(gauss, shapes, cfg)
    stage("nms_topk_ms", "NMS+top_k:", nms_topk, score_vol, cfg.max_keypoints)
    stage("detect_ms", "detect (all):", detect, gray, shapes, cfg)
    xy, _, _, _, gauss2, sigmas2, s_idx = detect(gray, shapes, cfg)
    stage("descriptors_ms", "descriptors:", descriptors, gauss2, xy, s_idx, sigmas2, cfg,
          r=max(1, reps // 2))
    stage("resample_ms", "  resample only:", resample, gauss2, cfg, r=max(1, reps // 2))
    stage("full_ms", "FULL:", full, gray, shapes, cfg, r=max(1, reps // 2))
    out["imgs_per_s"] = N / (out["full_ms"] * 1e-3)
    say(f"-> {out['imgs_per_s']:.1f} imgs/s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    distill_fountain.require(distill_fountain.DATA)
    from reconstructor_tpu_torch.io import images as io_images
    cfg = ReconstructorConfig()
    gray, shapes, _ = distill_fountain.gray_crops(
        io_images.load_folder(distill_fountain.DATA, cfg.img_max_size))
    profile(gray, shapes, cfg, dev, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
