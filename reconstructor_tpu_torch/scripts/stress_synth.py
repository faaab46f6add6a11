"""100-view synthetic-scene stress run: landmark and BA capacity, wall time.

The counterpart of the TPU package's ``scripts/stress_synth.py``. It
exercises what the 25-view scenes cannot: ~5,000 image pairs, O(100)
registered cameras, the growth of the landmark and observation tables and
~98 incremental bundle adjustments. The scene's ground truth makes the
result checkable (ATE).

The scene is ``eval.synth.make_synthetic_state(views, points, clutter,
seed=7)`` (2,000 points + 128 clutter slots a view, 128-D descriptors, K
rounded up to 2,176); the driver runs from matching on, with
``focal_px=520``, ``ba_local_window`` and ``ba_global_every`` from the
flags and ``rng_seed=--seed`` (the RANSAC stream). With ``--checkpoint``
the state autosaves as the driver does (after the initial pair, every
``checkpoint_every_views`` registrations and at the end), and a run
started on an existing file resumes from it
(``IncrementalReconstructor.restore``: state and generator).

It prints one JSON line: ``views_registered``, ``views_total``,
``landmarks``, ``observations``, ``wall_s`` and ``pose_ate``'s keys, as
the TPU script does, and ``ba_calls`` (bundle adjustments per solver:
``dense`` for ``ba.lm.solve``, ``pcg`` for ``ba.distributed.solve_pcg``,
``distributed`` for ``solve_distributed``, as the driver counts them in
``IncrementalReconstructor.ba_calls``)
and ``knn_launches`` (launches of the CUDA kNN kernel), which say which
routes ran.

    python -m reconstructor_tpu_torch.scripts.stress_synth [--views 100] \\
        [--points 2000] [--clutter 128] [--local-window 0] [--global-every 8] \\
        [--seed 0] [--checkpoint PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import torch

from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.eval import synth
from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
from reconstructor_tpu_torch.utils import cuda_build, device as devices

SCENE_SEED = 7


def scene(views: int = 100, points: int = 2000, clutter: int = 128, seed: int = SCENE_SEED):
    """The synthetic feature state, true poses (N, 4, 4) and points."""
    return synth.make_synthetic_state(n_views=views, n_points=points, clutter=clutter,
                                      seed=seed)


def reconstructor(state, local_window: int = 0, global_every: int = 8, seed: int = 0,
                  device: devices.DeviceLike = None, verbose: bool = True,
                  **config) -> IncrementalReconstructor:
    """The TPU script's configuration on ``state``'s keypoint capacity;
    ``config`` sets further ``ReconstructorConfig`` fields."""
    cfg = ReconstructorConfig(max_keypoints=state.max_keypoints, focal_px=520.0,
                              ba_local_window=local_window, ba_global_every=global_every,
                              rng_seed=seed, **config)
    return IncrementalReconstructor(cfg, verbose=verbose, device=device)


def drive(rec: IncrementalReconstructor, state, checkpoint: Optional[str] = None):
    """Resume from ``checkpoint`` where it exists, then run the driver to
    the end, autosaving there. Returns (state, {"wall_s", "ba_calls",
    "knn_launches"}); the wall ends in a device synchronise."""
    t0 = time.perf_counter()
    if checkpoint and os.path.exists(checkpoint):
        state = rec.restore(checkpoint)
        print(f"resumed at {len(state.registered)} views", file=sys.stderr, flush=True)
    cuda_build.reset_launches()
    before = dict(rec.ba_calls)
    state = rec.reconstruct_from_state(state, checkpoint_path=checkpoint)
    if rec.device.type == "cuda":
        torch.cuda.synchronize(rec.device)
    calls = {k: n - before[k] for k, n in rec.ba_calls.items()}
    return state, {"wall_s": time.perf_counter() - t0, "ba_calls": calls,
                   "knn_launches": cuda_build.launches()["knn_top2_launch"]}


def report(state, gt_poses, **extra) -> dict:
    """The TPU script's JSON fields of a state: counts, then ``extra``,
    then ``pose_ate``'s keys (floats rounded to 6 places)."""
    res = {"views_registered": len(state.registered),
           "views_total": state.num_images,
           "landmarks": int(state.num_landmarks),
           "observations": int(state.lm_obs_mask.sum())}
    res.update(extra)
    res.update({k: round(v, 6) if isinstance(v, float) else v
                for k, v in synth.pose_ate(state.poses, gt_poses).items()})
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--views", type=int, default=100)
    ap.add_argument("--points", type=int, default=2000)
    ap.add_argument("--clutter", type=int, default=128)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--local-window", type=int, default=0,
                    help="ba_local_window (0 = global BA every view)")
    ap.add_argument("--global-every", type=int, default=8)
    ap.add_argument("--checkpoint", default=None,
                    help="autosave path; an existing file is resumed from")
    ap.add_argument("--seed", type=int, default=0,
                    help="RANSAC generator seed (report runs with their seed)")
    ap.add_argument("--quiet", action="store_true", help="no driver log on stdout")
    args = ap.parse_args(argv)

    state, gt, _ = scene(args.views, args.points, args.clutter)
    rec = reconstructor(state, args.local_window, args.global_every, args.seed,
                        device=args.device, verbose=not args.quiet)
    name = torch.cuda.get_device_name(rec.device) if rec.device.type == "cuda" else "cpu"
    print(f"device={rec.device} ({name}) views={args.views} "
          f"keypoints/view={state.max_keypoints}", file=sys.stderr, flush=True)
    state, info = drive(rec, state, args.checkpoint)
    res = report(state, gt, wall_s=round(info["wall_s"], 1), ba_calls=info["ba_calls"],
                 knn_launches=info["knn_launches"])
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
