"""A stress-run report (JSON) from a checkpoint, finished or mid-run.

The counterpart of the TPU package's ``scripts/stress_report.py``: it
loads a checkpoint in the JAX package's layout (``pipeline.checkpoint``;
a file either package wrote, such as the tracked
``out/stress100_r4_ckpt.npz``), rebuilds the stress scene's true poses
(``eval.synth.make_synthetic_state`` with the run's ``--views``,
``--points``, ``--clutter`` and ``--seed``) and prints the stress run's
counts and ``pose_ate``'s keys as one JSON line. It reads no device: the
file is numpy.

    python -m reconstructor_tpu_torch.scripts.stress_report CKPT \\
        [--views 100] [--points 2000] [--clutter 128] [--seed 7] \\
        [--wall-s N] [--partial]
"""

from __future__ import annotations

import argparse
import json
import sys

from reconstructor_tpu_torch.pipeline import checkpoint
from reconstructor_tpu_torch.scripts import stress_synth


def report(path: str, views: int = 100, points: int = 2000, clutter: int = 128,
           seed: int = stress_synth.SCENE_SEED, wall_s=None, partial: bool = False) -> dict:
    """The TPU script's JSON object for the checkpoint at ``path``."""
    state = checkpoint.load(path)
    _, gt, _ = stress_synth.scene(views, points, clutter, seed)
    extra = {"partial": bool(partial)}
    if wall_s is not None:
        extra["wall_s"] = wall_s
    return stress_synth.report(state, gt, **extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt")
    ap.add_argument("--views", type=int, default=100)
    ap.add_argument("--points", type=int, default=2000)
    ap.add_argument("--clutter", type=int, default=128)
    ap.add_argument("--seed", type=int, default=stress_synth.SCENE_SEED)
    ap.add_argument("--wall-s", type=float, default=None)
    ap.add_argument("--partial", action="store_true")
    args = ap.parse_args(argv)
    print(json.dumps(report(args.ckpt, args.views, args.points, args.clutter, args.seed,
                            args.wall_s, args.partial)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
