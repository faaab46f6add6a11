"""The JAX package's learned path on the small held-out scene over RANSAC
seeds: ``tests/test_learned_e2e.py``'s run (``make_scene(21, 8 views)`` at
160 px written as PNGs and read back through the folder entry point,
the committed ``superpoint_synth.npz``, structured SuperGlue, 50 Sinkhorn
iterations, 256 keypoints) at each ``config.rng_seed`` given, with the JAX
package's own draws. Prints one JSON line a seed: registered views,
landmarks, normalised ATE, and whether the run clears the test's bars
(8/8, > 60 landmarks, ATE < 10%). The port's runs of the same scene and
seeds are in ``chip_smoke.py``'s train phase.

    JAX_PLATFORMS=cpu python tests/jax_learned_seeds.py [--seeds 0,1,2,3]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

WEIGHTS = os.path.join(HERE, "data", "superpoint_synth.npz")


def run_seed(seed: int, img_dir: str, out_dir: str, scene) -> dict:
    from reconstructor_tpu.config import ReconstructorConfig
    from reconstructor_tpu.eval import synth
    from reconstructor_tpu.pipeline.incremental import IncrementalReconstructor
    cfg = ReconstructorConfig(
        detector="superpoint", superpoint_weights=WEIGHTS,
        matcher="superglue", superglue_weights="structured",
        max_keypoints=256, focal_px=170.0, superglue_sinkhorn_iters=50,
        ba_local_window=0, final_refinement_rounds=1, rng_seed=seed)
    t = time.perf_counter()
    state = IncrementalReconstructor(cfg, verbose=False).reconstruct(img_dir, out_folder=out_dir)
    ate = synth.pose_ate(state.poses, scene["poses"])["ate_rmse_normalized"]
    n = len(state.registered)
    return {"rng_seed": seed, "registered": n, "views": len(scene["images"]),
            "landmarks": int(state.num_landmarks), "ate_normalized": float(ate),
            "passes": bool(n == len(scene["images"]) and state.num_landmarks > 60
                           and ate < 0.10),
            "wall_s": time.perf_counter() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from PIL import Image
    from reconstructor_tpu.eval import render
    scene = render.make_scene(seed=21, n_views=8, h=160, w=160)
    with tempfile.TemporaryDirectory() as tmp:
        img_dir = os.path.join(tmp, "imgs")
        os.makedirs(img_dir)
        for i, im in enumerate(scene["images"]):
            arr = np.clip(im * 255.0, 0, 255).astype(np.uint8)
            Image.fromarray(np.stack([arr] * 3, axis=-1)).save(
                os.path.join(img_dir, f"{i:04d}.png"))
        for seed in (int(s) for s in args.seeds.split(",")):
            print(json.dumps(run_seed(seed, img_dir, os.path.join(tmp, f"out{seed}"), scene)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
