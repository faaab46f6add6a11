"""Quality experiment: BA policy and convergence settings against the
trajectory error.

The counterpart of the TPU package's ``scripts/exp_quality.py``. One
detection and one matching of the fountain photographs are shared by
every variant below (a variant that changes matching matches again); each
runs ``reconstruct_from_state`` on a fresh copy of that state and gives
its registered views, landmarks, observations, the trajectory error of
the registered camera centres against the golden cloud
(``eval.ate.ate_vs_golden``: absolute, normalised and, where the golden
cloud gives it, the Hungarian-matched normalised error) and its wall
time. ``main()`` prints one JSON line a variant, then all of them, and
records a variant that raises as ``{"error": ...}`` and goes on, as the
TPU script does; ``run_variant`` and ``sweep`` let the exception through.

``main()`` reads ``reference/data`` and ``reference/cloud_fountain.ply``
inside the repository and stops with a message naming the missing one;
``sweep`` takes a matched state and a golden PLY. Runs on the card unless
given ``--device cpu``.

    python -m reconstructor_tpu_torch.scripts.exp_quality [default,noretri,...] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np

from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.eval import ate
from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
from reconstructor_tpu_torch.scripts import distill_fountain
from reconstructor_tpu_torch.scripts.measure_match100 import sync
from reconstructor_tpu_torch.utils import device as devices

VARIANTS: Dict[str, dict] = {
    "default": {},
    "default_bf16_matching": {"knn_compute_dtype": "bfloat16"},
    "local_iters50": {"ba_local_max_iters": 50},
    "noretri": {"final_retriangulate": False},
    "ftol8": {"ba_ftol": 1e-8},
    "final6": {"final_refinement_rounds": 6},
    "final6_ftol8": {"final_refinement_rounds": 6, "ba_ftol": 1e-8},
    "huber2": {"ba_huber_delta": 2.0},
    "huber45": {"ba_huber_delta": 4.5},
    "maxerr3": {"max_projection_error": 3.0},
    "final9": {"final_refinement_rounds": 9},
    "final6_iters150": {"ba_max_iters_large": 150},
}


def fresh_state(base):
    """A copy of the feature + match state without incremental results."""
    return dataclasses.replace(
        base,
        matches={k: v.copy() for k, v in base.matches.items()},
        poses={}, registered=[], feat2lm=None,
        lm_xyz=None, lm_rgb=None, lm_obs_img=None, lm_obs_feat=None,
        lm_obs_mask=None, lm_initial=None)


def select(names: Optional[str]) -> Dict[str, dict]:
    """The variants named in a comma-separated list (all for None)."""
    if not names:
        return dict(VARIANTS)
    keep = names.split(",")
    return {k: v for k, v in VARIANTS.items() if k in keep}


def run_variant(state0, base_cfg: ReconstructorConfig, over: dict, golden: str,
                device: devices.DeviceLike = None) -> dict:
    """One variant from the shared matched state."""
    dev = devices.resolve(device)
    rec = IncrementalReconstructor(base_cfg.with_(**over), verbose=False, device=dev)
    st = fresh_state(state0)
    if "knn_compute_dtype" in over:
        st.matches = {}      # a matching setting changed: match again
    sync(dev)
    t0 = time.perf_counter()
    st = rec.reconstruct_from_state(st)
    sync(dev)
    wall = time.perf_counter() - t0
    centers = np.stack([-st.poses[i][:3, :3].T @ st.poses[i][:3, 3] for i in st.registered])
    res = ate.ate_vs_golden(centers, golden)
    return {"registered": len(st.registered), "landmarks": int(st.num_landmarks),
            "observations": int(st.lm_obs_mask.sum()), "ate_rmse": res["ate_rmse"],
            "ate_norm": res["ate_rmse_normalized"],
            "ate_hung_norm": res.get("ate_rmse_hungarian_normalized", -1.0), "wall_s": wall}


def matched_state(imgs, cfg: ReconstructorConfig, device: devices.DeviceLike = None):
    """The shared detection and matching of loaded images."""
    rec = IncrementalReconstructor(cfg, verbose=False, device=devices.resolve(device))
    state = rec.detect_features_from_images(imgs)
    rec.match_features(state)
    return state


def sweep(state0, base_cfg: ReconstructorConfig, golden: str,
          device: devices.DeviceLike = None, variants: Optional[str] = None,
          log: Optional[Callable[[str], None]] = None) -> dict:
    """Every selected variant on ``state0`` (matched), by name."""
    results = {}
    for name, over in select(variants).items():
        results[name] = run_variant(state0, base_cfg, over, golden, device)
        if log:
            log(json.dumps({name: results[name]}))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="?", default=None,
                    help="comma-separated variant names (default: all)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    distill_fountain.require(distill_fountain.DATA, distill_fountain.GOLDEN)
    from reconstructor_tpu_torch.io import images as io_images
    base_cfg = ReconstructorConfig()
    state0 = matched_state(io_images.load_folder(distill_fountain.DATA, base_cfg.img_max_size),
                           base_cfg, dev)
    print("matching done", flush=True)
    results = {}
    for name, over in select(args.variants).items():
        try:
            results[name] = run_variant(state0, base_cfg, over, distill_fountain.GOLDEN, dev)
        except Exception as e:   # the script records a failed variant and goes on
            results[name] = {"error": repr(e)}
        print(json.dumps({name: results[name]}), flush=True)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
