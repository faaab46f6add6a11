"""Measure only the gate-inclusive matching headline: 100 images, 4,950 pairs.

The counterpart of the TPU package's ``scripts/measure_match100.py``: the
reference's 100-image matching workload without the reconstruction
stages, as the fast loop for kernel work. Detection runs on the fountain
photographs (25 images), the feature state is tiled 4x to 100 images
(``tile_state``), and the production ``match_features`` (top-2 kNN, ratio
and mutual test, fundamental-RANSAC gate, in chunks of
``match_chunk_pairs_fused`` pairs on the card) runs once cold and three
times warm. It gives the best warm time, pairs/s, the matching width Kt
and the number of pairs that kept matches.

A timed window ends with the host copy of the match tables, which
``match_features`` makes itself (``.cpu()``), as the TPU script's ends
with its host readback; the device is synchronised before each window
opens.

``main()`` detects on ``reference/data`` inside the repository and stops
with a message naming the folder while the photographs are not there;
``measure`` takes a feature state. Runs on the card unless given
``--device cpu`` (where matching is float32 through the plain matcher, the
TPU package's platform rule).

    python -m reconstructor_tpu_torch.scripts.measure_match100 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
from reconstructor_tpu_torch.scripts import distill_fountain
from reconstructor_tpu_torch.utils import device as devices

TILE = 4


def tile_state(state, tile: int = TILE):
    """The feature state repeated ``tile`` times along the image axis, with
    no matches and no incremental state: the TPU scripts'
    ``dataclasses.replace`` (``kp_score`` stays None when it is None)."""
    return dataclasses.replace(
        state,
        num_images=state.num_images * tile,
        xy=np.tile(state.xy, (tile, 1, 1)),
        desc=np.tile(state.desc, (tile, 1, 1)),
        kp_mask=np.tile(state.kp_mask, (tile, 1)),
        colors=np.tile(state.colors, (tile, 1, 1)),
        shapes=np.tile(state.shapes, (tile, 1)),
        intrinsics=np.tile(state.intrinsics, (tile, 1)),
        kp_score=None if state.kp_score is None else np.tile(state.kp_score, (tile, 1)),
        matches={}, poses={}, registered=[], feat2lm=None,
        lm_xyz=None, lm_rgb=None, lm_obs_img=None, lm_obs_feat=None,
        lm_obs_mask=None, lm_initial=None)


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_match(rec: IncrementalReconstructor, state, filter: bool = True) -> float:
    """One ``match_features`` pass from empty matches, host seconds."""
    state.matches = {}
    sync(rec.device)
    t0 = time.perf_counter()
    rec.match_features(state, filter=filter)
    return time.perf_counter() - t0


def measure(state, cfg: ReconstructorConfig, device: devices.DeviceLike = None,
            tile: int = TILE, reps: int = 3) -> dict:
    """The headline on ``state`` tiled ``tile`` times: cold seconds, best of
    ``reps`` warm seconds, pairs/s, Kt and pairs matched. The tiled state
    (with the last pass's matches) comes back under ``"state"``."""
    rec = IncrementalReconstructor(cfg, verbose=False, device=devices.resolve(device))
    state100 = tile_state(state, tile)
    n_pairs = state100.num_images * (state100.num_images - 1) // 2
    cold = timed_match(rec, state100)
    cold_matched = len(state100.matches)
    best = min(timed_match(rec, state100) for _ in range(reps))
    kt = int(rec._device_frontend(state100)[0].shape[1])
    return {"match100_cold_s": cold, "match100_warm_s": best,
            "match100_pairs_per_s": n_pairs / best, "kt": kt,
            "pairs_matched": len(state100.matches), "pairs_matched_cold": cold_matched,
            "n_pairs": n_pairs, "state": state100}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    distill_fountain.require(distill_fountain.DATA)
    cfg = ReconstructorConfig()
    rec = IncrementalReconstructor(cfg, verbose=False, device=dev)
    print(json.dumps({"device": str(dev)}), file=sys.stderr)
    sync(dev)
    t0 = time.perf_counter()
    state = rec.detect_features(distill_fountain.DATA)
    sync(dev)
    print(json.dumps({"detect_cold_s": round(time.perf_counter() - t0, 1)}),
          file=sys.stderr, flush=True)
    res = measure(state, cfg, dev)
    del res["state"]
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
