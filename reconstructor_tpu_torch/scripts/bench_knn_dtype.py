"""float32 against bfloat16 descriptors in the matching path, on the
100-image headline.

The counterpart of the TPU package's ``scripts/bench_knn_dtype.py``: the
fountain features tiled 4x (4,950 pairs, ``measure_match100.tile_state``)
go through the production ``match_features`` once with
``knn_compute_dtype="float32"`` and once with ``"bfloat16"`` (one cold
pass, then the best of three warm ones each). It gives each dtype's
seconds, pairs/s and total inliers, and the share of float32's inlier
matches that bfloat16 reproduces, the evidence behind the
``knn_compute_dtype`` default. On the card float32 takes kernel 1's SIMT
product and bfloat16 its tensor-core (``wgmma``) one; on the CPU matching
is float32 whatever the setting (the TPU package's platform rule), so the
agreement there is 1.0.

``main()`` detects on ``reference/data`` inside the repository and stops
with a message naming the folder while the photographs are not there;
``bench`` takes a feature state. Runs on the card unless given
``--device cpu``.

    python -m reconstructor_tpu_torch.scripts.bench_knn_dtype [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
from reconstructor_tpu_torch.scripts import distill_fountain
from reconstructor_tpu_torch.scripts.measure_match100 import TILE, tile_state, timed_match
from reconstructor_tpu_torch.utils import device as devices

DTYPES = ("float32", "bfloat16")


def agreement(m32: dict, m16: dict) -> float:
    """Share of float32's inlier matches that the bfloat16 tables repeat."""
    same = tot = 0
    for k, a in m32.items():
        sel = a >= 0
        tot += int(sel.sum())
        b = m16.get(k)
        if b is not None:
            same += int((b[sel] == a[sel]).sum())
    return same / max(tot, 1)


def bench(state, cfg: ReconstructorConfig, device: devices.DeviceLike = None,
          tile: int = TILE, reps: int = 3) -> dict:
    """Both dtypes on ``state`` tiled ``tile`` times. The match tables of
    each dtype's last pass come back under ``"matches"``."""
    dev = devices.resolve(device)
    state100 = tile_state(state, tile)
    n_pairs = state100.num_images * (state100.num_images - 1) // 2
    out = {"n_pairs": n_pairs, "device": str(dev)}
    results = {}
    for dtype in DTYPES:
        rec = IncrementalReconstructor(cfg.with_(knn_compute_dtype=dtype), verbose=False,
                                       device=dev)
        timed_match(rec, state100)   # cold
        best = min(timed_match(rec, state100) for _ in range(reps))
        results[dtype] = dict(state100.matches)
        out[f"match100_s_{dtype}"] = best
        out[f"pairs_per_s_{dtype}"] = n_pairs / best
        out[f"total_inliers_{dtype}"] = int(sum((m >= 0).sum() for m in results[dtype].values()))
    out["agreement_bf16_vs_f32"] = agreement(results["float32"], results["bfloat16"])
    out["matches"] = results
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    distill_fountain.require(distill_fountain.DATA)
    cfg = ReconstructorConfig()
    state = IncrementalReconstructor(cfg, verbose=False, device=dev).detect_features(
        distill_fountain.DATA)
    out = bench(state, cfg, dev)
    del out["matches"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
