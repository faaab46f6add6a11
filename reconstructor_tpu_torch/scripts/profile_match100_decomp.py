"""Decompose the 100-image matching headline into kNN, gate, download and
dispatch.

The counterpart of the TPU package's ``scripts/profile_match100_decomp.py``.
The fountain features go to the device at the matching width Kt
(``IncrementalReconstructor._device_frontend``), are tiled 4x to 100
images (4,950 pairs), and each case below runs every pair in fixed-size
chunks of B pairs, the last chunk padded with (0, 0) pairs as the TPU
script pads it (the driver's own chunks are not padded: this script times
fixed-B chunks). Median of 5 passes after one untimed pass, with min, max
and the spread (standard deviation over median):

  A. gated (kNN + F-gate, ``matching.gated.match_and_gate``) B=256, full download
  B. gated B=256, 4-element download
  C. kNN only (``cuda_knn.match_all_pairs_fused``) B=256, full download
  D. kNN only B=256, 4-element download
  E. gated B=512, full download
  G. gated B=1024, full download
  F. gated B=256 with H=128 F-gate hypotheses, full download

"Full download" is the host copy (``.cpu()``) of every chunk's whole (B,
Kt) match table and its counts (gated) or mask (kNN); "4-element" copies
``mi[-1, :4]`` of each chunk, which waits for the work and moves almost
nothing, so B - A and D - C are the price of moving the tables. Each pass
starts after a device synchronisation and ends with its copies.

Every chunk of a case takes the same F-gate draws, as every chunk of the
TPU script splits the same ``PRNGKey(7)``: one (B, H, 8) draw from a
generator seeded 7 on the device, passed to ``match_and_gate`` as
``pos``. The environment variable ``CASES`` selects the cases (default
``ABCD``), as in the TPU script. On the card the kNN runs in
``knn_compute_dtype``; on the CPU in float32 (the TPU package's platform
rule): the gated cases through the plain matcher, as the driver's, the
kNN-only cases through the kernel wrapper's plain version.

``main()`` detects on ``reference/data`` inside the repository and stops
with a message naming the folder while the photographs are not there;
``decompose`` takes a feature state. Runs on the card unless given
``--device cpu``.

    CASES=ABCDEGF python -m reconstructor_tpu_torch.scripts.profile_match100_decomp [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.geometry import ransac
from reconstructor_tpu_torch.matching import cuda_knn, gated
from reconstructor_tpu_torch.matching import pairs as pairing
from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
from reconstructor_tpu_torch.scripts import distill_fountain
from reconstructor_tpu_torch.scripts.measure_match100 import TILE, sync
from reconstructor_tpu_torch.utils import device as devices

DRAW_SEED = 7
# (letter, label, kind, chunk pairs B, F-gate hypotheses (None: the
# config's), full download), in the TPU script's order
ALL_CASES = [
    ("A", "A gated B=256 full-dl", "gated", 256, None, True),
    ("B", "B gated B=256 tiny-dl", "gated", 256, None, False),
    ("C", "C knn   B=256 full-dl", "knn", 256, None, True),
    ("D", "D knn   B=256 tiny-dl", "knn", 256, None, False),
    ("E", "E gated B=512 full-dl", "gated", 512, None, True),
    ("G", "G gated B=1024 full-dl", "gated", 1024, None, True),
    ("F", "F gated B=256 H=128 full-dl", "gated", 256, 128, True),
]


def median_spread(fn: Callable, device: torch.device, reps: int = 5):
    """(median, min, max, std / median) host seconds of ``reps`` calls."""
    ts = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts)
    med = float(np.median(ts))
    return med, float(ts.min()), float(ts.max()), float(ts.std() / med)


def frontend(state, cfg: ReconstructorConfig, device, tile: int = TILE):
    """(desc, mask, xy) at the matching width Kt on the device, tiled."""
    rec = IncrementalReconstructor(cfg, verbose=False, device=device)
    return tuple(torch.cat([a] * tile, dim=0) for a in rec._device_frontend(state))


def padded_chunks(pair_np: np.ndarray, B: int, device) -> List[torch.Tensor]:
    """Every pair in (B, 2) int32 chunks on the device, the last one
    padded with (0, 0) pairs."""
    out = []
    for s0 in range(0, pair_np.shape[0], B):
        chunk = np.zeros((B, 2), np.int32)
        e = min(s0 + B, pair_np.shape[0])
        chunk[: e - s0] = pair_np[s0:e]
        out.append(torch.from_numpy(chunk).to(device))
    return out


def gate_draws(B: int, H: int, device, seed: int = DRAW_SEED) -> torch.Tensor:
    """The (B, H, 8) F-gate draws every chunk of a gated case takes."""
    return ransac.raw_draws((B, H, 8), device, devices.generator(device, seed))


def compute_dtype(cfg: ReconstructorConfig, device: torch.device) -> str:
    return cfg.knn_compute_dtype if device.type == "cuda" else "float32"


def gated_chunks(desc, kmask, xy, chunks, cfg: ReconstructorConfig, H: int, pos):
    """(int16 match table (B, Kt), inlier counts (B,)) of every chunk."""
    return [gated.match_and_gate(
        desc, kmask, xy, c, ratio_thresh=cfg.ratio_thresh, cross_check=cfg.cross_check,
        num_hypotheses=H, thresh_px=cfg.fundamental_thresh_px,
        min_matches=cfg.min_matches_for_filter,
        compute_dtype=compute_dtype(cfg, desc.device), pos=pos) for c in chunks]


def knn_chunks(desc, kmask, chunks, cfg: ReconstructorConfig):
    """(match_idx (B, Kt), match_mask (B, Kt)) of every chunk, ungated."""
    return [cuda_knn.match_all_pairs_fused(
        desc, kmask, c, ratio_thresh=cfg.ratio_thresh, cross_check=cfg.cross_check,
        compute_dtype=compute_dtype(cfg, desc.device)) for c in chunks]


def download(outs, full: bool) -> None:
    """The host copies that end a pass."""
    for a, b in outs:
        if full:
            a.cpu()
            b.cpu()
        else:
            a[-1, :4].cpu()


def decompose(state, cfg: ReconstructorConfig, device: devices.DeviceLike = None,
              cases: Optional[str] = None, reps: int = 5, tile: int = TILE,
              keep: Iterable[str] = (), log: Optional[Callable[[str], None]] = None) -> dict:
    """The selected cases (default: ``$CASES`` or ``ABCD``) on ``state``
    tiled ``tile`` times. Each case gives pairs/s and median, min and max
    seconds and the spread; the chunk outputs of the last pass of each
    case in ``keep`` come back under ``"outputs"``."""
    dev = devices.resolve(device)
    sel = os.environ.get("CASES", "ABCD") if cases is None else cases
    desc, kmask, xy = frontend(state, cfg, dev, tile)
    pair_np = pairing.exhaustive_pairs(desc.shape[0])
    P = pair_np.shape[0]
    res = {"imgs": int(desc.shape[0]), "kt": int(desc.shape[1]), "pairs": P, "cases": {},
           "outputs": {}}
    if log:
        log(f"imgs={res['imgs']} Kt={res['kt']} pairs={P}")
    for letter, name, kind, B, H, full in ALL_CASES:
        if letter not in sel:
            continue
        chunks = padded_chunks(pair_np, B, dev)
        if kind == "gated":
            H = H or cfg.fundamental_num_hypotheses
            pos = gate_draws(B, H, dev)

            def run():
                return gated_chunks(desc, kmask, xy, chunks, cfg, H, pos)
        else:
            def run():
                return knn_chunks(desc, kmask, chunks, cfg)
        last = []

        def once():
            outs = run()
            download(outs, full)
            last[:] = outs
        once()   # first use: kernel load, allocator
        med, lo, hi, spread = median_spread(once, dev, reps)
        res["cases"][letter] = {"name": name, "pairs_per_s": P / med, "med_s": med,
                                "min_s": lo, "max_s": hi, "spread": spread}
        if letter in keep:
            res["outputs"][letter] = list(last)
        if log:
            log(f"{name:30s}: {P / med:7.1f} pairs/s  med={med:.3f}s "
                f"min={lo:.3f} max={hi:.3f} spread={spread * 100:.1f}%")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    distill_fountain.require(distill_fountain.DATA)
    cfg = ReconstructorConfig()
    state = IncrementalReconstructor(cfg, verbose=False, device=dev).detect_features(
        distill_fountain.DATA)
    decompose(state, cfg, dev, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
