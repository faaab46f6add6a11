"""Raw top-2 kNN, packed against unpacked, at two matching widths, on the
100-image workload.

The counterpart of the TPU package's ``scripts/exp_match_regression.py``
(which bisected a matching regression between the packed and the float
kNN kernel and the keypoint-axis trim). The fountain descriptors are tiled
4x to 100 images (4,950 pairs) and sliced to Kt keypoints, Kt the densest
image's count rounded up to 256 and then the full 4,096; at each width
the raw kernel outputs (``cuda_knn.knn_topk2``: best, second, argmin,
column argmin) of every pair come in chunks of ``match_chunk_pairs``
pairs, the last padded with (0, 0) pairs, through the packed kernel
(kernel 2: int32 keys, bias 0 / ``_DMAX``) and the float one (kernel 1:
bias 0 / ``_BIG``), in ``knn_compute_dtype``. One untimed pass, then the
best of three; a pass ends with the host copy of ``best[-1, :4]`` of
every chunk, which waits for all of them, after a device
synchronisation at its start. It gives pairs/s and seconds per run. On
the CPU the wrapper runs each kernel's plain version.

``main()`` detects on ``reference/data`` inside the repository and stops
with a message naming the folder while the photographs are not there;
``regress`` takes a feature state. Runs on the card unless given
``--device cpu``.

    python -m reconstructor_tpu_torch.scripts.exp_match_regression [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.matching import cuda_knn
from reconstructor_tpu_torch.matching import pairs as pairing
from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
from reconstructor_tpu_torch.scripts import distill_fountain
from reconstructor_tpu_torch.scripts.measure_match100 import TILE, sync
from reconstructor_tpu_torch.scripts.profile_match100_decomp import padded_chunks
from reconstructor_tpu_torch.utils import device as devices

FULL_KT = 4096


def widths(kmask: np.ndarray, full: int = FULL_KT) -> List[int]:
    """The two matching widths: the densest image's count rounded up to
    256, and ``full``."""
    kt_real = int(kmask.sum(axis=1).max())
    return [max(256, -(-kt_real // 256) * 256), full]


def inputs(desc: np.ndarray, kmask: np.ndarray, kt: int, packed: bool, dtype: str, device):
    """Descriptors (N, kt, D) in ``dtype`` and the kernel's bias (N, kt) on
    the device: int32 0 / ``_DMAX`` for the packed kernel, float32 0 /
    ``_BIG`` for the float one."""
    d = torch.from_numpy(np.ascontiguousarray(desc[:, :kt])).to(device)
    m = torch.from_numpy(np.ascontiguousarray(kmask[:, :kt])).to(device)
    if dtype == "bfloat16":
        d = d.to(torch.bfloat16)
    bias = (torch.where(m, 0, cuda_knn._DMAX).to(torch.int32) if packed
            else torch.where(m, 0.0, cuda_knn._BIG).to(torch.float32))
    return d.contiguous(), bias.contiguous()


def topk2_chunks(d, bias, chunks, packed: bool):
    """``knn_topk2``'s (best, second, arg, colarg) of every chunk."""
    return [cuda_knn.knn_topk2(d, bias, c, packed=packed) for c in chunks]


def run(desc: np.ndarray, kmask: np.ndarray, kt: int, packed: bool, dtype: str, B: int,
        device, reps: int = 3, keep: bool = False) -> dict:
    """One width and kernel over every pair of the tiled images: best of
    ``reps`` seconds and pairs/s (the last pass's chunk outputs under
    ``"outputs"`` with ``keep``)."""
    dev = devices.resolve(device)
    d, bias = inputs(desc, kmask, kt, packed, dtype, dev)
    pair_np = pairing.exhaustive_pairs(desc.shape[0])
    chunks = padded_chunks(pair_np, B, dev)
    last = []

    def once():
        outs = topk2_chunks(d, bias, chunks, packed)
        for o in outs:
            o[0][-1, :4].cpu()
        last[:] = outs
    once()
    best = float("inf")
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        once()
        best = min(best, time.perf_counter() - t0)
    P = pair_np.shape[0]
    res = {"kt": kt, "packed": packed, "dtype": dtype, "best_s": best, "pairs_per_s": P / best}
    if keep:
        res["outputs"] = list(last)
    return res


def regress(state, cfg: ReconstructorConfig, device: devices.DeviceLike = None,
            tile: int = TILE, reps: int = 3, keep: bool = False,
            log: Optional[Callable[[str], None]] = None) -> dict:
    """Both widths, packed and not, on ``state`` tiled ``tile`` times."""
    dev = devices.resolve(device)
    desc = np.tile(state.desc, (tile, 1, 1))
    kmask = np.tile(state.kp_mask, (tile, 1))
    B = cfg.match_chunk_pairs
    P = desc.shape[0] * (desc.shape[0] - 1) // 2
    if log:
        log(f"imgs={desc.shape[0]} K_full={desc.shape[1]} pairs={P} chunk={B}")
    runs = []
    for kt in widths(kmask, min(FULL_KT, desc.shape[1])):
        for packed in (True, False):
            r = run(desc, kmask, kt, packed, str(cfg.knn_compute_dtype), B, dev, reps, keep)
            runs.append(r)
            if log:
                log(f"kt={kt} packed={int(packed)} {r['dtype']:8s}: "
                    f"{r['pairs_per_s']:7.1f} pairs/s ({r['best_s']:.2f} s)")
    return {"imgs": int(desc.shape[0]), "pairs": P, "chunk": B, "runs": runs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    distill_fountain.require(distill_fountain.DATA)
    cfg = ReconstructorConfig()
    state = IncrementalReconstructor(cfg, verbose=False, device=dev).detect_features(
        distill_fountain.DATA)
    regress(state, cfg, dev, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
