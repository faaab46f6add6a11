"""Split the top-2 kNN kernel's time into its parts, on the card.

The counterpart of the TPU package's ``scripts/profile_knn_kernel.py``.
``run(desc, pair_idx, level)`` computes the kNN kernel without masks with
its reductions switched on level by level (``csrc/knn_levels.cu``):

- 0 ``matmul+min``: row min (arg = 0, second = best, colarg = 0);
- 1 ``+argmin``: adds the row argmin;
- 2 ``+second``: adds the second min;
- 3 ``full``: adds the column argmin (the top-2 kNN kernel, zero bias);
- ``"packed"``: the packed-int32 keys with a fixed 4096 stride, clipped
  at 2^19 - 1, no sentinel (K <= 4096).

On a CUDA tensor ``run`` launches the kernel (or raises), counted by
``utils.cuda_build`` under ``knn_levels_launch``; on a CPU tensor it runs
``run_plain``, the same function in plain PyTorch. In bf16 the kernel
takes the top-2 kNN kernel's tensor-core product
(``matching/csrc/knn_wgmma.cuh``, of which that kernel keeps an inline
copy); level 3 is checked equal to that kernel's outputs with zero bias,
bit for bit, so the levels split its epilogue; float32 takes the SIMT
product.

    python -m reconstructor_tpu_torch.scripts.profile_knn_kernel           # the sweep
    python -m reconstructor_tpu_torch.scripts.profile_knn_kernel --quick   # bf16: full vs packed
    python -m reconstructor_tpu_torch.scripts.profile_knn_kernel --device cpu \\
        --keypoints 256 --pairs 4                                          # plain, on the CPU

The sweep is the TPU script's: K in {4096, 3584}, D = 128, 256 pairs over
8 images of unnormalised standard-normal descriptors (so most rows' best
distance clips to 0 and the reductions work on ties), float32 and
bfloat16. Each tag is timed once warm and then over 3 runs with CUDA
events on the card (host clock on the CPU) and printed as
``{tag}_ms_per_pair`` / ``{tag}_pairs_per_s``. The TPU script's row-tile
size TR is a TPU tiling knob with no counterpart here: the tags drop its
``_TR...`` suffix.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import time

import numpy as np
import torch

from reconstructor_tpu_torch.matching import cuda_knn
from reconstructor_tpu_torch.utils import cuda_build
from reconstructor_tpu_torch.utils import device as devices

SOURCE = "scripts/csrc/knn_levels.cu"
REPLACES = "scripts/profile_knn_kernel.py:67"   # make_kernel(level), make_packed_kernel :22
LEVELS = (0, 1, 2, 3, "packed")
NAMES = {0: "matmul+min", 1: "+argmin", 2: "+second", 3: "full", "packed": "packed"}
_LEVEL_CODE = {0: 0, 1: 1, 2: 2, 3: 3, "packed": 4}

_VP, _CI = ctypes.c_void_p, ctypes.c_int
# level, desc, dtype code, pair_idx, B, K, D, best, second, arg, colarg,
# colbest, stream
_FNS = {"knn_levels_launch": [_CI, _VP, _CI, _VP, _CI, _CI, _CI, _VP, _VP, _VP, _VP, _VP, _VP]}


def run_plain(desc: torch.Tensor, pair_idx: torch.Tensor, level, pairs_per_batch: int = 16):
    """The level kernel's function in plain PyTorch (float32 accumulation).
    Returns (best (B,K), second (B,K), arg (B,K) int32, colarg (B,K) int32)."""
    N, K, _ = desc.shape
    if level == 3:
        zero = torch.zeros((N, K), dtype=torch.float32, device=desc.device)
        return cuda_knn.knn_topk2_plain(desc, zero, pair_idx, pairs_per_batch)
    if level == "packed":
        zero = torch.zeros((N, K), dtype=torch.int32, device=desc.device)
        return cuda_knn.packed_keys_plain(desc, zero, pair_idx, clip_hi=cuda_knn._DMAX,
                                          sentinel=False, pairs_per_batch=pairs_per_batch)
    cols = torch.arange(K, device=desc.device)
    outs = []
    for s in range(0, pair_idx.shape[0], pairs_per_batch):
        pc = pair_idx[s:s + pairs_per_batch].long()
        sim = torch.matmul(desc[pc[:, 0]].float(), desc[pc[:, 1]].float().transpose(1, 2))
        dist = torch.clamp(2.0 - 2.0 * sim, min=0.0)
        zeros = torch.zeros(dist.shape[:2], dtype=torch.int32, device=desc.device)
        if level == 0:
            best = dist.amin(2)
            outs.append((best, best, zeros, zeros))
            continue
        best, arg = torch.min(dist, dim=2)
        second = best
        if level >= 2:
            second = torch.where(cols == arg[:, :, None], cuda_knn._BIG, dist).amin(2)
        outs.append((best, second, arg.to(torch.int32), zeros))
    return tuple(torch.cat(t) for t in zip(*outs))


def run(desc: torch.Tensor, pair_idx: torch.Tensor, level):
    """Kernel 4 at ``level`` for every pair; see ``run_plain``. On a CUDA
    tensor this launches ``csrc/knn_levels.cu`` (or raises); the plain
    version runs only for tensors on the CPU."""
    if level not in _LEVEL_CODE:
        raise ValueError(f"profile_knn_kernel.run: level must be one of {LEVELS}, got {level!r}")
    N, K, D = desc.shape
    if level == "packed" and K > cuda_knn.PACKED_MAX_K:
        raise ValueError(f"profile_knn_kernel.run: the packed level takes K <= "
                         f"{cuda_knn.PACKED_MAX_K}, got K={K}")
    if desc.device.type == "cpu":
        return run_plain(desc, pair_idx, level)
    if desc.device.type != "cuda":
        raise ValueError(f"profile_knn_kernel.run: unsupported device {desc.device}")
    B = pair_idx.shape[0]
    if desc.dtype not in cuda_knn._DTYPE_CODE:
        raise TypeError(f"profile_knn_kernel.run: descriptors must be float32 or bfloat16, "
                        f"got {desc.dtype}")
    if not cuda_knn.supported(K, D):
        raise ValueError(f"profile_knn_kernel.run: need K % 128 == 0 and D a multiple of 128 "
                         f"up to 512, got K={K} D={D}")
    if pair_idx.dtype != torch.int32 or pair_idx.dim() != 2 or pair_idx.shape[1] != 2:
        raise ValueError("profile_knn_kernel.run: pair_idx must be int32 (B, 2)")
    if not 0 < B <= 65535:
        raise ValueError(f"profile_knn_kernel.run: 0 < B <= 65535 pairs per launch, got {B}")
    for name, t in (("desc", desc), ("pair_idx", pair_idx)):
        if t.device != desc.device:
            raise ValueError(f"profile_knn_kernel.run: {name} on {t.device}, "
                             f"descriptors on {desc.device}")
        if not t.is_contiguous():
            raise ValueError(f"profile_knn_kernel.run: {name} must be contiguous")
    dev = desc.device
    best = torch.empty((B, K), dtype=torch.float32, device=dev)
    second = torch.empty((B, K), dtype=torch.float32, device=dev)
    arg = torch.empty((B, K), dtype=torch.int32, device=dev)
    colarg = torch.empty((B, K), dtype=torch.int32, device=dev)
    colbest = torch.empty((B, K) if level == 3 else (1,), dtype=torch.int64, device=dev)
    args = (_LEVEL_CODE[level], desc.data_ptr(), cuda_knn._DTYPE_CODE[desc.dtype],
            pair_idx.data_ptr(), B, K, D, best.data_ptr(), second.data_ptr(), arg.data_ptr(),
            colarg.data_ptr(), colbest.data_ptr())
    cuda_build.launch(cuda_build.bind(SOURCE, _FNS, "knn_levels_error_string"),
                      "knn_levels_launch", args, dev)
    return best, second, arg, colarg


def _time_per_call(fn, dev: torch.device, iters: int = 3) -> float:
    """Seconds per call after one warm call: CUDA events on the card, the
    host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters / 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="bf16 only: full vs packed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card); 'cpu' runs the plain versions")
    ap.add_argument("--keypoints", type=int, nargs="+", default=[4096, 3584],
                    help="K values of the sweep")
    ap.add_argument("--pairs", type=int, default=256, help="pairs per launch (B)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    D, B = 128, args.pairs
    rng = np.random.default_rng(0)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}

    def measure(tag, desc, pair_idx, level):
        secs = _time_per_call(lambda: run(desc, pair_idx, level), dev)
        out[f"{tag}_ms_per_pair"] = secs / B * 1e3
        out[f"{tag}_pairs_per_s"] = B / secs
        print(json.dumps({tag: out[f"{tag}_pairs_per_s"]}), flush=True)

    for K in args.keypoints:
        desc_f = torch.from_numpy(rng.standard_normal((8, K, D)).astype(np.float32)).to(dev)
        pair_idx = torch.from_numpy(rng.integers(0, 8, (B, 2)).astype(np.int32)).to(dev)
        dts = ("bfloat16",) if args.quick else ("float32", "bfloat16")
        for dt in dts:
            desc = desc_f.to(torch.bfloat16) if dt == "bfloat16" else desc_f
            levels = (3, "packed") if args.quick else LEVELS
            for level in levels:
                measure(f"{dt}_K{K}_{NAMES[level]}", desc, pair_idx, level)
    print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
