#!/usr/bin/env python3
"""Smoke test of reconstructor_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # every phase, as a check runs it
    python3 chip_smoke.py --rng-seed 1    # another RANSAC seed in the e2e phase

Phases, each printing one or more lines with its elapsed seconds:

1. device  — the card's name and power limit (nvidia-smi).
2. build   — nvcc builds the CUDA kernel of the main path from the
             source in this checkout.
3. knn     — the top-2 kNN kernel against its plain PyTorch version at
             the fountain dataset's shape (25 images x 4096 keypoints x
             128, all 300 pairs in one launch, as the path's chunk of up
             to 512 pairs takes them): float32 on exactly representable descriptors
             (every output equal), float32 and bfloat16 on random unit
             descriptors (distances within tolerance, final matches
             agreeing at a stated rate), and the edge cases of the TPU
             package's kernel tests (fully masked image, K = 384, a lone
             valid column, exact ties).
4. timing  — kernel, plain version and a torch.matmul + topk yardstick
             at the fountain shape, beside the card's compute bound.
5. e2e     — a 25-view 384x512 scene rendered from a seed goes through
             ``detect_features_from_images`` and ``reconstruct_from_state``
             at the default configuration on the card, with the kernel's
             launch counter set to 0 just before and read just after. It
             must register >= 23 of 25 views with a normalised ATE under
             10% against the rendered poses, and launch the kernel. The
             kernel is then held against its plain version on the very
             inputs the path gave it, and timed there.

The last two lines of standard output are a JSON object describing each
kernel and a JSON object ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero; without CUDA, or without the package beside
this script, it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

T0 = time.perf_counter()
BF16_PEAK = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
F32_PEAK = 67e12        # H100 SXM float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {phase}: {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------------
# kNN inputs and comparisons
# ----------------------------------------------------------------------

def knn_inputs(N: int, K: int, D: int, seed: int, quantized: bool, dev):
    """Descriptors with match structure: every image sees a random subset
    of shared scene points (plus noise) followed by masked padding, as
    SIFT's valid-first slots are. ``quantized`` draws every value as
    k/64 with |k| <= 9, so every dot product is exact in float32 and any
    summation order gives the same bits (and exact ties happen)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    n_pts = 2 * K
    if quantized:
        base = rng.integers(-6, 7, (n_pts, D))
    else:
        base = rng.standard_normal((n_pts, D))
    desc = np.zeros((N, K, D), np.float32)
    mask = np.zeros((N, K), bool)
    for n in range(N):
        count = int(rng.integers(K // 3, K + 1))
        ids = rng.choice(n_pts, count, replace=False)
        if quantized:
            d = base[ids] + rng.integers(-3, 4, (count, D))
            desc[n, :count] = d / 64.0
        else:
            d = base[ids] + 0.35 * rng.standard_normal((count, D))
            desc[n, :count] = d / np.linalg.norm(d, axis=1, keepdims=True)
        mask[n, :count] = True
    mask[min(3, N - 1)] = False          # one image with no keypoints
    desc *= mask[..., None]
    return (torch.from_numpy(desc).to(dev), torch.from_numpy(mask).to(dev))


def all_pairs(N: int, dev):
    """Every unordered pair of N images, as one launch of the path takes
    them (N = 25 gives 300 pairs, inside one 512-pair chunk)."""
    import numpy as np
    import torch
    from reconstructor_tpu_torch.matching import pairs
    p = np.ascontiguousarray(pairs.exhaustive_pairs(N), dtype=np.int32)
    return torch.from_numpy(p).to(dev)


def compare_knn(desc, mask, chunk, exact: bool, tol: float,
                min_match_agree: float, label: str):
    """Kernel vs plain version on identical inputs. Returns a dict of the
    measured errors and agreement rates."""
    import torch
    from reconstructor_tpu_torch.matching import cuda_knn
    bias = torch.where(mask, 0.0, 1e30).to(torch.float32).contiguous()
    k_out = cuda_knn.knn_topk2(desc.contiguous(), bias, chunk)
    torch.cuda.synchronize()
    p_out = cuda_knn.knn_topk2_plain(desc, bias, chunk)
    kb, ks, ka, kc = k_out
    pb, ps, pa, pc = p_out
    i = chunk[:, 0].long()
    j = chunk[:, 1].long()
    rows_valid = mask[i]
    cols_valid = mask[j]
    fin = (pb < 1e29) & (kb < 1e29)
    err_best = (kb - pb).abs()[fin].max().item() if fin.any() else 0.0
    fin2 = (ps < 1e29) & (ks < 1e29)
    err_second = (ks - ps).abs()[fin2].max().item() if fin2.any() else 0.0
    arg_agree = (ka == pa)[rows_valid].double().mean().item()
    col_agree = (kc == pc)[cols_valid].double().mean().item()

    def matches(b, s, a, c):
        ok = (b < 0.49 * s) & rows_valid & (b < 5e29)
        rows = torch.arange(a.shape[1], device=a.device, dtype=torch.int32)
        ok = ok & (torch.gather(c, 1, a.long()) == rows)
        return torch.where(ok, a, -1)
    km = matches(kb, ks, ka, kc)
    pm = matches(pb, ps, pa, pc)
    agree = (km == pm)[rows_valid].double().mean().item()
    n_matches = int((pm >= 0).sum().item())
    res = {"max_abs_err": max(err_best, err_second), "arg_agree": arg_agree,
           "colarg_agree": col_agree, "match_agree": agree, "matches": n_matches}
    log("knn", f"{label}: " + json.dumps(res))
    if exact:
        for name, a, b in (("best", kb, pb), ("second", ks, ps), ("arg", ka, pa),
                           ("colarg", kc, pc)):
            check(torch.equal(a, b), f"{label}: kernel {name} differs from the plain version")
    else:
        check(res["max_abs_err"] <= tol, f"{label}: distance error {res['max_abs_err']} > {tol}")
        check(agree >= min_match_agree,
              f"{label}: final matches agree on {agree:.5f} < {min_match_agree} of rows")
    return res, km


def edge_cases(dev):
    """The cases of the TPU package's kernel tests, on the card: each must
    equal the plain version exactly (index outputs and distances)."""
    import numpy as np
    import torch
    from reconstructor_tpu_torch.matching import cuda_knn
    rng = np.random.default_rng(12)
    cases = []
    # fully masked image 1
    d = rng.standard_normal((2, 128, 128)).astype(np.float32)
    m = np.zeros((2, 128), bool)
    m[0] = True
    cases.append(("fully masked image", d, m, [[0, 1]]))
    # K = 384 (a multiple of 128, not 256)
    base = rng.standard_normal((384, 128)).astype(np.float32)
    d = np.stack([base + 0.1 * rng.standard_normal((384, 128)).astype(np.float32)
                  for _ in range(2)])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cases.append(("K=384", d, np.ones((2, 384), bool), [[0, 1]]))
    # one valid column in image j
    d = rng.standard_normal((2, 128, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[1, 0] = d[0, 5]
    m = np.zeros((2, 128), bool)
    m[0] = True
    m[1, 0] = True
    cases.append(("lone valid column", d, m, [[0, 1]]))
    # exact ties: duplicated descriptors in both images
    q = rng.integers(-4, 5, (64, 128)).astype(np.float32) / 32.0
    d = np.stack([np.concatenate([q, q]), np.concatenate([q[::-1], q])])
    cases.append(("exact ties", d, np.ones((2, 128), bool), [[0, 1], [1, 0], [0, 0]]))
    for name, d, m, pairs in cases:
        for dtype in (torch.float32, torch.bfloat16):
            desc = torch.from_numpy(d).to(dev).to(dtype).contiguous()
            mask = torch.from_numpy(m).to(dev)
            chunk = torch.tensor(pairs, dtype=torch.int32, device=dev)
            bias = torch.where(mask, 0.0, 1e30).to(torch.float32)
            k_out = cuda_knn.knn_topk2(desc, bias, chunk)
            p_out = cuda_knn.knn_topk2_plain(desc, bias, chunk)
            torch.cuda.synchronize()
            for a, b, what in zip(k_out[2:], p_out[2:], ("arg", "colarg")):
                check(torch.equal(a, b), f"edge case {name} ({dtype}): {what} differs")
            # distances: exact where every product is (ties, all-masked);
            # random reals are summed in another order -> a few ulps
            for a, b, what in zip(k_out[:2], p_out[:2], ("best", "second")):
                if name in ("exact ties", "fully masked image"):
                    check(torch.equal(a, b), f"edge case {name} ({dtype}): {what} differs")
                else:
                    check((a - b).abs().max().item() <= 1e-5,
                          f"edge case {name} ({dtype}): {what} off by more than 1e-5")
            fi, fm = cuda_knn.match_all_pairs_fused(desc.float(), mask, chunk)
            if name == "fully masked image":
                check(not bool(fm.any()), "fully masked image produced matches")
            if name == "lone valid column":
                check(bool(fm[0, 5]), "lone valid column: the match failed the ratio test")
        log("knn", f"edge case '{name}': kernel == plain (f32 and bf16)")


def knn_flops(mask, chunk, D: int) -> float:
    """Multiply-adds the data needs: a pair (i, j) takes n_i x n_j dot
    products of length D between its valid keypoints (masked slots and
    the padding to the tile multiple need none)."""
    n = mask.sum(1).double()
    ci = chunk.long()
    return 2.0 * D * float((n[ci[:, 0]] * n[ci[:, 1]]).sum().item())


def knn_bytes(N: int, K: int, D: int, B: int, elt: int) -> float:
    return N * K * D * elt + N * K * 4 + B * 8 + B * K * 16


def time_knn(desc, mask, chunk, label: str):
    """Kernel, plain and library (matmul + topk) times on one input."""
    import torch
    from reconstructor_tpu_torch.matching import cuda_knn
    bias = torch.where(mask, 0.0, 1e30).to(torch.float32).contiguous()
    desc = desc.contiguous()
    N, K, D = desc.shape
    B = chunk.shape[0]
    ms = cuda_ms(lambda: cuda_knn.knn_topk2(desc, bias, chunk))
    plain_ms = cuda_ms(lambda: cuda_knn.knn_topk2_plain(desc, bias, chunk), iters=3, warmup=1)
    ci = chunk.long()

    def library():
        for s in range(0, B, 16):
            i, j = ci[s:s + 16, 0], ci[s:s + 16, 1]
            sim = torch.matmul(desc[i], desc[j].transpose(1, 2)).float()
            dist = (2.0 - 2.0 * sim).clamp_(min=0.0).add_(bias[j][:, None, :])
            torch.topk(dist, 2, dim=2, largest=False)
            torch.min(dist.add_(bias[i][:, :, None]), dim=1)
    library_ms = cuda_ms(library, iters=3, warmup=1)
    elt = desc.element_size()
    peak = BF16_PEAK if desc.dtype == torch.bfloat16 else F32_PEAK
    flops = knn_flops(mask, chunk, D)
    t_ops = flops / peak * 1e3
    t_bytes = knn_bytes(N, K, D, B, elt) / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    res = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "useful_tflops": flops / (ms * 1e-3) / 1e12}
    log("timing", f"{label} (N={N} K={K} D={D} B={B} {desc.dtype}): " + json.dumps(res))
    return res


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def phase_kernels(dev, N: int = 25, K: int = 4096, D: int = 128):
    import torch
    from reconstructor_tpu_torch.matching import cuda_knn
    chunk = all_pairs(N, dev)
    desc_q, mask_q = knn_inputs(N, K, D, seed=1, quantized=True, dev=dev)
    compare_knn(desc_q, mask_q, chunk, exact=True, tol=0.0, min_match_agree=1.0,
                label="fountain shape f32, exactly representable descriptors")
    compare_knn(desc_q.to(torch.bfloat16), mask_q, chunk, exact=True, tol=0.0,
                min_match_agree=1.0, label="fountain shape bf16, exactly representable descriptors")
    desc, mask = knn_inputs(N, K, D, seed=2, quantized=False, dev=dev)
    # f32: the kernel and cuBLAS sum 128 products in different orders;
    # distances in [0, 4] agree to a few float32 ulps
    _, m32 = compare_knn(desc, mask, chunk, exact=False, tol=1e-5,
                         min_match_agree=0.999, label="fountain shape f32, random unit descriptors")
    # bf16 in, f32 accumulate: the same products (exact in f32), other order
    _, m16 = compare_knn(desc.to(torch.bfloat16), mask, chunk, exact=False, tol=1e-5,
                         min_match_agree=0.999, label="fountain shape bf16 vs plain on the same bf16 inputs")
    rows_valid = mask[chunk[:, 0].long()]
    agree = (m16 == m32)[rows_valid].float().mean().item()
    log("knn", f"bf16 vs f32 final-match agreement: {agree:.5f} of valid rows "
               f"(bound: >= 0.97; the TPU package's record is 99.1% inlier agreement)")
    check(agree >= 0.97, f"bf16 and f32 matches agree on only {agree:.4f}")
    edge_cases(dev)
    cuda_knn.reset_launches()
    return desc, mask, chunk


def phase_timing(desc, mask, chunk):
    import torch
    for dt in (torch.bfloat16, torch.float32):
        time_knn(desc.to(dt), mask, chunk, "fountain shape")


def phase_e2e(dev, tmp: str, n_views: int = 25, h: int = 384, w: int = 512,
              tex_size: int = 1024, n_blobs: int = 1200, cfg=None, min_registered: int = 23):
    import numpy as np
    import torch
    from reconstructor_tpu_torch.config import ReconstructorConfig
    from reconstructor_tpu_torch.eval import render, synth
    from reconstructor_tpu_torch.io import images as io_images
    from reconstructor_tpu_torch.matching import cuda_knn
    from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor

    t = time.perf_counter()
    scene = render.make_scene(seed=0, n_views=n_views, h=h, w=w, tex_size=tex_size,
                              n_blobs=n_blobs, focal_px=1.2 * max(h, w))
    imgs = [io_images.from_rgb(np.repeat((im * 255).astype(np.uint8)[..., None], 3, -1),
                               path=f"view{i:02d}")
            for i, im in enumerate(scene["images"])]
    log("e2e", f"rendered {n_views} views {h}x{w} in {time.perf_counter() - t:.1f}s")

    cfg = cfg or ReconstructorConfig()
    rec = IncrementalReconstructor(cfg, verbose=False, device=dev)
    cuda_knn.reset_launches()
    t = time.perf_counter()
    state = rec.detect_features_from_images(imgs)
    torch.cuda.synchronize()
    t_detect = time.perf_counter() - t
    counts = state.kp_mask.sum(1)
    log("e2e", f"detect {t_detect:.2f}s, keypoints per view {int(counts.min())}..{int(counts.max())}")
    t = time.perf_counter()
    state = rec.reconstruct_from_state(state, out_folder=os.path.join(tmp, "out"))
    torch.cuda.synchronize()
    t_rec = time.perf_counter() - t
    launches = cuda_knn.LAUNCHES
    for name, ms in rec.timer.totals().items():
        log("e2e", f"stage '{name}': {ms / 1e3:.2f}s")
    ate = synth.pose_ate(state.poses, scene["poses"])
    n_reg = len(state.registered)
    log("e2e", f"reconstruct {t_rec:.2f}s: registered {n_reg}/{n_views} views, "
               f"{state.num_landmarks} landmarks, normalised ATE "
               f"{ate['ate_rmse_normalized'] * 100:.2f}%, knn kernel launches {launches}")
    check(launches > 0, "the main path never launched the kNN kernel")
    check(n_reg >= min_registered, f"registered only {n_reg} of {n_views} views")
    check(ate["ate_rmse_normalized"] < 0.10, f"normalised ATE {ate['ate_rmse_normalized']}")
    check(np.isfinite(state.lm_xyz).all(), "non-finite landmarks")
    check(os.path.getsize(os.path.join(tmp, "out", "clouds", "cloud_final.ply")) > 0,
          "no PLY written")

    # the kernel on the very inputs the main path gave it
    desc_d, mask_d, _ = rec._device_frontend(state)
    check(state.num_images * (state.num_images - 1) // 2 <= cfg.match_chunk_pairs_fused,
          "the scene's pairs no longer fit one launch")
    chunk = all_pairs(state.num_images, dev)
    desc16 = desc_d.to(torch.bfloat16)
    res, _ = compare_knn(desc16, mask_d, chunk, exact=False, tol=1e-5,
                         min_match_agree=0.999, label="main-path inputs bf16")
    timing = time_knn(desc16, mask_d, chunk, "main-path inputs")
    return launches, res, timing, {"registered": n_reg, "landmarks": int(state.num_landmarks),
                                   "ate_normalized": ate["ate_rmse_normalized"],
                                   "detect_s": t_detect, "reconstruct_s": t_rec}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rng-seed", type=int, default=0,
                    help="the reconstructor's RANSAC seed (config.rng_seed) in the e2e phase")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "reconstructor_tpu_torch")):
        print("chip_smoke: reconstructor_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from reconstructor_tpu_torch.config import ReconstructorConfig
    from reconstructor_tpu_torch.matching import cuda_knn
    from reconstructor_tpu_torch.utils import cuda_build

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)} | torch {torch.__version__} "
                  f"cuda {torch.version.cuda} | nvidia-smi: {smi}")

    t = time.perf_counter()
    cuda_build.load(cuda_knn.SOURCE)
    log("build", f"{cuda_knn.SOURCE}: {time.perf_counter() - t:.1f}s")

    desc, mask, chunk = phase_kernels(dev)
    phase_timing(desc, mask, chunk)
    del desc, mask
    torch.cuda.empty_cache()

    kernel = {"name": "knn_top2", "route": "cuda",
              "source": "reconstructor_tpu_torch/" + cuda_knn.SOURCE,
              "replaces": cuda_knn.REPLACES}
    with tempfile.TemporaryDirectory() as tmp:
        launches, res, t, summary = phase_e2e(
            dev, tmp, cfg=ReconstructorConfig(rng_seed=args.rng_seed))
    kernel.update(launches=launches, max_abs_err=res["max_abs_err"], ms=t["ms"],
                  plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                  library_ms=t["library_ms"])
    log("e2e", json.dumps(summary))
    log("done", f"total {time.perf_counter() - T0:.1f}s")
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
