#!/usr/bin/env python3
"""Smoke test of reconstructor_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # every phase, as a check runs it
    python3 chip_smoke.py --rng-seed 1    # another RANSAC seed in the e2e phases
    python3 chip_smoke.py --pnp-replay build/pnp_dlt6.npz   # keep the PnP replay inputs

Phases, each printing one or more lines with its elapsed seconds:

1. device   — the card's name and power limit (nvidia-smi).
2. build    — nvcc builds the eight CUDA kernel sources in this checkout,
              side by side (one nvcc process per source), and prints every
              kernel's registers, static shared memory and spills
              (``-Xptxas -v``), the bf16 kNN launch that the kNN, packed
              and level kernels share (pipeline stages, shared memory) and
              the Sinkhorn kernel's cluster plan at the learned path's chunk.
3. knn      — the top-2 kNN kernel against its plain PyTorch version at
              the fountain dataset's shape (25 images x 4096 keypoints x
              128, all 300 pairs in one launch, as the path's chunk of up
              to 512 pairs takes them): float32 on exactly representable descriptors
              (every output equal), float32 and bfloat16 on random unit
              descriptors (distances within tolerance, final matches
              agreeing at a stated rate), the edge cases of the TPU
              package's kernel tests (fully masked image, K = 384, a lone
              valid column, exact ties), and SuperPoint's 256-wide
              descriptors (25 x 1024 x 256, exactly representable, every
              output equal in float32 and bfloat16; then timed in bf16);
              masks with holes, so that the bf16 kernel's column extents
              are not valid counts (25 x 1280: exact inputs equal, random
              ones at the rates above); the default path's launch shape
              (25 x 1280, SIFT-like valid prefixes of 445-1082) against
              the plain version and timed beside its bound and the
              library call; D = 384 and 512, exactly representable, every
              output equal.
4. timing   — kNN kernel, plain version and a torch.matmul + topk
              yardstick at the fountain shape, beside the card's bound.
5. sinkhorn — the Sinkhorn kernel against its plain PyTorch version on
              seeded random scores with ragged masks (one image fully
              masked, one with a single valid slot), at K = 1024, 8 pairs,
              100 iterations and K = 256, 8 pairs, 50 iterations: max error
              over valid entries and bins, masked entries, marginals,
              decoded matches; then kernel and plain times and the bound;
              the launch plan (cluster size); the same checks with holes
              in the masks, and after 1 and 2 iterations (the masked rows'
              and columns' closed forms before convergence); 0 iterations
              return the coupling itself; M != N both ways round with an
              image of no valid slot; K = 2048 and 4096 (more columns than
              a block has threads, rows read from device memory).
6. packed   — the packed-int32 kNN kernel (``knn_topk2(packed=True)``)
              against its plain version: the kNN edge cases (every output
              equal, but for bf16 distances on real-valued inputs: within
              one 2^-17 step, each one step at most from the float64
              distance's step and then beside a step boundary; the lone
              valid column passes the ratio test through the 1e30
              sentinel), the fountain shape on exactly
              representable descriptors (equal) and on random unit ones
              (argmins agreeing on >= 99.9% of rows, distances within one
              2^-17 step), both again with holes in the masks, the bf16
              launch timed at the fountain shape, then the port's
              ``scripts/check_packed.py`` (packed against the float
              kernel, the same rates) with the launch counters set to 0
              just before, then both of its launches (f32, bf16) against
              the plain version and timed (and, after the learned phase,
              traced: device time of each kernel a call, launches and host
              time a call).
7. levels   — the level-by-level kNN kernel of the port's
              ``scripts/profile_knn_kernel.py`` against its plain version
              at every level (index outputs equal on exactly representable
              descriptors and on the script's own unnormalised inputs, f32
              and bf16; argmins agreeing on >= 99.9% on random unit ones,
              bf16), level 3 equal to the kNN kernel with zero bias bit for
              bit on each of these inputs, then the script's full sweep
              (counters set to 0 just before), then every bf16 level timed
              on the sweep's input and on random unit descriptors, each
              beside its bound and its library chain, and the kNN kernel
              with zero bias on the sweep's input.
8. fgate    — the F-gate's Sampson-count kernel (kernel 7,
              ``geometry/cuda_fgate.py``) against its plain version, every
              count equal bit for bit, at ``FGATE_CASES``' shapes (the
              benchmark cell's 512-pair chunk and its ragged last chunk of
              342, stride 1 at K = 256, the learned path's 64 pairs, H =
              128 and 2,048, K = 8,192), each with an all-masked pair, F = 0
              and a NaN hypothesis; the wrapper refusing float64 and
              non-contiguous inputs; then a whole pass of the benchmark's
              ``match100-k4096`` cell (its configuration and scene
              generator): one launch a chunk, the first and the last
              chunks' counts equal to the plain version's, and the tables
              equal to a pass with the plain chain in the kernel's place;
              the kernel's ms and traced device time at the first chunk
              beside its bound, the plain chain's ms, both passes' ms.
9. segsum   — the fixed-order segment-sum kernel of the PCG solver
              (kernel 5) against its plain version (``index_add_`` over the
              live rows): ragged layouts with integer values (empty
              segments among short and long ones, long ones split over
              many blocks, one segment holding every live row, no mask,
              every row masked; widths 1-144), equal bit for bit and empty
              segments exactly zero; then random values at the street
              problem's shapes (500,000 live observations into 112
              cameras at W = 12 and 144, into 131,072 points at W = 3 and
              9) and at the saved fountain problem's (32 x 16,384, 65,536
              observations): three calls equal bit for bit, within 2e-6 of
              the magnitudes from a float64 sum; kernel, plain and
              ``index_add_`` times beside the bound, the kernel and
              ``index_add_`` also traced one call at a time (the card's
              busy time a call, and the wrapper's host share). Then the
              fused Schur-sum kernel (kernel 6, ``ba/cuda_schur.py``):
              both directions (W^T u into landmarks, W z into cameras)
              equal to their plain versions bit for bit on ragged integer
              inputs (u in shared memory and not), then at the street and
              fountain shapes on random Y, u, z: three calls equal, within
              3e-6 of float64 sums of the products' magnitudes; kernel,
              plain, the chain it replaced (gather + einsum + kernel 5)
              and the library chain (gather + einsum + ``index_add_``)
              timed beside the bound, each traced (device ms, launches a
              call). It runs after the learned phase, beside the packed
              trace: a process's first torch.profiler session leaves a
              one-time cost in the next path's stages.
10. render   — the 25-view 384x512 scene, rendered once from a seed for
              the end-to-end and profile phases.
11. e2e     — the default path (SIFT, kNN + F-gate, PnP, BA) through
              ``detect_features_from_images`` and ``reconstruct_from_state``
              on the card, with every kernel's launch counter set to 0 just
              before and read just after. It must register >= 23 of 25
              views with a normalised ATE under 10% against the rendered
              poses, and launch the kNN kernel. The kernel is then held
              against its plain version on the very inputs the path gave
              it, and timed there. Then the estimators the path does not
              call, on its data: ``estimate_fundamental`` on 64 of its
              pairs with the F-gate's draws (>= 99.9% of slots as the
              F-gate), ``estimate_essential`` + ``recover_pose`` on its
              initial pair, ``solve_pnp_ransac(minimal="dlt6")`` beside
              P3P on 8 registrations (see ``estimators_on_card``).
12. learned — the learned path (SuperPoint from
              ``tests/data/superpoint_synth.npz``, the structured 18-layer
              256-wide SuperGlue at 1024 keypoints, 100 Sinkhorn
              iterations, F-gate, PnP, BA) through the same entry points,
              with the same limits, and it must launch the Sinkhorn
              kernel. The kernel is then held against its plain version on
              the scores of the run's first chunk of pairs, and timed there.
              Last, the trained 4-layer GNN of
              ``tests/data/superglue_fountain.npz`` scores that chunk on
              the card and on the CPU, which must agree (the structured
              GNN's output does not depend on its attention layers).
13. profile — the port's ``scripts/profile_incremental.py`` on the first
              5 views of the rendered scene (the initial pair and three
              views registered after it; one final refinement round instead
              of six): wall seconds, device-busy share, launches and top
              kernels per stage, from a torch.profiler trace. It fails if a
              stage that launched CUDA work shows no device time, or if the
              registered count differs from an unprofiled run of the same
              views and seed.
14. orb     — the ORB path (FAST + rotated BRIEF at D = 256, kNN + F-gate,
              PnP, BA) on every third view (9 views at a 5.25 degree step:
              at the scene's 1.75 degree step ORB's initial pair cannot
              triangulate, in the JAX package too), default configuration.
              It must register 9/9 with a normalised ATE under 10% and
              launch the kNN kernel; the kernel in bf16 must then equal its
              plain version exactly on the run's descriptors (every entry
              +-1/16 or 0), and is timed there. The initial pair sees
              mostly one wall, so a RANSAC draw can take a wrong motion
              that fits as well and fails to triangulate; the phase prints
              how many of 10 single draws pass on the run's matches.
15. pcg     — (a) the default path with ``ba_solver="pcg"``: every bundle
              adjustment through the implicit-Schur PCG solver (counted),
              the segment-sum, fused Schur-sum and point-block kernels
              launched (the same counts in both runs), with the e2e
              phase's limits;
              run twice, both as users run it, and the two end states must
              be equal bit for bit (every sum over observations in a fixed
              order); then the segment-sum kernel on the J_c^T r rows of
              the run's last BA problem and the Schur-sum kernel on its Y,
              against their plain versions, timed; then the point-block
              kernel (kernel 8, H_pp^-1 v) at the PCG cells' L (2^20,
              2^23) and at that problem's L on random SPD inverses: equal
              bit for bit to ``block3_matvec_reference`` (its fixed
              order) everywhere and to the einsum it replaced at the
              cells' L, timed beside that einsum, a ``bmm`` of contiguous
              blocks and its bound (60 B a landmark at 3.35 TB/s);
              (b) a street-scale problem over
              the dense budget (100 cameras x 100,000 points, ~5e5
              observations, built on the card from a seed with
              ``tests/test_ba.py``'s noise model): the driver's rule must
              pick PCG; PCG and the dense solver then run on it, each to a
              final RMS within 10% of the 0.5 px noise, PCG finite, the
              gauge camera unmoved; costs, gap, iterations, wall time and
              peak memory printed.
16. mesh    — the multi-device path (``parallel.mesh``,
              ``parallel.sharding``, ``ba.distributed.solve_distributed``).
              In this process, over a world of one under NCCL (a
              ``FileStore`` in the temporary directory): (a) the default
              path with ``mesh=`` at the pcg phase's seed and
              configuration, as users run it: every BA through
              ``solve_distributed``, the kNN, segment-sum and Schur-sum
              kernels
              launched, and the end state equal to the pcg run's bit for
              bit; stage times beside the pcg run's; (b) the learned run's
              first two chunks (16 pairs) through
              ``match_superglue_sharded`` beside ``match_pairs_batched``:
              indices and masks equal, scores within 1e-5, the Sinkhorn
              kernel launched; (c) the street problem through
              ``solve_distributed`` beside ``solve_pcg``: final costs within
              1e-4 relative, RMS within the pcg phase's limit, the gauge
              camera unmoved; both wall times, the all-reduce calls and
              one all-reduce's time. The group is then destroyed. (d) The
              port's ``run_multiproc_dryrun.py`` with 2 ranks sharing the
              card under gloo, and with 1: both ok, the 2 ranks with one
              final BA cost below the initial / 100, every rank's match
              table equal to the 1-rank run's, the kNN kernel launched in
              each rank, and the driver's run with ``mesh=`` (5 rendered
              views) ending in one state on every rank. (e) One NCCL rank
              per card, min(4, count) ranks, the same checks, when there
              are 2 or more cards; otherwise one line says it did not run.
17. resume  — the ORB phase's run with autosaves every 3 registrations:
              the autosave made when the third view registered loads field
              for field equal to the state saved, and a fresh reconstructor
              resumed from it ends in the uninterrupted run's state bit for
              bit.
18. ate     — a golden PLY of the scene's true camera centres written by
              the port; ``ate_vs_golden`` on the e2e phase's centres within
              a factor of 2 of its pose ATE, and ``ate_floor_vs_golden``
              under 1%.
19. measure — the port's six photograph-measuring scripts on the rendered
              scene, which stands in for the photographs: (a)
              ``measure_match100`` on the 25 views tiled 4x (100 images,
              4,950 pairs): 10 kNN launches a pass (counters set to 0 just
              before), every tiled copy's ungated table equal to its
              pair's, each valid row of the 150 self-pairs its own best
              column on >= 99.9% of rows, the kernel on one 512-pair chunk
              against its plain version (final matches equal in float32,
              >= 99.9% in bf16, bf16 against float32 >= 97%) and timed
              beside its bound; (b) ``bench_knn_dtype``: finite pairs/s in
              both dtypes, inlier agreement >= 0.95; (c)
              ``profile_match100_decomp`` cases A-G: finite medians, case
              C's chunks (B = 256) equal to (a)'s ungated tables (B = 512);
              (d) ``exp_match_regression``: packed and float argmins agree
              on >= 99.9% of valid rows at each width (the packed launches
              counted), then the packed kernel on (a)'s chunk against its
              plain version and timed; (e) ``profile_detect`` on the 25
              views: every stage timed; (f) ``exp_quality``'s 12 variants
              on every third view against a golden PLY of their true
              centres: no variant fails, ``default`` 9/9 with ATE < 10%.
20. distill — the port's ``scripts/distill_fountain.py`` on the rendered
              views at the script's widths and depth (the teacher the
              port's SIFT, the bank from views 0-19): finite losses, the
              last 50 steps' mean loss under 0.8x the first 50's, the
              float16 npz reloading to the weights saved; ms a step, the
              phase's seconds, held-out recall and precision at 2 px
              against the teacher on views 20-24.
21. train-superglue — the port's ``scripts/train_superglue.py`` on the
              rendered views at the script's widths and pairs (600 of its
              1,500 steps): step 0 decodes every validation pair as the
              structured identity, bit for bit; finite losses that fall;
              the trained weights decode some pair otherwise than the
              identity; the trained and the best weights through
              ``params_to_npz`` / ``params_from_npz`` decode the same
              matches; the Sinkhorn kernel launched once a ``match_pair``
              call of ``val_f1`` (the kernels line's ``sinkhorn_val_f1``
              row: this path's launches, and the kernel timed at its
              B = 1, K = 512); every validation's F1, ms a step.
22. stress  — the port's ``scripts/stress_synth.py`` path at full width
              (``eval/synth``'s circular rig, 2,000 points + 128 clutter
              slots a view, 128-D descriptors, K = 2,176) at the script's
              100 views (4,950 pairs), autosaving every 50 views (users'
              default of 3 would spend minutes compressing full-state
              files): >= 98% of the views registered, normalised ATE
              under 6%, the kNN kernel launched once per chunk of 512
              pairs, and one ``triangulate_batch`` call larger than the
              eigensolver's slice (``EIGH_BATCH``); landmarks,
              observations, BAs per solver (the driver's count), kNN
              launches, autosave time and wall printed. The kNN kernel
              is then held against its plain version on the run's first
              chunk (N = 100, Kt = 2,304, 512 pairs) and timed there
              beside its bound. A fresh
              reconstructor resumed from the autosave made at half the
              views ends in the uninterrupted run's state bit for bit; then
              ``scripts/stress_report.py`` on the final autosave gives the
              run's counts and ATE.
23. ba-profile — the port's ``scripts/profile_ba.py`` on the saved
              fountain BA problem (``out/ba_problem_final.npz``): every piece
              of the dense and PCG solvers per call, the segment-sum kernel
              beside ``index_add_``, each full solve's device-busy share.
24. train   — SuperPoint trained on the card by the port's
              ``scripts/train_frontend.py`` at the JAX script's defaults
              (1,500 steps of 2 scenes, 24 scenes x 6 views at 160 px;
              autograd, cuDNN, Adam): ms a step, the wall, a finite loss
              that falls, the script's held-out metrics; then the JAX
              package's own bars for the weights it writes: detector
              recall at 2 px > 0.15 on ``make_scene(seed=33, n_views=3)``
              and the learned path (structured SuperGlue, 50 Sinkhorn
              iterations, 256 keypoints) on ``make_scene(seed=21,
              n_views=8)`` at RANSAC seeds 0-3: 8/8 views, > 60
              landmarks and normalised ATE under 10% at 3 seeds of the 4
              at least, the Sinkhorn kernel launched. The committed
              ``tests/data/superpoint_synth.npz`` runs the same scenes and
              seeds and is printed beside them, not gated. The weights'
              sha256 says whether training repeated.
25. ba-variants — the dense LM's Schur products at the three precisions
              against float64 ('highest' and 'high' within 1e-6 of the
              operands' scale, 'default''s one bf16 pass coarser); then
              the port's ``scripts/check_ba_variants.py``
              on the saved fountain problem and the 100 x 40,000 synthetic
              one (8 rows: float32 and bf16 storage, compact or not, the
              three Schur precisions, w16, hcc16; 3 warm solves a row):
              'high' must end within 1e-3 relative of 'highest''s final
              cost on both; the bf16-storage rows are recorded.
26. scaling — the port's ``scripts/bench_scaling.py`` (raw and gated kNN
              pairs/s, distributed BA seconds at 32 images x 512 keypoints
              and 25 cameras x 5,000 points) and ``diag_scaling.py`` with
              worlds of 1 and 2 gloo ranks sharing the card: the 2-rank
              match and gated tables equal the 1-rank ones, every rank of
              a world ends with one BA cost, iteration count and cost
              trace; ``diag_scaling``'s fit and replicated pieces on the
              bench's BA times; with two or more cards, bench_scaling with
              one NCCL rank per card.

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
from concurrent.futures import ThreadPoolExecutor

T0 = time.perf_counter()
BF16_PEAK = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
F32_PEAK = 67e12        # H100 SXM float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
SFU_EXP_PER_CLOCK_PER_SM = 16   # H100 special-function units: exponentials


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {phase}: {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(text: str):
    """Registers, static shared memory and spills of each kernel from
    nvcc's ``-Xptxas -v`` report."""
    import re
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return out


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

def knn_inputs(N: int, K: int, D: int, seed: int, quantized: bool, dev,
               counts=None, holes: bool = False):
    """Descriptors with match structure: every image sees a random subset
    of shared scene points (plus noise) followed by masked padding, as
    SIFT's valid-first slots are. ``quantized`` draws every value as
    k/64 with |k| <= 9, so every dot product is exact in float32 and any
    summation order gives the same bits (and exact ties happen).
    ``counts``: the (lo, hi) range of valid slots per image (default
    K/3..K); ``holes``: masks a random tenth of each image's valid slots
    too, so the masks are not prefixes."""
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
    lo, hi = counts or (K // 3, K)
    for n in range(N):
        count = int(rng.integers(lo, hi + 1))
        ids = rng.choice(n_pts, count, replace=False)
        if quantized:
            d = base[ids] + rng.integers(-3, 4, (count, D))
            desc[n, :count] = d / 64.0
        else:
            d = base[ids] + 0.35 * rng.standard_normal((count, D))
            desc[n, :count] = d / np.linalg.norm(d, axis=1, keepdims=True)
        mask[n, :count] = True
    mask[min(3, N - 1)] = False          # one image with no keypoints
    if holes:
        mask &= np.random.default_rng(seed + 1000).uniform(size=mask.shape) >= 0.1
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


def edge_case_inputs():
    """The cases of the TPU package's kernel tests: (name, desc, mask,
    pairs) as numpy."""
    import numpy as np
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
    return cases


def edge_cases(dev):
    """The cases of the TPU package's kernel tests, on the card: each must
    equal the plain version exactly (index outputs and distances)."""
    import torch
    from reconstructor_tpu_torch.matching import cuda_knn
    for name, d, m, pairs in edge_case_inputs():
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


def knn_bytes(N: int, K: int, D: int, B: int, elt: int, bias_elt: int = 4) -> float:
    return N * K * D * elt + N * K * bias_elt + B * 8 + B * K * 16


def time_knn(desc, mask, chunk, label: str, kernel=None, plain=None, bias_elt: int = 4,
             library=None):
    """Kernel, plain and library (matmul + topk + column min) times on one
    input, beside the bound. ``kernel`` / ``plain`` / ``library`` default
    to the top-2 kNN kernel, its plain version on the float bias of
    ``mask`` and that chain of PyTorch calls."""
    import torch
    from reconstructor_tpu_torch.matching import cuda_knn
    bias = torch.where(mask, 0.0, 1e30).to(torch.float32).contiguous()
    desc = desc.contiguous()
    N, K, D = desc.shape
    B = chunk.shape[0]
    kernel = kernel or (lambda: cuda_knn.knn_topk2(desc, bias, chunk))
    plain = plain or (lambda: cuda_knn.knn_topk2_plain(desc, bias, chunk))
    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain, iters=3, warmup=1)
    ci = chunk.long()

    def top2_library():
        for s in range(0, B, 16):
            i, j = ci[s:s + 16, 0], ci[s:s + 16, 1]
            sim = torch.matmul(desc[i], desc[j].transpose(1, 2)).float()
            dist = (2.0 - 2.0 * sim).clamp_(min=0.0).add_(bias[j][:, None, :])
            torch.topk(dist, 2, dim=2, largest=False)
            torch.min(dist.add_(bias[i][:, :, None]), dim=1)
    library_ms = cuda_ms(library or top2_library, iters=3, warmup=1)
    elt = desc.element_size()
    peak = BF16_PEAK if desc.dtype == torch.bfloat16 else F32_PEAK
    flops = knn_flops(mask, chunk, D)
    t_ops = flops / peak * 1e3
    t_bytes = knn_bytes(N, K, D, B, elt, bias_elt) / HBM_BYTES_PER_S * 1e3
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
    knn_superpoint_width(dev)
    knn_non_prefix_masks(dev)
    knn_default_shape(dev)
    knn_wide_descriptors(dev)
    cuda_knn.reset_launches()
    return desc, mask, chunk


def knn_wide_descriptors(dev, N: int = 6, K: int = 512):
    """The widest descriptors the kernel takes (D = 384 and 512: three and
    two pipeline stages of the bf16 kernel): exactly representable values,
    so every output equals the plain version's, in float32 and bfloat16."""
    import torch
    chunk = all_pairs(N, dev)
    for D in (384, 512):
        desc, mask = knn_inputs(N, K, D, seed=D, quantized=True, dev=dev, holes=True)
        for dt in (torch.float32, torch.bfloat16):
            compare_knn(desc.to(dt), mask, chunk, exact=True, tol=0.0, min_match_agree=1.0,
                        label=f"N={N} K={K} D={D} {dt}, exactly representable")


def knn_non_prefix_masks(dev, N: int = 25, K: int = 1280, D: int = 128):
    """Masks with holes (a tenth of each image's valid slots masked), so
    the bf16 kernel's column extents are not valid counts: exactly
    representable descriptors give every output equal in float32 and
    bfloat16, random unit ones agree at the rates of the fountain shape."""
    import torch
    chunk = all_pairs(N, dev)
    desc, mask = knn_inputs(N, K, D, seed=5, quantized=True, dev=dev, holes=True)
    for dt in (torch.float32, torch.bfloat16):
        compare_knn(desc.to(dt), mask, chunk, exact=True, tol=0.0, min_match_agree=1.0,
                    label=f"non-prefix masks N={N} K={K} {dt}, exactly representable")
    desc, mask = knn_inputs(N, K, D, seed=6, quantized=False, dev=dev, holes=True)
    compare_knn(desc.to(torch.bfloat16), mask, chunk, exact=False, tol=1e-5,
                min_match_agree=0.999, label=f"non-prefix masks N={N} K={K} bf16, random unit")


def knn_default_shape(dev, N: int = 25, K: int = 1280, D: int = 128):
    """The default path's launch: 25 views at Kt = 1280 with ragged valid
    prefixes of 445-1082 keypoints, as SIFT gives on the rendered scene;
    bf16 against the plain version, then timed beside the bound and the
    library call."""
    import torch
    chunk = all_pairs(N, dev)
    desc, mask = knn_inputs(N, K, D, seed=7, quantized=False, dev=dev, counts=(445, 1082))
    desc = desc.to(torch.bfloat16)
    compare_knn(desc, mask, chunk, exact=False, tol=1e-5, min_match_agree=0.999,
                label=f"default-path shape N={N} K={K} bf16, SIFT-like prefixes")
    return time_knn(desc, mask, chunk, "default-path shape, SIFT-like prefixes")


def knn_superpoint_width(dev, N: int = 25, K: int = 1024, D: int = 256):
    """SuperPoint's 256-wide descriptors (the learned detector with the kNN
    matcher): exactly representable values, so every output of the kernel
    equals the plain version's, in float32 and in bfloat16."""
    import torch
    chunk = all_pairs(N, dev)
    desc, mask = knn_inputs(N, K, D, seed=3, quantized=True, dev=dev)
    for dt in (torch.float32, torch.bfloat16):
        compare_knn(desc.to(dt), mask, chunk, exact=True, tol=0.0, min_match_agree=1.0,
                    label=f"SuperPoint width N={N} K={K} D={D} {dt}, exactly representable")
    return time_knn(desc.to(torch.bfloat16), mask, chunk, "SuperPoint width")


def phase_timing(desc, mask, chunk):
    import torch
    for dt in (torch.bfloat16, torch.float32):
        time_knn(desc.to(dt), mask, chunk, "fountain shape")


# ----------------------------------------------------------------------
# Sinkhorn inputs and comparisons
# ----------------------------------------------------------------------

def sinkhorn_inputs(B: int, K: int, seed: int, plant: float, dev, holes: bool = False):
    """Seeded (B, K, K) scores: unit normal noise plus ``plant`` on a random
    permutation for half the rows (so the decode finds matches), ragged
    valid prefixes, pair 1's image 0 fully masked and pair 2's image 1
    with a single valid slot (for B > 2). At these scales the plain loop's
    marginals converge to ~1e-6 in the stated iterations. ``holes``: a
    random tenth of the valid slots masked too, so the masks are not
    prefixes."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((B, K, K)).astype(np.float32)
    m0 = np.zeros((B, K), bool)
    m1 = np.zeros((B, K), bool)
    for b in range(B):
        c0, c1 = rng.integers(K // 3, K + 1, 2)
        m0[b, :c0] = True
        m1[b, :c1] = True
        perm = rng.permutation(K)
        rows = rng.choice(K, K // 2, replace=False)
        scores[b, rows, perm[rows]] += plant
    if holes:
        hole = np.random.default_rng(seed + 1000)
        m0 &= hole.uniform(size=m0.shape) >= 0.1
        m1 &= hole.uniform(size=m1.shape) >= 0.1
    if B > 2:
        m0[1] = False
        m1[2] = False
        m1[2, 0] = True
    return (torch.from_numpy(scores).to(dev), torch.from_numpy(m0).to(dev),
            torch.from_numpy(m1).to(dev))


def compare_sinkhorn(scores, alpha, m0, m1, iters: int, label: str,
                     marginal_tol=1e-3):
    """Kernel vs plain version on identical inputs: max error over the
    valid entries and the bins (<= 1e-4), masked entries (<= -1e8 in
    both), the row and column marginals of exp(Z) against log_mu / log_nu
    (to ``marginal_tol`` in log space; ``None``: as close as the plain
    version's own, within 1e-4), and the decoded matches (mutual argmax,
    score > 0.5) on >= 99.9% of valid rows. Returns a dict."""
    import torch
    from reconstructor_tpu_torch.matching import cuda_sinkhorn, superglue
    C, mu, nu, norm = cuda_sinkhorn.augment(scores, alpha, m0, m1)
    zk = cuda_sinkhorn.sinkhorn_kernel(C, mu, nu, iters)
    torch.cuda.synchronize()
    zp = cuda_sinkhorn.sinkhorn_plain(C, mu, nu, iters)
    ones = torch.ones_like(m0[:, :1])
    valid = (torch.cat([m0, ones], 1)[:, :, None] & torch.cat([m1, ones], 1)[:, None, :])
    err = (zk - zp).abs()[valid].max().item()
    masked = max(zk[~valid].max().item(), zp[~valid].max().item()) if (~valid).any() else -1e30

    def marginal_residual(z):
        zd = z.double()
        r = (torch.logsumexp(zd, 2) - mu.double())[mu > -1e8]
        c = (torch.logsumexp(zd, 1) - nu.double())[nu > -1e8]
        return max(r.abs().max().item(), c.abs().max().item())
    res_k, res_p = marginal_residual(zk), marginal_residual(zp)
    shift = norm[:, None, None]
    ik, ok_k, _ = superglue.decode(zk - shift, m0, 0.5)
    ip, ok_p, _ = superglue.decode(zp - shift, m0, 0.5)
    agree = (ik == ip)[m0].double().mean().item()
    res = {"max_abs_err": err, "masked_max": masked, "marginal_residual": res_k,
           "plain_marginal_residual": res_p, "match_agree": agree,
           "matches": int(ok_k.sum().item())}
    log("sinkhorn", f"{label}: " + json.dumps(res))
    check(err <= 1e-4, f"{label}: kernel off the plain version by {err} > 1e-4")
    check(masked <= -1e8, f"{label}: a masked entry reached {masked} > -1e8")
    if marginal_tol is None:
        check(res_k <= res_p + 1e-4, f"{label}: marginal residual {res_k} vs plain {res_p}")
    else:
        check(res_k <= marginal_tol, f"{label}: marginal residual {res_k} > {marginal_tol}")
    check(agree >= 0.999, f"{label}: decoded matches agree on {agree:.5f} < 0.999 of rows")
    return res


def sinkhorn_bound(m0, m1, iters: int):
    """The least time for the work: the exponentials the data needs at the
    special-function units' rate (SMs x 16 per clock x the card's maximum
    SM clock from nvidia-smi), against C in and Z out (plus the marginals)
    at the memory rate. A pair with n0 and n1 valid keypoints takes
    (n0 + 1) x (n1 + 1) exponentials (the bins included) in each half-step
    of each iteration: a masked entry of a valid row or column is exp(-1e9)
    = 0 in float32, and a masked row's or column's log-sum-exp is its bin
    alone. Returns (ms, bound_by, detail)."""
    import torch
    B, M = m0.shape
    N = m1.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n0 = m0.sum(1).double() + 1
    n1 = m1.sum(1).double() + 1
    exps = 2.0 * iters * float((n0 * n1).sum().item())
    t_ops = exps / (sms * SFU_EXP_PER_CLOCK_PER_SM * mhz * 1e6) * 1e3
    M1, N1 = M + 1, N + 1
    t_bytes = (2 * B * M1 * N1 + B * (M1 + N1)) * 4 / HBM_BYTES_PER_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, {"exps": exps, "sms": sms, "sm_clock_mhz": mhz,
                                     "ops_ms": t_ops, "bytes_ms": t_bytes}


def time_sinkhorn(scores, alpha, m0, m1, iters: int, label: str):
    """Kernel and plain times (CUDA events, warm) beside the bound. No
    single PyTorch call computes this function, so there is no library
    time."""
    from reconstructor_tpu_torch.matching import cuda_sinkhorn
    C, mu, nu, _ = cuda_sinkhorn.augment(scores, alpha, m0, m1)
    B, M1, N1 = C.shape
    ms = cuda_ms(lambda: cuda_sinkhorn.sinkhorn_kernel(C, mu, nu, iters))
    plain_ms = cuda_ms(lambda: cuda_sinkhorn.sinkhorn_plain(C, mu, nu, iters), iters=3, warmup=1)
    bound, by, detail = sinkhorn_bound(m0, m1, iters)
    res = {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound,
           "bound_by": by, **detail}
    log("timing", f"sinkhorn {label} (B={B} M1={M1} N1={N1} iters={iters}): " + json.dumps(res))
    return res


def sinkhorn_rectangular(dev, alpha, iters: int = 40):
    """Images with different keypoint capacities (M != N, either way
    round), non-prefix masks, one pair whose image 1 has no valid slot
    and one whose image 0 has none: the kernel against its plain version
    (marginals as close as the plain loop's own)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(7)
    for B, M, N in ((4, 384, 256), (4, 200, 520)):
        scores = (2 * rng.standard_normal((B, M, N))).astype(np.float32)
        m0 = rng.uniform(size=(B, M)) < 0.7
        m1 = rng.uniform(size=(B, N)) < 0.7
        m1[1] = False
        m0[2] = False
        compare_sinkhorn(torch.from_numpy(scores).to(dev), alpha, torch.from_numpy(m0).to(dev),
                         torch.from_numpy(m1).to(dev), iters,
                         f"rectangular M={M} N={N} B={B} iters={iters}", marginal_tol=None)


def phase_sinkhorn(dev):
    import torch
    from reconstructor_tpu_torch.matching import cuda_sinkhorn
    alpha = torch.tensor(1.0, device=dev)
    for B, K, iters, plant in ((8, 1024, 100, 10.0), (8, 256, 50, 8.0)):
        scores, m0, m1 = sinkhorn_inputs(B, K, seed=K, plant=plant, dev=dev)
        label = f"random K={K} B={B} iters={iters}"
        compare_sinkhorn(scores, alpha, m0, m1, iters, label)
        log("sinkhorn", f"launch plan B={B} M1=N1={K + 1}: "
                        + json.dumps(cuda_sinkhorn.plan(B, K + 1, K + 1, dev)))
        time_sinkhorn(scores, alpha, m0, m1, iters, label)
        scores, m0, m1 = sinkhorn_inputs(B, K, seed=K + 1, plant=plant, dev=dev, holes=True)
        compare_sinkhorn(scores, alpha, m0, m1, iters, f"non-prefix masks K={K} B={B} "
                                                       f"iters={iters}")
    # 1 and 2 iterations: the closed forms of the masked rows and columns
    # before the loop has converged (marginals as close as the plain
    # loop's own); 0 iterations return the coupling itself
    for iters in (1, 2):
        compare_sinkhorn(scores, alpha, m0, m1, iters, f"non-prefix masks K={K} B={B} "
                                                       f"iters={iters}", marginal_tol=None)
    C, mu, nu, _ = cuda_sinkhorn.augment(scores, alpha, m0, m1)
    check(torch.equal(cuda_sinkhorn.sinkhorn_kernel(C, mu, nu, 0), C),
          "sinkhorn with 0 iterations is not the coupling itself")
    sinkhorn_rectangular(dev, alpha)
    # more columns than a block has threads, and more rows than a cluster's
    # shared memory holds (read from device memory)
    for B, K, iters in ((2, 2048, 30), (1, 4096, 10)):
        scores, m0, m1 = sinkhorn_inputs(B, K, seed=K, plant=10.0, dev=dev, holes=True)
        compare_sinkhorn(scores, alpha, m0, m1, iters, f"non-prefix masks K={K} B={B} "
                                                       f"iters={iters}", marginal_tol=None)
        log("sinkhorn", f"launch plan B={B} M1=N1={K + 1}: "
                        + json.dumps(cuda_sinkhorn.plan(B, K + 1, K + 1, dev)))
    cuda_sinkhorn.reset_launches()


# ----------------------------------------------------------------------
# the packed kNN kernel and the level-by-level kernel
# ----------------------------------------------------------------------

STEP = 2.0 ** -17   # the packed kernels' distance step


TRACE_SESSIONS = 3   # profiler sessions trace_calls tries before it gives up


def trace_calls(fn, iters: int = 20) -> dict:
    """``iters`` calls of ``fn`` (after a warm one) under a torch.profiler
    trace, each synchronised inside its own window: a call's host
    milliseconds (profiler overhead included), CUDA launches, device-busy
    milliseconds and its kernels by device time (``utils/profiling``'s
    stage summary). Says whether a small call is bound by the card or by
    its host-side launches. The busy time is that of the device events
    launched inside the windows: the trace's card timestamps can drift
    from the host's by more than a kernel of a few microseconds lasts, so
    the same time clipped to the windows (``clipped_busy_ms``) can miss
    it. A session whose trace holds no device event at all (CUPTI now
    and then delivers none; seen in the segsum phases) is traced again,
    up to ``TRACE_SESSIONS`` in all; the check then holds the last
    session."""
    import torch
    from reconstructor_tpu_torch.utils import profiling
    fn()
    torch.cuda.synchronize()
    for session in range(1, TRACE_SESSIONS + 1):
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.trace(tmp, device="cuda"):
                for _ in range(iters):
                    with profiling.annotate("call"):
                        fn()
                        torch.cuda.synchronize()
            summary = profiling.stage_summary(os.path.join(tmp, profiling.TRACE_FILE), ["call"],
                                              top=8)
        st = summary["call"]
        if summary["all"]["busy_s"] is not None:
            break
        log("trace", f"session {session} of {TRACE_SESSIONS}: no device event in the trace "
                     f"({st['launches']} launches)")
    check(st["launched_busy_s"],
          f"trace_calls: no device time traced for the calls' launches "
          f"({st['launches']} launches, clipped busy {st['busy_s']} s)")
    return {"calls": st["windows"], "host_ms": st["wall_s"] * 1e3 / iters,
            "launches": st["launches"] / iters,
            "busy_ms": st["launched_busy_s"] * 1e3 / iters,
            "clipped_busy_ms": st["busy_s"] * 1e3 / iters,
            "kernels_ms": [[name[:60], sec * 1e3 / iters]
                           for name, sec in st["launched_kernels"]]}


def packed_bias(mask):
    import torch
    from reconstructor_tpu_torch.matching import cuda_knn
    return torch.where(mask, 0, cuda_knn._DMAX).to(torch.int32).contiguous()


def quantised(dist):
    """A float distance as the packed kernels give it from the same
    product: its 2^-17 step, clip((2 - 2 sim) * 2^17, 0, 2^19 - 2)
    truncated (exact: the scale is a power of two), or the 1e30 sentinel
    for a masked one."""
    import torch
    from reconstructor_tpu_torch.matching import cuda_knn
    q = torch.floor(torch.clamp(dist * 2.0 ** 17, 0.0, float(cuda_knn._DMAX - 1))) * STEP
    return torch.where(dist >= 1e29, 1e30, q)


def packed_matches_knn_kernel(desc, mask, chunk, packed_out, label: str):
    """bf16: the packed kernel and the kNN kernel take one tensor-core
    product, so on any input the packed best and second are the kNN
    kernel's (float bias of the same mask) quantised, bit for bit: the
    quantisation is monotone, so the smallest key holds the step of the
    smallest distance, and the second key the step of the second."""
    import torch
    from reconstructor_tpu_torch.matching import cuda_knn
    bias = torch.where(mask, 0.0, 1e30).to(torch.float32).contiguous()
    b1, s1, _, _ = cuda_knn.knn_topk2(desc.contiguous(), bias, chunk)
    for name, a, b in (("best", packed_out[0], b1), ("second", packed_out[1], s1)):
        check(torch.equal(a, quantised(b)),
              f"{label}: packed {name} is not the kNN kernel's {name} quantised")


def packed_steps_f64(desc, mask, chunk, kernel, plain, rank: int, label: str) -> dict:
    """A witness independent of both products for one packed distance
    output (``rank`` 0: best, 1: second): the distances of the same
    descriptors in float64 on the CPU, their ``rank``-th smallest over
    image j's valid slots per row, quantised to the 2^-17 step. Wherever
    the kernel's finite distance is not that step it must be one step from
    it, with the float64 distance within ``tol`` of the boundary between
    the two: a float32 sum of D products in any order lies within
    D 2^-24 |a||b| of the exact dot product, doubled by 2 - 2 sim, plus the
    rounding of that difference (``compare_levels``' bound, 4 D 2^-24
    |a|^2). That bound is several steps wide, so the returned counts say
    more: finite entries; the kernel off the float64 step, the plain
    version off it, the two apart, the kernel on the float64 step where
    the two are apart; and where the kernel is off the float64 step, or
    apart from the plain version, how far (in steps) the float64 distance
    lies from the boundary between the two steps at most."""
    import torch
    from reconstructor_tpu_torch.matching import cuda_knn
    d = desc.double().cpu()
    ci = chunk.long().cpu()
    valid_j = mask.cpu()[ci[:, 1]][:, None, :]
    dist = (2.0 - 2.0 * torch.einsum("bkd,bld->bkl", d[ci[:, 0]], d[ci[:, 1]])).clamp(min=0.0)
    ref = dist.masked_fill(~valid_j, float("inf")).sort(dim=2).values[..., rank]
    D = d.shape[2]
    tol = 4.0 * D * 2.0 ** -24 * d.pow(2).sum(-1).max().item() + 2.0 ** -21
    fin = torch.isfinite(ref)
    x = ref[fin] * 2.0 ** 17
    q = torch.floor(x.clamp(0.0, cuda_knn._DMAX - 1))
    k = torch.round(kernel.double().cpu()[fin] / STEP)
    p = torch.round(plain.double().cpu()[fin] / STEP)
    off = k != q
    near = (k - q).abs() == 1
    boundary = torch.maximum(k, q)
    near &= (x - boundary).abs() <= tol * 2.0 ** 17
    check(bool((~off | near).all()),
          f"{label}: {int((off & ~near).sum())} distances off the float64 step and not "
          f"beside a step boundary (tol {tol:.3g})")
    apart = k != p

    def gap(sel, other):
        return (x - torch.maximum(k, other))[sel].abs().max().item() if sel.any() else None
    return {"finite": int(fin.sum()), "kernel_off_f64": int(off.sum()),
            "plain_off_f64": int((p != q).sum()), "kernel_vs_plain": int(apart.sum()),
            "kernel_on_f64_where_apart": int((apart & ~off).sum()),
            "max_gap_steps_kernel_off_f64": gap(off, q),
            "max_gap_steps_apart": gap(apart, p)}


def compare_packed(desc, mask, chunk, exact: bool, label: str, min_agree: float = 0.999):
    """Packed kernel vs its plain version on identical inputs. ``exact``:
    every output equal. Otherwise float32 sums in another order can move a
    distance across one 2^-17 step, so distances agree within one step and
    the argmins on ``min_agree`` of valid rows and columns; which rows have
    no valid column (the 1e30 sentinel) always agrees. In bf16 the
    distances are also the kNN kernel's quantised, bit for bit
    (``packed_matches_knn_kernel``). Returns a dict."""
    import torch
    from reconstructor_tpu_torch.matching import cuda_knn
    bias = packed_bias(mask)
    k_out = cuda_knn.knn_topk2(desc.contiguous(), bias, chunk, packed=True)
    kb, ks, ka, kc = k_out
    torch.cuda.synchronize()
    pb, ps, pa, pc = cuda_knn.knn_topk2_packed_plain(desc, bias, chunk)
    rows_valid = mask[chunk[:, 0].long()]
    cols_valid = mask[chunk[:, 1].long()]

    def err(a, b):
        fin = (a < 1e29) & (b < 1e29)
        return (a - b).abs()[fin].max().item() if fin.any() else 0.0
    res = {"max_abs_err": max(err(kb, pb), err(ks, ps)),
           "arg_agree": (ka == pa)[rows_valid].double().mean().item(),
           "colarg_agree": (kc == pc)[cols_valid].double().mean().item(),
           "sentinel_agree": bool(torch.equal(kb >= 1e29, pb >= 1e29)
                                  and torch.equal(ks >= 1e29, ps >= 1e29))}
    log("packed", f"{label}: " + json.dumps(res))
    if exact:
        for name, a, b in (("best", kb, pb), ("second", ks, ps), ("arg", ka, pa),
                           ("colarg", kc, pc)):
            check(torch.equal(a, b), f"{label}: packed kernel {name} differs from the plain version")
    else:
        check(res["max_abs_err"] <= STEP + 1e-6,
              f"{label}: packed distances off by {res['max_abs_err']} > 2^-17 + 1e-6")
        check(res["arg_agree"] >= min_agree, f"{label}: arg agrees on {res['arg_agree']:.5f}")
        check(res["colarg_agree"] >= min_agree,
              f"{label}: colarg agrees on {res['colarg_agree']:.5f}")
        check(res["sentinel_agree"], f"{label}: the 1e30 sentinel differs")
    if desc.dtype == torch.bfloat16:
        packed_matches_knn_kernel(desc, mask, chunk, k_out, label)
    return res


def packed_edge_cases(dev):
    """The kNN edge cases through the packed kernel, in float32 and
    bfloat16: index outputs equal to the plain version's; the quantised
    distances equal too in float32 (at these sizes the SIMT product sums
    in the plain version's order) and where every product is exact (ties,
    all-masked). In bf16 the tensor-core product sums in another order, so
    on the real-valued cases a distance near a step boundary can land one
    2^-17 step from the plain version's: there the distances are within
    one step of it, equal, bit for bit, to the kNN kernel's quantised
    (``packed_matches_knn_kernel``), and each on the step of the float64
    distance or one step from it beside a step boundary
    (``packed_steps_f64``). The lone valid column matches through the
    sentinel (second best 1e30)."""
    import torch
    from reconstructor_tpu_torch.matching import cuda_knn
    witness = {}
    for name, d, m, pairs in edge_case_inputs():
        for dtype in (torch.float32, torch.bfloat16):
            desc = torch.from_numpy(d).to(dev).to(dtype).contiguous()
            mask = torch.from_numpy(m).to(dev)
            chunk = torch.tensor(pairs, dtype=torch.int32, device=dev)
            bias = packed_bias(mask)
            k_out = cuda_knn.knn_topk2(desc, bias, chunk, packed=True)
            p_out = cuda_knn.knn_topk2_packed_plain(desc, bias, chunk)
            torch.cuda.synchronize()
            for a, b, what in zip(k_out[2:], p_out[2:], ("arg", "colarg")):
                check(torch.equal(a, b), f"packed edge case {name} ({dtype}): {what} differs")
            for a, b, what in zip(k_out[:2], p_out[:2], ("best", "second")):
                if dtype == torch.float32 or name in ("exact ties", "fully masked image"):
                    check(torch.equal(a, b), f"packed edge case {name} ({dtype}): {what} differs")
                else:
                    fin = b < 1e29
                    off = (a - b).abs()[fin].max().item() if fin.any() else 0.0
                    check(torch.equal(a >= 1e29, b >= 1e29) and off <= STEP,
                          f"packed edge case {name} ({dtype}): {what} off by {off} > 2^-17")
                    witness[f"{name} {what}"] = packed_steps_f64(
                        desc, mask, chunk, a, b, 0 if what == "best" else 1,
                        f"packed edge case {name} ({dtype}) {what}")
            if dtype == torch.bfloat16:
                packed_matches_knn_kernel(desc, mask, chunk, k_out,
                                          f"packed edge case {name} ({dtype})")
            kb, ks, ka, kc = k_out
            if name == "fully masked image":
                check(bool((kb[0] >= 1e29).all()), "packed: a fully masked image has a best")
            if name == "lone valid column":
                check(bool(ks[0, 5] >= 1e29) and bool(kb[0, 5] < 0.49 * ks[0, 5])
                      and int(ka[0, 5]) == 0 and int(kc[0, 0]) == 5,
                      "packed: the lone valid column failed the ratio or mutual test")
        log("packed", f"edge case '{name}': packed kernel == plain (f32; bf16 indices, "
                      f"distances within a step and == the kNN kernel's quantised)")
    log("packed", "bf16 edge cases against float64 distances: " + json.dumps(witness))


def phase_packed(dev, N: int = 25, K: int = 4096, D: int = 128):
    """The packed kernel against its plain version, then the port's
    check_packed (the main path of this kernel) with every counter at 0
    just before; returns (launches, result, timing), each a dict by dtype
    of check_packed's two launches (float32: the SIMT product; bfloat16:
    the tensor-core product), the last two on check_packed's inputs."""
    import torch
    from reconstructor_tpu_torch.matching import cuda_knn
    from reconstructor_tpu_torch.scripts import check_packed
    packed_edge_cases(dev)
    chunk = all_pairs(N, dev)
    desc_q, mask_q = knn_inputs(N, K, D, seed=1, quantized=True, dev=dev)
    for dt in (torch.float32, torch.bfloat16):
        compare_packed(desc_q.to(dt), mask_q, chunk, exact=True,
                       label=f"fountain shape {dt}, exactly representable descriptors")
    desc, mask = knn_inputs(N, K, D, seed=2, quantized=False, dev=dev)
    for dt in (torch.float32, torch.bfloat16):
        compare_packed(desc.to(dt), mask, chunk, exact=False,
                       label=f"fountain shape {dt}, random unit descriptors")
    # holes in the masks: the bf16 kernel's column extents are not valid
    # counts, and warps with all rows masked add no column keys
    for exact, seed in ((True, 8), (False, 9)):
        d_h, m_h = knn_inputs(N, K, D, seed=seed, quantized=exact, dev=dev, holes=True)
        kind = "exactly representable" if exact else "random unit"
        for dt in (torch.float32, torch.bfloat16):
            compare_packed(d_h.to(dt), m_h, chunk, exact=exact,
                           label=f"fountain shape {dt}, masks with holes, {kind}")
    del d_h, m_h
    desc16 = desc.to(torch.bfloat16).contiguous()
    bias16 = packed_bias(mask)
    time_knn(desc16, mask, chunk, "packed kernel, fountain shape",
             kernel=lambda: cuda_knn.knn_topk2(desc16, bias16, chunk, packed=True),
             plain=lambda: cuda_knn.knn_topk2_packed_plain(desc16, bias16, chunk))
    del desc, mask, desc_q, mask_q, desc16
    torch.cuda.empty_cache()

    # the main path: check_packed, packed against the float kernel
    cuda_knn.reset_launches()
    out = check_packed.main([])
    bf16 = cuda_knn.LAUNCHES_PACKED_BF16
    launches = {torch.float32: cuda_knn.LAUNCHES_PACKED - bf16, torch.bfloat16: bf16}
    log("packed", f"check_packed: {json.dumps(out)}, packed launches "
                  f"{cuda_knn.LAUNCHES_PACKED} (bf16 {bf16})")
    for dt, n in launches.items():
        check(n > 0, f"check_packed never launched the packed kernel in {dt}")
    for dt in ("float32", "bfloat16"):
        check(out[f"{dt}_arg_agree"] >= 0.999, f"check_packed {dt}: arg agreement {out}")
        check(out[f"{dt}_colarg_agree"] >= 0.999, f"check_packed {dt}: colarg agreement {out}")
        check(out[f"{dt}_best_maxerr"] <= STEP + 1e-6, f"check_packed {dt}: best error {out}")
        check(out[f"{dt}_sentinel_agree"] == 1.0, f"check_packed {dt}: sentinel {out}")
    # the kernel on check_packed's own inputs, both launches of the path:
    # vs its plain version, timed
    d, m, p = check_packed.inputs()
    mask = torch.from_numpy(m).to(dev)
    chunk = torch.from_numpy(p).to(dev)
    bias = packed_bias(mask)
    res, timing = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        desc = torch.from_numpy(d).to(dev).to(dt).contiguous()
        res[dt] = compare_packed(desc, mask, chunk, exact=False,
                                 label=f"check_packed inputs {dt}")
        timing[dt] = time_knn(desc, mask, chunk, "packed kernel, check_packed inputs",
                              kernel=lambda: cuda_knn.knn_topk2(desc, bias, chunk, packed=True),
                              plain=lambda: cuda_knn.knn_topk2_packed_plain(desc, bias, chunk))
    cuda_knn.reset_launches()
    return launches, res, timing


def trace_packed(dev):
    """check_packed's two launches, each call traced (``trace_calls``).
    Run after the end-to-end phases: a process's first torch.profiler
    session pays a one-time cost of seconds that would otherwise leave the
    first torch.func call, in the default path's initial-pair stage."""
    import torch
    from reconstructor_tpu_torch.matching import cuda_knn
    from reconstructor_tpu_torch.scripts import check_packed
    d, m, p = check_packed.inputs()
    mask = torch.from_numpy(m).to(dev)
    chunk = torch.from_numpy(p).to(dev)
    bias = packed_bias(mask)
    for dt in (torch.float32, torch.bfloat16):
        desc = torch.from_numpy(d).to(dev).to(dt).contiguous()
        log("packed", f"check_packed inputs {dt}, one call traced: " + json.dumps(trace_calls(
            lambda: cuda_knn.knn_topk2(desc, bias, chunk, packed=True))))


def level_inputs(K: int, dev, kind: str, N: int = 8, D: int = 128, B: int = 256,
                 seed: int = 0):
    """The level script's shapes. ``kind``: ``exact``, k/64 values with
    |k| <= 6, so every dot product is exact in float32 and ties are common;
    ``sweep``, the script's own unnormalised standard normals and pairs;
    ``unit``, those normals scaled to unit length (distinct distances in
    [0, 4], as real descriptors give)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if kind == "exact":
        desc = rng.integers(-6, 7, (N, K, D)).astype(np.float32) / 64.0
    else:
        desc = rng.standard_normal((N, K, D)).astype(np.float32)
        if kind == "unit":
            desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    pairs = rng.integers(0, N, (B, 2)).astype(np.int32)
    return torch.from_numpy(desc).to(dev), torch.from_numpy(pairs).to(dev)


def compare_levels(desc, chunk, kind: str, label: str) -> float:
    """Kernel 4 vs run_plain at every level, and level 3 equal to the kNN
    kernel with zero bias, bit for bit (in bf16 both take the same tensor-
    core product, so on any input). Against the plain version: on
    ``exact`` inputs every output equal; on the script's ``sweep`` inputs
    index outputs equal and distances within the float32 bound of two dot
    products of length D summed in different orders, |d sim| <= D 2^-24
    |a||b| each, doubled by 2 - 2 sim, or one 2^-17 step for the packed
    level; on ``unit`` inputs (where near-equal distances are common)
    distances within that bound and argmins agreeing on >= 99.9% of rows
    and columns. Returns level 3's largest distance error."""
    import torch
    from reconstructor_tpu_torch.matching import cuda_knn
    from reconstructor_tpu_torch.scripts import profile_knn_kernel as pk
    err3 = 0.0
    D = desc.shape[2]
    rounding = 4.0 * D * 2.0 ** -24 * desc.float().pow(2).sum(-1).max().item()
    for level in pk.LEVELS:
        kb, ks, ka, kc = pk.run(desc, chunk, level)
        torch.cuda.synchronize()
        pb, ps, pa, pc = pk.run_plain(desc, chunk, level)
        arg_agree = (ka == pa).double().mean().item()
        col_agree = (kc == pc).double().mean().item()
        if kind == "unit":
            check(arg_agree >= 0.999 and col_agree >= 0.999,
                  f"{label} level {level}: argmins agree on {arg_agree:.5f} / {col_agree:.5f}")
        else:
            check(torch.equal(ka, pa) and torch.equal(kc, pc),
                  f"{label} level {level}: index outputs differ from the plain version")
        errs = [(a - b).abs().max().item() for a, b in ((kb, pb), (ks, ps))]
        tol = 0.0 if kind == "exact" else (STEP if level == "packed" else rounding)
        check(max(errs) <= tol, f"{label} level {level}: distances off by {errs} > {tol}")
        if level == 3:
            err3 = max(errs)
            zero = torch.zeros(desc.shape[:2], dtype=torch.float32, device=desc.device)
            k1 = cuda_knn.knn_topk2(desc, zero, chunk)
            for a, b in zip((kb, ks, ka, kc), k1):
                check(torch.equal(a, b), f"{label}: level 3 differs from the kNN kernel")
        # the script's unnormalised inputs clip most rows' best to 0
        zeros = (pb == 0).double().mean().item()
        log("levels", f"{label} level {level}: argmins agree on {arg_agree:.6f} / "
                      f"{col_agree:.6f}, distance error {max(errs):.3g} (tol {tol:.3g}), "
                      f"best == 0 on {zeros:.4f} of rows"
                      + (", == kNN kernel (zero bias) bit for bit" if level == 3 else ""))
    return err3


def level_library(desc, chunk, level):
    """The yardstick of a level: the chain of PyTorch calls that computes
    its reductions over the matmul's distances (0: amin; 1: min with
    argmin; 2: topk of 2; 3 and packed: topk of 2 and the column min with
    argmin, the float function the packed keys quantise)."""
    import torch
    ci = chunk.long()

    def run():
        for s in range(0, ci.shape[0], 16):
            i, j = ci[s:s + 16, 0], ci[s:s + 16, 1]
            sim = torch.matmul(desc[i], desc[j].transpose(1, 2)).float()
            dist = (2.0 - 2.0 * sim).clamp_(min=0.0)
            if level == 0:
                dist.amin(2)
            elif level == 1:
                torch.min(dist, dim=2)
            else:
                torch.topk(dist, 2, dim=2, largest=False)
                if level != 2:
                    torch.min(dist, dim=1)
    return run


def time_levels(desc, chunk, label: str):
    """Every level of kernel 4 timed beside its bound (all K^2 products
    of each pair), its plain version and its library chain. Returns
    {level: timing}."""
    import torch
    from reconstructor_tpu_torch.scripts import profile_knn_kernel as pk
    mask = torch.ones(desc.shape[:2], dtype=torch.bool, device=desc.device)
    out = {}
    for level in pk.LEVELS:
        out[level] = time_knn(desc, mask, chunk, f"level kernel, level {level}, {label}",
                              kernel=lambda: pk.run(desc, chunk, level),
                              plain=lambda: pk.run_plain(desc, chunk, level), bias_elt=0,
                              library=level_library(desc, chunk, level))
    return out


def phase_levels(dev, K: int = 4096):
    """Kernel 4 against its plain version, then the port's
    profile_knn_kernel sweep (its main path) with every counter at 0 just
    before, then every bf16 level timed on the sweep's input and on unit
    descriptors; returns (launches, result, timing of level 3 on the
    sweep's input)."""
    import torch
    from reconstructor_tpu_torch.matching import cuda_knn
    from reconstructor_tpu_torch.scripts import profile_knn_kernel as pk
    for kind in ("exact", "sweep"):
        desc, chunk = level_inputs(K, dev, kind)
        for dt in (torch.float32, torch.bfloat16):
            name = "exactly representable" if kind == "exact" else "the script's unnormalised"
            compare_levels(desc.to(dt).contiguous(), chunk, kind, f"K={K} {dt} {name}")
    desc, chunk = level_inputs(K, dev, "unit")
    unit16 = desc.to(torch.bfloat16).contiguous()
    compare_levels(unit16, chunk, "unit", f"K={K} bf16 random unit")
    del desc
    torch.cuda.empty_cache()
    pk.reset_launches()
    cuda_knn.reset_launches()
    out = pk.main([])
    launches = pk.LAUNCHES
    log("levels", f"profile_knn_kernel sweep: {json.dumps(out)}, launches {launches}")
    check(launches > 0, "profile_knn_kernel never launched the level kernel")
    # every level on the sweep's first input (the script's own seed), bf16
    desc, chunk = level_inputs(K, dev, "sweep")
    desc = desc.to(torch.bfloat16).contiguous()
    err = compare_levels(desc, chunk, "sweep", f"sweep input K={K} bf16")
    timing = time_levels(desc, chunk, "sweep input")
    # the kNN kernel on the same input (zero bias, every tile computed): its
    # mask handling is all that it runs beyond level 3
    time_knn(desc, torch.ones(desc.shape[:2], dtype=torch.bool, device=dev), chunk,
             "kNN kernel, zero bias, sweep input")
    time_levels(unit16, chunk, "random unit")
    pk.reset_launches()
    cuda_knn.reset_launches()
    return launches, {"max_abs_err": err}, timing[3]


# ----------------------------------------------------------------------
# kernel 7: the F-gate's Sampson counts
# ----------------------------------------------------------------------

# name: (B pairs, H hypotheses, K slots, stride). Every case has one pair
# all masked, holes in the other masks that are not a prefix, and F = 0
# and an F holding a NaN among its hypotheses.
FGATE_CASES = {
    "cell_chunk": (512, 512, 3840, 4),       # match100-k4096's chunk
    "ragged_chunk": (342, 512, 3840, 4),     # the last of its 4,950 pairs
    "stride1_k256": (64, 512, 256, 1),
    "learned_b64": (64, 512, 1024, 4),       # the learned path's chunks of 64
    "h128": (64, 128, 3840, 4),              # H not a multiple of the block
    "h2048": (64, 2048, 3840, 4),
    "k8192": (16, 512, 8192, 4),             # max_keypoints 8,192: two tiles of slots
}
SAMPSON_FLOPS = 35   # one Sampson distance with its clamp, then the threshold test
FGATE_CELL = "benchmark/configs/sift-fountain100.json"


def fgate_inputs(B: int, H: int, K: int, stride: int, dev, seed: int = 0):
    """A chunk of the F-gate on the card: each pair's slots hold one scene
    seen from two 512 x 384 views (focal 614.4, a turn of 3-9 degrees and
    0.6 of sideways travel), 0.5 px of noise, 30% of the second view's
    points replaced by clutter; masks set at random on ~75% of slots (pair
    0 on none). f (B, H, 9): the gate's own 8-point solves on random
    minimal samples of the pair's slots, with f[:, 0] = 0 and a NaN in
    f[:, 1]. Returns (f, pts1, pts2, mask)."""
    import torch
    from reconstructor_tpu_torch.geometry import fgate
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(device=dev, dtype=torch.float32)

    def rand(*shape):
        return torch.rand(*shape, generator=g, **f32)
    X = rand(B, K) * 4.0 - 2.0
    Y = rand(B, K) * 3.0 - 1.5
    Z = rand(B, K) * 4.0 + 5.0
    ang = (0.05 + 0.1 * rand(B))[:, None]
    X2 = torch.cos(ang) * X + torch.sin(ang) * Z - 0.6
    Z2 = torch.cos(ang) * Z - torch.sin(ang) * X

    def view(x, y, z):
        uv = torch.stack([614.4 * x / z + 256.0, 614.4 * y / z + 192.0], -1)
        return uv + 0.5 * torch.randn(B, K, 2, generator=g, **f32)
    p1, p2 = view(X, Y, Z), view(X2, Y, Z2)
    clutter = rand(B, K, 2) * torch.tensor([512.0, 384.0], **f32)
    p2 = torch.where((rand(B, K) < 0.3)[..., None], clutter, p2).contiguous()
    mask = rand(B, K) < 0.75
    mask[0] = False
    idx = torch.randint(0, K, (B, H * 8), generator=g, device=dev)

    def sample(p, c):
        return torch.gather(p[..., c], 1, idx).reshape(B, H, 8)
    hx1, hy1, hx2, hy2 = sample(p1, 0), sample(p1, 1), sample(p2, 0), sample(p2, 1)
    f = fgate._solve_f9(hx1, hy1, hx2, hy2, torch.ones_like(hx1), 8.0)
    f[:, 0] = 0.0
    f[:, 1, 4] = float("nan")
    return f.contiguous(), p1.contiguous(), p2, mask


def fgate_compare(f, p1, p2, mask, stride: int, label: str, thr: float = 9.0):
    """Kernel 7 against its plain version on one chunk: one launch, the
    counts equal bit for bit (so the argmax too), a second call equal.
    Returns (a summary, the counts)."""
    import torch
    from reconstructor_tpu_torch.geometry import cuda_fgate
    before = cuda_fgate.LAUNCHES
    got = cuda_fgate.sampson_counts(f, p1, p2, mask, stride, thr)
    torch.cuda.synchronize()
    check(cuda_fgate.LAUNCHES == before + 1, f"{label}: {cuda_fgate.LAUNCHES - before} launches")
    want = cuda_fgate.sampson_counts_plain(f, p1, p2, mask, stride, thr)
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{label}: kernel {got.dtype} {tuple(got.shape)}, plain {want.dtype} "
          f"{tuple(want.shape)}")
    differ = int((got != want).sum().item())
    check(differ == 0, f"{label}: {differ} of {got.numel()} counts differ from the plain version")
    check(torch.equal(torch.argmax(got, 1), torch.argmax(want, 1)), f"{label}: argmax differs")
    check(torch.equal(cuda_fgate.sampson_counts(f, p1, p2, mask, stride, thr), got),
          f"{label}: a second call differs")
    valid = mask[:, ::stride].sum(1)
    res = {"B": f.shape[0], "H": f.shape[1], "K": mask.shape[1], "stride": stride,
           "scored_slots": int(valid.sum().item()), "max_count": int(got.max().item()),
           "winner_mean": float(got.max(1).values.double().mean().item())}
    log("fgate", f"{label}: kernel == plain, " + json.dumps(res))
    return res, got


def fgate_case(dev, name: str) -> dict:
    """One of ``FGATE_CASES``: kernel == plain, and the degenerate rows
    read what they must (the all-masked pair 0, F = 0 counting every
    scored slot, the NaN hypothesis none)."""
    B, H, K, stride = FGATE_CASES[name]
    f, p1, p2, mask = fgate_inputs(B, H, K, stride, dev, seed=sorted(FGATE_CASES).index(name))
    res, counts = fgate_compare(f, p1, p2, mask, stride, name)
    valid = mask[:, ::stride].sum(1)
    check(int(counts[0].abs().sum().item()) == 0, f"{name}: the all-masked pair counts inliers")
    check(bool((counts[:, 0] == valid).all().item()), f"{name}: F = 0 must count every slot")
    check(int(counts[:, 1].abs().sum().item()) == 0, f"{name}: the NaN hypothesis counts inliers")
    check(res["winner_mean"] > 0.3 * float(valid[1:].double().mean().item()),
          f"{name}: the winners hold few inliers ({res['winner_mean']})")
    return res


def fgate_wrapper_checks(dev) -> None:
    """The wrapper raises on a float64 or non-contiguous CUDA input without
    launching, and ``LAUNCHES`` rises by one for each gated chunk."""
    import torch
    from reconstructor_tpu_torch.geometry import cuda_fgate
    from reconstructor_tpu_torch.matching import gated
    f, p1, p2, mask = fgate_inputs(4, 256, 512, 4, dev)
    bad = {"float64 f": ((f.double(), p1, p2, mask), TypeError),
           "float64 pts1": ((f, p1.double(), p2, mask), TypeError),
           "non-contiguous f": ((torch.cat([f, f], -1)[..., :9], p1, p2, mask), ValueError),
           "non-contiguous pts2": ((f, p1, torch.cat([p2, p2], -1)[..., :2], mask), ValueError),
           "non-contiguous mask": ((f, p1, p2, torch.cat([mask, mask], 1)[:, ::2]), ValueError)}
    before = cuda_fgate.LAUNCHES
    for what, (args, err) in bad.items():
        try:
            cuda_fgate.sampson_counts(*args, 4, 9.0)
        except err:
            continue
        raise AssertionError(f"sampson_counts took a {what}")
    check(cuda_fgate.LAUNCHES == before, "a refused call launched")
    g = torch.Generator(device=dev).manual_seed(1)
    for n in (1, 2):
        gated.filter_pairs(p1, p2, mask, num_hypotheses=256, thresh_px=3.0, generator=g)
        check(cuda_fgate.LAUNCHES == before + n,
              f"{n} gated chunks, {cuda_fgate.LAUNCHES - before} launches")
    log("fgate", f"wrapper: refused {', '.join(bad)}; one launch a gated chunk")


def fgate_cell_pass(dev, here: str, seed: int = 11):
    """match100-k4096's own pass: the cell's scene and configuration
    (``FGATE_CELL``, the benchmark's generator) through ``match_features``,
    recording what the gate hands kernel 7. One launch a chunk (10); the
    first (512 pairs) and the last (342) chunks' counts equal the plain
    version's; a second pass with the plain chain in the kernel's place, on
    the same draws, gives the same tables. Returns (the first chunk's
    recorded arguments, the pass's launches, the pass's seconds with the
    kernel and with the plain chain)."""
    import numpy as np
    import torch
    from benchmark.traffic.match_passes import make_scene
    from reconstructor_tpu_torch.config import ReconstructorConfig
    from reconstructor_tpu_torch.geometry import cuda_fgate
    from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
    from reconstructor_tpu_torch.pipeline.state import ReconstructionState
    with open(os.path.join(here, FGATE_CELL)) as fh:
        cell = json.load(fh)
    cfg = ReconstructorConfig(**cell["reconstructor"]).with_(rng_seed=seed)
    sc = {k: v.cpu().numpy() for k, v in make_scene(cell["scene"], seed, dev).items()}
    N, K = sc["mask"].shape
    state = ReconstructionState(
        num_images=N, max_keypoints=K, xy=sc["xy"], desc=sc["desc"], kp_mask=sc["mask"],
        colors=np.zeros((N, K, 3), np.uint8), shapes=sc["shapes"], intrinsics=sc["intrinsics"])
    kernel = cuda_fgate.sampson_counts
    seen = []

    def recording(*args):
        seen.append(args)
        return kernel(*args)

    def one_pass(counts):
        rec = IncrementalReconstructor(cfg, verbose=False, device=dev)
        state.matches = {}
        cuda_fgate.sampson_counts = counts
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            rec.match_features(state, filter=True)
            torch.cuda.synchronize()
            return dict(state.matches), time.perf_counter() - t
        finally:
            cuda_fgate.sampson_counts = kernel
    one_pass(kernel)                                          # warm: kernels built, loaded
    before = cuda_fgate.LAUNCHES
    tables, pass_s = one_pass(recording)
    launches = cuda_fgate.LAUNCHES - before
    chunks = -(-N * (N - 1) // 2 // cfg.match_chunk_pairs_fused)
    check(launches == chunks == len(seen), f"cell pass: {launches} launches, {chunks} chunks, "
                                           f"{len(seen)} gate calls")
    plain_tables, plain_s = one_pass(cuda_fgate.sampson_counts_plain)
    check(tables.keys() == plain_tables.keys()
          and all(np.array_equal(tables[p], plain_tables[p]) for p in tables),
          "cell pass: the kernel's tables differ from the plain chain's")
    for args, label in ((seen[0], "cell's first chunk"), (seen[-1], "cell's last chunk")):
        f, p1, p2, mask, stride, thr = args
        fgate_compare(f, p1, p2, mask, stride, f"{label} (seed {seed})", thr)
    check(seen[-1][0].shape[0] == N * (N - 1) // 2 - (chunks - 1) * cfg.match_chunk_pairs_fused,
          "cell pass: the last chunk is not the ragged one")
    log("fgate", f"cell pass (seed {seed}): {launches} launches, {len(tables)} tables equal to "
                 f"the plain chain's; pass {pass_s * 1e3:.1f} ms, with the plain chain "
                 f"{plain_s * 1e3:.1f} ms")
    return seen[0], launches, pass_s, plain_s


def fgate_bound(f, mask, stride: int) -> tuple:
    """(ms, by): the least time of one call on an H100: the Sampson
    evaluations the chunk needs (every hypothesis against every valid
    strided slot) at the float32 peak, or its bytes read once and counts
    written once at HBM speed, whichever is larger."""
    B, H = f.shape[:2]
    evals = H * float(mask[:, ::stride].sum().item())
    t_ops = evals * SAMPSON_FLOPS / F32_PEAK * 1e3
    nbytes = f.numel() * 4 + 2 * mask.numel() * 8 + mask.numel() + B * H * 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_fgate(dev, here: str) -> dict:
    """Kernel 7: every ``FGATE_CASES`` case and the wrapper's checks, then
    the cell's own pass; then at the cell's first chunk the kernel's time
    (events; traced device time), the plain chain's and the bound. Returns
    the kernels line's row."""
    import torch
    from reconstructor_tpu_torch.geometry import cuda_fgate
    t0 = time.perf_counter()
    for name in FGATE_CASES:
        fgate_case(dev, name)
        torch.cuda.empty_cache()
    fgate_wrapper_checks(dev)
    (f, p1, p2, mask, stride, thr), launches, pass_s, plain_s = fgate_cell_pass(dev, here)
    ms = cuda_ms(lambda: cuda_fgate.sampson_counts(f, p1, p2, mask, stride, thr), iters=20)
    plain_ms = cuda_ms(lambda: cuda_fgate.sampson_counts_plain(f, p1, p2, mask, stride, thr),
                       iters=3, warmup=1)
    traced = trace_calls(lambda: cuda_fgate.sampson_counts(f, p1, p2, mask, stride, thr))
    bound_ms, by = fgate_bound(f, mask, stride)
    res = {"ms": ms, "device_ms": traced["busy_ms"], "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": by, "launches_a_pass": launches, "pass_ms": pass_s * 1e3,
           "plain_pass_ms": plain_s * 1e3, "kernels_ms": traced["kernels_ms"]}
    log("fgate", f"cell's first chunk (B={f.shape[0]} H={f.shape[1]} K={mask.shape[1]} "
                 f"stride {stride}): " + json.dumps(res))
    log("fgate", f"phase {time.perf_counter() - t0:.1f}s")
    del f, p1, p2, mask
    torch.cuda.empty_cache()
    return {"name": "sampson_counts", "route": "cuda",
            "source": "reconstructor_tpu_torch/" + cuda_fgate.SOURCE,
            "replaces": cuda_fgate.REPLACES, "launches": launches, "max_abs_err": 0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None}


# ----------------------------------------------------------------------
# end to end
# ----------------------------------------------------------------------

def render_views():
    """The fountain-sized scene, rendered once for the end-to-end and
    profile phases."""
    from reconstructor_tpu_torch.scripts import profile_incremental
    t = time.perf_counter()
    scene, imgs = profile_incremental.smoke_scene()
    h, w = imgs[0].shape
    log("render", f"rendered {len(imgs)} views {h}x{w} in {time.perf_counter() - t:.1f}s")
    return scene, imgs


def run_path(dev, tmp: str, phase: str, scene, imgs, cfg, min_registered: int = 23,
             mesh=None, max_ate: float = 0.10):
    """Drive one path through the user's entry points (over ``mesh`` when
    given) with every kernel's launch counter set to 0 just before and
    read just after, and check the reconstruction (at least
    ``min_registered`` views, normalised ATE under ``max_ate``). Returns
    (reconstructor, state, launches, summary)."""
    import numpy as np
    import torch
    from reconstructor_tpu_torch.ba import cuda_blocks, cuda_schur, cuda_segsum
    from reconstructor_tpu_torch.eval import synth
    from reconstructor_tpu_torch.geometry import cuda_fgate
    from reconstructor_tpu_torch.matching import cuda_knn, cuda_sinkhorn
    from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor

    n_views = len(imgs)
    out = os.path.join(tmp, phase)
    rec = IncrementalReconstructor(cfg, verbose=False, device=dev, mesh=mesh)
    cuda_knn.reset_launches()
    cuda_sinkhorn.reset_launches()
    cuda_segsum.reset_launches()
    cuda_schur.reset_launches()
    cuda_blocks.reset_launches()
    cuda_fgate.reset_launches()
    t = time.perf_counter()
    state = rec.detect_features_from_images(imgs)
    torch.cuda.synchronize()
    t_detect = time.perf_counter() - t
    counts = state.kp_mask.sum(1)
    log(phase, f"detect {t_detect:.2f}s, keypoints per view {counts.tolist()}")
    t = time.perf_counter()
    state = rec.reconstruct_from_state(state, out_folder=out)
    torch.cuda.synchronize()
    t_rec = time.perf_counter() - t
    launches = {"knn_top2": cuda_knn.LAUNCHES, "sinkhorn": cuda_sinkhorn.LAUNCHES,
                "seg_sum": cuda_segsum.LAUNCHES, "schur_sums": cuda_schur.LAUNCHES,
                "block3_matvec": cuda_blocks.LAUNCHES, "sampson_counts": cuda_fgate.LAUNCHES}
    for name, ms in rec.timer.totals().items():
        log(phase, f"stage '{name}': {ms / 1e3:.2f}s")
    ate = synth.pose_ate(state.poses, scene["poses"])
    n_reg = len(state.registered)
    log(phase, f"reconstruct {t_rec:.2f}s: registered {n_reg}/{n_views} views, "
               f"{len(state.matches)} matched pairs, {state.num_landmarks} landmarks, "
               f"normalised ATE {ate['ate_rmse_normalized'] * 100:.2f}%, "
               f"kernel launches {json.dumps(launches)}")
    check(n_reg >= min_registered, f"{phase}: registered only {n_reg} of {n_views} views")
    check(ate["ate_rmse_normalized"] < max_ate,
          f"{phase}: normalised ATE {ate['ate_rmse_normalized']}")
    check(np.isfinite(state.lm_xyz).all(), f"{phase}: non-finite landmarks")
    check(os.path.getsize(os.path.join(out, "clouds", "cloud_final.ply")) > 0,
          f"{phase}: no PLY written")
    summary = {"registered": n_reg, "landmarks": int(state.num_landmarks),
               "matched_pairs": len(state.matches),
               "ate_normalized": ate["ate_rmse_normalized"],
               "detect_s": t_detect, "reconstruct_s": t_rec,
               "stages_s": {k: v / 1e3 for k, v in rec.timer.totals().items()}}
    return rec, state, launches, summary


def phase_e2e(dev, tmp: str, scene, imgs, cfg, pnp_replay: str = None):
    """The default path; then the kNN kernel on the inputs it was given."""
    import torch
    rec, state, launches, summary = run_path(dev, tmp, "e2e", scene, imgs, cfg)
    check(launches["knn_top2"] > 0, "the default path never launched the kNN kernel")
    check(launches["sampson_counts"] > 0, "the default path never launched kernel 7")
    cfg = rec.config

    # the kernel on the very inputs the main path gave it
    desc_d, mask_d, _ = rec._device_frontend(state)
    check(state.num_images * (state.num_images - 1) // 2 <= cfg.match_chunk_pairs_fused,
          "the scene's pairs no longer fit one launch")
    chunk = all_pairs(state.num_images, dev)
    desc16 = desc_d.to(torch.bfloat16)
    res, _ = compare_knn(desc16, mask_d, chunk, exact=False, tol=1e-5,
                         min_match_agree=0.999, label="main-path inputs bf16")
    timing = time_knn(desc16, mask_d, chunk, "main-path inputs")
    estimators_on_card(dev, rec, state, scene, replay=pnp_replay)
    return launches["knn_top2"], res, timing, summary, state


def rotation_gap_deg(Ra, Rb) -> float:
    """The angle between two rotations, 2 asin(|Ra - Rb|_F / sqrt 8), in
    float64: exact near zero, where the trace formula's arccos bottoms out
    at ~0.02 degrees for float32 matrices."""
    import numpy as np
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64)) / np.sqrt(8.0)
    return float(np.degrees(2.0 * np.arcsin(min(d, 1.0))))


# DLT6 beside P3P (estimators_on_card), each bound about twice (the
# posed count: under) or ten times (the re-polished gap) the readings on
# the card and on the CPU, both packages
DLT6_POSED_MIN = 3           # of the 8 views; 5 posed in every reading
DLT6_POSE_DEG = 3.0          # posed views' poses: readings up to 1.59 deg
DLT6_POSE_REL = 0.06         # ... and 3.0% of the distance
DLT6_REPOLISH_DEG = 2e-3     # polished again over the DLT6's inliers: readings
DLT6_REPOLISH_REL = 5e-5     # up to 1.1e-4 deg and 2.0e-6 of the distance


def estimators_on_card(dev, rec, state, scene, max_pairs: int = 64, max_views: int = 8,
                       replay: str = None) -> dict:
    """The estimators the path does not call, on the card, on the default
    path's own data (a few seconds):
    (1) ``epipolar.estimate_fundamental`` on the run's pairs that the
        F-gate gates (>= ``min_matches_for_filter`` kNN matches; the first
        ``max_pairs``), each with the F-gate's draws for that pair: its
        inlier masks agree with ``fgate.filter_pairs_scalarized``'s (at
        stride 1, as ``tests/test_features_matching.py:270-290`` holds the
        JAX package) on >= 99.9% of the slots;
    (2) ``estimate_essential`` then ``recover_pose`` on the run's initial
        pair (its highest match count: neighbours 1.75 degrees apart, so
        the translation's direction is ill-posed and only printed): most
        matches inliers, most inliers in front of both cameras, and the
        rotation within 5 degrees of the rendered truth (E's four
        decompositions differ by half turns);
    (3) ``pnp.solve_pnp_ransac(minimal="dlt6")`` beside the P3P default on
        the 2D-3D matches of the ``max_views`` lowest-numbered
        registrations (~0.5 s a view for the two), each on draws made
        here (``replay`` names an npz that keeps them with the inputs and
        both results, for ``tests/replay_pnp_dlt6.py``, which gives the
        JAX package the same draws). The run's landmarks are nearly
        coplanar and far (the smallest singular value of their spread is
        1-4% of the largest), and there the 12 x 12 DLT normal matrix
        (unnormalised coordinates: condition ~3e8) yields poor minimal
        poses, in both packages: the best hypothesis holds 5-20 inliers
        of ~900 where P3P's holds them all. The Gauss-Newton polish is
        weighted by that hypothesis's inliers, so it fits the pose to
        those few points; the final recount then admits nearly all
        matches on some views (posed: DLT6 keeps >= 90% of P3P's
        inliers), and the pose stays off P3P's by up to ~1.6 degrees.
        Gates: at least ``DLT6_POSED_MIN`` views posed; on each posed
        view the inlier masks agree on >= 99%, the poses within
        ``DLT6_POSE_DEG`` and ``DLT6_POSE_REL`` of the distance, and the
        two poses, each polished again over the DLT6's final inliers,
        within ``DLT6_REPOLISH_DEG`` and ``DLT6_REPOLISH_REL`` (the gap is
        the polish's weighting, not another minimum)."""
    import numpy as np
    import torch
    from reconstructor_tpu_torch.geometry import epipolar, fgate, pnp, ransac
    from reconstructor_tpu_torch.matching import cuda_knn
    cfg = rec.config
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {}

    # (1) the F-gate's pairs: kernel 1's matches at the run's settings
    desc_d, mask_d, xy_d = rec._device_frontend(state)
    chunk = all_pairs(state.num_images, dev)
    midx, mmask = cuda_knn.match_all_pairs_fused(
        desc_d, mask_d, chunk, ratio_thresh=cfg.ratio_thresh, cross_check=cfg.cross_check,
        compute_dtype=cfg.knn_compute_dtype)
    K = desc_d.shape[1]
    pc = chunk.long()
    gated = torch.nonzero(mmask.sum(1) >= cfg.min_matches_for_filter)[:max_pairs, 0]
    p1 = xy_d[pc[gated, 0]]
    p2 = xy_d[pc[gated, 1][:, None], torch.clamp(midx[gated].long(), 0, K - 1)]
    m = mmask[gated]
    H = cfg.fundamental_num_hypotheses
    pos = ransac.raw_draws((len(gated), H, 8), dev, gen)
    gate = fgate.filter_pairs_scalarized(p1, p2, m, num_hypotheses=H,
                                         thresh_px=cfg.fundamental_thresh_px, pos=pos)
    thr = cfg.fundamental_thresh_px ** 2
    generic = torch.stack([
        (epipolar.sampson_distance(epipolar.estimate_fundamental(
            p1[b], p2[b], m[b], thresh_px=cfg.fundamental_thresh_px, num_hypotheses=H,
            pos=pos[b])[0], p1[b], p2[b]) < thr) & m[b] for b in range(len(gated))])
    agree = (gate == generic)[m].double().mean().item()
    out["fundamental"] = {"pairs": len(gated), "slots": int(m.sum()),
                          "inliers_gate": int(gate.sum()), "inliers_estimate": int(generic.sum()),
                          "agree": agree}

    # (2) the initial pair through E and cheirality
    (i1, i2), mt = max(state.matches.items(), key=lambda kv: (kv[1] >= 0).sum())
    sel = np.where(mt >= 0)[0]
    uv1, uv2 = rec._t(state.xy[i1, sel]), rec._t(state.xy[i2, mt[sel]])
    intr1, intr2 = rec._t(state.intrinsics[i1]), rec._t(state.intrinsics[i2])
    E, inl, cnt = epipolar.estimate_essential(
        uv1, uv2, intr1, intr2, rec._t(np.ones(sel.size, bool)),
        thresh_px=cfg.essential_thresh_px, num_hypotheses=cfg.ransac_num_hypotheses,
        generator=gen)
    pose, counts = epipolar.recover_pose(E, uv1, uv2, intr1, intr2, inl)
    pose = pose.cpu().numpy()
    gt = scene["poses"][i2] @ np.linalg.inv(scene["poses"][i1])
    t_gt = gt[:3, 3] / np.linalg.norm(gt[:3, 3])
    rot_err = rotation_gap_deg(pose[:3, :3], gt[:3, :3])
    out["essential"] = {"pair": [int(i1), int(i2)], "matches": int(sel.size),
                        "inliers": int(cnt), "cheirality_counts": counts.cpu().tolist(),
                        "rotation_err_deg": rot_err,
                        "translation_cos": float(pose[:3, 3] @ t_gt)}

    # (3) registrations by DLT6 beside P3P, on draws made here
    centre = lambda T: -T[:3, :3].T @ T[:3, 3]  # noqa: E731
    H_pnp, iters = cfg.pnp_num_hypotheses, cfg.pnp_refine_iters
    views, kept = [], {}
    for k, img in enumerate(sorted(state.registered)[:max_views]):
        feat = np.where(state.feat2lm[img] >= 0)[0]
        lm = state.feat2lm[img][feat]
        args = (rec._t(state.lm_xyz[lm]), rec._t(state.xy[img, feat]),
                rec._t(state.intrinsics[img]), rec._t(np.ones(feat.size, bool)))
        pos = {m: ransac.raw_draws((H_pnp, n), dev, gen) for m, n in (("p3p", 3), ("dlt6", 6))}
        res = {m: pnp.solve_pnp_ransac(*args, thresh_px=cfg.max_projection_error,
                                       num_hypotheses=H_pnp, refine_iters=iters, pos=pos[m],
                                       minimal=m)[:2] for m in pos}
        w = res["dlt6"][1].to(args[0].dtype)
        polished = [pnp._gauss_newton_refine(res[m][0], *args[:3], w, iters).cpu().numpy()
                    for m in pos]
        (a, ia), (b, ib) = ([x.cpu().numpy() for x in res[m]] for m in pos)
        dist = float(np.linalg.norm(centre(a) - state.lm_xyz[lm].mean(0)))
        rms = [float(pnp._reproj_residual_sq(rec._t(T), *args[:3])[rec._t(ia)].mean()) ** 0.5
               for T in (a, b)]
        views.append({"view": int(img), "matches": int(feat.size),
                      "inliers_p3p": int(ia.sum()), "inliers_dlt6": int(ib.sum()),
                      "inlier_agree": float((ia == ib).mean()),
                      "rms_px_p3p": rms[0], "rms_px_dlt6": rms[1],
                      "rotation_diff_deg": rotation_gap_deg(a[:3, :3], b[:3, :3]),
                      "centre_diff_rel": float(np.linalg.norm(centre(a) - centre(b))) / dist,
                      "repolished_rotation_diff_deg": rotation_gap_deg(polished[0][:3, :3],
                                                                       polished[1][:3, :3]),
                      "repolished_centre_diff_rel": float(np.linalg.norm(
                          centre(polished[0]) - centre(polished[1]))) / dist})
        kept.update({f"view{k}": np.int64(img), f"X{k}": state.lm_xyz[lm].astype(np.float32),
                     f"uv{k}": state.xy[img, feat].astype(np.float32),
                     f"intr{k}": np.asarray(state.intrinsics[img], np.float32),
                     **{f"{x}_{m}{k}": v.cpu().numpy() for m in pos
                        for x, v in (("pos", pos[m]), ("pose", res[m][0]),
                                     ("inliers", res[m][1]))}})
    if replay:
        os.makedirs(os.path.dirname(os.path.abspath(replay)), exist_ok=True)
        np.savez_compressed(replay, thresh_px=np.float64(cfg.max_projection_error),
                            refine_iters=np.int64(iters), **kept)
        log("e2e", f"PnP inputs, draws and results of {len(views)} views written to {replay}")
    posed = [v for v in views if v["inliers_dlt6"] >= 0.9 * v["inliers_p3p"]]
    worst = lambda key, vs: max((v[key] for v in vs), default=None)  # noqa: E731
    out["pnp"] = {"views": len(views), "dlt6_posed": [v["view"] for v in posed],
                  "inliers_p3p_dlt6": [[v["inliers_p3p"], v["inliers_dlt6"]] for v in views],
                  "posed_max_rotation_diff_deg": worst("rotation_diff_deg", posed),
                  "posed_max_centre_diff_rel": worst("centre_diff_rel", posed),
                  "posed_min_inlier_agree": min((v["inlier_agree"] for v in posed),
                                                default=None),
                  "posed_rms_px_p3p_dlt6": [[v["rms_px_p3p"], v["rms_px_dlt6"]] for v in posed],
                  "rotation_diff_deg": [v["rotation_diff_deg"] for v in views],
                  "posed_repolished_max_rotation_diff_deg": worst("repolished_rotation_diff_deg",
                                                                  posed),
                  "posed_repolished_max_centre_diff_rel": worst("repolished_centre_diff_rel",
                                                                posed)}
    out["seconds"] = time.perf_counter() - t0
    log("e2e", "estimators on the card: " + json.dumps(out))
    check(agree >= 0.999, f"estimate_fundamental agrees with the F-gate on {agree:.5f} < 0.999")
    e = out["essential"]
    check(e["inliers"] > e["matches"] // 2, "estimate_essential: too few inliers")
    check(max(e["cheirality_counts"]) > 0.9 * e["inliers"],
          "recover_pose: too few inliers in front of both cameras")
    check(e["rotation_err_deg"] < 5.0, "recover_pose: rotation off the truth")
    p = out["pnp"]
    check(len(posed) >= DLT6_POSED_MIN,
          f"PnP dlt6: {len(posed)} of {len(views)} registrations posed")
    check(all(v["inlier_agree"] >= 0.99 for v in posed),
          "PnP dlt6 vs p3p: the two select other correspondences")
    check(p["posed_max_rotation_diff_deg"] <= DLT6_POSE_DEG
          and p["posed_max_centre_diff_rel"] <= DLT6_POSE_REL,
          "PnP dlt6 vs p3p: a posed view's pose is off P3P's")
    check(p["posed_repolished_max_rotation_diff_deg"] <= DLT6_REPOLISH_DEG
          and p["posed_repolished_max_centre_diff_rel"] <= DLT6_REPOLISH_REL,
          "PnP dlt6 vs p3p: polished over the same inliers, the poses still differ")
    return out


def phase_learned(dev, tmp: str, scene, imgs, cfg):
    """The learned path; then the Sinkhorn kernel on the scores of the
    run's first chunk of pairs."""
    import torch
    from reconstructor_tpu_torch.matching import superglue
    rec, state, launches, summary = run_path(dev, tmp, "learned", scene, imgs, cfg)
    check(launches["sinkhorn"] > 0, "the learned path never launched the Sinkhorn kernel")
    log("learned", f"landmarks {summary['landmarks']} (the JAX package on the CPU: 25/25 "
                   f"views, 3801 landmarks, 4.33% ATE on this scene and settings)")

    cfg = rec.config
    net = rec._superglue_params()
    first = rec.select_pairs(state)[:cfg.superglue_chunk_pairs]
    with torch.no_grad():
        scores, m0, m1 = superglue.pair_scores(
            net, rec._t(state.desc), rec._t(state.xy), rec._t(state.kp_score),
            rec._t(state.kp_mask), rec._t(state.shapes), rec._t(first.astype("int32")))
    label = f"main-path chunk ({len(first)} pairs, K={scores.shape[1]})"
    res = compare_sinkhorn(scores, net.bin_score, m0, m1, cfg.superglue_sinkhorn_iters, label,
                           marginal_tol=None)
    timing = time_sinkhorn(scores, net.bin_score, m0, m1, cfg.superglue_sinkhorn_iters,
                           "main-path chunk")
    trained_gnn_on_card(dev, rec, state, first)
    return launches["sinkhorn"], res, timing, summary, (rec, state)


def trained_gnn_on_card(dev, rec, state, pair_idx):
    """The structured SuperGlue's zeroed last layers discard every
    attention and MLP output, so the e2e run cannot show a fault of the GNN
    on the card (heads layout, matmul precision). Here the trained 4-layer
    ``tests/data/superglue_fountain.npz`` (which the CPU tests hold to the
    JAX package) scores the e2e run's first chunk on the card and on the
    CPU. Scores agree within 1e-4 of their scale plus 1e-4 relative, as the
    CPU tests hold the port to JAX (float32 both, sums in another order);
    the matches decoded from each (the Sinkhorn kernel on both) agree on
    >= 99.5% of valid rows, leaving room for rows whose two best entries,
    or whose best and the 0.5 threshold, lie within that error."""
    import torch
    from reconstructor_tpu_torch.matching import cuda_sinkhorn, superglue
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "data", "superglue_fountain.npz")
    cpu = torch.device("cpu")
    out = []
    for d in (dev, cpu):
        net = superglue.params_from_npz(path).to(d)
        arrays = [torch.as_tensor(a, device=d) for a in
                  (state.desc, state.xy, state.kp_score, state.kp_mask, state.shapes,
                   pair_idx.astype("int32"))]
        t = time.perf_counter()
        with torch.no_grad():
            out.append(superglue.pair_scores(net, *arrays)[0].to(dev))
        torch.cuda.synchronize()
        log("learned", f"trained 4-layer GNN on {d.type}: {time.perf_counter() - t:.2f}s")
    m0 = rec._t(state.kp_mask)[torch.as_tensor(pair_idx[:, 0]).long()]
    m1 = rec._t(state.kp_mask)[torch.as_tensor(pair_idx[:, 1]).long()]
    got, want = out
    valid = m0[:, :, None] & m1[:, None, :]
    err = (got - want).abs()[valid].max().item()
    scale = want.abs()[valid].max().item()
    rel_ok = bool(((got - want).abs() <= 1e-4 * scale + 1e-4 * want.abs())[valid].all())
    alpha = net.bin_score.to(dev)
    iters = rec.config.superglue_sinkhorn_iters
    dec = [superglue.decode(cuda_sinkhorn.log_sinkhorn_fused(sc, alpha, m0, m1, iters), m0, 0.5)
           for sc in (got, want)]
    agree = (dec[0][0] == dec[1][0])[m0].double().mean().item()
    res = {"max_abs_err": err, "scale": scale, "match_agree": agree,
           "matches_card": int(dec[0][1].sum().item()), "matches_cpu": int(dec[1][1].sum().item())}
    log("learned", "trained 4-layer GNN, card vs CPU on the first chunk: " + json.dumps(res))
    check(rel_ok, f"trained GNN scores on the card off the CPU's by {err} (scale {scale})")
    check(agree >= 0.995, f"trained GNN matches, card vs CPU, agree on {agree:.5f} < 0.995")
    return res


def phase_profile(dev, tmp: str, imgs, rng_seed: int, n_views: int = 5):
    """The port's stage profiler on the first ``n_views`` views of the
    rendered scene (the initial pair and the views registered after it),
    with one final refinement round instead of six, then the same views
    unprofiled. Returns the report without its per-kernel lists."""
    from reconstructor_tpu_torch.config import ReconstructorConfig
    from reconstructor_tpu_torch.scripts import profile_incremental
    cfg = ReconstructorConfig(rng_seed=rng_seed, final_refinement_rounds=1)
    views = imgs[:n_views]
    t = time.perf_counter()
    rep = profile_incremental.profile(views, cfg, os.path.join(tmp, "profile"), device=dev)
    log("profile", f"profiled run {time.perf_counter() - t:.1f}s")
    for line in profile_incremental.format_report(rep).splitlines():
        log("profile", line)
    t = time.perf_counter()
    plain = profile_incremental.unprofiled(views, cfg, device=dev)
    log("profile", f"unprofiled run {time.perf_counter() - t:.1f}s: {json.dumps(plain)}")
    check(rep["registered"] == plain["registered"],
          f"profiled run registered {rep['registered']}, unprofiled {plain['registered']}")
    check(rep["registered"] >= 4, f"profile: only {rep['registered']} views registered")
    for name, st in rep["stages"].items():
        if st["launches"] > 0:
            check(st["launched_busy_s"] is not None and st["launched_busy_s"] > 0,
                  f"profile: stage {name} launched {st['launches']} times but the trace "
                  f"shows no device time for those launches")
    check(rep["stages"]["choose_initial_pair"]["launches"] > 0,
          "profile: the initial pair launched no CUDA work")
    summary = {k: v for k, v in rep.items() if k not in ("stages", "top_kernels", "trace")}
    summary["unprofiled"] = plain
    summary["stages"] = {name: {k: st[k] for k in ("wall_s", "calls", "launches", "busy_s",
                                                   "busy_share")}
                         for name, st in rep["stages"].items()}
    log("profile", json.dumps(summary))
    return summary


# ----------------------------------------------------------------------
# the ORB front end, the PCG bundle adjuster, checkpoints, golden-cloud ATE
# ----------------------------------------------------------------------

def every_third_view(scene, imgs):
    """Views 0, 3, ..., 24 (a 5.25 degree step): ORB's initial pair cannot
    triangulate at the scene's 1.75 degree step, in either package."""
    views = list(range(0, len(imgs), 3))
    return {"poses": scene["poses"][views]}, [imgs[i] for i in views]


def initial_pair_draws(dev, state, cfg, seeds: int = 10) -> int:
    """How many of ``seeds`` single draws of the initial pair (generators
    seeded 0, 1, ...) pass the driver's yield test on the run's own
    matches: at least ``min_2d3d_match_num`` landmarks and a quarter of the
    pair's matches."""
    import numpy as np
    from reconstructor_tpu_torch.pipeline import checkpoint
    from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
    keep = ("num_images", "max_keypoints", "xy", "desc", "kp_mask", "kp_score", "colors",
            "shapes", "intrinsics", "match_keys", "match_vals")
    arrays = {k: v for k, v in checkpoint.arrays_of(state).items() if k in keep}
    passed = 0
    for seed in range(seeds):
        rec = IncrementalReconstructor(cfg.with_(rng_seed=seed), verbose=False, device=dev)
        st = checkpoint.state_from_arrays(arrays)
        i1, i2, pose = rec.choose_initial_pair(st)
        st.poses[i1] = np.eye(4, dtype=np.float32)
        st.poses[i2] = pose
        st.registered = [i1, i2]
        rec.triangulate_initial_pair(st, i1, i2)
        n = int((st.matches[(i1, i2)] >= 0).sum())
        passed += int(st.num_landmarks >= cfg.min_2d3d_match_num and 4 * st.num_landmarks >= n)
    return passed


def phase_orb(dev, tmp: str, scene, imgs, cfg):
    """The ORB path (FAST + rotated BRIEF, kNN at D = 256, F-gate, PnP,
    BA) on every third view; then the kNN kernel in bf16 on the run's own
    descriptors, which must equal its plain version exactly: every entry is
    +-1/16 or 0, so every product and sum is exact, ties included.

    The initial pair of these views sees mostly one wall, so the true
    motion and a wrong one fit its matches nearly equally well, and a draw
    that takes the wrong one fails to triangulate (the driver then redraws,
    three times, as the JAX package does). The phase prints how many of 10
    single draws on the run's matches pass the driver's yield test."""
    import torch
    sub, sub_imgs = every_third_view(scene, imgs)
    rec, state, launches, summary = run_path(dev, tmp, "orb", sub, sub_imgs, cfg,
                                             min_registered=len(sub_imgs))
    check(launches["knn_top2"] > 0, "the ORB path never launched the kNN kernel")
    summary["initial_pair_draws_passing_of_10"] = initial_pair_draws(dev, state, rec.config)
    log("orb", f"landmarks {summary['landmarks']} (the JAX package on the CPU: 9/9 views, "
               f"1015 landmarks, 0.11% ATE on these views and settings)")
    desc_d, mask_d, _ = rec._device_frontend(state)
    chunk = all_pairs(state.num_images, dev)
    desc16 = desc_d.to(torch.bfloat16)
    check(torch.equal(desc16.float(), desc_d), "ORB descriptors are not exact in bf16")
    res, _ = compare_knn(desc16, mask_d, chunk, exact=True, tol=0.0, min_match_agree=1.0,
                         label=f"ORB path inputs bf16 (N={state.num_images}, "
                               f"Kt={desc_d.shape[1]}, D={desc_d.shape[2]}), exact")
    summary["knn"] = time_knn(desc16, mask_d, chunk, "ORB path inputs")
    log("orb", json.dumps(summary))
    return summary


def state_sha256(state) -> str:
    """One hash of every field of a state (its checkpoint arrays, by name)."""
    import hashlib

    import numpy as np
    from reconstructor_tpu_torch.pipeline import checkpoint
    h = hashlib.sha256()
    for k, v in sorted(checkpoint.arrays_of(state).items()):
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def check_same_state(a, b, what: str) -> None:
    """Two states equal field for field, bit for bit."""
    import numpy as np
    from reconstructor_tpu_torch.pipeline import checkpoint
    x, y = checkpoint.arrays_of(a), checkpoint.arrays_of(b)
    check(sorted(x) == sorted(y), f"{what}: the states hold other fields")
    for k in x:
        check(x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]),
              f"{what}: field {k} differs")


def phase_pcg_path(dev, tmp: str, scene, imgs, cfg):
    """The default path with ``ba_solver="pcg"``, twice, both as users run
    it: every bundle adjustment through the implicit-Schur PCG solver
    (counted), none through the dense one, kernels 5, 6 and 8 launched,
    as often in both runs; the second run must end in the first's state bit for bit
    (every sum over observations is the fixed-order kernel, no atomics).
    Then kernels 5 and 6 on the last BA problem of the run, against their
    plain versions. Returns (summary, state, (launches, kernel 5's and
    kernel 6's comparisons and timings, the last problem's landmark
    count)), the mesh phase's reference."""
    from reconstructor_tpu_torch.ba import distributed
    last = {}
    real_pcg = distributed.solve_pcg

    def keep(prob, **k):
        last["prob"] = prob
        return real_pcg(prob, **k)
    distributed.solve_pcg = keep
    try:
        rec, state, launches, summary = run_path(dev, tmp, "pcg", scene, imgs, cfg)
        rec2, again, launches2, summary2 = run_path(dev, tmp, "pcg-again", scene, imgs, cfg)
    finally:
        distributed.solve_pcg = real_pcg
    calls, calls2 = rec.ba_calls, rec2.ba_calls
    log("pcg", f"BA calls {json.dumps(calls)}, {json.dumps(calls2)}; landmarks "
               f"{summary['landmarks']}, {summary2['landmarks']} (the JAX package on the CPU: "
               f"25/25 views, 2351 landmarks, 7.29% ATE)")
    check(launches["knn_top2"] > 0 and launches2["knn_top2"] > 0,
          "the PCG path never launched the kNN kernel")
    for k in ("seg_sum", "schur_sums", "block3_matvec"):
        check(launches[k] > 0 and launches2[k] == launches[k],
              f"the PCG path's {k} launches: {launches[k]}, {launches2[k]}")
    check(calls["pcg"] > 0 and calls["dense"] == 0 and calls["distributed"] == 0
          and calls2 == calls, f"the PCG path's bundle adjustments went elsewhere: "
                               f"{calls}, {calls2}")
    summary["ba_calls"] = calls
    summary["state_sha256"] = state_sha256(state)
    summary2["state_sha256"] = state_sha256(again)
    log("pcg", json.dumps(summary))
    log("pcg-again", json.dumps(summary2))
    check_same_state(state, again, "two PCG-routed runs")
    log("pcg", f"the two runs end in one state bit for bit: {summary['state_sha256']}")
    return summary, state, (launches, *segsum_path_problem(last["prob"]),
                            last["prob"].points.shape[0])


def phase_pcg_street(dev, cfg):
    """A BA problem over the dense budget (100 cameras x 100,000 points,
    ~5e5 observations): the driver's rule must route it to PCG; then PCG
    and the dense solver run on it with the driver's settings. Each final
    RMS must be within 10% of the pixel noise, PCG's result finite and
    the gauge camera unmoved."""
    import numpy as np
    import torch
    from reconstructor_tpu_torch.ba import cuda_schur, cuda_segsum, distributed, lm as ba_lm
    from reconstructor_tpu_torch.pipeline import incremental
    from reconstructor_tpu_torch.scripts.profile_pcg_path import street_ba_kwargs, street_problem
    px_noise = 0.5
    t = time.perf_counter()
    prob, host, O = street_problem(dev, px_noise=px_noise)
    torch.cuda.synchronize()
    C_pad, L_pad = prob.cam_params.shape[0], prob.points.shape[0]
    elems = C_pad * 12 * L_pad * 3
    n_cams = int(prob.cam_free[:, 0].sum()) + 1
    log("pcg", f"street problem built in {time.perf_counter() - t:.2f}s: {n_cams} cameras, "
               f"{int(prob.obs_pt.max()) + 1} points, {O} observations; padded {C_pad} x {L_pad} x "
               f"{prob.obs_uv.shape[0]}, dense coupling {elems:.3e} elements "
               f"(budget {cfg.ba_dense_w_max_elems:.3e})")
    check(incremental.uses_pcg(cfg, C_pad, L_pad), "the driver's rule would not route to PCG")
    common = street_ba_kwargs(cfg)
    solvers = (("pcg", lambda: distributed.solve_pcg(prob, **common)),
               ("dense", lambda: ba_lm.solve(prob, compact=False, host_obs=host, **common)))
    out = {}
    for name, solve in solvers:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_segsum.reset_launches()
        cuda_schur.reset_launches()
        t = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        cost = float(res.cost_final)
        rms = float(np.sqrt(cost / O))
        out[name] = {"cost_initial": float(res.cost_initial), "cost_final": cost,
                     "rms_px": rms, "iterations": int(res.iterations), "wall_s": wall,
                     "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                     "seg_sum_launches": cuda_segsum.LAUNCHES,
                     "schur_sums_launches": cuda_schur.LAUNCHES}
        log("pcg", f"street problem, {name}: " + json.dumps(out[name]))
        check(bool(torch.isfinite(res.cam_params).all() and torch.isfinite(res.points).all()),
              f"{name}: non-finite result")
        check(torch.equal(res.cam_params[0], prob.cam_params[0]), f"{name}: gauge camera moved")
        check(rms <= 1.1 * px_noise, f"{name}: final RMS {rms} px > 1.1 x {px_noise} px noise")
    gap = abs(out["pcg"]["cost_final"] - out["dense"]["cost_final"]) / out["dense"]["cost_final"]
    out["relative_gap"] = gap
    log("pcg", f"street problem: final costs pcg {out['pcg']['cost_final']:.2f}, dense "
               f"{out['dense']['cost_final']:.2f}, relative gap {gap:.3e} (expected < 1e-2)")
    return out


# ----------------------------------------------------------------------
# the fixed-order segment sums of PCG (kernels 5 and 6)
# ----------------------------------------------------------------------

# Kernel against float64 sums: error within SEGSUM_REL_TOL of the
# segment's sum of magnitudes. float32 rounding along the kernel's chains
# (up to ~35 additions a column on a 5,000-row segment at W = 144: 18 a
# thread, the row phases, ~10 chunks) bounds it by ~2.1e-6 in the worst
# case; random signs leave ~1e-7 (a block a segment measured <= 1.6e-7,
# the atomics of index_add_ ~2e-7).
SEGSUM_REL_TOL = 2e-6
# Kernel 6 against float64, relative to the sum of the products'
# magnitudes (sum over rows and terms of |Y| |operand|): each row's
# product is a 12-term fmaf chain (3 terms into cameras), then up to
# LONG_ROWS - 1 = 31 additions a landmark or ~20 a camera (2 rows a
# thread, a 256-thread tree, ~10 chunks): at most ~43 roundings of 2^-24,
# ~2.6e-6 in the worst case; random signs leave a few 1e-7.
SCHUR_REL_TOL = 3e-6


def segsum_bytes(lay, W: int) -> float:
    """Bytes the sum must move: each live row of values and its perm
    entry once, offsets, the segment list, the chunk table and the output
    once."""
    live = int(lay.perm.numel())
    return (live * (W * 4 + 4) + (lay.n + 1) * 4 + lay.n * 4 + lay.n * W * 4
            + (lay.n_chunks + lay.n_long + 1) * 4)


def compare_segsum(values, lay, index, label: str) -> dict:
    """The kernel on ``values`` (rows, W): three calls equal bit for bit,
    within SEGSUM_REL_TOL of a float64 sum; its max abs difference from
    the plain version; kernel, plain and ``index_add_`` over every row
    (the library call; the solver's masked rows are exact zeros) timed
    beside the bound (bytes at 3.35 TB/s). ``ms`` and ``library_ms`` are
    CUDA-event spans over back-to-back calls, host gaps included; the
    kernel and the library call are also traced one call at a time
    (``trace_calls``): ``device_ms`` / ``library_device_ms`` are the
    card's busy time per call, ``host_share`` the part of ``ms`` in which
    the card waited for the wrapper."""
    import torch
    from reconstructor_tpu_torch.ba import cuda_segsum as S
    W = values.shape[1]
    got = [S.seg_sum(values, lay) for _ in range(3)]
    torch.cuda.synchronize()
    check(torch.equal(got[0], got[1]) and torch.equal(got[1], got[2]),
          f"segsum {label}: three calls differ")
    plain = S.seg_sum_plain(values, lay)
    v64 = values.double().index_select(0, lay.rows)
    ref = torch.zeros(lay.n, W, dtype=torch.float64, device=values.device).index_add_(
        0, lay.index, v64)
    mag = torch.zeros_like(ref).index_add_(0, lay.index, v64.abs())
    rel = float(((got[0].double() - ref).abs() / mag.clamp(min=1e-30)).max())
    rel_plain = float(((plain.double() - ref).abs() / mag.clamp(min=1e-30)).max())
    bound = segsum_bytes(lay, W) / HBM_BYTES_PER_S * 1e3
    res = {"max_abs_err": float((got[0] - plain).abs().max()), "rel_err_vs_f64": rel,
           "plain_rel_err_vs_f64": rel_plain,
           "ms": cuda_ms(lambda: S.seg_sum(values, lay), iters=50, warmup=5),
           "plain_ms": cuda_ms(lambda: S.seg_sum_plain(values, lay), iters=50, warmup=5),
           "library_ms": cuda_ms(lambda: torch.zeros(lay.n, W, device=values.device)
                                 .index_add_(0, index, values), iters=50, warmup=5),
           "bound_ms": bound, "bound_by": "bytes",
           "live_rows": int(lay.perm.numel()), "segments": lay.n, "long_segments": lay.n_long,
           "chunks": lay.n_chunks}
    tr = trace_calls(lambda: S.seg_sum(values, lay))
    tr_lib = trace_calls(lambda: torch.zeros(lay.n, W, device=values.device)
                         .index_add_(0, index, values))
    res.update(device_ms=tr["busy_ms"], library_device_ms=tr_lib["busy_ms"],
               clipped_device_ms=tr["clipped_busy_ms"],
               host_share=max(0.0, 1.0 - tr["busy_ms"] / res["ms"]),
               kernels_ms=tr["kernels_ms"], library_kernels_ms=tr_lib["kernels_ms"])
    log("segsum", f"{label} (W={W}): " + json.dumps(res))
    check(rel <= SEGSUM_REL_TOL, f"segsum {label}: {rel} of the magnitudes from float64")
    return res


def segsum_shapes(prob, label: str, seed: int = 0) -> dict:
    """Random values (masked rows zero) through a problem's two layouts,
    at the widths the solver sums: 12 and 144 into cameras, 3 and 9 into
    points."""
    import torch
    from reconstructor_tpu_torch.ba import cuda_segsum as S
    g = torch.Generator(device=prob.obs_cam.device)
    g.manual_seed(seed)
    out = {}
    for name, index, n, widths in (("cameras", prob.obs_cam.long(), prob.cam_params.shape[0],
                                    (12, 144)),
                                   ("points", prob.obs_pt.long(), prob.points.shape[0], (3, 9))):
        lay = S.segment_layout(index, n, prob.obs_mask)
        for W in widths:
            v = torch.randn(index.numel(), W, generator=g, device=index.device)
            v = v * prob.obs_mask[:, None]
            out[f"{name}_w{W}"] = compare_segsum(v, lay, index, f"{label}, {name}")
    return out


def ragged_cases(rng):
    """Segment indices with empty segments among short and long ones (a
    long one split over many chunks), one segment holding every live row,
    no mask, and every row masked: name -> (index, n, mask or None)."""
    import numpy as np
    rows = 20000
    idx = rng.choice(np.arange(300)[np.arange(300) % 4 != 0], rows)
    idx[rng.uniform(size=rows) < 0.4] = 7
    return {"empty, short and long segments": (idx, 300, rng.uniform(size=rows) >= 0.2),
            "one segment holds every live row": (np.full(5000, 5), 12,
                                                 rng.uniform(size=5000) >= 0.3),
            "no mask, one segment": (np.zeros(777, np.int64), 1, None),
            "every row masked": (rng.integers(0, 20, 1000), 20, np.zeros(1000, bool))}


def segsum_ragged(dev) -> None:
    """Kernel 5 on ragged layouts with integer values (every sum exact, so
    the kernel must equal the plain version bit for bit): ``ragged_cases``
    at widths from 1 to 144 (float and float4 columns); empty segments
    exactly zero."""
    import numpy as np
    import torch
    from reconstructor_tpu_torch.ba import cuda_segsum as S
    rng = np.random.default_rng(0)
    for name, (index, n, mask) in ragged_cases(rng).items():
        index_t = torch.as_tensor(index, device=dev).long()
        mask_t = None if mask is None else torch.as_tensor(mask, device=dev)
        lay = S.segment_layout(index_t, n, mask_t)
        live = np.ones(len(index), bool) if mask is None else mask
        empty = torch.as_tensor(np.bincount(index[live], minlength=n) == 0, device=dev)
        for W in (1, 3, 9, 12, 33, 144):
            v = torch.as_tensor(rng.integers(-8, 9, (len(index), W)).astype(np.float32),
                                device=dev)
            got = S.seg_sum(v, lay)
            torch.cuda.synchronize()
            check(torch.equal(got, S.seg_sum_plain(v, lay)),
                  f"segsum ragged '{name}' W={W}: kernel != plain")
            check(not bool(got[empty].any()), f"segsum ragged '{name}' W={W}: an empty "
                                              f"segment is not zero")
        log("segsum", f"ragged '{name}': {lay.n} segments, {lay.n_long} long in "
                      f"{lay.n_chunks} chunks, {int(lay.perm.numel())} live rows: "
                      f"kernel == plain, exact, W 1-144")


def schur_ragged(dev) -> None:
    """Kernel 6 on ragged layouts with integer Y and operands (every
    product and sum exact): ``ragged_cases``' indices as the cameras,
    against landmark indices with empty, short and long (split) segments;
    both directions equal to their plain versions bit for bit, empty
    segments exactly zero; u staged in shared memory (12 cameras) and
    read through L1 (1,000)."""
    import numpy as np
    import torch
    from reconstructor_tpu_torch.ba import cuda_schur as K
    rng = np.random.default_rng(1)
    cases = ragged_cases(rng)
    cases["1,000 cameras"] = (rng.integers(0, 1000, 30000), 1000, rng.uniform(size=30000) >= 0.1)
    for name, (cam, C, mask) in cases.items():
        O = len(cam)
        L = 700
        pt = rng.integers(0, L, O)
        pt[rng.uniform(size=O) < 0.1] = 3               # one landmark split over chunks
        pt[pt % 5 == 1] = 2                             # empty landmarks
        live = np.ones(O, bool) if mask is None else mask
        lay = K.schur_layout(torch.as_tensor(cam, device=dev), torch.as_tensor(pt, device=dev),
                             C, L, None if mask is None else torch.as_tensor(mask, device=dev))
        Y = torch.as_tensor((rng.integers(-4, 5, (O, 12, 3)) * live[:, None, None])
                            .astype(np.float32), device=dev)
        u = torch.as_tensor(rng.integers(-4, 5, (C, 12)).astype(np.float32), device=dev)
        z = torch.as_tensor(rng.integers(-4, 5, (L, 3)).astype(np.float32), device=dev)
        for what, got, plain, index, n in (
                ("ytu_sum", K.ytu_sum(Y, u, lay), K.ytu_sum_plain(Y, u, lay), pt, L),
                ("yz_sum", K.yz_sum(Y, z, lay), K.yz_sum_plain(Y, z, lay), cam, C)):
            torch.cuda.synchronize()
            check(torch.equal(got, plain), f"schur ragged '{name}' {what}: kernel != plain")
            empty = torch.as_tensor(np.bincount(index[live], minlength=n) == 0, device=dev)
            check(not bool(got[empty].any()), f"schur ragged '{name}' {what}: an empty "
                                              f"segment is not zero")
        log("segsum", f"schur ragged '{name}': {C} cameras ({lay.cam.n_long} long, "
                      f"{lay.cam.n_chunks} chunks), {L} landmarks ({lay.pt.n_long} long, "
                      f"{lay.pt.n_chunks} chunks), {int(live.sum())} live rows: both "
                      f"directions == plain, exact")


def schur_bytes(seg, n_operand: int, op_w: int, out_w: int) -> float:
    """Bytes one direction of kernel 6 must move: each live row of Y
    (144 B) with its perm and other entries, the operand, offsets, the
    segment list, the chunk table and the output once."""
    live = int(seg.perm.numel())
    return (live * (144 + 8) + n_operand * op_w * 4 + (seg.n + 1) * 4 + seg.n * 4
            + (seg.n_chunks + seg.n_long + 1) * 4 + seg.n * out_w * 4)


def compare_schur(Y, u, z, lay, label: str) -> dict:
    """Kernel 6's two directions on Y (O, 12, 3), u (C, 12), z (L, 3):
    three calls equal bit for bit, within SCHUR_REL_TOL of a float64 sum
    of the products; max abs difference from the plain version; kernel,
    plain, the chain it replaced (gather + einsum + kernel 5) and the
    library chain (gather + einsum + ``index_add_``) timed back to back
    beside the bound (bytes at 3.35 TB/s); the kernel and both chains
    also traced a call at a time (device ms and launches a call)."""
    import torch
    from reconstructor_tpu_torch.ba import cuda_schur as K, cuda_segsum as S
    Y64 = Y.double()
    out = {}
    for d, op, seg, n_op, op_w, out_w in (("ytu", u, lay.pt, lay.cam.n, 12, 3),
                                          ("yz", z, lay.cam, lay.pt.n, 3, 12)):
        if d == "ytu":
            fn = lambda: K.ytu_sum(Y, u, lay)
            plain = lambda: K.ytu_sum_plain(Y, u, lay)
            chain = lambda: S.seg_sum(torch.einsum("oij,oi->oj", Y, u[lay.obs_cam]), lay.pt)
            library = lambda: torch.zeros(lay.pt.n, 3, device=Y.device).index_add_(
                0, lay.obs_pt, torch.einsum("oij,oi->oj", Y, u[lay.obs_cam]))
            prods = torch.einsum("oij,oi->oj", Y64, u.double()[lay.obs_cam])
            mags = torch.einsum("oij,oi->oj", Y64.abs(), u.double().abs()[lay.obs_cam])
            index = lay.obs_pt
        else:
            fn = lambda: K.yz_sum(Y, z, lay)
            plain = lambda: K.yz_sum_plain(Y, z, lay)
            chain = lambda: S.seg_sum(torch.einsum("oij,oj->oi", Y, z[lay.obs_pt]), lay.cam)
            library = lambda: torch.zeros(lay.cam.n, 12, device=Y.device).index_add_(
                0, lay.obs_cam, torch.einsum("oij,oj->oi", Y, z[lay.obs_pt]))
            prods = torch.einsum("oij,oj->oi", Y64, z.double()[lay.obs_pt])
            mags = torch.einsum("oij,oj->oi", Y64.abs(), z.double().abs()[lay.obs_pt])
            index = lay.obs_cam
        got = [fn() for _ in range(3)]
        torch.cuda.synchronize()
        check(torch.equal(got[0], got[1]) and torch.equal(got[1], got[2]),
              f"schur {label} {d}: three calls differ")
        rows = seg.rows
        ref = torch.zeros(seg.n, out_w, dtype=torch.float64, device=Y.device).index_add_(
            0, index[rows], prods[rows])
        mag = torch.zeros_like(ref).index_add_(0, index[rows], mags[rows])
        rel = float(((got[0].double() - ref).abs() / mag.clamp(min=1e-30)).max())
        p = plain()
        rel_plain = float(((p.double() - ref).abs() / mag.clamp(min=1e-30)).max())
        res = {"max_abs_err": float((got[0] - p).abs().max()), "rel_err_vs_f64": rel,
               "plain_rel_err_vs_f64": rel_plain,
               "ms": cuda_ms(fn, iters=50, warmup=5),
               "plain_ms": cuda_ms(plain, iters=50, warmup=5),
               "chain_ms": cuda_ms(chain, iters=50, warmup=5),
               "library_ms": cuda_ms(library, iters=50, warmup=5),
               "bound_ms": schur_bytes(seg, n_op, op_w, out_w) / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "live_rows": int(rows.numel()), "segments": seg.n,
               "long_segments": seg.n_long, "chunks": seg.n_chunks}
        tr, tr_chain, tr_lib = trace_calls(fn), trace_calls(chain), trace_calls(library)
        res.update(device_ms=tr["busy_ms"], chain_device_ms=tr_chain["busy_ms"],
                   library_device_ms=tr_lib["busy_ms"], launches_a_call=tr["launches"],
                   chain_launches_a_call=tr_chain["launches"],
                   library_launches_a_call=tr_lib["launches"],
                   host_share=max(0.0, 1.0 - tr["busy_ms"] / res["ms"]),
                   kernels_ms=tr["kernels_ms"], chain_kernels_ms=tr_chain["kernels_ms"])
        log("segsum", f"schur {label}, {d}_sum: " + json.dumps(res))
        check(rel <= SCHUR_REL_TOL, f"schur {label} {d}: {rel} of the magnitudes from float64")
        out[d] = res
    return out


def schur_shapes(prob, label: str, seed: int = 0) -> dict:
    """Kernel 6 on a problem's layouts with random Y (masked rows zero),
    u and z."""
    import torch
    from reconstructor_tpu_torch.ba import cuda_schur as K
    g = torch.Generator(device=prob.obs_cam.device)
    g.manual_seed(seed)
    dev = prob.obs_cam.device
    lay = K.schur_layout(prob.obs_cam, prob.obs_pt, prob.cam_params.shape[0],
                         prob.points.shape[0], prob.obs_mask)
    Y = torch.randn(prob.obs_cam.numel(), 12, 3, generator=g, device=dev)
    Y = Y * prob.obs_mask[:, None, None]
    u = torch.randn(lay.cam.n, 12, generator=g, device=dev)
    z = torch.randn(lay.pt.n, 3, generator=g, device=dev)
    return compare_schur(Y, u, z, lay, label)


def segsum_fountain(dev):
    """The 25-view scale: the saved fountain BA problem (32 x 16,384,
    65,536 observations)."""
    from reconstructor_tpu_torch.scripts import exp_ba
    return exp_ba.load_problem(device=dev)


def phase_segsum(dev) -> dict:
    """Kernels 5 and 6 against their plain versions: ragged and empty
    cases exact, then the street problem's and the fountain problem's
    shapes."""
    from reconstructor_tpu_torch.scripts.profile_pcg_path import street_problem
    t = time.perf_counter()
    segsum_ragged(dev)
    schur_ragged(dev)
    street, _, _ = street_problem(dev)
    fountain = segsum_fountain(dev)
    res = {"street": segsum_shapes(street, "street problem"),
           "fountain": segsum_shapes(fountain, "fountain problem"),
           "schur_street": schur_shapes(street, "street problem"),
           "schur_fountain": schur_shapes(fountain, "fountain problem")}
    log("segsum", f"phase {time.perf_counter() - t:.1f}s")
    return res


def segsum_path_problem(prob):
    """Both kernels on what the PCG path sums in its last BA problem:
    kernel 5 on J_c^T r (observations into cameras, W = 12), kernel 6 on
    the problem's Y with a random u and z. Returns (kernel 5's, kernel
    6's comparisons)."""
    import torch
    from reconstructor_tpu_torch.ba import cuda_segsum as S, distributed
    prob = prob._replace(obs_cam=prob.obs_cam.long(), obs_pt=prob.obs_pt.long())
    res, Jc, Jp = distributed._build_blocks(prob, prob.cam_params, prob.points)
    rows = torch.einsum("ori,or->oi", Jc, res).contiguous()
    C, L, O = prob.cam_params.shape[0], prob.points.shape[0], prob.obs_cam.shape[0]
    label = f"pcg path's last BA problem ({C} x {L}, {O} observations)"
    lay = S.segment_layout(prob.obs_cam, C, prob.obs_mask)
    k5 = compare_segsum(rows, lay, prob.obs_cam, f"{label}, J_c^T r into cameras")
    g = torch.Generator(device=prob.obs_cam.device)
    g.manual_seed(0)
    Y = torch.einsum("ori,orj->oij", Jc, Jp).contiguous()
    u = torch.randn(C, 12, generator=g, device=Y.device)
    z = torch.randn(L, 3, generator=g, device=Y.device)
    k6 = compare_schur(Y, u, z, distributed._layouts(prob), label)
    return k5, k6


# the PCG point-block products (kernel 8)
BLOCKS_CELL_L = (1 << 20, 1 << 23)   # padded landmarks of ba-venice1778-pcg, ba-final13682-dist4
BLOCK_BYTES = 60                     # a landmark: 9 + 3 floats read, 3 written


def blocks_case(dev, L: int, at_cell: bool) -> dict:
    """Kernel 8 on random SPD inverses' (9, L) planes and a v whose rows
    span 2^-10 .. 2^9: three calls equal, equal bit for bit to
    ``block3_matvec_reference``, and at a PCG cell's L (``at_cell``) to
    the einsum it replaced there; then the kernel (events; traced device
    time and launches a call), that einsum, a ``bmm`` of contiguous
    (L, 3, 3) blocks and the bound."""
    import torch
    from reconstructor_tpu_torch.ba import cuda_blocks as K, distributed
    g = torch.Generator(device=dev)
    g.manual_seed(L)
    B = torch.randn(L, 3, 3, generator=g, device=dev)
    h9 = distributed._inv3x3(B @ B.transpose(1, 2) + 0.1 * torch.eye(3, device=dev))
    del B
    v = torch.randn(L, 3, generator=g, device=dev)
    v = v * torch.exp2(torch.randint(-10, 10, (L, 1), generator=g, device=dev).float())
    got = [K.block3_matvec(h9, v) for _ in range(3)]
    torch.cuda.synchronize()
    label = f"L={L:,}"
    check(torch.equal(got[0], got[1]) and torch.equal(got[1], got[2]),
          f"blocks {label}: three calls differ")
    bits = lambda x: x.contiguous().view(torch.int32)
    n_ref = int((bits(got[0]) != bits(K.block3_matvec_reference(h9, v))).sum())
    plain = K.block3_matvec_plain(h9, v)
    n_einsum = int((bits(got[0]) != bits(plain)).sum())
    blocks = h9.T.contiguous().reshape(L, 3, 3)
    fn = lambda: K.block3_matvec(h9, v)
    library = lambda: torch.bmm(blocks, v[:, :, None])
    res = {"L": L, "differ_from_reference": n_ref, "differ_from_einsum": n_einsum,
           "max_abs_err": float((got[0] - plain).abs().max()),
           "ms": cuda_ms(fn, iters=50, warmup=5),
           "plain_ms": cuda_ms(lambda: K.block3_matvec_plain(h9, v), iters=20, warmup=3),
           "library_ms": cuda_ms(library, iters=20, warmup=3),
           "bound_ms": L * BLOCK_BYTES / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    tr, tr_plain = trace_calls(fn), trace_calls(lambda: K.block3_matvec_plain(h9, v))
    res.update(device_ms=tr["busy_ms"], launches_a_call=tr["launches"],
               plain_device_ms=tr_plain["busy_ms"],
               plain_launches_a_call=tr_plain["launches"], kernels_ms=tr["kernels_ms"],
               plain_kernels_ms=tr_plain["kernels_ms"],
               bound_share=res["bound_ms"] / res["ms"])
    log("blocks", f"{label}{' (a PCG cell)' if at_cell else ''}: " + json.dumps(res))
    check(n_ref == 0, f"blocks {label}: {n_ref} of {3 * L} values differ from the reference")
    check(not at_cell or n_einsum == 0,
          f"blocks {label}: {n_einsum} of {3 * L} values differ from the einsum at a cell's L")
    return res


def phase_blocks(dev, path_L: int) -> dict:
    """Kernel 8 at the PCG cells' L and at the pcg path's last problem's
    ``path_L``. Returns the kernels line's row (at L = 2^23; launches
    filled in by the caller)."""
    import torch
    from reconstructor_tpu_torch.ba import cuda_blocks as K
    t = time.perf_counter()
    res = {}
    for L in (*BLOCKS_CELL_L, path_L):
        res[L] = blocks_case(dev, L, L in BLOCKS_CELL_L)
        torch.cuda.empty_cache()
    log("blocks", f"phase {time.perf_counter() - t:.1f}s")
    top = res[BLOCKS_CELL_L[-1]]
    return {"name": "block3_matvec", "route": "cuda",
            "source": "reconstructor_tpu_torch/" + K.SOURCE, "replaces": K.REPLACES,
            **{k: top[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}}


# ----------------------------------------------------------------------
# the multi-device path
# ----------------------------------------------------------------------

def centres_of(state):
    import numpy as np
    return np.stack([-state.poses[i][:3, :3].T @ state.poses[i][:3, 3]
                     for i in sorted(state.registered)])


def mesh_path(dev, tmp: str, mesh, scene, imgs, cfg, pcg_run):
    """(a) The default path with ``mesh=`` in a world of one under NCCL,
    the ``pcg`` phase's seed and configuration, as users run it: every
    bundle adjustment through ``solve_distributed``, the kNN and
    segment-sum kernels launched, and the end state equal to the pcg
    phase's bit for bit (same kernels, same draws, every sum in a fixed
    order, and an all-reduce over one rank is a copy)."""
    from reconstructor_tpu_torch.parallel import sharding
    pcg_summary, pcg_state = pcg_run
    sharding.reset_counts()
    rec, state, launches, summary = run_path(dev, tmp, "mesh", scene, imgs, cfg, mesh=mesh)
    calls = rec.ba_calls
    collectives = sharding.counts()
    log("mesh", f"(a) BA calls {json.dumps(calls)}, collectives {json.dumps(collectives)}, "
                f"kernel launches {json.dumps(launches)}")
    for name in sorted(set(summary["stages_s"]) | set(pcg_summary["stages_s"])):
        log("mesh", f"(a) stage '{name}': mesh {summary['stages_s'].get(name, 0.0):.2f}s, "
                    f"pcg {pcg_summary['stages_s'].get(name, 0.0):.2f}s")
    check(launches["knn_top2"] > 0, "the mesh path never launched the kNN kernel")
    check(launches["seg_sum"] > 0, "the mesh path never launched the segment-sum kernel")
    check(launches["schur_sums"] > 0, "the mesh path never launched the fused Schur-sum kernel")
    check(launches["block3_matvec"] > 0, "the mesh path never launched the point-block kernel")
    check(calls["distributed"] > 0 and calls["pcg"] == 0 and calls["dense"] == 0,
          f"the mesh path's bundle adjustments went elsewhere: {calls}")
    summary.update(ba_calls=calls, collectives=collectives, state_sha256=state_sha256(state))
    log("mesh", "(a) " + json.dumps(summary))
    check_same_state(state, pcg_state, "mesh (a) against the pcg run")
    log("mesh", f"(a) equal to the pcg run bit for bit: {summary['state_sha256']}")
    return summary


def mesh_superglue(dev, mesh, learned_run):
    """(b) The learned run's first two chunks (16 pairs) through
    ``match_superglue_sharded`` beside ``match_pairs_batched`` on the same
    inputs: indices and masks equal, scores within 1e-5; the Sinkhorn
    kernel must launch inside the sharded calls."""
    import torch
    from reconstructor_tpu_torch.matching import cuda_sinkhorn, superglue
    from reconstructor_tpu_torch.parallel import sharding
    rec, state = learned_run
    cfg = rec.config
    net = rec._superglue_params()
    B = cfg.superglue_chunk_pairs
    pairs = rec.select_pairs(state)[:2 * B].astype("int32")
    args = [rec._t(a) for a in (state.desc, state.xy, state.kp_score, state.kp_mask,
                                state.shapes)]
    kw = dict(sinkhorn_iters=cfg.superglue_sinkhorn_iters, score_thresh=cfg.superglue_score_thresh)
    launches, err, ms = 0, 0.0, {"sharded": 0.0, "batched": 0.0}
    for s in range(0, len(pairs), B):
        chunk = pairs[s:s + B]
        cuda_sinkhorn.reset_launches()
        a = sharding.match_superglue_sharded(mesh, net, *args, chunk, **kw)
        launches += cuda_sinkhorn.LAUNCHES
        b = superglue.match_pairs_batched(net, *args, rec._t(chunk), **kw)
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"sharded SuperGlue matches differ from match_pairs_batched on chunk {s // B}")
        err = max(err, float((a[2] - b[2]).abs().max()))
        ms["sharded"] += cuda_ms(lambda: sharding.match_superglue_sharded(
            mesh, net, *args, chunk, **kw), iters=3, warmup=1)
        ms["batched"] += cuda_ms(lambda: superglue.match_pairs_batched(
            net, *args, rec._t(chunk), **kw), iters=3, warmup=1)
    res = {"pairs": int(len(pairs)), "sinkhorn_launches": launches, "max_score_err": err,
           "matches": int(b[1].sum()), "ms_two_chunks": ms}
    log("mesh", "(b) learned SuperGlue, sharded vs batched: " + json.dumps(res))
    check(err <= 1e-5, f"sharded SuperGlue scores {err} from match_pairs_batched's")
    check(launches > 0, "match_superglue_sharded never launched the Sinkhorn kernel")
    return res


def mesh_street(dev, mesh, cfg):
    """(c) The street problem through ``solve_distributed`` at a world of
    one beside ``solve_pcg``: final costs within 1e-4 relative, the RMS
    within the ``pcg`` phase's limit, the gauge camera unmoved; both wall
    times (each solver twice, alternating, so that neither pays a first
    call alone), the all-reduce calls and one all-reduce's time."""
    import numpy as np
    import torch
    from reconstructor_tpu_torch.ba import distributed
    from reconstructor_tpu_torch.parallel import sharding
    from reconstructor_tpu_torch.scripts.profile_pcg_path import street_ba_kwargs, street_problem
    px_noise = 0.5
    prob, _, O = street_problem(dev, px_noise=px_noise)
    common = street_ba_kwargs(cfg)
    out = {}
    for name in ("pcg", "distributed") * 2:
        torch.cuda.synchronize()
        sharding.reset_counts()
        t = time.perf_counter()
        if name == "distributed":
            res = distributed.solve_distributed(mesh, prob, **common)
        else:
            res = distributed.solve_pcg(prob, **common)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        cost = float(res.cost_final)
        walls = out.get(name, {}).get("wall_s", []) + [wall]
        out[name] = {"cost_final": cost, "rms_px": float(np.sqrt(cost / O)),
                     "iterations": int(res.iterations), "wall_s": walls,
                     "all_reduces": sharding.counts()["all_reduce"]}
        check(torch.equal(res.cam_params[0], prob.cam_params[0]), f"{name}: gauge camera moved")
        check(out[name]["rms_px"] <= 1.1 * px_noise,
              f"{name}: final RMS {out[name]['rms_px']} px > 1.1 x {px_noise} px noise")
    # one (C, 12) all-reduce: CUDA events over 200 back to back, and the
    # host's time to issue one (the path's BAs are host-bound)
    C = prob.cam_params.shape[0]
    buf = torch.zeros(C, 12, device=dev)
    out["all_reduce_us_c12"] = 1e3 * cuda_ms(lambda: sharding.all_sum(mesh, buf), iters=200,
                                              warmup=20)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(200):
        sharding.all_sum(mesh, buf)
    out["all_reduce_host_us_c12"] = 1e6 * (time.perf_counter() - t) / 200
    torch.cuda.synchronize()
    gap = (abs(out["distributed"]["cost_final"] - out["pcg"]["cost_final"])
           / out["pcg"]["cost_final"])
    out["relative_gap"] = gap
    log("mesh", "(c) street problem, solve_distributed vs solve_pcg: " + json.dumps(out))
    check(gap <= 1e-4, f"solve_distributed's final cost {gap} relative from solve_pcg's")
    return out


def run_dryrun(here: str, n: int, device: str, backend: str) -> dict:
    """The port's ``run_multiproc_dryrun`` with ``n`` ranks; its merged
    report. Its ranks load the kernels this script built."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "reconstructor_tpu_torch.scripts.run_multiproc_dryrun", str(n),
         "--device", device, "--backend", backend, "--timeout", "240"],
        cwd=here, env=dict(os.environ, PYTHONPATH=here), capture_output=True, text=True,
        timeout=420)
    check(proc.returncode == 0, f"run_multiproc_dryrun {n} {device} {backend} exited "
                                f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    log("mesh", f"run_multiproc_dryrun {n} --device {device} --backend {backend} "
                f"({time.perf_counter() - t:.1f}s): "
                + json.dumps({k: v for k, v in rep.items() if k != "workers"}))
    for w in rep["workers"]:
        log("mesh", f"  rank {w['rank']}: " + json.dumps(w))
    return rep


def check_dryrun(rep: dict, one: dict, n: int, label: str) -> None:
    """Every rank ok, with the same final BA cost below the initial / 100,
    the kNN kernel launched, the match table of the 1-rank run, and the
    driver's run ending in the same state on every rank."""
    check(rep["ok"] and len(rep["workers"]) == n, f"{label}: run not ok")
    ref = one["workers"][0]["match_table_sha256"]
    w0 = rep["workers"][0]
    for w in rep["workers"]:
        check(w["ba_cost_final"] == w0["ba_cost_final"],
              f"{label}: ranks end with different BA costs")
        check(w["driver_sha256"] == w0["driver_sha256"],
              f"{label}: rank {w['rank']} ends the driver's run in another state than rank 0")
        check(w["ba_cost_final"] < w["ba_cost_initial"] / 100,
              f"{label}: rank {w['rank']} BA cost {w['ba_cost_final']}")
        check(w["knn_launches"] > 0, f"{label}: rank {w['rank']} never launched the kNN kernel")
        check(w["match_table_sha256"] == ref, f"{label}: rank {w['rank']} match table differs "
                                              f"from the 1-rank run's")


def phase_mesh(dev, tmp: str, here: str, scene, imgs, cfg, pcg_run, learned_run):
    """The multi-device path: (a)-(c) in this process over a world of one
    under NCCL (a ``FileStore`` in the temporary directory; the group is
    destroyed after (c), so that later phases run as before), (d) two
    ranks sharing the card under gloo, (e) one NCCL rank per card when
    there are two or more."""
    import torch
    import torch.distributed as dist
    from reconstructor_tpu_torch.parallel import sharding
    mesh = sharding.initialize_multihost(f"file://{tmp}/nccl_store", 1, 0, backend="nccl",
                                         device=dev, timeout_s=300)
    log("mesh", f"world of one: rank {mesh.rank}/{mesh.size}, {mesh.backend}, {mesh.device}")
    try:
        res = {"path": mesh_path(dev, tmp, mesh, scene, imgs, cfg, pcg_run),
               "superglue": mesh_superglue(dev, mesh, learned_run),
               "street": mesh_street(dev, mesh, cfg)}
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    one = run_dryrun(here, 1, "cuda:0", "gloo")
    two = run_dryrun(here, 2, "cuda:0", "gloo")
    check_dryrun(one, one, 1, "(d) 1 rank")
    check_dryrun(two, one, 2, "(d) 2 ranks sharing the card")
    count = torch.cuda.device_count()
    if count >= 2:
        n = min(4, count)
        check_dryrun(run_dryrun(here, n, "cuda", "nccl"), one, n, f"(e) {n} NCCL ranks")
    else:
        log("mesh", f"(e) one NCCL rank per card: not run, torch.cuda.device_count() = {count} "
                    f"(needs 2)")
    return res


def phase_resume(dev, tmp: str, scene, imgs, cfg):
    """The ORB phase's run with autosaves every 3 registrations; the
    autosave made when the third view registered is copied, must load
    field for field equal to the state saved, and a fresh reconstructor
    resumed from it must end in the uninterrupted run's state bit for bit
    (no stage of the path adds with atomics)."""
    import shutil

    import numpy as np
    import torch
    from reconstructor_tpu_torch.pipeline import checkpoint
    from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
    _, sub_imgs = every_third_view(scene, imgs)
    d = os.path.join(tmp, "resume")
    os.makedirs(d)
    ckpt, mid, resumed = (os.path.join(d, n) for n in ("run.npz", "mid.npz", "resumed.npz"))
    rec = IncrementalReconstructor(cfg, verbose=False, device=dev)
    saved = {}
    autosave = rec._autosave

    def copying(state, path):
        autosave(state, path)
        if len(state.registered) == 3 and not saved:
            shutil.copy(path, mid)
            saved.update(checkpoint.arrays_of(state))
    rec._autosave = copying
    t = time.perf_counter()
    full = rec.reconstruct_from_state(rec.detect_features_from_images(sub_imgs),
                                      checkpoint_path=ckpt)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t
    check(bool(saved), "no autosave was made when the third view registered")
    loaded = checkpoint.arrays_of(checkpoint.load(mid))
    check(sorted(loaded) == sorted(saved), "the checkpoint's fields differ from the state's")
    for k in saved:
        check(loaded[k].dtype == saved[k].dtype and np.array_equal(loaded[k], saved[k]),
              f"checkpoint field {k} differs from the state saved")
    meta = checkpoint.load_meta(mid)
    check(meta.get("rng") == "torch" and meta.get("rng_device") == torch.device(dev).type,
          f"checkpoint meta {meta.get('rng')}, {meta.get('rng_device')}")
    shutil.copy(mid, resumed)
    rec2 = IncrementalReconstructor(cfg, verbose=False, device=dev)
    t = time.perf_counter()
    again = rec2.reconstruct("", checkpoint_path=resumed, resume=True)
    torch.cuda.synchronize()
    t_resumed = time.perf_counter() - t

    res = {"registered": len(full.registered), "registered_resumed": len(again.registered),
           "landmarks": int(full.num_landmarks), "landmarks_resumed": int(again.num_landmarks),
           "saved_at_registered": int(len(saved["registered"])),
           "run_s": t_full, "resumed_s": t_resumed}
    check(sorted(again.registered) == sorted(full.registered),
          f"resumed run registered {sorted(again.registered)}, uninterrupted "
          f"{sorted(full.registered)}")
    c1, c2 = centres_of(full), centres_of(again)
    extent = float(np.linalg.norm(c1.max(0) - c1.min(0)))
    res["centre_gap_of_extent"] = float(np.linalg.norm(c1 - c2, axis=1).max() / extent)
    res["state_sha256"], res["state_sha256_resumed"] = state_sha256(full), state_sha256(again)
    log("resume", json.dumps(res))
    check_same_state(full, again, "the resumed run against the uninterrupted one")
    return res


def phase_ate(tmp: str, scene, state, pose_ate: float):
    """Golden-cloud ATE: a PLY of the scene's true camera centres (green
    rows, PCL dialect) written by the port, then ``ate_vs_golden`` on the
    e2e phase's registered centres; its normalised ATE must lie within a
    factor of 2 of ``synth.pose_ate``'s (the bound of
    ``tests/test_torch_ate.py::test_golden_ate_tracks_pose_ate``), and the
    methodology floor (``ate_floor_vs_golden``) under 1%."""
    import numpy as np
    from reconstructor_tpu_torch.eval import ate
    from reconstructor_tpu_torch.io import ply
    golden = os.path.join(tmp, "golden.ply")
    ply.save_cloud(golden, scene["points"], np.full((len(scene["points"]), 3), 128, np.uint8),
                   scene["poses"])
    centres = np.stack([-state.poses[i][:3, :3].T @ state.poses[i][:3, 3]
                        for i in sorted(state.registered)])
    res = ate.ate_vs_golden(centres, golden)
    res.update(ate.ate_floor_vs_golden(centres, golden))
    res["pose_ate_normalized"] = pose_ate
    log("ate", json.dumps(res))
    ratio = res["ate_rmse_normalized"] / pose_ate
    check(res["num_ref"] == len(scene["poses"]), f"golden cloud holds {res['num_ref']} cameras")
    check(0.5 <= ratio <= 2.0, f"golden-cloud ATE {res['ate_rmse_normalized']} vs "
                               f"pose ATE {pose_ate}: ratio {ratio}")
    check(res["ate_floor_normalized"] < 0.01, f"ATE floor {res['ate_floor_normalized']}")
    return res


# ----------------------------------------------------------------------
# the photograph-measuring scripts on the rendered scene
# ----------------------------------------------------------------------

def copies_repeat(tables: dict, n: int) -> int:
    """Every tiled copy (i + n a, j + n b) of a pair (i < j) of the first
    ``n`` images has the pair's ungated table, bit for bit, and a pair
    without matches has copies without matches. Returns the copies
    checked."""
    import numpy as np
    checked = 0
    for p in range(4 * n):
        for q in range(p + 1, 4 * n):
            i, j = p % n, q % n
            if i >= j:
                continue
            a, b = tables.get((p, q)), tables.get((i, j))
            check((a is None) == (b is None) and (a is None or np.array_equal(a, b)),
                  f"measure: the ungated table of copy ({p}, {q}) differs from ({i}, {j})")
            checked += 1
    # a pair's copies with p < q are those with a <= b: 10 of the 16
    check(checked == 10 * n * (n - 1) // 2, f"measure: {checked} copies checked")
    return checked


def self_pairs_find_themselves(desc16, mask, n: int, dev) -> float:
    """Kernel 1 (bf16) on the 6 n self-pairs (i + n a, i + n b), a < b, of
    the tiled images in one launch: the share of valid rows whose best
    column is the row itself."""
    import torch
    from reconstructor_tpu_torch.matching import cuda_knn
    pairs = [(i + n * a, i + n * b) for i in range(n) for a in range(4) for b in range(a + 1, 4)]
    chunk = torch.tensor(pairs, dtype=torch.int32, device=dev)
    bias = torch.where(mask, 0.0, 1e30).to(torch.float32).contiguous()
    _, _, arg, _ = cuda_knn.knn_topk2(desc16, bias, chunk)
    rows = torch.arange(arg.shape[1], device=dev, dtype=torch.int32)
    valid = mask[chunk[:, 0].long()]
    return (arg == rows)[valid].double().mean().item()


def chunk_outputs_equal(outputs, pair_np, tables: dict, K: int, label: str) -> int:
    """The decomposition's kept kNN-only chunks (match_idx, match_mask),
    pair for pair, equal to the driver's ungated tables. Returns the pairs
    compared."""
    import numpy as np
    s0 = 0
    for mi, mm in outputs:
        m = np.where(mm.cpu().numpy(), mi.cpu().numpy(), -1)
        kt = m.shape[1]
        for q in range(mi.shape[0]):
            if s0 + q >= len(pair_np):
                break
            i, j = (int(v) for v in pair_np[s0 + q])
            ref = tables.get((i, j), np.full(K, -1, np.int32))
            check(np.array_equal(m[q], ref[:kt]) and not (ref[kt:] >= 0).any(),
                  f"{label}: pair ({i}, {j}) differs from the driver's ungated table")
        s0 += mi.shape[0]
    check(s0 >= len(pair_np), f"{label}: chunks hold {s0} of {len(pair_np)} pairs")
    return len(pair_np)


def packed_agrees(runs, mask_np, pair_np) -> dict:
    """Per width, the share of valid rows of the real pairs on which the
    packed and the float kernel's argmins agree (``exp_match_regression``'s
    kept outputs)."""
    import torch
    out = {}
    for kt in sorted({r["kt"] for r in runs}):
        by = {r["packed"]: r["outputs"] for r in runs if r["kt"] == kt}
        same = tot = 0
        s0 = 0
        for a, b in zip(by[True], by[False]):
            B = a[2].shape[0]
            e = min(B, len(pair_np) - s0)
            rows = torch.from_numpy(mask_np[pair_np[s0:s0 + e, 0], :kt]).to(a[2].device)
            same += int(((a[2][:e] == b[2][:e]) & rows).sum())
            tot += int(rows.sum())
            s0 += B
        out[kt] = same / max(tot, 1)
    return out


def phase_measure(dev, tmp: str, scene, imgs) -> list:
    """The port's six photograph-measuring scripts on the rendered scene,
    which stands in for the fountain photographs (their ``main()`` reads
    ``reference/data``, not in the repository): (a) ``measure_match100``
    on the 25 views tiled 4x, (b) ``bench_knn_dtype``, (c)
    ``profile_match100_decomp`` cases A-G, (d) ``exp_match_regression``,
    (e) ``profile_detect`` on the 25 views, (f) ``exp_quality``'s 12
    variants on every third view. Returns the kernels line's two rows:
    kernel 1 and kernel 2 at the headline's shape (N = 100, the run's Kt,
    a 512-pair chunk, bf16)."""
    import numpy as np
    import torch
    from reconstructor_tpu_torch.config import ReconstructorConfig
    from reconstructor_tpu_torch.io import images as io_images, ply
    from reconstructor_tpu_torch.matching import cuda_knn
    from reconstructor_tpu_torch.matching import pairs as pairing
    from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
    from reconstructor_tpu_torch.scripts import (bench_knn_dtype, exp_match_regression,
                                                 exp_quality, measure_match100,
                                                 profile_detect, profile_match100_decomp)
    t_phase = time.perf_counter()
    cfg = ReconstructorConfig()
    n = len(imgs)
    state = IncrementalReconstructor(cfg, verbose=False, device=dev).detect_features_from_images(
        imgs)

    # (a) the headline: the main path of this phase, counted
    t = time.perf_counter()
    cuda_knn.reset_launches()
    head = measure_match100.measure(state, cfg, dev)
    launches = cuda_knn.LAUNCHES
    state100 = head.pop("state")
    B = cfg.match_chunk_pairs_fused
    chunks = -(-head["n_pairs"] // B)
    log("measure", f"(a) measure_match100 in {time.perf_counter() - t:.1f}s: " + json.dumps(head)
                   + f", kernel 1 launches {launches}")
    check(head["n_pairs"] == 2 * n * (4 * n - 1) and np.isfinite(head["match100_pairs_per_s"]),
          f"measure (a): {head}")
    check(launches == 4 * chunks, f"measure (a): {launches} kernel 1 launches for 4 passes of "
                                  f"{chunks} chunks")
    rec = IncrementalReconstructor(cfg, verbose=False, device=dev)
    state100.matches = {}
    rec.match_features(state100, filter=False)
    ungated = dict(state100.matches)
    copies = copies_repeat(ungated, n)
    desc_d, mask_d, _ = rec._device_frontend(state100)
    desc16 = desc_d.to(torch.bfloat16).contiguous()
    selfs = self_pairs_find_themselves(desc16, mask_d, n, dev)
    log("measure", f"(a) ungated: {len(ungated)} pairs with matches; {copies} tiled copies equal "
                   f"to their pair's table; self-pairs: best column the row itself on {selfs:.6f} "
                   f"of valid rows")
    check(selfs >= 0.999, f"measure (a): self-pairs find themselves on {selfs}")
    pair_np = pairing.exhaustive_pairs(state100.num_images)
    chunk = torch.from_numpy(np.ascontiguousarray(pair_np[:B], dtype=np.int32)).to(dev)
    label = (f"headline chunk (N={state100.num_images}, Kt={desc_d.shape[1]}, "
             f"D={desc_d.shape[2]}, B={B} of {len(pair_np)} pairs)")
    _, m32 = compare_knn(desc_d, mask_d, chunk, exact=False, tol=1e-5, min_match_agree=1.0,
                         label=label + " f32")
    knn16, m16 = compare_knn(desc16, mask_d, chunk, exact=False, tol=1e-5,
                             min_match_agree=0.999, label=label + " bf16")
    rows_valid = mask_d[chunk[:, 0].long()]
    agree = (m16 == m32)[rows_valid].float().mean().item()
    log("measure", f"(a) bf16 vs f32 final matches on the chunk: {agree:.5f} of valid rows")
    check(agree >= 0.97, f"measure (a): bf16 and f32 matches agree on only {agree:.4f}")
    t1 = time_knn(desc16, mask_d, chunk, label + " bf16")
    rows = [{"name": "knn_top2_match100", "route": "cuda",
             "source": "reconstructor_tpu_torch/" + cuda_knn.SOURCE,
             "replaces": cuda_knn.REPLACES, "launches": launches,
             "max_abs_err": knn16["max_abs_err"], "ms": t1["ms"], "plain_ms": t1["plain_ms"],
             "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
             "library_ms": t1["library_ms"]}]

    # (b) float32 against bfloat16
    t = time.perf_counter()
    dt = bench_knn_dtype.bench(state, cfg, dev)
    dt.pop("matches")
    log("measure", f"(b) bench_knn_dtype in {time.perf_counter() - t:.1f}s: " + json.dumps(dt))
    for d in bench_knn_dtype.DTYPES:
        check(np.isfinite(dt[f"pairs_per_s_{d}"]) and dt[f"pairs_per_s_{d}"] > 0,
              f"measure (b): {d} pairs/s {dt}")
    check(dt["agreement_bf16_vs_f32"] >= 0.95, f"measure (b): agreement {dt}")

    # (c) the decomposition, every case
    t = time.perf_counter()
    dec = profile_match100_decomp.decompose(state, cfg, dev, cases="ABCDEGF", keep="C",
                                            log=lambda m: log("measure", "(c) " + m))
    for letter, c in dec["cases"].items():
        check(np.isfinite(c["med_s"]) and c["med_s"] > 0, f"measure (c): case {letter} {c}")
    check(len(dec["cases"]) == 7, f"measure (c): cases {list(dec['cases'])}")
    compared = chunk_outputs_equal(dec["outputs"].pop("C"), pair_np, ungated,
                                   state.max_keypoints, "measure (c) case C")
    log("measure", f"(c) decomposition in {time.perf_counter() - t:.1f}s; case C (B=256) == "
                   f"(a)'s ungated tables (B={B}) on all {compared} pairs; "
                   + json.dumps(dec["cases"]))
    del dec

    # (d) packed against unpacked at both widths
    t = time.perf_counter()
    cuda_knn.reset_launches()
    reg = exp_match_regression.regress(state, cfg, dev, keep=True,
                                       log=lambda m: log("measure", "(d) " + m))
    packed_launches = cuda_knn.LAUNCHES_PACKED
    agree = packed_agrees(reg["runs"], np.tile(state.kp_mask, (4, 1)), pair_np)
    for r in reg["runs"]:
        r.pop("outputs")
    log("measure", f"(d) exp_match_regression in {time.perf_counter() - t:.1f}s: "
                   + json.dumps(reg) + f"; packed vs float argmins agree {json.dumps(agree)}; "
                   f"packed launches {packed_launches}")
    for kt, a in agree.items():
        check(a >= 0.999, f"measure (d): at Kt={kt} packed and float argmins agree on {a}")
    check(packed_launches > 0, "measure (d): the packed kernel never launched")
    del reg
    torch.cuda.empty_cache()
    bias16 = torch.where(mask_d, 0, cuda_knn._DMAX).to(torch.int32).contiguous()
    pres = compare_packed(desc16, mask_d, chunk, exact=False, label=label + " packed bf16")
    t2 = time_knn(desc16, mask_d, chunk, label + " packed bf16",
                  kernel=lambda: cuda_knn.knn_topk2(desc16, bias16, chunk, packed=True),
                  plain=lambda: cuda_knn.knn_topk2_packed_plain(desc16, bias16, chunk))
    rows.append({"name": "knn_packed_match100", "route": "cuda",
                 "source": "reconstructor_tpu_torch/" + cuda_knn.PACKED_SOURCE,
                 "replaces": cuda_knn.PACKED_REPLACES, "launches": packed_launches,
                 "max_abs_err": pres["max_abs_err"], "ms": t2["ms"], "plain_ms": t2["plain_ms"],
                 "bound_ms": t2["bound_ms"], "bound_by": t2["bound_by"],
                 "library_ms": t2["library_ms"]})
    del desc16, bias16, desc_d, mask_d, state100, ungated
    torch.cuda.empty_cache()

    # (e) the SIFT stages on the 25 views
    t = time.perf_counter()
    gray, shapes, _ = io_images.pad_batch(imgs)
    prof = profile_detect.profile(gray, shapes, cfg, dev,
                                  log=lambda m: log("measure", "(e) " + m))
    stage_keys = ("scale_space_ms", "dog_gates_ms", "nms_topk_ms", "detect_ms",
                  "descriptors_ms", "resample_ms", "full_ms")
    log("measure", f"(e) profile_detect in {time.perf_counter() - t:.1f}s: " + json.dumps(prof))
    for k in stage_keys:
        check(np.isfinite(prof[k]) and prof[k] > 0, f"measure (e): stage {k} {prof}")

    # (f) the quality sweep on every third view, against their true centres
    t = time.perf_counter()
    sub, sub_imgs = every_third_view(scene, imgs)
    golden = os.path.join(tmp, "golden_every_third.ply")
    ply.save_cloud(golden, scene["points"],
                   np.full((len(scene["points"]), 3), 128, np.uint8), sub["poses"])
    state0 = exp_quality.matched_state(sub_imgs, cfg, dev)
    qual = exp_quality.sweep(state0, cfg, golden, dev,
                             log=lambda m: log("measure", "(f) " + m))
    log("measure", f"(f) exp_quality, {len(qual)} variants on {len(sub_imgs)} views in "
                   f"{time.perf_counter() - t:.1f}s")
    check(len(qual) == len(exp_quality.VARIANTS), f"measure (f): variants {list(qual)}")
    d = qual["default"]
    check(d["registered"] == len(sub_imgs) and d["ate_norm"] < 0.10,
          f"measure (f): default registered {d['registered']}/{len(sub_imgs)}, "
          f"ATE {d['ate_norm']}")
    log("measure", f"phase {time.perf_counter() - t_phase:.1f}s")
    return rows


# ----------------------------------------------------------------------
# the 100-view stress run and the BA profile
# ----------------------------------------------------------------------

def phase_stress(dev, tmp: str, views: int = 100):
    """The port's ``scripts/stress_synth.py`` path on the card at full
    width (2,000 points + 128 clutter slots a view, 128-D, K = 2,176),
    ``views`` views, autosaving every ``views // 2`` registrations (a
    full-state file takes seconds to compress at 100 views; the default
    cadence of 3 would make ~36): at least 98% of the views registered,
    normalised ATE under 6%, the kNN kernel launched once per chunk of
    pairs, and at least one ``triangulate_batch`` call of more matrices
    than the eigensolver takes at once (``EIGH_BATCH``: cuSOLVER's batched
    ``eigh`` rejected 38,444), so that its slicing runs on the card. Then
    the kernel on the run's first chunk of pairs, against its
    plain version and timed beside its bound. The autosave made when half
    the views had registered is copied; a fresh reconstructor resumed
    from it (no further autosaves) must end in the uninterrupted run's
    state bit for bit. Then ``stress_report`` on the final autosave must
    give the run's counts."""
    import shutil

    import numpy as np
    import torch
    from reconstructor_tpu_torch.geometry import triangulation
    from reconstructor_tpu_torch.scripts import stress_report, stress_synth
    d = os.path.join(tmp, "stress")
    os.makedirs(d)
    ckpt, mid = os.path.join(d, "run.npz"), os.path.join(d, "mid.npz")
    scene_state, gt, _ = stress_synth.scene(views)
    cadence = {"checkpoint_every_views": views // 2}
    rec = stress_synth.reconstructor(scene_state, device=dev, verbose=False, **cadence)
    saved = {"autosaves": 0, "autosave_s": 0.0}
    autosave = rec._autosave

    def copying(state, path):
        t = time.perf_counter()
        autosave(state, path)
        saved["autosave_s"] += time.perf_counter() - t
        saved["autosaves"] += 1
        if len(state.registered) >= views // 2 and "at" not in saved:
            shutil.copy(path, mid)
            saved["at"] = len(state.registered)
    rec._autosave = copying
    triangulate = triangulation.triangulate_batch
    batches = []

    def recording(poses, *args):
        batches.append(poses.shape[0])
        return triangulate(poses, *args)
    triangulation.triangulate_batch = recording
    try:
        state, info = stress_synth.drive(rec, scene_state, ckpt)
    finally:
        triangulation.triangulate_batch = triangulate
    res = stress_synth.report(state, gt, wall_s=info["wall_s"], ba_calls=info["ba_calls"],
                              knn_launches=info["knn_launches"])
    res.update(autosaves=saved["autosaves"], autosave_s=saved["autosave_s"],
               triangulate_calls=len(batches), triangulate_largest=max(batches, default=0),
               triangulate_over_eigh_batch=sum(b > triangulation.EIGH_BATCH for b in batches),
               stages_s={k: v / 1e3 for k, v in rec.timer.totals().items()})
    log("stress", json.dumps(res))
    log("stress", "the JAX package on its chip (out/stress100.json): 100/100 views, 19,976 "
                  "landmarks, 102,558 observations, 1.99% ATE (seed 1; seed 0 cold: 3.96%)")
    check(res["views_registered"] >= 0.98 * views,
          f"stress: registered {res['views_registered']} of {views}")
    check(res["ate_rmse_normalized"] < 0.06,
          f"stress: normalised ATE {res['ate_rmse_normalized']}")
    pairs = rec.select_pairs(state)
    B = rec.config.match_chunk_pairs_fused
    chunks = -(-len(pairs) // B)
    check(res["knn_launches"] >= chunks,
          f"stress: {res['knn_launches']} kNN kernel launches for {chunks} chunks of pairs")
    check("at" in saved, "stress: no autosave after half the views")
    check(res["triangulate_largest"] > triangulation.EIGH_BATCH,
          f"stress: the largest triangulate_batch call held {res['triangulate_largest']} "
          f"matrices, not more than EIGH_BATCH = {triangulation.EIGH_BATCH}")

    # the kernel on the very inputs the run gave it: its first chunk
    desc_d, mask_d, _ = rec._device_frontend(state)
    desc16 = desc_d.to(torch.bfloat16)
    chunk = torch.from_numpy(np.ascontiguousarray(pairs[:B], dtype=np.int32)).to(dev)
    label = (f"stress run's first chunk bf16 (N={views}, Kt={desc_d.shape[1]}, "
             f"D={desc_d.shape[2]}, B={chunk.shape[0]} of {len(pairs)} pairs)")
    knn, _ = compare_knn(desc16, mask_d, chunk, exact=False, tol=1e-5,
                         min_match_agree=0.999, label=label)
    knn.update(time_knn(desc16, mask_d, chunk, label), launches=res["knn_launches"],
               chunks=chunks)
    log("stress", "kNN kernel: " + json.dumps(knn))
    res["knn"] = knn
    del desc16, chunk

    rec2 = stress_synth.reconstructor(scene_state, device=dev, verbose=False, **cadence)
    t = time.perf_counter()
    again = rec2.reconstruct_from_state(rec2.restore(mid))
    torch.cuda.synchronize()
    resumed = {"resumed_at": saved["at"], "resumed_s": time.perf_counter() - t,
               "state_sha256": state_sha256(state), "state_sha256_resumed": state_sha256(again)}
    log("stress", "resume: " + json.dumps(resumed))
    check_same_state(state, again, "the resumed stress run against the uninterrupted one")
    rep = stress_report.report(ckpt, views, wall_s=info["wall_s"])
    log("stress", "stress_report on the final autosave: " + json.dumps(rep))
    for k in ("views_registered", "views_total", "landmarks", "observations", "ate_rmse",
              "ate_rmse_normalized"):
        check(rep[k] == res[k], f"stress_report's {k} {rep[k]} is not the run's {res[k]}")
    res.update(resumed)
    return res


def phase_ba_profile(dev) -> dict:
    """The port's ``scripts/profile_ba.py`` on the saved fountain BA
    problem: every piece of both solvers timed, the segment-sum kernel
    beside ``index_add_``, each full solve's device-busy share."""
    import math
    from reconstructor_tpu_torch.scripts import profile_ba
    t = time.perf_counter()
    res = profile_ba.profile(profile_ba.problem("final", dev), "final")
    log("ba-profile", json.dumps(res))
    log("ba-profile", f"phase {time.perf_counter() - t:.1f}s")
    for k, v in res["ms"].items():
        check(isinstance(v, float) and math.isfinite(v) and v > 0, f"ba-profile: {k} = {v}")
    for name, b in res["busy"].items():
        check(b["busy_share"] is not None and b["busy_share"] > 0,
              f"ba-profile: {name} shows no device time")
    return res


def heldout_views(seed: int, n_views: int):
    """``make_scene(seed, n_views)`` at 160 x 160 and its views as the
    8-bit frames a user's folder would hold (the JAX package's learned
    test writes them as PNGs)."""
    import numpy as np
    from reconstructor_tpu_torch.eval import render
    from reconstructor_tpu_torch.io import images as io_images
    scene = render.make_scene(seed=seed, n_views=n_views, h=160, w=160)
    imgs = [io_images.from_rgb(np.repeat(np.clip(im * 255.0, 0, 255).astype(np.uint8)[..., None],
                                         3, -1), path=f"view{i:02d}")
            for i, im in enumerate(scene["images"])]
    return scene, imgs


RANSAC_SEEDS = (0, 1, 2, 3)


def phase_train(dev, tmp: str, here: str) -> dict:
    """SuperPoint trained on the card by the port's
    ``scripts/train_frontend.py`` at the JAX script's defaults (1,500
    steps, 24 scenes x 6 views, 160 px): ms a step and the wall, a finite
    loss that falls, the script's held-out metrics; then the JAX package's
    own bars for the weights it writes (``tests/test_learned_e2e.py``):
    detector recall at 2 px > 0.15 on ``make_scene(seed=33, n_views=3)``,
    and the learned path (structured SuperGlue, 50 Sinkhorn iterations,
    256 keypoints, focal 170, global BA every view, one final round) on
    ``make_scene(seed=21, n_views=8)``: 8/8 views, > 60 landmarks and
    normalised ATE < 10% at 3 or more of the RANSAC seeds 0-3 (the
    small scene's outcome moves with the RANSAC stream for one set of
    weights), the Sinkhorn kernel launched in every run. The committed
    ``tests/data/superpoint_synth.npz`` (trained by the JAX script) runs
    the same scenes and seeds and is printed beside them, not gated."""
    import numpy as np
    import torch
    from reconstructor_tpu_torch.config import ReconstructorConfig
    from reconstructor_tpu_torch.features import superpoint as sp
    from reconstructor_tpu_torch.scripts import train_frontend as tf
    t = time.perf_counter()
    data = tf.to_device(tf.make_dataset(24, 6, 160, 160, tf.LM_BUDGET, 0), dev)
    log("train", f"rendered 24 scenes x 6 views at 160 px in {time.perf_counter() - t:.1f}s")
    steps = 1500
    res = tf.train(data, steps, 1.5e-3, 0)
    losses = res["losses"]
    first, last = losses[:50, 0].mean(), losses[-50:, 0].mean()
    import hashlib
    digest = hashlib.sha256()
    for prm in res["net"].parameters():
        digest.update(prm.detach().cpu().numpy().tobytes())
    summary = {"steps": steps, "train_wall_s": res["wall_s"],
               "weights_sha256": digest.hexdigest(),
               "ms_per_step": res["wall_s"] / steps * 1e3,
               "loss_first50": float(first), "loss_last50": float(last),
               "det_last50": float(losses[-50:, 1].mean()),
               "desc_last50": float(losses[-50:, 2].mean()),
               "heldout_seed777": tf.evaluate(res["net"], 0, 160, 160)}
    log("train", json.dumps(summary))
    check(np.isfinite(losses).all(), "train: a non-finite loss")
    check(last < 0.8 * first, f"train: the loss did not fall ({first:.4f} -> {last:.4f})")
    del data
    path = os.path.join(tmp, "superpoint_port.npz")
    sp.save_npz(res["net"], path)
    committed = os.path.join(here, "tests", "data", "superpoint_synth.npz")
    det_scene = heldout_views(33, 3)[0]
    learned_scene, learned_imgs = heldout_views(21, 8)
    out = {}
    for label, weights in (("port-trained", path), ("committed", committed)):
        net = sp.params_from_npz(weights).to(dev)
        recall, precision = tf.detector_recall(net, det_scene)
        cfg = ReconstructorConfig(
            detector="superpoint", superpoint_weights=weights, matcher="superglue",
            superglue_weights="structured", max_keypoints=256, focal_px=170.0,
            superglue_sinkhorn_iters=50, ba_local_window=0, final_refinement_rounds=1)
        runs, launches = {}, {}
        for seed in RANSAC_SEEDS:
            _, _, launches[seed], r = run_path(
                dev, tmp, f"train-{label}-seed{seed}", learned_scene, learned_imgs,
                cfg.with_(rng_seed=seed), min_registered=0, max_ate=float("inf"))
            runs[seed] = [r["registered"], r["landmarks"], r["ate_normalized"]]
        passed = [seed for seed, (n, lm, ate) in runs.items()
                  if n == len(learned_imgs) and lm > 60 and ate < 0.10]
        out[label] = {"recall_2px_seed33": recall, "precision_2px_seed33": precision,
                      "rng_seeds": runs, "seeds_passing": passed, "launches": launches}
        log("train", f"{label} weights (learned runs at RANSAC seeds {RANSAC_SEEDS}: "
                     "registered, landmarks, ATE): " + json.dumps(out[label]))
    port, ref = out["port-trained"], out["committed"]
    log("train", f"seeds passing the JAX package's bars: port-trained {port['seeds_passing']}, "
                 f"committed {ref['seeds_passing']}")
    check(port["recall_2px_seed33"] > 0.15,
          f"train: held-out recall at 2 px {port['recall_2px_seed33']} <= 0.15")
    check(len(port["seeds_passing"]) >= 3,
          f"train: the port-trained weights pass 8/8, > 60 landmarks, ATE < 10% at RANSAC "
          f"seeds {port['seeds_passing']} only, of {RANSAC_SEEDS}")
    check(all(n["sinkhorn"] > 0 for n in port["launches"].values()),
          "train: a learned run never launched the Sinkhorn kernel")
    torch.cuda.empty_cache()
    summary["heldout"] = out
    return summary


DISTILL_STEPS = 1200       # the script's default
DISTILL_PAIRS = 400        # the script's default
SUPERGLUE_STEPS = 600      # the script's default: 1500 (~64 ms a step on an H100)
SUPERGLUE_PAIRS = 200      # the script's default


def phase_distill(dev, tmp: str, imgs, steps: int = DISTILL_STEPS,
                  pairs: int = DISTILL_PAIRS) -> dict:
    """The port's ``scripts/distill_fountain.py`` on the rendered 25 views
    in place of the photographs, at the script's widths (CROP 160, 48
    keypoints a pair, batch 8, lr 1.5e-3) and depth (1,200 steps, 400
    crop pairs; ``steps`` and ``pairs`` cut it): the teacher
    (the port's SIFT, 1024 keypoints, the config's settings) on all 25
    views, the bank from views 0-19, ``train`` under cuDNN's deterministic
    algorithms, then recall and precision at 2 px against the teacher on
    views 20-24 (printed, not gated). Gates: finite losses, the mean loss
    of the last 50 steps under 0.8x that of the first 50, and the float16
    npz ``save_params`` writes reloading (``superpoint.params_from_npz``)
    to the saved weights rounded to float16."""
    import numpy as np
    import torch
    from reconstructor_tpu_torch.config import ReconstructorConfig
    from reconstructor_tpu_torch.features import superpoint as sp
    from reconstructor_tpu_torch.scripts import distill_fountain as df
    t0 = time.perf_counter()
    log("distill", f"depth: {steps} steps (script: 1200), {pairs} crop pairs (script: 400); "
                   f"widths as the script: CROP {df.CROP}, {df.M_KP} keypoints a pair, batch 8, "
                   f"lr 1.5e-3")
    gray, shapes, grays = df.gray_crops(imgs)
    t = time.perf_counter()
    t_xy, t_mask = df.teacher(gray, shapes, ReconstructorConfig(), dev)
    teacher_s = time.perf_counter() - t
    t = time.perf_counter()
    bank = df.to_device(df.build_bank(grays[:20], t_xy[:20], t_mask[:20], pairs,
                                      np.random.default_rng(0)), dev)
    bank_s = time.perf_counter() - t
    res = df.train(bank, steps, 1.5e-3, 8, 0)
    losses = res["losses"]
    first, last = float(losses[:50, 0].mean()), float(losses[-50:, 0].mean())
    recall, precision = df.heldout_recall(res["net"], gray, shapes, t_xy, t_mask)
    path = os.path.join(tmp, "superpoint_distilled.npz")
    df.save_params(res["net"], path)
    back = sp.params_from_npz(path).state_dict()
    saved = {k: v.detach().cpu().half().float() for k, v in res["net"].state_dict().items()}
    summary = {"teacher_kps_per_view": float(t_mask.sum(1).mean()), "teacher_s": teacher_s,
               "bank_s": bank_s, "steps": steps, "train_wall_s": res["wall_s"],
               "ms_per_step": res["wall_s"] / steps * 1e3, "loss_first50": first,
               "loss_last50": last, "det_last50": float(losses[-50:, 1].mean()),
               "desc_last50": float(losses[-50:, 2].mean()),
               "teacher_recall_2px_heldout": recall, "teacher_precision_2px_heldout": precision,
               "npz_bytes": os.path.getsize(path), "phase_s": time.perf_counter() - t0}
    log("distill", json.dumps(summary))
    check(np.isfinite(losses).all(), "distill: a non-finite loss")
    check(last < 0.8 * first, f"distill: the loss did not fall ({first:.4f} -> {last:.4f})")
    check(set(back) == set(saved) and all(torch.equal(back[k], saved[k]) for k in saved),
          "distill: the saved float16 weights reload to other values")
    del bank
    torch.cuda.empty_cache()
    return summary


def phase_train_superglue(dev, tmp: str, here: str, imgs, steps: int = SUPERGLUE_STEPS,
                          pairs: int = SUPERGLUE_PAIRS) -> dict:
    """The port's ``scripts/train_superglue.py`` on the rendered 25 views in
    place of the photographs, at the script's widths (CROP 320, 512
    keypoints, 4 layers, batch 8, 50 Sinkhorn iterations, lr 2e-4) and its
    200 crop pairs, at 600 of its 1,500 steps (the one cut, for the
    smoke's time): the bank from ``tests/data/superpoint_fountain.npz``, then
    ``train`` with the Sinkhorn kernel's launch counter set to 0 just
    before and read just after (``val_f1`` decodes each held-out pair
    with ``match_pair``: one kernel launch a pair a validation; every
    validation's F1 is printed). Gates: at step 0 every validation pair's
    matches equal the structured identity's (18 layers) bit for bit;
    finite losses; the mean loss of the last 50 steps under that of the
    first 50; the last (trained) weights decode other matches than the
    identity on some validation pair; the trained and the best weights
    through ``params_to_npz`` and ``params_from_npz`` each decode the same
    matches; the kernel's launches equal the ``match_pair`` calls. Then
    the kernel on one validation pair's scores under the trained weights
    (B = 1, K = 512, 100 iterations: the shape ``val_f1`` gives it)
    against its plain version, and timed. Returns the summary with the
    launches and the kernel's figures."""
    import numpy as np
    import torch
    from reconstructor_tpu_torch.features import superpoint as sp
    from reconstructor_tpu_torch.matching import cuda_sinkhorn, superglue as sg
    from reconstructor_tpu_torch.scripts import distill_fountain as df
    from reconstructor_tpu_torch.scripts import train_superglue as ts
    t0 = time.perf_counter()
    log("train-superglue", f"depth: {steps} steps (script: 1500), {pairs} crop pairs "
                           f"(script: 200); widths as the script: CROP {ts.CROP}, 512 keypoints, "
                           f"4 layers, batch 8, 50 Sinkhorn iterations, lr 2e-4")
    _, _, grays = df.gray_crops(imgs)
    sp_net = sp.params_from_npz(os.path.join(here, "tests", "data",
                                             "superpoint_fountain.npz")).to(dev)
    t = time.perf_counter()
    bank = ts.build_bank(grays, sp_net, pairs, 512, np.random.default_rng(0))
    bank_s = time.perf_counter() - t
    n_bank = bank["d0"].shape[0]
    trn, val = ts.split_bank(bank, dev)
    n_val = val["d0"].shape[0]
    shape = torch.tensor([ts.CROP, ts.CROP], dtype=torch.int32, device=dev)

    def decode_all(net):
        return [sg.match_pair(net, *(val[k][i] for k in ("d0", "d1", "x0", "x1", "s0", "s1")),
                              val["m0"][i].bool(), val["m1"][i].bool(), shape, shape,
                              sinkhorn_iters=100, score_thresh=0.5) for i in range(n_val)]

    def same(a, b):
        return all(torch.equal(x, y) for pa, pb in zip(a, b) for x, y in zip(pa, pb))

    def round_trip_same(net, name):
        path = os.path.join(tmp, name)
        sg.params_to_npz(net, path)
        return same(decode_all(net), decode_all(sg.params_from_npz(path).to(dev)))

    net = ts.small_identity_params(4).to(dev)
    step0 = decode_all(net)
    identity_same = same(step0, decode_all(sg.structured_identity_params().to(dev)))
    cuda_sinkhorn.reset_launches()
    res = ts.train(net, trn, val, steps, 2e-4, 8, 50)
    launches = cuda_sinkhorn.LAUNCHES
    losses = res["losses"]
    first, last = float(losses[:50].mean()), float(losses[-50:].mean())
    for step, f1, prec, rec in res["validations"]:
        log("train-superglue", f"validation at step {step}: F1 {f1:.4f} (P {prec:.4f} "
                               f"R {rec:.4f})")
    # the kernel at the shape val_f1 gives it (B = 1, K = 512, 100
    # iterations), held against its plain version and timed
    pair = lambda k0, k1: torch.stack([val[k0][0], val[k1][0]])  # noqa: E731
    with torch.no_grad():
        scores, m0, m1 = sg.pair_scores(
            res["net"], pair("d0", "d1"), pair("x0", "x1"), pair("s0", "s1"),
            pair("m0", "m1").bool(), shape.expand(2, 2), torch.tensor([[0, 1]], device=dev))
    alpha = res["net"].bin_score.detach()
    kernel = {**compare_sinkhorn(scores, alpha, m0, m1, 100, "train-superglue val_f1 pair",
                                 marginal_tol=None),
              **time_sinkhorn(scores, alpha, m0, m1, 100, "train-superglue val_f1 pair")}
    trained = decode_all(res["net"])
    trained_differs = sum(not all(torch.equal(x, y) for x, y in zip(a, b))
                          for a, b in zip(trained, step0))
    trained_same = round_trip_same(res["net"], "superglue_last.npz")
    best_same = round_trip_same(res["best"], "superglue_best.npz")
    summary = {"bank_pairs": n_bank, "train_pairs": n_bank - n_val, "val_pairs": n_val,
               "bank_s": bank_s, "steps": steps, "train_wall_s": res["wall_s"],
               "ms_per_step": res["wall_s"] / steps * 1e3, "loss_first50": first,
               "loss_last50": last, "identity_f1": res["identity"][0],
               "identity_precision": res["identity"][1], "identity_recall": res["identity"][2],
               "best_f1": res["best_f1"], "would_save": res["best_f1"] > res["identity"][0],
               "step0_equals_structured_identity": identity_same,
               "validation_f1": [v[1] for v in res["validations"]],
               "trained_pairs_decoded_otherwise": trained_differs,
               "npz_round_trip_same_matches": {"trained": trained_same, "best": best_same},
               "val_calls": res["val_calls"],
               "sinkhorn_launches": launches, "phase_s": time.perf_counter() - t0,
               "kernel_val_pair": {k: kernel[k] for k in ("max_abs_err", "match_agree", "ms",
                                                          "plain_ms", "bound_ms", "bound_by",
                                                          "library_ms")}}
    log("train-superglue", json.dumps(summary))
    check(identity_same, "train-superglue: step 0 does not decode as the structured identity")
    check(np.isfinite(losses).all(), "train-superglue: a non-finite loss")
    check(last < first, f"train-superglue: the loss did not fall ({first:.4f} -> {last:.4f})")
    check(trained_differs > 0, "train-superglue: the trained weights decode every validation "
                               "pair as the identity does")
    check(trained_same and best_same,
          "train-superglue: params_to_npz -> params_from_npz decodes otherwise")
    check(launches == res["val_calls"] * n_val > 0,
          f"train-superglue: {launches} Sinkhorn launches for {res['val_calls']} x {n_val} "
          f"match_pair calls")
    del bank, val, trn
    torch.cuda.empty_cache()
    return summary


def phase_ba_variants(dev) -> dict:
    """The port's ``scripts/check_ba_variants.py`` on the card (the saved
    fountain problem and the 100 x 40,000 synthetic one): 'high' must
    end within 1e-3 relative of 'highest''s final cost on both (the JAX
    docstring's converged-cost parity); the bf16-storage rows are
    recorded, not gated. First the three Schur precisions' products
    against a float64 product on W-shaped operands."""
    import torch
    from reconstructor_tpu_torch.ba import lm as ba_lm
    from reconstructor_tpu_torch.scripts import check_ba_variants, profile_ba
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((1344, 16384), generator=g, device=dev)
    b = torch.randn((16384, 1344), generator=g, device=dev) * 1e-2
    exact = a.double() @ b.double()
    scale = float((a.double().abs() @ b.double().abs()).max())
    err = {p: float((ba_lm.schur_mm(a, b, p).double() - exact).abs().max()) / scale
           for p in ba_lm.SCHUR_PRECISIONS}
    log("ba-variants", "schur_mm error / scale against float64 (1344 x 16384 x 1344): "
                       + json.dumps(err))
    check(err["high"] < 1e-6 and err["highest"] < 1e-6,
          f"ba-variants: the float32 products off by {err}")
    check(err["default"] > 10 * err["high"],
          f"ba-variants: the bf16 pass no coarser than float32 ({err}): operands not rounded?")
    del a, b, exact
    out = {"schur_mm_rel_err": err, "problems": []}
    for name in ("final", "large"):
        t = time.perf_counter()
        res = check_ba_variants.check(profile_ba.problem(name, dev), name, reps=3)
        log("ba-variants", f"{name} ({time.perf_counter() - t:.1f}s): " + json.dumps(res))
        check(res["high_vs_highest_rel"] < 1e-3,
              f"ba-variants: {name}: 'high' ends {res['high_vs_highest_rel']} relative from "
              f"'highest'")
        out["problems"].append(res)
        torch.cuda.empty_cache()
    return out


def run_scaling_script(here: str, script: str, args, timeout: float) -> dict:
    """One of the port's rank-scaling scripts in a subprocess; its JSON."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"reconstructor_tpu_torch.scripts.{script}", *args],
        cwd=here, env=dict(os.environ, PYTHONPATH=here), capture_output=True, text=True,
        timeout=timeout)
    check(proc.returncode == 0, f"{script} {' '.join(args)} exited {proc.returncode}:\n"
                                f"{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    log("scaling", f"{script} {' '.join(args)} ({time.perf_counter() - t:.1f}s): "
                   + json.dumps({k: v for k, v in res.items() if k != "workers"}))
    return res


def phase_scaling(here: str) -> dict:
    """The port's ``scripts/bench_scaling.py`` with worlds of 1 and 2
    gloo ranks sharing the card (the ranks load the kernels this script
    built): the 2-rank match and gated tables equal the 1-rank ones, every
    rank of a world ends with one BA cost, iteration count and cost trace;
    then ``diag_scaling``'s fit and replicated pieces on the bench's BA
    times (best of a world's solves, as the script takes them); with two
    or more cards, bench_scaling again with one NCCL rank per card."""
    import math

    import torch
    from reconstructor_tpu_torch.scripts import diag_scaling
    bench = run_scaling_script(here, "bench_scaling", ["--ranks", "1,2", "--device", "cuda:0",
                                                       "--timeout", "300"], 900)
    one, two = bench["workers"]["1"], bench["workers"]["2"]
    for n, ws in (("1", one), ("2", two)):
        for w in ws:
            log("scaling", f"  {n} rank(s), rank {w['rank']}: " + json.dumps(
                {k: w[k] for k in ("knn_kernel_launches", "knn_sha256", "gated_sha256",
                                   "knn_s", "gated_s", "ba_s", "ba_cost_initial",
                                   "ba_cost_final", "ba_iterations", "ba_cost_trace")}))
    for w in two:
        check(w["knn_sha256"] == one[0]["knn_sha256"], "scaling: the 2-rank match table "
                                                       "differs from the 1-rank one")
        check(w["gated_sha256"] == one[0]["gated_sha256"], "scaling: the 2-rank gated table "
                                                           "differs from the 1-rank one")
        for key in ("ba_cost_final", "ba_iterations", "ba_cost_trace"):
            check(w[key] == two[0][key], f"scaling: the 2 ranks end with different {key}")
    # the JAX script's 25-camera problem turns its rig through 6 rad, so most
    # cameras see the points from behind: a timing load on which LM accepts
    # no step (its seconds time rejected trials); a rank may only end at or
    # below its initial cost
    for w in one + two:
        check(w["knn_kernel_launches"] > 0, f"scaling: rank {w['rank']} never launched the "
                                            f"kNN kernel")
        check(math.isfinite(w["ba_cost_final"]) and w["ba_cost_final"] <= w["ba_cost_initial"],
              f"scaling: rank {w['rank']} BA cost {w['ba_cost_initial']} -> "
              f"{w['ba_cost_final']}")
    t = {n: min(ws[0]["ba_s"]) for n, ws in ((1, one), (2, two))}
    diag = diag_scaling.diagnose(t, "cuda:0", bench["ba_cams"], bench["ba_points"])
    log("scaling", f"diag_scaling on the bench's BA seconds {json.dumps(t)}: "
                   + json.dumps(diag))
    out = {"bench": {k: v for k, v in bench.items() if k != "workers"}, "diag": diag}
    count = torch.cuda.device_count()
    if count >= 2:
        ranks = ",".join(str(n) for n in (1, 2, 4) if n <= count)
        out["nccl"] = run_scaling_script(here, "bench_scaling", ["--ranks", ranks, "--device",
                                                                 "cuda", "--timeout", "300"],
                                         1200)
    else:
        log("scaling", f"one NCCL rank per card: not run, torch.cuda.device_count() = {count}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rng-seed", type=int, default=0,
                    help="the reconstructor's RANSAC seed (config.rng_seed) in the e2e phases")
    ap.add_argument("--pnp-replay", default=None, metavar="NPZ",
                    help="also write the e2e phase's PnP inputs, draws and results here, for "
                         "tests/replay_pnp_dlt6.py")
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
    from reconstructor_tpu_torch.ba import cuda_blocks, cuda_schur, cuda_segsum
    from reconstructor_tpu_torch.config import ReconstructorConfig
    from reconstructor_tpu_torch.geometry import cuda_fgate
    from reconstructor_tpu_torch.matching import cuda_knn, cuda_sinkhorn
    from reconstructor_tpu_torch.scripts import profile_knn_kernel
    from reconstructor_tpu_torch.utils import cuda_build

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(smi, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)} | torch {torch.__version__} "
                  f"cuda {torch.version.cuda} | nvidia-smi: {smi}")

    # one nvcc per source, all started together
    def build(src):
        t = time.perf_counter()
        cuda_build.load(src)
        return src, time.perf_counter() - t
    sources = [cuda_knn.SOURCE, cuda_sinkhorn.SOURCE, cuda_knn.PACKED_SOURCE,
               profile_knn_kernel.SOURCE, cuda_segsum.SOURCE, cuda_schur.SOURCE,
               cuda_fgate.SOURCE, cuda_blocks.SOURCE]
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        for src, secs in pool.map(build, sources):
            log("build", f"{src}: {secs:.1f}s")
    for src in sources:
        for k in ptxas_summary(cuda_build.build_log(src)):
            log("build", f"{src} ptxas: " + json.dumps(k))
    log("build", "bf16 kNN launch, shared by the kNN, packed and level kernels (D=128 / 256): "
                 + json.dumps([cuda_knn.wgmma_plan(d, dev) for d in (128, 256)]))
    log("build", "sinkhorn launch at the learned path's chunk (B=8, M1=N1=1025): "
                 + json.dumps(cuda_sinkhorn.plan(8, 1025, 1025, dev)))

    desc, mask, chunk = phase_kernels(dev)
    phase_timing(desc, mask, chunk)
    del desc, mask
    torch.cuda.empty_cache()
    phase_sinkhorn(dev)
    packed = phase_packed(dev)
    levels = phase_levels(dev)
    torch.cuda.empty_cache()
    fgate = phase_fgate(dev, here)

    scene, imgs = render_views()
    sp_weights = os.path.join(here, "tests", "data", "superpoint_synth.npz")
    kernels = [fgate]
    with tempfile.TemporaryDirectory() as tmp:
        launches, res, t, summary, e2e_state = phase_e2e(
            dev, tmp, scene, imgs, ReconstructorConfig(rng_seed=args.rng_seed), args.pnp_replay)
        e2e_ate = summary["ate_normalized"]
        kernels.append({"name": "knn_top2", "route": "cuda",
                        "source": "reconstructor_tpu_torch/" + cuda_knn.SOURCE,
                        "replaces": cuda_knn.REPLACES, "launches": launches,
                        "max_abs_err": res["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        log("e2e", json.dumps(summary))
        learned_cfg = ReconstructorConfig(
            detector="superpoint", matcher="superglue", superpoint_weights=sp_weights,
            superglue_weights="structured", max_keypoints=1024, focal_px=614.4,
            rng_seed=args.rng_seed)
        launches, res, t, summary, learned_run = phase_learned(dev, tmp, scene, imgs,
                                                               learned_cfg)
        kernels.append({"name": "sinkhorn", "route": "cuda",
                        "source": "reconstructor_tpu_torch/" + cuda_sinkhorn.SOURCE,
                        "replaces": cuda_sinkhorn.REPLACES, "launches": launches,
                        "max_abs_err": res["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": None})
        log("learned", json.dumps(summary))
        p_launches, p_res, p_t = packed
        for name, src, replaces, (launches, res, t) in (
                ("knn_packed", cuda_knn.PACKED_SOURCE, cuda_knn.PACKED_REPLACES,
                 (p_launches[torch.float32], p_res[torch.float32], p_t[torch.float32])),
                ("knn_packed_bf16", cuda_knn.PACKED_SOURCE, cuda_knn.PACKED_REPLACES,
                 (p_launches[torch.bfloat16], p_res[torch.bfloat16], p_t[torch.bfloat16])),
                ("knn_levels", profile_knn_kernel.SOURCE, profile_knn_kernel.REPLACES, levels)):
            kernels.append({"name": name, "route": "cuda",
                            "source": "reconstructor_tpu_torch/" + src,
                            "replaces": replaces, "launches": launches,
                            "max_abs_err": res["max_abs_err"], "ms": t["ms"],
                            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        trace_packed(dev)
        phase_segsum(dev)
        torch.cuda.empty_cache()
        phase_profile(dev, tmp, imgs, args.rng_seed)
        orb_cfg = ReconstructorConfig(detector="orb", rng_seed=args.rng_seed)
        phase_orb(dev, tmp, scene, imgs, orb_cfg)
        pcg_cfg = ReconstructorConfig(ba_solver="pcg", rng_seed=args.rng_seed)
        pcg_summary, pcg_state, (launches, res, fused, path_L) = phase_pcg_path(
            dev, tmp, scene, imgs, pcg_cfg)
        kernels.append({"name": "seg_sum", "route": "cuda",
                        "source": "reconstructor_tpu_torch/" + cuda_segsum.SOURCE,
                        "replaces": cuda_segsum.REPLACES, "launches": launches["seg_sum"],
                        "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                        "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                        "bound_by": res["bound_by"], "library_ms": res["library_ms"]})
        # one W^T u and one W z, as a matvec takes them: both directions summed
        kernels.append({"name": "schur_sums", "route": "cuda",
                        "source": "reconstructor_tpu_torch/" + cuda_schur.SOURCE,
                        "replaces": cuda_schur.REPLACES, "launches": launches["schur_sums"],
                        "max_abs_err": max(r["max_abs_err"] for r in fused.values()),
                        **{k: sum(r[k] for r in fused.values())
                           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
                        "bound_by": "bytes"})
        kernels.append({**phase_blocks(dev, path_L), "launches": launches["block3_matvec"]})
        phase_pcg_street(dev, ReconstructorConfig(rng_seed=args.rng_seed))
        phase_mesh(dev, tmp, here, scene, imgs, pcg_cfg, (pcg_summary, pcg_state), learned_run)
        phase_resume(dev, tmp, scene, imgs, orb_cfg.with_(checkpoint_every_views=3))
        phase_ate(tmp, scene, e2e_state, e2e_ate)
        kernels += phase_measure(dev, tmp, scene, imgs)
        torch.cuda.empty_cache()
        phase_distill(dev, tmp, imgs)
        sg_train = phase_train_superglue(dev, tmp, here, imgs)
        kernels.append({"name": "sinkhorn_val_f1", "route": "cuda",
                        "source": "reconstructor_tpu_torch/" + cuda_sinkhorn.SOURCE,
                        "replaces": cuda_sinkhorn.REPLACES,
                        "launches": sg_train["sinkhorn_launches"],
                        **{k: sg_train["kernel_val_pair"][k]
                           for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}})
        del scene, imgs, e2e_state, pcg_state, learned_run
        torch.cuda.empty_cache()
        phase_stress(dev, tmp)
        phase_ba_profile(dev)
        torch.cuda.empty_cache()
        phase_train(dev, tmp, here)
        phase_ba_variants(dev)
        phase_scaling(here)
    log("done", f"total {time.perf_counter() - T0:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
