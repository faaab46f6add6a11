"""Profile the pieces of the port's BA solvers, per call.

The counterpart of the TPU package's ``scripts/profile_ba.py``, which
times the dense LM's pieces in their TPU layouts (one-hot camera
reductions, a sentinel gather). This script times the port's own pieces:

- dense LM (``ba/lm.py``): the full 20-iteration solve with ``ftol=0``
  (no early exit, so ms/iteration is clean) from a prebuilt layout, the
  layout itself (host-built gather tables), ``_normal_blocks``, the
  ``jacfwd`` Jacobian stacks, the camera-side reductions (one-hot
  products), the point-side reductions (gather and sum),
  ``_damped_schur_step`` and ``_cost``;
- PCG (``ba/distributed.py``): the full 20-iteration solve, the two
  segment layouts, ``_build_pcg_blocks``, one Schur matvec, and one
  segment sum of each kind (observations to cameras at W = 12 and 144, to
  points at W = 3 and 9) through ``cuda_segsum.seg_sum`` (the kernel on
  the card) and through ``index_add_`` (the library call).

Times are per call: CUDA events over ``--reps`` calls after warm-up on
the card (the time between the events on the stream, host gaps included),
the host clock ending in a synchronise elsewhere. The device-busy share
of each full solve comes from a ``torch.profiler`` trace read by
``utils/profiling.py`` ("not measured" off the card). Problems: the
saved fountain problem ``out/ba_problem_final.npz`` and ``exp_ba``'s
synthetic sizes.

    python -m reconstructor_tpu_torch.scripts.profile_ba [--problems final,large] \\
        [--reps 20] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

from reconstructor_tpu_torch.ba import cuda_segsum, distributed, lm as ba_lm
from reconstructor_tpu_torch.scripts import exp_ba
from reconstructor_tpu_torch.utils import device as devices
from reconstructor_tpu_torch.utils import profiling

SOLVE_ITERS = 20


def problem(name: str, device=None) -> ba_lm.BAProblem:
    """``final`` (the saved fountain problem) or one of ``exp_ba.SHAPES``,
    built from ``np.random.default_rng(0)``."""
    if name == "final":
        return exp_ba.load_problem(device=device)
    sh = exp_ba.SHAPES[name]
    prob, _ = exp_ba.make_problem(np.random.default_rng(0), sh["C"], sh["L"], None,
                                  device=device, C_pad=sh["C_pad"], L_pad=sh["L_pad"])
    return prob


def timeit(fn, reps: int = 20, warmup: int = 2, cuda: bool = False) -> float:
    """Milliseconds a call of ``fn``: CUDA events when ``cuda``, else the
    host clock; both after ``warmup`` calls (and a synchronise)."""
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def busy_shares(prob: ba_lm.BAProblem, solves: dict) -> dict:
    """Device-busy share of each full solve, from one traced call each."""
    dev = prob.cam_params.device
    if dev.type != "cuda":
        return {name: "not measured" for name in solves}
    out = {}
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d, device=dev):
            for name, fn in solves.items():
                with profiling.annotate(name):
                    fn()
                    torch.cuda.synchronize(dev)
        summary = profiling.stage_summary(f"{d}/{profiling.TRACE_FILE}", solves)
    for name in solves:
        out[name] = {"busy_share": profiling.busy_share(summary[name]),
                     "launches": summary[name]["launches"],
                     "top_kernels": summary[name]["top_kernels"][:3]}
    return out


def profile(prob: ba_lm.BAProblem, tag: str, reps: int = 20) -> dict:
    """Per-call milliseconds of every piece of both solvers on ``prob``."""
    dev = prob.cam_params.device
    on_card = dev.type == "cuda"
    mask = prob.obs_mask.cpu().numpy()
    host = tuple(np.ascontiguousarray(t.cpu().numpy()) for t in (prob.obs_pt, prob.obs_cam))
    host = (host[0], host[1], mask)
    C, L, O = prob.cam_params.shape[0], prob.points.shape[0], prob.obs_cam.shape[0]
    res = {"problem": tag, "C": C, "L": L, "O": O, "live_observations": int(mask.sum()),
           "live_points": int(np.unique(host[0][mask]).size),
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu", "ms": {}}
    ms = res["ms"]

    def timeit_(fn, reps=reps, warmup=2):
        return timeit(fn, reps, warmup, cuda=on_card)
    long = prob._replace(obs_cam=prob.obs_cam.long(), obs_pt=prob.obs_pt.long())
    cam, pts = prob.cam_params, prob.points
    solve_reps = max(1, min(3, reps))

    # dense LM
    ms["lm_layout"] = timeit_(lambda: ba_lm._layout(prob, host), reps=solve_reps, warmup=1)
    lay = ba_lm._layout(prob, host)
    kw = dict(max_iters=SOLVE_ITERS, init_lambda=1e-3, ftol=0.0, focal_upper_bound=1000.0,
              max_retries=1, huber_delta=0.0, damping="marquardt", schedule="nielsen",
              lambda_up=4.0, lambda_down=2.0, block_dtype="float32", schur_precision="high")

    def lm_solve():
        return ba_lm._solve_core(prob, lay, **kw)
    ms["lm_solve_20"] = timeit_(lm_solve, reps=solve_reps, warmup=1)
    ms["lm_per_iter"] = ms["lm_solve_20"] / SOLVE_ITERS
    ms["lm_normal_blocks"] = timeit_(lambda: ba_lm._normal_blocks(long, lay, cam, pts, 0.0))
    camO, ptO = cam[long.obs_cam], pts[long.obs_pt]
    ms["lm_jacobians"] = timeit_(lambda: ba_lm._jac(camO, ptO, prob.obs_uv))
    Jc, Jp = ba_lm._jac(camO, ptO, prob.obs_uv)
    res_o = ba_lm._resid(camO, ptO, prob.obs_uv) * lay.maskO[:, None]
    jtr_c = torch.einsum("ori,or->oi", Jc, res_o)
    hcc_o = torch.einsum("ori,orj->oij", Jc, Jc).reshape(O, 144)
    ms["lm_camera_reductions"] = timeit_(lambda: (lay.onehot.T @ jtr_c, lay.onehot.T @ hcc_o))
    src = torch.cat([torch.einsum("ori,orj->oij", Jc, Jp).reshape(O, 36),
                     torch.einsum("ori,orj->oij", Jp, Jp).reshape(O, 9),
                     torch.einsum("ori,or->oi", Jp, res_o)], dim=1)
    src = torch.cat([src, torch.zeros_like(src[:1])], dim=0)

    def point_side():
        if lay.p_idx is None:
            return torch.sum(src[lay.w_idx][..., 36:], dim=0)
        return torch.sum(src[lay.p_idx, 36:] * lay.p_mask[..., None], dim=1)
    ms["lm_point_reductions"] = timeit_(point_side)
    res["lm_point_route"] = "coupling table" if lay.p_idx is None else "landmark-major table"
    blocks = ba_lm._normal_blocks(long, lay, cam, pts, 0.0)
    lam = torch.tensor(1e-3, dtype=cam.dtype, device=dev)
    ms["lm_damped_schur_step"] = timeit_(
        lambda: ba_lm._damped_schur_step(prob.cam_free, blocks, lam, "marquardt", "high"))
    ms["lm_cost"] = timeit_(lambda: ba_lm._cost(long, cam, pts, lay.maskO, 0.0))

    # PCG
    def pcg_solve():
        return distributed.solve_pcg(prob, max_iters=SOLVE_ITERS, ftol=0.0)
    ms["pcg_solve_20"] = timeit_(pcg_solve, reps=solve_reps, warmup=1)
    ms["pcg_per_iter"] = ms["pcg_solve_20"] / SOLVE_ITERS
    ms["pcg_layouts"] = timeit_(lambda: distributed._layouts(long))
    segs = distributed._layouts(long)
    ms["pcg_blocks"] = timeit_(lambda: distributed._build_pcg_blocks(long, segs, cam, pts))
    g_c, g_p, H_cc, H_pp, Y = distributed._build_pcg_blocks(long, segs, cam, pts)
    eye3 = torch.eye(3, dtype=cam.dtype, device=dev)
    H_pp_inv = distributed._inv3x3(H_pp + 1e-3 * eye3)
    u = torch.ones(C * 12, dtype=cam.dtype, device=dev)
    ms["pcg_schur_matvec"] = timeit_(
        lambda: distributed._schur_matvec(long, segs, Y, H_cc, H_pp_inv, u), reps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for lay_name, seg_lay, index in (("cam", segs.cam, long.obs_cam),
                                     ("pt", segs.pt, long.obs_pt)):
        for W in ((12, 144) if lay_name == "cam" else (3, 9)):
            v = torch.randn(O, W, generator=gen, device=dev) * prob.obs_mask[:, None]
            key = f"seg_sum_{lay_name}_w{W}"
            ms[key + "_kernel"] = (timeit_(lambda: cuda_segsum.seg_sum(v, seg_lay))
                                   if on_card else "not measured")
            ms[key + "_index_add"] = timeit_(
                lambda: torch.zeros(seg_lay.n, W, device=dev).index_add_(0, index, v), reps)
    res["busy"] = busy_shares(prob, {"lm_solve_20": lm_solve, "pcg_solve_20": pcg_solve})
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--problems", default="final,large")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    for name in args.problems.split(","):
        res = profile(problem(name, dev), name, args.reps)
        print(f"== {name}: C={res['C']} L={res['L']} O={res['O']} (live "
              f"{res['live_observations']} observations, {res['live_points']} points) on "
              f"{res['device']}", file=sys.stderr)
        for k, v in res["ms"].items():
            print(f"  {k:28s} {v if isinstance(v, str) else f'{v:10.3f} ms'}", file=sys.stderr)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
