"""BA solver microbenchmark: the port's LM solvers against the native C++
DENSE_SCHUR baseline.

The counterpart of the TPU package's ``scripts/exp_ba.py``. It times the
dense-Schur LM (``ba.lm.solve``) and the implicit-Schur PCG LM
(``ba.distributed.solve_pcg``) on the device, and the native solver
(``native/ba_schur.cpp`` through ``eval/ba_native.py``: Jet autodiff,
dense Schur, float64, 4 OpenMP threads, the Ceres stand-in), on:

- ``final``: the saved fountain BA problem ``out/ba_problem_final.npz``
  (32 x 16,384 padded, 65,536 observations);
- ``fountain``, ``large``, ``small``: synthetic problems
  (``make_problem``) shaped like an incremental-SfM final solve, at 25 x
  11,000, 100 x 40,000 and 10 x 2,000 cameras x points (and ``tiny``, 6 x
  300, for tests).

For each it prints s/iteration and the time each solver takes to reach
the worse of the two final costs (the device solvers' time per iteration
is the solve's wall over its iterations; the native solver keeps a clock
per iteration). The native library is built from ``native/`` where it is
missing; where it does not load (no compiler or no libjpeg), the script
says so and exits 1 unless ``--solvers`` leaves ``native`` out.

    python -m reconstructor_tpu_torch.scripts.exp_ba [--sizes final,fountain,large] \\
        [--iters 50] [--solvers lm,pcg,native] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from reconstructor_tpu_torch.ba import distributed, lm as ba_lm
from reconstructor_tpu_torch.geometry import camera as cam_mod, se3
from reconstructor_tpu_torch.io import native
from reconstructor_tpu_torch.utils import device as devices

FINAL = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                                     "out", "ba_problem_final.npz"))
SHAPES = {
    "fountain": dict(C=25, L=11000, C_pad=32, L_pad=16384),
    "large": dict(C=100, L=40000, C_pad=112, L_pad=49152),
    "small": dict(C=10, L=2000, C_pad=16, L_pad=2048),
    "tiny": dict(C=6, L=300, C_pad=16, L_pad=512),     # for the CPU tests
}


def make_problem(rng, C, L, obs_per_cam=None, pose_noise=5e-3, pt_noise=2e-2,
                 px_noise=0.5, C_pad=None, L_pad=None, device=None):
    """The TPU script's synthetic BA problem, built in numpy from ``rng``
    and put on ``device`` (the card by default): (problem, live
    observations). Cameras on an arc, landmarks in a box, each landmark
    observed by a contiguous run of cameras (track length ~ geometric);
    observations padded to a multiple of 4096. ``obs_per_cam`` is unused,
    as in the TPU script."""
    intr = np.array([520.0, 520.0, 256.0, 170.0, 0.0, 0.0], np.float32)
    cams_gt = []
    for i in range(C):
        th = 0.8 * i / max(C - 1, 1) - 0.4
        aa = np.array([0.02 * np.sin(3 * th), th, 0.01 * np.cos(5 * th)], np.float32)
        t = np.array([-2.0 * np.sin(th), 0.1 * th, 0.3 * (1 - np.cos(th))], np.float32)
        cams_gt.append(np.concatenate([aa, t, intr]))
    cams_gt = np.stack(cams_gt)

    pts_gt = rng.uniform([-3, -2, 4], [3, 2, 10], (L, 3)).astype(np.float32)
    first = rng.integers(0, C, L)
    tlen = np.minimum(2 + rng.geometric(0.35, L), C - first)
    obs_pt = np.repeat(np.arange(L), tlen).astype(np.int32)
    obs_cam = (np.repeat(first, tlen)
               + np.arange(tlen.sum()) - np.repeat(np.cumsum(tlen) - tlen, tlen)).astype(np.int32)

    R_all = se3.angle_axis_to_rotation(torch.from_numpy(cams_gt[:, :3])).numpy()
    pc = np.einsum("oij,oj->oi", R_all[obs_cam], pts_gt[obs_pt]) + cams_gt[obs_cam, 3:6]
    uv = cam_mod.project(torch.from_numpy(intr), torch.from_numpy(pc)).numpy()
    uv = uv + rng.normal(0, px_noise, uv.shape).astype(np.float32)

    cams0 = cams_gt.copy()
    cams0[2:, :3] += rng.normal(0, pose_noise, (C - 2, 3)).astype(np.float32)
    cams0[2:, 3:6] += rng.normal(0, pose_noise * 5, (C - 2, 3)).astype(np.float32)
    pts0 = pts_gt + rng.normal(0, pt_noise, pts_gt.shape).astype(np.float32)

    C_pad = C_pad or C
    L_pad = L_pad or L
    O = obs_cam.size
    O_pad = -(-O // 4096) * 4096
    cp = np.zeros((C_pad, 12), np.float32)
    cp[:C] = cams0
    pp = np.zeros((L_pad, 3), np.float32)
    pp[:L] = pts0
    oc = np.zeros(O_pad, np.int32)
    oc[:O] = obs_cam
    op = np.zeros(O_pad, np.int32)
    op[:O] = obs_pt
    ouv = np.zeros((O_pad, 2), np.float32)
    ouv[:O] = uv
    om = np.zeros(O_pad, bool)
    om[:O] = True
    free = np.zeros((C_pad, 12), np.float32)
    free[:C] = ba_lm.make_cam_free_mask(C)
    return to_problem(dict(cam_params=cp, points=pp, obs_cam=oc, obs_pt=op, obs_uv=ouv,
                           obs_mask=om, cam_free=free), device), O


def to_problem(arrays: dict, device=None) -> ba_lm.BAProblem:
    """A ``BAProblem`` of ``arrays`` on ``device`` (the card by default)."""
    dev = devices.resolve(device)
    return ba_lm.BAProblem(**{k: torch.as_tensor(np.asarray(v), device=dev)
                              for k, v in arrays.items()})


def load_problem(path: str = FINAL, device=None) -> ba_lm.BAProblem:
    """A BA problem saved as an npz of the ``BAProblem`` fields."""
    z = np.load(path)
    return to_problem({k: z[k] for k in ba_lm.BAProblem._fields}, device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_solver(solve, prob: ba_lm.BAProblem, repeat: int = 3) -> dict:
    """Best wall of ``repeat`` solves after a first one (host clock ending
    in a device synchronise): total_s, iters, s_per_iter, cost0, cost and
    cost_trace (numpy)."""
    dev = prob.cam_params.device
    r = solve(prob)
    _sync(dev)
    best = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        r = solve(prob)
        float(r.cost_final)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    iters = max(int(r.iterations), 1)
    return dict(total_s=best, iters=iters, s_per_iter=best / iters,
                cost0=float(r.cost_initial), cost=float(r.cost_final),
                cost_trace=r.cost_trace.cpu().numpy())


def time_lm(prob, max_iters=50, damping="marquardt", huber=0.0, repeat=3) -> dict:
    return time_solver(lambda p: ba_lm.solve(p, max_iters=max_iters, damping=damping,
                                             huber_delta=huber), prob, repeat)


def time_pcg(prob, max_iters=50, damping="marquardt", huber=0.0, repeat=3) -> dict:
    return time_solver(lambda p: distributed.solve_pcg(p, max_iters=max_iters,
                                                       damping=damping, huber_delta=huber),
                       prob, repeat)


def time_native(prob: ba_lm.BAProblem, max_iters: int = 50) -> dict:
    from reconstructor_tpu_torch.eval import ba_native
    om = prob.obs_mask.cpu().numpy()
    oc = prob.obs_cam.cpu().numpy()[om]
    op = prob.obs_pt.cpu().numpy()[om]
    ouv = prob.obs_uv.cpu().numpy()[om]
    C = int(oc.max()) + 1
    L = int(op.max()) + 1
    r = ba_native.solve_native_ba(
        prob.cam_params.cpu().numpy()[:C], prob.points.cpu().numpy()[:L], oc, op, ouv,
        prob.cam_free.cpu().numpy()[:C], max_iters=max_iters)
    return dict(total_s=r["total_s"], iters=r["iters"], s_per_iter=r["s_per_iter"],
                cost=r["cost_final"], cost_trace=r["cost_trace"], time_trace=r["time_trace"])


def time_to_cost(t: dict, n: dict):
    """Seconds each solver takes to reach the worse of the two final
    costs: the device solver's time per iteration times the iterations to
    get there; the native solver's own clock at its first iteration there
    (its total where no iteration is)."""
    target = max(t["cost"], n["cost"]) * (1.0 + 1e-6)
    ti = int(np.argmax(t["cost_trace"] <= target)) + 1
    dev_s = t["s_per_iter"] * ti
    reached = n["cost_trace"] <= target
    if reached.any():
        native_s = float(n["time_trace"][int(np.argmax(reached))])
    else:
        native_s = float(n["total_s"])
    return dev_s, native_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="final,fountain,large")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--solvers", default="lm,pcg,native")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    solvers = args.solvers.split(",")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})", file=sys.stderr)
    if "native" in solvers and not native.available():
        print("exp_ba: the native library (native/libreconstructor_native.so) does not load "
              "or build here; no baseline to compare (pass --solvers lm,pcg to time the "
              "device solvers alone)", file=sys.stderr)
        return 1
    rng = np.random.default_rng(0)
    timers = {"lm": time_lm, "pcg": time_pcg}
    for size in args.sizes.split(","):
        if size == "final":
            prob = load_problem(device=dev)
            O = int(prob.obs_mask.sum())
            desc = f"C={prob.cam_params.shape[0]} L={prob.points.shape[0]} (padded)"
        else:
            sh = SHAPES[size]
            prob, O = make_problem(rng, sh["C"], sh["L"], None, device=dev,
                                   C_pad=sh["C_pad"], L_pad=sh["L_pad"])
            desc = f"C={sh['C']} L={sh['L']}"
        print(f"[{size}] {desc} O={O}", file=sys.stderr)
        res = {"size": size, "observations": O, "device": name}
        for s in solvers:
            if s == "native":
                res[s] = time_native(prob, max_iters=args.iters)
            else:
                res[s] = timers[s](prob, max_iters=args.iters, repeat=args.repeat)
            r = res[s]
            print(f"  {s:7s}: {r['total_s']:.3f}s / {r['iters']} iters = "
                  f"{r['s_per_iter'] * 1e3:.2f} ms/iter  cost -> {r['cost']:.3f}",
                  file=sys.stderr)
        if "native" in res:
            for s in solvers:
                if s == "native":
                    continue
                dev_s, native_s = time_to_cost(res[s], res["native"])
                res[s]["time_to_equal_cost_s"] = dev_s
                res[s]["native_time_to_equal_cost_s"] = native_s
                print(f"  time-to-equal-cost: {s} {dev_s:.3f}s vs native {native_s:.3f}s = "
                      f"{native_s / max(dev_s, 1e-9):.2f}x", file=sys.stderr)
        print(json.dumps({k: ({kk: vv for kk, vv in v.items()
                               if kk not in ("cost_trace", "time_trace")}
                              if isinstance(v, dict) else v) for k, v in res.items()}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
