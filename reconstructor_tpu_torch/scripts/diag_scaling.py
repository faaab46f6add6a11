"""Split the distributed BA's time at several world sizes into a shardable
and a replicated part.

The counterpart of the TPU package's ``scripts/diag_scaling.py``. It times
``ba.distributed.solve_distributed`` (``max_iters=10, cg_iters=32``) on
``bench_scaling``'s problem (``tests/test_ba.py``'s scene at 25 cameras x
5,000 points) in a world of each size in ``--ranks`` (best of ``--reps``
warm solves, rank 0's host clock ending in a synchronise), fits the
two-term model of ranks that share one device

    t_N = S + N * R      (S: the work the ranks divide, R: a rank's copy
                          of the replicated work)

to the smallest and the largest world, and checks the fit at the sizes
between them (``pred``, ``rel_err``). It then times the replicated pieces
alone on one device of the worlds' kind, 10 LM iterations' worth: the
H_pp inverse as (9, L) planes (``distributed._inv3x3``), the (C, 12, 12)
block-Jacobi inverse (``torch.linalg.inv``, as ``_lm_step_pcg``) and
the CG vector arithmetic on (C * 12) vectors (32 iterations of two dots,
three updates and a norm). Prints one JSON object and writes no file;
the exit code is 0 only when every world ran and its ranks agreed on the
BA's cost, iteration count and cost trace.

    python -m reconstructor_tpu_torch.scripts.diag_scaling [--ranks 1,2,4] \\
        [--device cuda|cuda:0|cpu] [--reps 3]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from reconstructor_tpu_torch.scripts import bench_scaling
from reconstructor_tpu_torch.utils import device as devices

LM_ITERS = 10
CG_ITERS = 32


def fit(t: dict) -> dict:
    """The two-term fit t_N = S + N R through the smallest and largest
    world of ``t`` ({ranks: seconds}); its prediction and relative error
    at every world."""
    lo, hi = min(t), max(t)
    R = (t[hi] - t[lo]) / (hi - lo) if hi > lo else 0.0
    S = t[lo] - lo * R
    pred = {n: S + n * R for n in sorted(t)}
    return {"S": S, "R": R, "pred": pred,
            "rel_err": {n: (t[n] - pred[n]) / t[n] for n in sorted(t)}}


def replicated_pieces(C: int, L: int, device, iters: int = LM_ITERS, reps: int = 3) -> dict:
    """Seconds for ``iters`` LM iterations' worth of each replicated piece
    on one device (best of ``reps``), and their sum."""
    from reconstructor_tpu_torch.ba import distributed
    dev = devices.resolve(device)
    g = torch.Generator(device=dev).manual_seed(0)
    Hpp = torch.randn((L, 3, 3), generator=g, device=dev) * 0.1 + 3.0 * torch.eye(3, device=dev)
    Hcc = (torch.randn((C, 12, 12), generator=g, device=dev) * 0.1
           + 3.0 * torch.eye(12, device=dev))
    v = torch.randn(C * 12, generator=g, device=dev)

    def cg_vectors():
        x, r, p = torch.zeros_like(v), v.clone(), v.clone()
        rz = torch.dot(r, r)
        for _ in range(CG_ITERS):
            alpha = rz / torch.clamp(torch.dot(p, r), min=1e-20)
            x = x + alpha * p
            r = r - alpha * p
            rz_new = torch.dot(r, r)
            p = r + (rz_new / torch.clamp(rz, min=1e-20)) * p
            rz = rz_new
            torch.linalg.norm(r)
        return x

    pieces = {"hpp_inverse": lambda: distributed._inv3x3(Hpp),
              "block_jacobi": lambda: torch.linalg.inv(Hcc),
              "cg_vectors": cg_vectors}
    out = {}
    for name, fn in pieces.items():
        fn()
        best = float("inf")
        for _ in range(reps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        out[name] = best
    out["total"] = sum(out.values())
    return out


def diagnose(t: dict, device: str, ba_cams: int, ba_points: int) -> dict:
    """The fit of ``t`` ({ranks: seconds of a solve}) and the replicated
    pieces timed alone on one device of the worlds' kind."""
    res = fit(t)
    one_device = "cpu" if device == "cpu" else (device if ":" in device else "cuda:0")
    rep = replicated_pieces(ba_cams, ba_points, one_device)
    res.update(replicated_s_10it=rep, R_direct_10it=rep["total"],
               R_direct_share_of_1rank=rep["total"] / t[min(t)])
    if one_device != "cpu":
        res["card"] = torch.cuda.get_device_name(torch.device(one_device))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", default="1,2,4", help="world sizes, comma-separated")
    ap.add_argument("--device", default="cuda",
                    help="cuda (a card per rank, nccl), cuda:i (one shared card, gloo) or cpu")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ba-cams", type=int, default=25)
    ap.add_argument("--ba-points", type=int, default=5000)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    ranks = sorted(int(r) for r in args.ranks.split(","))
    t, costs, problems = {}, {}, []
    for n in ranks:
        w = bench_scaling.run_world(n, args.device, ("ba",), ba_cams=args.ba_cams,
                                    ba_points=args.ba_points, reps=args.reps,
                                    timeout=args.timeout)
        if not w["ok"]:
            problems.append(f"{n} ranks: a rank failed")
            continue
        costs[n] = [r["ba_cost_final"] for r in w["workers"]]
        problems += bench_scaling.summarise({n: w})["problems"]
        t[n] = min(w["workers"][0]["ba_s"])
        print(f"{n} rank(s): {t[n]:.3f}s", file=sys.stderr, flush=True)
    res = {"device": args.device, "ranks": ranks, "t": t, "ba_cost_final": costs,
           "ba_cams": args.ba_cams, "ba_points": args.ba_points,
           "ok": not problems and len(t) == len(ranks), "problems": problems}
    if t:
        res.update(diagnose(t, args.device, args.ba_cams, args.ba_points))
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
