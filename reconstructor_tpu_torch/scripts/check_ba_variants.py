"""Compare the dense-Schur LM's precision variants on the saved fountain
problem and the large synthetic one: final cost, iterations, time.

The counterpart of the TPU package's ``scripts/check_ba_variants.py``,
which runs ``lm.solve`` (``max_iters=50``) on ``out/ba_problem_final.npz``
and on ``exp_ba.make_problem(rng(0), 100, 40000, C_pad=112,
L_pad=49152)`` as four rows: float32 and bfloat16 block storage, each
compacted and not. This script runs the same four rows and adds those the
JAX package's ``lm.solve`` docstring compares: the other two Schur
precisions (``'highest'``, ``'default'``; the four rows run the default
``'high'``) and the split storages ``w16`` and ``hcc16``.

Each row prints initial -> final cost, iterations, the median wall of
``--reps`` solves after a first one (host clock ending in a device
synchronise) and ms per iteration; the last line is one JSON object with
every row and, per problem, the relative gap between the ``'high'`` and
``'highest'`` final costs. Runs on the card unless given ``--device cpu``
(where all three Schur precisions are the same float32 product).

    python -m reconstructor_tpu_torch.scripts.check_ba_variants [--problems final,large] \\
        [--reps 5] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from reconstructor_tpu_torch.ba import lm as ba_lm
from reconstructor_tpu_torch.scripts import profile_ba
from reconstructor_tpu_torch.utils import device as devices

MAX_ITERS = 50
ROWS = (
    ("f32 nocompact", dict(compact=False, block_dtype="float32")),
    ("f32 compact", dict(compact=True, block_dtype="float32")),
    ("bf16 compact", dict(compact=True, block_dtype="bfloat16")),
    ("bf16 nocompact", dict(compact=False, block_dtype="bfloat16")),
    ("f32 compact highest", dict(compact=True, block_dtype="float32", schur_precision="highest")),
    ("f32 compact default", dict(compact=True, block_dtype="float32", schur_precision="default")),
    ("w16 compact", dict(compact=True, block_dtype="w16")),
    ("hcc16 compact", dict(compact=True, block_dtype="hcc16")),
)


def run(prob: ba_lm.BAProblem, reps: int, max_iters: int = MAX_ITERS, **kw) -> dict:
    """One row: a first solve, then the median wall of ``reps`` more."""
    dev = prob.cam_params.device

    def solve():
        r = ba_lm.solve(prob, max_iters=max_iters, **kw)
        float(r.cost_final)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return r
    solve()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r = solve()
        walls.append(time.perf_counter() - t0)
    ms = statistics.median(walls) * 1e3
    it = int(r.iterations)
    return {"cost_initial": float(r.cost_initial), "cost_final": float(r.cost_final),
            "iterations": it, "total_ms": ms, "ms_per_iter": ms / max(it, 1),
            "schur_precision": kw.get("schur_precision", "high"), **kw}


def check(prob: ba_lm.BAProblem, name: str, reps: int, max_iters: int = MAX_ITERS) -> dict:
    """Every row on one problem, and the 'high' / 'highest' cost gap."""
    print(f"== {name}", file=sys.stderr, flush=True)
    rows = {}
    for tag, kw in ROWS:
        r = rows[tag] = run(prob, reps, max_iters, **kw)
        print(f"  {tag:22s} cost {r['cost_initial']:12.1f} -> {r['cost_final']:12.4f}  "
              f"iters {r['iterations']:3d}  total {r['total_ms']:8.1f} ms  "
              f"{r['ms_per_iter']:7.2f} ms/iter", file=sys.stderr, flush=True)
    high, highest = rows["f32 compact"]["cost_final"], rows["f32 compact highest"]["cost_final"]
    return {"problem": name, "rows": rows,
            "high_vs_highest_rel": abs(high - highest) / max(abs(highest), 1e-30)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--problems", default="final,large",
                    help="final (out/ba_problem_final.npz) and/or exp_ba sizes")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--max-iters", type=int, default=MAX_ITERS)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = {"device": name, "reps": args.reps, "max_iters": args.max_iters, "problems": []}
    for p in args.problems.split(","):
        out["problems"].append(check(profile_ba.problem(p, dev), p, args.reps, args.max_iters))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
