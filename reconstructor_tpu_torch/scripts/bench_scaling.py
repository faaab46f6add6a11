"""Sharded matching and distributed BA, timed at several world sizes.

The counterpart of the TPU package's ``scripts/bench_scaling.py``, which
times the same three loads on a virtual CPU mesh of 1, 2, 4 and 8
devices. Here each world size in ``--ranks`` is a world of
``torch.distributed`` processes started as ``run_multiproc_dryrun``
starts them (a ``FileStore`` in a fresh directory, ``LOCAL_RANK``), and
every rank runs:

- raw kNN: ``parallel.sharding.match_all_pairs_sharded`` over all pairs of
  ``n_images`` images of ``keypoints`` random unit descriptors (D = 128;
  the kNN kernel in float32 on a card, the plain matcher on the CPU);
  pairs/s;
- gated kNN: ``match_and_gate_sharded`` on the same descriptors at
  random coordinates (ratio 0.7, cross-check, 128 F-gate hypotheses,
  3 px, 7 matches; draws from a generator seeded with 0 on every call);
  pairs/s;
- distributed BA: ``ba.distributed.solve_distributed`` (``max_iters=10,
  cg_iters=32``) on ``tests/test_ba.py``'s problem at 25 cameras x 5,000
  points (``make_ba_problem``, seed 1; 125,000 observations); seconds.

Each reading is warm: a first call, then ``--reps`` calls, each started
after a barrier and ended by a device synchronise; the median of rank 0's
host-clock times. Each is also given as retained throughput against the
1-rank world (N-rank pairs/s over 1-rank pairs/s; BA 1-rank seconds over
N-rank seconds) and as efficiency (retained / N).

Modes: ``--device cpu`` (gloo ranks on the host, the counterpart of the
JAX virtual mesh), ``--device cuda:0`` (gloo ranks sharing one card) and
``--device cuda`` (the default: one NCCL rank per card, ``cuda:LOCAL_RANK``).
Prints one JSON object; ``ok`` holds, and the exit code is 0, only when
every world ran, its ranks ended with one match table, one gated table and
one BA cost, iteration count and cost trace, and every world's tables
equal the first world's. Writes no
file.

    python -m reconstructor_tpu_torch.scripts.bench_scaling [32 [512]] [--ranks 1,2,4] \\
        [--device cuda|cuda:0|cpu] [--reps 3] [--ba-cams 25] [--ba-points 5000]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import time

import numpy as np
import torch

from reconstructor_tpu_torch.geometry import np_ops
from reconstructor_tpu_torch.scripts import run_multiproc_dryrun

WORKER = "reconstructor_tpu_torch.scripts.bench_scaling"
PARTS = ("knn", "gated", "ba")
GATE_KW = dict(ratio_thresh=0.7, cross_check=True, num_hypotheses=128, thresh_px=3.0,
               min_matches=7)


def make_ba_problem(rng, n_cams=5, n_pts=200, pose_noise=0.02, pt_noise=0.05, px_noise=0.0):
    """``tests/test_ba.py``'s problem, in numpy with the same draws: points
    in a box seen by every camera of a sweeping rig, and perturbed initial
    estimates (camera 0 exact, camera 1's translation exact). Returns the
    problem's fields as numpy arrays (``BAProblem`` order)."""
    from reconstructor_tpu_torch.ba import lm as ba_lm
    pts_gt = rng.uniform([-2, -2, 5], [2, 2, 9], (n_pts, 3)).astype(np.float32)
    intr = np.array([600.0, 600.0, 320.0, 240.0, 0.0, 0.0], np.float32)
    i = np.arange(n_cams, dtype=np.float64)[:, None]
    aa = np.concatenate([0.05 * i, 0.25 * i - 0.5, 0.02 * i], axis=1).astype(np.float32)
    t = np.concatenate([1.2 * i - 2.4, 0.1 * i, 0.05 * i], axis=1).astype(np.float32)
    cams_gt = np.concatenate([aa, t, np.tile(intr, (n_cams, 1))], axis=1)
    R = np_ops.angle_axis_to_rotation(aa)
    uv = np.stack([np_ops.project(intr, pts_gt @ R[c].T + t[c]) for c in range(n_cams)])
    if px_noise:
        uv = np.stack([u + rng.normal(0, px_noise, u.shape).astype(np.float32) for u in uv])
    cams = cams_gt.copy()
    cams[2:, :3] += rng.normal(0, pose_noise, (n_cams - 2, 3)).astype(np.float32)
    cams[2:, 3:6] += rng.normal(0, pose_noise * 5, (n_cams - 2, 3)).astype(np.float32)
    cams[1, :3] += rng.normal(0, pose_noise, 3).astype(np.float32)
    pts = pts_gt + rng.normal(0, pt_noise, pts_gt.shape).astype(np.float32)
    n_obs = n_cams * n_pts
    return (cams.astype(np.float32), pts.astype(np.float32),
            np.repeat(np.arange(n_cams, dtype=np.int32), n_pts),
            np.tile(np.arange(n_pts, dtype=np.int32), n_cams),
            uv.reshape(n_obs, 2).astype(np.float32), np.ones(n_obs, bool),
            ba_lm.make_cam_free_mask(n_cams))


def matching_inputs(n_images: int, keypoints: int):
    """The JAX script's matching inputs from ``default_rng(0)``: unit
    descriptors (N, K, 128), all-valid masks, coordinates in [0, 512)
    and all pairs."""
    from reconstructor_tpu_torch.matching import pairs as pairing
    rng = np.random.default_rng(0)
    desc = rng.standard_normal((n_images, keypoints, 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    mask = np.ones((n_images, keypoints), bool)
    xy = rng.uniform(0, 512, (n_images, keypoints, 2)).astype(np.float32)
    return desc, mask, xy, pairing.exhaustive_pairs(n_images)


def sha256(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(np.ascontiguousarray(t.cpu().numpy()).tobytes())
    return h.hexdigest()


# ----------------------------------------------------------------------
# one rank
# ----------------------------------------------------------------------

def timed(mesh, fn, reps: int):
    """A first call, then ``reps`` calls after a barrier each, ended by a
    device synchronise: (last output, seconds of each timed call)."""
    import torch.distributed as dist

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
    out = fn()
    sync()
    times = []
    for _ in range(reps):
        dist.barrier()
        t = time.perf_counter()
        out = fn()
        sync()
        times.append(time.perf_counter() - t)
    return out, times


def worker(argv=None) -> int:
    """One rank: join the group, run the asked parts, write the report."""
    from reconstructor_tpu_torch.ba import distributed, lm as ba_lm
    from reconstructor_tpu_torch.parallel import sharding
    from reconstructor_tpu_torch.utils import cuda_build
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", required=True)
    ap.add_argument("--timeout", type=float, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--images", type=int, required=True)
    ap.add_argument("--keypoints", type=int, required=True)
    ap.add_argument("--ba-cams", type=int, required=True)
    ap.add_argument("--ba-points", type=int, required=True)
    ap.add_argument("--reps", type=int, required=True)
    ap.add_argument("--parts", required=True)
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    mesh = sharding.initialize_multihost(args.init_method, args.world_size, args.rank,
                                         backend=args.backend, device=args.device,
                                         timeout_s=args.timeout)
    dev = mesh.device
    rep = {"rank": mesh.rank, "n_processes": mesh.size, "backend": mesh.backend,
           "device": str(dev)}
    parts = args.parts.split(",")
    cuda_build.reset_launches()
    if "knn" in parts or "gated" in parts:
        desc, mask, xy, pair_idx = matching_inputs(args.images, args.keypoints)
        rep["pairs"] = int(pair_idx.shape[0])
    if "knn" in parts:
        (mi, mm), t = timed(mesh, lambda: sharding.match_all_pairs_sharded(
            mesh, desc, mask, pair_idx), args.reps)
        rep.update(knn_s=t, knn_sha256=sha256(mi, mm), knn_matches=int(mm.sum()))
    if "gated" in parts:
        def gated():
            gen = torch.Generator(device=dev).manual_seed(0)
            return sharding.match_and_gate_sharded(
                mesh, desc, mask, xy, pair_idx, generator=gen, **GATE_KW)
        (mi, cnt), t = timed(mesh, gated, args.reps)
        rep.update(gated_s=t, gated_sha256=sha256(mi, cnt), gated_inliers=int(cnt.sum()))
    rep["knn_kernel_launches"] = cuda_build.launches()["knn_top2_launch"]
    if "ba" in parts:
        arrays = make_ba_problem(np.random.default_rng(1), args.ba_cams, args.ba_points)
        prob = ba_lm.BAProblem(*(torch.from_numpy(a) for a in arrays))
        res, t = timed(mesh, lambda: distributed.solve_distributed(
            mesh, prob, max_iters=10, cg_iters=32), args.reps)
        rep.update(ba_s=t, ba_obs=int(prob.obs_uv.shape[0]),
                   ba_cost_initial=float(res.cost_initial), ba_cost_final=float(res.cost_final),
                   ba_iterations=int(res.iterations),
                   ba_cost_trace=[float(c) for c in res.cost_trace])
    dist.destroy_process_group()
    with open(args.out, "w") as fh:
        json.dump(rep, fh)
    return 0


# ----------------------------------------------------------------------
# the worlds
# ----------------------------------------------------------------------

def backend_for(device: str) -> str:
    """NCCL for ``cuda`` (a card per rank), gloo for the host or a shared
    ``cuda:i``, as ``run_multiproc_dryrun`` chooses."""
    return "nccl" if device == "cuda" else "gloo"


def run_world(n: int, device: str, parts=PARTS, n_images: int = 32, keypoints: int = 512,
              ba_cams: int = 25, ba_points: int = 5000, reps: int = 3,
              timeout: float = 600.0) -> dict:
    """Start a world of ``n`` ranks and return {"ok", "wall_s", "workers":
    the ranks' reports}."""
    args = ["--worker", "--images", str(n_images), "--keypoints", str(keypoints),
            "--ba-cams", str(ba_cams), "--ba-points", str(ba_points), "--reps", str(reps),
            "--parts", ",".join(parts)]
    reports, rcs, wall = run_multiproc_dryrun.launch(n, WORKER, backend_for(device), device,
                                                     timeout, args)
    return {"ok": len(reports) == n and all(rc == 0 for rc in rcs), "wall_s": wall,
            "workers": reports}


def summarise(worlds: dict) -> dict:
    """Rank 0's medians per world, retained throughput and efficiency
    against the smallest world, and the consistency checks."""
    out, problems = {}, []
    ns = sorted(worlds)
    base = worlds[ns[0]]["workers"][0] if worlds[ns[0]]["ok"] else None
    for n in ns:
        w = worlds[n]
        if not w["ok"]:
            problems.append(f"{n} ranks: a rank failed")
            continue
        r0 = w["workers"][0]
        for key, what in (("knn_sha256", "match table"), ("gated_sha256", "gated table"),
                          ("ba_cost_final", "final BA cost"), ("ba_iterations", "BA iteration"),
                          ("ba_cost_trace", "BA cost trace")):
            if key not in r0:
                continue
            if any(r[key] != r0[key] for r in w["workers"]):
                problems.append(f"{n} ranks: the ranks end with different {what}s")
            if base is not None and r0[key] != base[key] and not key.startswith("ba_"):
                problems.append(f"{n} ranks: {what} differs from the {ns[0]}-rank world's")
        for kind in ("knn", "gated"):
            if f"{kind}_s" in r0:
                out[f"{kind}_pairs_per_s_{n}dev"] = (r0["pairs"]
                                                     / statistics.median(r0[f"{kind}_s"]))
        if "ba_s" in r0:
            out[f"ba_solve_s_{n}dev"] = statistics.median(r0["ba_s"])
            out[f"ba_cost_final_{n}dev"] = r0["ba_cost_final"]
            out[f"ba_iterations_{n}dev"] = r0["ba_iterations"]
    for n in ns:
        for kind in ("knn", "gated"):
            k, k1 = f"{kind}_pairs_per_s_{n}dev", f"{kind}_pairs_per_s_{ns[0]}dev"
            if k in out and k1 in out:
                out[f"{kind}_retained_{n}dev"] = out[k] / out[k1]
                out[f"{kind}_efficiency_{n}dev"] = out[k] / out[k1] / (n / ns[0])
        k, k1 = f"ba_solve_s_{n}dev", f"ba_solve_s_{ns[0]}dev"
        if k in out and k1 in out:
            out[f"ba_retained_{n}dev"] = out[k1] / out[k]
            out[f"ba_efficiency_{n}dev"] = out[k1] / out[k] / (n / ns[0])
    return {"ok": not problems, "problems": problems, **out}


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if "--worker" in argv:
        return worker(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("num_images", nargs="?", type=int, default=32)
    ap.add_argument("keypoints", nargs="?", type=int, default=512)
    ap.add_argument("--ranks", default="1,2,4", help="world sizes, comma-separated")
    ap.add_argument("--device", default="cuda",
                    help="cuda (a card per rank, nccl), cuda:i (one shared card, gloo) or cpu")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ba-cams", type=int, default=25)
    ap.add_argument("--ba-points", type=int, default=5000)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a world may take, and a collective may wait")
    args = ap.parse_args(argv)
    ranks = sorted(int(r) for r in args.ranks.split(","))
    worlds = {}
    for n in ranks:
        worlds[n] = run_world(n, args.device, PARTS, args.num_images, args.keypoints,
                              args.ba_cams, args.ba_points, args.reps, args.timeout)
        print(f"{n} rank(s): ok={worlds[n]['ok']} wall {worlds[n]['wall_s']:.1f}s",
              file=sys.stderr, flush=True)
    w0 = next((w["workers"][0] for w in worlds.values() if w["ok"]), {})
    card = (torch.cuda.get_device_name(0)
            if args.device.startswith("cuda") and torch.cuda.is_available() else None)
    res = {"num_images": args.num_images, "keypoints": args.keypoints,
           "pairs": w0.get("pairs"), "ba_cams": args.ba_cams, "ba_points": args.ba_points,
           "ba_obs": w0.get("ba_obs"), "device": args.device,
           "backend": backend_for(args.device), "card": card,
           "reps": args.reps, "ranks": ranks, **summarise(worlds),
           "workers": {n: w["workers"] for n, w in worlds.items()}}
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
