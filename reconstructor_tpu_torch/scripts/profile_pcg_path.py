"""Profile the PCG bundle adjustment where it runs: its pieces, one CG
iteration, the street problem and the PCG-routed reconstruction; one run
per tree, so that two commits compare on one card.

- ``path``: the 25-view rendered scene that ``chip_smoke.py`` runs
  (``profile_incremental.smoke_scene``) through the default path with
  ``ba_solver="pcg"``, as users run it: stage seconds, BA calls, the PCG
  kernels' launches and the end state's hash; with ``--mesh`` the same
  again with ``mesh=`` at a world of one (NCCL on the card, gloo on the
  CPU), which must end in the same state.
- ``street``: the street problem (``street_problem``: 100 cameras x
  100,000 facade points, ~5e5 observations, built on the device from a
  seed; ``chip_smoke.py``'s pcg and mesh phases solve it) through
  ``solve_pcg`` with the driver's settings, ``--street-reps`` times (host
  seconds ending in a synchronise).
- ``pieces``: on each of ``--problems`` (``profile_ba.problem``),
  ``profile_ba.profile``'s PCG rows (``pcg_per_iter``,
  ``pcg_schur_matvec``, ...), then one Schur matvec and one CG iteration
  traced (``utils/profiling``): launches, host ms and device ms a call
  ("not measured" off the card); and the host microseconds of one call of
  each PCG kernel's wrapper (back-to-back calls on the host clock, the
  card behind them; "not measured" off the card, where the wrappers run
  their plain versions). The matvec, the right-hand side and the
  preconditioner are taken from inside ``ba.distributed._lm_step_pcg``
  (its ``_pcg`` wrapped for one call), so the script measures whatever
  matvec the tree it runs in has.

On the card the tree's kernels are built first, so that no build lands
in a timed stage. One JSON object on stdout. To compare two commits on one card, unpack the
parent with ``git archive`` into a directory that ``.gitignore`` lists,
copy this file into its ``reconstructor_tpu_torch/scripts/``, and run
parent, change, change, parent in one call; launch counters are read from
``utils.cuda_build``, so the parent must count launches there.

    python -m reconstructor_tpu_torch.scripts.profile_pcg_path [--mesh] \\
        [--parts path,street,pieces] [--device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from reconstructor_tpu_torch.ba import cuda_schur, cuda_segsum, distributed, lm as ba_lm
from reconstructor_tpu_torch.geometry import se3
from reconstructor_tpu_torch.utils import cuda_build, device as devices
from reconstructor_tpu_torch.utils import profiling

CG_ITERS = 16      # CG iterations in the traced call (divided out)


def street_problem(dev, seed: int = 0, n_cams: int = 100, n_pts: int = 100_000,
                   views: int = 5, px_noise: float = 0.5, pose_noise: float = 0.02,
                   pt_noise: float = 0.05):
    """A street-scale BA problem, built on ``dev`` from ``seed`` with the
    noise model of ``tests/test_ba.py::make_ba_problem``: ``n_cams``
    cameras 0.5 apart along a track, looking sideways at a facade 8-20 m
    away; each point observed by the ``views`` cameras nearest it that have
    it in front and in the 640x480 frame, with ``px_noise`` pixels of noise;
    camera 0 fixed, camera 1's translation fixed. Padded as the driver pads
    (cameras to 16, points and observations to powers of two). Returns
    (problem, host (obs_pt, obs_cam, obs_mask), live observations)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def normal(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    i = torch.arange(n_cams, device=dev, dtype=torch.float32)
    centres = torch.stack([0.5 * i, torch.zeros_like(i), torch.zeros_like(i)], 1)
    aa = torch.stack([0.01 * torch.cos(i / 5), 0.05 * torch.sin(i / 7),
                      torch.zeros_like(i)], 1)
    R = se3.angle_axis_to_rotation(aa)
    t = -torch.einsum("cij,cj->ci", R, centres)
    intr = torch.tensor([600.0, 600.0, 320.0, 240.0, 0.0, 0.0], device=dev)
    cams = torch.cat([aa, t, intr.expand(n_cams, 6)], 1)
    lo = torch.tensor([0.0, -3.0, 8.0], device=dev)
    hi = torch.tensor([0.5 * (n_cams - 1), 3.0, 20.0], device=dev)
    pts = lo + (hi - lo) * torch.rand(n_pts, 3, generator=g, device=dev)

    pc = torch.einsum("cij,lj->cli", R, pts) + t[:, None]
    u = 600.0 * pc[..., 0] / pc[..., 2] + 320.0
    v = 600.0 * pc[..., 1] / pc[..., 2] + 240.0
    seen = (pc[..., 2] > 0.1) & (u >= 0) & (u < 640) & (v >= 0) & (v < 480)
    dist = torch.where(seen, (pts[None, :, 0] - centres[:, None, 0]).abs(), float("inf"))
    d, cam_ids = torch.topk(dist, views, dim=0, largest=False)          # (views, L)
    ok = torch.isfinite(d)
    obs_cam = cam_ids[ok]
    obs_pt = torch.arange(n_pts, device=dev).expand(views, n_pts)[ok]
    O = int(obs_cam.numel())
    uv = ba_lm._resid(cams[obs_cam], pts[obs_pt], torch.zeros(O, 2, device=dev))
    uv = uv + normal(O, 2, std=px_noise)

    init = cams.clone()
    init[2:, :3] += normal(n_cams - 2, 3, std=pose_noise)
    init[2:, 3:6] += normal(n_cams - 2, 3, std=pose_noise * 5)
    init[1, :3] += normal(3, std=pose_noise)
    pts_init = pts + normal(n_pts, 3, std=pt_noise)

    C_pad = max(16, -(-n_cams // 16) * 16)
    L_pad = ba_lm._bucket(n_pts, 1)
    O_pad = ba_lm._bucket(O, 1)

    def pad(x, n):
        out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)
        out[:x.shape[0]] = x
        return out
    free = torch.as_tensor(ba_lm.make_cam_free_mask(n_cams), device=dev)
    mask = torch.zeros(O_pad, dtype=torch.bool, device=dev)
    mask[:O] = True
    prob = ba_lm.BAProblem(
        cam_params=pad(init, C_pad), points=pad(pts_init, L_pad),
        obs_cam=pad(obs_cam.to(torch.int32), O_pad), obs_pt=pad(obs_pt.to(torch.int32), O_pad),
        obs_uv=pad(uv, O_pad), obs_mask=mask, cam_free=pad(free, C_pad))
    host = tuple(np.ascontiguousarray(x.cpu().numpy())
                 for x in (prob.obs_pt, prob.obs_cam, prob.obs_mask))
    return prob, host, O


def street_ba_kwargs(cfg) -> dict:
    """The driver's settings for a global BA of 10 or more cameras."""
    return dict(max_iters=cfg.ba_max_iters_large, init_lambda=cfg.ba_init_lambda,
                lambda_up=cfg.ba_lambda_up, lambda_down=cfg.ba_lambda_down,
                ftol=cfg.ba_ftol, focal_upper_bound=cfg.ba_focal_upper_bound,
                huber_delta=cfg.ba_huber_delta, damping=cfg.ba_damping)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_kernels() -> None:
    """Every kernel source of the package, one nvcc each, side by side."""
    pkg = Path(cuda_build.__file__).resolve().parents[1]
    srcs = [str(p.relative_to(pkg)) for p in sorted(pkg.glob("**/csrc/*.cu"))]
    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
        list(pool.map(cuda_build.load, srcs))


def state_sha256(state) -> str:
    """One hash of every field of a state (its checkpoint arrays, by name)."""
    from reconstructor_tpu_torch.pipeline import checkpoint
    h = hashlib.sha256()
    for k, v in sorted(checkpoint.arrays_of(state).items()):
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def run_path(dev: torch.device, imgs, mesh=None) -> dict:
    """The default path with ``ba_solver="pcg"`` on ``imgs`` (over
    ``mesh`` when given), with the PCG kernels' launch counters set to 0
    just before."""
    from reconstructor_tpu_torch.config import ReconstructorConfig
    from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
    rec = IncrementalReconstructor(ReconstructorConfig(ba_solver="pcg"), verbose=False,
                                   device=dev, mesh=mesh)
    cuda_build.reset_launches()
    with tempfile.TemporaryDirectory() as out:
        t = time.perf_counter()
        state = rec.reconstruct_from_state(rec.detect_features_from_images(imgs),
                                           out_folder=out)
        _sync(dev)
        wall = time.perf_counter() - t
    n = cuda_build.launches()
    return {"wall_s": wall, "registered": len(state.registered),
            "landmarks": int(state.num_landmarks), "ba_calls": dict(rec.ba_calls),
            "stages_s": {k: v / 1e3 for k, v in rec.timer.totals().items()},
            "launches": {"cuda_segsum": n["seg_sum_launch"],
                         "cuda_schur": n["ytu_sum_launch"] + n["yz_sum_launch"]},
            "state_sha256": state_sha256(state)}


def part_path(dev: torch.device, views: int, h: int, w: int, mesh: bool) -> dict:
    from reconstructor_tpu_torch.scripts import profile_incremental
    _, imgs = profile_incremental.smoke_scene(views, h, w)
    out = {"pcg": run_path(dev, imgs)}
    if mesh:
        import torch.distributed as dist
        from reconstructor_tpu_torch.parallel import sharding
        with tempfile.TemporaryDirectory() as d:
            m = sharding.initialize_multihost(
                f"file://{d}/store", 1, 0, backend="nccl" if dev.type == "cuda" else "gloo",
                device=dev, timeout_s=300)
            try:
                out["mesh"] = run_path(dev, imgs, mesh=m)
            finally:
                dist.destroy_process_group()
    return out


def part_street(dev: torch.device, reps: int, n_cams: int, n_pts: int) -> dict:
    from reconstructor_tpu_torch.config import ReconstructorConfig
    prob, _, O = street_problem(dev, n_cams=n_cams, n_pts=n_pts)
    kw = street_ba_kwargs(ReconstructorConfig())
    walls = []
    for _ in range(reps):
        _sync(dev)
        t = time.perf_counter()
        res = distributed.solve_pcg(prob, **kw)
        _sync(dev)
        walls.append(time.perf_counter() - t)
    return {"observations": O, "wall_s": walls, "iterations": int(res.iterations),
            "cost_final": float(res.cost_final),
            "rms_px": float(np.sqrt(float(res.cost_final) / O))}


def cg_operators(prob: ba_lm.BAProblem):
    """(matvec, rhs, preconditioner) of one damped PCG solve on ``prob``,
    as ``_lm_step_pcg`` builds them."""
    long = prob._replace(obs_cam=prob.obs_cam.long(), obs_pt=prob.obs_pt.long())
    lay = distributed._layouts(long)
    blocks = distributed._build_pcg_blocks(long, lay, long.cam_params, long.points)
    got = {}
    real = distributed._pcg

    def keep(matvec, rhs, precond, num_iters, tol):
        got.update(matvec=matvec, rhs=rhs, precond=precond)
        return real(matvec, rhs, precond, num_iters, tol)
    distributed._pcg = keep
    try:
        distributed._lm_step_pcg(long, lay, blocks, np.float32(1e-3), CG_ITERS, 0.0,
                                 "marquardt")
    finally:
        distributed._pcg = real
    return got["matvec"], got["rhs"], got["precond"]


def traced(fn, dev: torch.device, iters: int, per: int = 1) -> dict:
    """``iters`` calls of ``fn`` (after a warm one) in a torch.profiler
    trace, each synchronised in its own window: launches, host ms and
    device ms (launched inside the windows) a call, over ``per``."""
    fn()
    _sync(dev)
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d, device=dev):
            for _ in range(iters):
                with profiling.annotate("call"):
                    fn()
                    _sync(dev)
        st = profiling.stage_summary(f"{d}/{profiling.TRACE_FILE}", ["call"])["call"]
    n = iters * per
    busy = st["launched_busy_s"]
    return {"launches": st["launches"] / n, "host_ms": st["wall_s"] * 1e3 / n,
            "device_ms": "not measured" if dev.type != "cuda" or busy is None
            else busy * 1e3 / n}


def host_us(fn, dev: torch.device, n: int = 2000):
    """Host microseconds of one call of ``fn``, over ``n`` back-to-back
    calls (the card runs behind them)."""
    if dev.type != "cuda":
        return "not measured"
    for _ in range(50):
        fn()
    _sync(dev)
    t = time.perf_counter()
    for _ in range(n):
        fn()
    el = time.perf_counter() - t
    _sync(dev)
    return el / n * 1e6


def wrapper_host_us(prob: ba_lm.BAProblem) -> dict:
    """Each PCG kernel wrapper's host microseconds a call on ``prob``'s
    layouts: kernel 5 into points at W = 3, kernel 6 W^T u."""
    dev = prob.cam_params.device
    long = prob._replace(obs_cam=prob.obs_cam.long(), obs_pt=prob.obs_pt.long())
    lay = distributed._layouts(long)
    O = prob.obs_cam.shape[0]
    v = torch.zeros(O, 3, device=dev)
    Y = torch.zeros(O, 12, 3, device=dev)
    u = torch.zeros(prob.cam_params.shape[0], 12, device=dev)
    return {"seg_sum": host_us(lambda: cuda_segsum.seg_sum(v, lay.pt), dev),
            "ytu_sum": host_us(lambda: cuda_schur.ytu_sum(Y, u, lay), dev)}


def part_pieces(dev: torch.device, problems, reps: int) -> dict:
    from reconstructor_tpu_torch.scripts import profile_ba
    out = {}
    for name in problems:
        prob = profile_ba.problem(name, dev)
        res = profile_ba.profile(prob, name, reps)
        matvec, rhs, precond = cg_operators(prob)
        out[name] = {"ms": {k: v for k, v in res["ms"].items() if k.startswith("pcg")},
                     "busy": res["busy"].get("pcg_solve_20"),
                     "matvec": traced(lambda: matvec(rhs), dev, reps),
                     "cg_iteration": traced(
                         lambda: distributed._pcg(matvec, rhs, precond, CG_ITERS, 0.0), dev,
                         max(1, reps // 4), per=CG_ITERS),
                     "wrapper_host_us": wrapper_host_us(prob)}
        del prob, matvec, rhs, precond
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default="path,street,pieces")
    ap.add_argument("--mesh", action="store_true", help="the path again at a world of one")
    ap.add_argument("--views", type=int, default=25)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--street-reps", type=int, default=3)
    ap.add_argument("--street-cams", type=int, default=100)
    ap.add_argument("--street-points", type=int, default=100_000)
    ap.add_argument("--problems", default="final,large")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    if dev.type == "cuda":
        if dev.index is None:           # the mesh names its card by index
            dev = torch.device("cuda", torch.cuda.current_device())
        build_kernels()
    parts = args.parts.split(",")
    res = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)}
    if "path" in parts:
        res["path"] = part_path(dev, args.views, args.height, args.width, args.mesh)
    if "street" in parts:
        res["street"] = part_street(dev, args.street_reps, args.street_cams, args.street_points)
    if "pieces" in parts:
        res["pieces"] = part_pieces(dev, args.problems.split(","), args.reps)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
