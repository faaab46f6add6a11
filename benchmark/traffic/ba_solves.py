"""Traffic kind ``ba_solves``: one bundle-adjustment problem solved again and
again from the same start, back to back, by one caller.

Inputs (``make_problem``): a city-district problem with exactly
``cameras`` cameras, ``points`` points and ``observations`` observations,
made on the device from a seed (the street problem of the PCG profiling
script, spread over a district and grown to a published problem's counts).
Cameras stand about ``camera_spacing_m`` apart over a square, each facing
its own heading; each point lies in the view of a camera drawn for it, at
``depth_m``; its observers are the cameras nearest it (of the
``candidates`` nearest) that have it in front and in the frame. Track lengths
are 2 plus a geometric draw with the problem's mean, capped by how many
cameras see the point, then moved up or down by one at points drawn from
the seed until the observations total exactly. Observed pixels get
``px_noise`` of Gaussian noise; the start turns cameras 1.. about their own
centres (angle-axis by ``pose_noise``), moves the centres of cameras 2.. by
5x that, and points by ``point_noise``. Padded as the driver pads a global BA (cameras
to a multiple of 16, points and observations to powers of two), with its
free-parameter policy (camera 0 fixed, camera 1's translation fixed,
principal points fixed, intrinsics fixed below ``intrinsics_free_min_cams``).

The problem is made from the traffic's ``problem_seed``, not from the run's
seed: every run solves the same problem in the same order. (Problems drawn
from the run's seed, and the same problem with its points or observations
in another order, converge in different numbers of LM iterations, since
the float32 sums round otherwise: the seed would change the work.)

A step is one solve by the solver that the driver's routing rule
(``uses_pcg``) picks for the padded sizes, called as the driver calls it
for a global BA, ending in the host copies of the cameras and points.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import os
from pathlib import Path

import numpy as np
import torch

from benchmark import roofline
from benchmark.reference import ba as ref_ba
from benchmark.reference import precision as ref_precision
from benchmark.trace import annotated, patched

# the reference's solves, kept in the checkout (listed in .gitignore)
REFERENCE_CACHE = Path(__file__).resolve().parents[2] / "build" / "bench_reference"


def _pow2_bucket(n: int) -> int:
    return 256 if n <= 256 else 1 << (n - 1).bit_length()


def make_problem(scene: dict, counts: dict, seed: int, device: torch.device) -> dict:
    """The problem as tensors on ``device``: the padded arrays the driver
    hands a solver (``cam_params``, ``points``, ``obs_cam``, ``obs_pt``,
    ``obs_uv``, ``obs_mask``, ``cam_free``) and the live problem for the
    reference (``live``, a ``reference.ba.Problem``)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f32 = dict(device=device, dtype=torch.float32)
    C, L, O = int(counts["cameras"]), int(counts["points"]), int(counts["observations"])
    sp = float(scene["camera_spacing_m"])
    fx, fy, cx, cy = (float(v) for v in scene["intrinsics"])
    width, height = (int(v) for v in scene["frame"])

    def rand(*shape):
        return torch.rand(*shape, generator=g, **f32)

    def randn(*shape):
        return torch.randn(*shape, generator=g, **f32)

    # cameras scattered over a square district, each facing its own heading
    side = math.sqrt(C) * sp
    xz = rand(C, 2) * side
    centres = torch.stack([xz[:, 0], 0.3 * randn(C), xz[:, 1]], 1)
    aa = torch.stack([0.05 * randn(C), (rand(C) * 2 - 1) * math.pi, 0.02 * randn(C)], 1)
    R = ref_ba._rotation(aa)
    t = -torch.einsum("cij,cj->ci", R, centres)
    intr = torch.tensor([fx, fy, cx, cy, 0.0, 0.0], **f32)
    cams = torch.cat([aa, t, intr.expand(C, 6)], 1)
    d0, d1 = scene["depth_m"]
    k_near = min(C, int(scene["candidates"]))

    def observers(p):
        """(cameras nearest p first among those that see it, how many see it)."""
        dist = torch.cdist(p, centres)                                        # (n, C)
        near = torch.topk(dist, k_near, dim=1, largest=False)
        cc = near.indices
        pc = torch.einsum("nkij,nj->nki", R[cc], p) + t[cc]
        u = fx * pc[..., 0] / pc[..., 2] + cx
        v = fy * pc[..., 1] / pc[..., 2] + cy
        seen = (pc[..., 2] > 1.0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
        d = torch.where(seen, near.values, math.inf)
        return torch.gather(cc, 1, torch.argsort(d, dim=1, stable=True)), seen.sum(1)

    # each point in the view of a camera drawn for it, at a drawn pixel and
    # depth; drawn again until at least two cameras see it
    pts = torch.empty(L, 3, **f32)
    order = torch.empty(L, k_near, dtype=torch.long, device=device)
    n_seen = torch.zeros(L, dtype=torch.long, device=device)
    todo = torch.arange(L, device=device)
    for _ in range(50):
        if todo.numel() == 0:
            break
        n = todo.numel()
        src = torch.randint(0, C, (n,), generator=g, device=device)
        z = d0 + (d1 - d0) * rand(n)
        xc = torch.stack([(rand(n) * width - cx) / fx * z, (rand(n) * height - cy) / fy * z,
                          z], 1)
        pts[todo] = torch.einsum("nji,nj->ni", R[src], xc - t[src])
        for s in range(0, n, 1 << 15):
            idx = todo[s:s + (1 << 15)]
            order[idx], n_seen[idx] = observers(pts[idx])
        todo = todo[n_seen[todo] < 2]
    if todo.numel():
        raise ValueError("points seen by fewer than 2 cameras remain")

    # track lengths: 2 + geometric(mean O / L - 2), capped, then to the total
    p_geo = 1.0 / (O / L - 1.0)
    extra = torch.floor(torch.log(rand(L).clamp(min=1e-12)) / math.log(1.0 - p_geo))
    cap = torch.clamp(n_seen, max=int(scene["max_track"]))
    track = torch.minimum(2 + extra.long(), cap)
    win = k_near
    for _ in range(200):
        diff = O - int(track.sum())
        if diff == 0:
            break
        room = (track < cap) if diff > 0 else (track > 2)
        score = torch.where(room, rand(L), -1.0)
        k = min(abs(diff), int(room.sum()))
        if k == 0:
            raise ValueError("the track lengths cannot reach the observation count")
        track[torch.topk(score, k).indices] += 1 if diff > 0 else -1
    if int(track.sum()) != O:
        raise ValueError("the track lengths did not reach the observation count")
    keep = torch.arange(win, device=device)[None] < track[:, None]
    obs_cam = order[keep]
    obs_pt = torch.arange(L, device=device)[:, None].expand(L, win)[keep]

    uv = ref_ba.project(cams[obs_cam], pts[obs_pt]) + scene["px_noise"] * randn(O, 2)
    # the start: each camera turned about its own centre and moved
    pn = float(scene["pose_noise"])
    aa0 = aa.clone()
    aa0[1:] += pn * randn(C - 1, 3)
    c0 = centres.clone()
    c0[2:] += 5 * pn * randn(C - 2, 3)
    init = torch.cat([aa0, -torch.einsum("cij,cj->ci", ref_ba._rotation(aa0), c0),
                      intr.expand(C, 6)], 1)
    pts_init = pts + scene["point_noise"] * randn(L, 3)

    free = torch.ones(C, 12, **f32)
    free[0] = 0.0
    if C > 1:
        free[1, 3:6] = 0.0
    if C < int(scene["intrinsics_free_min_cams"]):
        free[:, 6:12] = 0.0
    else:
        free[:, 8:10] = 0.0

    C_pad, L_pad, O_pad = max(16, -(-C // 16) * 16), _pow2_bucket(L), _pow2_bucket(O)

    def pad(x, n):
        out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=device)
        out[:x.shape[0]] = x
        return out
    mask = torch.zeros(O_pad, dtype=torch.bool, device=device)
    mask[:O] = True
    live = ref_ba.Problem(cams=init, pts=pts_init, obs_cam=obs_cam, obs_pt=obs_pt, uv=uv,
                          free=free)
    return {"cam_params": pad(init, C_pad), "points": pad(pts_init, L_pad),
            "obs_cam": pad(obs_cam.to(torch.int32), O_pad),
            "obs_pt": pad(obs_pt.to(torch.int32), O_pad), "obs_uv": pad(uv, O_pad),
            "obs_mask": mask, "cam_free": pad(free, C_pad), "live": live}


def settings(cfg, n_cams: int, **override) -> ref_ba.Settings:
    """The driver's settings of a global BA over ``n_cams`` cameras."""
    base = dict(max_iters=cfg.ba_max_iters_small if n_cams < 10 else cfg.ba_max_iters_large,
                init_lambda=cfg.ba_init_lambda, lambda_up=cfg.ba_lambda_up,
                lambda_down=cfg.ba_lambda_down, ftol=cfg.ba_ftol,
                focal_upper_bound=cfg.ba_focal_upper_bound, huber_delta=cfg.ba_huber_delta,
                cg_iters=64, cg_tol=1e-6)
    base.update(override)
    return ref_ba.Settings(**base)


def reference_solve(live: ref_ba.Problem, st: ref_ba.Settings) -> ref_ba.Result:
    """The reference's float64 solve of ``live``, kept under ``REFERENCE_CACHE``
    by a hash of the problem, the settings, the reference's code, the torch
    version and the device: the same problem is solved once in a checkout."""
    h = hashlib.sha256()
    for x in live:
        h.update(str(tuple(x.shape)).encode() + str(x.dtype).encode())
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    h.update(repr(tuple(st)).encode())
    for mod in (ref_ba, ref_precision):
        h.update(Path(mod.__file__).read_bytes())
    dev = live.cams.device
    h.update(torch.__version__.encode())
    h.update((torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type).encode())
    path = REFERENCE_CACHE / f"ba_{h.hexdigest()[:24]}.pt"
    if path.is_file():
        r = torch.load(path, map_location=dev)
        return ref_ba.Result(cams=r["cams"], pts=r["pts"], cost=r["cost"],
                             iterations=r["iterations"])
    ref = ref_ba.solve(live, st, precision="float64")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp")
    torch.save({"cams": ref.cams.cpu(), "pts": ref.pts.cpu(), "cost": float(ref.cost),
                "iterations": int(ref.iterations)}, tmp)
    os.replace(tmp, path)
    return ref


class Runner:
    """Solves of one problem by the solver the driver routes it to."""

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.dev = int(seed), device
        self.iterations = []                 # LM iterations of every window solve
        self._traced = {"iterations": 0, "schur_bytes": 0.0, "schur_calls": 0}
        self.result = None
        self._tracing = False

    def setup(self) -> None:
        from reconstructor_tpu_torch.ba import distributed, lm as ba_lm
        from reconstructor_tpu_torch.config import ReconstructorConfig
        from reconstructor_tpu_torch.pipeline.incremental import uses_pcg

        self.cfg = ReconstructorConfig(**self.config["reconstructor"])
        p = make_problem(self.config["scene"], self.traffic,
                         int(self.traffic["problem_seed"]), self.dev)
        self.live = p.pop("live")
        self.n_cams = int(self.traffic["cameras"])
        prob = ba_lm.BAProblem(**p)
        st = settings(self.cfg, self.n_cams)
        common = dict(max_iters=st.max_iters, init_lambda=st.init_lambda,
                      lambda_up=st.lambda_up, lambda_down=st.lambda_down, ftol=st.ftol,
                      focal_upper_bound=st.focal_upper_bound, huber_delta=st.huber_delta,
                      damping=self.cfg.ba_damping)
        self.route = "pcg" if uses_pcg(self.cfg, p["cam_params"].shape[0],
                                       p["points"].shape[0]) else "dense"
        if self.route == "pcg":
            def solve(**kw):
                return distributed.solve_pcg(prob, **{**common, **kw})
        else:
            host = tuple(np.ascontiguousarray(x.cpu().numpy())
                         for x in (prob.obs_pt, prob.obs_cam, prob.obs_mask))

            def solve(**kw):
                return ba_lm.solve(prob, compact=False, host_obs=host, **{**common, **kw})
        self._solve = solve
        # warm-up: the first LM iterations of a solve run every shape and
        # kernel the window's solves run
        solve(max_iters=int(self.traffic.get("warmup_lm_iterations", 2)))

    def step(self) -> None:
        res = self._solve()
        self.result = (res.cam_params.cpu(), res.points.cpu(), float(res.cost_final))
        self.iterations.append(int(res.iterations))

    def e2e(self, elapsed: float, steps: int) -> dict:
        return {"ba_solve_s": elapsed / steps}

    def trace_hooks(self, stop):
        """Spans around the solver's pieces and byte counters around kernels 5
        and 6, for the first ``trace_lm_iterations`` LM iterations of the
        traced solve: the hook at the next iteration's blocks calls ``stop``."""
        from reconstructor_tpu_torch.ba import cuda_schur, cuda_segsum, distributed, lm as ba_lm
        traced, runner = self._traced, self
        budget = int(self.cell.get("trace_lm_iterations", 1 << 30))

        def seg_sum(fn):
            def inner(values, lay):
                if runner._tracing:
                    W = int(np.prod(values.shape[1:])) if values.dim() > 1 else 1
                    traced["schur_bytes"] += roofline.segsum_bytes(
                        int(lay.perm.numel()), lay.n, lay.n_chunks, lay.n_long, W)
                    traced["schur_calls"] += 1
                return fn(values, lay)
            return inner

        def schur(direction):
            def wrap(fn):
                def inner(Y, operand, lay):
                    if runner._tracing:
                        seg, other = ((lay.pt, lay.cam) if direction == "ytu"
                                      else (lay.cam, lay.pt))
                        op_w, out_w = (12, 3) if direction == "ytu" else (3, 12)
                        traced["schur_bytes"] += roofline.schur_bytes(
                            int(seg.perm.numel()), seg.n, seg.n_chunks, seg.n_long, other.n,
                            op_w, out_w)
                        traced["schur_calls"] += 1
                    return fn(Y, operand, lay)
                return inner
            return wrap

        def blocks(name):
            def wrap(fn):
                spanned = annotated(name)(fn)

                def inner(*a, **k):
                    if runner._tracing and traced["iterations"] == budget:
                        stop()
                        runner._tracing = False
                    if not runner._tracing:
                        return fn(*a, **k)
                    traced["iterations"] += 1
                    return spanned(*a, **k)
                return inner
            return wrap

        targets = [(cuda_segsum, "seg_sum", seg_sum), (cuda_schur, "ytu_sum", schur("ytu")),
                   (cuda_schur, "yz_sum", schur("yz")),
                   (distributed, "_build_pcg_blocks", blocks("build_pcg_blocks")),
                   (ba_lm, "_normal_blocks", blocks("normal_blocks"))]
        for mod, names in ((distributed, ("_layouts", "_lm_step_pcg", "_pcg", "_schur_matvec")),
                           (ba_lm, ("_layout", "_damped_schur_step", "_cost"))):
            targets += [(mod, n, annotated(n.strip("_"))) for n in names]

        @contextlib.contextmanager
        def hooks():
            with patched(targets):
                runner._tracing = True
                try:
                    yield
                finally:
                    runner._tracing = False
        return hooks()

    def counters(self) -> dict:
        return {"route": self.route, "iterations": list(self.iterations),
                "traced_iterations": self._traced["iterations"],
                "schur_bound_s": self._traced["schur_bytes"] / roofline.HBM_BYTES_PER_S,
                "schur_calls": self._traced["schur_calls"]}

    def check(self) -> list:
        """The last solve's cameras and points against the reference's solve
        from the same start, each number beside the cell's limit."""
        got, _ = self.judge()
        return [(name, got[name], float(lim)) for name, lim in self.cell["limits"].items()]

    def judge(self, control: bool = False):
        """(the program's numbers, the control's or None): the last solve, and
        with ``control`` the reference solved in TF32 at the driver's
        settings, each against the reference's float64 solve."""
        cams, pts, reported = self.result
        self._solve = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        C, L = self.live.cams.shape[0], self.live.pts.shape[0]
        st = settings(self.cfg, self.n_cams, **self.config.get("reference_settings", {}))
        ref = reference_solve(self.live, st)
        prog = ref_ba.compare(self.live, st, ref, cams[:C].to(self.dev), pts[:L].to(self.dev),
                              reported)
        ctrl = None
        if control:
            c = ref_ba.solve(self.live, settings(self.cfg, self.n_cams), precision="tf32")
            ctrl = ref_ba.compare(self.live, st, ref, c.cams, c.pts, c.cost)
        return prog, ctrl
