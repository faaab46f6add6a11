"""Plain reference of bundle adjustment: Levenberg-Marquardt on the
engine's reprojection cost, with the reduced camera system solved by
block-Jacobi preconditioned conjugate gradients (the implicit Schur
complement), in float64.

The cost is the one the engine states (a frozen copy of its arithmetic):
12 parameters a camera ``[angle-axis (3), t (3), fx, fy, cx, cy, k1, k2]``,
the point rotated by Rodrigues' formula, additive radial distortion
``d = k1 r + k2 r^2`` on the normalised coordinates (``u = fx (x + d) +
cx``), a Huber loss on the squared residual norm, and a 0/1 mask of the
free parameters. Every sum over observations is a segment sum over
observations sorted once by camera and by point (no atomics). Jacobian
blocks come from forward-mode automatic differentiation.

``precision="tf32"`` is the control: float32 values with every operand of a
product (the rotation of a point in the residual and the cost, the Jacobian
products, the Schur products) rounded to TF32, as a TF32 matrix product
reads them. It imports no part of the engine.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from benchmark.reference.precision import rounder


class Problem(NamedTuple):
    """A BA problem with live observations only: cams (C, 12), pts (L, 3),
    obs_cam / obs_pt (O,) int64, uv (O, 2), free (C, 12) 0/1."""
    cams: torch.Tensor
    pts: torch.Tensor
    obs_cam: torch.Tensor
    obs_pt: torch.Tensor
    uv: torch.Tensor
    free: torch.Tensor


class Settings(NamedTuple):
    max_iters: int
    init_lambda: float
    lambda_up: float
    lambda_down: float
    ftol: float
    focal_upper_bound: float
    huber_delta: float
    cg_iters: int
    cg_tol: float
    max_retries: int = 5


class Result(NamedTuple):
    cams: torch.Tensor
    pts: torch.Tensor
    cost: float
    iterations: int


def _dtype(precision: str) -> torch.dtype:
    return torch.float64 if precision == "float64" else torch.float32


def _rotation(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, (..., 3) -> (..., 3, 3), series-safe near 0."""
    t2 = torch.sum(aa * aa, dim=-1, keepdim=True)[..., None]
    t = torch.sqrt(t2 + 1e-30)
    small = t2 < 1e-8
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / (t2 + 1e-30))
    x, y, z = aa[..., 0], aa[..., 1], aa[..., 2]
    o = torch.zeros_like(x)
    W = torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                     torch.stack([-y, x, o], -1)], -2)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + a * W + b * (W @ W)


def project(cam: torch.Tensor, pt: torch.Tensor, precision: str = "float64") -> torch.Tensor:
    """Predicted pixel (..., 2) of points pt (..., 3) in cameras cam (..., 12),
    the rotation's product with the point read in ``precision``."""
    rnd = rounder(precision) or (lambda x: x)
    R = _rotation(cam[..., 0:3])
    p = torch.sum(rnd(R) * rnd(pt)[..., None, :], dim=-1) + cam[..., 3:6]
    z = p[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    x, y = p[..., 0:1] / z, p[..., 1:2] / z
    r = x * x + y * y
    d = cam[..., 10:11] * r + cam[..., 11:12] * r * r
    return torch.cat([cam[..., 6:7] * (x + d) + cam[..., 8:9],
                      cam[..., 7:8] * (y + d) + cam[..., 9:10]], dim=-1)


def _huber(s: torch.Tensor, delta: float) -> torch.Tensor:
    if delta <= 0.0:
        return s
    return torch.where(s <= delta * delta, s, 2.0 * delta * torch.sqrt(s + 1e-20) - delta * delta)


def cost(prob: Problem, cams: torch.Tensor, pts: torch.Tensor, huber_delta: float,
         precision: str = "float64", block: int = 1 << 21) -> float:
    """0.5 SUM huber(|r|^2) over the observations, in ``precision``
    (float64 sums for the reference)."""
    dt = _dtype(precision)
    cams, pts = cams.to(dt), pts.to(dt)
    total = torch.zeros((), dtype=torch.float64, device=cams.device)
    for s in range(0, prob.obs_cam.numel(), block):
        oc, op = prob.obs_cam[s:s + block], prob.obs_pt[s:s + block]
        r = project(cams[oc], pts[op], precision) - prob.uv[s:s + block].to(dt)
        total = total + torch.sum(_huber(torch.sum(r * r, -1), huber_delta)).double()
    return 0.5 * float(total)


def reprojection_gap(prob: Problem, a_cams, a_pts, b_cams, b_pts, block: int = 1 << 21) -> float:
    """RMS over the observations of the distance (px) between the pixels that
    two solutions predict, in float64."""
    total = 0.0
    for s in range(0, prob.obs_cam.numel(), block):
        oc, op = prob.obs_cam[s:s + block], prob.obs_pt[s:s + block]
        d = (project(a_cams.double()[oc], a_pts.double()[op])
             - project(b_cams.double()[oc], b_pts.double()[op]))
        total += float(torch.sum(d * d))
    return math.sqrt(total / max(prob.obs_cam.numel(), 1))


class _Segments:
    """Observations sorted once by a segment index: sums in a fixed order."""

    def __init__(self, index: torch.Tensor, n: int):
        self.perm = torch.argsort(index, stable=True)
        self.lengths = torch.bincount(index, minlength=n)

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        flat = values.reshape(values.shape[0], -1)[self.perm]
        out = torch.segment_reduce(flat, "sum", lengths=self.lengths, axis=0)
        return out.reshape((self.lengths.numel(),) + tuple(values.shape[1:]))


def solve(prob: Problem, st: Settings, precision: str = "float64",
          block: int = 1 << 20, log=None) -> Result:
    """LM from the problem's start to its stopping rule: an accepted step
    whose relative cost drop is under ``ftol``, lambda above 1e10, or
    ``max_iters`` outer iterations (each with up to ``max_retries`` damped
    trials). ``log``: called with each outer iteration's (iteration, cost,
    lambda, accepted, CG iterations of its last trial)."""
    dt = _dtype(precision)
    rnd = rounder(precision) or (lambda x: x)
    dev = prob.cams.device
    C, L = prob.cams.shape[0], prob.pts.shape[0]
    oc, op = prob.obs_cam, prob.obs_pt
    uv = prob.uv.to(dt)
    free = prob.free.to(dt)
    by_cam, by_pt = _Segments(oc, C), _Segments(op, L)
    eye12 = torch.eye(12, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)

    def mv(A, x):             # (n, i, j) (n, j) -> (n, i)
        return torch.sum(rnd(A) * rnd(x)[:, None, :], dim=2)

    def tv(A, x):             # (n, i, j) (n, i) -> (n, j)
        return torch.sum(rnd(A) * rnd(x)[:, :, None], dim=1)

    def tm(A, B):             # (n, r, i) (n, r, j) -> (n, i, j)
        return torch.sum(rnd(A)[:, :, :, None] * rnd(B)[:, :, None, :], dim=1)

    def resid(cam, pt, obs_uv):
        return project(cam, pt, precision) - obs_uv
    # Jacobian blocks by forward-mode AD of the unrounded residual: the
    # control's rounding is in the residual, the cost and every product
    exact = "float64" if dt == torch.float64 else "float32"
    jac = torch.func.vmap(torch.func.jacfwd(lambda c, p, u: project(c, p, exact) - u,
                                            argnums=(0, 1)))

    def blocks(cams, pts):
        """g_c, g_p, H_cc, H_pp and the per-observation coupling Y, the
        per-observation products made in blocks of observations."""
        parts = []
        for s in range(0, oc.numel(), block):
            o_c, o_p = oc[s:s + block], op[s:s + block]
            camO, ptO, uvO = cams[o_c], pts[o_p], uv[s:s + block]
            r = resid(camO, ptO, uvO)
            Jc, Jp = jac(camO, ptO, uvO)
            Jc = Jc * free[o_c][:, None, :]
            if st.huber_delta > 0.0:
                e = torch.sqrt(torch.sum(r * r, -1) + 1e-20)
                w = torch.sqrt(torch.clamp(st.huber_delta / e, max=1.0))
                r, Jc, Jp = r * w[:, None], Jc * w[:, None, None], Jp * w[:, None, None]
            parts.append((tv(Jc, r), tv(Jp, r), tm(Jc, Jc), tm(Jp, Jp), tm(Jc, Jp)))
        gc, gp, hc, hp, Y = (torch.cat(t) for t in zip(*parts))
        return by_cam.sum(gc), by_pt.sum(gp), by_cam.sum(hc), by_pt.sum(hp), Y

    def step(blk, lam):
        g_c, g_p, H_cc, H_pp, Y = blk
        dc = torch.clamp(torch.diagonal(H_cc, dim1=1, dim2=2), 1e-6, 1e32)
        dp = torch.clamp(torch.diagonal(H_pp, dim1=1, dim2=2), 1e-6, 1e32)
        Hc = H_cc + (lam * dc)[:, :, None] * eye12 + (1.0 - free)[:, :, None] * eye12
        Hp_inv = torch.linalg.inv(H_pp + (lam * dp + 1e-8)[:, :, None] * eye3)
        Hc_inv = torch.linalg.inv(Hc)

        def W_z(z):           # (L, 3) -> (C, 12)
            return by_cam.sum(mv(Y, z[op]))

        def Wt_u(u):          # (C, 12) -> (L, 3)
            return by_pt.sum(tv(Y, u[oc]))

        def S(u):
            return mv(Hc, u) - W_z(mv(Hp_inv, Wt_u(u)))

        rhs = -(g_c - W_z(mv(Hp_inv, g_p)))
        x = torch.zeros_like(rhs)
        r = rhs
        z = mv(Hc_inv, r)
        p = z
        rz = torch.sum(r * z)
        limit = st.cg_tol * torch.linalg.norm(rhs)
        for k in range(st.cg_iters):
            if not bool(torch.linalg.norm(r) > limit):
                break
            cg_used[0] = k + 1
            Ap = S(p)
            alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
            x = x + alpha * p
            r = r - alpha * Ap
            z = mv(Hc_inv, r)
            rz_new = torch.sum(r * z)
            p = z + (rz_new / torch.clamp(rz, min=1e-30)) * p
            rz = rz_new
        d_cam = x * free
        d_pt = -mv(Hp_inv, g_p + Wt_u(d_cam))
        return d_cam, d_pt

    cg_used = [0]
    cams, pts = prob.cams.to(dt), prob.pts.to(dt)
    cur = cost(prob, cams, pts, st.huber_delta, precision)
    lam = st.init_lambda
    it = 0
    while it < st.max_iters:
        blk = blocks(cams, pts)
        accepted = False
        for _ in range(st.max_retries):
            d_cam, d_pt = step(blk, lam)
            new_cams = cams + d_cam
            new_cams[:, 6:8] = torch.clamp(new_cams[:, 6:8], max=st.focal_upper_bound)
            new_pts = pts + d_pt
            new = cost(prob, new_cams, new_pts, st.huber_delta, precision)
            if math.isfinite(new) and new < cur:
                accepted = True
                break
            lam *= st.lambda_up
        it += 1
        done = False
        if accepted:
            drop = (cur - new) / max(cur, 1e-12)
            cams, pts, cur = new_cams, new_pts, new
            lam /= st.lambda_down
            done = drop < st.ftol
        if log is not None:
            log(it, cur, lam, accepted, cg_used[0])
        if done or lam > 1e10:
            break
    return Result(cams=cams, pts=pts, cost=cur, iterations=it)


def compare(prob: Problem, st: Settings, ref: Result, cams: torch.Tensor, pts: torch.Tensor,
            reported_cost: Optional[float]) -> dict:
    """The numbers that judge a solution (cams, pts) against the reference's:
    ``cost_excess``, its cost over the reference's less 1 (both in float64);
    ``cost_report``, the relative gap between the cost it reports and its
    cost in float64; ``reproj_gap_px``, the RMS distance between the pixels
    the two solutions predict."""
    c = cost(prob, cams, pts, st.huber_delta)
    out = {"cost_excess": (c - ref.cost) / ref.cost,
           "reproj_gap_px": reprojection_gap(prob, cams, pts, ref.cams, ref.pts)}
    if reported_cost is not None:
        out["cost_report"] = abs(reported_cost - c) / c
    return out
