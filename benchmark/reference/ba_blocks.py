"""The plain reference of bundle adjustment (``reference/ba.py``) for a
problem whose float64 blocks do not fit one card: the same Levenberg-Marquardt
loop and block-Jacobi PCG on the implicit Schur complement, in the same
float64 arithmetic, with the observations split into contiguous slices, one
on each of several devices, all driven from one process.

Each device holds its slice of the observations, their per-observation
coupling Y and the slice's two segment orders (by camera, by point, sorted
once). A sum over observations is the slice's segment sum on its device (in
``reference/ba.py``'s fixed order), and the slices' sums are added on the
first device in device order, so a solve repeats bit for bit. Cameras and
points, and every vector of the CG, live on the first device. Plain
``torch``, no process group; it imports no part of the engine.

``precision="tf32"`` is ``reference/ba.py``'s control, over the same slices.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from benchmark.reference.ba import (Problem, Result, Settings, _dtype, _huber, _Segments,
                                    project)
from benchmark.reference.precision import rounder


class _Slice:
    """One device's contiguous slice of the observations, its two segment
    orders, and (once ``blocks`` ran) its coupling blocks Y."""

    def __init__(self, prob: Problem, lo: int, hi: int, device: torch.device, dt):
        self.dev = device
        self.oc = prob.obs_cam[lo:hi].to(device)
        self.op = prob.obs_pt[lo:hi].to(device)
        self.uv = prob.uv[lo:hi].to(device=device, dtype=dt)
        self.by_cam = _Segments(self.oc, prob.cams.shape[0])
        self.by_pt = _Segments(self.op, prob.pts.shape[0])
        self.Y = None


def _split(n: int, parts: int) -> List[int]:
    per = -(-n // parts)
    return [min(n, k * per) for k in range(parts + 1)]


def cost(prob: Problem, slices: Sequence[_Slice], cams: torch.Tensor, pts: torch.Tensor,
         huber_delta: float, precision: str = "float64", block: int = 1 << 21) -> float:
    """``reference/ba.py``'s cost over the slices, each slice's blocks summed
    in float64 on its device, the slices added in device order."""
    dt = _dtype(precision)
    parts = []
    for sl in slices:
        c, p = cams.to(device=sl.dev, dtype=dt), pts.to(device=sl.dev, dtype=dt)
        total = torch.zeros((), dtype=torch.float64, device=sl.dev)
        for s in range(0, sl.oc.numel(), block):
            oc, op = sl.oc[s:s + block], sl.op[s:s + block]
            r = project(c[oc], p[op], precision) - sl.uv[s:s + block]
            total = total + torch.sum(_huber(torch.sum(r * r, -1), huber_delta)).double()
        parts.append(total)
    return 0.5 * sum(float(t) for t in parts)


def solve(prob: Problem, st: Settings, devices: Sequence, precision: str = "float64",
          block: int = 1 << 20, log=None) -> Result:
    """``reference/ba.py``'s ``solve`` with the observations split over
    ``devices`` (the problem's own device first among them, where the
    cameras, points and CG vectors live)."""
    dt = _dtype(precision)
    rnd = rounder(precision) or (lambda x: x)
    devs = [torch.device(d) for d in devices]
    home = prob.cams.device
    C, L = prob.cams.shape[0], prob.pts.shape[0]
    bounds = _split(prob.obs_cam.numel(), len(devs))
    slices = [_Slice(prob, bounds[k], bounds[k + 1], d, dt) for k, d in enumerate(devs)]
    free = prob.free.to(dt)
    eye12 = torch.eye(12, dtype=dt, device=home)
    eye3 = torch.eye(3, dtype=dt, device=home)

    def mv(A, x):             # (n, i, j) (n, j) -> (n, i)
        return torch.sum(rnd(A) * rnd(x)[:, None, :], dim=2)

    def tv(A, x):             # (n, i, j) (n, i) -> (n, j)
        return torch.sum(rnd(A) * rnd(x)[:, :, None], dim=1)

    def tm(A, B):             # (n, r, i) (n, r, j) -> (n, i, j)
        return torch.sum(rnd(A)[:, :, :, None] * rnd(B)[:, :, None, :], dim=1)

    def resid(cam, pt, obs_uv):
        return project(cam, pt, precision) - obs_uv
    exact = "float64" if dt == torch.float64 else "float32"
    jac = torch.func.vmap(torch.func.jacfwd(lambda c, p, u: project(c, p, exact) - u,
                                            argnums=(0, 1)))

    def gather(parts):
        """The slices' partial sums added on the home device, in device order."""
        out = parts[0].to(home)
        for p in parts[1:]:
            out = out + p.to(home)
        return out

    def blocks(cams, pts):
        """g_c, g_p, H_cc, H_pp summed over the slices; each slice keeps its Y."""
        sums = []
        for sl in slices:
            c, p, fr = cams.to(sl.dev), pts.to(sl.dev), free.to(sl.dev)
            parts = []
            for s in range(0, sl.oc.numel(), block):
                o_c, o_p = sl.oc[s:s + block], sl.op[s:s + block]
                camO, ptO, uvO = c[o_c], p[o_p], sl.uv[s:s + block]
                r = resid(camO, ptO, uvO)
                Jc, Jp = jac(camO, ptO, uvO)
                Jc = Jc * fr[o_c][:, None, :]
                if st.huber_delta > 0.0:
                    e = torch.sqrt(torch.sum(r * r, -1) + 1e-20)
                    w = torch.sqrt(torch.clamp(st.huber_delta / e, max=1.0))
                    r, Jc, Jp = r * w[:, None], Jc * w[:, None, None], Jp * w[:, None, None]
                parts.append((tv(Jc, r), tv(Jp, r), tm(Jc, Jc), tm(Jp, Jp), tm(Jc, Jp)))
            gc, gp, hc, hp, sl.Y = (torch.cat(t) for t in zip(*parts))
            del parts
            sums.append((sl.by_cam.sum(gc), sl.by_pt.sum(gp), sl.by_cam.sum(hc),
                         sl.by_pt.sum(hp)))
            del gc, gp, hc, hp
        return tuple(gather(list(t)) for t in zip(*sums))

    def step(blk, lam):
        g_c, g_p, H_cc, H_pp = blk
        dc = torch.clamp(torch.diagonal(H_cc, dim1=1, dim2=2), 1e-6, 1e32)
        dp = torch.clamp(torch.diagonal(H_pp, dim1=1, dim2=2), 1e-6, 1e32)
        Hc = H_cc + (lam * dc)[:, :, None] * eye12 + (1.0 - free)[:, :, None] * eye12
        Hp_inv = torch.linalg.inv(H_pp + (lam * dp + 1e-8)[:, :, None] * eye3)
        Hc_inv = torch.linalg.inv(Hc)

        def W_z(z):           # (L, 3) -> (C, 12)
            parts = []
            for sl in slices:
                zd = z.to(sl.dev)
                parts.append(sl.by_cam.sum(mv(sl.Y, zd[sl.op])))
            return gather(parts)

        def Wt_u(u):          # (C, 12) -> (L, 3)
            parts = []
            for sl in slices:
                ud = u.to(sl.dev)
                parts.append(sl.by_pt.sum(tv(sl.Y, ud[sl.oc])))
            return gather(parts)

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
    cur = cost(prob, slices, cams, pts, st.huber_delta, precision)
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
            new = cost(prob, slices, new_cams, new_pts, st.huber_delta, precision)
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
