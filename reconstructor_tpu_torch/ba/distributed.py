"""Bundle adjustment with implicit-Schur PCG linear solves, on one device.

The PyTorch counterpart of ``reconstructor_tpu.ba.distributed.solve_pcg``:
the large-scene solver the driver takes when the dense coupling of
``ba.lm`` would pass ``ba_dense_w_max_elems`` (or with
``ba_solver="pcg"``). The reduced camera system S = Hcc - W Hpp^-1 W^T is
never formed: LM solves it with block-Jacobi preconditioned CG whose
matvec is two sums over observations,
u -> Hcc u - SUM_o Y_o Hpp^-1[pt_o] (Y_o^T u[cam_o]), with the
per-observation coupling Y_o = Jc_o^T Jp_o. Memory is O(C + L + O).

- Every sum over observations is an ``index_add_`` over ``obs_cam`` /
  ``obs_pt`` (the JAX package's ``segment_sum``): each observation counts,
  also a second one of the same (camera, landmark). On the card these are
  float atomics, so a solve repeats to the last bits only on the CPU.
- The CG early exit is a frozen-state flag: once ||r|| <= tol ||rhs||,
  x, r and p stop changing, which gives the early exit's x. The host reads
  the flag every ``_CG_CHECK`` iterations to stop the loop.
- LM keeps the JAX loop's semantics: blocks once per outer iteration, up
  to ``max_retries`` damped trials, lambda and the cost on the host in
  float32, one host read per trial.

The multi-device solve (``solve_distributed``, the sharded problem) is not
part of this package yet.
"""

from __future__ import annotations

import numpy as np
import torch

from reconstructor_tpu_torch.ba import lm as ba_lm

# CG iterations between host reads of the converged flag (the flag, not
# this period, decides x)
_CG_CHECK = 16


def _seg_sum(values: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """Sum of ``values`` rows into ``n`` segments (``jax.ops.segment_sum``)."""
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype, device=values.device)
    return out.index_add_(0, index, values)


def _inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (L, 3, 3) blocks (``ba.lm``'s
    structure-of-arrays version, in the JAX package's (L, 3, 3) layout)."""
    L = m.shape[0]
    return ba_lm._inv3x3_soa(m.reshape(L, 9).T).T.reshape(L, 3, 3)


def _build_blocks(prob: ba_lm.BAProblem, cam, pts, huber_delta: float = 0.0):
    """Per-observation residuals and masked, Huber-weighted Jacobian
    blocks: (O, 2), (O, 2, 12), (O, 2, 3)."""
    camO = cam[prob.obs_cam]
    ptO = pts[prob.obs_pt]
    Jc, Jp = ba_lm._jac(camO, ptO, prob.obs_uv)
    res = ba_lm._resid(camO, ptO, prob.obs_uv)
    m = prob.obs_mask.to(res.dtype)
    Jc = Jc * m[:, None, None] * prob.cam_free[prob.obs_cam][:, None, :]
    Jp = Jp * m[:, None, None]
    res = res * m[:, None]
    if huber_delta > 0.0:
        e = torch.sqrt(torch.sum(res * res, dim=-1, keepdim=True) + 1e-20)
        w = torch.sqrt(torch.clamp(huber_delta / e, max=1.0))          # (O, 1)
        res = res * w
        Jc = Jc * w[:, :, None]
        Jp = Jp * w[:, :, None]
    return res, Jc, Jp


def _pcg(matvec, rhs: torch.Tensor, precond, num_iters: int, tol: float) -> torch.Tensor:
    """Fixed-budget preconditioned conjugate gradient with early exit."""
    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    limit = tol * torch.linalg.norm(rhs)
    active = torch.linalg.norm(r) > limit
    for it in range(num_iters):
        Ap = matvec(p)
        alpha = rz / torch.clamp(torch.dot(p, Ap), min=1e-20)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = precond(r_new)
        rz_new = torch.dot(r_new, z)
        beta = rz_new / torch.clamp(rz, min=1e-20)
        p_new = z + beta * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rz = torch.where(active, rz_new, rz)
        active = active & (torch.linalg.norm(r) > limit)
        if (it + 1) % _CG_CHECK == 0 and it + 1 < num_iters and not bool(active):
            break
    return x


def _build_pcg_blocks(prob: ba_lm.BAProblem, cam, pts, huber_delta: float = 0.0):
    """Damping-independent blocks for the implicit-Schur path (built once
    per outer LM iteration; lambda retries reuse them)."""
    C = cam.shape[0]
    L = pts.shape[0]
    res, Jc, Jp = _build_blocks(prob, cam, pts, huber_delta)
    g_c = _seg_sum(torch.einsum("ori,or->oi", Jc, res), prob.obs_cam, C)
    g_p = _seg_sum(torch.einsum("ori,or->oi", Jp, res), prob.obs_pt, L)
    H_cc = _seg_sum(torch.einsum("ori,orj->oij", Jc, Jc), prob.obs_cam, C)
    H_pp = _seg_sum(torch.einsum("ori,orj->oij", Jp, Jp), prob.obs_pt, L)
    Y = torch.einsum("ori,orj->oij", Jc, Jp)                            # (O, 12, 3)
    return g_c, g_p, H_cc, H_pp, Y


def _lm_step_pcg(prob: ba_lm.BAProblem, blocks, lam, cg_iters: int, cg_tol: float,
                 damping: str = "levenberg"):
    """One damped implicit-Schur PCG solve from prebuilt blocks; ``lam``
    is a float32 scalar. Returns (d_cam (C, 12), d_pt (L, 3))."""
    g_c, g_p, H_cc, H_pp, Y = blocks
    C = g_c.shape[0]
    L = g_p.shape[0]
    dtype, dev = g_c.dtype, g_c.device
    eye12 = torch.eye(12, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    fixed_c = 1.0 - prob.cam_free
    lam = float(lam)
    if damping == "marquardt":
        dc = torch.clamp(torch.diagonal(H_cc, dim1=1, dim2=2), 1e-6, 1e32)
        dp = torch.clamp(torch.diagonal(H_pp, dim1=1, dim2=2), 1e-6, 1e32)
        H_cc = H_cc + (lam * dc)[:, :, None] * eye12 + fixed_c[:, :, None] * eye12
        H_pp = H_pp + (lam * dp + 1e-8)[:, :, None] * eye3
    else:
        H_cc = H_cc + lam * eye12 + fixed_c[:, :, None] * eye12
        H_pp = H_pp + float(np.float32(lam) + np.float32(1e-8)) * eye3
    H_pp_inv = _inv3x3(H_pp)                                            # (L, 3, 3)
    cam_o, pt_o = prob.obs_cam, prob.obs_pt

    def schur_matvec(u_flat):
        u = u_flat.reshape(C, 12)
        Ytu = torch.einsum("oij,oi->oj", Y, u[cam_o])                   # (O, 3)
        WtU = _seg_sum(Ytu, pt_o, L)                                    # (L, 3)
        z = torch.einsum("lij,lj->li", H_pp_inv, WtU)
        Wz = _seg_sum(torch.einsum("oij,oj->oi", Y, z[pt_o]), cam_o, C)  # (C, 12)
        Hu = torch.einsum("cij,cj->ci", H_cc, u)
        return (Hu - Wz).reshape(-1)

    # W Hpp^-1 g_p for the reduced rhs
    zg = torch.einsum("lij,lj->li", H_pp_inv, g_p)
    Wzg = _seg_sum(torch.einsum("oij,oj->oi", Y, zg[pt_o]), cam_o, C)
    rhs = -(g_c - Wzg).reshape(-1)

    H_cc_inv = torch.linalg.inv(H_cc)                                   # block-Jacobi

    def precond(r_flat):
        return torch.einsum("cij,cj->ci", H_cc_inv, r_flat.reshape(C, 12)).reshape(-1)

    d_cam = _pcg(schur_matvec, rhs, precond, cg_iters, cg_tol).reshape(C, 12)

    WtD = _seg_sum(torch.einsum("oij,oi->oj", Y, d_cam[cam_o]), pt_o, L)
    d_pt = -torch.einsum("lij,lj->li", H_pp_inv, g_p + WtD)
    return d_cam * prob.cam_free, d_pt


def solve_pcg(prob: ba_lm.BAProblem, max_iters: int = 50,
              init_lambda: float = 1e-3, lambda_up: float = 4.0,
              lambda_down: float = 2.0, ftol: float = 1e-8,
              cg_iters: int = 64, cg_tol: float = 1e-6,
              focal_upper_bound: float = 1000.0,
              max_retries: int = 5, huber_delta: float = 0.0,
              damping: str = "marquardt") -> ba_lm.BAResult:
    """LM with implicit-Schur PCG linear solves, on the problem's device.

    Same two-level structure as ``ba.lm.solve``: blocks once per outer
    iteration, damping retries re-run only the PCG solve. An outer
    iteration whose retries all fail only inflates lambda; the loop ends at
    convergence (relative cost drop under ``ftol``), lambda above 1e10 or
    ``max_iters``.
    """
    prob = prob._replace(obs_cam=prob.obs_cam.long(), obs_pt=prob.obs_pt.long())
    maskO = prob.obs_mask.to(prob.cam_params.dtype)

    def cost_of(cam, pts):
        return ba_lm._cost(prob, cam, pts, maskO, huber_delta)

    f32 = np.float32
    cam, pts = prob.cam_params, prob.points
    cost0 = cost_of(cam, pts)
    cost = cost0
    cost_h = f32(cost0.item())
    lam = f32(init_lambda)
    it = 0
    while it < max_iters:
        blocks = _build_pcg_blocks(prob, cam, pts, huber_delta)
        lam_i = lam
        accepted = False
        for _ in range(max_retries):
            d_cam, d_pt = _lm_step_pcg(prob, blocks, lam_i, cg_iters, cg_tol, damping)
            cam_new = cam + d_cam
            cam_new[:, 6:8] = torch.clamp(cam_new[:, 6:8], max=focal_upper_bound)
            pts_new = pts + d_pt
            new_cost = cost_of(cam_new, pts_new)
            new_h = f32(new_cost.item())
            if np.isfinite(new_h) and new_h < cost_h:
                accepted = True
                break
            lam_i = f32(lam_i * f32(lambda_up))
        it += 1
        if accepted:
            cam, pts, cost = cam_new, pts_new, new_cost
            lam = f32(lam_i / f32(lambda_down))
            rel_drop = f32((cost_h - new_h) / max(cost_h, f32(1e-12)))
            cost_h = new_h
            if rel_drop < f32(ftol) and rel_drop >= 0:
                break
        else:
            lam = lam_i
        if lam > 1e10:
            break
    return ba_lm.BAResult(cam_params=cam, points=pts, cost_initial=cost0,
                          cost_final=cost, iterations=it)
