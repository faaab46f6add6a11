"""Bundle adjustment with implicit-Schur PCG linear solves, on one device
or with the observation axis sharded over the ranks of a mesh.

The PyTorch counterpart of ``reconstructor_tpu.ba.distributed``.
``solve_pcg`` is the large-scene solver the driver takes when the dense coupling of
``ba.lm`` would pass ``ba_dense_w_max_elems`` (or with
``ba_solver="pcg"``). The reduced camera system S = Hcc - W Hpp^-1 W^T is
never formed: LM solves it with block-Jacobi preconditioned CG whose
matvec is two sums over observations,
u -> Hcc u - SUM_o Y_o Hpp^-1[pt_o] (Y_o^T u[cam_o]), with the
per-observation coupling Y_o = Jc_o^T Jp_o. Memory is O(C + L + O).

- Every sum over observations is a segment sum over ``obs_cam`` /
  ``obs_pt`` (the JAX package's ``segment_sum``) through the two layouts
  of the live observations built once per solve
  (``ba.cuda_schur.schur_layout``): each observation counts, also a second
  one of the same (camera, landmark). On the card the block sums (g_c,
  g_p, H_cc, H_pp) are the fixed-order kernel 5 (``ba/csrc/seg_sum.cu``)
  and W^T u and W z, with their gather and product, one launch each of
  the fused kernel 6 (``ba/csrc/schur_sums.cu``); no atomics on values.
  On the CPU both are ``index_add_`` in observation order, so a solve
  repeats bit for bit on either device. The products H_pp^-1 v over every
  landmark are kernel 8 (``ba/csrc/point_blocks.cu``, one fixed rounding
  order) on the card, on ``_inv3x3``'s (9, L) planes, and the einsum it
  replaced on the CPU.
- The CG early exit is a frozen-state flag: once ||r|| <= tol ||rhs||,
  x, r and p stop changing, which gives the early exit's x. The host reads
  the flag every ``_CG_CHECK`` iterations to stop the loop.
- LM keeps the JAX loop's semantics: blocks once per outer iteration, up
  to ``max_retries`` damped trials, lambda and the cost on the host in
  float32, one host read per trial.

``solve_distributed`` runs the same LM loop over a mesh
(``parallel.mesh``): each rank holds a contiguous slice of the
observations (``shard_problem``) and the whole camera and point state.
Every sum over observations is a partial sum on each rank that one
``all_reduce`` completes, through the loop's one reduce hook: g_c, g_p,
H_cc and H_pp once per outer iteration (one call), W^T u and W z in every
CG iteration (two calls, of (L, 3) and (C, 12)), W Hpp^-1 g_p for the
rhs, W^T d for the point step, and every cost. The per-observation
coupling Y stays on its rank. Every vector of the CG and every decision
(accept, lambda, the frozen flag, the end) is then computed from reduced
values, the same on every rank, so every rank makes the same collective
calls and ends with the same state. On one device the hook does nothing.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from reconstructor_tpu_torch.ba import cuda_blocks, cuda_schur, cuda_segsum, lm as ba_lm
from reconstructor_tpu_torch.parallel.mesh import Mesh, all_sum, replicate, shard_rows
from reconstructor_tpu_torch.utils import profiling

# CG iterations between host reads of the converged flag (the flag, not
# this period, decides x)
_CG_CHECK = 16


def _local(*sums):
    """The reduce hook of one device: the partial sums are the sums."""
    return sums


def _layouts(prob: ba_lm.BAProblem) -> cuda_schur.SchurLayout:
    """The segment layouts of one solve: observations by camera, by point
    (the ``ba.layout`` span)."""
    with profiling.annotate("ba.layout"):
        return cuda_schur.schur_layout(prob.obs_cam, prob.obs_pt, prob.cam_params.shape[0],
                                       prob.points.shape[0], prob.obs_mask)


def _inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (L, 3, 3) blocks, as ``ba.lm``'s
    structure-of-arrays version leaves it: (9, L) planes, plane 3 i + j
    holding entry (i, j) of every block (what ``cuda_blocks.block3_matvec``
    reads)."""
    return ba_lm._inv3x3_soa(m.reshape(m.shape[0], 9).T)


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
        with profiling.annotate("ba.pcg.cg_iteration"):
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


def _build_pcg_blocks(prob: ba_lm.BAProblem, lay: cuda_schur.SchurLayout, cam, pts,
                      huber_delta: float = 0.0, reduce=_local):
    """Damping-independent blocks for the implicit-Schur path (built once
    per outer LM iteration; lambda retries reuse them). ``reduce`` sums
    the four over the ranks; Y stays local."""
    with profiling.annotate("ba.blocks"):
        seg_sum = cuda_segsum.seg_sum
        res, Jc, Jp = _build_blocks(prob, cam, pts, huber_delta)
        g_c = seg_sum(torch.einsum("ori,or->oi", Jc, res), lay.cam)
        g_p = seg_sum(torch.einsum("ori,or->oi", Jp, res), lay.pt)
        H_cc = seg_sum(torch.einsum("ori,orj->oij", Jc, Jc), lay.cam)
        H_pp = seg_sum(torch.einsum("ori,orj->oij", Jp, Jp), lay.pt)
        g_c, g_p, H_cc, H_pp = reduce(g_c, g_p, H_cc, H_pp)
        Y = torch.einsum("ori,orj->oij", Jc, Jp).contiguous()               # (O, 12, 3)
        return g_c, g_p, H_cc, H_pp, Y


def _schur_matvec(lay: cuda_schur.SchurLayout, Y, H_cc, H_pp_inv, u_flat: torch.Tensor,
                  reduce=_local) -> torch.Tensor:
    """S u = Hcc u - W Hpp^-1 W^T u without forming S: two sums over
    observations (``reduce`` completes each over the ranks); ``H_pp_inv``
    is ``_inv3x3``'s (9, L) planes."""
    C = H_cc.shape[0]
    u = u_flat.reshape(C, 12)
    (WtU,) = reduce(cuda_schur.ytu_sum(Y, u, lay))                      # (L, 3)
    z = cuda_blocks.block3_matvec(H_pp_inv, WtU)
    (Wz,) = reduce(cuda_schur.yz_sum(Y, z, lay))                        # (C, 12)
    Hu = torch.einsum("cij,cj->ci", H_cc, u)
    return (Hu - Wz).reshape(-1)


def _lm_step_pcg(prob: ba_lm.BAProblem, lay: cuda_schur.SchurLayout, blocks, lam,
                 cg_iters: int,
                 cg_tol: float, damping: str = "levenberg", reduce=_local):
    """One damped implicit-Schur PCG solve from prebuilt blocks; ``lam``
    is a float32 scalar. Returns (d_cam (C, 12), d_pt (L, 3))."""
    g_c, g_p, H_cc, H_pp, Y = blocks
    C = g_c.shape[0]
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
    H_pp_inv = _inv3x3(H_pp)                                            # (9, L)
    schur_matvec = functools.partial(_schur_matvec, lay, Y, H_cc, H_pp_inv, reduce=reduce)

    # W Hpp^-1 g_p for the reduced rhs
    zg = cuda_blocks.block3_matvec(H_pp_inv, g_p)
    (Wzg,) = reduce(cuda_schur.yz_sum(Y, zg, lay))
    rhs = -(g_c - Wzg).reshape(-1)

    H_cc_inv = torch.linalg.inv(H_cc)                                   # block-Jacobi

    def precond(r_flat):
        return torch.einsum("cij,cj->ci", H_cc_inv, r_flat.reshape(C, 12)).reshape(-1)

    d_cam = _pcg(schur_matvec, rhs, precond, cg_iters, cg_tol).reshape(C, 12)

    (WtD,) = reduce(cuda_schur.ytu_sum(Y, d_cam, lay))
    d_pt = -cuda_blocks.block3_matvec(H_pp_inv, g_p + WtD)
    return d_cam * prob.cam_free, d_pt


def solve_pcg(prob: ba_lm.BAProblem, max_iters: int = 50,
              init_lambda: float = 1e-3, lambda_up: float = 4.0,
              lambda_down: float = 2.0, ftol: float = 1e-8,
              cg_iters: int = 64, cg_tol: float = 1e-6,
              focal_upper_bound: float = 1000.0,
              max_retries: int = 5, huber_delta: float = 0.0,
              damping: str = "marquardt", reduce=None) -> ba_lm.BAResult:
    """LM with implicit-Schur PCG linear solves, on the problem's device.

    Same two-level structure as ``ba.lm.solve``: blocks once per outer
    iteration, damping retries re-run only the PCG solve. An outer
    iteration whose retries all fail only inflates lambda; the loop ends at
    convergence (relative cost drop under ``ftol``), lambda above 1e10 or
    ``max_iters``. ``cost_trace`` holds the cost after each outer
    iteration, padded with the final cost (a CPU tensor: the loop reads
    each cost on the host anyway). ``reduce``: the hook that sums
    per-observation partial sums over the ranks (``solve_distributed``
    passes it); ``None`` on one device.
    """
    with profiling.annotate("ba.solve"):
        reduce = reduce or _local
        prob = prob._replace(obs_cam=prob.obs_cam.long(), obs_pt=prob.obs_pt.long())
        lay = _layouts(prob)
        maskO = prob.obs_mask.to(prob.cam_params.dtype)

        def cost_of(cam, pts):
            return reduce(ba_lm._cost(prob, cam, pts, maskO, huber_delta))[0]

        f32 = np.float32
        cam, pts = prob.cam_params, prob.points
        cost0 = cost_of(cam, pts)
        cost = cost0
        cost_h = f32(cost0.item())
        lam = f32(init_lambda)
        trace = []
        it = 0
        while it < max_iters:
            with profiling.annotate("ba.lm_iteration"):
                blocks = _build_pcg_blocks(prob, lay, cam, pts, huber_delta, reduce)
                lam_i = lam
                accepted = False
                for _ in range(max_retries):
                    with profiling.annotate("ba.trial"):
                        d_cam, d_pt = _lm_step_pcg(prob, lay, blocks, lam_i, cg_iters, cg_tol,
                                                   damping, reduce)
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
                trace.append(cost_h)
                if lam > 1e10:
                    break
        trace += [cost_h] * (max_iters - len(trace))
        return ba_lm.BAResult(cam_params=cam, points=pts, cost_initial=cost0,
                              cost_final=cost, iterations=it,
                              cost_trace=torch.tensor(np.asarray(trace, np.float32)))


def shard_problem(mesh: Mesh, prob: ba_lm.BAProblem) -> ba_lm.BAProblem:
    """This rank's part of a BA problem on its device: a contiguous slice
    of the observation axis, padded to a multiple of the world size with
    masked slots; cameras, points and ``cam_free`` whole."""
    n_pad = -(-prob.obs_uv.shape[0] // mesh.size) * mesh.size

    def obs(x):
        return shard_rows(mesh, replicate(mesh, x), n_pad)
    return ba_lm.BAProblem(
        cam_params=replicate(mesh, prob.cam_params),
        points=replicate(mesh, prob.points),
        obs_cam=obs(prob.obs_cam), obs_pt=obs(prob.obs_pt), obs_uv=obs(prob.obs_uv),
        obs_mask=obs(prob.obs_mask),
        cam_free=replicate(mesh, prob.cam_free))


def solve_distributed(mesh: Mesh, prob: ba_lm.BAProblem, **kwargs) -> ba_lm.BAResult:
    """``solve_pcg`` with the observation axis sharded over the mesh and
    every sum over observations summed across the ranks (``all_sum``).
    Every rank passes the same global problem and gets the same result.
    ``kwargs`` are ``solve_pcg``'s."""
    return solve_pcg(shard_problem(mesh, prob), reduce=functools.partial(all_sum, mesh),
                     **kwargs)
