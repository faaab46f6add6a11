"""Levenberg-Marquardt bundle adjustment with a dense Schur-complement solve.

Capability parity with the reference's Ceres-based ``BundleAdjuster``
(BundleAdjuster.cpp:11-188: autodiff reprojection residuals, DENSE_SCHUR,
gauge fixing cam0 + cam1-translation, intrinsics frozen below 10 cameras),
and the same solver as ``reconstructor_tpu.ba.lm.solve``:

- The residual (``_resid``) is the reference's ReprojectionError
  (BundleAdjuster.h:26-58) — angle-axis rotation, additive shared radial
  distortion. Forward-mode autodiff (``torch.func.jacfwd`` batched over
  all observations) gives the (O, 2, 12) camera and (O, 2, 3) point
  Jacobian blocks.
- Camera-side reductions are one-hot (O, C) matmuls; the camera-landmark
  coupling W is a gather through a (C, L) table with a zero sentinel, and
  the point-side Hpp / g_p sums ride that gather (or a landmark-major
  (L, M) table when it is much smaller): every reduction is
  deterministic (no float atomics), so a solve repeats bit for bit on
  the card.
- The reduced camera system S = Hcc - W Hpp^-1 W^T is formed densely
  through the (12C, 3L) coupling matrix and factored by Cholesky: the
  DENSE_SCHUR regime of tens of cameras. Per-landmark 3x3 inverses are
  closed-form adjugates.
- Damping is Ceres-style Marquardt (lambda * clipped diag(H)) with the
  Marquardt-Nielsen gain-ratio schedule; parameter freezing (gauge +
  intrinsics policy) zeroes Jacobian columns.
- The LM loop runs on the device; the host reads one flag per iteration
  to stop at convergence.
- ``block_dtype`` rounds the coupling W and/or the camera Hessian's
  per-observation blocks to bfloat16 (sums stay float32), and
  ``schur_precision`` sets how the three W-sized products are computed on
  the card: a float32 pass with TF32 off (``'highest'`` and ``'high'``)
  or one pass on bf16-rounded operands (``'default'``). On the CPU all
  three are plain float32 products, as XLA:CPU computes them.

Parameter layout per camera (12): [aa(3), t(3), fx, fy, cx, cy, k1, k2]
(extrinsics packing of BundleAdjuster.cpp:52-57, intrinsics of :38-43).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

SCHUR_PRECISIONS = ("highest", "high", "default")


class BAProblem(NamedTuple):
    """Fixed-shape bundle adjustment problem (tensors on one device)."""
    cam_params: torch.Tensor   # (C, 12)
    points: torch.Tensor       # (L, 3)
    obs_cam: torch.Tensor      # (O,) int
    obs_pt: torch.Tensor       # (O,) int
    obs_uv: torch.Tensor       # (O, 2)
    obs_mask: torch.Tensor     # (O,) bool
    cam_free: torch.Tensor     # (C, 12) float 0/1 — free-parameter mask


class BAResult(NamedTuple):
    cam_params: torch.Tensor
    points: torch.Tensor
    cost_initial: torch.Tensor
    cost_final: torch.Tensor
    iterations: int
    # accepted cost per outer iteration (max_iters,), padded with the
    # final cost
    cost_trace: Optional[torch.Tensor] = None


def make_cam_free_mask(num_cams: int, intrinsics_free_min_cams: int = 10) -> np.ndarray:
    """Reference freezing policy as a (C, 12) 0/1 mask (host numpy).

    - camera 0: fully constant (gauge, BundleAdjuster.cpp:100-101)
    - camera 1: translation constant (scale gauge, :104-105)
    - intrinsics: all frozen when C < 10, else only principal point frozen
      (:108-129). k1, k2 follow the focal columns' policy.
    """
    free = np.ones((num_cams, 12), np.float32)
    free[0, :] = 0.0
    if num_cams > 1:
        free[1, 3:6] = 0.0
    if num_cams < intrinsics_free_min_cams:
        free[:, 6:12] = 0.0
    else:
        free[:, 8:10] = 0.0
    return free


def landmark_major_layout(obs_pt, obs_cam, obs_mask, num_landmarks: int,
                          m_pad: Optional[int] = None):
    """Host-side (numpy) landmark-major padded observation layout.

    Returns (p_idx, p_cam, p_mask), each (L, M): for landmark l, slot m
    holds the index into the flat observation table of its m-th
    observation (0 + mask 0 for padding). M is the max track length
    rounded up to a power of two (>= 4)."""
    op = np.asarray(obs_pt)
    oc = np.asarray(obs_cam)
    om = np.asarray(obs_mask)
    L = int(num_landmarks)
    live = np.nonzero(om)[0]
    if live.size == 0:
        M = int(m_pad) if m_pad else 4
        return (np.zeros((L, M), np.int32), np.zeros((L, M), np.int32),
                np.zeros((L, M), np.float32))
    order = live[np.argsort(op[live], kind="stable")]
    sp = op[order]
    counts = np.bincount(sp, minlength=L)
    maxc = int(counts.max())
    M = int(m_pad) if m_pad else max(4, 1 << (maxc - 1).bit_length())
    starts = np.zeros(L, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    slot = np.arange(order.size) - starts[sp]
    p_idx = np.zeros((L, M), np.int32)
    p_cam = np.zeros((L, M), np.int32)
    p_mask = np.zeros((L, M), np.float32)
    p_idx[sp, slot] = order
    p_cam[sp, slot] = oc[order]
    p_mask[sp, slot] = 1.0
    return p_idx, p_cam, p_mask


def coupling_gather_table(obs_pt, obs_cam, obs_mask, num_cams: int,
                          num_landmarks: int) -> np.ndarray:
    """Host-side (numpy) (C, L) gather table for the W coupling blocks.

    Each (camera, landmark) pair has at most one observation, so
    W[c, l] = Jc_o^T Jp_o is a pure gather of per-observation blocks:
    w_idx[c, l] is that observation's index, and unobserved pairs point
    at the sentinel slot O (a zero block appended on the device)."""
    op = np.asarray(obs_pt)
    oc = np.asarray(obs_cam)
    om = np.asarray(obs_mask)
    O = op.shape[0]
    live = np.nonzero(om)[0]
    w_idx = np.full((num_cams, num_landmarks), O, np.int32)
    w_idx[oc[live], op[live]] = live
    return w_idx


def _bucket(n: int, steps: int = 4) -> int:
    """Size bucket >= n with ``steps`` subdivisions per power-of-two
    octave (min 256); steps=1 gives pure powers of two."""
    if n <= 256:
        return 256
    p = 1 << (n - 1).bit_length()
    if steps > 1:
        base = p // (2 * steps)
        for num in range(steps + 1, 2 * steps):
            cand = base * num
            if n <= cand:
                return cand
    return p


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def compact_problem(prob: BAProblem, bucket_steps: int = 4):
    """Host-side compaction: drop masked observations, landmarks with no
    live observation and cameras with no live observation, bucket the
    trailing pads, and return (compact_problem, used_landmarks,
    used_cameras, n_live_obs). Cameras bucket to multiples of 16."""
    dev = prob.cam_params.device
    om = _np(prob.obs_mask).astype(bool)
    live = np.nonzero(om)[0]
    op = _np(prob.obs_pt)[live]
    oc = _np(prob.obs_cam)[live]
    uv = _np(prob.obs_uv)[live]
    used = np.unique(op)
    used_cams = np.unique(oc)
    L_c = _bucket(max(int(used.size), 1), bucket_steps)
    O_c = _bucket(max(int(live.size), 1), bucket_steps)
    C_c = min(prob.cam_params.shape[0], max(16, -(-int(used_cams.size) // 16) * 16))
    remap = np.zeros(prob.points.shape[0], np.int32)
    remap[used] = np.arange(used.size, dtype=np.int32)
    cremap = np.zeros(prob.cam_params.shape[0], np.int32)
    cremap[used_cams] = np.arange(used_cams.size, dtype=np.int32)
    n = live.size
    obs_pt = np.zeros(O_c, np.int32)
    obs_cam = np.zeros(O_c, np.int32)
    obs_uv = np.zeros((O_c, 2), np.float32)
    obs_mask = np.zeros(O_c, bool)
    obs_pt[:n] = remap[op]
    obs_cam[:n] = cremap[oc]
    obs_uv[:n] = uv
    obs_mask[:n] = True
    pts = np.zeros((L_c, 3), np.float32)
    pts[:used.size] = _np(prob.points)[used]
    cams = np.zeros((C_c, 12), np.float32)
    cams[:used_cams.size] = _np(prob.cam_params)[used_cams]
    cfree = np.zeros((C_c, 12), np.float32)
    cfree[:used_cams.size] = _np(prob.cam_free)[used_cams]
    t = lambda a: torch.as_tensor(a, device=dev)
    cprob = BAProblem(cam_params=t(cams), points=t(pts), obs_cam=t(obs_cam),
                      obs_pt=t(obs_pt), obs_uv=t(obs_uv), obs_mask=t(obs_mask),
                      cam_free=t(cfree))
    return cprob, used, used_cams, int(n)


def _resid(cam: torch.Tensor, pt: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Reprojection residual [du, dv] (BundleAdjuster.h:26-58 parity),
    batched over leading dims: cam (..., 12) [aa, t, fx, fy, cx, cy, k1,
    k2]; pt (..., 3); uv (..., 2) -> (..., 2).

    Every intermediate keeps a trailing axis: forward-mode AD of 0-dim
    tensors mixed with Python scalars promotes tangents to float64.
    """
    def c(k):
        return cam[..., k:k + 1]
    aa, t = cam[..., 0:3], cam[..., 3:6]
    theta2 = c(0) * c(0) + c(1) * c(1) + c(2) * c(2)
    theta = torch.sqrt(theta2 + 1e-20)
    w = aa / theta
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    px, py, pz = pt[..., 0:1], pt[..., 1:2], pt[..., 2:3]
    w0, w1, w2 = w[..., 0:1], w[..., 1:2], w[..., 2:3]
    wxp = torch.cat([w1 * pz - w2 * py, w2 * px - w0 * pz, w0 * py - w1 * px], dim=-1)
    aaxp = torch.cat([c(1) * pz - c(2) * py, c(2) * px - c(0) * pz,
                      c(0) * py - c(1) * px], dim=-1)
    wdp = w0 * px + w1 * py + w2 * pz
    rot = pt * cos_t + wxp * sin_t + w * (wdp * (1.0 - cos_t))
    rot = torch.where(theta2 < 1e-12, pt + aaxp, rot)
    p = rot + t
    pz_ = p[..., 2:3]
    z = torch.where(torch.abs(pz_) < 1e-8, torch.full_like(pz_, 1e-8), pz_)
    x = p[..., 0:1] / z
    y = p[..., 1:2] / z
    r = x * x + y * y
    d = c(10) * r + c(11) * r * r
    u = c(6) * (x + d) + c(8)
    v = c(7) * (y + d) + c(9)
    return torch.cat([u - uv[..., 0:1], v - uv[..., 1:2]], dim=-1)


_jac = torch.func.vmap(torch.func.jacfwd(_resid, argnums=(0, 1)))


def _huber(s: torch.Tensor, huber_delta: float) -> torch.Tensor:
    if huber_delta > 0.0:
        d2 = huber_delta * huber_delta
        s = torch.where(s <= d2, s, 2.0 * huber_delta * torch.sqrt(s + 1e-20) - d2)
    return s


class _Layout(NamedTuple):
    onehot: torch.Tensor               # (O, C) float — live observation -> camera
    maskO: torch.Tensor                # (O,) float
    w_idx: torch.Tensor                # (C, L) long, sentinel O
    p_idx: Optional[torch.Tensor]      # (L, M) long, or None: sum through w_idx
    p_mask: Optional[torch.Tensor]     # (L, M) float


def _cost(prob: BAProblem, cam, pts, maskO, huber_delta: float) -> torch.Tensor:
    res = _resid(cam[prob.obs_cam], pts[prob.obs_pt], prob.obs_uv) * maskO[:, None]
    return 0.5 * torch.sum(_huber(torch.sum(res * res, dim=-1), huber_delta))


def _normal_blocks(prob: BAProblem, lay: _Layout, cam, pts, huber_delta: float,
                   block_dtype: str = "float32"):
    """Damping-independent normal-equation pieces, built once per outer
    LM iteration: g_c (C,12), g_p (3,L), H_cc (C,12,12), H_pp (9,L) and
    the coupling W (C,12,3,L).

    ``block_dtype``: ``"bfloat16"`` or ``"w16"`` round the per-observation
    coupling blocks to bfloat16 before the gather (W is then bfloat16),
    ``"bfloat16"`` or ``"hcc16"`` round the per-observation camera
    Hessian blocks before the camera sum, which accumulates in float32;
    any other value is float32, as in the JAX package. H_pp and g_p stay
    float32."""
    camO = cam[prob.obs_cam]
    ptO = pts[prob.obs_pt]
    res = _resid(camO, ptO, prob.obs_uv) * lay.maskO[:, None]       # (O, 2)
    Jc, Jp = _jac(camO, ptO, prob.obs_uv)                           # (O,2,12), (O,2,3)
    m = lay.maskO[:, None, None]
    Jc = Jc * m * prob.cam_free[prob.obs_cam][:, None, :]
    Jp = Jp * m
    if huber_delta > 0.0:
        e = torch.sqrt(torch.sum(res * res, dim=-1) + 1e-20)
        w = torch.sqrt(torch.clamp(huber_delta / e, max=1.0))       # (O,)
        res = res * w[:, None]
        Jc = Jc * w[:, None, None]
        Jp = Jp * w[:, None, None]
    O = res.shape[0]
    C = cam.shape[0]
    L = pts.shape[0]
    jtr_c = torch.einsum("ori,or->oi", Jc, res)                     # (O, 12)
    hcc_o = torch.einsum("ori,orj->oij", Jc, Jc).reshape(O, 144)
    if block_dtype in ("bfloat16", "hcc16"):
        hcc_o = _round_bf16(hcc_o)
    g_c = lay.onehot.T @ jtr_c                                      # (C, 12)
    H_cc = (lay.onehot.T @ hcc_o).reshape(C, 12, 12)
    Y = torch.einsum("ori,orj->oij", Jc, Jp).reshape(O, 36)         # (O, 36)
    w16 = block_dtype in ("bfloat16", "w16")
    if w16:
        Y = _round_bf16(Y)
    hpp_o = torch.einsum("ori,orj->oij", Jp, Jp).reshape(O, 9)
    gp_o = torch.einsum("ori,or->oi", Jp, res)                      # (O, 3)
    src = torch.cat([Y, hpp_o, gp_o], dim=1)                        # (O, 48)
    src = torch.cat([src, torch.zeros_like(src[:1])], dim=0)        # sentinel row O
    if lay.p_idx is None:
        # one (C, L) gather carries the coupling AND the point-side rows;
        # the camera-sum of the latter is the per-landmark sum
        G = src[lay.w_idx]                                          # (C, L, 48)
        W = G[..., :36].reshape(C, L, 12, 3).permute(0, 2, 3, 1)
        pt_sum = torch.sum(G[..., 36:], dim=0)                      # (L, 12)
    else:
        W = src[lay.w_idx, :36].reshape(C, L, 12, 3).permute(0, 2, 3, 1)
        pt_sum = torch.sum(src[lay.p_idx, 36:] * lay.p_mask[..., None], dim=1)
    if w16:
        W = W.to(torch.bfloat16)        # exact: the values are bf16 already
    return g_c, pt_sum[:, 9:].T.contiguous(), H_cc, pt_sum[:, :9].T.contiguous(), W


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (nearest even) and held in float32."""
    return x.to(torch.bfloat16).to(x.dtype)


def schur_mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in float32 for one of the Schur step's W-sized products.

    bfloat16 operands (a bf16 ``block_dtype``) multiply exactly in float32
    and accumulate there, whatever ``precision`` says. On the CPU every
    precision is a plain float32 product, as XLA:CPU computes them. On the
    card ``'highest'`` and ``'high'`` are float32 products with TF32 off
    (3xTF32, the counterpart of the TPU's three bf16 passes, was no faster
    on an H100 and took twice the memory; see ``PERF.md``) and
    ``'default'`` rounds the operands to bfloat16 first: one bf16 pass
    with float32 accumulation."""
    if precision not in SCHUR_PRECISIONS:
        raise ValueError(f"schur_precision must be one of {SCHUR_PRECISIONS}, "
                         f"got {precision!r}")
    a, b = a.float(), b.float()
    if precision == "default" and a.device.type == "cuda":
        a, b = _round_bf16(a), _round_bf16(b)
    return a @ b


def _inv3x3_soa(h9: torch.Tensor) -> torch.Tensor:
    """Adjugate inverse of SPD 3x3 blocks stored as (9, L) rows
    [a b c d e f g h i]."""
    a, b, c, d, e, f, g, h, i = h9
    A = e * i - f * h
    B = c * h - b * i
    Cc = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    return torch.stack([A, B, Cc, D, E, F, G, H, I]) / det


def _damped_schur_step(cam_free, blocks, lam, damping: str, precision: str = "highest"):
    """Damped Schur-complement solve from prebuilt blocks:
    returns (d_cam (C,12), d_pt (L,3), predicted_reduction).

    ``precision`` is the three W-sized products' (``schur_mm``). A
    bfloat16 W (``block_dtype``) takes Hpp^-1 in bfloat16, builds B = W
    Hpp^-1 in bfloat16 and rounds g_p and the camera step to bfloat16 for
    the products with W and B, as the JAX package does."""
    g_c, g_pL, H_cc, H_ppL, W = blocks
    C = g_c.shape[0]
    L = g_pL.shape[1]
    n = C * 12
    dtype, dev = g_c.dtype, g_c.device
    eye12 = torch.eye(12, dtype=dtype, device=dev)
    fixed_c = 1.0 - cam_free
    diag3 = [0, 4, 8]
    if damping == "marquardt":
        dc = lam * torch.clamp(torch.diagonal(H_cc, dim1=1, dim2=2), 1e-6, 1e32)
        dp = lam * torch.clamp(H_ppL[diag3], 1e-6, 1e32) + 1e-8
    else:
        dc = torch.full((C, 12), 1.0, dtype=dtype, device=dev) * lam
        dp = torch.full((3, L), 1.0, dtype=dtype, device=dev) * lam + 1e-8
    H_cc_d = H_cc + dc[:, :, None] * eye12 + fixed_c[:, :, None] * eye12
    H_pp_d = H_ppL.clone()
    H_pp_d[diag3] = H_pp_d[diag3] + dp
    Hinv = _inv3x3_soa(H_pp_d).reshape(3, 3, L)

    wd = W.dtype
    Hinv_w = Hinv.to(wd)
    B = (W[:, :, 0, None, :] * Hinv_w[0][None, None]
         + W[:, :, 1, None, :] * Hinv_w[1][None, None]
         + W[:, :, 2, None, :] * Hinv_w[2][None, None])
    Wf = W.reshape(n, 3 * L)
    Bf = B.reshape(n, 3 * L)
    S = -schur_mm(Bf, Wf.T, precision)
    ci = torch.arange(C, device=dev)
    S = S.reshape(C, 12, C, 12)
    S[ci, :, ci, :] = S[ci, :, ci, :] + H_cc_d
    S = S.reshape(n, n)
    rhs = -(g_c.reshape(-1) - schur_mm(Bf, g_pL.reshape(-1).to(wd), precision))
    chol, info = torch.linalg.cholesky_ex(S)
    d_cam = torch.cholesky_solve(rhs[:, None], chol)[:, 0] * cam_free.reshape(-1)
    # a failed factorization gives a NaN step, whose cost the LM loop rejects
    d_cam = torch.where(info == 0, d_cam, float("nan"))

    Wt_dc = schur_mm(d_cam.to(wd), Wf, precision).reshape(3, L)
    t = g_pL + Wt_dc
    d_ptT = -(Hinv[:, 0] * t[0] + Hinv[:, 1] * t[1] + Hinv[:, 2] * t[2])
    pred = 0.5 * (torch.sum(d_cam * d_cam * dc.reshape(-1))
                  + torch.sum(d_ptT * d_ptT * dp)
                  - torch.dot(d_cam, g_c.reshape(-1))
                  - torch.sum(d_ptT * g_pL))
    return d_cam.reshape(C, 12), d_ptT.T, pred


def _layout(prob: BAProblem, host_obs=None) -> _Layout:
    dev = prob.cam_params.device
    C = prob.cam_params.shape[0]
    L = prob.points.shape[0]
    if host_obs is not None:
        h_pt, h_cam, h_mask = (np.asarray(a) for a in host_obs)
    else:
        h_pt, h_cam, h_mask = _np(prob.obs_pt), _np(prob.obs_cam), _np(prob.obs_mask)
    w_idx = coupling_gather_table(h_pt, h_cam, h_mask, C, L)
    p_idx, _, p_mask = landmark_major_layout(h_pt, h_cam, h_mask, L)
    maskO = prob.obs_mask.to(prob.cam_params.dtype)
    onehot = ((prob.obs_cam.long()[:, None] == torch.arange(C, device=dev))
              & prob.obs_mask[:, None]).to(prob.cam_params.dtype)
    # The point-side sums ride the (C, L) coupling gather unless the
    # (L, M) landmark-major table is much smaller (many cameras) — the
    # reference solver's routing rule, kept because the two routes differ
    # where one camera observes a landmark twice: the (C, L) table holds
    # one of the two observations.
    use_pidx = p_idx.size < 0.7 * w_idx.size
    return _Layout(onehot=onehot, maskO=maskO,
                   w_idx=torch.as_tensor(w_idx, device=dev).long(),
                   p_idx=torch.as_tensor(p_idx, device=dev).long() if use_pidx else None,
                   p_mask=torch.as_tensor(p_mask, device=dev) if use_pidx else None)


def _solve_core(prob: BAProblem, lay: _Layout, max_iters: int, init_lambda: float,
                ftol: float, focal_upper_bound: float, max_retries: int,
                huber_delta: float, damping: str, schedule: str,
                lambda_up: float, lambda_down: float, block_dtype: str,
                schur_precision: str) -> BAResult:
    dtype, dev = prob.cam_params.dtype, prob.cam_params.device
    prob = prob._replace(obs_cam=prob.obs_cam.long(), obs_pt=prob.obs_pt.long())

    def cost_of(cam, pts):
        return _cost(prob, cam, pts, lay.maskO, huber_delta)

    cam, pts = prob.cam_params, prob.points
    cost0 = cost_of(cam, pts)
    cost = cost0
    lam = torch.tensor(init_lambda, dtype=dtype, device=dev)
    trace = torch.full((max_iters,), float("inf"), dtype=dtype, device=dev)
    two = torch.tensor(2.0, dtype=dtype, device=dev)
    it = 0
    while it < max_iters:
        blocks = _normal_blocks(prob, lay, cam, pts, huber_delta, block_dtype)
        lam_i, nu = lam, two
        accepted = torch.tensor(False, device=dev)
        best_cam, best_pts, best_cost, lam_next = cam, pts, cost, lam
        # fixed-budget damped trials; once one is accepted, later trials
        # leave the state as it is (the TPU package's retry while_loop)
        for _ in range(max_retries):
            d_cam, d_pt, pred = _damped_schur_step(prob.cam_free, blocks, lam_i, damping,
                                                   schur_precision)
            cam_new = cam + d_cam
            cam_new = torch.cat([cam_new[:, :6],
                                 torch.clamp(cam_new[:, 6:8], max=focal_upper_bound),
                                 cam_new[:, 8:]], dim=1)
            pts_new = pts + d_pt
            new_cost = cost_of(cam_new, pts_new)
            good = (new_cost < cost) & torch.isfinite(new_cost) & ~accepted
            if schedule == "nielsen":
                rho = (cost - new_cost) / torch.clamp(pred, min=1e-20)
                shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
                lam_acc = torch.clamp(lam_i * shrink, min=1e-12)
                lam_rej = lam_i * nu
                nu_new = torch.where(good, two, nu * 2.0)
            else:
                lam_acc = torch.clamp(lam_i / lambda_down, min=1e-12)
                lam_rej = lam_i * lambda_up
                nu_new = nu
            best_cam = torch.where(good, cam_new, best_cam)
            best_pts = torch.where(good, pts_new, best_pts)
            best_cost = torch.where(good, new_cost, best_cost)
            lam_next = torch.where(accepted, lam_next, torch.where(good, lam_acc, lam_rej))
            nu = torch.where(accepted, nu, nu_new)
            lam_i = torch.where(accepted | good, lam_i, lam_rej)
            accepted = accepted | good
        cam = torch.where(accepted, best_cam, cam)
        pts = torch.where(accepted, best_pts, pts)
        lam = lam_next
        rel_drop = (cost - best_cost) / torch.clamp(cost, min=1e-12)
        done = (accepted & (rel_drop < ftol) & (rel_drop >= 0)) | (lam > 1e10)
        cost = torch.where(accepted, best_cost, cost)
        trace[it] = cost
        it += 1
        if bool(done):
            break
    trace = torch.cummin(torch.where(torch.isfinite(trace), trace, cost), dim=0).values
    return BAResult(cam_params=cam, points=pts, cost_initial=cost0,
                    cost_final=cost, iterations=it, cost_trace=trace)


def solve(prob: BAProblem, max_iters: int = 50, init_lambda: float = 1e-3,
          lambda_up: float = 4.0, lambda_down: float = 2.0,
          ftol: float = 1e-6, focal_upper_bound: float = 1000.0,
          max_retries: int = 1, huber_delta: float = 0.0,
          damping: str = "marquardt", schedule: str = "nielsen",
          compact: bool = True, block_dtype: str = "float32",
          schur_precision: str = "high", bucket_steps: int = 4,
          host_obs=None) -> BAResult:
    """Run damped LM to convergence (or max_iters) on the problem's device.

    The Jacobian/normal blocks are built once per outer iteration; an
    inner fixed budget of ``max_retries`` damped trials escalates lambda
    until a step is accepted (``max_retries=1``: every damped trial is its
    own outer iteration, as Ceres counts unsuccessful steps).

    ``compact=True`` strips masked observations / dead landmarks / unused
    cameras host-side before solving and scatters results back to the
    caller's shapes; ``host_obs`` passes numpy copies of (obs_pt, obs_cam,
    obs_mask) for the host-built gather tables of a problem that is
    already compact. ``ftol`` matches Ceres's function_tolerance default
    (1e-6), which the reference inherits (BundleAdjuster.cpp:131-142).

    ``block_dtype`` (``"float32"``, ``"bfloat16"``, ``"w16"``,
    ``"hcc16"``; see ``_normal_blocks``) sets the storage of the
    Gauss-Newton blocks and ``schur_precision`` (``"highest"``,
    ``"high"``, ``"default"``; see ``schur_mm``) the three W-sized
    products of the Schur step, with the JAX package's names and
    defaults. The JAX package keeps ``block_dtype="float32"`` (bf16
    storage stalled its 100-camera problem) and runs ``"high"``, which it
    found at converged-cost parity; ``scripts/check_ba_variants.py``
    compares them.
    """
    kw = dict(max_iters=max_iters, init_lambda=init_lambda, ftol=ftol,
              focal_upper_bound=focal_upper_bound, max_retries=max_retries,
              huber_delta=huber_delta, damping=damping, schedule=schedule,
              lambda_up=lambda_up, lambda_down=lambda_down, block_dtype=block_dtype,
              schur_precision=schur_precision)
    if not compact:
        return _solve_core(prob, _layout(prob, host_obs), **kw)
    cprob, used, used_cams, _ = compact_problem(prob, bucket_steps)
    res = _solve_core(cprob, _layout(cprob), **kw)
    dev = prob.points.device
    u = torch.as_tensor(used, device=dev).long()
    uc = torch.as_tensor(used_cams, device=dev).long()
    pts = prob.points.clone()
    pts[u] = res.points[:u.numel()]
    cams = prob.cam_params.clone()
    cams[uc] = res.cam_params[:uc.numel()]
    return res._replace(points=pts, cam_params=cams)
