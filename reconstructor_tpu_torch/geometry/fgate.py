"""Scalarized batched fundamental-RANSAC for the per-pair epipolar gate.

8-point hypotheses, Sampson scoring and an inlier-guarded all-inlier
refit (GeometricFilter.cpp:39-61 equivalent), laid out as elementwise
arithmetic over the (B, H[, S]) batch with the nine F entries carried as
separate scalars — no per-hypothesis tiny matmuls. The same arithmetic as
``reconstructor_tpu.geometry.fgate`` in the same order, so fed the same
draws it returns the same inlier masks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from reconstructor_tpu_torch.geometry.linalg import cholesky_unrolled, cho_solve_unrolled
from reconstructor_tpu_torch.geometry.ransac import raw_draws
from reconstructor_tpu_torch.utils import profiling


def _normalize(x, y, w, wsum):
    """Weighted Hartley normalization stats. x, y, w: (..., S)."""
    cx = torch.sum(x * w, -1) / wsum
    cy = torch.sum(y * w, -1) / wsum
    d = torch.sqrt((x - cx[..., None]) ** 2 + (y - cy[..., None]) ** 2)
    s = math.sqrt(2.0) / torch.clamp(torch.sum(d * w, -1) / wsum, min=1e-12)
    return cx, cy, s


def _normal_matrix(x1, y1, x2, y2, w):
    """Sum_s w_s a_s a_s^T for the 8-point rows a = [x2x1, x2y1, x2, y2x1,
    y2y1, y2, x1, y1, 1]; returns (..., 9, 9)."""
    ones = torch.ones_like(x1)
    rows = [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones]
    A = torch.stack(rows, dim=-1) * w[..., None]          # (..., S, 9)
    Au = torch.stack(rows, dim=-1)
    S = A.shape[-2]
    if S <= 16:
        # minimal samples: explicit sum of rank-1 outer products over S
        M = A[..., 0, :, None] * Au[..., 0, None, :]
        for s in range(1, S):
            M = M + A[..., s, :, None] * Au[..., s, None, :]
        return M
    return torch.einsum("...si,...sj->...ij", A, Au)


def _smallest_eigvec9(M, iters: int = 6):
    """Inverse iteration on the ridge-regularized 9x9 (see linalg)."""
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(9, dtype=M.dtype, device=M.device)
    L = cholesky_unrolled(M + (1e-7 * tr + 1e-30) * eye)
    v = torch.ones(M.shape[:-2] + (9,), dtype=M.dtype, device=M.device) + \
        0.01 * torch.arange(9, dtype=M.dtype, device=M.device)
    for _ in range(iters):
        v = cho_solve_unrolled(L, v)
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
    return v


def _rank2_project9(f):
    """Closed-form rank-2 projection of F given as (..., 9) flat entries:
    v3 = smallest eigenvector of F^T F, F <- F (I - v3 v3^T)."""
    F = f.reshape(f.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=f.dtype, device=f.device)
    G = torch.einsum("...ki,...kj->...ij", F, F)
    q = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / 3.0
    Gq = G - q[..., None, None] * eye
    p = torch.sqrt(torch.clamp(torch.sum(Gq * Gq, (-2, -1)) / 6.0, min=1e-30))
    Bm = Gq / p[..., None, None]
    r = torch.clamp(torch.linalg.det(Bm) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    M = G - lam[..., None, None] * eye
    c01 = torch.linalg.cross(M[..., 0, :], M[..., 1, :], dim=-1)
    c02 = torch.linalg.cross(M[..., 0, :], M[..., 2, :], dim=-1)
    c12 = torch.linalg.cross(M[..., 1, :], M[..., 2, :], dim=-1)
    cs = torch.stack([c01, c02, c12], dim=-2)
    n2 = torch.sum(cs * cs, -1)
    best = torch.argmax(n2, dim=-1)
    v = torch.gather(cs, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=f.dtype, device=f.device)
    v = torch.where(torch.amax(n2, -1, keepdim=True) > 1e-20, v, ex.expand(v.shape))
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
    Fv = torch.einsum("...ij,...j->...i", F, v)
    F2 = F - Fv[..., :, None] * v[..., None, :]
    return F2.reshape(f.shape)


def _denormalize9(f, cx1, cy1, s1, cx2, cy2, s2):
    """F' = T2^T F T1 for Hartley T = [[s,0,-s cx],[0,s,-s cy],[0,0,1]],
    expanded to scalar arithmetic. f: (..., 9); stats broadcast over f."""
    f00, f01, f02, f10, f11, f12, f20, f21, f22 = torch.unbind(f, dim=-1)
    g00 = f00 * s1
    g01 = f01 * s1
    g02 = -f00 * s1 * cx1 - f01 * s1 * cy1 + f02
    g10 = f10 * s1
    g11 = f11 * s1
    g12 = -f10 * s1 * cx1 - f11 * s1 * cy1 + f12
    g20 = f20 * s1
    g21 = f21 * s1
    g22 = -f20 * s1 * cx1 - f21 * s1 * cy1 + f22
    h00 = g00 * s2
    h01 = g01 * s2
    h02 = g02 * s2
    h10 = g10 * s2
    h11 = g11 * s2
    h12 = g12 * s2
    h20 = -g00 * s2 * cx2 - g10 * s2 * cy2 + g20
    h21 = -g01 * s2 * cx2 - g11 * s2 * cy2 + g21
    h22 = -g02 * s2 * cx2 - g12 * s2 * cy2 + g22
    out = torch.stack([h00, h01, h02, h10, h11, h12, h20, h21, h22], dim=-1)
    return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-12)


def _sampson9(f, x1, y1, x2, y2):
    """Sampson distance with F as (..., 9) scalars; points (..., S)."""
    f00, f01, f02, f10, f11, f12, f20, f21, f22 = (f[..., i, None] for i in range(9))
    l1 = f00 * x1 + f01 * y1 + f02
    l2 = f10 * x1 + f11 * y1 + f12
    l3 = f20 * x1 + f21 * y1 + f22
    m1 = f00 * x2 + f10 * y2 + f20
    m2 = f01 * x2 + f11 * y2 + f21
    e = x2 * l1 + y2 * l2 + l3
    denom = l1 * l1 + l2 * l2 + m1 * m1 + m2 * m2
    return (e * e) / torch.clamp(denom, min=1e-12)


def _solve_f9(x1, y1, x2, y2, w, wsum):
    """Weighted normalized 8-point solve; returns (..., 9) flat F."""
    cx1, cy1, s1 = _normalize(x1, y1, w, wsum)
    cx2, cy2, s2 = _normalize(x2, y2, w, wsum)
    nx1 = (x1 - cx1[..., None]) * s1[..., None]
    ny1 = (y1 - cy1[..., None]) * s1[..., None]
    nx2 = (x2 - cx2[..., None]) * s2[..., None]
    ny2 = (y2 - cy2[..., None]) * s2[..., None]
    M = _normal_matrix(nx1, ny1, nx2, ny2, w)
    fn = _smallest_eigvec9(M)
    fn = _rank2_project9(fn)
    return _denormalize9(fn, cx1, cy1, s1, cx2, cy2, s2)


def filter_pairs_scalarized(pts1: torch.Tensor, pts2: torch.Tensor,
                            mask: torch.Tensor, num_hypotheses: int,
                            thresh_px: float, stride: int = 1,
                            generator: Optional[torch.Generator] = None,
                            pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched per-pair F-RANSAC gate. pts1/pts2 (B, K, 2); mask (B, K).
    ``pos``: optional (B, H, 8) raw draws (see geometry.ransac); drawn
    from ``generator`` otherwise. Returns inlier masks (B, K).

    Model selection runs on every ``stride``-th match slot; the winning F
    — after an all-inlier refit kept only if it scores at least as well —
    then classifies every slot once.
    """
    B, K = mask.shape
    H = num_hypotheses
    x1f, y1f = pts1[..., 0], pts1[..., 1]
    x2f, y2f = pts2[..., 0], pts2[..., 1]
    xs1, ys1 = x1f[:, ::stride], y1f[:, ::stride]
    xs2, ys2 = x2f[:, ::stride], y2f[:, ::stride]
    ms = mask[:, ::stride]
    thr = thresh_px * thresh_px

    # ---- sampling: compacted valid indices, uniform draws --------------
    with profiling.annotate("match.fgate.sample"):
        order = torch.argsort((~ms).to(torch.int8), dim=1, stable=True)
        n_valid = torch.clamp(ms.sum(dim=1), min=1).to(torch.int64)
        if pos is None:
            pos = raw_draws((B, H, 8), mask.device, generator)
        pos = pos.to(torch.int64) % n_valid[:, None, None]
        idx = torch.gather(order, 1, pos.reshape(B, -1))         # (B, H*8)

        def g(a):
            return torch.gather(a, 1, idx).reshape(B, H, 8)
        hx1, hy1, hx2, hy2 = g(xs1), g(ys1), g(xs2), g(ys2)

    # ---- hypothesis solve + scoring ------------------------------------
    with profiling.annotate("match.fgate.hypotheses"):
        w8 = torch.ones_like(hx1)
        f = _solve_f9(hx1, hy1, hx2, hy2, w8, 8.0)                # (B, H, 9)
        d = _sampson9(f, xs1[:, None], ys1[:, None], xs2[:, None], ys2[:, None])
        counts = torch.sum((d < thr) & ms[:, None, :], dim=-1)   # (B, H)
        best = torch.argmax(counts, dim=1)
        fb = torch.gather(f, 1, best[:, None, None].expand(B, 1, 9))[:, 0]

    # ---- classify every slot with the winner ---------------------------
    with profiling.annotate("match.fgate.refit"):
        d_best = _sampson9(fb[:, None, :], x1f[:, None], y1f[:, None],
                           x2f[:, None], y2f[:, None])[:, 0]
        inl_best = (d_best < thr) & mask
        cnt_best = torch.sum(inl_best, dim=1)

        # ---- guarded all-inlier refit ----------------------------------
        w = inl_best.to(pts1.dtype)
        fr = _solve_f9(x1f, y1f, x2f, y2f, w, torch.clamp(torch.sum(w, -1), min=1.0))
        d_refit = _sampson9(fr[:, None, :], x1f[:, None], y1f[:, None],
                            x2f[:, None], y2f[:, None])[:, 0]
        inl_refit = (d_refit < thr) & mask
        better = (torch.sum(inl_refit, dim=1) >= cnt_best)[:, None]
        return torch.where(better, inl_refit, inl_best)
