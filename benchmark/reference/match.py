"""Plain reference of gated matching: exact top-2 descriptor matching with
Lowe's ratio test and the mutual check, then the epipolar gate (a batched
8-point fundamental RANSAC) on the same random draws, then the fold into
match tables.

The matcher computes every squared distance in float64 from descriptors
rounded to the precision the configuration states (bfloat16: its products
are exact there), so it is the answer that a bfloat16 matcher with exact
sums gives. The gate is a frozen copy of the arithmetic the engine
specifies for it (a scalarised 8-point solve by inverse iteration on the
normal matrix, closed-form rank-2 projection, Sampson scoring on every
``stride``-th slot, a guarded all-inlier refit), in float32, fed the same
raw draws. It imports no part of the engine.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from benchmark.reference.precision import rounder

INT32_MAX = 2 ** 31 - 1


def raw_draws(shape, device, generator: torch.Generator) -> torch.Tensor:
    """Uniform int32 draws in [0, 2^31 - 1), drawn as int64 and cast, as the
    engine draws them (the same call advances a generator by the same
    amount)."""
    return torch.randint(0, INT32_MAX, shape, generator=generator, device=device,
                         dtype=torch.int64).to(torch.int32)


def fitted_width(kp_mask: torch.Tensor) -> int:
    """Slots a matcher reads: the largest valid count over the images, rounded
    up to 256 (valid keypoints are a prefix of each image's slots)."""
    kt = int(kp_mask.sum(1).max()) if kp_mask.numel() else 0
    return max(256, -(-kt // 256) * 256)


# ---------------------------------------------------------------------------
# top-2 matching
# ---------------------------------------------------------------------------

def knn_match(desc: torch.Tensor, mask: torch.Tensor, pairs: torch.Tensor,
              ratio: float, cross_check: bool, precision: str = "bfloat16",
              pairs_per_batch: int = 8):
    """desc (N, K, D), mask (N, K), pairs (B, 2) -> (idx (B, K) int64, -1
    where unmatched; ok (B, K) bool)."""
    cast = rounder(precision)
    d = desc if cast is None else cast(desc)
    d = d.double()
    idx_out, ok_out = [], []
    for s in range(0, pairs.shape[0], pairs_per_batch):
        pc = pairs[s:s + pairs_per_batch].long()
        i, j = pc[:, 0], pc[:, 1]
        d2 = torch.clamp(2.0 - 2.0 * torch.matmul(d[i], d[j].transpose(1, 2)), min=0.0)
        d2 = torch.where(mask[i][:, :, None] & mask[j][:, None, :], d2, math.inf)
        nn = torch.argmin(d2, dim=2)
        best = torch.gather(d2, 2, nn[..., None])[..., 0]
        second = torch.amin(d2.scatter(2, nn[..., None], math.inf), dim=2)
        ok = (best < ratio * ratio * second) & mask[i] & torch.isfinite(best)
        if cross_check:
            rev = torch.argmin(d2, dim=1)
            rows = torch.arange(d2.shape[1], device=d2.device)
            ok = ok & (torch.gather(rev, 1, nn) == rows)
        idx_out.append(torch.where(ok, nn, -1))
        ok_out.append(ok)
    return torch.cat(idx_out), torch.cat(ok_out)


# ---------------------------------------------------------------------------
# the epipolar gate (float32)
# ---------------------------------------------------------------------------

def _cholesky(A):
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)
    S, cols = A, []
    for j in range(n):
        d = torch.sqrt(torch.clamp(S[..., j, j], min=1e-30))
        col = torch.where(rows >= j, S[..., :, j] / d[..., None], 0.0)
        S = S - col[..., :, None] * col[..., None, :]
        cols.append(col)
    return torch.stack(cols, dim=-1)


def _cho_solve(L, b):
    n = L.shape[-1]
    r, y = b, []
    for i in range(n):
        yi = r[..., i] / L[..., i, i]
        r = r - yi[..., None] * L[..., :, i]
        y.append(yi)
    r, x = torch.stack(y, dim=-1), [None] * n
    for i in range(n - 1, -1, -1):
        xi = r[..., i] / L[..., i, i]
        r = r - xi[..., None] * L[..., i, :]
        x[i] = xi
    return torch.stack(x, dim=-1)


def _normalize(x, y, w, wsum):
    cx = torch.sum(x * w, -1) / wsum
    cy = torch.sum(y * w, -1) / wsum
    d = torch.sqrt((x - cx[..., None]) ** 2 + (y - cy[..., None]) ** 2)
    s = math.sqrt(2.0) / torch.clamp(torch.sum(d * w, -1) / wsum, min=1e-12)
    return cx, cy, s


def _normal_matrix(x1, y1, x2, y2, w):
    rows = [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)]
    Au = torch.stack(rows, dim=-1)
    A = Au * w[..., None]
    if A.shape[-2] <= 16:
        M = A[..., 0, :, None] * Au[..., 0, None, :]
        for s in range(1, A.shape[-2]):
            M = M + A[..., s, :, None] * Au[..., s, None, :]
        return M
    return torch.einsum("...si,...sj->...ij", A, Au)


def _smallest_eigvec9(M, iters: int = 6):
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(9, dtype=M.dtype, device=M.device)
    L = _cholesky(M + (1e-7 * tr + 1e-30) * eye)
    v = (torch.ones(M.shape[:-2] + (9,), dtype=M.dtype, device=M.device)
         + 0.01 * torch.arange(9, dtype=M.dtype, device=M.device))
    for _ in range(iters):
        v = _cho_solve(L, v)
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
    return v


def _rank2(f):
    F = f.reshape(f.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=f.dtype, device=f.device)
    G = torch.einsum("...ki,...kj->...ij", F, F)
    q = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / 3.0
    Gq = G - q[..., None, None] * eye
    p = torch.sqrt(torch.clamp(torch.sum(Gq * Gq, (-2, -1)) / 6.0, min=1e-30))
    r = torch.clamp(torch.linalg.det(Gq / p[..., None, None]) / 2.0, -1.0, 1.0)
    lam = q + 2.0 * p * torch.cos(torch.arccos(r) / 3.0 + 2.0 * math.pi / 3.0)
    M = G - lam[..., None, None] * eye
    cs = torch.stack([torch.linalg.cross(M[..., 0, :], M[..., 1, :], dim=-1),
                      torch.linalg.cross(M[..., 0, :], M[..., 2, :], dim=-1),
                      torch.linalg.cross(M[..., 1, :], M[..., 2, :], dim=-1)], dim=-2)
    n2 = torch.sum(cs * cs, -1)
    best = torch.argmax(n2, dim=-1)
    v = torch.gather(cs, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=f.dtype, device=f.device)
    v = torch.where(torch.amax(n2, -1, keepdim=True) > 1e-20, v, ex.expand(v.shape))
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
    Fv = torch.einsum("...ij,...j->...i", F, v)
    return (F - Fv[..., :, None] * v[..., None, :]).reshape(f.shape)


def _denormalize(f, cx1, cy1, s1, cx2, cy2, s2):
    f00, f01, f02, f10, f11, f12, f20, f21, f22 = torch.unbind(f, dim=-1)
    g00, g01 = f00 * s1, f01 * s1
    g02 = -f00 * s1 * cx1 - f01 * s1 * cy1 + f02
    g10, g11 = f10 * s1, f11 * s1
    g12 = -f10 * s1 * cx1 - f11 * s1 * cy1 + f12
    g20, g21 = f20 * s1, f21 * s1
    g22 = -f20 * s1 * cx1 - f21 * s1 * cy1 + f22
    out = torch.stack([g00 * s2, g01 * s2, g02 * s2, g10 * s2, g11 * s2, g12 * s2,
                       -g00 * s2 * cx2 - g10 * s2 * cy2 + g20,
                       -g01 * s2 * cx2 - g11 * s2 * cy2 + g21,
                       -g02 * s2 * cx2 - g12 * s2 * cy2 + g22], dim=-1)
    return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-12)


def _sampson(f, x1, y1, x2, y2):
    f00, f01, f02, f10, f11, f12, f20, f21, f22 = (f[..., i, None] for i in range(9))
    l1 = f00 * x1 + f01 * y1 + f02
    l2 = f10 * x1 + f11 * y1 + f12
    l3 = f20 * x1 + f21 * y1 + f22
    m1 = f00 * x2 + f10 * y2 + f20
    m2 = f01 * x2 + f11 * y2 + f21
    e = x2 * l1 + y2 * l2 + l3
    return (e * e) / torch.clamp(l1 * l1 + l2 * l2 + m1 * m1 + m2 * m2, min=1e-12)


def _solve_f(x1, y1, x2, y2, w, wsum):
    cx1, cy1, s1 = _normalize(x1, y1, w, wsum)
    cx2, cy2, s2 = _normalize(x2, y2, w, wsum)
    M = _normal_matrix((x1 - cx1[..., None]) * s1[..., None],
                       (y1 - cy1[..., None]) * s1[..., None],
                       (x2 - cx2[..., None]) * s2[..., None],
                       (y2 - cy2[..., None]) * s2[..., None], w)
    return _denormalize(_rank2(_smallest_eigvec9(M)), cx1, cy1, s1, cx2, cy2, s2)


def fgate(pts1, pts2, mask, pos, thresh_px: float, stride: int):
    """Inlier masks (B, K) of the fundamental RANSAC gate on pts1/pts2 (B, K,
    2) float32 and mask (B, K), with raw draws ``pos`` (B, H, 8)."""
    B, K = mask.shape
    H = pos.shape[1]
    x1f, y1f, x2f, y2f = pts1[..., 0], pts1[..., 1], pts2[..., 0], pts2[..., 1]
    xs1, ys1, xs2, ys2 = (a[:, ::stride] for a in (x1f, y1f, x2f, y2f))
    ms = mask[:, ::stride]
    thr = thresh_px * thresh_px
    order = torch.argsort((~ms).to(torch.int8), dim=1, stable=True)
    n_valid = torch.clamp(ms.sum(dim=1), min=1).to(torch.int64)
    idx = torch.gather(order, 1, (pos.to(torch.int64) % n_valid[:, None, None]).reshape(B, -1))

    def g(a):
        return torch.gather(a, 1, idx).reshape(B, H, 8)
    f = _solve_f(g(xs1), g(ys1), g(xs2), g(ys2), torch.ones(B, H, 8, device=mask.device), 8.0)
    d = _sampson(f, xs1[:, None], ys1[:, None], xs2[:, None], ys2[:, None])
    best = torch.argmax(torch.sum((d < thr) & ms[:, None, :], dim=-1), dim=1)
    fb = torch.gather(f, 1, best[:, None, None].expand(B, 1, 9))[:, 0]
    inl_best = (_sampson(fb[:, None, :], x1f[:, None], y1f[:, None], x2f[:, None],
                         y2f[:, None])[:, 0] < thr) & mask
    w = inl_best.to(pts1.dtype)
    fr = _solve_f(x1f, y1f, x2f, y2f, w, torch.clamp(torch.sum(w, -1), min=1.0))
    inl_refit = (_sampson(fr[:, None, :], x1f[:, None], y1f[:, None], x2f[:, None],
                          y2f[:, None])[:, 0] < thr) & mask
    better = (torch.sum(inl_refit, dim=1) >= torch.sum(inl_best, dim=1))[:, None]
    return torch.where(better, inl_refit, inl_best)


# ---------------------------------------------------------------------------
# a whole pass
# ---------------------------------------------------------------------------

def match_tables(desc: torch.Tensor, mask: torch.Tensor, xy: torch.Tensor,
                 pairs: torch.Tensor, chunk: int, draws: Callable[[int], torch.Tensor],
                 ratio: float, cross_check: bool, num_hypotheses: int, thresh_px: float,
                 min_matches: int, precision: str = "bfloat16") -> torch.Tensor:
    """Gated match tables (P, Kt) int64 (-1 where no match) of every pair,
    processed in chunks of ``chunk`` pairs; ``draws(n)`` gives the (n, H, 8)
    raw draws of a chunk of n pairs, in chunk order."""
    kt = fitted_width(mask)
    desc, mask, xy = desc[:, :kt].float(), mask[:, :kt], xy[:, :kt].float()
    P = pairs.shape[0]
    out = torch.full((P, kt), -1, dtype=torch.int64, device=desc.device)
    stride = 4 if kt >= 1024 else 1
    for s0 in range(0, P, chunk):
        e = min(s0 + chunk, P)
        pos = draws(e - s0)
        if tuple(pos.shape) != (e - s0, num_hypotheses, 8):
            raise ValueError(f"draws {tuple(pos.shape)} for {e - s0} pairs")
        pc = pairs[s0:e].long()
        midx, ok = knn_match(desc, mask, pc, ratio, cross_check, precision)
        p1 = xy[pc[:, 0]]
        p2 = xy[pc[:, 1][:, None], torch.clamp(midx, 0, kt - 1)]
        inl = fgate(p1, p2, ok, pos, thresh_px, stride)
        keep = torch.where((ok.sum(1) >= min_matches)[:, None], inl & ok, ok)
        out[s0:e] = torch.where(keep, midx, -1)
    return out


def compare_tables(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Slots on which two sets of tables (P, >= Kt) and (P, Kt) differ, as a
    share of the slots that either matches; got's slots past Kt must be -1.
    Returns {"slot_mismatch": share, "pair_mismatch": share of pairs with any
    difference, "matched_slots": count}."""
    kt = ref.shape[1]
    extra = (got[:, kt:] >= 0).sum(1) if got.shape[1] > kt else torch.zeros_like(ref[:, 0])
    g = got[:, :kt]
    diff = (g != ref).sum(1) + extra
    either = ((g >= 0) | (ref >= 0)).sum(1) + extra
    n_either = int(either.sum())
    return {"slot_mismatch": float(diff.sum()) / max(n_either, 1),
            "pair_mismatch": float((diff > 0).sum()) / max(ref.shape[0], 1),
            "matched_slots": n_either}
