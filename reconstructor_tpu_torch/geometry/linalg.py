"""Small-matrix linear algebra helpers for batched hypothesis solves.

The RANSAC minimal solvers need one thing from dense linear algebra: the
smallest eigenvector of a tiny PSD normal matrix (9x9 for F/E/H, 12x12
for PnP), across thousands of hypotheses at once. Inverse iteration
converges to it in a handful of steps and batches trivially; the PSD
structure lets it Cholesky-factor ONCE with an unrolled right-looking
update (n steps of rank-1 outer products, each a batch-wide elementwise
op) and back/forward-substitute with unrolled triangular solves. The
same arithmetic as ``reconstructor_tpu.geometry.linalg``, in the same
order, so both packages pick the same RANSAC winners from the same
minimal samples.
"""

from __future__ import annotations

import math

import torch


def cholesky_unrolled(A: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky of a small SPD matrix via an unrolled
    right-looking (outer-product) elimination.

    A: (..., n, n) SPD. Returns lower-triangular L with A = L L^T.
    No pivoting (SPD input is assumed ridge-regularized).
    """
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)
    S = A
    cols = []
    for j in range(n):
        d = torch.sqrt(torch.clamp(S[..., j, j], min=1e-30))
        col = S[..., :, j] / d[..., None]
        col = torch.where(rows >= j, col, 0.0)
        S = S - col[..., :, None] * col[..., None, :]
        cols.append(col)
    return torch.stack(cols, dim=-1)


def cho_solve_unrolled(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b with unrolled forward/backward substitution.

    L: (..., n, n) lower-triangular; b: (..., n).
    """
    n = L.shape[-1]
    r = b
    y = []
    for i in range(n):
        yi = r[..., i] / L[..., i, i]
        r = r - yi[..., None] * L[..., :, i]
        y.append(yi)
    y = torch.stack(y, dim=-1)
    r = y
    x = [None] * n
    for i in range(n - 1, -1, -1):
        xi = r[..., i] / L[..., i, i]
        r = r - xi[..., None] * L[..., i, :]
        x[i] = xi
    return torch.stack(x, dim=-1)


def smallest_eigvec(A: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Smallest-eigenvalue eigenvector of a symmetric PSD matrix.

    A: (..., n, n). Returns (..., n), unit norm. Inverse iteration with a
    spectrum-relative ridge; the factorization is computed once and
    reused across iterations.
    """
    n = A.shape[-1]
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    ridge = 1e-7 * tr + 1e-30
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    L = cholesky_unrolled(A + ridge * eye)
    x = torch.ones(A.shape[:-2] + (n,), dtype=A.dtype, device=A.device) + \
        0.01 * torch.arange(n, dtype=A.dtype, device=A.device)
    for _ in range(iters):
        x = cho_solve_unrolled(L, x)
        x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-30)
    return x


def smallest_eigvec_3x3_sym(A: torch.Tensor) -> torch.Tensor:
    """Closed-form smallest eigenvector of symmetric 3x3 matrices.

    Eigenvalue by the trigonometric (Kahan-stable) characteristic-
    polynomial formula; eigenvector as the largest cross product of rows
    of A - lambda_min I. Degenerate (repeated eigenvalue) inputs fall back
    through extra cross-product candidates; any vector of the eigenspace
    is a correct answer there.

    A: (..., 3, 3) symmetric. Returns (..., 3), unit norm.
    """
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    off = A[..., 0, 1] ** 2 + A[..., 0, 2] ** 2 + A[..., 1, 2] ** 2
    p2 = ((A[..., 0, 0] - q) ** 2 + (A[..., 1, 1] - q) ** 2
          + (A[..., 2, 2] - q) ** 2 + 2.0 * off)
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    B = (A - q[..., None, None] * eye) / p[..., None, None]
    r = torch.clamp(torch.linalg.det(B) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    M = A - lam_min[..., None, None] * eye
    scale2 = torch.sum(M * M, dim=(-2, -1)) + 1e-30

    crosses = torch.stack([torch.linalg.cross(M[..., 0, :], M[..., 1, :], dim=-1),
                           torch.linalg.cross(M[..., 0, :], M[..., 2, :], dim=-1),
                           torch.linalg.cross(M[..., 1, :], M[..., 2, :], dim=-1)],
                          dim=-2)
    cn = torch.linalg.norm(crosses, dim=-1)                     # (..., 3)
    best = torch.argmax(cn, dim=-1)
    v_cross = torch.gather(crosses, -2,
                           best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]

    rs = M[..., 0, :] + M[..., 1, :] + M[..., 2, :]
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=A.dtype, device=A.device).expand(rs.shape)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=A.dtype, device=A.device).expand(rs.shape)
    f1 = torch.linalg.cross(rs, ex, dim=-1)
    f2 = torch.linalg.cross(rs, ey, dim=-1)
    v_rank1 = torch.where((torch.linalg.norm(f1, dim=-1) >
                           torch.linalg.norm(f2, dim=-1))[..., None], f1, f2)
    v_rank1 = torch.where(
        (torch.linalg.norm(v_rank1, dim=-1) ** 2 > 1e-12 * scale2)[..., None],
        v_rank1, ex)

    v = torch.where((torch.amax(cn, dim=-1) ** 2 > 1e-12 * scale2 ** 2)[..., None],
                    v_cross, v_rank1)
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)


def project_rank2(M: torch.Tensor) -> torch.Tensor:
    """Closest rank-2 matrix to 3x3 M (Frobenius), without an SVD:
    M (I - v3 v3^T) with v3 the smallest right-singular vector, from the
    closed-form symmetric eigensolver on M^T M. M: (..., 3, 3)."""
    v3 = smallest_eigvec_3x3_sym(M.transpose(-1, -2) @ M)
    Mv = (M @ v3[..., :, None])[..., 0]
    return M - Mv[..., :, None] * v3[..., None, :]
