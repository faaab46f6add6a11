"""The F-gate's hypothesis scores, fused: a hand-written CUDA kernel for
Hopper (kernel 7).

``geometry/fgate.py::filter_pairs_scalarized`` scores every hypothesis F
(B, H, 9) against every ``stride``-th match slot of its pair and keeps the
hypothesis with the most inliers. ``sampson_counts`` returns those inlier
counts (B, H), int64:

- on a CUDA tensor one launch of ``csrc/fgate_score.cu`` (or a raise): the
  Sampson distances stay in registers, in ``sampson9``'s order of
  operations with every product and sum rounded on its own, so the counts
  equal the plain version's bit for bit and nothing of size B x H x S is
  written;
- on a CPU tensor ``sampson_counts_plain``: the two lines the gate ran
  before (``sampson9`` on (B, H, S) tensors, the threshold, the mask and
  the sum), so the CPU tests against the JAX package run what they ran.

The kernel launches once for each gated chunk on the card. It is built
with ``nvcc`` for ``sm_90a`` at its first call, called through ``ctypes``
and counted by ``utils.cuda_build``.
"""

from __future__ import annotations

import ctypes

import torch

from reconstructor_tpu_torch.utils import cuda_build

SOURCE = "geometry/csrc/fgate_score.cu"
# the scoring of filter_pairs_scalarized (plain jnp that XLA fuses; no Pallas)
REPLACES = "reconstructor_tpu/geometry/fgate.py:216"
_GRID_Y_MAX = 65535


def sampson9(f, x1, y1, x2, y2):
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


def sampson_counts_plain(f: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor,
                         mask: torch.Tensor, stride: int, thr: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch: for each hypothesis f (B, H,
    9), the number of slots ``::stride`` of pts1 / pts2 (B, K, 2) with
    ``mask`` (B, K) set and a Sampson distance below ``thr``; (B, H)."""
    xs1, ys1 = pts1[:, ::stride, 0], pts1[:, ::stride, 1]
    xs2, ys2 = pts2[:, ::stride, 0], pts2[:, ::stride, 1]
    ms = mask[:, ::stride]
    d = sampson9(f, xs1[:, None], ys1[:, None], xs2[:, None], ys2[:, None])
    return torch.sum((d < thr) & ms[:, None, :], dim=-1)


_VP, _CI = ctypes.c_void_p, ctypes.c_int
# f, pts1, pts2, mask, B, H, K, stride, thr, counts, stream
_FNS = {"sampson_count_launch": [_VP, _VP, _VP, _VP, _CI, _CI, _CI, _CI, ctypes.c_float, _VP,
                                 _VP]}


def sampson_counts(f: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor,
                   mask: torch.Tensor, stride: int, thr: float) -> torch.Tensor:
    """Inlier counts (B, H) int64 of hypotheses f (B, H, 9) over the slots
    ``::stride`` of pts1 / pts2 (B, K, 2) where ``mask`` (B, K) is set, at
    squared-pixel threshold ``thr``. On CUDA tensors one launch of
    ``csrc/fgate_score.cu`` (or a raise), which reads the slots in place;
    the plain version runs only for tensors on the CPU."""
    dev = f.device
    if dev.type == "cpu":
        return sampson_counts_plain(f, pts1, pts2, mask, stride, thr)
    if dev.type != "cuda":
        raise ValueError(f"sampson_counts: unsupported device {dev}")
    if (f.dtype, pts1.dtype, pts2.dtype, mask.dtype) != (torch.float32,) * 3 + (torch.bool,):
        raise TypeError(f"sampson_counts: f, pts1, pts2 must be float32 and mask bool, got "
                        f"{f.dtype}, {pts1.dtype}, {pts2.dtype}, {mask.dtype}")
    if f.dim() != 3 or f.shape[2] != 9 or mask.dim() != 2:
        raise ValueError(f"sampson_counts: f {tuple(f.shape)} must be (B, H, 9) and mask "
                         f"{tuple(mask.shape)} (B, K)")
    B, H = f.shape[:2]
    K = mask.shape[1]
    if tuple(mask.shape) != (B, K) or tuple(pts1.shape) != (B, K, 2) \
            or tuple(pts2.shape) != (B, K, 2):
        raise ValueError(f"sampson_counts: pts1 {tuple(pts1.shape)}, pts2 "
                         f"{tuple(pts2.shape)} and mask {tuple(mask.shape)} for f "
                         f"{tuple(f.shape)}")
    if any(x.device != dev for x in (pts1, pts2, mask)):
        raise ValueError(f"sampson_counts: f on {dev}, pts1 on {pts1.device}, pts2 on "
                         f"{pts2.device}, mask on {mask.device}")
    if not all(x.is_contiguous() for x in (f, pts1, pts2, mask)):
        raise ValueError("sampson_counts: f, pts1, pts2 and mask must be contiguous")
    if stride < 1 or B > _GRID_Y_MAX or K >= 2 ** 30:
        raise ValueError(f"sampson_counts: stride {stride} (at least 1), B {B} (at most "
                         f"{_GRID_Y_MAX}), K {K} (below 2**30)")
    counts = torch.empty((B, H), dtype=torch.int64, device=dev)
    if B == 0 or H == 0:
        return counts
    args = (f.data_ptr(), pts1.data_ptr(), pts2.data_ptr(), mask.data_ptr(), B, H, K, stride,
            thr, counts.data_ptr())
    cuda_build.launch(cuda_build.bind(SOURCE, _FNS, "sampson_count_error_string"),
                      "sampson_count_launch", args, dev)
    return counts
