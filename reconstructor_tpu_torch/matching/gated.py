"""Fused kNN matching + epipolar gate over a chunk of pairs.

One pass per chunk: raw top-2 descriptor matching (the CUDA kernel on
the card, the plain matcher on the CPU), on-device gather of the matched
coordinates, fundamental-RANSAC gating, and an on-device mask fold to
compact int16 match tables. The raw match table never round-trips to the
host between the stages. It covers the reference's OpenMP collapse(2)
matching loop (SequentialReconstructor.cpp:202) plus its per-pair
cv::findFundamentalMat gate (:251).
"""

from __future__ import annotations

from typing import Optional

import torch

from reconstructor_tpu_torch.geometry import fgate
from reconstructor_tpu_torch.matching import cuda_knn, knn
from reconstructor_tpu_torch.utils import profiling


def filter_pairs(pts1, pts2, mask, num_hypotheses: int, thresh_px: float,
                 generator: Optional[torch.Generator] = None,
                 pos: Optional[torch.Tensor] = None):
    """Batched fundamental-RANSAC gate over a chunk of pairs.

    pts1/pts2: (B, K, 2); mask: (B, K). Returns inlier masks (B, K).
    Model selection runs on a strided quarter-subsample of the match
    slots when K >= 1024; the winning F (plus a guarded all-inlier refit)
    then classifies every match once.
    """
    K = pts1.shape[1]
    stride = 4 if K >= 1024 else 1
    with profiling.annotate("match.fgate"):
        return fgate.filter_pairs_scalarized(
            pts1, pts2, mask, num_hypotheses=num_hypotheses,
            thresh_px=thresh_px, stride=stride, generator=generator, pos=pos)


def match_and_gate(desc, kmask, xy, pair_chunk,
                   ratio_thresh: float, cross_check: bool,
                   use_fused: bool, num_hypotheses: int,
                   thresh_px: float, min_matches: int,
                   compute_dtype: str = "float32",
                   generator: Optional[torch.Generator] = None,
                   pos: Optional[torch.Tensor] = None):
    """kNN matching + epipolar gate for one pair chunk.

    desc (N, K, D), kmask (N, K), xy (N, K, 2), pair_chunk (B, 2) int32,
    all on one device. ``pos``: optional (B, H, 8) F-gate draws.
    Returns (match_idx (B, K) int16 with -1 for gated-out slots,
    inlier counts (B,) int32).
    """
    fn = cuda_knn.match_all_pairs_fused if use_fused else knn.match_all_pairs
    with profiling.annotate("match.knn"):
        midx, mmask = fn(desc, kmask, pair_chunk, ratio_thresh=ratio_thresh,
                         cross_check=cross_check, compute_dtype=compute_dtype)
    K = desc.shape[1]
    pc = pair_chunk.long()
    p1 = xy[pc[:, 0]]                                             # (B, K, 2)
    p2 = xy[pc[:, 1][:, None], torch.clamp(midx.long(), 0, K - 1)]
    inl = filter_pairs(p1, p2, mmask, num_hypotheses=num_hypotheses,
                       thresh_px=thresh_px, generator=generator, pos=pos)
    # need >= min_matches for F estimation; keep raw matches otherwise
    # (SequentialReconstructor.cpp:237)
    counts = torch.sum(mmask, dim=1)
    out = torch.where((counts >= min_matches)[:, None], inl & mmask, mmask)
    midx16 = torch.where(out, midx, -1).to(torch.int16)
    return midx16, torch.sum(out, dim=1).to(torch.int32)
