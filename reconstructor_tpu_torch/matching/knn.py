"""Exact top-2 descriptor matching with ratio test — the FLANN replacement.

Capability parity with ``FlannMatcher::matchFeatures``
(FeatureMatcher.cpp:32-65: FLANN kNN k=2, Lowe ratio 0.7, uniqueness on
train ids), computed exactly: the (K1, D) x (D, K2) similarity is one
matmul, followed by two masked min/argmin passes. Uniqueness is enforced
as full mutual-nearest cross-checking (reverse argmin agreement) rather
than FLANN's first-come-first-served train-id set.

This is the plain version of the matcher: the CPU path, the rescue
matcher of the incremental reconstructor, and the specification that the CUDA
top-2 kernel (``matching/cuda_knn.py``) is held against. Invalid slots
get +inf distance so they never match.
"""

from __future__ import annotations

import torch


def match_pair_scores(desc1: torch.Tensor, desc2: torch.Tensor,
                      mask1: torch.Tensor, mask2: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances between two descriptor sets, batched over any
    leading dims: d^2 = 2 - 2 <a, b> for unit descriptors, accumulated in
    float32 whatever the input type. Masked slots are pushed to +inf."""
    sim = torch.matmul(desc1.float(), desc2.float().transpose(-1, -2))
    d2 = torch.clamp(2.0 - 2.0 * sim, min=0.0)
    valid = mask1[..., :, None] & mask2[..., None, :]
    return torch.where(valid, d2, float("inf"))


def _top2_and_match(d2, mask1, ratio_thresh: float, cross_check: bool):
    """(..., K1, K2) distances -> (match_idx (..., K1) int32, ok (..., K1))."""
    nn = torch.argmin(d2, dim=-1)
    best = torch.gather(d2, -1, nn[..., None])[..., 0]
    d2_masked = d2.scatter(-1, nn[..., None], float("inf"))
    second = torch.amin(d2_masked, dim=-1)
    # Lowe ratio on squared distances against ratio^2 (identical test)
    ratio_ok = best < (ratio_thresh * ratio_thresh) * second
    ok = ratio_ok & mask1 & torch.isfinite(best)
    if cross_check:
        rev = torch.argmin(d2, dim=-2)                      # best row per column
        rows = torch.arange(d2.shape[-2], device=d2.device)
        ok = ok & (torch.gather(rev, -1, nn) == rows)
    return torch.where(ok, nn, -1).to(torch.int32), ok


def match_pair(desc1: torch.Tensor, desc2: torch.Tensor,
               mask1: torch.Tensor, mask2: torch.Tensor,
               ratio_thresh: float = 0.7, cross_check: bool = True):
    """Ratio-tested (optionally mutual) nearest-neighbor match of one pair.

    Returns (match_idx (K1,) int32 — index into desc2 or -1,
             match_mask (K1,) bool).
    """
    d2 = match_pair_scores(desc1, desc2, mask1, mask2)
    return _top2_and_match(d2, mask1, ratio_thresh, cross_check)


def match_all_pairs(desc: torch.Tensor, mask: torch.Tensor,
                    pair_idx: torch.Tensor,
                    ratio_thresh: float = 0.7, cross_check: bool = True,
                    compute_dtype: str = "float32", pairs_per_batch: int = 64):
    """Batched matching over an explicit list of image pairs.

    desc: (N, K, D); mask: (N, K); pair_idx: (P, 2) image-id pairs.
    Returns (match_idx (P, K), match_mask (P, K)). Pairs run in batches
    of ``pairs_per_batch`` to bound the (B, K, K) distance tensor.
    """
    if compute_dtype == "bfloat16":
        desc = desc.to(torch.bfloat16)     # products accumulate in float32
    idx_out, ok_out = [], []
    for s in range(0, pair_idx.shape[0], pairs_per_batch):
        pc = pair_idx[s:s + pairs_per_batch].long()
        i, j = pc[:, 0], pc[:, 1]
        d2 = match_pair_scores(desc[i], desc[j], mask[i], mask[j])
        mi, ok = _top2_and_match(d2, mask[i], ratio_thresh, cross_check)
        idx_out.append(mi)
        ok_out.append(ok)
    return torch.cat(idx_out), torch.cat(ok_out)
