"""Sharded all-pairs matching over the mesh.

The PyTorch counterpart of ``reconstructor_tpu.parallel.sharding``. The
mesh, its placement helpers and the two collectives live in
``parallel.mesh`` and are re-exported here under the JAX module's names.
Every rank runs the whole driver, so host bookkeeping is replicated; the
sharded matchers pad a chunk's pair axis to a multiple of the world size
with (0, 0) pairs, run the single-device function on this rank's
contiguous slice, gather the slices and drop the padding, so that every
rank holds the same result. In a world of one they are the single-device
functions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from reconstructor_tpu_torch.geometry import ransac
from reconstructor_tpu_torch.matching import gated, superglue
from reconstructor_tpu_torch.parallel.mesh import (  # noqa: F401  (the JAX module's names)
    AXIS, DEFAULT_TIMEOUT_S, Mesh, all_gather, all_sum, counts, initialize_multihost,
    make_mesh, pad_to_multiple, put_global, replicate, reset_counts, shard_batch, shard_rows)


def _pairs(mesh: Mesh, pair_idx):
    """(this rank's slice of the pair axis padded with (0, 0) pairs to a
    multiple of the world size, real pair count, padded count)."""
    if isinstance(pair_idx, torch.Tensor):
        pair_idx = pair_idx.cpu().numpy()
    pairs = np.asarray(pair_idx, np.int32).reshape(-1, 2)
    padded = pad_to_multiple(pairs, mesh.size)
    return shard_batch(mesh, np.ascontiguousarray(padded)), pairs.shape[0], padded.shape[0]


# ----------------------------------------------------------------------
# sharded matchers
# ----------------------------------------------------------------------

def match_all_pairs_sharded(mesh: Mesh, desc, mask, pair_idx,
                            ratio_thresh: float = 0.7, cross_check: bool = True,
                            compute_dtype: str = "float32"):
    """All-pairs descriptor matching with the pair axis sharded over the
    ranks (the reference's OpenMP collapse(2) loop,
    SequentialReconstructor.cpp:202). Descriptors are replicated; each rank
    matches its slice of pairs (``gated.match_pairs``: the CUDA top-2
    kernel on a card, the plain matcher on the CPU), and the slices are
    gathered.

    desc (N, K, D), mask (N, K), pair_idx (P, 2). Returns (match_idx
    (P, K) int32, match_mask (P, K)) on the rank's device, the same on
    every rank.
    """
    pairs, n, _ = _pairs(mesh, pair_idx)
    mi, mm = gated.match_pairs(replicate(mesh, desc), replicate(mesh, mask), pairs,
                               ratio_thresh, cross_check, compute_dtype)
    return all_gather(mesh, mi)[:n], all_gather(mesh, mm)[:n]


def match_and_gate_sharded(mesh: Mesh, desc, kmask, xy, pair_idx,
                           ratio_thresh: float, cross_check: bool, num_hypotheses: int,
                           thresh_px: float, min_matches: int,
                           compute_dtype: str = "float32",
                           generator: Optional[torch.Generator] = None,
                           pos: Optional[torch.Tensor] = None):
    """Fused kNN + epipolar gate (``gated.match_and_gate``) with the pair
    axis sharded: both halves of the work shard, the descriptor top-2 and
    the per-pair fundamental RANSAC.

    The F-gate's draws do not depend on the world size: every rank draws
    the (B, H, 8) tensor of the chunk's B real pairs whole from
    ``generator`` (or takes the given ``pos``), pads it with zero rows for
    the padding pairs and gates its own rows. Each rank's generator thus
    advances exactly as the single-device path's does, and a world of N
    gives what one device gives.

    desc (N, K, D), kmask (N, K), xy (N, K, 2); pair_idx (B, 2) real pairs
    only. Returns (match_idx (B, K) int16, inlier counts (B,) int32) on
    the rank's device, the same on every rank.
    """
    pairs, n, n_pad = _pairs(mesh, pair_idx)
    if pos is None:
        pos = ransac.raw_draws((n, num_hypotheses, 8), mesh.device, generator)
    pos = replicate(mesh, pos)
    if tuple(pos.shape) != (n, num_hypotheses, 8):
        raise ValueError(f"pos {tuple(pos.shape)} is not ({n}, {num_hypotheses}, 8)")
    mi, cnt = gated.match_and_gate(
        replicate(mesh, desc), replicate(mesh, kmask), replicate(mesh, xy), pairs,
        ratio_thresh=ratio_thresh, cross_check=cross_check, num_hypotheses=num_hypotheses,
        thresh_px=thresh_px, min_matches=min_matches, compute_dtype=compute_dtype,
        pos=shard_rows(mesh, pos, n_pad))
    return all_gather(mesh, mi)[:n], all_gather(mesh, cnt)[:n]


def match_superglue_sharded(mesh: Mesh, net: superglue.SuperGlue, desc, xy, score,
                            kmask, shapes, pair_idx, sinkhorn_iters: int,
                            score_thresh: float):
    """SuperGlue inference (``superglue.match_pairs_batched``: GNN,
    scores, the Sinkhorn kernel on a card) with the pair axis sharded.
    The network and the per-image arrays are replicated; each rank runs
    the whole stack on its slice of pairs.

    pair_idx (B, 2) real pairs only. Returns (match_idx (B, K), match_mask
    (B, K), match_scores (B, K)) on the rank's device, the same on every
    rank.
    """
    pairs, n, _ = _pairs(mesh, pair_idx)
    out = superglue.match_pairs_batched(
        net, replicate(mesh, desc), replicate(mesh, xy), replicate(mesh, score),
        replicate(mesh, kmask), replicate(mesh, shapes), pairs,
        sinkhorn_iters=sinkhorn_iters, score_thresh=score_thresh)
    return tuple(all_gather(mesh, o)[:n] for o in out)

