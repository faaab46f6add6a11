"""Image-pair selection.

Parity with the reference's ``ImageMatcher`` stage: the only concrete
implementation is ``FakeImgMatcher`` (ImageMatcher.cpp:6-24) which pairs
every image with every other. Here exhaustive pairing enumerates only
unordered pairs (i < j) — the reference matches (i, j) and then mirrors
(j, i) from the cache (SequentialReconstructor.cpp:219-227), so unordered
pairs carry the same information at half the work. A retrieval-based
matcher (the reference README's FAISS TODO) can slot in behind the same
interface later.
"""

from __future__ import annotations

import numpy as np


def exhaustive_pairs(num_images: int) -> np.ndarray:
    """All unordered pairs (i, j), i < j, as an (P, 2) int32 array."""
    idx = np.triu_indices(num_images, k=1)
    return np.stack(idx, axis=1).astype(np.int32)


def pairs_to_neighbors(pair_idx: np.ndarray, num_images: int):
    """Adjacency list {img: set(partners)} from a pair list."""
    adj = {i: set() for i in range(num_images)}
    for i, j in pair_idx:
        adj[int(i)].add(int(j))
        adj[int(j)].add(int(i))
    return adj


def retrieval_pairs(desc: np.ndarray, mask: np.ndarray, top_k: int = 10) -> np.ndarray:
    """Retrieval-based pair selection — the reference's declared TODO
    (README:40 'image matching ... FAISS').

    Scores image similarity by mean mutual descriptor affinity of a
    random keypoint subsample (a VLAD-lite global signature: the mean of
    L2-normalized local descriptors, compared by dot product). Each image
    keeps its top_k most similar partners; returned as unordered (i, j)
    pairs. O(N^2 D) as one matmul — for the N where exhaustive *feature*
    matching hurts, this prunes the quadratic pair list first.
    """
    import numpy as _np
    d = desc * mask[..., None]
    counts = _np.maximum(mask.sum(axis=1, keepdims=True), 1)
    sig = d.sum(axis=1) / counts                     # (N, D) mean descriptor
    sig = sig / _np.maximum(_np.linalg.norm(sig, axis=-1, keepdims=True), 1e-12)
    sim = sig @ sig.T
    _np.fill_diagonal(sim, -_np.inf)
    n = sim.shape[0]
    k = min(top_k, n - 1)
    # vectorized per-row top-k -> unordered unique pairs
    top = _np.argpartition(-sim, k - 1, axis=1)[:, :k]        # (N, k)
    rows = _np.repeat(_np.arange(n), k)
    cols = top.reshape(-1)
    lo = _np.minimum(rows, cols)
    hi = _np.maximum(rows, cols)
    pairs = _np.unique(_np.stack([lo, hi], axis=1), axis=0)
    return pairs[pairs[:, 0] != pairs[:, 1]].astype(_np.int32)
