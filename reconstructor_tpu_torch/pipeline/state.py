"""Mutable reconstruction state (host side).

The reference scatters state over unordered_maps inside the orchestrator
(SequentialReconstructor.h:205-229). Here the authoritative layout is a
set of flat numpy arrays with a *grouped observation table*
(landmark-major, fixed max views per landmark) — the shape that feeds
directly into the batched device kernels (validity sweep, triangulation,
BA packing) without any host-side graph walking.

The incremental loop is inherently sequential (each PnP depends on the
last BA — SURVEY.md §7 risk list), so this state lives on host between
stages; everything expensive happens in fixed-shape device programs.
Every mutation here is a vectorized numpy op: landmark storage grows by
capacity doubling (the public ``lm_*`` attributes are views into the
backing buffers), observations attach in batches, and observation rows
stay left-compacted so the first free slot is always ``mask.sum()``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

MAX_VIEWS_PER_LANDMARK = 32


@dataclasses.dataclass
class ReconstructionState:
    num_images: int
    max_keypoints: int

    # frontend outputs (fixed shape, set once)
    xy: np.ndarray            # (N, K, 2) float32
    desc: np.ndarray          # (N, K, D) float32
    kp_mask: np.ndarray       # (N, K) bool
    colors: np.ndarray        # (N, K, 3) uint8
    shapes: np.ndarray        # (N, 2) int32 (h, w)
    intrinsics: np.ndarray    # (N, 6) float32

    # detector confidences (used by SuperGlue's keypoint encoder)
    kp_score: Optional[np.ndarray] = None   # (N, K) float32

    # matching outputs: matches[(i, j)] = (K,) int32 feat_i -> feat_j or -1
    matches: Dict = dataclasses.field(default_factory=dict)

    # incremental state
    poses: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    registered: List[int] = dataclasses.field(default_factory=list)  # order
    feat2lm: Optional[np.ndarray] = None     # (N, K) int32, -1 = free

    # landmarks (grouped observation table) — views into backing buffers
    lm_xyz: Optional[np.ndarray] = None      # (L, 3) float32
    lm_rgb: Optional[np.ndarray] = None      # (L, 3) uint8
    lm_obs_img: Optional[np.ndarray] = None  # (L, V) int32
    lm_obs_feat: Optional[np.ndarray] = None # (L, V) int32
    lm_obs_mask: Optional[np.ndarray] = None # (L, V) bool
    lm_initial: Optional[np.ndarray] = None  # (L,) bool

    def __post_init__(self):
        assert self.max_keypoints <= 32767, (
            "match tables ship as int16 feature ids "
            f"(max_keypoints={self.max_keypoints} > 32767)")
        if self.feat2lm is None:
            self.feat2lm = np.full((self.num_images, self.max_keypoints), -1, np.int32)
        self._match_inv_cache: Dict = {}
        n0 = 0 if self.lm_xyz is None else self.lm_xyz.shape[0]
        self._lm_count = n0
        self._alloc(max(n0, 1024))
        if n0:
            self._buf_xyz[:n0] = self.lm_xyz
            self._buf_rgb[:n0] = self.lm_rgb
            self._buf_obs_img[:n0] = self.lm_obs_img
            self._buf_obs_feat[:n0] = self.lm_obs_feat
            self._buf_obs_mask[:n0] = self.lm_obs_mask
            self._buf_initial[:n0] = self.lm_initial
        self._refresh_views()

    # ---------------- storage ------------------------------------------
    def _alloc(self, cap: int) -> None:
        V = MAX_VIEWS_PER_LANDMARK
        self._lm_cap = cap
        self._buf_xyz = np.zeros((cap, 3), np.float32)
        self._buf_rgb = np.zeros((cap, 3), np.uint8)
        self._buf_obs_img = np.zeros((cap, V), np.int32)
        self._buf_obs_feat = np.zeros((cap, V), np.int32)
        self._buf_obs_mask = np.zeros((cap, V), bool)
        self._buf_initial = np.zeros((cap,), bool)

    def _refresh_views(self) -> None:
        L = self._lm_count
        self.lm_xyz = self._buf_xyz[:L]
        self.lm_rgb = self._buf_rgb[:L]
        self.lm_obs_img = self._buf_obs_img[:L]
        self.lm_obs_feat = self._buf_obs_feat[:L]
        self.lm_obs_mask = self._buf_obs_mask[:L]
        self.lm_initial = self._buf_initial[:L]

    def _ensure_capacity(self, extra: int) -> None:
        need = self._lm_count + extra
        if need <= self._lm_cap:
            return
        old = (self._buf_xyz, self._buf_rgb, self._buf_obs_img,
               self._buf_obs_feat, self._buf_obs_mask, self._buf_initial)
        L = self._lm_count
        self._alloc(max(self._lm_cap * 2, need))
        for dst, src in zip((self._buf_xyz, self._buf_rgb, self._buf_obs_img,
                             self._buf_obs_feat, self._buf_obs_mask,
                             self._buf_initial), old):
            dst[:L] = src[:L]

    def reset_landmarks(self) -> None:
        """Drop every landmark and free all feature assignments (used to
        redraw a failed initialization; buffers are kept allocated)."""
        self._lm_count = 0
        self.feat2lm.fill(-1)
        self._refresh_views()

    # ---------------- landmarks ----------------------------------------
    @property
    def num_landmarks(self) -> int:
        return self._lm_count

    def add_landmarks(self, xyz: np.ndarray, rgb: np.ndarray,
                      obs_img: np.ndarray, obs_feat: np.ndarray,
                      obs_mask: np.ndarray, initial: bool = False) -> np.ndarray:
        """Append new landmarks; returns their ids. Updates feat2lm."""
        n = xyz.shape[0]
        self._ensure_capacity(n)
        L = self._lm_count
        ids = np.arange(L, L + n, dtype=np.int32)
        self._buf_xyz[L:L + n] = xyz
        self._buf_rgb[L:L + n] = rgb
        self._buf_obs_img[L:L + n] = obs_img
        self._buf_obs_feat[L:L + n] = obs_feat
        self._buf_obs_mask[L:L + n] = obs_mask
        self._buf_initial[L:L + n] = initial
        self._lm_count = L + n
        self._refresh_views()
        sel = obs_mask.astype(bool)
        ids_b = np.broadcast_to(ids[:, None], obs_mask.shape)
        self.feat2lm[obs_img[sel], obs_feat[sel]] = ids_b[sel]
        return ids

    def add_observation(self, lm_id: int, img: int, feat: int) -> bool:
        """Attach one observation to an existing landmark (if capacity)."""
        added = self.add_observations(np.asarray([lm_id], np.int32),
                                      np.asarray([img], np.int32),
                                      np.asarray([feat], np.int32))
        return added == 1

    def add_observations(self, lm_ids: np.ndarray, imgs: np.ndarray,
                         feats: np.ndarray) -> int:
        """Attach a batch of observations (one vectorized pass).

        Rows whose landmark is already at MAX_VIEWS_PER_LANDMARK capacity
        are skipped. Returns the number attached. Observation rows are
        left-compacted, so the first free slot of landmark l is
        ``lm_obs_mask[l].sum()``; duplicates of the same landmark within
        the batch land in consecutive slots via a per-group cumulative
        count.
        """
        n = lm_ids.size
        if n == 0:
            return 0
        V = MAX_VIEWS_PER_LANDMARK
        order = np.argsort(lm_ids, kind="stable")
        lm_s = lm_ids[order]
        img_s = imgs[order]
        feat_s = feats[order]
        first = np.r_[True, lm_s[1:] != lm_s[:-1]]
        grp_start = np.flatnonzero(first)
        grp_len = np.diff(np.r_[grp_start, n])
        cum = np.arange(n) - np.repeat(grp_start, grp_len)
        base = self.lm_obs_mask[lm_s].sum(axis=1)
        slot = base + cum
        ok = slot < V
        lm_ok, sl_ok = lm_s[ok], slot[ok]
        self._buf_obs_img[lm_ok, sl_ok] = img_s[ok]
        self._buf_obs_feat[lm_ok, sl_ok] = feat_s[ok]
        self._buf_obs_mask[lm_ok, sl_ok] = True
        self.feat2lm[img_s[ok], feat_s[ok]] = lm_ok
        return int(ok.sum())

    def _compact_rows(self) -> None:
        """Left-compact observation rows so free slots trail the live ones."""
        L = self._lm_count
        mask = self._buf_obs_mask[:L]
        order = np.argsort(~mask, axis=1, kind="stable")
        self._buf_obs_img[:L] = np.take_along_axis(self._buf_obs_img[:L], order, axis=1)
        self._buf_obs_feat[:L] = np.take_along_axis(self._buf_obs_feat[:L], order, axis=1)
        self._buf_obs_mask[:L] = np.take_along_axis(mask, order, axis=1)

    def drop_observations(self, drop_mask: np.ndarray) -> None:
        """Remove observations flagged (L, V) True; resets feat2lm."""
        sel = drop_mask & self.lm_obs_mask
        if not sel.any():
            return
        imgs = self.lm_obs_img[sel]
        feats = self.lm_obs_feat[sel]
        self.feat2lm[imgs, feats] = -1
        self.lm_obs_mask &= ~drop_mask
        self._compact_rows()

    def remove_landmarks(self, keep: np.ndarray) -> None:
        """Compact landmark arrays to ``keep`` (bool mask), freeing the
        features of removed ones (removeOutlierLandmarks parity,
        SequentialReconstructor.cpp:956-976)."""
        gone = ~keep
        sel = self.lm_obs_mask & gone[:, None]
        self.feat2lm[self.lm_obs_img[sel], self.lm_obs_feat[sel]] = -1
        n_keep = int(keep.sum())
        L = self._lm_count
        for buf in (self._buf_xyz, self._buf_rgb, self._buf_obs_img,
                    self._buf_obs_feat, self._buf_obs_mask, self._buf_initial):
            buf[:n_keep] = buf[:L][keep]
        self._buf_obs_mask[n_keep:L] = False
        self._lm_count = n_keep
        self._refresh_views()
        # reindex feat2lm
        new_ids = np.full(keep.shape[0], -1, np.int32)
        new_ids[keep] = np.arange(n_keep, dtype=np.int32)
        live = self.feat2lm >= 0
        self.feat2lm[live] = new_ids[self.feat2lm[live]]

    # ---------------- observations as flat arrays ----------------------
    def flat_observations(self):
        """(obs_lm, obs_img, obs_feat) int32 arrays of all live observations."""
        lm_ids = np.broadcast_to(
            np.arange(self.num_landmarks, dtype=np.int32)[:, None],
            self.lm_obs_mask.shape)
        sel = self.lm_obs_mask
        return lm_ids[sel], self.lm_obs_img[sel], self.lm_obs_feat[sel]

    def observation_uv(self, obs_img: np.ndarray, obs_feat: np.ndarray) -> np.ndarray:
        return self.xy[obs_img, obs_feat]

    def match_lookup(self, i: int, j: int) -> Optional[np.ndarray]:
        """feat_i -> feat_j mapping ((K,) int32 with -1), if the pair was
        matched. Mirrors stored i<j tables on the fly, caching the inverse
        per source table (the reference caches it eagerly instead,
        SequentialReconstructor.cpp:219-227)."""
        if (i, j) in self.matches:
            return self.matches[(i, j)]
        if (j, i) in self.matches:
            inv = self.matches[(j, i)]
            cached = self._match_inv_cache.get((i, j))
            if cached is not None and cached[0] is inv:
                return cached[1]
            out = np.full(self.max_keypoints, -1, np.int32)
            src = np.where(inv >= 0)[0]
            out[inv[src]] = src
            self._match_inv_cache[(i, j)] = (inv, out)
            return out
        return None
