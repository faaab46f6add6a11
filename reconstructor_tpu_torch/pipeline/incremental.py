"""The incremental SfM loop — SequentialReconstructor in PyTorch.

Capability parity with the reference's pipeline
(SequentialReconstructor.cpp:978-1103): detect -> match (+epipolar gate) ->
initial pair -> triangulate -> [PnP register -> triangulate new ->
validity sweep -> BA -> outlier removal] x (N-2) -> colored PLY.

The same loop as ``reconstructor_tpu.pipeline.incremental``: a thin
host loop owns the bookkeeping (pipeline.state, numpy) while every
stage's math runs as a batched tensor program on the reconstructor's
device:

- detection: one batched program over the whole image batch
  (features.sift, features.orb, or features.superpoint on the learned
  path);
- matching + epipolar gating: the CUDA top-2 kernel (matching.cuda_knn)
  on the card, the plain matcher on the CPU, fused with the batched
  fundamental-RANSAC gate per chunk of pairs (matching.gated); on the
  learned path SuperGlue per chunk of pairs (matching.superglue, whose
  Sinkhorn is the CUDA kernel matching.cuda_sinkhorn on the card), then
  the same gate in chunks of its own;
- registration: batched P3P hypotheses (geometry.pnp);
- triangulation + landmark validity: landmark-major observation tables
  swept in one batched program;
- BA: dense Schur-complement LM (ba.lm), or the implicit-Schur PCG
  solver (ba.distributed) where the dense coupling would pass
  ``ba_dense_w_max_elems`` or with ``ba_solver="pcg"``;
- with a mesh (parallel.mesh): every rank runs this loop; the
  matching chunks shard their pairs over the ranks (parallel.sharding,
  whose matchers run over a world of one without a mesh) and every BA runs the
  observation-sharded PCG solver (``solve_distributed``), so every rank
  holds the same state; only rank 0 writes files;
- checkpoints: with ``checkpoint_path`` the state autosaves after the
  initial pair, every ``checkpoint_every_views`` registrations and at the
  end (pipeline.checkpoint), and ``resume`` continues from such a file.

The TPU package pads every dynamic size to coarse buckets so that XLA
compiles a handful of programs; PyTorch runs eagerly, so this loop
passes the live sizes as they are (that padding changes no result),
except in bundle adjustment, where the solver reads the padded sizes.
Randomness comes from one ``torch.Generator`` on the device, seeded from
``config.rng_seed``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reconstructor_tpu_torch.ba import distributed, lm as ba_lm
from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.features import orb, sift, superpoint
from reconstructor_tpu_torch.geometry import camera as cam
from reconstructor_tpu_torch.geometry import epipolar, np_ops, pnp, se3, triangulation
from reconstructor_tpu_torch.io import images as io_images
from reconstructor_tpu_torch.io import ply
from reconstructor_tpu_torch.matching import gated, knn, pairs as pairing, superglue
from reconstructor_tpu_torch.parallel import mesh as pmesh, sharding
from reconstructor_tpu_torch.pipeline import checkpoint
from reconstructor_tpu_torch.pipeline.state import ReconstructionState, MAX_VIEWS_PER_LANDMARK
from reconstructor_tpu_torch.utils import device as devices, profiling
from reconstructor_tpu_torch.utils.timing import TimeLogger


def _check_landmarks(xyz, poses_all, intr_all, obs_img, obs_feat, obs_mask,
                     xy_all, max_err: float, min_angle: float):
    """Batched landmark validity sweep (checkLandmarkValidity parity,
    SequentialReconstructor.cpp:869-954).

    xyz (L,3); poses_all (N,4,4); intr_all (N,6); obs_* (L,V); xy_all (N,K,2).
    Returns (valid (L,), new_obs_mask (L,V)): failing observations
    (reproj > gate or negative depth) are dropped and a landmark survives
    iff >= 2 observations remain and at least one pair of them subtends
    more than the minimum angle (the reference's keep-if-any-pair-passes
    rule at :943-948).
    """
    uv = xy_all[obs_img, obs_feat]
    P = poses_all[obs_img]
    I = intr_all[obs_img]
    local = torch.einsum("lvij,lj->lvi", P[..., :3, :3], xyz) + P[..., :3, 3]
    err = cam.reprojection_error_l1(I, local[..., None, :], uv[..., None, :])[..., 0]
    obs_ok = (err <= max_err) & (local[..., 2] > 0)
    new_mask = obs_mask & obs_ok

    centers = se3.camera_center(P)
    ang = triangulation.triangulation_angles_deg(xyz, centers)
    V = obs_mask.shape[1]
    pair = (new_mask[:, :, None] & new_mask[:, None, :]
            & ~torch.eye(V, dtype=torch.bool, device=xyz.device)[None])
    angle_passed = torch.any((pair & (ang > min_angle)).reshape(pair.shape[0], -1), dim=1)
    valid = (torch.sum(new_mask, dim=1) >= 2) & angle_passed
    return valid, new_mask


def uses_pcg(cfg: ReconstructorConfig, c_pad: int, l_pad: int) -> bool:
    """The driver's BA routing rule: the implicit-Schur PCG solver when
    asked for, or when the dense coupling's C_pad*12 x L_pad*3 elements
    pass ``ba_dense_w_max_elems``."""
    return cfg.ba_solver == "pcg" or c_pad * 12 * l_pad * 3 > cfg.ba_dense_w_max_elems


class IncrementalReconstructor:
    """End-to-end incremental reconstruction (reconstruct() parity).

    ``device``: where every stage runs — ``cuda`` unless given (the tests
    pass ``"cpu"``). Detectors ``sift``, ``orb`` and ``superpoint``,
    matchers ``knn`` and ``superglue``, dense-Schur or implicit-Schur PCG
    bundle adjustment.

    ``mesh``: an optional ``parallel.mesh.Mesh``. Matching always runs
    the sharded matchers (``match_and_gate_sharded``,
    ``match_all_pairs_sharded``, ``match_superglue_sharded``), over a
    world of one without a mesh. With a mesh the device is the mesh's (a
    different ``device`` raises), each chunk's pairs shard over the ranks
    and every bundle adjustment runs ``ba.distributed.solve_distributed``,
    also under the dense budget. Every rank must run the same calls.
    """

    def __init__(self, config: Optional[ReconstructorConfig] = None,
                 verbose: bool = True, device=None, mesh: Optional[pmesh.Mesh] = None):
        self.config = config or ReconstructorConfig()
        cfg = self.config
        for name, value, known in (("detector", cfg.detector, ("sift", "orb", "superpoint")),
                                   ("matcher", cfg.matcher, ("knn", "superglue")),
                                   ("ba_solver", cfg.ba_solver, ("dense_schur", "pcg"))):
            if value not in known:
                raise ValueError(f"unknown {name} {value!r} (one of {', '.join(known)})")
        self.verbose = verbose
        self.mesh = mesh
        if mesh is not None:
            if device is not None and devices.resolve(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
        self.device = devices.resolve(device)
        # the matchers shard over this; without a mesh it is the world of one
        self._shards = mesh or pmesh.world_of_one(self.device)
        # ranks of a mesh hold the same state; one writes it
        self._writes = self._shards.rank == 0
        self.timer = TimeLogger()
        self._gen = devices.generator(self.device, cfg.rng_seed)
        # bundle adjustments per solver: ba.lm.solve, ba.distributed.solve_pcg
        # and solve_distributed (which route ran)
        self.ba_calls = {"dense": 0, "pcg": 0, "distributed": 0}

    def _log(self, *args):
        if self.verbose:
            print(*args, flush=True)

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device, dtype=dtype)

    # ------------------------------------------------------------------
    def reconstruct(self, img_folder: str, out_folder: Optional[str] = None,
                    save_intermediate: bool = False,
                    checkpoint_path: Optional[str] = None,
                    resume: bool = False) -> ReconstructionState:
        """Detect, match and reconstruct a folder of images. With
        ``resume`` and an existing ``checkpoint_path``, continue from that
        file instead (state and generator; the folder is not read)."""
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            state = self.restore(checkpoint_path)
        else:
            with self.timer.event("feature extraction"):
                state = self.detect_features(img_folder)
        return self.reconstruct_from_state(state, out_folder, save_intermediate,
                                           checkpoint_path=checkpoint_path)

    def restore(self, checkpoint_path: str) -> ReconstructionState:
        """Load a checkpoint's state and put the generator where the
        writing run left it. This package keeps no sticky shape caps, so a
        file's ``caps`` are not read. A file without a torch generator
        state (one the JAX package wrote, whose ``rng_key`` drives another
        stream) leaves the generator as it is."""
        state = checkpoint.load(checkpoint_path)
        gen_state = checkpoint.load_rng_state(checkpoint_path, self.device)
        if gen_state is not None:
            self._gen.set_state(gen_state)
        else:
            self._log(f"{checkpoint_path} holds no torch generator state for "
                      f"{self.device.type}; the generator keeps its seed")
        self._log(f"resumed from {checkpoint_path}: {len(state.registered)} views registered")
        return state

    def _autosave(self, state: ReconstructionState, checkpoint_path: Optional[str]) -> None:
        if checkpoint_path:
            checkpoint.save(checkpoint_path, state, config=self.config,
                            generator=self._gen)

    def reconstruct_from_state(self, state: ReconstructionState,
                               out_folder: Optional[str] = None,
                               save_intermediate: bool = False,
                               checkpoint_path: Optional[str] = None) -> ReconstructionState:
        """Run the full pipeline from a prepared feature state: matching,
        initialization, the incremental register/BA loop, and output
        artifacts. A partially registered state (a resumed checkpoint)
        continues where it stopped; with ``checkpoint_path`` the state
        autosaves after the initial pair, every
        ``checkpoint_every_views`` registrations, after the last one and
        at the end."""
        resuming = bool(state.registered)
        if not self._writes:
            out_folder = checkpoint_path = None
        if out_folder and not resuming:
            # clear previous run artifacts (deleteDirectoryContents parity,
            # SequentialReconstructor.cpp:984-985) — only dirs we own
            for sub in ("clouds", "matches"):
                d = os.path.join(out_folder, sub)
                if os.path.isdir(d):
                    shutil.rmtree(d)
        if out_folder:
            os.makedirs(os.path.join(out_folder, "clouds"), exist_ok=True)

        if not state.matches:
            with self.timer.event("feature matching"):
                self.match_features(state)
        if not state.registered:
            # RANSAC's pose recovery is randomized; an unlucky draw can
            # return a pose that passes the epipolar fit but fails
            # cheirality en masse. Detect the failed initialization by its
            # triangulation yield and redraw (the generator advances on
            # every attempt), keeping the best draw.
            best = None
            for attempt in range(3):
                with self.timer.event("initial pair and pose estimation"):
                    i1, i2, rel_pose = self.choose_initial_pair(state)
                state.poses[i1] = np.eye(4, dtype=np.float32)
                state.poses[i2] = rel_pose
                state.registered = [i1, i2]
                self._log(f"initial pair: {i1}, {i2}")

                with self.timer.event("initial pair features triangulation"):
                    self.triangulate_initial_pair(state, i1, i2)
                n_pair_matches = int((state.matches[(i1, i2)] >= 0).sum())
                self._log(f"landmarks initial size: {state.num_landmarks} "
                          f"(of {n_pair_matches} matches)")
                if (state.num_landmarks >= self.config.min_2d3d_match_num
                        and state.num_landmarks * 4 >= n_pair_matches):
                    break
                if best is None or state.num_landmarks > best[0]:
                    best = (state.num_landmarks, i1, i2, rel_pose)
                self._log("initial triangulation starved — redrawing the initial pose")
                state.poses = {}
                state.registered = []
                state.reset_landmarks()
            else:
                count, i1, i2, rel_pose = best
                if count < self.config.min_2d3d_match_num:
                    raise RuntimeError(
                        "initialization failed: 3 initial-pair pose redraws all "
                        f"starved triangulation (best draw {count} < "
                        f"{self.config.min_2d3d_match_num} landmarks)")
                self._log(f"no draw cleared the yield ratio — keeping the best "
                          f"({count} landmarks)")
                state.poses[i1] = np.eye(4, dtype=np.float32)
                state.poses[i2] = rel_pose
                state.registered = [i1, i2]
                self.triangulate_initial_pair(state, i1, i2)
            self._autosave(state, checkpoint_path)

        if out_folder and save_intermediate and not resuming:
            self._save(state, os.path.join(out_folder, "clouds/cloud_initial.ply"))

        retried = False
        for it in range(len(state.registered) - 2,
                        max(state.num_images - 2, len(state.registered) - 2)):
            with self.timer.event("adding new view"):
                added = self.add_next_view(state)
            if added is None:
                # one retry round: track completion after the last BA can
                # unlock 2d-3d support that did not exist before
                if not retried:
                    retried = True
                    self.complete_tracks(state)
                    added = self.add_next_view(state)
                if added is None:
                    self._log("no registrable view left; stopping early")
                    break
            retried = False
            cfg = self.config
            use_local = (cfg.ba_local_window > 0
                         and len(state.registered) > max(cfg.ba_global_every,
                                                         cfg.ba_local_window + 2)
                         and (len(state.registered) % cfg.ba_global_every != 0))
            with self.timer.event("local bundle adjustment" if use_local
                                  else "global bundle adjustment"):
                inl_before = self.check_landmark_validity(state, drop=True)
                if out_folder and save_intermediate:
                    self._save(state, os.path.join(out_folder, f"clouds/cloud_before_{it}.ply"),
                               inl_before)
                if use_local:
                    window = self._covisible_window(state, added, cfg.ba_local_window)
                    self.bundle_adjust(state, local_cams=window)
                else:
                    self.bundle_adjust(state)
                inl_after = self.check_landmark_validity(state, drop=True)
                state.remove_landmarks(inl_after)
                self.complete_tracks(state)
                if out_folder and save_intermediate:
                    self._save(state, os.path.join(out_folder, f"clouds/cloud_after_{it}.ply"))
            self._log(f"registered img {added} | landmarks: {state.num_landmarks}")
            # a full-state npz per view would cost seconds a view at 100
            # views; every Nth view bounds the replay after a crash to N
            if (it % max(cfg.checkpoint_every_views, 1) == 0
                    or len(state.registered) == state.num_images):
                self._autosave(state, checkpoint_path)

        for r in range(self.config.final_refinement_rounds):
            with self.timer.event("final refinement"):
                if self.config.final_retriangulate:
                    self.retriangulate(state)
                self.check_landmark_validity(state, drop=True)
                self.bundle_adjust(state)
                keep = self.check_landmark_validity(state, drop=True)
                state.remove_landmarks(keep)
                self.complete_tracks(state)
            self._log(f"final refinement {r + 1}: {state.num_landmarks} landmarks")

        self._autosave(state, checkpoint_path)
        if out_folder:
            self._save(state, os.path.join(out_folder, "clouds/cloud_final.ply"))
            self._write_report(state, out_folder)
        if self.verbose:
            self.timer.print_timings()
        return state

    def _write_report(self, state: ReconstructionState, out_folder: str) -> None:
        """Structured run report: stage timings, counts and the registered
        views as JSON next to the cloud."""
        report = {
            "num_images": state.num_images,
            "registered": state.registered,
            "num_landmarks": int(state.num_landmarks),
            "num_observations": int(state.lm_obs_mask.sum()),
            "device": str(self.device),
            "stage_timings_ms": {k: round(v, 1) for k, v in self.timer.totals().items()},
            "config": {k: v for k, v in vars(self.config).items()
                       if isinstance(v, (int, float, str, bool, type(None)))},
        }
        with open(os.path.join(out_folder, "report.json"), "w") as f:
            json.dump(report, f, indent=2)

    # ------------------------------------------------------------------
    def _superpoint_params(self) -> superpoint.SuperPointNet:
        """The detector's network on the reconstructor's device: an
        ``.npz`` of the JAX package's layout, a magicleap state dict, or
        (no weights configured) a seeded random init."""
        if not hasattr(self, "_sp_net"):
            path = self.config.superpoint_weights
            if path and path.endswith(".npz"):
                net = superpoint.params_from_npz(path)
            elif path:
                net = superpoint.params_from_torch_state_dict(
                    torch.load(path, map_location="cpu"))
            else:
                self._log("superpoint: no weights configured, random init")
                net = superpoint.init_params(torch.Generator().manual_seed(42))
            self._sp_net = net.to(self.device)
        return self._sp_net

    def _superglue_params(self) -> superglue.SuperGlue:
        """The matcher's network on the reconstructor's device:
        ``"structured"`` (identity GNN + full Sinkhorn decode on the raw
        descriptors), an ``.npz`` of the JAX package's layout, a magicleap
        state dict, or (no weights configured) a seeded random init."""
        if not hasattr(self, "_sg_net"):
            path = self.config.superglue_weights
            if path == "structured":
                net = superglue.structured_identity_params()
            elif path and path.endswith(".npz"):
                net = superglue.params_from_npz(path)
            elif path:
                net = superglue.params_from_torch_state_dict(
                    torch.load(path, map_location="cpu"))
            else:
                self._log("superglue: no weights configured, random init")
                net = superglue.init_params(torch.Generator().manual_seed(43))
            self._sg_net = net.to(self.device)
        return self._sg_net

    def detect_features(self, img_folder: str) -> ReconstructionState:
        """Load a folder (native libjpeg or PIL decode, reference resize) and
        detect."""
        imgs = io_images.load_folder(img_folder, self.config.img_max_size)
        if len(imgs) < 2:
            raise ValueError(f"need at least 2 images, found {len(imgs)} in {img_folder}")
        return self.detect_features_from_images(imgs)

    def detect_features_from_images(self, imgs: Sequence[io_images.LoadedImage]
                                    ) -> ReconstructionState:
        """Detect and describe on already-loaded images (the seam that
        lets callers with in-memory images skip the file decode)."""
        cfg = self.config
        gray, shapes, rgb = io_images.pad_batch(imgs)
        if cfg.detector == "superpoint":
            feats = superpoint.detect_and_describe(
                self._superpoint_params(), self._t(gray), self._t(shapes),
                max_keypoints=cfg.max_keypoints,
                conf_thresh=cfg.superpoint_conf_thresh,
                nms_radius=cfg.superpoint_nms_radius,
                border=cfg.superpoint_border)
        elif cfg.detector == "orb":
            feats = orb.detect_and_describe(
                self._t(gray), self._t(shapes),
                max_keypoints=cfg.max_keypoints,
                threshold=cfg.orb_fast_threshold)
        else:
            feats = sift.detect_and_describe(
                self._t(gray), self._t(shapes),
                max_keypoints=cfg.max_keypoints,
                num_scales=cfg.sift_num_scales,
                contrast_thresh=cfg.sift_contrast_thresh,
                edge_thresh=cfg.sift_edge_thresh,
                sigma0=cfg.sift_sigma0)
        xy = feats.xy.cpu().numpy()
        mask = feats.mask.cpu().numpy()
        # per-feature color pickup (SequentialReconstructor.cpp:99-106)
        n, k = mask.shape
        xi = np.clip(xy[..., 0].astype(np.int32), 0, rgb.shape[2] - 1)
        yi = np.clip(xy[..., 1].astype(np.int32), 0, rgb.shape[1] - 1)
        colors = rgb[np.arange(n)[:, None], yi, xi]
        intr = np.stack([cam.make_intrinsics(int(h), int(w), cfg.focal_px,
                                             cfg.focal_length_factor)
                         for h, w in shapes])
        state = ReconstructionState(
            num_images=n, max_keypoints=k,
            xy=xy, desc=feats.desc.cpu().numpy(), kp_mask=mask,
            colors=colors, shapes=shapes, intrinsics=intr,
            kp_score=feats.score.cpu().numpy())
        self._log(f"detected features: {mask.sum(1).tolist()}")
        return state

    # ------------------------------------------------------------------
    def _device_frontend(self, state: ReconstructionState):
        """Device copies of (desc, kp_mask, xy), cached on the state, with
        the keypoint axis fitted to the dataset's real occupancy: slots
        are score-sorted (valid keypoints are a prefix) and matching cost
        is quadratic in K. Kt is the max per-image count rounded up to
        256, the CUDA kernel's tile multiple; where that passes
        ``max_keypoints`` the extra slots are masked padding. Slot ids
        are unchanged."""
        cache = getattr(state, "_dev_frontend", None)
        if cache is None or cache[0] is not state.desc or cache[4] != self.device:
            counts = np.asarray(state.kp_mask).sum(axis=1)
            kt = int(counts.max()) if counts.size else 0
            kt = max(256, -(-kt // 256) * 256)

            def fit(a):
                a = a[:, :kt]
                pad = [(0, 0), (0, kt - a.shape[1])] + [(0, 0)] * (a.ndim - 2)
                return np.ascontiguousarray(np.pad(a, pad))
            cache = (state.desc, self._t(fit(state.desc)), self._t(fit(state.kp_mask)),
                     self._t(fit(state.xy)), self.device)
            state._dev_frontend = cache
        return cache[1], cache[2], cache[3]

    def select_pairs(self, state: ReconstructionState) -> np.ndarray:
        """Pair-selection stage (matchImages parity,
        SequentialReconstructor.cpp:1002 / ImageMatcher.cpp:6-24):
        ``exhaustive`` (all unordered pairs) or ``retrieval``
        (global-descriptor top-k)."""
        cfg = self.config
        if cfg.pair_selection == "retrieval":
            return pairing.retrieval_pairs(state.desc, state.kp_mask,
                                           top_k=cfg.retrieval_top_k)
        return pairing.exhaustive_pairs(state.num_images)

    def match_features(self, state: ReconstructionState, filter: bool = True) -> None:
        """kNN + ratio + mutual matching of every selected pair, fused with
        the epipolar gate (filter=True), in chunks of pairs. On the card
        the chunk is up to ``match_chunk_pairs_fused`` pairs through the
        CUDA top-2 kernel with ``knn_compute_dtype`` descriptors; on the
        CPU it is ``match_chunk_pairs`` through the plain matcher in
        float32 (the TPU package's platform rule), rounded up to a multiple
        of the world size. The chunk goes through the sharded matchers
        (``parallel.sharding``), over the mesh or a world of one. A chunk
        holds only real pairs: the last one is shorter, not padded (the
        sharded matchers pad their slices themselves, and draw the F-gate's
        draws for real pairs only). With
        ``matcher="superglue"`` the pairs go through ``_match_superglue``
        and then, with filter=True, the gate of ``_filter_matches``."""
        with profiling.annotate("match.pass"):
            cfg = self.config
            pair_idx = self.select_pairs(state)
            if cfg.matcher == "superglue":
                midx, mmask = self._match_superglue(state, pair_idx)
                if filter:
                    mmask = self._filter_matches(state, pair_idx, midx, mmask)
                with profiling.annotate("match.tables"):
                    for p, (i, j) in enumerate(pair_idx):
                        m = np.where(mmask[p], midx[p], -1).astype(np.int32)
                        if (m >= 0).sum() > 0:
                            state.matches[(int(i), int(j))] = m
                return
            desc_d, mask_d, xy_d = self._device_frontend(state)
            Kt = int(desc_d.shape[1])
            on_card = self.device.type == "cuda"
            compute_dtype = cfg.knn_compute_dtype if on_card else "float32"
            B = cfg.match_chunk_pairs_fused if on_card else cfg.match_chunk_pairs
            B = -(-B // self._shards.size) * self._shards.size
            P = pair_idx.shape[0]
            K = state.max_keypoints
            n = min(K, Kt)
            results = []
            for s0 in range(0, P, B):
                with profiling.annotate("match.chunk"):
                    e = min(s0 + B, P)
                    chunk = np.ascontiguousarray(pair_idx[s0:e], dtype=np.int32)
                    if filter:
                        out = sharding.match_and_gate_sharded(
                            self._shards, desc_d, mask_d, xy_d, chunk,
                            ratio_thresh=cfg.ratio_thresh, cross_check=cfg.cross_check,
                            num_hypotheses=cfg.fundamental_num_hypotheses,
                            thresh_px=cfg.fundamental_thresh_px,
                            min_matches=cfg.min_matches_for_filter,
                            compute_dtype=compute_dtype, generator=self._gen)
                    else:
                        mi, mm = sharding.match_all_pairs_sharded(
                            self._shards, desc_d, mask_d, chunk, ratio_thresh=cfg.ratio_thresh,
                            cross_check=cfg.cross_check, compute_dtype=compute_dtype)
                        out = (torch.where(mm, mi, -1), mm.sum(1))
                    results.append((s0, e, out))
            with profiling.annotate("match.tables"):
                for s0, e, (mi, cnt) in results:
                    mi = mi.cpu().numpy()
                    cnt = cnt.cpu().numpy()
                    for q in range(e - s0):
                        if cnt[q] > 0:
                            i, j = pair_idx[s0 + q]
                            full = np.full(K, -1, np.int32)
                            full[:n] = mi[q, :n]
                            state.matches[(int(i), int(j))] = full

    def _match_superglue(self, state: ReconstructionState, pair_idx: np.ndarray):
        """SuperGlue over every pair (FeatureMatcherSuperglue parity:
        +-0.7 coordinate normalisation, score > 0.5 gate), at the full
        ``max_keypoints`` width, in chunks of ``superglue_chunk_pairs``
        real pairs (the last one shorter; rounded up to a multiple of the
        world size), through ``match_superglue_sharded`` over the mesh or a
        world of one. On the card the Sinkhorn step is the CUDA kernel, on
        the CPU the plain loop (the TPU package's rule ``platform not in
        ("cpu",)``). Returns (match_idx (P, K),
        match_mask (P, K)) as numpy."""
        cfg = self.config
        net = self._superglue_params()
        P = pair_idx.shape[0]
        K = state.max_keypoints
        desc, xy = self._t(state.desc), self._t(state.xy)
        score, kmask = self._t(state.kp_score), self._t(state.kp_mask)
        shapes = self._t(state.shapes)
        B = -(-cfg.superglue_chunk_pairs // self._shards.size) * self._shards.size
        results = []
        for s0 in range(0, P, B):
            with profiling.annotate("match.chunk"):
                e = min(s0 + B, P)
                chunk = np.ascontiguousarray(pair_idx[s0:e], dtype=np.int32)
                idx, ok, _ = sharding.match_superglue_sharded(
                    self._shards, net, desc, xy, score, kmask, shapes, chunk,
                    sinkhorn_iters=cfg.superglue_sinkhorn_iters,
                    score_thresh=cfg.superglue_score_thresh)
                results.append((s0, e, idx, ok))
        midx = np.full((P, K), -1, np.int32)
        mmask = np.zeros((P, K), bool)
        with profiling.annotate("match.tables"):
            for s0, e, idx, ok in results:
                midx[s0:e] = idx.cpu().numpy()
                mmask[s0:e] = ok.cpu().numpy()
        return midx, mmask

    def _filter_matches(self, state: ReconstructionState, pair_idx: np.ndarray,
                        midx: np.ndarray, mmask: np.ndarray) -> np.ndarray:
        """Fundamental-RANSAC gate on every pair, in chunks of
        ``filter_chunk_pairs`` real pairs, with draws from the
        reconstructor's generator. A pair with fewer than
        ``min_matches_for_filter`` raw matches keeps them all
        (SequentialReconstructor.cpp:237). Returns the gated mask."""
        cfg = self.config
        P = pair_idx.shape[0]
        K = state.max_keypoints
        B = cfg.filter_chunk_pairs
        out = mmask.copy()
        raw_counts = mmask.sum(1)
        p1_all = state.xy[pair_idx[:, 0]]                                 # (P, K, 2)
        p2_all = state.xy[pair_idx[:, 1][:, None], np.clip(midx, 0, K - 1)]
        results = []
        for s in range(0, P, B):
            e = min(s + B, P)
            inl = gated.filter_pairs(
                self._t(p1_all[s:e]), self._t(p2_all[s:e]), self._t(mmask[s:e]),
                num_hypotheses=cfg.fundamental_num_hypotheses,
                thresh_px=cfg.fundamental_thresh_px, generator=self._gen)
            results.append((s, e, inl))
        for s, e, inl in results:
            inl = inl.cpu().numpy()
            for bi, p in enumerate(range(s, e)):
                if raw_counts[p] >= cfg.min_matches_for_filter:
                    out[p] = inl[bi] & mmask[p]
        return out

    # ------------------------------------------------------------------
    def choose_initial_pair(self, state: ReconstructionState) -> Tuple[int, int, np.ndarray]:
        """Highest-match-count pair -> essential -> cheirality pose
        (chooseInitialPair parity, SequentialReconstructor.cpp:325-375)."""
        cfg = self.config
        best = max(state.matches.items(), key=lambda kv: (kv[1] >= 0).sum())
        (i1, i2), m = best
        sel = np.where(m >= 0)[0]
        uv1 = state.xy[i1, sel]
        uv2 = state.xy[i2, m[sel]]
        mask = np.ones(sel.size, bool)
        pose, _, _, cnt = epipolar.estimate_relative_pose(
            self._t(uv1), self._t(uv2),
            self._t(state.intrinsics[i1]), self._t(state.intrinsics[i2]),
            self._t(mask), thresh_px=cfg.essential_thresh_px,
            num_hypotheses=cfg.ransac_num_hypotheses, generator=self._gen)
        self._log(f"essential inliers: {int(cnt)} / {sel.size}")
        return int(i1), int(i2), pose.cpu().numpy()

    # ------------------------------------------------------------------
    def _batch_triangulate(self, state: ReconstructionState,
                           obs_img: np.ndarray, obs_feat: np.ndarray,
                           obs_mask: np.ndarray):
        """Triangulate+validate candidate landmarks given their (n, V)
        observation tables. Returns (xyz, valid) as numpy."""
        cfg = self.config
        poses_all = np.stack([state.poses.get(i, np.eye(4, dtype=np.float32))
                              for i in range(state.num_images)])
        xyz, valid = triangulation.triangulate_and_validate(
            self._t(poses_all[obs_img]), self._t(state.intrinsics[obs_img]),
            self._t(state.xy[obs_img, obs_feat]), self._t(obs_mask),
            cfg.max_projection_error, cfg.min_triangulation_angle)
        return xyz.cpu().numpy(), valid.cpu().numpy()

    def triangulate_initial_pair(self, state: ReconstructionState, i1: int, i2: int) -> None:
        m = state.match_lookup(i1, i2)
        f1 = np.where(m >= 0)[0]
        f2 = m[f1]
        n = f1.size
        V = MAX_VIEWS_PER_LANDMARK
        obs_img = np.zeros((n, V), np.int32)
        obs_feat = np.zeros((n, V), np.int32)
        obs_mask = np.zeros((n, V), bool)
        obs_img[:, 0] = i1
        obs_feat[:, 0] = f1
        obs_img[:, 1] = i2
        obs_feat[:, 1] = f2
        obs_mask[:, :2] = True
        xyz, valid = self._batch_triangulate(state, obs_img, obs_feat, obs_mask)
        rgb = state.colors[i1, f1]
        state.add_landmarks(xyz[valid], rgb[valid], obs_img[valid],
                            obs_feat[valid], obs_mask[valid], initial=True)

    # ------------------------------------------------------------------
    def calc_2d3d_matches(self, state: ReconstructionState,
                          candidates: List[int]) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """2d-3d correspondence mining (calc2d3dMatches parity,
        SequentialReconstructor.cpp:643-695), vectorized per candidate:
        landmarks seen in a registered image whose features match the
        candidate's unassigned features; one landmark per candidate
        feature (first registered image wins)."""
        out = {}
        empty = (np.zeros(0, np.int32), np.zeros(0, np.int32))
        F2L = state.feat2lm
        reg = list(state.registered)
        for c in candidates:
            tabs, rids = [], []
            for r in reg:
                m = state.match_lookup(c, r)
                if m is not None:
                    tabs.append(m)
                    rids.append(r)
            if not tabs:
                out[c] = empty
                continue
            M = np.stack(tabs)
            lmtab = F2L[np.asarray(rids)[:, None], np.maximum(M, 0)]
            valid = (M >= 0) & (lmtab >= 0) & (F2L[c] == -1)[None, :]
            fc = np.nonzero(valid.any(axis=0))[0]
            if fc.size == 0:
                out[c] = empty
                continue
            first_r = valid[:, fc].argmax(axis=0)
            lm = lmtab[first_r, fc]
            out[c] = (lm.astype(np.int32), fc.astype(np.int32))
        return out

    def rank_next_images(self, state: ReconstructionState,
                         matches_2d3d: Dict[int, Tuple[np.ndarray, np.ndarray]]) -> List[int]:
        """Next-view ranking (rankNextImages parity,
        SequentialReconstructor.cpp:697-759)."""
        cfg = self.config
        scores = {}
        for c, (lm_ids, feat_ids) in matches_2d3d.items():
            if cfg.ranking_mode == "total":
                scores[c] = lm_ids.size
            else:
                h, w = state.shapes[c]
                g = cfg.ranking_grid
                xy = state.xy[c, feat_ids]
                cx = np.clip((g * xy[:, 0] / float(w)).astype(int), 0, g - 1)
                cy = np.clip((g * xy[:, 1] / float(h)).astype(int), 0, g - 1)
                scores[c] = np.unique(cy * g + cx).size
        ranked = sorted(scores, key=lambda c: -scores[c])
        passing = [c for c in ranked if scores[c] > cfg.min_2d3d_match_num]
        if not passing and ranked:
            # the reference would crash on an empty list (cpp:793)
            passing = ranked[:1]
        return passing

    def register_image_pnp(self, state: ReconstructionState, img: int,
                           lm_ids: np.ndarray, feat_ids: np.ndarray):
        """PnP registration (registerImagePnP parity,
        SequentialReconstructor.cpp:559-638). Returns (pose, inlier sel)."""
        cfg = self.config
        n = lm_ids.size
        pose, inl, _ = pnp.solve_pnp_ransac(
            self._t(state.lm_xyz[lm_ids]), self._t(state.xy[img, feat_ids]),
            self._t(state.intrinsics[img]), self._t(np.ones(n, bool)),
            thresh_px=cfg.max_projection_error,
            num_hypotheses=cfg.pnp_num_hypotheses,
            refine_iters=cfg.pnp_refine_iters, generator=self._gen)
        inl = inl.cpu().numpy()
        self._log(f"imgIdx: {img} numInliers: {int(inl.sum())} totalMatches: {n}")
        return pose.cpu().numpy(), inl

    def triangulate_matched_landmarks(self, state: ReconstructionState, img: int,
                                      lm_ids: np.ndarray, feat_ids: np.ndarray) -> None:
        """Attach observations + create new landmarks
        (triangulateMatchedLandmarks parity, cpp:492-557)."""
        cfg = self.config
        pose = state.poses[img]
        intr = state.intrinsics[img]
        # 1. attach 2d-3d inlier matches as new observations, gated on
        #    positive depth, L1 reprojection and unassigned feature (cpp:506)
        if lm_ids.size:
            pts = state.lm_xyz[lm_ids]
            local = pts @ pose[:3, :3].T + pose[:3, 3]
            uv = state.xy[img, feat_ids]
            err = np_ops.reprojection_error_l1(intr, local, uv)
            ok = ((local[:, 2] > 0) & (err < cfg.max_projection_error)
                  & (state.feat2lm[img, feat_ids] == -1))
            state.add_observations(lm_ids[ok], np.full(int(ok.sum()), img, np.int32),
                                   feat_ids[ok])

        # 2. unassigned features: multi-view triangulation against ALL
        #    registered partners whose matched features are also unassigned
        free = np.where((state.feat2lm[img] == -1) & state.kp_mask[img])[0]
        V = MAX_VIEWS_PER_LANDMARK
        n = free.size
        if n == 0:
            return
        obs_img = np.zeros((n, V), np.int32)
        obs_feat = np.zeros((n, V), np.int32)
        obs_mask = np.zeros((n, V), bool)
        obs_img[:, 0] = img
        obs_feat[:, 0] = free
        obs_mask[:, 0] = True
        slot = np.ones(n, np.int32)
        for r in state.registered:
            if r == img:
                continue
            m = state.match_lookup(img, r)
            if m is None:
                continue
            partner = m[free]
            ok = partner >= 0
            ok[ok] &= state.feat2lm[r, partner[ok]] == -1
            ok &= slot < V
            rows = np.where(ok)[0]
            obs_img[rows, slot[rows]] = r
            obs_feat[rows, slot[rows]] = partner[rows]
            obs_mask[rows, slot[rows]] = True
            slot[rows] += 1
        multi = slot >= 2
        if not multi.any():
            return
        obs_img, obs_feat, obs_mask = obs_img[multi], obs_feat[multi], obs_mask[multi]
        xyz, valid = self._batch_triangulate(state, obs_img, obs_feat, obs_mask)
        rgb = state.colors[obs_img[:, 0], obs_feat[:, 0]]
        state.add_landmarks(xyz[valid], rgb[valid], obs_img[valid],
                            obs_feat[valid], obs_mask[valid])

    def complete_tracks(self, state: ReconstructionState) -> int:
        """Attach missing observations of existing landmarks across all
        registered views (COLMAP-style track completion). Returns the
        number of observations added."""
        cfg = self.config
        added = 0
        for r, (lm_ids, feat_ids) in self.calc_2d3d_matches(
                state, list(state.registered)).items():
            if lm_ids.size == 0:
                continue
            pose = state.poses[r]
            local = state.lm_xyz[lm_ids] @ pose[:3, :3].T + pose[:3, 3]
            err = np_ops.reprojection_error_l1(state.intrinsics[r], local,
                                               state.xy[r, feat_ids])
            ok = ((local[:, 2] > 0) & (err < cfg.max_projection_error)
                  & (state.feat2lm[r, feat_ids] == -1))
            added += state.add_observations(
                lm_ids[ok], np.full(int(ok.sum()), r, np.int32), feat_ids[ok])
        return added

    def match_features_to_landmarks(self, state: ReconstructionState, img: int):
        """Direct 2D-3D mining: match the candidate's descriptors against
        landmark descriptors (each landmark represented by its first
        observation's descriptor) with the plain matcher."""
        if state.num_landmarks == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        lm_desc = state.desc[state.lm_obs_img[:, 0], state.lm_obs_feat[:, 0]]
        midx, mmask = knn.match_pair(
            self._t(state.desc[img]), self._t(lm_desc),
            self._t(state.kp_mask[img]), self._t(state.lm_obs_mask[:, 0]),
            ratio_thresh=0.9, cross_check=True)
        midx = midx.cpu().numpy()
        sel = np.where(mmask.cpu().numpy() & (state.feat2lm[img] == -1))[0]
        return midx[sel].astype(np.int32), sel.astype(np.int32)

    def _try_register(self, state: ReconstructionState, img: int,
                      lm_ids: np.ndarray, feat_ids: np.ndarray) -> bool:
        if lm_ids.size < 6:
            return False
        pose, inl = self.register_image_pnp(state, img, lm_ids, feat_ids)
        # reject registrations the pose evidence cannot support (the
        # reference registers unconditionally, cpp:797-801)
        if int(inl.sum()) < self.config.pnp_min_inliers:
            self._log(f"rejecting img {img}: only {int(inl.sum())} PnP inliers")
            return False
        state.poses[img] = pose
        self.triangulate_matched_landmarks(state, img, lm_ids[inl], feat_ids[inl])
        state.registered.append(img)
        return True

    def add_next_view(self, state: ReconstructionState) -> Optional[int]:
        """addNextView parity (cpp:761-813) + landmark-descriptor rescue."""
        candidates = [i for i in range(state.num_images) if i not in state.poses]
        if not candidates:
            return None
        matches_2d3d = self.calc_2d3d_matches(state, candidates)
        for img in self.rank_next_images(state, matches_2d3d):
            lm_ids, feat_ids = matches_2d3d[img]
            if self._try_register(state, img, lm_ids, feat_ids):
                return img
        # rescue pass: every remaining candidate gets one shot at direct
        # feature-to-landmark matching, best-connected first
        order = sorted(candidates, key=lambda c: -matches_2d3d[c][0].size)
        for img in order:
            if img in state.poses:
                continue
            lm_ids, feat_ids = self.match_features_to_landmarks(state, img)
            self._log(f"rescue 2d-3d for img {img}: {lm_ids.size} direct matches")
            if self._try_register(state, img, lm_ids, feat_ids):
                return img
        return None

    def retriangulate(self, state: ReconstructionState) -> int:
        """Re-solve every landmark's position by multi-view DLT from the
        current camera poses; positions update only where the re-solve
        passes the reprojection + angle gates. Returns the count updated."""
        if state.num_landmarks == 0:
            return 0
        xyz, valid = self._batch_triangulate(state, state.lm_obs_img,
                                             state.lm_obs_feat, state.lm_obs_mask)
        state.lm_xyz[valid] = xyz[valid]
        return int(valid.sum())

    # ------------------------------------------------------------------
    def check_landmark_validity(self, state: ReconstructionState,
                                drop: bool = False) -> np.ndarray:
        """Batched validity sweep; optionally drops failing observations
        in place (the reference mutates during the check, cpp:896)."""
        cfg = self.config
        if state.num_landmarks == 0:
            return np.zeros(0, bool)
        poses_all = np.stack([state.poses.get(i, np.eye(4, dtype=np.float32))
                              for i in range(state.num_images)])
        valid, new_mask = _check_landmarks(
            self._t(state.lm_xyz), self._t(poses_all), self._t(state.intrinsics),
            self._t(state.lm_obs_img).long(), self._t(state.lm_obs_feat).long(),
            self._t(state.lm_obs_mask), self._t(state.xy),
            cfg.max_projection_error, cfg.min_triangulation_angle)
        valid = valid.cpu().numpy()
        new_mask = new_mask.cpu().numpy()
        if drop:
            state.drop_observations(state.lm_obs_mask & ~new_mask)
        return valid

    # ------------------------------------------------------------------
    def _covisible_window(self, state: ReconstructionState, img: int,
                          window: int) -> List[int]:
        """``img`` plus its (window-1) most covisible registered cameras,
        ranked by shared-landmark count."""
        rows = ((state.lm_obs_img == img) & state.lm_obs_mask).any(axis=1)
        counts = np.bincount(state.lm_obs_img[rows][state.lm_obs_mask[rows]],
                             minlength=state.num_images)
        counts[img] = 0
        reg = np.zeros(state.num_images, bool)
        reg[state.registered] = True
        counts[~reg] = 0
        top = np.argsort(-counts)[:max(window - 1, 0)]
        return [img] + [int(t) for t in top if counts[t] > 0]

    def bundle_adjust(self, state: ReconstructionState,
                      local_cams: Optional[List[int]] = None) -> None:
        """Bundle adjustment (BundleAdjuster::adjust parity).

        Global by default: all registered cameras and landmarks. With
        ``local_cams`` this is a COLMAP-style local BA: only landmarks
        observed by the window participate, only window cameras move, and
        the cameras outside the window that co-observe those landmarks
        enter as fixed anchors (which also pins the gauge).
        """
        cfg = self.config
        obs_lm, obs_img, obs_feat = state.flat_observations()
        reg_mask = np.isin(obs_img, state.registered)
        obs_lm, obs_img, obs_feat = obs_lm[reg_mask], obs_img[reg_mask], obs_feat[reg_mask]

        lm_sel = None
        if local_cams is None:
            order = list(state.registered)
            L = state.num_landmarks
            points_src = state.lm_xyz
        else:
            local_set = set(int(c) for c in local_cams)
            lm_sel = np.unique(obs_lm[np.isin(obs_img, list(local_set))])
            keep = np.isin(obs_lm, lm_sel)
            obs_lm, obs_img, obs_feat = obs_lm[keep], obs_img[keep], obs_feat[keep]
            remap = np.full(state.num_landmarks, -1, np.int64)
            remap[lm_sel] = np.arange(lm_sel.size)
            obs_lm = remap[obs_lm]
            # fixed anchors first, window cameras after
            participating = set(np.unique(obs_img).tolist()) | local_set
            order = sorted(participating - local_set) + sorted(local_set)
            L = lm_sel.size
            points_src = state.lm_xyz[lm_sel]

        C = len(order)
        if obs_lm.size == 0:
            return
        # The reference pads cameras to a multiple of 16 and observations
        # and landmarks to powers of two. The padding changes no value,
        # but the solver's choice of how to sum the point side (see
        # ba.lm._layout) reads these sizes, so the same padding keeps the
        # two packages on the same route.
        C_pad = max(16, -(-C // 16) * 16)
        g2l = {g: l for l, g in enumerate(order)}
        poses_arr = np.stack([state.poses[g] for g in order])
        cam_params = np.zeros((C_pad, 12), np.float32)
        cam_params[:C, :3] = np_ops.rotation_to_angle_axis(poses_arr[:, :3, :3])
        cam_params[:C, 3:6] = poses_arr[:, :3, 3]
        cam_params[:C, 6:] = state.intrinsics[np.asarray(order, np.int64)]

        O = obs_lm.size
        O_pad = ba_lm._bucket(O, 1)
        L_pad = ba_lm._bucket(max(L, 1), 1)
        obs_cam_l = np.zeros(O_pad, np.int32)
        obs_pt = np.zeros(O_pad, np.int32)
        obs_uv = np.zeros((O_pad, 2), np.float32)
        obs_mask = np.zeros(O_pad, bool)
        obs_cam_l[:O] = [g2l[g] for g in obs_img]
        obs_pt[:O] = obs_lm
        obs_uv[:O] = state.observation_uv(obs_img, obs_feat)
        obs_mask[:O] = True
        points = np.zeros((L_pad, 3), np.float32)
        points[:L] = points_src

        cam_free = np.zeros((C_pad, 12), np.float32)
        if local_cams is None:
            cam_free[:C] = ba_lm.make_cam_free_mask(C, cfg.ba_intrinsics_free_min_cams)
        else:
            n_fixed = C - len(local_set)
            if n_fixed == 0:
                # no anchors — fall back to the reference gauge policy
                cam_free[:C] = ba_lm.make_cam_free_mask(C, cfg.ba_intrinsics_free_min_cams)
            else:
                cam_free[n_fixed:C, :6] = 1.0
                # intrinsics policy follows the FULL registered count
                if len(state.registered) >= cfg.ba_intrinsics_free_min_cams:
                    cam_free[n_fixed:C, 6:8] = 1.0     # focal free
                    cam_free[n_fixed:C, 10:12] = 1.0   # distortion free

        prob = ba_lm.BAProblem(
            cam_params=self._t(cam_params), points=self._t(points),
            obs_cam=self._t(obs_cam_l), obs_pt=self._t(obs_pt), obs_uv=self._t(obs_uv),
            obs_mask=self._t(obs_mask), cam_free=self._t(cam_free))
        if local_cams is not None:
            max_iters = cfg.ba_local_max_iters
        else:
            max_iters = cfg.ba_max_iters_small if C < 10 else cfg.ba_max_iters_large
        common = dict(max_iters=max_iters, init_lambda=cfg.ba_init_lambda,
                      lambda_up=cfg.ba_lambda_up, lambda_down=cfg.ba_lambda_down,
                      ftol=cfg.ba_ftol, focal_upper_bound=cfg.ba_focal_upper_bound,
                      huber_delta=cfg.ba_huber_delta, damping=cfg.ba_damping)
        # the dense coupling W is (C*12, L*3): past the element budget the
        # implicit-Schur PCG solver (no W, sums over observations) runs;
        # over a mesh it always does, its observations sharded
        if self.mesh is not None:
            self.ba_calls["distributed"] += 1
            result = distributed.solve_distributed(self.mesh, prob, **common)
        elif uses_pcg(cfg, C_pad, L_pad):
            self.ba_calls["pcg"] += 1
            result = distributed.solve_pcg(prob, **common)
        else:
            self.ba_calls["dense"] += 1
            result = ba_lm.solve(prob, compact=False, host_obs=(obs_pt, obs_cam_l, obs_mask),
                                 **common)
        self._log(f"BA: cost {float(result.cost_initial):.1f} -> "
                  f"{float(result.cost_final):.1f} in {int(result.iterations)} iters")

        new_cams = result.cam_params.cpu().numpy()
        R_all = np_ops.angle_axis_to_rotation(new_cams[:C, :3])
        for g, l in g2l.items():
            if local_cams is not None and g not in local_set:
                continue  # fixed anchor — unchanged by construction
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R_all[l]
            T[:3, 3] = new_cams[l, 3:6]
            state.poses[g] = T
            state.intrinsics[g] = new_cams[l, 6:]
        pts = result.points.cpu().numpy()
        if lm_sel is None:
            state.lm_xyz[:] = pts[:L]
        else:
            state.lm_xyz[lm_sel] = pts[:L]

    # ------------------------------------------------------------------
    def _save(self, state: ReconstructionState, path: str,
              inliers: Optional[np.ndarray] = None) -> None:
        poses = np.stack([state.poses[i] for i in state.registered]) \
            if state.registered else None
        ply.save_cloud(path, state.lm_xyz, state.lm_rgb, poses, inliers)
