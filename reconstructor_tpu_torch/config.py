r"""Configuration for the PyTorch/CUDA SfM engine.

Field for field the configuration of ``reconstructor_tpu``, so one set of
keyword arguments drives either package, except the TPU package's two
kernel switches, ``knn_use_pallas`` and ``superglue_use_pallas_sinkhorn``:
on the card the CUDA top-2 kNN kernel and the CUDA Sinkhorn kernel always
run, and no setting sends the card to their plain versions.

The reference hardcodes every knob as enums, ``#define``\ s and member
defaults scattered over headers (SURVEY.md §5 "Config / flag system"); this
module lifts all of them into one dataclass so a single object drives the
whole pipeline. Default values replicate the reference's:

- ``img_max_size=512``               SequentialReconstructor.h:246
- ``focal_length_factor=1.2``        SequentialReconstructor.h:261
- ``max_projection_error=4.0``       SequentialReconstructor.h:256
- ``min_triangulation_angle=1.0``    SequentialReconstructor.h:257
- ``min_2d3d_match_num=30``          SequentialReconstructor.h:240
- ``ranking_mode='density'``         SequentialReconstructor.h:237
- ``ratio_thresh=0.7``               FeatureMatcher.h:45
- ``superpoint_conf_thresh=0.015``   FeatureSuperPoint.h:28-30
- ``superpoint_nms_radius=4``        FeatureSuperPoint.cpp:18
- ``superpoint_border=4``            FeatureSuperPoint.cpp:76
- ``superglue_score_thresh=0.5``     FeatureMatcherSuperglue.h:25
- PnP budget 10000 iters / 4.0 px / 0.99 conf
                                     SequentialReconstructor.cpp:591-597
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ReconstructorConfig:
    # ---- image preprocessing -------------------------------------------
    img_max_size: int = 512          # cap on max image side before detection
    # Focal priors: if focal_px is set it is used directly (Camera.h:18-27);
    # otherwise colmap-style f = factor * max(h, w) (Camera.h:45-54).
    focal_px: Optional[float] = None
    focal_length_factor: float = 1.2

    # ---- feature detection ---------------------------------------------
    detector: str = "sift"           # "sift" | "orb" | "superpoint"
    orb_fast_threshold: float = 0.06
    max_keypoints: int = 4096        # fixed per-image keypoint capacity
    # (4096 registers all 25 fountain views; 2048 loses the 4 tail views)
    sift_num_scales: int = 12        # full-res scale levels, ratio 2^(1/3)
    sift_sigma0: float = 0.8         # finest detection sigma (native px)
    sift_contrast_thresh: float = 0.004
    sift_edge_thresh: float = 10.0
    superpoint_conf_thresh: float = 0.015
    superpoint_nms_radius: int = 4
    superpoint_border: int = 4
    # weights: an .npz in the JAX package's layout (tests/data), a torch
    # checkpoint (magicleap superpoint_v1.pth / superglue_outdoor.pth),
    # "structured" for SuperGlue (identity GNN, see matching.superglue),
    # or None -> seeded random init (tests only)
    superpoint_weights: Optional[str] = None
    superglue_weights: Optional[str] = None

    # RANSAC key-stream seed (essential/fundamental/PnP draws). Results
    # are deterministic per seed; quality metrics should be reported
    # over several seeds (bench.py runs 3) because registration-order
    # variance moves fountain ATE by a few tenths of a point.
    rng_seed: int = 0

    # ---- pair selection (matchImages stage) ------------------------------
    # "exhaustive" = the reference's FakeImgMatcher (all unordered pairs);
    # "retrieval" = global-descriptor top-k pruning (the reference's FAISS
    # TODO, README:40) — for image counts where O(N^2) matching hurts.
    pair_selection: str = "exhaustive"
    retrieval_top_k: int = 10

    # ---- matching -------------------------------------------------------
    matcher: str = "knn"             # "knn" (FLANN equivalent) | "superglue"
    ratio_thresh: float = 0.7        # Lowe ratio test
    cross_check: bool = True         # mutual-nearest constraint
    superglue_score_thresh: float = 0.5
    superglue_sinkhorn_iters: int = 100
    superglue_chunk_pairs: int = 8   # pairs per SuperGlue chunk (GNN + Sinkhorn launch)
    min_matches_for_filter: int = 7  # need >=7 for F estimation

    # ---- geometric verification ----------------------------------------
    fundamental_thresh_px: float = 3.0   # cv::findFundamentalMat default
    essential_thresh_px: float = 1.0     # cv::findEssentialMat default
    ransac_num_hypotheses: int = 2048    # initial-pair E/H budget
    # Per-pair F-gating runs on every pair; after ratio + cross-check the
    # inlier fraction is high, so a smaller budget loses nothing and the
    # batched 9x9 nullspace solves dominate matching cost otherwise.
    fundamental_num_hypotheses: int = 512
    filter_chunk_pairs: int = 64         # pairs per F-gate chunk after SuperGlue
    match_chunk_pairs: int = 256         # pairs per matching+gate chunk, plain matcher
    # Pairs per chunk on the CUDA-kernel path. The kernel keeps the (K, K)
    # distance tile out of device memory, so memory does not bound the
    # chunk; the value is the JAX package's (chosen there on a TPU). The
    # plain matcher materializes (B, K, K) and keeps match_chunk_pairs.
    match_chunk_pairs_fused: int = 512
    # Matmul input dtype for descriptor distances ("float32" | "bfloat16")
    # on the card: bf16 inputs, float32 accumulation; rounding is ~2^-9
    # relative on unit-norm descriptors. The CPU path always uses float32.
    knn_compute_dtype: str = "bfloat16"
    ransac_confidence: float = 0.99

    # ---- incremental engine ---------------------------------------------
    max_projection_error: float = 4.0    # L1 |du|+|dv| gate, px
    min_triangulation_angle: float = 1.0 # degrees
    min_2d3d_match_num: int = 30
    ranking_mode: str = "density"        # "density" | "total"
    ranking_grid: int = 32               # 32x32 occupancy cells
    pnp_num_hypotheses: int = 2048
    pnp_refine_iters: int = 10
    pnp_min_inliers: int = 12        # reject registrations weaker than this

    # ---- bundle adjustment ----------------------------------------------
    ba_max_iters_small: int = 150        # <10 cameras (BundleAdjuster.cpp:135)
    # The reference caps at 50 (BundleAdjuster.cpp:136); the JAX package
    # measured fountain-25 BAs still descending at 50 (100 iters + 3
    # refinement rounds took its ATE from 3.2% to 2.2% of extent).
    ba_max_iters_large: int = 100
    ba_intrinsics_free_min_cams: int = 10
    ba_focal_upper_bound: float = 1000.0
    ba_solver: str = "dense_schur"   # "dense_schur" | "pcg"
    # dense_schur materializes the (C*12, L*3) coupling matrix; above
    # this element budget (~1.2 GB f32 + solver intermediates) the
    # implicit-Schur PCG solver is used instead (matvec segment-sums,
    # O(C+L+O) memory) — the 100-view stress lives there.
    ba_dense_w_max_elems: int = 300_000_000
    # Huber robust loss on the BA reprojection residual (px; 0 = plain
    # squared loss = reference parity, BundleAdjuster.cpp:95-97 passes no
    # loss function). Robustness to the outlier tail that survives the
    # 4 px validity gates measurably tightens the trajectory.
    ba_huber_delta: float = 3.0
    ba_init_lambda: float = 1e-3
    ba_lambda_up: float = 4.0
    ba_lambda_down: float = 2.0
    # Ceres function_tolerance default (the reference sets no tolerance,
    # BundleAdjuster.cpp:131-142, so it inherits 1e-6)
    ba_ftol: float = 1e-6
    # LM damping: "marquardt" = lambda * clip(diag(H)) (Ceres-style,
    # scale-aware — the problem mixes focal px with radians); "levenberg"
    # = lambda * I (what the reference's plain-Ceres defaults resolve to
    # after its trust-region schedule).
    ba_damping: str = "marquardt"
    # Extra global refinement rounds (validity sweep + BA + track
    # completion) after the last view registers. The reference stops at
    # the last per-view BA; the tail views it registers last never get a
    # re-triangulation pass, which these rounds provide.
    # The JAX package measured 6 rounds ~0.5 ATE points better than 3 on
    # fountain-25 (2.29% vs 2.86% of extent).
    final_refinement_rounds: int = 6
    # Re-solve every landmark's DLT from the final poses before each
    # refinement round (COLMAP-style retriangulation; resets points that
    # were triangulated against early, less-accurate poses).
    final_retriangulate: bool = True
    # Checkpoint autosave cadence (registered views between full-state npz
    # writes) when the reconstructor is given a checkpoint path.
    checkpoint_every_views: int = 3
    # Local (windowed) BA: when > 0 and more than ba_global_every views
    # are registered, each new view triggers a local BA over itself plus
    # its (window-1) most covisible registered cameras, with fixed
    # co-observing anchors; a full global BA still runs every
    # ba_global_every registrations and in the final refinement rounds.
    # 0 = reference behavior (global BA after every view). Default is the
    # COLMAP-style local policy: quality holds (periodic global + final
    # refinement rounds re-anchor everything) and per-view cost stops
    # growing with the map.
    ba_local_window: int = 8
    ba_global_every: int = 8
    # LM iteration budget for windowed local BAs (global rounds and the
    # final refinement use ba_max_iters_*). The JAX package measured 20
    # iters costing fountain-25 ATE (2.19% -> 2.51% of extent); 50 holds.
    ba_local_max_iters: int = 50

    # ---- parallelism -----------------------------------------------------
    mesh_axis: str = "shard"          # mesh axis name for pair/obs sharding

    # ---- numerics --------------------------------------------------------
    dtype: str = "float32"

    def with_(self, **kwargs) -> "ReconstructorConfig":
        return dataclasses.replace(self, **kwargs)
