"""Command-line entry point — the reference's ``reconstruct`` executable.

    python -m reconstructor_tpu_torch IMG_FOLDER OUT_FOLDER \
        --max-keypoints 4096 [--device cuda]

Runs the default path (SIFT, kNN + fundamental gate, PnP, dense-Schur
BA), ORB with ``--detector orb``, or the learned path with ``--detector
superpoint --matcher superglue``, and writes ``clouds/cloud_final.ply``
and ``report.json``:

    python -m reconstructor_tpu_torch IMG_FOLDER OUT_FOLDER \
        --detector superpoint --matcher superglue \
        --superpoint-weights tests/data/superpoint_synth.npz \
        --superglue-weights structured

``--checkpoint PATH`` autosaves the resumable state (npz) during the run,
``--resume`` continues from it, ``--eval-ate GOLDEN_PLY`` prints the ATE
against a golden cloud, and ``--save-matches`` / ``--render`` draw the
matches and the final cloud (these two need PIL / matplotlib).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="reconstructor_tpu_torch",
        description="incremental structure-from-motion on PyTorch/CUDA")
    p.add_argument("img_folder", help="folder of input images")
    p.add_argument("out_folder", help="output folder (clouds/ written here)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--detector", choices=["sift", "orb", "superpoint"], default="sift")
    p.add_argument("--matcher", choices=["knn", "superglue"], default="knn")
    p.add_argument("--max-keypoints", type=int, default=2048)
    p.add_argument("--img-max-size", type=int, default=512)
    p.add_argument("--focal-px", type=float, default=None,
                   help="known focal length in pixels (else colmap-style prior)")
    p.add_argument("--focal-factor", type=float, default=1.2)
    p.add_argument("--superpoint-weights", default=None,
                   help=".npz (JAX package layout) or magicleap .pth; none = random init")
    p.add_argument("--superglue-weights", default=None,
                   help="'structured', .npz or magicleap .pth; none = random init")
    p.add_argument("--save-intermediate", action="store_true",
                   help="dump cloud_before_i/cloud_after_i each iteration")
    p.add_argument("--save-matches", action="store_true",
                   help="dump side-by-side match visualizations (needs PIL)")
    p.add_argument("--render", action="store_true",
                   help="render the final cloud to render.png (needs matplotlib)")
    p.add_argument("--checkpoint", default=None,
                   help="autosave path for resumable state (.npz)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists (state and random stream)")
    p.add_argument("--pair-selection", choices=["exhaustive", "retrieval"],
                   default="exhaustive")
    p.add_argument("--retrieval-top-k", type=int, default=10)
    p.add_argument("--eval-ate", default=None, metavar="GOLDEN_PLY",
                   help="report ATE against a golden cloud after the run")
    p.add_argument("--local-ba-window", type=int, default=None,
                   help="windowed local BA size; 0 = global BA every view")
    p.add_argument("--global-ba-every", type=int, default=None,
                   help="full global BA every N registrations (with local BA)")
    p.add_argument("--final-refinement", type=int, default=None,
                   help="extra global BA rounds after the last view")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from reconstructor_tpu_torch.config import ReconstructorConfig
    from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor

    cfg = ReconstructorConfig(
        detector=args.detector, matcher=args.matcher,
        superpoint_weights=args.superpoint_weights,
        superglue_weights=args.superglue_weights,
        max_keypoints=args.max_keypoints, img_max_size=args.img_max_size,
        focal_px=args.focal_px, focal_length_factor=args.focal_factor,
        pair_selection=args.pair_selection, retrieval_top_k=args.retrieval_top_k)
    overrides = {k: v for k, v in
                 (("ba_local_window", args.local_ba_window),
                  ("ba_global_every", args.global_ba_every),
                  ("final_refinement_rounds", args.final_refinement))
                 if v is not None}
    if overrides:
        cfg = cfg.with_(**overrides)
    rec = IncrementalReconstructor(cfg, verbose=not args.quiet, device=args.device)
    state = rec.reconstruct(args.img_folder, args.out_folder,
                            save_intermediate=args.save_intermediate,
                            checkpoint_path=args.checkpoint, resume=args.resume)

    if args.save_matches:
        from reconstructor_tpu_torch.utils import viz
        viz.draw_all_matches(state, args.img_folder, args.out_folder)

    if args.render:
        import os
        from reconstructor_tpu_torch.utils import viz
        viz.render_cloud(os.path.join(args.out_folder, "clouds/cloud_final.ply"),
                         os.path.join(args.out_folder, "render.png"))

    print(f"registered {len(state.registered)}/{state.num_images} views, "
          f"{state.num_landmarks} landmarks")

    if args.eval_ate:
        import json
        import numpy as np
        from reconstructor_tpu_torch.eval import ate
        centers = np.stack([-state.poses[i][:3, :3].T @ state.poses[i][:3, 3]
                            for i in state.registered])
        print(json.dumps(ate.ate_vs_golden(centers, args.eval_ate), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
