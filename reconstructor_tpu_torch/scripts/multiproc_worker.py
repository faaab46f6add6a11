"""One rank of the multi-process run: sharded gated matching, the
observation-sharded PCG bundle adjustment and the driver over a
``torch.distributed`` world.

The counterpart of the TPU package's ``scripts/multiproc_worker.py``. The
rank joins the process group (``parallel.sharding.initialize_multihost``)
and runs the same two loads through the library's entry points:

- ``sharding.match_and_gate_sharded`` on 25 images x 512 unit
  descriptors (D = 128) at random coordinates, all 300 pairs in one
  chunk, 128 F-gate hypotheses, draws from a generator seeded with 0 (the
  kNN kernel in float32 on a card, the plain matcher on the CPU). The
  TPU worker's descriptors are independent per image and match nothing;
  here each image's are its random ones halved plus image 0's, so that
  every pair has raw matches for the gate to thin out and the gathered
  table depends on the draws (the same random numbers are drawn, so the
  BA problem is the TPU worker's);
- ``distributed.solve_distributed`` on 25 cameras x 5000 points x 6
  observations with 0.3 px noise (``max_iters=10``, ``cg_iters=32``);

and then the driver, ``IncrementalReconstructor(mesh=...)``, on the
5-view rendered scene of the port's isolation test (192 x 256, 256
keypoints), whose replicated stages must keep every rank in the same
state.

It prints one JSON report (and writes it to ``--out``): the gathered match
table's shape, SHA-256 and match count, the generator's state after the
draws, the kNN kernel's launches, BA costs and iterations, the driver's
registered views, landmarks and state SHA-256, the all-reduce and
all-gather calls, and times. ``run_multiproc_dryrun``
starts the ranks and merges their reports; this is not meant to run alone.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from reconstructor_tpu_torch.ba import distributed, lm as ba_lm
from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.eval import render
from reconstructor_tpu_torch.geometry import np_ops
from reconstructor_tpu_torch.io import images as io_images
from reconstructor_tpu_torch.matching import pairs as pairing
from reconstructor_tpu_torch.parallel import sharding
from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
from reconstructor_tpu_torch.utils import cuda_build, device as devices


def sha256(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a.cpu().numpy() if torch.is_tensor(a) else a).tobytes())
    return h.hexdigest()


def gated_matching(mesh: sharding.Mesh, report: dict, rng) -> None:
    n_img, K, D = 25, 512, 128
    desc = rng.standard_normal((n_img, K, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    desc = desc[:1] + 0.5 * desc
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    mask = np.ones((n_img, K), bool)
    xy = rng.uniform(0, 512, (n_img, K, 2)).astype(np.float32)
    pair_idx = pairing.exhaustive_pairs(n_img)
    gen = devices.generator(mesh.device, 0)
    cuda_build.reset_launches()
    t = time.perf_counter()
    midx, counts = sharding.match_and_gate_sharded(
        mesh, desc, mask, xy, pair_idx, ratio_thresh=0.7, cross_check=True,
        num_hypotheses=128, thresh_px=3.0, min_matches=7, generator=gen)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    report.update(match_pairs=int(pair_idx.shape[0]), match_table_shape=list(midx.shape),
                  match_table_sha256=sha256(midx, counts), matched=int(counts.sum()),
                  generator_sha256=sha256(gen.get_state()),
                  knn_launches=cuda_build.launches()["knn_top2_launch"],
                  match_s=time.perf_counter() - t)


def ba_problem(rng):
    """The TPU worker's problem: 25 cameras along x, 5000 points, each
    seen by 6 random cameras, 0.3 px noise, points perturbed by 5 cm."""
    n_cams, n_pts, obs_per_pt = 25, 5000, 6
    pts = rng.uniform([-2, -2, 6], [2, 2, 12], (n_pts, 3)).astype(np.float32)
    intr = np.array([600.0, 600.0, 256.0, 192.0, 0.0, 0.0], np.float32)
    aa = np.stack([[0.0, 0.04 * c, 0.0] for c in range(n_cams)]).astype(np.float32)
    t = np.stack([[0.3 * c, 0.0, 0.0] for c in range(n_cams)]).astype(np.float32)
    cam_params = np.concatenate([aa, t, np.tile(intr, (n_cams, 1))], axis=1).astype(np.float32)
    R = np_ops.angle_axis_to_rotation(aa)
    obs_pt = np.repeat(np.arange(n_pts, dtype=np.int32), obs_per_pt)
    obs_cam = rng.integers(0, n_cams, obs_pt.size).astype(np.int32)
    pc = np.einsum("oij,oj->oi", R[obs_cam], pts[obs_pt]) + t[obs_cam]
    obs_uv = np_ops.project(intr, pc).astype(np.float32)
    obs_uv += rng.normal(0, 0.3, obs_uv.shape).astype(np.float32)
    points = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    return ba_lm.BAProblem(
        cam_params=torch.from_numpy(cam_params), points=torch.from_numpy(points),
        obs_cam=torch.from_numpy(obs_cam), obs_pt=torch.from_numpy(obs_pt),
        obs_uv=torch.from_numpy(obs_uv), obs_mask=torch.ones(obs_pt.size, dtype=torch.bool),
        cam_free=torch.from_numpy(ba_lm.make_cam_free_mask(n_cams)))


def bundle_adjustment(mesh: sharding.Mesh, report: dict, rng) -> None:
    prob = ba_problem(rng)
    t = time.perf_counter()
    res = distributed.solve_distributed(mesh, prob, max_iters=10, cg_iters=32)
    c0, c1 = float(res.cost_initial), float(res.cost_final)
    report.update(ba_cost_initial=c0, ba_cost_final=c1, ba_iterations=int(res.iterations),
                  ba_obs=int(prob.obs_uv.shape[0]), ba_state_sha256=sha256(res.cam_params,
                                                                          res.points),
                  ba_s=time.perf_counter() - t)
    report["ok"] = bool(np.isfinite(c1) and c1 < c0)


def reconstruction(mesh: sharding.Mesh, report: dict) -> None:
    sc = render.make_scene(seed=0, n_views=5, h=192, w=256, n_blobs=200, tex_size=512,
                           focal_px=1.2 * 256)
    imgs = [io_images.from_rgb(np.repeat((im * 255).astype(np.uint8)[..., None], 3, -1))
            for im in sc["images"]]
    cfg = ReconstructorConfig(max_keypoints=256, ransac_num_hypotheses=256,
                              pnp_num_hypotheses=256, fundamental_num_hypotheses=128,
                              final_refinement_rounds=1)
    t = time.perf_counter()
    rec = IncrementalReconstructor(cfg, verbose=False, mesh=mesh)
    st = rec.reconstruct_from_state(rec.detect_features_from_images(imgs))
    views, keys = sorted(st.registered), sorted(st.matches)
    report.update(driver_registered=len(views), driver_landmarks=int(st.num_landmarks),
                  driver_sha256=sha256(np.array(views), *[st.poses[i] for i in views],
                                       st.lm_xyz, *[st.matches[k] for k in keys],
                                       rec._gen.get_state()),
                  driver_s=time.perf_counter() - t)
    report["ok"] = report["ok"] and len(views) >= 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--init-method", required=True, help="file:///path or tcp://host:port")
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", required=True,
                    help="cpu, cuda (this rank's own card) or cuda:i (a shared card)")
    ap.add_argument("--timeout", type=float, default=sharding.DEFAULT_TIMEOUT_S,
                    help="seconds a collective may wait before it raises")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    t = time.perf_counter()
    mesh = sharding.initialize_multihost(args.init_method, args.world_size, args.rank,
                                         backend=args.backend, device=args.device,
                                         timeout_s=args.timeout)
    report = {"rank": mesh.rank, "n_processes": mesh.size, "backend": mesh.backend,
              "device": str(mesh.device), "init_s": time.perf_counter() - t}
    sharding.reset_counts()
    rng = np.random.default_rng(0)
    gated_matching(mesh, report, rng)
    bundle_adjustment(mesh, report, rng)
    reconstruction(mesh, report)
    n = sharding.counts()
    report.update(all_reduces=n["all_reduce"], all_gathers=n["all_gather"])
    dist.destroy_process_group()
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
