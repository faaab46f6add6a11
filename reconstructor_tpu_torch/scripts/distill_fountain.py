"""Self-distill SuperPoint on the fountain photographs, with torch autograd
and ``torch.optim``.

The counterpart of the TPU package's ``scripts/distill_fountain.py``, which
made ``tests/data/superpoint_fountain.npz``: the classic DoG/SIFT detector
is the teacher and the real SuperPoint the student, on random 160 x 160
crops of the 25 fountain images, each warped by a random homography:

- detector: the 65-way cell classification (64 subcells and a dust bin)
  of the teacher's keypoints in both views, non-keypoint cells weighted
  0.3;
- descriptor: InfoNCE at a temperature of 1/20 anchored on keypoint
  identity across the warp (48 keypoints a pair);

eight pairs a step, each view under its own photometric augmentation
(gain, bias, pixel noise). The crop bank (``build_bank``), the homographies
and the labels are the JAX script's numpy code, bit for bit from one
``np.random.default_rng``. The optimizer is the JAX script's
``clip_by_global_norm(1.0)`` + ``adam(warmup_cosine_decay_schedule(0, lr,
min(100, steps // 10), steps, 0.03 lr))``, through the helpers of
``train_frontend.py``; the augmentation is drawn from a ``torch.Generator``
on the device and the loss takes it as tensors, so that a test can give
both packages the same draws. Convolutions are cuDNN's, held to its
deterministic algorithms while the loop runs.

Images 20-24 are held out: after training, detector recall and precision
at 2 px against the teacher on those. The weights are written every 100
steps and at the end as the float16 npz both packages'
``params_from_npz`` load, replaced atomically. ``--reconstruct`` then runs
the 25 photographs through the learned path (structured SuperGlue) with
them and reports registered views and ATE against the golden cloud.

``main()`` reads the photographs from ``reference/data`` inside the
repository (and ``--reconstruct`` the golden cloud beside them), and stops
with a message naming the folder while they are not there; the functions
take images as arrays. Runs on the card unless given ``--cpu``.

    python -m reconstructor_tpu_torch.scripts.distill_fountain [--steps 1200] [--pairs 400] \\
        [--batch 8] [--lr 1.5e-3] [--seed 0] [--out PATH] [--cpu] [--reconstruct] [--init NPZ]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from reconstructor_tpu_torch.features import sift
from reconstructor_tpu_torch.features import superpoint as sp
from reconstructor_tpu_torch.scripts import train_frontend as tf
from reconstructor_tpu_torch.utils import device as devices

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "build", "superpoint_fountain_torch.npz")
DATA = os.path.join(REPO, "reference", "data")
GOLDEN = os.path.join(REPO, "reference", "cloud_fountain.ply")
CROP = 160
M_KP = 48  # keypoint budget per training pair
TAU = 20.0
HELD_OUT = list(range(20, 25))


# ----------------------------------------------------------------------
# the bank (numpy, as the JAX script)
# ----------------------------------------------------------------------

def rand_homography(rng, size, jitter=0.18):
    """Random perspective warp of a size x size square (corner jitter)."""
    s = float(size)
    src = np.array([[0, 0], [s, 0], [s, s], [0, s]], np.float64)
    dst = src + rng.uniform(-jitter * s, jitter * s, (4, 2))
    # DLT for the 4-point homography
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    H = Vt[-1].reshape(3, 3)
    return H / H[2, 2]


def warp_image(img, H, size):
    """Inverse-map bilinear warp of img (H applied to pixel coords)."""
    Hi = np.linalg.inv(H)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float64)
    ones = np.ones_like(xs)
    src = np.einsum("ij,jhw->ihw", Hi, np.stack([xs, ys, ones]))
    sx = src[0] / src[2]
    sy = src[1] / src[2]
    x0 = np.floor(sx).astype(int)
    y0 = np.floor(sy).astype(int)
    fx, fy = sx - x0, sy - y0
    h, w = img.shape
    valid = (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
    x0c = np.clip(x0, 0, w - 2)
    y0c = np.clip(y0, 0, h - 2)
    out = ((1 - fx) * (1 - fy) * img[y0c, x0c]
           + fx * (1 - fy) * img[y0c, x0c + 1]
           + (1 - fx) * fy * img[y0c + 1, x0c]
           + fx * fy * img[y0c + 1, x0c + 1])
    return np.where(valid, out, 0.0).astype(np.float32)


def cell_labels(uv, valid, size):
    """65-way SuperPoint cell labels (64 subcells + dust bin) for a crop."""
    hc = size // 8
    lab = np.full((hc, hc), 64, np.int32)
    for (x, y), v in zip(uv, valid):
        if not v:
            continue
        cx, cy = int(x // 8), int(y // 8)
        if 0 <= cx < hc and 0 <= cy < hc:
            lab[cy, cx] = int(y % 8) * 8 + int(x % 8)
    return lab


def build_bank(grays, teacher_xy, teacher_mask, n_pairs, rng):
    """Pre-generate (crop, warped crop, kp uv pairs, labels) tuples."""
    imgs = np.zeros((n_pairs, 2, CROP, CROP), np.float32)
    uvs = np.zeros((n_pairs, 2, M_KP, 2), np.float32)
    kvalid = np.zeros((n_pairs, M_KP), bool)
    labels = np.full((n_pairs, 2, CROP // 8, CROP // 8), 64, np.int32)
    n = 0
    while n < n_pairs:
        i = rng.integers(0, len(grays))
        g = grays[i]
        h, w = g.shape
        y0 = rng.integers(0, h - CROP)
        x0 = rng.integers(0, w - CROP)
        crop = g[y0:y0 + CROP, x0:x0 + CROP].astype(np.float32)
        kp = teacher_xy[i][teacher_mask[i]]
        inside = ((kp[:, 0] >= x0 + 2) & (kp[:, 0] < x0 + CROP - 2)
                  & (kp[:, 1] >= y0 + 2) & (kp[:, 1] < y0 + CROP - 2))
        kp_c = kp[inside] - np.array([x0, y0], np.float32)
        if len(kp_c) < 12:
            continue
        H = rand_homography(rng, CROP)
        warped = warp_image(crop, H, CROP)
        ones = np.ones((len(kp_c), 1))
        kp_w = (np.hstack([kp_c, ones]) @ H.T)
        kp_w = kp_w[:, :2] / kp_w[:, 2:3]
        both = ((kp_w[:, 0] >= 2) & (kp_w[:, 0] < CROP - 2)
                & (kp_w[:, 1] >= 2) & (kp_w[:, 1] < CROP - 2))
        if both.sum() < 12:
            continue
        sel = np.flatnonzero(both)
        take = rng.choice(sel, M_KP, replace=len(sel) < M_KP)
        imgs[n, 0] = crop
        imgs[n, 1] = warped
        uvs[n, 0] = kp_c[take]
        uvs[n, 1] = kp_w[take]
        kvalid[n] = True
        labels[n, 0] = cell_labels(kp_c, np.ones(len(kp_c), bool), CROP)
        labels[n, 1] = cell_labels(kp_w[both], np.ones(both.sum(), bool), CROP)
        n += 1
    return imgs, uvs, kvalid, labels


def require(*paths: str) -> None:
    """Stop with a message when an input of ``main()`` is missing."""
    for path in paths:
        if not os.path.exists(path):
            raise SystemExit(f"{path} is missing: main() reads the fountain photographs, "
                             "which the repository does not hold yet; the functions of this "
                             "script take images or feature states as arrays")


def gray_crops(imgs):
    """A loaded folder as the padded gray batch (N, H, W), its shapes
    (N, 2) and each image's unpadded gray view."""
    from reconstructor_tpu_torch.io import images as io_images
    gray, shapes, _ = io_images.pad_batch(imgs)
    return gray, shapes, [gray[i, :shapes[i, 0], :shapes[i, 1]] for i in range(len(imgs))]


def teacher(gray: np.ndarray, shapes: np.ndarray, cfg, device) -> tuple:
    """The DoG/SIFT teacher on every image at 1024 keypoints and the
    config's SIFT settings: (xy (N, 1024, 2), mask (N, 1024)) numpy."""
    feats = sift.detect_and_describe(
        torch.as_tensor(gray, device=device), torch.as_tensor(shapes, device=device),
        max_keypoints=1024, num_scales=cfg.sift_num_scales,
        contrast_thresh=cfg.sift_contrast_thresh, edge_thresh=cfg.sift_edge_thresh,
        sigma0=cfg.sift_sigma0)
    return feats.xy.cpu().numpy(), feats.mask.cpu().numpy()


# ----------------------------------------------------------------------
# the loss
# ----------------------------------------------------------------------

class Bank(NamedTuple):
    """The crop bank on the device."""
    imgs: torch.Tensor       # (P, 2, CROP, CROP) float32
    uv: torch.Tensor         # (P, 2, M_KP, 2) float32
    labels: torch.Tensor     # (P, 2, CROP/8, CROP/8) int64


def to_device(bank, device) -> Bank:
    imgs, uvs, _, labels = bank
    return Bank(torch.as_tensor(imgs, device=device), torch.as_tensor(uvs, device=device),
                torch.as_tensor(labels, device=device).long())


def draws(gen: torch.Generator, n_pairs: int, size: int) -> Dict[str, torch.Tensor]:
    """One step's augmentation, made on ``gen``'s device: per-view gain
    (1 + 0.25 N) and bias (0.1 N) of shape (n, 2, 1, 1) and pixel noise
    (0.02 N) of (n, 2, size, size)."""
    dev = gen.device
    normal = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    return {"gain": 1.0 + 0.25 * normal(n_pairs, 2, 1, 1),
            "bias": 0.1 * normal(n_pairs, 2, 1, 1),
            "noise": 0.02 * normal(n_pairs, 2, size, size)}


def pair_losses(net: sp.SuperPointNet, imgs, uv, labels, gain, bias, noise):
    """The JAX script's ``pair_loss`` for a batch of pairs with its draws
    given: imgs (B, 2, C, C), uv (B, 2, M, 2), labels (B, 2, C/8, C/8),
    gain and bias (B, 2, 1, 1), noise (B, 2, C, C). The pairs' views go
    through the network as one batch. Returns (loss, detector term,
    descriptor term), each (B,)."""
    B, _, C, _ = imgs.shape
    g = torch.clamp(imgs * gain + bias + noise, 0.0, 1.0)
    logits, draw = sp.forward(net, g.reshape(B * 2, C, C))
    logp = torch.log_softmax(logits, dim=-1).reshape(B, 2, C // 8, C // 8, 65)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    is_kp = (labels != 64).to(nll.dtype)
    not_kp = 1.0 - is_kp
    dims = (1, 2, 3)
    det = (torch.sum(nll * is_kp, dim=dims) / torch.clamp(torch.sum(is_kp, dim=dims), min=1)
           + 0.3 * torch.sum(nll * not_kp, dim=dims)
           / torch.clamp(torch.sum(not_kp, dim=dims), min=1))
    d = sp._bilinear_sample_map(draw, uv.reshape(B * 2, -1, 2)).reshape(B, 2, uv.shape[2], -1)
    sim = TAU * (d[:, 0] @ d[:, 1].transpose(1, 2))                      # (B, M, M)
    m = sim.shape[-1]
    lbl = torch.arange(m, device=sim.device).repeat(B)
    def ce(s):
        return F.cross_entropy(s.reshape(-1, m), lbl, reduction="none").reshape(B, m)
    desc = 0.5 * torch.mean(ce(sim) + ce(sim.transpose(1, 2)), dim=1)
    return det + desc, det, desc


def batch_loss(net: sp.SuperPointNet, bank: Bank, bs: torch.Tensor, d):
    """Mean of ``pair_losses`` over the bank's pairs ``bs`` with the draws
    ``d`` (``draws``): (loss, detector term, descriptor term)."""
    terms = pair_losses(net, bank.imgs[bs], bank.uv[bs], bank.labels[bs],
                        d["gain"], d["bias"], d["noise"])
    return tuple(t.mean() for t in terms)


# ----------------------------------------------------------------------
# training, evaluation, saving
# ----------------------------------------------------------------------

def save_params(net: sp.SuperPointNet, out: str) -> None:
    """float16 npz (``superpoint.save_npz``), replaced atomically: a kill
    mid-write must never truncate the only checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    tmp = out + f".tmp{os.getpid()}"
    sp.save_npz(net, tmp)
    os.replace(tmp if os.path.exists(tmp) else tmp + ".npz", out)


def train(bank: Bank, steps: int, lr: float, batch: int, seed: int,
          net: sp.SuperPointNet = None, log=None, save=None) -> dict:
    """Train ``net`` (He-initialised from seed 1 when not given) for
    ``steps`` updates of ``batch`` pairs: the pair indices from
    ``np.random.default_rng(seed + 1)`` (the JAX script's), the
    augmentation from a generator on the device seeded ``seed + 2``.
    ``save(net)`` runs every 100 steps. Returns {"net", "losses" (steps,
    3) numpy: loss, detector, descriptor per step, "wall_s" (host clock
    ending in a device synchronise)}."""
    dev = bank.imgs.device
    if net is None:
        net = sp.init_params(torch.Generator().manual_seed(1))
    net = net.to(dev).train().requires_grad_(True)
    opt = tf.make_optimizer(net)
    n_pairs = bank.imgs.shape[0]
    nprng = np.random.default_rng(seed + 1)
    gen = devices.generator(dev, seed + 2)
    losses = torch.zeros((steps, 3), device=dev)
    t0 = time.perf_counter()
    with tf._deterministic_cudnn():
        for it in range(steps):
            bs = torch.as_tensor(nprng.choice(n_pairs, batch, replace=False), device=dev)
            d = draws(gen, batch, bank.imgs.shape[-1])
            opt.zero_grad(set_to_none=False)
            loss, det, desc = batch_loss(net, bank, bs, d)
            loss.backward()
            tf.apply_gradients(net, opt, tf.schedule(it, lr, steps))
            losses[it] = torch.stack([loss, det, desc]).detach()
            if log is not None and (it % 50 == 0 or it == steps - 1):
                l, dt, ds = losses[it].tolist()
                log(f"step {it:4d}  loss {l:.4f}  det {dt:.4f}  desc {ds:.4f}  "
                    f"({time.perf_counter() - t0:.0f}s)")
            if save is not None and it and it % 100 == 0:
                save(net)   # a run cut short keeps its last checkpoint
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return {"net": net.eval().requires_grad_(False), "losses": losses.cpu().numpy(),
            "wall_s": wall}


def heldout_recall(net: sp.SuperPointNet, gray: np.ndarray, shapes: np.ndarray, t_xy, t_mask,
                   held=HELD_OUT):
    """Mean recall and precision at 2 px of the student's detections
    (1024 keypoints, threshold 0.015, NMS radius 4, border 4) against the
    teacher's keypoints on the held-out images."""
    dev = next(net.parameters()).device
    hf = sp.detect_and_describe(
        net, torch.as_tensor(gray[held], device=dev), torch.as_tensor(shapes[held], device=dev),
        max_keypoints=1024, conf_thresh=0.015, nms_radius=4, border=4)
    xy, msk = hf.xy.cpu().numpy(), hf.mask.cpu().numpy()
    rec, prec = [], []
    for k, i in enumerate(held):
        gt = t_xy[i][t_mask[i]]
        det_xy = xy[k][msk[k]]
        if len(det_xy) == 0:
            rec.append(0.0)
            prec.append(0.0)
            continue
        d = np.linalg.norm(gt[:, None] - det_xy[None], axis=-1)
        rec.append(float((d.min(1) <= 2.0).mean()))
        prec.append(float((d.min(0) <= 2.0).mean()))
    return float(np.mean(rec)), float(np.mean(prec))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--pairs", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1.5e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="weights npz (default: build/, which git ignores)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--reconstruct", action="store_true")
    ap.add_argument("--init", default=None,
                    help="warm-start from an existing weights npz "
                         "(continue an earlier run)")
    args = ap.parse_args(argv)
    dev = devices.resolve("cpu" if args.cpu else None)

    require(DATA, *([GOLDEN] if args.reconstruct else []))
    from reconstructor_tpu_torch.config import ReconstructorConfig
    from reconstructor_tpu_torch.io import images as io_images
    cfg = ReconstructorConfig()
    gray, shapes, grays = gray_crops(io_images.load_folder(DATA, cfg.img_max_size))

    # ---- teacher: DoG keypoints on every image -------------------------
    t_xy, t_mask = teacher(gray, shapes, cfg, dev)
    print(f"teacher: {t_mask.sum(1).mean():.0f} DoG kps/img", flush=True)

    rng = np.random.default_rng(args.seed)
    train_imgs = list(range(20))        # 20-24 held out
    bank = to_device(build_bank([grays[i] for i in train_imgs], t_xy[train_imgs],
                                t_mask[train_imgs], args.pairs, rng), dev)
    print(f"bank: {args.pairs} crop pairs", flush=True)

    net = None
    if args.init and os.path.exists(args.init):
        net = sp.params_from_npz(args.init)
        print(f"warm-start from {args.init}", flush=True)
    res = train(bank, args.steps, args.lr, args.batch, args.seed, net=net,
                log=lambda m: print(m, flush=True), save=lambda n: save_params(n, args.out))

    # ---- held-out eval vs the teacher ----------------------------------
    rec, prec = heldout_recall(res["net"], gray, shapes, t_xy, t_mask)
    out = {"steps": args.steps, "train_s": round(res["wall_s"], 1),
           "teacher_recall_2px_heldout": round(rec, 3),
           "teacher_precision_2px_heldout": round(prec, 3), "weights": args.out}
    save_params(res["net"], args.out)
    out["size_mb"] = round(os.path.getsize(args.out) / 1e6, 2)
    print(json.dumps(out), flush=True)

    if args.reconstruct:
        from reconstructor_tpu_torch.eval import ate
        from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
        rcfg = ReconstructorConfig(
            detector="superpoint", matcher="superglue", superpoint_weights=args.out,
            superglue_weights="structured", max_keypoints=1024)
        rec_ = IncrementalReconstructor(rcfg, verbose=True, device=dev)
        st = rec_.reconstruct_from_state(rec_.detect_features(DATA))
        centers = np.stack([-st.poses[i][:3, :3].T @ st.poses[i][:3, 3]
                            for i in st.registered])
        res_ = ate.ate_vs_golden(centers, GOLDEN)
        print(json.dumps({
            "learned_registered": len(st.registered),
            "learned_landmarks": int(st.num_landmarks),
            "learned_ate_normalized": round(res_["ate_rmse_normalized"], 4)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
