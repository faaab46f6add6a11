"""Train SuperPoint on rendered corner scenes with torch autograd and
``torch.optim``.

The counterpart of the TPU package's ``scripts/train_frontend.py``, which
made ``tests/data/superpoint_synth.npz``: the real SuperPoint
(``features/superpoint.py``) fit on analytic corner scenes
(``eval/render.py``) with the standard SuperPoint losses:

- detector: the 65-way cell classification (64 subcell positions and a
  dust bin) against the known blob-centre projections, non-keypoint cells
  weighted 0.3;
- descriptor: cross-view InfoNCE at a temperature of 1/20 anchored on
  landmark identity (two views of one blob pull together, other blobs push
  apart), over 6 sampled covisible view pairs;

two scenes a step, each view under its own photometric augmentation
(gain, bias, pixel noise). The optimizer is the JAX script's
``optax.chain(clip_by_global_norm(1.0), adam(warmup_cosine_decay_schedule(
0, lr, min(100, steps // 10), steps, 0.03 lr)))``: ``torch.optim.Adam``
with that schedule set before every step (the first update has learning
rate 0 whenever there is a warm-up) and the gradients clipped to a global
norm of 1 as optax clips them (no epsilon on the norm). The scenes are
drawn from the seeded host generator of the JAX script; the augmentation
and the sampled pairs from a ``torch.Generator`` on the device, and the
loss takes them as tensors (``draws``), so that a test can give both
packages the same ones. Nothing here is a hand-written kernel:
convolutions and their gradients are cuDNN's, with TF32 off as the
package pins it and cuDNN held to its deterministic algorithms while the
loop runs, so that a run repeats bit for bit, as the JAX script's does
(cuDNN's choice of weight-gradient algorithms was the only source of
run-to-run change on the card).

After training, the held-out evaluation: detector recall and precision at
2 px and the descriptors' positive / negative similarity on
``make_scene(seed + 777)``; then the weights are written to ``--out`` in
the npz layout that both packages' ``params_from_npz`` load, and one JSON
line is printed with the JAX script's keys. Runs on the card unless given
``--device cpu``.

    python -m reconstructor_tpu_torch.scripts.train_frontend [--steps 1500] [--lr 1.5e-3] \\
        [--seed 0] [--scenes 24] [--views 6] [--size 160] [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from reconstructor_tpu_torch.eval import render
from reconstructor_tpu_torch.features import superpoint as sp
from reconstructor_tpu_torch.utils import device as devices

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "build", "superpoint_synth_torch.npz")
LM_BUDGET = 48
TAU = 20.0
N_PAIR_SAMPLE = 6
SCENES_PER_STEP = 2
MAX_GRAD_NORM = 1.0


def build_labels(scene, hc, wc):
    """Per-view detector cell labels (64 subcell classes + dust bin)."""
    n_views = scene["images"].shape[0]
    labels = np.full((n_views, hc, wc), 64, np.int32)
    for i in range(n_views):
        uv = scene["gt_uv"][i][scene["gt_vis"][i]]
        cx = (uv[:, 0] // 8).astype(np.int32)
        cy = (uv[:, 1] // 8).astype(np.int32)
        sub = ((uv[:, 1] % 8).astype(np.int32) * 8
               + (uv[:, 0] % 8).astype(np.int32))
        labels[i, cy, cx] = sub
    return labels


def build_pairs(scene, lm_budget, rng):
    """All covisible view pairs with fixed-size landmark samples."""
    n_views = scene["images"].shape[0]
    vis = scene["gt_vis"]
    pairs, lms = [], []
    for i in range(n_views):
        for j in range(i + 1, n_views):
            common = np.flatnonzero(vis[i] & vis[j])
            if len(common) < 8:
                continue
            take = rng.choice(common, lm_budget,
                              replace=len(common) < lm_budget)
            pairs.append((i, j))
            lms.append(take)
    return np.asarray(pairs, np.int32), np.asarray(lms, np.int32)


def make_dataset(n_scenes, views_per_scene, h, w, lm_budget, seed):
    """Pre-render a bank of scenes; returns stacked arrays.

    Images (S, V, h, w); labels (S, V, hc, wc); per-view ground-truth
    projections (S, V, P, 2) zero-padded to the largest scene; per-scene
    pair tables (S, Q, 2) and landmark samples (S, Q, M) cut to a common
    pair count.
    """
    rng = np.random.default_rng(seed)
    imgs, labels, uvs, pair_ij, pair_lm = [], [], [], [], []
    for s in range(n_scenes):
        scene = render.make_scene(
            seed=seed * 1000 + s, n_views=views_per_scene, h=h, w=w,
            n_blobs=int(rng.integers(90, 140)),
            focal_px=float(rng.uniform(150, 200)))
        imgs.append(scene["images"])
        labels.append(build_labels(scene, h // 8, w // 8))
        uvs.append(scene["gt_uv"])
        ij, lm = build_pairs(scene, lm_budget, rng)
        pair_ij.append(ij)
        pair_lm.append(lm)
    n_pair = min(len(p) for p in pair_ij)
    pad_uv = max(u.shape[1] for u in uvs)
    uv_arr = np.zeros((n_scenes, views_per_scene, pad_uv, 2), np.float32)
    for s, u in enumerate(uvs):
        uv_arr[s, :, :u.shape[1]] = u
    return (np.stack(imgs), np.stack(labels), uv_arr,
            np.stack([p[:n_pair] for p in pair_ij]),
            np.stack([p[:n_pair] for p in pair_lm]))


class Batch(NamedTuple):
    """The dataset on the device."""
    imgs: torch.Tensor       # (S, V, H, W) float32
    labels: torch.Tensor     # (S, V, hc, wc) int64
    uv: torch.Tensor         # (S, V, P, 2) float32
    pair_ij: torch.Tensor    # (S, Q, 2) int64
    pair_lm: torch.Tensor    # (S, Q, M) int64


def to_device(dataset, device) -> Batch:
    imgs, labels, uv, ij, lm = dataset
    t = lambda a, dt: torch.as_tensor(np.asarray(a), device=device).to(dt)  # noqa: E731
    return Batch(t(imgs, torch.float32), t(labels, torch.int64), t(uv, torch.float32),
                 t(ij, torch.int64), t(lm, torch.int64))


def draws(gen: torch.Generator, n_scenes: int, n_views: int, h: int, w: int,
          n_pairs: int) -> Dict[str, torch.Tensor]:
    """One step's random draws, made on ``gen``'s device: per-view gain
    (1 + 0.25 N) and bias (0.1 N) of shape (n, V, 1, 1), pixel noise
    (0.02 N) of (n, V, h, w) and the sampled pair indices (n, 6)."""
    dev = gen.device
    normal = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    return {"gain": 1.0 + 0.25 * normal(n_scenes, n_views, 1, 1),
            "bias": 0.1 * normal(n_scenes, n_views, 1, 1),
            "noise": 0.02 * normal(n_scenes, n_views, h, w),
            "qidx": torch.randint(0, n_pairs, (n_scenes, N_PAIR_SAMPLE), generator=gen,
                                  device=dev)}


def scene_loss(net: sp.SuperPointNet, gray, labels, uv, pair_ij, pair_lm, gain, bias, noise,
               qidx):
    """The JAX script's per-scene loss with its draws given: gray (V, H,
    W), labels (V, hc, wc), uv (V, P, 2), pair_ij (Q, 2), pair_lm (Q, M),
    gain and bias (V, 1, 1), noise (V, H, W), qidx (6,). Returns (loss,
    detector term, descriptor term)."""
    gray = torch.clamp(gray * gain + bias + noise, 0.0, 1.0)
    logits, desc_raw = net(gray)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    is_kp = (labels != 64).to(nll.dtype)
    not_kp = 1.0 - is_kp
    det = (torch.sum(nll * is_kp) / torch.clamp(torch.sum(is_kp), min=1)
           + 0.3 * torch.sum(nll * not_kp) / torch.clamp(torch.sum(not_kp), min=1))

    all_desc = sp._bilinear_sample_map(desc_raw, uv)           # (V, P, 256)
    ij = pair_ij[qidx]                                          # (6, 2)
    lm = pair_lm[qidx]                                          # (6, M)
    di = all_desc[ij[:, 0, None], lm]                           # (6, M, 256)
    dj = all_desc[ij[:, 1, None], lm]
    sim = TAU * (di @ dj.transpose(1, 2))                       # (6, M, M)
    m = sim.shape[-1]
    lbl = torch.arange(m, device=sim.device).repeat(sim.shape[0])
    desc = 0.5 * (F.cross_entropy(sim.reshape(-1, m), lbl)
                  + F.cross_entropy(sim.transpose(1, 2).reshape(-1, m), lbl))
    return det + desc, det, desc


def batch_loss(net: sp.SuperPointNet, data: Batch, scene_ids, d):
    """Mean of ``scene_loss`` over ``scene_ids`` with the draws ``d``
    (``draws``): (loss, detector term, descriptor term)."""
    terms = [scene_loss(net, data.imgs[s], data.labels[s], data.uv[s], data.pair_ij[s],
                        data.pair_lm[s], d["gain"][k], d["bias"][k], d["noise"][k],
                        d["qidx"][k])
             for k, s in enumerate(scene_ids)]
    return tuple(torch.stack(t).mean() for t in zip(*terms))


def schedule(step: int, lr: float, steps: int) -> float:
    """optax's ``warmup_cosine_decay_schedule(0, lr, min(100, steps // 10),
    steps, 0.03 lr)`` at update ``step`` (0 for the first update): a linear
    warm-up from 0, then a cosine decay to 3% of ``lr``."""
    warmup = min(100, steps // 10)
    decay = steps - warmup
    if decay <= 0:
        raise ValueError(f"the cosine decay needs steps > warm-up steps, got {steps}")
    if step < warmup:
        return lr * step / warmup
    alpha = 0.0 if lr == 0.0 else lr * 0.03 / lr
    t = min(step - warmup, decay)
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / decay)) + alpha)


def clip_by_global_norm(params, max_norm: float = MAX_GRAD_NORM) -> torch.Tensor:
    """Scale the gradients in place as ``optax.clip_by_global_norm`` does:
    g / ||g|| * max_norm when the global norm reaches ``max_norm``, with no
    epsilon on the norm (``clip_grad_norm_`` adds 1e-6). Returns the norm;
    no host synchronisation."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    div = torch.where(keep, torch.ones_like(norm), norm)
    mul = torch.where(keep, torch.ones_like(norm), torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(div).mul_(mul)
    return norm


def make_optimizer(net: sp.SuperPointNet) -> torch.optim.Adam:
    """optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8); the learning
    rate is set before every step by ``apply_gradients``."""
    return torch.optim.Adam(net.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8)


def apply_gradients(net: sp.SuperPointNet, opt: torch.optim.Adam, lr: float) -> torch.Tensor:
    """One optimizer update from the gradients in ``.grad``: clip, set the
    scheduled learning rate, step. Returns the gradients' global norm."""
    norm = clip_by_global_norm(list(net.parameters()))
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    return norm


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block only."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def train(data: Batch, steps: int, lr: float, seed: int, net: sp.SuperPointNet = None,
          log=None) -> dict:
    """Train ``net`` (He-initialised from seed 1 when not given) for
    ``steps`` updates of ``SCENES_PER_STEP`` scenes. Returns {"net",
    "losses" (steps, 3) float numpy: loss, detector, descriptor per step,
    "wall_s" (host clock ending in a device synchronise)}."""
    dev = data.imgs.device
    if net is None:
        net = sp.init_params(torch.Generator().manual_seed(1))
    net = net.to(dev).train().requires_grad_(True)
    opt = make_optimizer(net)
    n_scenes, n_views, h, w = data.imgs.shape
    n_pairs = data.pair_ij.shape[1]
    rng = np.random.default_rng(seed + 1)
    gen = devices.generator(dev, seed + 2)
    losses = torch.zeros((steps, 3), device=dev)
    t0 = time.perf_counter()
    with _deterministic_cudnn():
        for it in range(steps):
            sids = rng.choice(n_scenes, SCENES_PER_STEP, replace=False)
            d = draws(gen, SCENES_PER_STEP, n_views, h, w, n_pairs)
            opt.zero_grad(set_to_none=False)
            loss, det, desc = batch_loss(net, data, [int(s) for s in sids], d)
            loss.backward()
            apply_gradients(net, opt, schedule(it, lr, steps))
            losses[it] = torch.stack([loss, det, desc]).detach()
            if log is not None and (it % 25 == 0 or it == steps - 1):
                l, dt, ds = losses[it].tolist()
                log(f"step {it:4d}  loss {l:.4f}  det {dt:.4f} desc {ds:.4f}  "
                    f"({time.perf_counter() - t0:.0f}s)")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return {"net": net.eval().requires_grad_(False), "losses": losses.cpu().numpy(),
            "wall_s": wall}


def detector_recall(net: sp.SuperPointNet, scene: dict, max_keypoints: int = 256):
    """Mean per-view recall and precision at 2 px of the detections
    (``detect_and_describe``) against the visible ground-truth blobs."""
    dev = next(net.parameters()).device
    n, h, w = scene["images"].shape
    feats = sp.detect_and_describe(
        net, torch.as_tensor(np.asarray(scene["images"], np.float32), device=dev),
        torch.as_tensor(np.tile([h, w], (n, 1)).astype(np.int32), device=dev),
        max_keypoints=max_keypoints)
    xy, msk = feats.xy.cpu().numpy(), feats.mask.cpu().numpy()
    recalls, precisions = [], []
    for i in range(n):
        gt = scene["gt_uv"][i][scene["gt_vis"][i]]
        det_xy = xy[i][msk[i]]
        if len(det_xy) == 0:
            recalls.append(0.0)
            precisions.append(0.0)
            continue
        d_gt = np.linalg.norm(gt[:, None] - det_xy[None], axis=-1)
        recalls.append(float((d_gt.min(1) <= 2.0).mean()))
        precisions.append(float((d_gt.min(0) <= 2.0).mean()))
    return float(np.mean(recalls)), float(np.mean(precisions))


def evaluate(net: sp.SuperPointNet, seed: int, h: int, w: int) -> dict:
    """The JAX script's held-out evaluation on ``make_scene(seed + 777,
    6 views)``: recall and precision at 2 px, and the mean descriptor
    similarity of the same blob (pos) and of different blobs (neg) between
    views 0 and 3."""
    dev = next(net.parameters()).device
    ev = render.make_scene(seed=seed + 777, n_views=6, h=h, w=w)
    recall, precision = detector_recall(net, ev)
    with torch.no_grad():
        _, draw = net(torch.as_tensor(np.asarray(ev["images"], np.float32), device=dev))
        uv = torch.as_tensor(ev["gt_uv"][[0, 3]], device=dev)
        d = sp._bilinear_sample_map(draw[[0, 3]], uv).cpu().numpy()
    both = ev["gt_vis"][0] & ev["gt_vis"][3]
    sim = d[0][both] @ d[1][both].T
    return {"det_recall_2px_heldout": recall, "det_precision_2px_heldout": precision,
            "desc_pos_sim": float(np.mean(np.diag(sim))),
            "desc_neg_sim": float(np.mean(sim[~np.eye(sim.shape[0], dtype=bool)]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--lr", type=float, default=1.5e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scenes", type=int, default=24)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--size", type=int, default=160)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="weights npz (default: build/, which git ignores)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)

    H = W = args.size
    print(f"rendering {args.scenes} scenes x {args.views} views ...", flush=True)
    data = to_device(make_dataset(args.scenes, args.views, H, W, LM_BUDGET, args.seed), dev)
    t0 = time.perf_counter()
    res = train(data, args.steps, args.lr, args.seed, log=lambda m: print(m, flush=True))
    metrics = evaluate(res["net"], args.seed, H, W)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    sp.save_npz(res["net"], args.out)
    print(json.dumps({
        "steps": args.steps, "train_s": round(time.perf_counter() - t0, 1),
        **{k: round(v, 3) for k, v in metrics.items()},
        "weights": args.out, "size_mb": round(os.path.getsize(args.out) / 1e6, 2)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
