"""Train a compact SuperGlue GNN on fountain homography pairs, with torch
autograd and ``torch.optim``.

The counterpart of the TPU package's ``scripts/train_superglue.py``, which
made ``tests/data/superglue_fountain.npz``: a 4-layer (self/cross
alternating) attentional GNN supervised on homography-warped 320 x 320
crops of the fountain photographs, with keypoints and descriptors from the
self-distilled SuperPoint (``tests/data/superpoint_fountain.npz``).

Initialisation is the structured identity (zeroed residual MLPs, ``24 I``
final projection, dust-bin score 5), so step 0 decodes exactly as
``superglue.structured_identity_params()``, the production matcher; the
trained model is saved only if it beats the identity on the held-out
pairs' correspondence F1.

- ``build_bank``: the JAX script's crops, warps (``distill_fountain``'s
  ``rand_homography`` and ``warp_image``) and ground truth, numpy from one
  ``np.random.default_rng``, on the port's SuperPoint.
- ``pair_nll`` / ``batch_loss``: the negative log-likelihood of the
  ground-truth correspondences and dust-bin assignments under the plain,
  differentiable ``superglue.log_sinkhorn`` (the JAX script differentiates
  the plain loop too: the Sinkhorn kernel has no backward), batched over
  the step's pairs.
- Adam (optax's defaults) under optax's ``cosine_decay_schedule(lr,
  steps)``, no clipping. The BN statistics (``running_mean``,
  ``running_var``) are trained like the weights, as the JAX pytree's
  leaves are; nothing clamps the variance. The batch indices come from a
  ``torch.Generator`` on the device.
- ``val_f1``: precision, recall and F1 of the matches that
  ``superglue.match_pair`` decodes (100 Sinkhorn iterations: the CUDA
  kernel on the card), at step 0 and every 100 steps; the best weights are
  kept.

``main()`` reads the photographs from ``reference/data`` inside the
repository, and stops with a message naming the folder while they are not
there; the functions take images as arrays. Runs on the card unless given
``--cpu``.

    python -m reconstructor_tpu_torch.scripts.train_superglue [--steps 1500] [--pairs 200] \\
        [--kps 512] [--layers 4] [--batch 8] [--lr 2e-4] [--sinkhorn-iters 50] [--out PATH] \\
        [--warm-start NPZ] [--bank NPZ] [--cpu]
"""

from __future__ import annotations

import argparse
import copy
import math
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from reconstructor_tpu_torch.features import superpoint as sp
from reconstructor_tpu_torch.matching import superglue as sg
from reconstructor_tpu_torch.scripts.distill_fountain import (gray_crops, rand_homography,
                                                              require, warp_image)
from reconstructor_tpu_torch.utils import device as devices

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "build", "superglue_fountain_torch.npz")
SP_WEIGHTS = os.path.join(REPO, "tests", "data", "superpoint_fountain.npz")
DATA = os.path.join(REPO, "reference", "data")
CROP = 320
BANK_KEYS = ("d0", "d1", "x0", "x1", "s0", "s1", "m0", "m1", "gt0", "bin1")


def build_bank(grays, sp_net: sp.SuperPointNet, n_pairs, kps, rng, conf_thresh=0.015):
    """(desc0, desc1, xy0, xy1, sc0, sc1, m0, m1, gt0, bin1) arrays.

    gt0[i] = column index of kp i's GT partner, kps (the dust-bin column)
    when kp i maps inside the warp but has no partner within 3 px, or -1
    (excluded from the loss) when it maps outside the crop.
    bin1[j] = True when kp j of the warped crop has no GT partner (its
    dust-bin row term enters the loss).
    """
    dev = next(sp_net.parameters()).device
    shape = torch.tensor([[CROP, CROP]], dtype=torch.int32, device=dev)

    def detect(g):
        return sp.detect_and_describe(
            sp_net, torch.as_tensor(np.asarray(g, np.float32), device=dev)[None], shape,
            max_keypoints=kps, conf_thresh=conf_thresh)

    out: Dict[str, List[np.ndarray]] = {k: [] for k in BANK_KEYS}
    n_img = len(grays)
    made = 0
    while made < n_pairs:
        g = grays[rng.integers(n_img)]
        H_img, W_img = g.shape
        y0 = rng.integers(0, H_img - CROP + 1)
        x0 = rng.integers(0, W_img - CROP + 1)
        crop = g[y0:y0 + CROP, x0:x0 + CROP]
        Hm = rand_homography(rng, CROP)
        warped = warp_image(crop, Hm, CROP)

        fa = detect(crop)
        fb = detect(warped)
        xa = fa.xy[0].cpu().numpy()
        ma = fa.mask[0].cpu().numpy().astype(bool)
        xb = fb.xy[0].cpu().numpy()
        mb = fb.mask[0].cpu().numpy().astype(bool)
        if ma.sum() < 64 or mb.sum() < 64:
            continue

        # map A's keypoints through the warp: warp_image computes
        # out(x, y) = img(H^-1 (x, y)), so a source point p appears at
        # H(p) in the warped image
        ph = np.concatenate([xa, np.ones((kps, 1))], axis=1) @ Hm.T
        pw = ph[:, :2] / np.maximum(np.abs(ph[:, 2:]), 1e-9) * np.sign(ph[:, 2:])
        inside = ((pw[:, 0] >= 4) & (pw[:, 0] < CROP - 4)
                  & (pw[:, 1] >= 4) & (pw[:, 1] < CROP - 4) & ma)
        d2 = np.linalg.norm(pw[:, None] - xb[None], axis=-1)
        d2[:, ~mb] = 1e9
        nn = d2.argmin(1)
        nnd = d2[np.arange(kps), nn]
        # one-to-one: keep the closest claimant of each target
        gt0 = np.full(kps, -1, np.int64)
        gt0[inside & (nnd < 3.0)] = nn[inside & (nnd < 3.0)]
        for j in np.unique(gt0[gt0 >= 0]):
            claim = np.where(gt0 == j)[0]
            if claim.size > 1:
                keep = claim[np.argmin(nnd[claim])]
                gt0[claim] = -1
                gt0[keep] = j
        gt0[inside & (gt0 < 0)] = kps        # dust-bin column
        matched_j = gt0[(gt0 >= 0) & (gt0 < kps)]
        bin1 = mb.copy()
        bin1[matched_j] = False

        if (gt0 >= 0).sum() < 32:
            continue
        out["d0"].append(fa.desc[0].cpu().numpy())
        out["d1"].append(fb.desc[0].cpu().numpy())
        out["x0"].append(xa)
        out["x1"].append(xb)
        out["s0"].append(fa.score[0].cpu().numpy())
        out["s1"].append(fb.score[0].cpu().numpy())
        out["m0"].append(ma)
        out["m1"].append(mb)
        out["gt0"].append(gt0)
        out["bin1"].append(bin1)
        made += 1
    return {k: np.stack(v) for k, v in out.items()}


def small_identity_params(n_layers: int, gamma: float = 24.0, bin_score: float = 5.0,
                          generator: torch.Generator = None) -> sg.SuperGlue:
    """An n-layer GNN initialised AT the structured identity (step 0 ==
    the production matcher); the other weights from ``generator``
    (seed 1 when not given)."""
    return sg.structured_identity_params(gamma, bin_score,
                                         generator or torch.Generator().manual_seed(1),
                                         n_layers=n_layers)


def trainable(net: sg.SuperGlue) -> List[torch.Tensor]:
    """The tensors training updates: every parameter and every BN's
    ``running_mean`` and ``running_var`` (leaves of the JAX pytree, so
    ``value_and_grad`` and Adam treat them as weights there)."""
    out = list(net.parameters())
    for m in net.modules():
        if isinstance(m, sg.EvalBatchNorm):
            out += [m.running_mean, m.running_var]
    return out


def to_device(bank: Dict[str, np.ndarray], device, sl=slice(None)) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v[sl]), device=device) for k, v in bank.items()}


def split_bank(bank: Dict[str, np.ndarray], device):
    """The JAX script's split: the first max(8, P/10) pairs (at most half
    the bank) for validation, the rest for training. Returns (train,
    validation) on ``device``."""
    n_bank = bank["d0"].shape[0]
    n_val = min(max(8, n_bank // 10), max(n_bank // 2, 1))
    return to_device(bank, device, slice(n_val, None)), to_device(bank, device, slice(None, n_val))


def pair_nll(net: sg.SuperGlue, b: Dict[str, torch.Tensor], idx: torch.Tensor,
             sinkhorn_iters: int) -> torch.Tensor:
    """The JAX script's ``pair_nll`` for the bank's pairs ``idx``, batched:
    the mean log-likelihood of each ground-truth column (a partner or the
    dust bin) over the rows that have one, plus that of the dust-bin row
    over the warped crop's unmatched keypoints, negated. Returns (B,)."""
    xy0n = sg.normalize_keypoints(b["x0"][idx], CROP, CROP)
    xy1n = sg.normalize_keypoints(b["x1"][idx], CROP, CROP)
    m0, m1 = b["m0"][idx].bool(), b["m1"][idx].bool()
    f0, f1 = sg.gnn_forward(net, b["d0"][idx], b["d1"][idx], xy0n, xy1n, b["s0"][idx],
                            b["s1"][idx], m0, m1)
    scores = torch.einsum("bmd,bnd->bmn", f0, f1) / (sg.D_MODEL ** 0.5)
    Z = sg.log_sinkhorn(scores, net.bin_score, m0, m1, sinkhorn_iters)
    kps = scores.shape[1]
    gt = b["gt0"][idx].long()
    has = gt >= 0
    row_ll = torch.gather(Z[:, :kps], 2, torch.where(has, gt, 0)[..., None])[..., 0]
    row_terms = torch.where(has, row_ll, 0.0)
    n_row = torch.clamp(has.sum(1), min=1)
    bin1 = b["bin1"][idx].bool()
    bin_ll = torch.where(bin1, Z[:, kps, :kps], 0.0)
    n_bin = torch.clamp(bin1.sum(1), min=1)
    return -(row_terms.sum(1) / n_row + bin_ll.sum(1) / n_bin)


def batch_loss(net: sg.SuperGlue, b: Dict[str, torch.Tensor], idx: torch.Tensor,
               sinkhorn_iters: int) -> torch.Tensor:
    """The JAX script's ``loss_fn``: the mean of ``pair_nll`` over ``idx``."""
    return pair_nll(net, b, idx, sinkhorn_iters).mean()


def schedule(step: int, lr: float, steps: int) -> float:
    """optax's ``cosine_decay_schedule(lr, steps)`` at update ``step`` (0
    for the first update): lr (1 + cos(pi min(step, steps) / steps)) / 2."""
    if steps <= 0:
        raise ValueError(f"the cosine decay needs steps > 0, got {steps}")
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(step, steps) / steps))


def make_optimizer(tensors: List[torch.Tensor]) -> torch.optim.Adam:
    """optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8); the learning
    rate is set before every step."""
    return torch.optim.Adam(tensors, lr=0.0, betas=(0.9, 0.999), eps=1e-8)


def val_f1(net: sg.SuperGlue, val: Dict[str, torch.Tensor]):
    """Precision/recall of decoded matches vs GT on the val pairs:
    ``match_pair`` at 100 Sinkhorn iterations and a 0.5 score threshold,
    one call a pair. Returns (F1, precision, recall)."""
    shape = torch.tensor([CROP, CROP], dtype=torch.int32, device=val["d0"].device)
    kps = val["d0"].shape[1]
    tp = fp = fn = 0
    for i in range(val["d0"].shape[0]):
        mi, _, _ = sg.match_pair(
            net, val["d0"][i], val["d1"][i], val["x0"][i], val["x1"][i],
            val["s0"][i], val["s1"][i], val["m0"][i].bool(), val["m1"][i].bool(),
            shape, shape, sinkhorn_iters=100, score_thresh=0.5)
        mi = mi.cpu().numpy()
        gt = val["gt0"][i].cpu().numpy()
        has_gt = (gt >= 0) & (gt < kps)
        pred = mi >= 0
        tp += int((pred & has_gt & (mi == gt)).sum())
        fp += int((pred & ~(has_gt & (mi == gt))).sum())
        fn += int((has_gt & ~(pred & (mi == gt))).sum())
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return 2 * prec * rec / max(prec + rec, 1e-9), prec, rec


def train(net: sg.SuperGlue, trn: Dict[str, torch.Tensor], val: Dict[str, torch.Tensor],
          steps: int, lr: float, batch: int, sinkhorn_iters: int, seed: int = 0,
          val_every: int = 100, log=None) -> dict:
    """The JAX script's loop: the identity's F1, then ``steps`` Adam
    updates of ``batch`` pairs drawn with replacement, ``val_f1`` every
    ``val_every`` steps, the best weights kept. Returns {"net" (the
    last), "best" (the best, the identity when nothing beat it),
    "identity" (F1, P, R), "best_f1", "validations" (step, F1, P, R) of
    every validation, step 0's first, "losses" (steps,) numpy,
    "val_calls", "wall_s" (training, host clock ending in a device
    synchronise)}."""
    dev = trn["d0"].device
    net = net.to(dev).train()
    tensors = trainable(net)
    for t in tensors:
        t.requires_grad_(True)
    opt = make_optimizer(tensors)
    n_trn = trn["d0"].shape[0]
    gen = devices.generator(dev, seed)
    identity = val_f1(net, val)
    validations = [(0, *identity)]
    if log is not None:
        log(f"identity baseline: F1 {identity[0]:.3f} (P {identity[1]:.3f} "
            f"R {identity[2]:.3f})")
    best_f1, best = identity[0], copy.deepcopy(net)
    losses = torch.zeros(steps, device=dev)
    t0 = time.perf_counter()
    for it in range(steps):
        idx = torch.randint(0, n_trn, (batch,), generator=gen, device=dev)
        opt.zero_grad(set_to_none=False)
        loss = batch_loss(net, trn, idx, sinkhorn_iters)
        loss.backward()
        for group in opt.param_groups:
            group["lr"] = schedule(it, lr, steps)
        opt.step()
        losses[it] = loss.detach()
        if (it + 1) % val_every == 0:
            f1, prec, rec = val_f1(net, val)
            validations.append((it + 1, f1, prec, rec))
            mark = ""
            if f1 > best_f1:
                best_f1, best = f1, copy.deepcopy(net)
                mark = "  *best*"
            if log is not None:
                log(f"step {it + 1:5d}: loss {float(losses[it]):.4f}  F1 {f1:.3f} "
                    f"(P {prec:.3f} R {rec:.3f})  "
                    f"{(it + 1) / (time.perf_counter() - t0):.1f} it/s{mark}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    for m in (net, best):
        for t in trainable(m):
            t.requires_grad_(False)
    return {"net": net.eval(), "best": best.eval(), "identity": identity, "best_f1": best_f1,
            "validations": validations, "losses": losses.cpu().numpy(),
            "val_calls": len(validations), "wall_s": wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--pairs", type=int, default=200)
    ap.add_argument("--kps", type=int, default=512)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--sinkhorn-iters", type=int, default=50)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="weights npz (default: build/, which git ignores)")
    ap.add_argument("--warm-start", default=None,
                    help="resume from a params npz instead of the identity")
    ap.add_argument("--bank", default=None,
                    help="npz path to cache/reuse the correspondence bank")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = devices.resolve("cpu" if args.cpu else None)

    require(DATA)
    from reconstructor_tpu_torch.io import images as io_images
    sp_net = sp.params_from_npz(SP_WEIGHTS).to(dev)
    _, _, grays = gray_crops(io_images.load_folder(DATA, 512))

    rng = np.random.default_rng(0)
    t0 = time.time()
    if args.bank and os.path.exists(args.bank):
        bank = dict(np.load(args.bank))
        print(f"loaded bank {args.bank}", flush=True)
    else:
        bank = build_bank(grays, sp_net, args.pairs, args.kps, rng)
        if args.bank:
            np.savez_compressed(args.bank, **bank)
    trn, val = split_bank(bank, dev)
    print(f"bank: {trn['d0'].shape[0]} train / {val['d0'].shape[0]} val pairs "
          f"({time.time() - t0:.0f} s)", flush=True)

    if args.warm_start and os.path.exists(args.warm_start):
        net = sg.params_from_npz(args.warm_start)
        print(f"warm-started from {args.warm_start}", flush=True)
    else:
        net = small_identity_params(args.layers)
    res = train(net, trn, val, args.steps, args.lr, args.batch, args.sinkhorn_iters,
                log=lambda m: print(m, flush=True))

    f1_0 = res["identity"][0]
    print(f"final: best F1 {res['best_f1']:.3f} vs identity {f1_0:.3f}", flush=True)
    if res["best_f1"] > f1_0:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        sg.params_to_npz(res["best"], args.out)
        print(f"saved {args.out}", flush=True)
    else:
        print("trained model did NOT beat the identity — not saving", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
