"""The packed kNN kernel against the float one, on the card.

The counterpart of the TPU package's ``scripts/check_packed_tpu.py``: at
N = 6 images of K = 1024 random unit descriptors (D = 128), slots 900 and
up masked, up to 16 pairs of distinct images, it runs
``cuda_knn.knn_topk2(..., packed=True)`` (``csrc/knn_packed.cu``, int32
bias) and the float kernel (``csrc/knn_top2.cu``, 1e30 bias) in float32
and in bfloat16, and prints one JSON line with, per type,

- ``arg_agree`` / ``colarg_agree``: the share of equal row and column
  argmins (quantising to 2^-17 can order two near-equal distances by slot);
- ``best_maxerr``: the largest |best| difference over rows with a valid
  best (at most 2^-17 plus the float kernel's own rounding);
- ``sentinel_agree``: the share of rows on which both agree that no valid
  column exists.

    python -m reconstructor_tpu_torch.scripts.check_packed               # on the card
    python -m reconstructor_tpu_torch.scripts.check_packed --device cpu  # plain versions
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from reconstructor_tpu_torch.matching import cuda_knn
from reconstructor_tpu_torch.utils import device as devices


def inputs(seed: int = 0):
    """The TPU script's inputs: (desc (6, 1024, 128) float32, mask (6,
    1024), pairs (<= 16, 2) int32) as numpy."""
    rng = np.random.default_rng(seed)
    N, K, D, B = 6, 1024, 128, 32
    desc = rng.standard_normal((N, K, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    mask = np.ones((N, K), bool)
    mask[:, 900:] = False          # exercise the mask sentinel
    pidx = rng.integers(0, N, (B, 2)).astype(np.int32)
    pidx = pidx[pidx[:, 0] != pidx[:, 1]][:16]
    return desc, mask, pidx


def compare(packed_out, float_out) -> dict:
    """The agreement measures of one type (see the module docstring)."""
    bp, _, ap, cp = [x.cpu().numpy() for x in packed_out]
    bf, _, af, cf = [x.cpu().numpy() for x in float_out]
    lo = bf < 1e29
    return {"arg_agree": float((ap == af).mean()),
            "colarg_agree": float((cp == cf).mean()),
            "best_maxerr": float(np.abs(bp - bf)[lo].max()),
            "sentinel_agree": float(((bp > 1e29) == (bf > 1e29)).mean())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card); 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    desc, mask, pidx = inputs()
    desc_t = torch.from_numpy(desc).to(dev)
    mask_t = torch.from_numpy(mask).to(dev)
    pidx_t = torch.from_numpy(pidx).to(dev)
    bias_f = torch.where(mask_t, 0.0, cuda_knn._BIG).to(torch.float32)
    bias_i = torch.where(mask_t, 0, cuda_knn._DMAX).to(torch.int32)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    for dt in ("float32", "bfloat16"):
        d = desc_t.to(torch.bfloat16) if dt == "bfloat16" else desc_t
        res = compare(cuda_knn.knn_topk2(d, bias_i, pidx_t, packed=True),
                      cuda_knn.knn_topk2(d, bias_f, pidx_t))
        out.update({f"{dt}_{k}": v for k, v in res.items()})
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
