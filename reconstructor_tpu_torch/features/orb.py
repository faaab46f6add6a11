"""ORB-style detector: FAST corners + oriented BRIEF descriptors, batched.

The PyTorch counterpart of ``reconstructor_tpu.features.orb`` (the
reference's commented-out ORB support beside SIFT, FeatureDetector.cpp:9,19;
BASELINE config 1 "ORB + FLANN"):

- FAST-9/16: all 16 Bresenham-circle comparisons for every pixel at once
  (shifted images, no gathers); the contiguous-arc test runs as bit-mask
  rotations, in int64 (the JAX package's uint32 masks; the values fit).
- Score: sum of absolute center-circle differences (the FAST score),
  3x3 NMS, global top-K with validity masks — the fixed-capacity layout
  of features.sift.
- Orientation by intensity centroid over a radius-7 disc, and 256 BRIEF
  tests with offsets rotated by it, both as gathers over every (image,
  keypoint) at once.
- Bits are +-1/16 (+-1 over sqrt(256)), so Hamming distance is an affine
  function of the inner product and the kNN matcher works unchanged; every
  entry is exact in bfloat16, so the card's bf16 kNN kernel is exact on them.

The test pattern is the JAX package's seeded draw, copied as it is.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reconstructor_tpu_torch.features.sift import Features

# Bresenham circle of radius 3 (FAST-16 offsets, clockwise from 12 o'clock)
_CIRCLE = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], np.int32)  # (dx, dy)

_NUM_TESTS = 256
_PATCH_R = 15


def _brief_pattern(seed: int = 7) -> np.ndarray:
    """(256, 4) test offsets (x1, y1, x2, y2), N(0, (R/2)^2) clipped."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, _PATCH_R / 2.0, size=(_NUM_TESTS, 4))
    return np.clip(pts, -_PATCH_R, _PATCH_R).astype(np.float32)


_PATTERN = _brief_pattern()


def _shift(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """Shift an (N, H, W) batch so out[y, x] = img[y+dy, x+dx], wrapping
    around at the borders (``jnp.roll``, as the JAX package does)."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(1, 2))


def fast_score(gray: torch.Tensor, threshold: float):
    """FAST-9/16 corner mask and score for an (N, H, W) batch."""
    center = gray
    brighter = torch.zeros(gray.shape, dtype=torch.int64, device=gray.device)
    darker = torch.zeros_like(brighter)
    score = torch.zeros_like(gray)
    for i, (dx, dy) in enumerate(_CIRCLE):
        diff = _shift(gray, int(dx), int(dy)) - center
        brighter |= (diff > threshold).to(torch.int64) << i
        darker |= (diff < -threshold).to(torch.int64) << i
        score = score + torch.abs(diff)

    def has_arc9(mask16):
        # contiguous run >= 9 on the 16-bit ring: duplicate the ring and
        # AND together 9 successively shifted copies
        ring = mask16 | (mask16 << 16)
        run = ring
        for s in range(1, 9):
            run = run & (ring >> s)
        return run != 0

    corner = has_arc9(brighter) | has_arc9(darker)
    return corner, torch.where(corner, score, 0.0)


def _gather(gray: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """gray[n, ys, xs] for (N, H, W) gray and (N, ...) int indices."""
    N, H, W = gray.shape
    flat = (ys.long() * W + xs.long()).reshape(N, -1)
    return torch.gather(gray.reshape(N, -1), 1, flat).reshape(ys.shape)


def _orientation(gray: torch.Tensor, xy: torch.Tensor, radius: int = 7) -> torch.Tensor:
    """Intensity-centroid orientation at every keypoint: gray (N, H, W),
    xy (N, K, 2) -> theta (N, K)."""
    N, H, W = gray.shape
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=gray.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    in_disc = (ox ** 2 + oy ** 2) <= radius * radius
    # .to(int32) truncates toward zero, as astype(int32) does
    ys = torch.clamp((xy[..., 1, None, None] + oy).to(torch.int32), 0, H - 1)
    xs = torch.clamp((xy[..., 0, None, None] + ox).to(torch.int32), 0, W - 1)
    patch = _gather(gray, ys, xs) * in_disc                          # (N, K, 2r+1, 2r+1)
    m10 = torch.sum((patch * ox).flatten(-2), dim=-1)
    m01 = torch.sum((patch * oy).flatten(-2), dim=-1)
    return torch.arctan2(m01, m10)


def _brief_at(gray: torch.Tensor, xy: torch.Tensor, theta: torch.Tensor,
              pattern: torch.Tensor) -> torch.Tensor:
    """Rotated-BRIEF +-1/16 descriptors: gray (N, H, W), xy (N, K, 2),
    theta (N, K), pattern (256, 4) -> (N, K, 256)."""
    N, H, W = gray.shape
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]

    def sample(ox, oy):
        rx = c * ox - s * oy
        ry = s * ox + c * oy
        ys = torch.clamp((xy[..., 1, None] + ry).to(torch.int32), 0, H - 1)
        xs = torch.clamp((xy[..., 0, None] + rx).to(torch.int32), 0, W - 1)
        return _gather(gray, ys, xs)

    v1 = sample(pattern[:, 0], pattern[:, 1])
    v2 = sample(pattern[:, 2], pattern[:, 3])
    bits = torch.where(v1 < v2, 1.0, -1.0).to(gray.dtype)
    return bits / torch.sqrt(torch.tensor(float(_NUM_TESTS), dtype=gray.dtype))


def detect_and_describe(gray: torch.Tensor, shapes: torch.Tensor,
                        max_keypoints: int = 2048, threshold: float = 0.06,
                        border: int = 16) -> Features:
    """Full ORB frontend: (N, H, W) float [0,1] batch -> Features."""
    N, H, W = gray.shape
    dev = gray.device
    # light blur stabilizes both FAST and BRIEF: [0.25, 0.5, 0.25] along
    # the width, then along the height, one zero pixel padded each side
    k = torch.tensor([0.25, 0.5, 0.25], dtype=gray.dtype, device=dev)
    img4 = F.conv2d(gray[:, None], k.reshape(1, 1, 1, 3), padding=(0, 1))
    img4 = F.conv2d(img4, k.reshape(1, 1, 3, 1), padding=(1, 0))
    smooth = img4[:, 0]

    corner, score = fast_score(smooth, threshold)

    ys = torch.arange(H, device=dev)[None, :, None]
    xs = torch.arange(W, device=dev)[None, None, :]
    hh = shapes[:, 0].to(dev)[:, None, None]
    ww = shapes[:, 1].to(dev)[:, None, None]
    inb = (ys >= border) & (ys < hh - border) & (xs >= border) & (xs < ww - border)
    score = torch.where(inb, score, 0.0)

    # 3x3 NMS
    pad = F.pad(score, (1, 1, 1, 1))
    rows = torch.maximum(torch.maximum(pad[:, :-2, 1:-1], pad[:, 1:-1, 1:-1]), pad[:, 2:, 1:-1])
    padr = F.pad(rows, (1, 1))
    local_max = torch.maximum(torch.maximum(padr[:, :, :-2], padr[:, :, 1:-1]), padr[:, :, 2:])
    score = torch.where(score >= local_max, score, 0.0)

    # global top-K per image; a stable descending sort keeps the lowest
    # flat index first among equal scores (lax.top_k's order)
    flat = score.reshape(N, -1)
    scores, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :max_keypoints], idx[:, :max_keypoints]
    yk = (idx // W).to(gray.dtype)
    xk = (idx % W).to(gray.dtype)
    mask = scores > 0
    xy = torch.stack([xk, yk], dim=-1)

    pattern = torch.as_tensor(_PATTERN, device=dev)
    theta = _orientation(smooth, xy)
    desc = _brief_at(smooth, xy, theta, pattern) * mask[..., None]
    return Features(xy=xy, scale=torch.full(scores.shape, 3.0, dtype=gray.dtype, device=dev),
                    score=scores, desc=desc, mask=mask)
