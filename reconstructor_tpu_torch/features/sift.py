"""Classic (DoG/SIFT-style) feature detection as one batched program.

Capability parity with the reference's ``FeatureClassic`` (OpenCV SIFT,
FeatureDetector.cpp:13-35), in the design of ``reconstructor_tpu``'s
detector, which this module mirrors step for step:

- The Gaussian scale space is built at full resolution with
  geometrically increasing sigmas, for the whole image batch at once, by
  two band-matrix contractions (rows, then columns). The band matrices
  compose the incremental, zero-padded, 3-sigma-truncated separable blur
  chain in float64 on the host, so every level equals the conv chain to
  float32 rounding.
- Extrema detection, contrast/edge gating and a 3x3 spatial NMS are
  fixed-shape masked tensor ops; every image yields exactly
  ``max_keypoints`` slots with a validity mask. Slots are sorted by score
  (descending, lowest flat index first on ties), so valid keypoints are a
  prefix — the matcher trims the keypoint axis on that assumption.
- The descriptor is the classic 4x4 spatial x 8 orientation histogram
  (128-d) over a 16x16 gradient patch sampled at the keypoint's scale,
  rotated to a dominant orientation, L2-normalized, 0.2-clipped and
  renormalized as in Lowe's paper. Patches sample the Gaussian level
  resampled at the descriptor's pitch, with taps clamped to the level's
  own extent (replicate edges).

Output coordinate convention matches the reference: (x, y) pixel
coordinates in the resized image, plus a quadratic subpixel offset.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# keypoints per descriptor batch: bounds the (M, 256, 36) orientation and
# (M, 256, 16) binning intermediates to a few hundred MB at M = 8192
_DESC_CHUNK = 8192


class Features(NamedTuple):
    """Fixed-capacity per-image feature set (batched over leading dim)."""
    xy: torch.Tensor       # (..., K, 2) float32 — (x, y) pixel coords
    scale: torch.Tensor    # (..., K) float32 — detection sigma
    score: torch.Tensor    # (..., K) float32 — |DoG| response
    desc: torch.Tensor     # (..., K, D) float32 — L2-normalized descriptor (SIFT 128, SuperPoint 256)
    mask: torch.Tensor     # (..., K) bool


def gaussian_kernel1d(sigma: float, radius: int, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """Normalised Gaussian taps at -radius..radius."""
    x = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable, zero-padded Gaussian blur of an (N, H, W) batch, the
    taps truncated at 3 sigma (the conv chain the band matrices below
    compose)."""
    radius = max(1, int(math.ceil(3.0 * sigma)))
    k = gaussian_kernel1d(sigma, radius, img.dtype, img.device)
    out = F.conv2d(img[:, None], k.reshape(1, 1, 1, -1), padding=(0, radius))
    out = F.conv2d(out, k.reshape(1, 1, -1, 1), padding=(radius, 0))
    return out[:, 0]


@functools.lru_cache(maxsize=8)
def _blur_band_matrices(n: int, num_scales: int, sigma0: float,
                        scales_per_octave: int) -> np.ndarray:
    """(S, n, n) float32 band matrices: level s = mats[s] @ signal.

    Composed in float64 numpy to replicate the incremental zero-padded
    separable blur chain exactly (each increment's kernel truncated at
    its own 3*sigma).
    """
    sigmas = [sigma0 * (2.0 ** (i / scales_per_octave)) for i in range(num_scales)]
    mats = []
    prev = None
    for i, s in enumerate(sigmas):
        inc = s if i == 0 else math.sqrt(max(s * s - sigmas[i - 1] ** 2, 1e-6))
        radius = max(1, int(math.ceil(3.0 * inc)))
        x = np.arange(-radius, radius + 1, dtype=np.float64)
        k = np.exp(-0.5 * (x / inc) ** 2)
        k /= k.sum()
        T = np.zeros((n, n), np.float64)
        for o, w in zip(range(-radius, radius + 1), k):
            T += np.diag(np.full(n - abs(o), w), o)
        prev = T if prev is None else T @ prev
        mats.append(prev)
    return np.stack(mats).astype(np.float32)


def build_scale_space(img: torch.Tensor, num_scales: int, sigma0: float = 1.6,
                      scales_per_octave: int = 3):
    """(N, H, W) -> gaussians (N, S, H, W) and sigmas (S,).

    sigma_i = sigma0 * 2^(i / scales_per_octave); all S levels come from
    two batched band-matrix contractions.
    """
    N, H, W = img.shape
    dev, dt = img.device, img.dtype
    A = torch.from_numpy(_blur_band_matrices(H, num_scales, float(sigma0),
                                             scales_per_octave)).to(dev)
    B = torch.from_numpy(_blur_band_matrices(W, num_scales, float(sigma0),
                                             scales_per_octave)).to(dev)
    sigmas = [sigma0 * (2.0 ** (i / scales_per_octave)) for i in range(num_scales)]
    g = torch.einsum("sab,nbw->nsaw", A, img)          # blur rows (H axis)
    g = torch.einsum("nsaw,svw->nsav", g, B)           # blur cols (W axis)
    return g, torch.tensor(sigmas, dtype=dt, device=dev)


def _pool3x3(x: torch.Tensor, op, fill: float) -> torch.Tensor:
    pad = F.pad(x, (1, 1, 1, 1), value=fill)
    rows = op(op(pad[..., :-2, 1:-1], pad[..., 1:-1, 1:-1]), pad[..., 2:, 1:-1])
    padr = F.pad(rows, (1, 1), value=fill)
    return op(op(padr[..., :-2], padr[..., 1:-1]), padr[..., 2:])


def _neighborhood_extrema(dog: torch.Tensor) -> torch.Tensor:
    """26-neighborhood extremum test over the (N, S, H, W) DoG volume.

    Returns bool (N, S-2, H, W) for the interior scales: a voxel is an
    extremum when it equals the max (or min) of its 3x3x3 neighborhood.
    """
    mx = _pool3x3(dog, torch.maximum, -math.inf)
    mn = _pool3x3(dog, torch.minimum, math.inf)
    nb_max = torch.maximum(torch.maximum(mx[:, :-2], mx[:, 1:-1]), mx[:, 2:])
    nb_min = torch.minimum(torch.minimum(mn[:, :-2], mn[:, 1:-1]), mn[:, 2:])
    center = dog[:, 1:-1]
    is_max = (center >= nb_max) & (center > 0)
    is_min = (center <= nb_min) & (center < 0)
    return is_max | is_min


def _edge_response_ok(d: torch.Tensor, edge_thresh: float) -> torch.Tensor:
    """Hessian-ratio edge rejection (Lowe §4.1): tr^2/det < (r+1)^2/r,
    on the last two (H, W) axes of ``d``."""
    dxx = F.pad(d[..., :, 2:] + d[..., :, :-2] - 2 * d[..., :, 1:-1], (1, 1))
    dyy = F.pad(d[..., 2:, :] + d[..., :-2, :] - 2 * d[..., 1:-1, :], (0, 0, 1, 1))
    dxy = (d[..., 2:, 2:] - d[..., 2:, :-2] - d[..., :-2, 2:] + d[..., :-2, :-2]) / 4.0
    dxy = F.pad(dxy, (1, 1, 1, 1))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_thresh
    return (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)


def detect_keypoints(gray: torch.Tensor, shapes: torch.Tensor, max_keypoints: int,
                     num_scales: int = 12, contrast_thresh: float = 0.004,
                     edge_thresh: float = 10.0, border: int = 8,
                     sigma0: float = 0.8):
    """Batched DoG keypoint detection.

    gray: (N, H, W) float32 in [0,1]; shapes: (N, 2) valid (h, w) per image.
    Returns (xy (N,K,2), scale (N,K), score (N,K), mask (N,K),
    gaussians (N,S,H,W), sigmas (S,), scale index (N,K)).
    """
    N, H, W = gray.shape
    dev = gray.device
    gauss, sigmas = build_scale_space(gray, num_scales, sigma0=sigma0)
    dog = gauss[:, 1:] - gauss[:, :-1]                    # (N, S-1, H, W)

    extrema = _neighborhood_extrema(dog)                  # (N, S-3, H, W)
    inner = dog[:, 1:-1]
    cand = extrema & (torch.abs(inner) > contrast_thresh) & _edge_response_ok(inner, edge_thresh)

    ys = torch.arange(H, device=dev)[None, None, :, None]
    xs = torch.arange(W, device=dev)[None, None, None, :]
    h_valid = shapes[:, 0].to(dev)[:, None, None, None]
    w_valid = shapes[:, 1].to(dev)[:, None, None, None]
    in_bounds = (ys >= border) & (ys < h_valid - border) & (xs >= border) & (xs < w_valid - border)
    cand = cand & in_bounds

    score_vol = torch.where(cand, torch.abs(inner), 0.0)
    local_max = _pool3x3(score_vol, torch.maximum, 0.0)
    score_vol = torch.where(score_vol >= local_max, score_vol, 0.0)

    # global top-K per image; a stable descending sort keeps the lowest
    # flat index first among equal scores (lax.top_k's order)
    flat = score_vol.reshape(N, -1)
    scores, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :max_keypoints], idx[:, :max_keypoints]
    s_idx = idx // (H * W)
    y_idx = (idx % (H * W)) // W
    x_idx = idx % W
    mask = scores > 0
    dxy = _subpixel_offset(dog, s_idx + 1, y_idx, x_idx)
    xy = torch.stack([x_idx, y_idx], dim=-1).to(gray.dtype) + dxy
    scale = sigmas[s_idx + 1]
    return xy, scale, scores, mask, gauss, sigmas, s_idx + 1


def _subpixel_offset(dog: torch.Tensor, d_idx: torch.Tensor, y: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """(dx, dy) quadratic-fit offsets on each keypoint's DoG level,
    clamped to +-0.5. dog: (N, D, H, W); d_idx/y/x: (N, K)."""
    N, D, H, W = dog.shape
    yc = torch.clamp(y, 1, H - 2)
    xc = torch.clamp(x, 1, W - 2)
    ns = torch.arange(N, device=dog.device)[:, None]

    def level_val(oy, ox):
        return dog[ns, d_idx, yc + oy, xc + ox]

    v = level_val(0, 0)
    gx = (level_val(0, 1) - level_val(0, -1)) / 2.0
    gy = (level_val(1, 0) - level_val(-1, 0)) / 2.0
    hxx = level_val(0, 1) + level_val(0, -1) - 2 * v
    hyy = level_val(1, 0) + level_val(-1, 0) - 2 * v
    hxy = (level_val(1, 1) - level_val(1, -1) - level_val(-1, 1) + level_val(-1, -1)) / 4.0
    det = hxx * hyy - hxy * hxy
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    dx = torch.clamp(-(hyy * gx - hxy * gy) / det, -0.5, 0.5)
    dy = torch.clamp(-(hxx * gy - hxy * gx) / det, -0.5, 0.5)
    return torch.stack([dx, dy], dim=-1)


def _pitch_of(sigma: float) -> float:
    """Descriptor sample spacing for a level sigma (3 px/bin at sigma=1.6)."""
    return sigma * 3.0 / 1.6 / 2.0


def _resample_pitch_levels(gauss: torch.Tensor, sigma_list, lo: int, hi: int):
    """Resample Gaussian levels [lo, hi) onto their descriptor-pitch grids.

    gauss: (N, S, H, W). Level s is bilinearly resampled at coordinate
    pitch ``_pitch_of(sigma_list[s])`` (tent-weight matrices, two small
    matmuls per level), each at its own (U_l, V_l) grid, out-of-image
    coordinates clamped to the edge. Results land in a zero-padded
    (N, hi-lo, U, V) volume; per-level valid extents come back so the
    descriptor taps clamp to the level's own edge.

    Returns (rs, pitches (hi-lo,), lims (hi-lo, 2) int64).
    """
    N, S, H, W = gauss.shape
    dev = gauss.device
    pitches = [_pitch_of(sigma_list[s]) for s in range(lo, hi)]
    sizes = [(int((H - 1) / p) + 2, int((W - 1) / p) + 2) for p in pitches]
    U = max(u for u, _ in sizes)
    V = -(-max(v for _, v in sizes) // 8) * 8
    hs = np.arange(H, dtype=np.float32)
    ws = np.arange(W, dtype=np.float32)
    g = gauss[:, lo:hi].to(torch.float32)
    levels = []
    for i, (p, (Ul, Vl)) in enumerate(zip(pitches, sizes)):
        cu = np.minimum(np.arange(Ul, dtype=np.float32) * p, H - 1.0)
        cv = np.minimum(np.arange(Vl, dtype=np.float32) * p, W - 1.0)
        A = torch.from_numpy(np.clip(1.0 - np.abs(cu[:, None] - hs[None, :]), 0, 1)).to(dev)
        B = torch.from_numpy(np.clip(1.0 - np.abs(cv[:, None] - ws[None, :]), 0, 1)).to(dev)
        level = torch.matmul(torch.matmul(A, g[:, i]), B.T)
        levels.append(F.pad(level, (0, V - Vl, 0, U - Ul)))
    rs = torch.stack(levels, dim=1)
    lims = torch.tensor(sizes, dtype=torch.int64, device=dev)
    return rs.to(gauss.dtype), torch.tensor(pitches, dtype=gauss.dtype, device=dev), lims


def _descriptors_at(rs_flat: torch.Tensor, rs_shape, img: torch.Tensor,
                    s_rel: torch.Tensor, xy: torch.Tensor, sigma: torch.Tensor,
                    pitch: torch.Tensor, lim: torch.Tensor,
                    patch_radius: int = 8) -> torch.Tensor:
    """128-d SIFT descriptors of M keypoints.

    rs_flat: the flattened (N, Sl, U, V) pitch-matched volume; img, s_rel
    (M,) image and level of each keypoint; xy (M, 2); sigma, pitch (M,);
    lim (M, 2) the level's valid extent. In the pitch-matched frame the
    (P+2)^2 patch taps sit at integer offsets from one fractional base, so
    sampling is one (P+3)^2 block gather plus a 4-term bilinear combine.
    """
    _, Sl, U, V = rs_shape
    M = xy.shape[0]
    dev, dt = xy.device, xy.dtype
    R = patch_radius
    P = 2 * R
    spacing = pitch
    offs_p = (torch.arange(P + 2, dtype=dt, device=dev) - (P + 1) / 2.0)[None, :] * spacing[:, None]
    py = offs_p[:, :, None].expand(M, P + 2, P + 2)
    px = offs_p[:, None, :].expand(M, P + 2, P + 2)

    ub = xy[:, 1] / spacing - (P + 1) / 2.0
    vb = xy[:, 0] / spacing - (P + 1) / 2.0
    u0 = torch.floor(ub).to(torch.int64)
    v0 = torch.floor(vb).to(torch.int64)
    fu = (ub - u0)[:, None, None]
    fv = (vb - v0)[:, None, None]
    ar = torch.arange(P + 3, device=dev)
    uu = torch.minimum(torch.clamp(u0[:, None] + ar, min=0), lim[:, 0:1] - 1)
    vv = torch.minimum(torch.clamp(v0[:, None] + ar, min=0), lim[:, 1:2] - 1)
    base = (img * Sl + s_rel) * U
    flat_idx = (base[:, None, None] + uu[:, :, None]) * V + vv[:, None, :]
    blk = rs_flat[flat_idx]                                  # (M, P+3, P+3)
    patch = ((1 - fu) * (1 - fv) * blk[:, :-1, :-1]
             + (1 - fu) * fv * blk[:, :-1, 1:]
             + fu * (1 - fv) * blk[:, 1:, :-1]
             + fu * fv * blk[:, 1:, 1:])                     # (M, P+2, P+2)

    dx = (patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2]) / 2.0
    dy = (patch[:, 2:, 1:-1] - patch[:, :-2, 1:-1]) / 2.0
    gy = py[:, 1:-1, 1:-1]
    gx = px[:, 1:-1, 1:-1]
    mag = torch.sqrt(dx * dx + dy * dy + 1e-12)
    ang = torch.atan2(dy, dx)

    # --- dominant orientation (36-bin histogram, Gaussian-weighted) ------
    # binned as a one-hot contraction: deterministic on the card, where a
    # float scatter-add's order (and so an argmax tie) would vary by run
    sig = sigma[:, None, None]
    w_orient = torch.exp(-(gx ** 2 + gy ** 2) / (2.0 * (1.5 * sig * 3.0) ** 2))
    bins36 = torch.floor((ang + math.pi) / (2 * math.pi) * 36).to(torch.int64) % 36
    contrib36 = (mag * w_orient).reshape(M, 1, -1)
    onehot = (bins36.reshape(M, -1, 1) == torch.arange(36, device=dev)).to(dt)
    hist36 = torch.bmm(contrib36, onehot)[:, 0]              # (M, 36)
    hist36 = (torch.roll(hist36, 1, dims=1) + hist36 + torch.roll(hist36, -1, dims=1)) / 3.0
    theta0 = (torch.argmax(hist36, dim=1).to(dt) + 0.5) / 36.0 * 2 * math.pi - math.pi
    theta0 = theta0[:, None, None]

    ang_rel = ang - theta0
    cos0, sin0 = torch.cos(-theta0), torch.sin(-theta0)
    sp = torch.clamp(spacing, min=1e-6)[:, None, None]
    rx = (gx * cos0 - gy * sin0) / sp
    ry = (gx * sin0 + gy * cos0) / sp

    # --- 4x4 x 8 histogram with trilinear weights ------------------------
    cx = rx / 4.0 + 1.5 + 0.5
    cy = ry / 4.0 + 1.5 + 0.5
    ob = (ang_rel + 2 * math.pi) % (2 * math.pi) / (2 * math.pi) * 8.0
    w_desc = torch.exp(-(rx ** 2 + ry ** 2) / (2.0 * 8.0 ** 2)) * mag

    s_flat = w_desc.reshape(M, -1)
    cells = torch.arange(4, dtype=dt, device=dev)
    Wy = torch.clamp(1.0 - torch.abs(cy.reshape(M, -1, 1) - 0.5 - cells), 0, 1)
    Wx = torch.clamp(1.0 - torch.abs(cx.reshape(M, -1, 1) - 0.5 - cells), 0, 1)
    obins = torch.arange(8, dtype=dt, device=dev)
    do = torch.abs(ob.reshape(M, -1, 1) - obins)
    Wo = torch.clamp(1.0 - torch.minimum(do, 8.0 - do), 0, 1)
    A = (Wy[:, :, :, None] * Wx[:, :, None, :]).reshape(M, -1, 16) * s_flat[:, :, None]
    v = torch.einsum("msk,mso->mko", A, Wo).reshape(M, 128)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)
    v = torch.clamp(v, max=0.2)
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def compute_descriptors(gauss: torch.Tensor, xy: torch.Tensor, scale_idx: torch.Tensor,
                        sigmas: torch.Tensor, sigma_list=None) -> torch.Tensor:
    """Descriptors for a batch of images' keypoints. gauss: (N, S, H, W);
    xy (N, K, 2); scale_idx (N, K) int; sigma_list: per-level sigmas as
    Python floats (defaults to the values of ``sigmas``). Returns
    (N, K, 128)."""
    if sigma_list is None:
        sigma_list = [float(v) for v in sigmas.cpu()]
    N, S = gauss.shape[:2]
    K = xy.shape[1]
    # detection only emits interior DoG levels [1, S-3]; resample just those
    lo, hi = 1, max(2, S - 2)
    rs, pitches, lims = _resample_pitch_levels(gauss, sigma_list, lo, hi)
    rs_flat = rs.reshape(-1)
    img = torch.arange(N, device=xy.device)[:, None].expand(N, K).reshape(-1)
    s_idx = scale_idx.reshape(-1).to(torch.int64)
    s_rel = torch.clamp(s_idx - lo, 0, hi - lo - 1)
    xy_f = xy.reshape(-1, 2)
    out = []
    for a in range(0, N * K, _DESC_CHUNK):
        b = min(a + _DESC_CHUNK, N * K)
        sr = s_rel[a:b]
        out.append(_descriptors_at(rs_flat, rs.shape, img[a:b], sr, xy_f[a:b],
                                   sigmas[s_idx[a:b]], pitches[sr], lims[sr]))
    return torch.cat(out).reshape(N, K, 128)


def detect_and_describe(gray: torch.Tensor, shapes: torch.Tensor,
                        max_keypoints: int = 2048, num_scales: int = 12,
                        contrast_thresh: float = 0.004,
                        edge_thresh: float = 10.0,
                        sigma0: float = 0.8) -> Features:
    """The full classic frontend: (N, H, W) batch -> Features.

    sigma0=0.8 plays the role of OpenCV SIFT's doubled-resolution first
    octave (its sigma 1.6 lives on a 2x-upsampled image, i.e. 0.8 in
    native pixels).
    """
    xy, scale, score, mask, gauss, sigmas, s_idx = detect_keypoints(
        gray, shapes, max_keypoints, num_scales, contrast_thresh, edge_thresh,
        sigma0=sigma0)
    sigma_list = [sigma0 * (2.0 ** (i / 3.0)) for i in range(num_scales)]
    desc = compute_descriptors(gauss, xy, s_idx, sigmas, sigma_list)
    desc = desc * mask[..., None]
    return Features(xy=xy, scale=scale, score=score, desc=desc, mask=mask)
