"""SuperPoint learned detector/descriptor in PyTorch.

Capability parity with the reference's ``FeatureSuperPoint``
(FeatureSuperPoint.{h,cpp}), in the design of ``reconstructor_tpu``'s
module of the same name: the magicleap VGG encoder (64/64/128/128), a
65-channel detector head and a 256-channel descriptor head, then a
fixed-shape batched decode — softmax over the 65 logits, dust-bin drop,
depth-to-space x8, confidence threshold 0.015, max-pool NMS of radius 4,
a border strip of 4, the global top-K, and bilinear descriptor sampling
at the keypoints with an L2 norm.

``SuperPointNet`` keeps torch's NCHW/OIHW layout inside and the magicleap
parameter names, so a ``superpoint_v1.pth`` state dict loads as it is;
``forward`` returns the JAX package's channels-last layout so that both
packages' public functions compare like with like. Weights come from a
seeded ``torch.Generator`` (``init_params``), the JAX package's npz files
(``params_from_npz``, float16 storage upcast to float32), a magicleap
state dict, or the JAX package's parameter pytree as numpy arrays
(``from_jax_params``). ``to_jax_params`` and ``save_npz`` go the other
way, to the pytree and to the npz layout that both packages'
``params_from_npz`` load (``scripts/train_frontend.py`` writes it).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from reconstructor_tpu_torch.features.sift import Features

# encoder channel plan (VGG-style, matching magicleap SuperPointNet)
_ENC = [(1, 64), (64, 64), (64, 64), (64, 64),
        (64, 128), (128, 128), (128, 128), (128, 128)]
_ENC_NAMES = ["conv1a", "conv1b", "conv2a", "conv2b",
              "conv3a", "conv3b", "conv4a", "conv4b"]
# pool after conv1b, conv2b, conv3b
_POOL_AFTER = {"conv1b", "conv2b", "conv3b"}
_HEADS = [("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
          ("convDa", 128, 256, 3), ("convDb", 256, 256, 1)]
_ALL_NAMES = _ENC_NAMES + [h[0] for h in _HEADS]


class SuperPointNet(nn.Module):
    """The SuperPoint network (magicleap module names, NCHW)."""

    def __init__(self):
        super().__init__()
        for (cin, cout), name in zip(_ENC, _ENC_NAMES):
            setattr(self, name, nn.Conv2d(cin, cout, 3, 1, 1))
        for name, cin, cout, k in _HEADS:
            setattr(self, name, nn.Conv2d(cin, cout, k, 1, k // 2))

    def forward(self, gray: torch.Tensor):
        """gray: (N, H, W) float32 in [0, 1], H and W multiples of 8.

        Returns (logits (N, H/8, W/8, 65), desc_raw (N, H/8, W/8, 256)),
        channels last like the JAX package.
        """
        x = gray[:, None]
        for name in _ENC_NAMES:
            x = F.relu(getattr(self, name)(x))
            if name in _POOL_AFTER:
                x = F.max_pool2d(x, 2, 2)
        logits = self.convPb(F.relu(self.convPa(x)))
        desc = self.convDb(F.relu(self.convDa(x)))
        return logits.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)


def forward(net: SuperPointNet, gray: torch.Tensor):
    """Network forward. gray: (N, H, W) float32 in [0, 1] (the reference's
    /255 prep, FeatureSuperPoint.cpp:265-288), H and W multiples of 8.

    Returns (logits (N, H/8, W/8, 65), desc_raw (N, H/8, W/8, 256)) in the
    JAX package's channels-last layout; differentiable.
    """
    return net(gray)


def init_params(generator: Optional[torch.Generator] = None) -> SuperPointNet:
    """He-initialised weights (normal * sqrt(2 / fan_in)), zero biases."""
    net = SuperPointNet()
    with torch.no_grad():
        for name in _ALL_NAMES:
            conv = getattr(net, name)
            fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator)
                              * np.sqrt(2.0 / fan_in))
            conv.bias.zero_()
    return net.eval().requires_grad_(False)


def from_jax_params(params: Mapping[str, Mapping[str, Any]]) -> SuperPointNet:
    """The JAX package's pytree ``{name: {"w": HWIO, "b": (O,)}}`` (numpy
    or anything ``np.asarray`` takes) -> the module."""
    net = SuperPointNet()
    with torch.no_grad():
        for name in _ALL_NAMES:
            w = np.asarray(params[name]["w"], np.float32).transpose(3, 2, 0, 1)  # HWIO->OIHW
            conv = getattr(net, name)
            conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
            conv.bias.copy_(torch.from_numpy(np.asarray(params[name]["b"], np.float32)))
    return net.eval().requires_grad_(False)


def to_jax_params(net: SuperPointNet) -> Dict[str, Dict[str, np.ndarray]]:
    """The module -> the JAX package's pytree ``{name: {"w": HWIO, "b":
    (O,)}}`` of float32 numpy arrays (the inverse of ``from_jax_params``)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name in _ALL_NAMES:
        conv = getattr(net, name)
        w = conv.weight.detach().cpu().numpy().transpose(2, 3, 1, 0)   # OIHW->HWIO
        out[name] = {"w": np.ascontiguousarray(w, np.float32),
                     "b": conv.bias.detach().cpu().numpy().astype(np.float32)}
    return out


def save_npz(net: SuperPointNet, path: str) -> None:
    """Write the weights as the flat ``name.key`` npz of float16 HWIO
    kernels and biases that the JAX package's training script writes
    (compressed); both packages' ``params_from_npz`` load it."""
    flat = {f"{name}.{k}": v.astype(np.float16)
            for name, layer in to_jax_params(net).items() for k, v in layer.items()}
    np.savez_compressed(path, **flat)


def params_from_npz(path: str) -> SuperPointNet:
    """Weights saved as a flat ``name.key`` npz of HWIO kernels (the JAX
    package's training-script format; float16 storage upcasts)."""
    data = np.load(path)
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for flat_key in data.files:
        name, k = flat_key.rsplit(".", 1)
        tree.setdefault(name, {})[k] = data[flat_key].astype(np.float32)
    return from_jax_params(tree)


def params_from_torch_state_dict(sd: Mapping[str, Any]) -> SuperPointNet:
    """A magicleap SuperPointNet state dict (OIHW tensors or arrays)."""
    net = SuperPointNet()
    net.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                         for k, v in sd.items()})
    return net.eval().requires_grad_(False)


def decode_heatmap(logits: torch.Tensor) -> torch.Tensor:
    """(N, Hc, Wc, 65) logits -> (N, Hc*8, Wc*8) keypoint probability:
    softmax over the 65 channels, dust bin dropped, depth-to-space."""
    prob = torch.softmax(logits, dim=-1)[..., :64]
    n, hc, wc, _ = prob.shape
    prob = prob.reshape(n, hc, wc, 8, 8).permute(0, 1, 3, 2, 4)
    return prob.reshape(n, hc * 8, wc * 8)


def _maxpool_nms(heat: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep only local maxima within a (2r+1)^2 window (the window pads
    with -inf, as ``reduce_window`` does)."""
    k = 2 * radius + 1
    mx = F.max_pool2d(heat[:, None], k, stride=1, padding=radius)[:, 0]
    return torch.where(heat >= mx, heat, 0.0)


def _bilinear_sample_map(desc_map: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample (N, Hc, Wc, C) descriptor maps at full-res keypoints xy
    (N, K, 2); cell centres sit at i*8 + 3.5. Returns L2-normalised
    (N, K, C)."""
    n, hc, wc, c = desc_map.shape
    gx = torch.clamp((xy[..., 0] - 3.5) / 8.0, 0.0, wc - 1.0)
    gy = torch.clamp((xy[..., 1] - 3.5) / 8.0, 0.0, hc - 1.0)
    x0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, wc - 2)
    y0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, hc - 2)
    fx = gx - x0
    fy = gy - y0
    ns = torch.arange(n, device=xy.device)[:, None]
    v00 = desc_map[ns, y0, x0]
    v01 = desc_map[ns, y0, x0 + 1]
    v10 = desc_map[ns, y0 + 1, x0]
    v11 = desc_map[ns, y0 + 1, x0 + 1]
    v = (v00 * ((1 - fy) * (1 - fx))[..., None] + v01 * ((1 - fy) * fx)[..., None]
         + v10 * (fy * (1 - fx))[..., None] + v11 * (fy * fx)[..., None])
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


@torch.no_grad()
def detect_and_describe(net: SuperPointNet, gray: torch.Tensor, shapes: torch.Tensor,
                        max_keypoints: int = 2048, conf_thresh: float = 0.015,
                        nms_radius: int = 4, border: int = 4) -> Features:
    """Full SuperPoint frontend -> fixed-capacity Features (batched).

    gray: (N, H, W) float32 in [0, 1]; shapes: (N, 2) valid (h, w).
    Slots are sorted by score, descending, with the lowest flat index
    first on ties (``lax.top_k``'s order), so valid keypoints are a
    prefix; padded slots have zero descriptors.
    """
    n, H, W = gray.shape
    logits, desc_raw = net(gray)
    heat = decode_heatmap(logits)                       # (N, H, W)
    heat = torch.where(heat >= conf_thresh, heat, 0.0)
    heat = _maxpool_nms(heat, nms_radius)

    dev = gray.device
    ys = torch.arange(H, device=dev)[None, :, None]
    xs = torch.arange(W, device=dev)[None, None, :]
    hh = shapes[:, 0].to(dev)[:, None, None]
    ww = shapes[:, 1].to(dev)[:, None, None]
    inb = (ys >= border) & (ys < hh - border) & (xs >= border) & (xs < ww - border)
    heat = torch.where(inb, heat, 0.0)

    # a stable descending sort keeps the lowest flat index first among
    # equal scores, as lax.top_k does
    flat = heat.reshape(n, -1)
    scores, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :max_keypoints], idx[:, :max_keypoints]
    yk = (idx // W).to(gray.dtype)
    xk = (idx % W).to(gray.dtype)
    mask = scores > 0.0
    xy = torch.stack([xk, yk], dim=-1)

    desc = _bilinear_sample_map(desc_raw, xy) * mask[..., None]
    return Features(xy=xy, scale=torch.full(scores.shape, 8.0, dtype=gray.dtype, device=dev),
                    score=scores, desc=desc, mask=mask)
