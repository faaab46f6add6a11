"""SuperGlue learned matcher (attentional GNN + Sinkhorn OT) in PyTorch.

Capability parity with the reference's ``FeatureMatcherSuperglue``
(FeatureMatcherSuperglue.{h,cpp}), in the design of ``reconstructor_tpu``'s
module of the same name: keypoints normalised to +-0.7 around the image
centre, a keypoint MLP encoder [3 -> 32 -> 64 -> 128 -> 256] added to the
256-d descriptors, alternating self-/cross-attention layers (4 heads x 64,
each with a [512 -> 512 -> 256] MLP), a final projection, scores / sqrt(D),
log-space Sinkhorn with a learned dust-bin score, then mutual argmax and
score > 0.5.

The JAX package ``vmap``s one pair over a chunk; here the chunk is an
explicit leading batch dimension. Rows are (keypoint, channel) as in the
JAX package (dense layers are ``x @ w + b``), heads are the *inner* stride
of the channel axis (the magicleap ``view(b, 64, 4, n)`` layout), masks use
-1e9, BatchNorm is in eval form, and attention is plain products and a
softmax, as the JAX package computes it. Depth is the number of layers in
the parameters. Module names follow the magicleap checkpoint
(``kenc.encoder.*``, ``gnn.layers.i.attn.proj.*``, ``final_proj``,
``bin_score``), so its state dict converts by squeezing the Conv1d kernels.

Matching runs its Sinkhorn through ``matching.cuda_sinkhorn.log_sinkhorn_fused``:
the hand-written kernel for tensors on the card, the plain loop for
tensors on the CPU. ``log_sinkhorn`` is the plain, differentiable loop on
any device, which training differentiates (the kernel has no backward,
as the Pallas one has no VJP). ``to_jax_params`` and ``params_to_npz`` write
the JAX package's pytree and its flat ``kenc.0.dense.w``-style npz.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from reconstructor_tpu_torch.matching import cuda_sinkhorn

D_MODEL = 256
N_HEADS = 4
N_LAYERS = 18  # alternating self, cross
KENC_CHANNELS = [3, 32, 64, 128, 256, D_MODEL]
MLP_CHANNELS = [2 * D_MODEL, 2 * D_MODEL, D_MODEL]


# ----------------------------------------------------------------------
# modules
# ----------------------------------------------------------------------

class EvalBatchNorm(nn.Module):
    """BatchNorm in eval form, ``(x - mean) * rsqrt(var + eps) * w + b``
    over the last axis, written out as the JAX package computes it."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return ((x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
                * self.weight + self.bias)


def _mlp(channels: List[int]) -> nn.Sequential:
    """Dense, BN, ReLU, ... , Dense at the magicleap Sequential's indices
    (0, 3, 6, ... dense; 1, 4, ... BN)."""
    layers: List[nn.Module] = []
    for i in range(1, len(channels)):
        layers.append(nn.Linear(channels[i - 1], channels[i]))
        if i < len(channels) - 1:
            layers += [EvalBatchNorm(channels[i]), nn.ReLU()]
    return nn.Sequential(*layers)


class KeypointEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = _mlp(KENC_CHANNELS)

    def forward(self, xyn, score):
        return self.encoder(torch.cat([xyn, score[..., None]], dim=-1))


class Attention(nn.Module):
    """Multi-head attention of x over source, heads inner in the channels."""

    def __init__(self):
        super().__init__()
        self.proj = nn.ModuleList([nn.Linear(D_MODEL, D_MODEL) for _ in range(3)])
        self.merge = nn.Linear(D_MODEL, D_MODEL)

    def forward(self, x, source, source_mask):
        B, M, _ = x.shape
        hd = D_MODEL // N_HEADS
        q = self.proj[0](x).reshape(B, M, hd, N_HEADS)
        k = self.proj[1](source).reshape(B, -1, hd, N_HEADS)
        v = self.proj[2](source).reshape(B, -1, hd, N_HEADS)
        scores = torch.einsum("bmdh,bndh->bhmn", q, k) / np.sqrt(hd)
        scores = torch.where(source_mask[:, None, None, :], scores, -1e9)
        attn = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhmn,bndh->bmdh", attn, v).reshape(B, M, D_MODEL)
        return self.merge(out)


class AttentionalPropagation(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = Attention()
        self.mlp = _mlp(MLP_CHANNELS)

    def forward(self, x, source, source_mask):
        message = self.attn(x, source, source_mask)
        return self.mlp(torch.cat([x, message], dim=-1))


class AttentionalGNN(nn.Module):
    def __init__(self, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList([AttentionalPropagation() for _ in range(n_layers)])

    def forward(self, x0, x1, mask0, mask1):
        for i, layer in enumerate(self.layers):
            if i % 2 == 0:   # self-attention
                s0, sm0, s1, sm1 = x0, mask0, x1, mask1
            else:            # cross-attention
                s0, sm0, s1, sm1 = x1, mask1, x0, mask0
            m0 = layer(x0, s0, sm0)
            m1 = layer(x1, s1, sm1)
            x0, x1 = x0 + m0, x1 + m1
        return x0, x1


class SuperGlue(nn.Module):
    """The SuperGlue network; ``n_layers`` alternating self/cross layers."""

    def __init__(self, n_layers: int = N_LAYERS):
        super().__init__()
        self.kenc = KeypointEncoder()
        self.gnn = AttentionalGNN(n_layers)
        self.final_proj = nn.Linear(D_MODEL, D_MODEL)
        self.bin_score = nn.Parameter(torch.tensor(1.0))

    def forward(self, desc0, desc1, xy0n, xy1n, score0, score1, mask0, mask1):
        """Batched GNN: desc (B, M, D), xyn (B, M, 2), score/mask (B, M).
        Returns the matching descriptors after the final projection."""
        x0 = desc0 + self.kenc(xy0n, score0)
        x1 = desc1 + self.kenc(xy1n, score1)
        x0, x1 = self.gnn(x0, x1, mask0, mask1)
        return self.final_proj(x0), self.final_proj(x1)


# ----------------------------------------------------------------------
# weights
# ----------------------------------------------------------------------

def init_params(generator: Optional[torch.Generator] = None,
                n_layers: int = N_LAYERS) -> SuperGlue:
    """Dense weights normal * sqrt(1 / fan_in), zero biases, identity
    BN, dust-bin score 1. ``n_layers`` < 18 builds a smaller GNN of the
    same layer structure."""
    net = SuperGlue(n_layers)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * np.sqrt(1.0 / m.in_features))
                m.bias.zero_()
    return net.eval().requires_grad_(False)


def structured_identity_params(gamma: float = 24.0, bin_score: float = 5.0,
                               generator: Optional[torch.Generator] = None,
                               n_layers: int = N_LAYERS) -> SuperGlue:
    """Structured weights that make SuperGlue a pure Sinkhorn matcher.

    The GNN layers are residual, so zeroing every MLP's last dense (and
    the keypoint encoder's) makes the 18-layer GNN an exact identity on
    the descriptors whatever the other weights are; the final projection
    is ``gamma * I``, so the transport scores are ``gamma^2 <d_i, d_j> /
    sqrt(D)``, and the full dust-bin Sinkhorn + mutual-argmax + score > 0.5
    decode runs unchanged. The other weights are drawn from ``generator``
    (the JAX package draws them from its own key; the output does not
    depend on them). The config value ``superglue_weights="structured"``;
    with fewer ``n_layers``, the trainer's starting point
    (``scripts/train_superglue.small_identity_params``).
    """
    net = init_params(generator, n_layers)
    with torch.no_grad():
        last = [net.kenc.encoder[-1]] + [layer.mlp[-1] for layer in net.gnn.layers]
        for dense in last:
            dense.weight.zero_()
            dense.bias.zero_()
        net.final_proj.weight.copy_(gamma * torch.eye(D_MODEL))
        net.final_proj.bias.zero_()
        net.bin_score.fill_(bin_score)
    return net


def _load(n_layers: int, sd: Dict[str, np.ndarray]) -> SuperGlue:
    net = SuperGlue(n_layers)
    net.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).reshape(
        net.state_dict()[k].shape) for k, v in sd.items()})
    return net.eval().requires_grad_(False)


def from_jax_params(params: Mapping[str, Any]) -> SuperGlue:
    """The JAX package's pytree (dense ``w`` as (in, out), BN
    ``scale/bias/mean/var``, scalar ``bin_score``; numpy or anything
    ``np.asarray`` takes) -> the module."""
    sd: Dict[str, np.ndarray] = {}

    def dense(prefix, p):
        sd[f"{prefix}.weight"] = np.asarray(p["w"], np.float32).T
        sd[f"{prefix}.bias"] = np.asarray(p["b"], np.float32)

    def mlp(prefix, layers):
        for i, layer in enumerate(layers):
            dense(f"{prefix}.{3 * i}", layer["dense"])
            if "bn" in layer:
                bn = layer["bn"]
                for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                                     ("running_mean", "mean"), ("running_var", "var")):
                    sd[f"{prefix}.{3 * i + 1}.{ours}"] = np.asarray(bn[theirs], np.float32)

    mlp("kenc.encoder", params["kenc"])
    for i, layer in enumerate(params["layers"]):
        p = f"gnn.layers.{i}"
        for j, name in enumerate(("q", "k", "v")):
            dense(f"{p}.attn.proj.{j}", layer[name])
        dense(f"{p}.attn.merge", layer["merge"])
        mlp(f"{p}.mlp", layer["mlp"])
    dense("final_proj", params["final_proj"])
    sd["bin_score"] = np.asarray(params["bin_score"], np.float32)
    return _load(len(params["layers"]), sd)


def to_jax_params(net: SuperGlue) -> Dict[str, Any]:
    """The module -> the JAX package's pytree of numpy arrays in the
    module's dtype (the inverse of ``from_jax_params``): dense ``w`` as
    (in, out), BN ``scale/bias/mean/var``, a scalar ``bin_score``."""
    sd = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}

    def dense(prefix):
        return {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].T), "b": sd[f"{prefix}.bias"]}

    def mlp(prefix, channels):
        layers = []
        for i in range(len(channels) - 1):
            layer = {"dense": dense(f"{prefix}.{3 * i}")}
            if i < len(channels) - 2:
                layer["bn"] = {theirs: sd[f"{prefix}.{3 * i + 1}.{ours}"]
                               for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                                                    ("running_mean", "mean"),
                                                    ("running_var", "var"))}
            layers.append(layer)
        return layers

    params: Dict[str, Any] = {"kenc": mlp("kenc.encoder", KENC_CHANNELS),
                              "final_proj": dense("final_proj"),
                              "bin_score": sd["bin_score"].reshape(()), "layers": []}
    for i in range(len(net.gnn.layers)):
        p = f"gnn.layers.{i}"
        params["layers"].append({
            "q": dense(f"{p}.attn.proj.0"), "k": dense(f"{p}.attn.proj.1"),
            "v": dense(f"{p}.attn.proj.2"), "merge": dense(f"{p}.attn.merge"),
            "mlp": mlp(f"{p}.mlp", MLP_CHANNELS)})
    return params


def params_to_npz(net: SuperGlue, path: str) -> None:
    """Write the weights as the JAX package's ``params_to_npz`` does: the
    pytree flattened to ``kenc.0.dense.w``-style keys (dict keys, then
    list indices), float32, compressed; both packages' ``params_from_npz``
    load it."""
    flat: Dict[str, np.ndarray] = {}

    def walk(obj, prefix):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(v, f"{prefix}{i}.")
        else:
            flat[prefix[:-1]] = np.asarray(obj)

    walk(to_jax_params(net), "")
    np.savez_compressed(path, **flat)


def params_from_npz(path: str) -> SuperGlue:
    """Weights saved by the JAX package's ``params_to_npz`` (flat
    ``kenc.0.dense.w``-style keys), e.g. tests/data/superglue_fountain.npz."""
    d = np.load(path)
    root: Dict[str, Any] = {}
    for key in d.files:
        parts = key.split(".")
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = d[key]

    def listify(obj):
        if isinstance(obj, dict):
            if obj and all(k.isdigit() for k in obj):
                return [listify(obj[str(i)]) for i in range(len(obj))]
            return {k: listify(v) for k, v in obj.items()}
        return obj

    return from_jax_params(listify(root))


def params_from_torch_state_dict(sd: Mapping[str, Any]) -> SuperGlue:
    """A magicleap SuperGlue state dict (Conv1d (out, in, 1) kernels)."""
    arrays = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    n_layers = len({k.split(".")[2] for k in arrays if k.startswith("gnn.layers.")})
    return _load(n_layers, arrays)


# ----------------------------------------------------------------------
# matching
# ----------------------------------------------------------------------

def normalize_keypoints(xy: torch.Tensor, height, width,
                        normalization: float = 0.7) -> torch.Tensor:
    """(p - centre) / (max(h, w) * 0.7) with an integer-floored centre
    (utils.cpp:119-150). xy (..., K, 2); height/width broadcast to xy's
    leading dims."""
    height = torch.as_tensor(height, device=xy.device)
    width = torch.as_tensor(width, device=xy.device)
    cx = torch.floor_divide(width, 2).to(xy.dtype)
    cy = torch.floor_divide(height, 2).to(xy.dtype)
    scale = torch.maximum(height, width).to(xy.dtype) * normalization
    return (xy - torch.stack([cx, cy], dim=-1)[..., None, :]) / scale[..., None, None]


def pair_scores(net: SuperGlue, desc, xy, score, kmask, shapes, pair_idx):
    """The GNN's (B, K, K) transport scores for a chunk of pairs, with
    the pairs' keypoint masks. desc (N, K, D), xy (N, K, 2), score/kmask
    (N, K), shapes (N, 2), pair_idx (B, 2)."""
    i, j = pair_idx[:, 0].long(), pair_idx[:, 1].long()
    xy0n = normalize_keypoints(xy[i], shapes[i, 0], shapes[i, 1])
    xy1n = normalize_keypoints(xy[j], shapes[j, 0], shapes[j, 1])
    f0, f1 = net(desc[i], desc[j], xy0n, xy1n, score[i], score[j], kmask[i], kmask[j])
    return torch.einsum("bmd,bnd->bmn", f0, f1) / (D_MODEL ** 0.5), kmask[i], kmask[j]


def gnn_forward(net: SuperGlue, desc0, desc1, xy0n, xy1n, score0, score1, mask0, mask1):
    """The attentional GNN on one pair, unbatched as in the JAX package:
    desc (M, D), xyn (M, 2), score/mask (M,); or on a batch of pairs, each
    with a leading (B,). Returns the matching descriptors (M, D), (N, D)
    (or (B, M, D), (B, N, D)) after the final projection; differentiable."""
    if desc0.dim() == 3:
        return net(desc0, desc1, xy0n, xy1n, score0, score1, mask0, mask1)
    f0, f1 = net(desc0[None], desc1[None], xy0n[None], xy1n[None], score0[None], score1[None],
                 mask0[None], mask1[None])
    return f0[0], f1[0]


def log_sinkhorn(scores: torch.Tensor, alpha: torch.Tensor, mask0: torch.Tensor,
                 mask1: torch.Tensor, num_iters: int) -> torch.Tensor:
    """Differentiable optimal transport with dust bins (SuperGlue §3.2),
    the plain loop on any device: scores (M, N) or (B, M, N) -> the
    (M+1, N+1) (or (B, M+1, N+1)) log-coupling. Masked slots are driven to
    -1e9 so they couple only with the bins. This is the function training
    differentiates; matching takes the kernel (``log_sinkhorn_fused``)."""
    single = scores.dim() == 2
    if single:
        scores, mask0, mask1 = scores[None], mask0[None], mask1[None]
    couplings, log_mu, log_nu, norm = cuda_sinkhorn.augment(scores, alpha, mask0, mask1)
    Z = cuda_sinkhorn.sinkhorn_plain(couplings, log_mu, log_nu, num_iters) - norm[:, None, None]
    return Z[0] if single else Z


def decode(Z: torch.Tensor, mask0: torch.Tensor, score_thresh: float):
    """Mutual argmax on exp(Z) without the bins (first maximum on ties)
    and score > thresh. Returns (match_idx (B, M) int32 or -1,
    match_mask (B, M), match_scores (B, M))."""
    P = torch.exp(Z[:, :-1, :-1])
    idx0 = torch.argmax(P, dim=2)
    idx1 = torch.argmax(P, dim=1)
    rows = torch.arange(P.shape[1], device=P.device)
    mutual = torch.gather(idx1, 1, idx0) == rows
    mscores = torch.gather(P, 2, idx0[..., None])[..., 0]
    ok = mutual & (mscores > score_thresh) & mask0
    return torch.where(ok, idx0, -1).to(torch.int32), ok, mscores


@torch.no_grad()
def match_pairs_batched(net: SuperGlue, desc, xy, score, kmask, shapes, pair_idx,
                        sinkhorn_iters: int = 100, score_thresh: float = 0.5):
    """SuperGlue on a chunk of pairs: GNN, scores, Sinkhorn (the CUDA
    kernel for tensors on the card, the plain loop on the CPU), decode.

    desc (N, K, D), xy (N, K, 2), score (N, K), kmask (N, K), shapes
    (N, 2), pair_idx (B, 2). Returns (match_idx (B, K), match_mask (B, K),
    match_scores (B, K)), the keep-if-score > 0.5 contract of
    FeatureMatcherSuperglue.cpp:76-87.
    """
    scores, mask0, mask1 = pair_scores(net, desc, xy, score, kmask, shapes, pair_idx)
    Z = cuda_sinkhorn.log_sinkhorn_fused(scores, net.bin_score, mask0, mask1, sinkhorn_iters)
    return decode(Z, mask0, score_thresh)


def match_pair(net: SuperGlue, desc0, desc1, xy0, xy1, score0, score1, mask0, mask1,
               shape0, shape1, sinkhorn_iters: int = 100, score_thresh: float = 0.5):
    """One image pair: the per-image arrays of ``match_pairs_batched``
    with ``shape0``/``shape1`` as (h, w). Returns (match_idx (M,),
    match_mask (M,), match_scores (M,))."""
    stack = lambda a, b: torch.stack([torch.as_tensor(a), torch.as_tensor(b)])  # noqa: E731
    pair = torch.tensor([[0, 1]], device=desc0.device)
    out = match_pairs_batched(net, stack(desc0, desc1), stack(xy0, xy1),
                              stack(score0, score1), stack(mask0, mask1),
                              stack(shape0, shape1).to(desc0.device), pair,
                              sinkhorn_iters, score_thresh)
    return tuple(o[0] for o in out)
