"""SuperGlue of the PyTorch port against the JAX package, on the CPU.

The same weights (a numpy random init at full width and depth, the
trained 4-layer ``tests/data/superglue_fountain.npz``, or the structured
identity weights) and the same keypoints go through
``reconstructor_tpu.matching.superglue`` and
``reconstructor_tpu_torch.matching.superglue``. The Sinkhorn kernel's
module (``matching/cuda_sinkhorn.py``, which runs its plain version for
CPU tensors) is held against the Pallas kernel in interpret mode, as
``tests/test_pallas_kernels.py`` runs it; the kernel itself runs only on
a card (``tests/test_torch_cuda.py``).

Tolerances: everything is float32. The GNN's products are summed in
another order by XLA and by torch, and 18 residual layers carry those
roundings through, so its outputs agree to 1e-4 of their scale (measured
3e-6). The log-coupling agrees to 1e-4 absolute (the TPU package's own
bound between its kernel and its XLA loop). Match indices are equal
index for index.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconstructor_tpu.matching import pallas_sinkhorn
from reconstructor_tpu.matching import superglue as jsg
from reconstructor_tpu_torch.matching import cuda_sinkhorn
from reconstructor_tpu_torch.matching import superglue as tsg
from reconstructor_tpu_torch.utils import cuda_build

from torch_parity import t

FOUNTAIN = os.path.join(os.path.dirname(__file__), "data", "superglue_fountain.npz")


def numpy_init(seed, n_layers=18):
    """A SuperGlue pytree as numpy: dense (in, out) weights, random
    biases and BN statistics, so every term of the forward pass counts."""
    rng = np.random.default_rng(seed)

    def dense(cin, cout):
        return {"w": (rng.standard_normal((cin, cout)) * np.sqrt(1.0 / cin)).astype(np.float32),
                "b": (0.1 * rng.standard_normal(cout)).astype(np.float32)}

    def bn(c):
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
                "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}

    def mlp(ch):
        out = []
        for i in range(1, len(ch)):
            layer = {"dense": dense(ch[i - 1], ch[i])}
            if i < len(ch) - 1:
                layer["bn"] = bn(ch[i])
            out.append(layer)
        return out

    return {"kenc": mlp(jsg.KENC_CHANNELS), "final_proj": dense(256, 256),
            "bin_score": np.float32(1.0),
            "layers": [{"q": dense(256, 256), "k": dense(256, 256), "v": dense(256, 256),
                        "merge": dense(256, 256), "mlp": mlp(jsg.MLP_CHANNELS)}
                       for _ in range(n_layers)]}


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair_inputs(seed, K=64, valid=(64, 50)):
    """Two images whose descriptors share most of their scene points
    (unit-norm, noisy) with ragged validity, as numpy."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((K + 16, 256))
    desc = np.zeros((2, K, 256), np.float32)
    mask = np.zeros((2, K), bool)
    for n, count in enumerate(valid):
        d = base[rng.choice(K + 16, count, replace=False)] + 0.3 * rng.standard_normal((count, 256))
        desc[n, :count] = d / np.linalg.norm(d, axis=1, keepdims=True)
        mask[n, :count] = True
    xy = rng.uniform(0, 160, (2, K, 2)).astype(np.float32)
    score = rng.uniform(0, 1, (2, K)).astype(np.float32) * mask
    return desc, xy, score, mask


def gnn_both(jparams, net, seed=0):
    desc, xy, score, mask = pair_inputs(seed)
    xyn = np.stack([np.asarray(jsg.normalize_keypoints(jnp.asarray(xy[i]), 160, 160))
                    for i in range(2)])
    want = jsg.gnn_forward(jparams, *(jnp.asarray(a) for a in
                                      (desc[0], desc[1], xyn[0], xyn[1], score[0], score[1],
                                       mask[0], mask[1])))
    with torch.no_grad():
        txyn = tsg.normalize_keypoints(t(xy), t([160, 160]), t([160, 160]))
        np.testing.assert_array_equal(txyn.numpy(), xyn)
        args = [t(a) for a in (desc[0], desc[1], xyn[0], xyn[1], score[0], score[1],
                               mask[0], mask[1])]
        got = tsg.gnn_forward(net, *args)
        batched = tsg.gnn_forward(net, *(a[None] for a in args))
    for g, b in zip(got, batched):
        assert torch.equal(g, b[0])
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def assert_close_to_scale(got, want, rel=1e-4):
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


def test_gnn_full_width_and_depth_equals_jax():
    p = numpy_init(0)
    net = tsg.from_jax_params(p)
    assert len(net.gnn.layers) == 18
    want, got = gnn_both(to_jax(p), net)
    for g, w in zip(got, want):
        assert w.shape == (64, 256)
        assert_close_to_scale(g, w)


def test_compact_fountain_gnn_equals_jax():
    jp = jsg.params_from_npz(FOUNTAIN)
    net = tsg.params_from_npz(FOUNTAIN)
    assert len(net.gnn.layers) == len(jp["layers"]) == 4
    assert float(net.bin_score) == float(jp["bin_score"])
    want, got = gnn_both(jp, net, seed=1)
    for g, w in zip(got, want):
        assert_close_to_scale(g, w)


def test_structured_weights_do_not_depend_on_the_draws():
    """The zeroed last layers make the GNN an identity whatever the other
    weights are: the port's two draws and the JAX package's own draw give
    the same output (gamma times the descriptors)."""
    jp = jsg.structured_identity_params()
    a = tsg.structured_identity_params(generator=torch.Generator().manual_seed(1))
    b = tsg.structured_identity_params(generator=torch.Generator().manual_seed(2))
    assert not torch.equal(a.gnn.layers[0].attn.proj[0].weight, b.gnn.layers[0].attn.proj[0].weight)
    want, got_a = gnn_both(jp, a)
    _, got_b = gnn_both(jp, b)
    desc = pair_inputs(0)[0]
    for ga, gb, w, d in zip(got_a, got_b, want, desc):
        np.testing.assert_array_equal(ga, gb)
        assert_close_to_scale(ga, w)
        np.testing.assert_allclose(ga, 24.0 * d, rtol=1e-6, atol=1e-6)


def test_torch_state_dict_converter_equals_jax_pytree():
    """The magicleap layout (Conv1d (out, in, 1) kernels, kenc.encoder.*,
    gnn.layers.i.attn.proj.*) converts to the same module as the JAX
    pytree of the same weights."""
    p = numpy_init(5, n_layers=2)
    ref = tsg.from_jax_params(p)
    sd = {k: (v.numpy()[:, :, None] if v.dim() == 2 else v.numpy())
          for k, v in ref.state_dict().items()}
    conv = tsg.params_from_torch_state_dict(sd)
    for (ka, va), (kb, vb) in zip(ref.state_dict().items(), conv.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka


def ragged_scores(seed, B=3, M=48, N=40):
    rng = np.random.default_rng(seed)
    scores = (2 * rng.standard_normal((B, M, N))).astype(np.float32)
    m0 = np.zeros((B, M), bool)
    m1 = np.zeros((B, N), bool)
    m0[0, :44], m1[0, :36] = True, True
    m0[1, :1], m1[1, :N] = True, True         # a single valid slot in image 0
    m1[2, :20] = True                          # image 0 fully masked
    return scores, m0, m1


@pytest.mark.parametrize("iters", [20, 60])
def test_log_sinkhorn_equals_jax_and_pallas_interpret(iters):
    scores, m0, m1 = ragged_scores(iters)
    alpha = np.float32(0.7)
    # CPU tensors: the wrapper runs the plain loop
    got_plain = cuda_sinkhorn.log_sinkhorn_fused(t(scores), t(alpha), t(m0), t(m1), iters).numpy()
    for b in range(scores.shape[0]):
        args = (jnp.asarray(scores[b]), jnp.asarray(alpha), jnp.asarray(m0[b]), jnp.asarray(m1[b]))
        ref = np.asarray(jsg.log_sinkhorn(*args, iters))
        pal = np.asarray(pallas_sinkhorn.log_sinkhorn_fused(*args, iters, interpret=True))
        np.testing.assert_allclose(got_plain[b], ref, atol=1e-4, rtol=0)
        np.testing.assert_allclose(got_plain[b], pal, atol=1e-4, rtol=0)


def test_sinkhorn_wrapper_dispatches_by_device():
    """A CPU tensor takes the plain version (not counted as a launch); an
    unknown device is refused."""
    scores, m0, m1 = ragged_scores(3)
    C, mu, nu, _ = cuda_sinkhorn.augment(t(scores), t(np.float32(0.7)), t(m0), t(m1))
    before = cuda_build.launches()
    out = cuda_sinkhorn.sinkhorn_kernel(C, mu, nu, 10)
    assert cuda_build.launches() == before
    assert torch.equal(out, cuda_sinkhorn.sinkhorn_plain(C, mu, nu, 10))
    with pytest.raises(ValueError):
        cuda_sinkhorn.sinkhorn_kernel(C.to("meta"), mu.to("meta"), nu.to("meta"), 10)
    assert cuda_sinkhorn.supported(8, 4097, 4097)


def batched_inputs(seed, N=4, K=64):
    """N images of one scene: each sees a random subset of shared points."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((2 * K, 256))
    desc = np.zeros((N, K, 256), np.float32)
    mask = np.zeros((N, K), bool)
    for n in range(N):
        count = int(rng.integers(K // 2, K + 1))
        d = base[rng.choice(2 * K, count, replace=False)] + 0.4 * rng.standard_normal((count, 256))
        desc[n, :count] = d / np.linalg.norm(d, axis=1, keepdims=True)
        mask[n, :count] = True
    xy = rng.uniform(0, 120, (N, K, 2)).astype(np.float32)
    score = (rng.uniform(0, 1, (N, K)) * mask).astype(np.float32)
    shapes = np.array([[120, 160]] * N, np.int32)
    pairs = np.array([[0, 1], [0, 2], [1, 3], [2, 3], [3, 0]], np.int32)
    return desc, xy, score, mask, shapes, pairs


@pytest.mark.parametrize("weights,thresh", [("structured", 0.5), ("structured", 0.0),
                                            ("fountain", 0.5)])
def test_match_pairs_batched_equals_jax(weights, thresh):
    if weights == "structured":
        jp, net = jsg.structured_identity_params(), tsg.structured_identity_params()
    else:
        jp, net = jsg.params_from_npz(FOUNTAIN), tsg.params_from_npz(FOUNTAIN)
    arrays = batched_inputs(7)
    ji, jm, js = jsg.match_pairs_batched(jp, *(jnp.asarray(a) for a in arrays),
                                         sinkhorn_iters=50, score_thresh=thresh)
    ti, tm, ts = tsg.match_pairs_batched(net, *(t(a) for a in arrays),
                                         sinkhorn_iters=50, score_thresh=thresh)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    assert tm.numpy().sum() > 20                     # the pairs do match
    # one pair at a time gives the same rows as the batch
    desc, xy, score, mask, shapes, pairs = arrays
    i, j = pairs[1]
    si, sm, _ = tsg.match_pair(net, t(desc[i]), t(desc[j]), t(xy[i]), t(xy[j]), t(score[i]),
                               t(score[j]), t(mask[i]), t(mask[j]), t(shapes[i]), t(shapes[j]),
                               sinkhorn_iters=50, score_thresh=thresh)
    np.testing.assert_array_equal(si.numpy(), ti.numpy()[1])
    np.testing.assert_array_equal(sm.numpy(), tm.numpy()[1])
