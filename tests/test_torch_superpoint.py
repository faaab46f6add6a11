"""SuperPoint of the PyTorch port against the JAX package, on the CPU.

The same weights (the trained ``tests/data/superpoint_synth.npz``, or a
numpy random init handed to both packages) and the same frames go
through ``reconstructor_tpu.features.superpoint`` and
``reconstructor_tpu_torch.features.superpoint``.

Tolerances: both run in float32, and XLA's and torch's convolutions sum
their products in different orders, so the network outputs agree to
1e-4 of their scale (logits reach ~100, where a float32 ulp is 7.6e-6).
The decoded keypoint scores are softmax probabilities of those logits: a
logit error of ~5e-5 moves a probability by that fraction of itself, so
scores agree to 1e-4 relative (measured 5.4e-6 absolute on scores up to
~0.1), not to 1e-6 absolute. Slot order, masks and coordinates are
integers of the decode and must be equal; descriptors agree to 1e-4.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconstructor_tpu.eval import render
from reconstructor_tpu.features import superpoint as jsp
from reconstructor_tpu_torch.features import superpoint as tsp

from torch_parity import t

WEIGHTS = os.path.join(os.path.dirname(__file__), "data", "superpoint_synth.npz")


def numpy_init(seed):
    """He-initialised HWIO weights with small random biases, as numpy."""
    rng = np.random.default_rng(seed)
    params = {}
    shapes = ([(name, cin, cout, 3) for (cin, cout), name in zip(jsp._ENC, jsp._ENC_NAMES)]
              + [("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
                 ("convDa", 128, 256, 3), ("convDb", 256, 256, 1)])
    for name, cin, cout, k in shapes:
        w = rng.standard_normal((k, k, cin, cout)) * np.sqrt(2.0 / (cin * k * k))
        params[name] = {"w": w.astype(np.float32),
                        "b": (0.05 * rng.standard_normal(cout)).astype(np.float32)}
    return params


def both_nets(which):
    if which == "synth_npz":
        return jsp.params_from_npz(WEIGHTS), tsp.params_from_npz(WEIGHTS)
    p = numpy_init(3)
    return ({k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in p.items()},
            tsp.from_jax_params(p))


def assert_close_to_scale(got, want, rel=1e-4):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("which", ["synth_npz", "numpy_random"])
def test_forward_equals_jax(which):
    jp, net = both_nets(which)
    rng = np.random.default_rng(1)
    gray = rng.uniform(size=(2, 64, 96)).astype(np.float32)
    jl, jd = jsp.forward(jp, jnp.asarray(gray))
    with torch.no_grad():
        tl, td = tsp.forward(net, t(gray))
    assert tuple(tl.shape) == (2, 8, 12, 65) and tuple(td.shape) == (2, 8, 12, 256)
    assert_close_to_scale(tl.numpy(), np.asarray(jl))
    assert_close_to_scale(td.numpy(), np.asarray(jd))


def test_decode_heatmap_equals_jax():
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((2, 4, 5, 65))).astype(np.float32)
    want = np.asarray(jsp.decode_heatmap(jnp.asarray(logits)))
    got = tsp.decode_heatmap(t(logits)).numpy()
    assert got.shape == (2, 32, 40)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_detect_and_describe_equals_jax_on_rendered_views():
    jp, net = both_nets("synth_npz")
    scene = render.make_scene(seed=33, n_views=2, h=160, w=160)
    gray = np.asarray(scene["images"], np.float32)
    shapes = np.tile(np.array([160, 160], np.int32), (2, 1))
    jf = jsp.detect_and_describe(jp, jnp.asarray(gray), jnp.asarray(shapes), max_keypoints=256)
    tf = tsp.detect_and_describe(net, t(gray), t(shapes), max_keypoints=256)
    mask = np.asarray(jf.mask)
    assert mask.sum(1).min() > 50                       # the scene has keypoints
    np.testing.assert_array_equal(tf.mask.numpy(), mask)
    np.testing.assert_array_equal(tf.xy.numpy(), np.asarray(jf.xy))
    np.testing.assert_allclose(tf.score.numpy(), np.asarray(jf.score), rtol=1e-4, atol=0)
    np.testing.assert_allclose(tf.desc.numpy(), np.asarray(jf.desc), atol=1e-4)
    np.testing.assert_array_equal(tf.scale.numpy(), np.asarray(jf.scale))
    assert not tf.desc.numpy()[~mask].any()              # padded slots are zero


def test_weight_loaders_agree():
    """The magicleap state dict (OIHW) and the JAX pytree (HWIO) of the
    same weights give the same module; a seeded init is reproducible."""
    p = numpy_init(4)
    a = tsp.from_jax_params(p)
    sd = {f"{k}.weight": v["w"].transpose(3, 2, 0, 1) for k, v in p.items()}
    sd.update({f"{k}.bias": v["b"] for k, v in p.items()})
    b = tsp.params_from_torch_state_dict(sd)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    g1 = tsp.init_params(torch.Generator().manual_seed(5))
    g2 = tsp.init_params(torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(g1.parameters(), g2.parameters()))
