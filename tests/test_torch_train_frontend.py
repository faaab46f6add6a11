"""SuperPoint training in the port (``scripts/train_frontend.py`` on torch
autograd and ``torch.optim``) against the JAX package on the CPU.

- The loss of the JAX script (``scripts/train_frontend.py:140-175``),
  written here from the JAX package's own ``sp.forward`` and
  ``_bilinear_sample_map`` with the random draws (gain, bias, noise, pair
  indices) given as arrays, and its gradient, against the port's
  ``batch_loss`` on the same draws, from the JAX package's
  ``init_params(PRNGKey(1))`` carried across with ``from_jax_params``:
  2 scenes x 3 views at 96 px (at 64 px most rendered views share fewer
  than 8 blobs, and the JAX script's pair tables come out empty). In
  float64 (both packages) the loss agrees within 1e-12 relative and every
  parameter's gradient within 1e-9 of that tensor's largest magnitude. In
  float32, as the trainer runs, the loss agrees within 1e-5 relative, and
  the gradients within 1e-4 of each tensor's largest magnitude from the
  last pooling up (conv4 and both heads); below it within 3e-3: the two
  packages' convolutions differ by ~1e-7 relative, which is enough to
  flip the winner of a 2x2 max-pool window whose two best values are that
  close, and the flipped window sends its gradient to the neighbour
  (measured 1e-4 to 2e-3 at the encoder's layers, by the draws; in
  float64 the flips vanish and so does the gap).
- The learning-rate schedule equals optax's at every step of a 50-step
  run, and three optimizer updates fed the same gradients (clipped on
  some steps, not on others) move the parameters as optax does, within
  1e-4 of each tensor's largest move (plus one float32 rounding of the
  weight): optax takes Adam's bias corrections in float32 (1 - 0.999
  carries 1.3e-5 of relative error), torch in float64.
- ``save_npz`` -> both packages' ``params_from_npz`` give the same
  tensors.
- The script runs 3 steps on the CPU with a temporary ``--out``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from reconstructor_tpu.features import superpoint as jsp
from reconstructor_tpu_torch.features import superpoint as tsp
from reconstructor_tpu_torch.scripts import train_frontend as tf

from torch_parity import time_limit  # (also: two torch threads per worker)

SIZE = 96


@pytest.fixture(scope="module")
def dataset():
    """2 scenes x 3 views at 96 px: images, labels, projections, pair
    tables (numpy)."""
    return tf.make_dataset(2, 3, SIZE, SIZE, tf.LM_BUDGET, seed=0)


def jax_loss(params, imgs, labels, uv, pair_ij, pair_lm, gain, bias, noise, qidx):
    """The JAX script's ``loss_fn`` with its draws given as arrays."""
    def scene_loss(s):
        gray = jnp.clip(imgs[s] * gain[s] + bias[s] + noise[s], 0.0, 1.0)
        logits, desc_raw = jsp.forward(params, gray)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, labels[s][..., None], axis=-1)[..., 0]
        is_kp = labels[s] != 64
        det = (jnp.sum(nll * is_kp) / jnp.maximum(jnp.sum(is_kp), 1)
               + 0.3 * jnp.sum(nll * ~is_kp) / jnp.maximum(jnp.sum(~is_kp), 1))
        all_desc = jax.vmap(lambda i: jsp._bilinear_sample_map(desc_raw[i], uv[s, i]))(
            jnp.arange(gray.shape[0]))

        def pair_loss(q):
            ij, lm = pair_ij[s, q], pair_lm[s, q]
            sim = tf.TAU * (all_desc[ij[0], lm] @ all_desc[ij[1], lm].T)
            lbl = jnp.arange(sim.shape[0])
            return 0.5 * jnp.mean(
                optax.softmax_cross_entropy_with_integer_labels(sim, lbl)
                + optax.softmax_cross_entropy_with_integer_labels(sim.T, lbl))
        return det + jnp.mean(jax.vmap(pair_loss)(qidx[s]))
    return jnp.mean(jnp.stack([scene_loss(s) for s in range(imgs.shape[0])]))


def torch_grads_as_jax(net):
    """The port's gradients in the JAX pytree's layout (HWIO)."""
    return {name: {"w": getattr(net, name).weight.grad.numpy().transpose(2, 3, 1, 0),
                   "b": getattr(net, name).bias.grad.numpy()} for name in tsp._ALL_NAMES}


def draws_and_grads(dataset, dtype):
    """The JAX loss and gradient, and the port's, on seeded draws, both
    in ``dtype``."""
    imgs, labels, uv, ij, lm = dataset
    S, V = imgs.shape[:2]
    rng = np.random.default_rng(5)
    gain = 1.0 + 0.25 * rng.standard_normal((S, V, 1, 1))
    bias = 0.1 * rng.standard_normal((S, V, 1, 1))
    noise = 0.02 * rng.standard_normal((S, V, SIZE, SIZE))
    qidx = rng.integers(0, ij.shape[1], (S, tf.N_PAIR_SAMPLE))
    fl = lambda a: np.asarray(a, dtype)  # noqa: E731
    floats = (imgs, uv, gain, bias, noise)
    imgs, uv, gain, bias, noise = (fl(a) for a in floats)

    params = jsp.init_params(jax.random.PRNGKey(1))
    with jax.enable_x64(dtype == np.float64):
        pj = jax.tree.map(lambda a: jnp.asarray(fl(a)), params)
        lj, gj = jax.jit(jax.value_and_grad(jax_loss))(
            pj, *(jnp.asarray(a) for a in (imgs, labels, uv, ij, lm, gain, bias, noise, qidx)))
        lj, gj = float(lj), jax.tree.map(np.asarray, gj)

    net = tsp.from_jax_params(jax.tree.map(np.asarray, params)).to(torch.from_numpy(fl(0)).dtype)
    net.train().requires_grad_(True)
    t = torch.from_numpy
    data = tf.Batch(t(imgs), t(labels).long(), t(uv), t(ij).long(), t(lm).long())
    draws = {"gain": t(gain), "bias": t(bias), "noise": t(noise), "qidx": t(qidx)}
    lt, det, desc = tf.batch_loss(net, data, list(range(S)), draws)
    lt.backward()
    assert torch.isfinite(det) and torch.isfinite(desc)
    return lj, gj, float(lt), torch_grads_as_jax(net)


@time_limit(60)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_loss_and_gradients_match_jax(dataset, dtype):
    lj, gj, lt, gt = draws_and_grads(dataset, dtype)
    np.testing.assert_allclose(lt, lj, rtol=1e-5 if dtype == np.float32 else 1e-12)
    for name in tsp._ALL_NAMES:
        if dtype == np.float64:
            tol = 1e-9
        else:
            tol = 1e-4 if name.startswith(("conv4", "convP", "convD")) else 3e-3
        for k in ("w", "b"):
            a, b = gj[name][k], gt[name][k]
            assert a.shape == b.shape and a.dtype == b.dtype == dtype, (name, k)
            scale = np.abs(a).max()
            assert scale > 0, (name, k)
            assert np.abs(a - b).max() <= tol * scale, (name, k, np.abs(a - b).max(), scale)


def test_schedule_equals_optax():
    for steps, lr in ((50, 1.5e-3), (1500, 1.5e-3), (3, 1e-2)):
        ref = optax.warmup_cosine_decay_schedule(
            0.0, lr, warmup_steps=min(100, steps // 10), decay_steps=steps, end_value=lr * 0.03)
        ours = np.array([tf.schedule(i, lr, steps) for i in range(steps)])
        np.testing.assert_allclose(ours, np.array([float(ref(i)) for i in range(steps)]),
                                   rtol=1e-6, atol=1e-12)
    assert tf.schedule(0, 1.5e-3, 50) == 0.0          # the first update has rate 0
    with pytest.raises(ValueError):
        tf.schedule(0, 1e-3, 0)


def test_three_updates_equal_optax():
    """Clip to the global norm, then Adam at the scheduled rate: the same
    three gradients (global norms ~3, ~0.5, ~2: clipped, kept, clipped)
    give optax's parameters."""
    steps, lr = 50, 1.5e-3
    params = jax.tree.map(np.asarray, jsp.init_params(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(9)
    grads = []
    for norm in (3.0, 0.5, 2.0):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        total = np.sqrt(sum(float(np.sum(x.astype(np.float64) ** 2))
                            for x in jax.tree.leaves(g)))
        grads.append(jax.tree.map(lambda x: (x * (norm / total)).astype(np.float32), g))

    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=min(100, steps // 10),
                                               decay_steps=steps, end_value=lr * 0.03)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(sched))
    pj = jax.tree.map(jnp.asarray, params)
    state = opt.init(pj)

    @jax.jit
    def update(g, state, p):
        upd, state = opt.update(g, state)
        return optax.apply_updates(p, upd), state
    for g in grads:
        pj, state = update(jax.tree.map(jnp.asarray, g), state, pj)

    net = tsp.from_jax_params(params).train().requires_grad_(True)
    torch_opt = tf.make_optimizer(net)
    norms = []
    for it, g in enumerate(grads):
        for name in tsp._ALL_NAMES:
            conv = getattr(net, name)
            conv.weight.grad = torch.from_numpy(
                np.ascontiguousarray(g[name]["w"].transpose(3, 2, 0, 1)))
            conv.bias.grad = torch.from_numpy(g[name]["b"].copy())
        norms.append(float(tf.apply_gradients(net, torch_opt, tf.schedule(it, lr, steps))))
    np.testing.assert_allclose(norms, [3.0, 0.5, 2.0], rtol=1e-5)
    got = tsp.to_jax_params(net)
    for name in tsp._ALL_NAMES:
        for k in ("w", "b"):
            ref = np.asarray(pj[name][k])
            move = np.abs(ref - params[name][k]).max()
            assert move > 1e-4                    # the updates did move the weights
            # and one float32 rounding of the weight itself
            np.testing.assert_allclose(got[name][k], ref, rtol=2e-7, atol=1e-4 * move,
                                       err_msg=f"{name}.{k}")


def test_save_npz_loads_in_both_packages(tmp_path):
    net = tsp.init_params(torch.Generator().manual_seed(4))
    path = str(tmp_path / "sp.npz")
    tsp.save_npz(net, path)
    z = np.load(path)
    assert sorted(z.files) == sorted(f"{n}.{k}" for n in tsp._ALL_NAMES for k in ("w", "b"))
    assert all(z[f].dtype == np.float16 for f in z.files)
    pj = jsp.params_from_npz(path)
    pt = tsp.to_jax_params(tsp.params_from_npz(path))
    ref = tsp.to_jax_params(net)
    for name in tsp._ALL_NAMES:
        for k in ("w", "b"):
            np.testing.assert_array_equal(pt[name][k], np.asarray(pj[name][k]))
            np.testing.assert_array_equal(pt[name][k],
                                          ref[name][k].astype(np.float16).astype(np.float32))
    # to_jax_params inverts from_jax_params exactly
    again = tsp.to_jax_params(tsp.from_jax_params(ref))
    for name in tsp._ALL_NAMES:
        np.testing.assert_array_equal(again[name]["w"], ref[name]["w"])


@time_limit(60)
def test_script_runs_three_steps_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "weights.npz")
    assert tf.main(["--steps", "3", "--size", str(SIZE), "--scenes", "2", "--views", "3",
                    "--device", "cpu", "--out", out]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert sum(line.startswith("step ") for line in lines) == 2        # steps 0 and 2
    res = json.loads(lines[-1])
    assert set(res) == {"steps", "train_s", "det_recall_2px_heldout",
                        "det_precision_2px_heldout", "desc_pos_sim", "desc_neg_sim",
                        "weights", "size_mb"}
    assert res["steps"] == 3 and res["weights"] == out
    assert 0.0 <= res["det_recall_2px_heldout"] <= 1.0
    assert np.isfinite(res["desc_pos_sim"]) and np.isfinite(res["desc_neg_sim"])
    tsp.params_from_npz(out)
    # cuDNN's deterministic switch is held only while the loop runs
    assert torch.backends.cudnn.deterministic is False
