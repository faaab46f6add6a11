"""SuperPoint self-distillation in the port (``scripts/distill_fountain.py``
on torch autograd and ``torch.optim``) against the JAX package's script on
the CPU, at a 64 px crop (the script's 160 cut to size; both modules'
``CROP`` set for the test).

- ``rand_homography``, ``warp_image``, ``cell_labels`` and ``build_bank``
  equal the JAX script's bit for bit from one ``np.random.default_rng``
  (numpy on both sides).
- The JAX script's ``pair_loss`` (``scripts/distill_fountain.py:215-235``),
  written here from the JAX package's own ``sp.forward`` and
  ``_bilinear_sample_map`` with the augmentation (gain, bias, noise) given
  as arrays, and its gradient, against the port's ``batch_loss`` on the
  same draws, from the JAX package's ``init_params(PRNGKey(1))`` carried
  across. In float64 (both packages) the loss agrees within 1e-9 relative
  and every gradient within 1e-9 of that tensor's largest magnitude. In
  float32, as the trainer runs, the loss agrees within 1e-5 relative and
  the gradients within 1e-4 of each tensor's largest magnitude from the
  last pooling up (conv4 and both heads), within 3e-3 below it: the two
  packages' convolutions differ by ~1e-7 relative, enough to flip the
  winner of a 2x2 max-pool window whose two best values are that close,
  and the flipped window sends its gradient to the neighbour (as
  ``tests/test_torch_train_frontend.py`` finds for the other trainer).
- ``save_params`` writes float16 atomically; ``params_from_npz`` gives back
  the weights saved.
- ``main()`` runs 3 steps on the CPU, with ``io.images.load_folder``
  replaced by 25 rendered views.
"""

import importlib.util
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from reconstructor_tpu.features import superpoint as jsp
from reconstructor_tpu_torch.features import superpoint as tsp
from reconstructor_tpu_torch.scripts import distill_fountain as tdf

from torch_parity import time_limit  # (also: two torch threads per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = 64


def jax_script(name):
    """A root ``scripts/*.py`` module of the JAX package, imported from its
    file (the scripts directory is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jdf():
    return jax_script("distill_fountain")


@pytest.fixture
def crop64(jdf, monkeypatch):
    monkeypatch.setattr(jdf, "CROP", CROP)
    monkeypatch.setattr(tdf, "CROP", CROP)


def small_inputs(n_img=3, h=96, w=120, seed=0):
    """Rendered grays and synthetic teacher keypoints (a dense grid with
    jitter and a mask with holes)."""
    from reconstructor_tpu_torch.eval import render
    scene = render.make_scene(seed=seed, n_views=n_img, h=h, w=w)
    rng = np.random.default_rng(seed + 1)
    xy = rng.uniform([0, 0], [w, h], (n_img, 300, 2)).astype(np.float32)
    mask = rng.uniform(size=(n_img, 300)) < 0.8
    return list(scene["images"].astype(np.float32)), xy, mask


def test_numpy_helpers_bit_for_bit(jdf):
    for seed in range(3):
        Hj = jdf.rand_homography(np.random.default_rng(seed), 160)
        Ht = tdf.rand_homography(np.random.default_rng(seed), 160)
        np.testing.assert_array_equal(Ht, Hj)
        img = np.random.default_rng(seed + 10).uniform(0, 1, (160, 160)).astype(np.float32)
        np.testing.assert_array_equal(tdf.warp_image(img, Ht, 160), jdf.warp_image(img, Hj, 160))
        uv = np.random.default_rng(seed + 20).uniform(-5, 165, (60, 2))
        valid = np.arange(60) % 4 != 0
        np.testing.assert_array_equal(tdf.cell_labels(uv, valid, 160),
                                      jdf.cell_labels(uv, valid, 160))
    assert (tdf.CROP, tdf.M_KP, tdf.TAU) == (jdf.CROP, jdf.M_KP, 20.0)


def test_build_bank_bit_for_bit(jdf, crop64):
    grays, xy, mask = small_inputs()
    bj = jdf.build_bank(grays, xy, mask, 6, np.random.default_rng(4))
    bt = tdf.build_bank(grays, xy, mask, 6, np.random.default_rng(4))
    for a, b in zip(bt, bj):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert bt[0].shape == (6, 2, CROP, CROP) and (bt[3] != 64).any()


def jax_loss(params, imgs, uv, labels, gain, bias, noise):
    """The JAX script's ``loss_fn`` with the augmentation given as arrays."""
    def pair_loss(b):
        g = jnp.clip(imgs[b] * gain[b] + bias[b] + noise[b], 0.0, 1.0)
        logits, draw = jsp.forward(params, g)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, labels[b][..., None], axis=-1)[..., 0]
        is_kp = labels[b] != 64
        det = (jnp.sum(nll * is_kp) / jnp.maximum(jnp.sum(is_kp), 1)
               + 0.3 * jnp.sum(nll * ~is_kp) / jnp.maximum(jnp.sum(~is_kp), 1))
        d0 = jsp._bilinear_sample_map(draw[0], uv[b, 0])
        d1 = jsp._bilinear_sample_map(draw[1], uv[b, 1])
        sim = tdf.TAU * (d0 @ d1.T)
        lbl = jnp.arange(sim.shape[0])
        desc = 0.5 * jnp.mean(optax.softmax_cross_entropy_with_integer_labels(sim, lbl)
                              + optax.softmax_cross_entropy_with_integer_labels(sim.T, lbl))
        return det + desc
    return jnp.mean(jnp.stack([pair_loss(b) for b in range(imgs.shape[0])]))


@pytest.fixture(scope="module")
def bank64(jdf):
    grays, xy, mask = small_inputs(seed=3)
    old = tdf.CROP
    tdf.CROP = CROP
    try:
        return tdf.build_bank(grays, xy, mask, 4, np.random.default_rng(7))
    finally:
        tdf.CROP = old


@time_limit(60)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_loss_and_gradients_match_jax(bank64, dtype):
    imgs, uvs, _, labels = bank64
    bs = np.array([2, 0, 3])
    B = len(bs)
    rng = np.random.default_rng(5)
    gain = 1.0 + 0.25 * rng.standard_normal((B, 2, 1, 1))
    bias = 0.1 * rng.standard_normal((B, 2, 1, 1))
    noise = 0.02 * rng.standard_normal((B, 2, CROP, CROP))
    fl = lambda a: np.asarray(a, dtype)  # noqa: E731
    params = jsp.init_params(jax.random.PRNGKey(1))
    with jax.enable_x64(dtype == np.float64):
        pj = jax.tree.map(lambda a: jnp.asarray(fl(a)), params)
        lj, gj = jax.jit(jax.value_and_grad(jax_loss))(
            pj, jnp.asarray(fl(imgs[bs])), jnp.asarray(fl(uvs[bs])), jnp.asarray(labels[bs]),
            jnp.asarray(fl(gain)), jnp.asarray(fl(bias)), jnp.asarray(fl(noise)))
        lj, gj = float(lj), jax.tree.map(np.asarray, gj)

    net = tsp.from_jax_params(jax.tree.map(np.asarray, params)).to(torch.from_numpy(fl(0)).dtype)
    net.train().requires_grad_(True)
    t = lambda a: torch.from_numpy(fl(a))  # noqa: E731
    bank = tdf.Bank(t(imgs), t(uvs), torch.from_numpy(labels).long())
    lt, det, desc = tdf.batch_loss(net, bank, torch.from_numpy(bs),
                                   {"gain": t(gain), "bias": t(bias), "noise": t(noise)})
    lt.backward()
    assert torch.isfinite(det) and torch.isfinite(desc) and float(det) > 0 and float(desc) > 0
    np.testing.assert_allclose(float(lt), lj, rtol=1e-5 if dtype == np.float32 else 1e-9)
    for name in tsp._ALL_NAMES:
        if dtype == np.float64:
            tol = 1e-9
        else:
            tol = 1e-4 if name.startswith(("conv4", "convP", "convD")) else 3e-3
        conv = getattr(net, name)
        got = {"w": conv.weight.grad.numpy().transpose(2, 3, 1, 0), "b": conv.bias.grad.numpy()}
        for k in ("w", "b"):
            a, b = gj[name][k], got[k]
            assert a.shape == b.shape and a.dtype == b.dtype == dtype, (name, k)
            scale = np.abs(a).max()
            assert scale > 0, (name, k)
            assert np.abs(a - b).max() <= tol * scale, (name, k, np.abs(a - b).max(), scale)


def test_draws_and_save_params(tmp_path):
    d = tdf.draws(torch.Generator().manual_seed(0), 3, CROP)
    assert d["gain"].shape == (3, 2, 1, 1) and d["noise"].shape == (3, 2, CROP, CROP)
    again = tdf.draws(torch.Generator().manual_seed(0), 3, CROP)
    assert all(torch.equal(d[k], again[k]) for k in d)
    net = tsp.init_params(torch.Generator().manual_seed(2))
    out = str(tmp_path / "sub" / "sp.npz")
    tdf.save_params(net, out)
    tdf.save_params(net, out)                       # replaces the file
    assert sorted(os.listdir(tmp_path / "sub")) == ["sp.npz"]
    back = tsp.to_jax_params(tsp.params_from_npz(out))
    ref = tsp.to_jax_params(net)
    for name in tsp._ALL_NAMES:
        for k in ("w", "b"):
            np.testing.assert_array_equal(back[name][k],
                                          ref[name][k].astype(np.float16).astype(np.float32))


@pytest.mark.parametrize("argv", [[], ["--reconstruct"]])
def test_main_needs_the_photographs_inside_the_checkout(tmp_path, monkeypatch, argv):
    """The photographs and the golden cloud are looked for inside the
    repository, and main() stops naming what is missing."""
    for path in (tdf.DATA, tdf.GOLDEN):
        assert os.path.commonpath([path, tdf.REPO]) == tdf.REPO
    monkeypatch.setattr(tdf, "DATA", str(tmp_path))
    monkeypatch.setattr(tdf, "GOLDEN", str(tmp_path / "cloud.ply"))
    if not argv:
        monkeypatch.setattr(tdf, "DATA", str(tmp_path / "data"))
    missing = tdf.DATA if not argv else tdf.GOLDEN
    with pytest.raises(SystemExit, match=re.escape(f"{missing} is missing")):
        tdf.main(["--cpu", "--steps", "1", *argv])


@time_limit(120)
def test_main_runs_three_steps_on_the_cpu(tmp_path, capsys, monkeypatch):
    from reconstructor_tpu_torch.eval import render
    from reconstructor_tpu_torch.io import images as io_images
    scene = render.make_scene(seed=2, n_views=25, h=96, w=128, n_blobs=120)
    views = [io_images.from_rgb(np.repeat(np.clip(im * 255, 0, 255).astype(np.uint8)[..., None],
                                          3, -1), path=f"{i:04d}.png")
             for i, im in enumerate(scene["images"])]
    asked = []

    def load_folder(folder, img_max_size=512, max_workers=8):
        asked.append((folder, img_max_size))
        return views
    monkeypatch.setattr(io_images, "load_folder", load_folder)
    monkeypatch.setattr(tdf, "CROP", CROP)
    monkeypatch.setattr(tdf, "DATA", str(tmp_path))
    out = str(tmp_path / "w.npz")
    assert tdf.main(["--steps", "3", "--pairs", "4", "--batch", "2", "--cpu",
                     "--out", out]) == 0
    assert asked == [(tdf.DATA, 512)]
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("teacher: ") and lines[1] == "bank: 4 crop pairs"
    assert sum(line.startswith("step ") for line in lines) == 2        # steps 0 and 2
    res = json.loads(lines[-1])
    assert set(res) == {"steps", "train_s", "teacher_recall_2px_heldout",
                        "teacher_precision_2px_heldout", "weights", "size_mb"}
    assert res["steps"] == 3 and res["weights"] == out
    assert 0.0 <= res["teacher_recall_2px_heldout"] <= 1.0
    tsp.params_from_npz(out)
    assert torch.backends.cudnn.deterministic is False
