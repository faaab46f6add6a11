"""SuperGlue training in the port (``scripts/train_superglue.py`` on torch
autograd and ``torch.optim``) against the JAX package's script on the CPU,
at a 96 px crop (the script's 320 cut to size; both modules' ``CROP`` set
for the test), 64 keypoints and 2-layer GNNs.

- ``build_bank`` on rendered views equals the JAX script's from one
  ``np.random.default_rng``: the same crops and warps, the same keypoints
  in each slot but where two SuperPoint scores lie within float32
  rounding of each other and trade slots (``tests/test_torch_learned.py``
  allows those and nothing else), descriptors within 1e-4, and ground
  truth equal once such swaps are undone.
- The JAX script's ``loss_fn`` (``scripts/train_superglue.py:184-207``),
  written here from the JAX package's ``gnn_forward`` and
  ``log_sinkhorn``, and its gradient, against the port's ``batch_loss``, at
  the JAX script's ``small_identity_params(2)`` and at a JAX
  ``init_params(PRNGKey(3), n_layers=2)`` (BN statistics moved off 0 and
  1), where every layer's gradient is non-zero. The BN statistics
  (``mean`` / ``var``) are trained as weights in both. float64: loss within 1e-9 relative, every gradient within 1e-9
  of its tensor's largest magnitude; float32: loss within 1e-5, gradients
  within 5e-4 of that magnitude (measured 1e-4 at the random weights: 50
  Sinkhorn iterations carry the two packages' float32 roundings of the
  attention into the coupling). A tensor whose gradient is zero in exact
  arithmetic is held to the largest gradient's scale instead.
- Three Adam updates under optax's cosine decay, fed the same gradients,
  move the parameters and BN statistics as optax does (within 1e-4 of
  each tensor's largest move plus one float32 rounding).
- ``params_to_npz`` writes the JAX ``params_to_npz``'s keys; both
  packages' ``params_from_npz`` load it back.
- Step 0 is the production matcher: ``small_identity_params(4)`` decodes
  every pair exactly as ``structured_identity_params()``, bit for bit.
- ``main()`` runs 3 steps on the CPU with ``io.images.load_folder``
  replaced by rendered views.
"""

import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from reconstructor_tpu.features import superpoint as jsp
from reconstructor_tpu.matching import superglue as jsg
from reconstructor_tpu_torch.features import superpoint as tsp
from reconstructor_tpu_torch.matching import superglue as tsg
from reconstructor_tpu_torch.scripts import train_superglue as tts

from torch_parity import time_limit  # (also: two torch threads per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = 96
KPS = 64
ITERS = 50


def jax_script(name):
    """A root ``scripts/*.py`` module of the JAX package from its file. The
    JAX ``train_superglue.build_bank`` imports ``distill_fountain`` by name,
    from the scripts directory its module puts on ``sys.path``."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jts():
    saved = list(sys.path)
    mod = jax_script("train_superglue")
    sys.path[:] = saved + [os.path.join(REPO, "scripts")]
    return mod


def views(n=6, seed=0):
    from reconstructor_tpu_torch.eval import render
    return render.make_scene(seed=seed, n_views=n, h=128, w=160, n_blobs=1200, tex_size=1024,
                             focal_px=192.0)["images"].astype(np.float32)


@pytest.fixture(scope="module")
def banks(jts):
    """The JAX script's bank and the port's, 6 pairs from one seed."""
    grays = list(views())
    old = jts.CROP, tts.CROP
    jts.CROP = tts.CROP = CROP
    try:
        jb = jts.build_bank(grays, jsp.params_from_npz(tts.SP_WEIGHTS), 6, KPS,
                            np.random.default_rng(0))
        tb = tts.build_bank(grays, tsp.params_from_npz(tts.SP_WEIGHTS), 6, KPS,
                            np.random.default_rng(0))
    finally:
        jts.CROP, tts.CROP = old
    return jb, tb


@time_limit(120)
def test_build_bank_matches_jax(banks):
    jb, tb = banks
    assert set(tb) == set(jb) == set(tts.BANK_KEYS)
    for k in tts.BANK_KEYS:
        assert tb[k].shape == jb[k].shape and tb[k].dtype == jb[k].dtype, k
    np.testing.assert_array_equal(tb["m0"], jb["m0"])
    np.testing.assert_array_equal(tb["m1"], jb["m1"])
    swapped = 0
    for n in range(tb["d0"].shape[0]):
        perms = []
        for side in "01":
            valid = jb[f"m{side}"][n]
            where = {tuple(p): k for k, p in enumerate(jb[f"x{side}"][n][valid])}
            perm = np.array([where[tuple(p)] for p in tb[f"x{side}"][n][valid]])
            moved = perm != np.arange(perm.size)
            swapped += int(moved.sum())
            s = jb[f"s{side}"][n]
            np.testing.assert_allclose(s[perm[moved]], s[:perm.size][moved], rtol=1e-4, atol=0)
            np.testing.assert_allclose(tb[f"s{side}"][n][valid], s[valid][perm], rtol=1e-4)
            np.testing.assert_allclose(tb[f"d{side}"][n][valid], jb[f"d{side}"][n][valid][perm],
                                       atol=1e-4)
            np.testing.assert_array_equal(tb[f"x{side}"][n][~valid], jb[f"x{side}"][n][~valid])
            perms.append(np.concatenate([perm, np.arange(perm.size, KPS)]))
        pa, pb = perms
        inv_b = np.argsort(pb)
        jg = jb["gt0"][n][pa]
        want = np.where((jg >= 0) & (jg < KPS), inv_b[np.clip(jg, 0, KPS - 1)], jg)
        np.testing.assert_array_equal(tb["gt0"][n], want)
        np.testing.assert_array_equal(tb["bin1"][n], jb["bin1"][n][pb])
    assert swapped <= 8
    partners = (tb["gt0"] >= 0) & (tb["gt0"] < KPS)
    assert partners.sum() > 30 and (tb["gt0"] == KPS).any() and tb["bin1"].any()


def jax_loss(p, b, idx):
    """The JAX script's ``loss_fn`` at the test's crop and Sinkhorn depth."""
    shape = jnp.asarray([CROP, CROP], jnp.int32)

    def pair_nll(i):
        xy0n = jsg.normalize_keypoints(b["x0"][i], shape[0], shape[1])
        xy1n = jsg.normalize_keypoints(b["x1"][i], shape[0], shape[1])
        f0, f1 = jsg.gnn_forward(p, b["d0"][i], b["d1"][i], xy0n, xy1n,
                                 b["s0"][i], b["s1"][i], b["m0"][i], b["m1"][i])
        scores = jnp.einsum("md,nd->mn", f0, f1) / (jsg.D_MODEL ** 0.5)
        Z = jsg.log_sinkhorn(scores, p["bin_score"], b["m0"][i], b["m1"][i], ITERS)
        gt = b["gt0"][i]
        sel = jnp.where(gt >= 0, gt, 0)
        row_terms = jnp.where(gt >= 0, Z[jnp.arange(KPS), sel], 0.0)
        n_row = jnp.maximum((gt >= 0).sum(), 1)
        bin_ll = jnp.where(b["bin1"][i], Z[KPS, :KPS], 0.0)
        n_bin = jnp.maximum(b["bin1"][i].sum(), 1)
        return -(row_terms.sum() / n_row + bin_ll.sum() / n_bin)
    return jnp.mean(jax.vmap(pair_nll)(idx))


def jax_small_identity(jts, n_layers):
    return jax.tree.map(np.asarray, jts.small_identity_params(n_layers))


def grads_as_jax(net):
    """The port's gradients (parameters and BN statistics) in the JAX
    pytree's layout."""
    g = tsg.SuperGlue(len(net.gnn.layers)).to(net.final_proj.weight.dtype)
    sd = dict(net.named_parameters())
    sd.update(net.named_buffers())
    g.load_state_dict({k: v.grad for k, v in sd.items()})
    return tsg.to_jax_params(g)


@time_limit(120)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("init", ["small_identity", "random"])
def test_loss_and_gradients_match_jax(jts, banks, init, dtype, monkeypatch):
    monkeypatch.setattr(tts, "CROP", CROP)
    bank = banks[0]
    params = (jax_small_identity(jts, 2) if init == "small_identity"
              else jax.tree.map(np.asarray, jsg.init_params(jax.random.PRNGKey(3), n_layers=2)))
    if init == "random":      # BN statistics away from (0, 1), so that both get gradients
        rng = np.random.default_rng(1)
        for layer in params["kenc"] + [m for lay in params["layers"] for m in lay["mlp"]]:
            if "bn" in layer:
                c = layer["bn"]["mean"].shape[0]
                layer["bn"]["mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
                layer["bn"]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    idx = np.array([3, 0, 5, 0])
    def fl(a):          # floats to the test's dtype, indices and masks as they are
        a = np.asarray(a)
        return a.astype(dtype) if a.dtype.kind == "f" else a
    with jax.enable_x64(dtype == np.float64):
        pj = jax.tree.map(lambda a: jnp.asarray(fl(a)), params)
        bj = {k: jnp.asarray(fl(v)) for k, v in bank.items()}
        lj, gj = jax.jit(jax.value_and_grad(jax_loss))(pj, bj, jnp.asarray(idx))
        lj, gj = float(lj), jax.tree.map(np.asarray, gj)

    net = tsg.from_jax_params(params).to(torch.from_numpy(fl(np.float32(0))).dtype)
    tensors = tts.trainable(net)
    for t in tensors:
        t.requires_grad_(True)
    bt = {k: torch.from_numpy(fl(v)) for k, v in bank.items()}
    lt = tts.batch_loss(net, bt, torch.from_numpy(idx), ITERS)
    lt.backward()
    assert np.isfinite(float(lt)) and float(lt) > 0
    np.testing.assert_allclose(float(lt), lj, rtol=1e-5 if dtype == np.float32 else 1e-9)
    tol = 5e-4 if dtype == np.float32 else 1e-9
    gt = grads_as_jax(net)
    flat_j = jax.tree_util.tree_flatten_with_path(gj)[0]
    flat_t = dict((jax.tree_util.keystr(k), v) for k, v in
                  jax.tree_util.tree_flatten_with_path(gt)[0])
    assert len(flat_j) == len(flat_t) == len(tensors)
    assert sum(k.endswith("['var']") for k in flat_t) == 4 + 2    # kenc's 4 BNs, 1 a layer
    # a tensor whose gradient is zero in exact arithmetic (at the identity,
    # everything the zeroed last layers discard) carries rounding noise:
    # held to the largest gradient's scale instead of its own
    top = max(np.abs(a).max() for _, a in flat_j)
    live = []
    for path, a in flat_j:
        name = jax.tree_util.keystr(path)
        b = np.asarray(flat_t[name])
        assert a.shape == b.shape and b.dtype == dtype, name
        scale = np.abs(a).max()
        if scale > 1e-6 * top:
            live.append(name)
        assert np.abs(a - b).max() <= tol * max(scale, 1e-6 * top), (
            name, np.abs(a - b).max(), scale)
    if init == "random":
        # every tensor's gradient is live, BN means and variances included,
        # but the attention's key biases: a bias on the keys shifts each
        # query's scores by one constant, which the softmax cancels
        dead = [jax.tree_util.keystr(p) for p, _ in flat_j
                if jax.tree_util.keystr(p) not in live]
        assert dead == [f"['layers'][{i}]['k']['b']" for i in range(2)], dead
    else:                                      # the last dense layers, projection, bin
        assert set(live) == {"['bin_score']", "['final_proj']['b']", "['final_proj']['w']",
                             "['kenc'][4]['dense']['b']", "['kenc'][4]['dense']['w']",
                             *(f"['layers'][{i}]['mlp'][1]['dense']['{k}']"
                               for i in range(2) for k in "bw")}


def test_three_adam_updates_equal_optax(jts):
    steps, lr = 40, 2e-4
    params = jax.tree.map(np.asarray, jsg.init_params(jax.random.PRNGKey(3), n_layers=2))
    rng = np.random.default_rng(9)
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32) * s, params)
             for s in (1.0, 0.01, 3.0)]
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps))
    pj = jax.tree.map(jnp.asarray, params)
    state = opt.init(pj)

    @jax.jit
    def update(g, state, p):
        upd, state = opt.update(g, state)
        return optax.apply_updates(p, upd), state
    for g in grads:
        pj, state = update(jax.tree.map(jnp.asarray, g), state, pj)

    net = tsg.from_jax_params(params)
    tensors = tts.trainable(net)
    for t in tensors:
        t.requires_grad_(True)
    opt_t = tts.make_optimizer(tensors)
    named = dict(net.named_parameters())
    named.update(net.named_buffers())
    for it, g in enumerate(grads):
        gnet = tsg.from_jax_params(g)
        gsd = gnet.state_dict()
        for k, v in named.items():
            v.grad = gsd[k].clone()
        for group in opt_t.param_groups:
            group["lr"] = tts.schedule(it, lr, steps)
        opt_t.step()
    got = tsg.to_jax_params(net)
    ref = jax.tree.map(np.asarray, pj)
    for (path, r), (_, p0), (_, o) in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                                          jax.tree_util.tree_flatten_with_path(params)[0],
                                          jax.tree_util.tree_flatten_with_path(got)[0]):
        move = np.abs(r - p0).max()
        assert move > 1e-5, jax.tree_util.keystr(path)
        np.testing.assert_allclose(o, r, rtol=2e-7, atol=1e-4 * move,
                                   err_msg=jax.tree_util.keystr(path))
    # optax evaluates the cosine in float32
    sched = optax.cosine_decay_schedule(lr, steps)
    np.testing.assert_allclose([tts.schedule(i, lr, steps) for i in range(steps + 5)],
                               [float(sched(i)) for i in range(steps + 5)], rtol=2e-5, atol=1e-12)


def test_params_to_npz_round_trips_through_both_packages(tmp_path):
    net = tsg.init_params(torch.Generator().manual_seed(5), n_layers=2)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, tsg.EvalBatchNorm):
                m.running_mean.normal_()
                m.running_var.uniform_(0.5, 2.0)
    path = str(tmp_path / "sg.npz")
    tsg.params_to_npz(net, path)
    ref_path = str(tmp_path / "ref.npz")
    jsg.params_to_npz(jax.tree.map(jnp.asarray, tsg.to_jax_params(net)), ref_path)
    z, zr = np.load(path), np.load(ref_path)
    assert sorted(z.files) == sorted(zr.files)
    for k in z.files:
        np.testing.assert_array_equal(z[k], zr[k])
    pj = jsg.params_from_npz(path)
    want = tsg.to_jax_params(net)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(pj)[0],
                                jax.tree_util.tree_flatten_with_path(want)[0]):
        assert jax.tree_util.keystr(pa) == jax.tree_util.keystr(pb)
        np.testing.assert_array_equal(np.asarray(a), b)
    back = tsg.params_from_npz(path)
    for (k, a), (k2, b) in zip(back.state_dict().items(), net.state_dict().items()):
        assert k == k2
        assert torch.equal(a, b), k


def test_step_zero_is_the_production_matcher(banks, monkeypatch):
    """small_identity_params(4) decodes every pair bit for bit as the
    structured identity (18 layers), and val_f1 agrees."""
    monkeypatch.setattr(tts, "CROP", CROP)
    val = tts.to_device(banks[1], "cpu")
    small = tts.small_identity_params(4)
    full = tsg.structured_identity_params(generator=torch.Generator().manual_seed(0))
    shape = torch.tensor([CROP, CROP], dtype=torch.int32)
    for i in range(val["d0"].shape[0]):
        args = [val[k][i] for k in ("d0", "d1", "x0", "x1", "s0", "s1", "m0", "m1")]
        a = tsg.match_pair(small, *args, shape, shape, sinkhorn_iters=100)
        b = tsg.match_pair(full, *args, shape, shape, sinkhorn_iters=100)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert a[1].sum() > 0
    assert tts.val_f1(small, val) == tts.val_f1(full, val)
    # the log_sinkhorn training differentiates is the kernel's plain loop
    sc = torch.randn(2, 5, 7, dtype=torch.float64)
    m0 = torch.tensor([[1, 1, 0, 1, 1], [1, 0, 1, 1, 1]], dtype=torch.bool)
    m1 = torch.ones(2, 7, dtype=torch.bool)
    alpha = torch.tensor(1.5, dtype=torch.float64)
    Zb = tsg.log_sinkhorn(sc, alpha, m0, m1, 7)
    Zj = np.stack([np.asarray(jsg.log_sinkhorn(jnp.asarray(sc[i].numpy(), jnp.float32),
                                               jnp.asarray(1.5), jnp.asarray(m0[i].numpy()),
                                               jnp.asarray(m1[i].numpy()), 7)) for i in range(2)])
    np.testing.assert_allclose(Zb.numpy(), Zj, rtol=1e-5, atol=1e-4)
    assert torch.equal(tsg.log_sinkhorn(sc[1], alpha, m0[1], m1[1], 7), Zb[1])


def test_main_needs_the_photographs_inside_the_checkout(tmp_path, monkeypatch):
    """The photographs are looked for inside the repository, and main()
    stops naming the folder while it is missing."""
    assert os.path.commonpath([tts.DATA, tts.REPO]) == tts.REPO
    missing = str(tmp_path / "data")
    monkeypatch.setattr(tts, "DATA", missing)
    with pytest.raises(SystemExit, match=re.escape(f"{missing} is missing")):
        tts.main(["--cpu", "--steps", "1"])


@time_limit(120)
def test_split_bank_and_train_log_every_validation(banks, monkeypatch):
    """split_bank keeps the JAX script's split; train validates at step 0
    and every val_every steps, keeps each reading, and the best is the
    identity until a validation beats it."""
    monkeypatch.setattr(tts, "CROP", CROP)
    bank = {k: np.concatenate([v, v]) for k, v in banks[1].items()}
    n = bank["d0"].shape[0]
    trn, val = tts.split_bank(bank, "cpu")
    n_val = min(max(8, n // 10), max(n // 2, 1))
    assert val["d0"].shape[0] == n_val and trn["d0"].shape[0] == n - n_val
    assert torch.equal(val["gt0"], torch.as_tensor(bank["gt0"][:n_val]))
    res = tts.train(tts.small_identity_params(2), trn, val, 4, 1e-3, 2, 5, val_every=2)
    steps = [v[0] for v in res["validations"]]
    assert steps == [0, 2, 4] and res["val_calls"] == 3
    assert res["validations"][0][1:] == res["identity"]
    assert res["best_f1"] == max(v[1] for v in res["validations"])


@time_limit(120)
def test_main_runs_three_steps_on_the_cpu(tmp_path, capsys, monkeypatch):
    from reconstructor_tpu_torch.io import images as io_images
    frames = [io_images.from_rgb(np.repeat(np.clip(im * 255, 0, 255).astype(np.uint8)[..., None],
                                           3, -1), path=f"{i:04d}.png")
              for i, im in enumerate(views(4, seed=1))]
    asked = []

    def load_folder(folder, img_max_size=512, max_workers=8):
        asked.append((folder, img_max_size))
        return frames
    monkeypatch.setattr(io_images, "load_folder", load_folder)
    monkeypatch.setattr(tts, "CROP", CROP)
    monkeypatch.setattr(tts, "DATA", str(tmp_path))
    out = str(tmp_path / "sg.npz")
    bank = str(tmp_path / "bank.npz")
    argv = ["--steps", "3", "--pairs", "10", "--kps", str(KPS), "--layers", "2", "--batch", "2",
            "--sinkhorn-iters", "10", "--lr", "1e-3", "--cpu", "--out", out, "--bank", bank]
    assert tts.main(argv) == 0
    assert asked == [(tts.DATA, 512)] and os.path.exists(bank)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("bank: 5 train / 5 val pairs")
    assert lines[1].startswith("identity baseline: F1 ")
    assert lines[2].startswith("final: best F1 ")
    assert lines[3] in (f"saved {out}", "trained model did NOT beat the identity — not saving")
    assert os.path.exists(out) == lines[3].startswith("saved")
    # a second run reads the cached bank
    assert tts.main(argv) == 0
    assert capsys.readouterr().out.startswith(f"loaded bank {bank}")
