"""Checkpoint writing and resume in the PyTorch port, on the CPU.

The port's files keep the JAX package's npz layout, so each package loads
the other's; the port writes its generator's state (``rng_state_torch``)
and never a JAX ``rng_key``, which it ignores when it reads one. A run
resumed from an autosave reproduces the uninterrupted run (the pattern of
``tests/test_integration.py::TestCheckpointResume``)."""

import shutil

import numpy as np
import jax
import pytest
import torch

from reconstructor_tpu.pipeline import checkpoint as jax_checkpoint
from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.eval.synth import make_synthetic_state
from reconstructor_tpu_torch.pipeline import checkpoint
from reconstructor_tpu_torch.pipeline.checkpoint import FIELDS
from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor

import torch_parity  # noqa: F401  (two torch threads per worker)

CFG = dict(max_keypoints=320, ransac_num_hypotheses=256, fundamental_num_hypotheses=128,
           pnp_num_hypotheses=256, ba_max_iters_small=20, ba_max_iters_large=20,
           final_refinement_rounds=1, min_2d3d_match_num=10, pnp_min_inliers=8,
           checkpoint_every_views=1)


def fresh_state():
    state, _, _ = make_synthetic_state(n_views=6, n_points=250, clutter=16, seed=11)
    return state


def assert_states_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), f)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
    assert a.num_images == b.num_images and a.max_keypoints == b.max_keypoints
    assert list(a.registered) == list(b.registered)
    assert sorted(a.poses) == sorted(b.poses)
    for i in a.poses:
        np.testing.assert_array_equal(np.asarray(a.poses[i]), np.asarray(b.poses[i]))
    assert sorted(a.matches) == sorted(b.matches)
    for k in a.matches:
        np.testing.assert_array_equal(np.asarray(a.matches[k]), np.asarray(b.matches[k]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An uninterrupted run that autosaves after every view, with a copy of
    the autosave made when the fourth view registered; then a fresh
    reconstructor resumed from that copy."""
    d = tmp_path_factory.mktemp("ckpt")
    ckpt, mid = str(d / "run.npz"), str(d / "mid.npz")
    rec_a = IncrementalReconstructor(ReconstructorConfig(**CFG), verbose=False, device="cpu")
    saved = {}
    autosave = rec_a._autosave

    def copying(state, path):
        autosave(state, path)
        if len(state.registered) == 4 and not saved:
            shutil.copy(path, mid)
            saved["state"] = checkpoint.state_from_arrays(checkpoint.arrays_of(state))
            saved["gen"] = rec_a._gen.get_state()
    rec_a._autosave = copying
    final_a = rec_a.reconstruct_from_state(fresh_state(), checkpoint_path=ckpt)
    # the resumed run autosaves over the file it resumed from: give it a copy
    resumed = str(d / "resumed.npz")
    shutil.copy(mid, resumed)
    rec_c = IncrementalReconstructor(ReconstructorConfig(**CFG), verbose=False, device="cpu")
    final_c = rec_c.reconstruct("unused: the state comes from the checkpoint",
                                checkpoint_path=resumed, resume=True)
    return final_a, final_c, saved, ckpt, mid


def test_autosave_loads_field_for_field(runs):
    final_a, _, saved, ckpt, mid = runs
    assert_states_equal(checkpoint.load(mid), saved["state"])
    assert torch.equal(checkpoint.load_rng_state(mid, "cpu"), saved["gen"])
    # the last autosave is the final state
    assert_states_equal(checkpoint.load(ckpt), final_a)


def test_resume_reproduces_uninterrupted_run(runs):
    final_a, final_c, _, _, _ = runs
    assert len(final_a.registered) == 6
    assert final_c.registered == final_a.registered
    assert final_c.num_landmarks == final_a.num_landmarks
    for i in final_a.registered:
        np.testing.assert_allclose(final_c.poses[i], final_a.poses[i], atol=1e-5)


def test_meta_carries_config_and_rng(runs):
    _, _, _, _, mid = runs
    meta = checkpoint.load_meta(mid)
    assert meta["rng"] == "torch" and meta["rng_device"] == "cpu" and meta["caps"] == {}
    cfg = ReconstructorConfig(**CFG)
    assert meta["config"]["checkpoint_every_views"] == 1
    assert ReconstructorConfig(**meta["config"]) == cfg
    with np.load(mid) as z:
        assert "rng_state_torch" in z.files and "rng_key" not in z.files
    # a generator state of another device type is not offered
    assert checkpoint.load_rng_state(mid, "cuda") is None


def test_port_file_loads_in_jax(runs):
    final_a, _, _, ckpt, _ = runs
    js = jax_checkpoint.load(ckpt)
    assert_states_equal(js, final_a)
    assert jax_checkpoint.load_rng_key(ckpt) is None
    assert jax_checkpoint.load_meta(ckpt)["config"]["max_keypoints"] == 320


def test_jax_file_loads_in_port(runs, tmp_path, capsys):
    final_a, _, _, _, _ = runs
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save(path, final_a, config=None, rng_key=jax.random.PRNGKey(5),
                        caps={"obs": 4096})
    assert_states_equal(checkpoint.load(path), final_a)
    assert checkpoint.load_rng_state(path, "cpu") is None
    rec = IncrementalReconstructor(ReconstructorConfig(**CFG), verbose=True, device="cpu")
    before = rec._gen.get_state()
    state = rec.restore(path)
    assert_states_equal(state, final_a)
    assert torch.equal(rec._gen.get_state(), before)
    out = capsys.readouterr().out
    assert "holds no torch generator state" in out


def test_save_is_atomic_and_overwrites(tmp_path, runs):
    final_a, _, _, _, _ = runs
    path = str(tmp_path / "s.npz")
    checkpoint.save(path, fresh_state())
    checkpoint.save(path, final_a, config=ReconstructorConfig(**CFG),
                    generator=torch.Generator().manual_seed(3))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["s.npz"]
    assert_states_equal(checkpoint.load(path), final_a)
    assert torch.equal(checkpoint.load_rng_state(path, "cpu"),
                       torch.Generator().manual_seed(3).get_state())
