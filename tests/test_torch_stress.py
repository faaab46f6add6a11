"""The port's stress scripts (``scripts/stress_synth.py``,
``scripts/stress_report.py``) against the JAX package's, on the CPU.

The stress run at a small size (6 views, 150 points, 32 clutter slots, the
scripts' seeds): both packages register every view and triangulate every
point, each within a normalised ATE of 0.5%, the two ATEs within 0.1% of
the extent of each other (the RANSAC streams differ: the port's generator
and JAX's keys draw differently, so runs are compared by their
statistics). The report of the tracked 100-view checkpoint: integers
equal, floats within 1e-5 relative."""

import contextlib
import io
import json
import os
import sys

import jax

from reconstructor_tpu_torch.scripts import stress_report, stress_synth

import torch_parity  # noqa: F401  (two torch threads per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "out", "stress100_r4_ckpt.npz")
SMALL = ["--views", "6", "--points", "150", "--clutter", "32", "--seed", "0"]


def last_json(fn, argv):
    """Run a script's ``main`` with ``argv`` as its command line; the JSON
    object of its last line of standard output."""
    old = sys.argv
    sys.argv = ["script"] + list(argv)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            fn()
    finally:
        sys.argv = old
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def jax_script(name):
    sys.path.insert(0, REPO)
    jax.config.update("jax_platforms", "cpu")
    import importlib
    return importlib.import_module(f"scripts.{name}")


def test_stress_synth_matches_the_jax_script():
    # measured: both 6/6 views, 150 landmarks, 900 observations; ATE
    # 0.0167% (JAX) and 0.0203% (port); every BA dense, no kNN launch on
    # the CPU
    jres = last_json(jax_script("stress_synth").main, SMALL + ["--cpu"])
    tres = last_json(lambda: stress_synth.main(SMALL + ["--device", "cpu", "--quiet"]), [])
    for k in ("views_registered", "views_total", "landmarks", "observations", "num_aligned"):
        assert tres[k] == jres[k], (k, tres[k], jres[k])
    assert tres["views_registered"] == 6 and tres["landmarks"] == 150
    assert tres["ate_rmse_normalized"] < 0.005 and jres["ate_rmse_normalized"] < 0.005
    assert abs(tres["ate_rmse_normalized"] - jres["ate_rmse_normalized"]) < 0.001
    assert set(jres) <= set(tres)
    assert tres["ba_calls"] == {"dense": 10, "pcg": 0, "distributed": 0}
    assert tres["knn_launches"] == 0


def test_stress_report_matches_the_jax_script():
    argv = [CKPT, "--wall-s", "772.1"]
    jres = last_json(jax_script("stress_report").main, argv)
    tres = last_json(lambda: stress_report.main(argv), [])
    assert sorted(tres) == sorted(jres)
    for k, v in jres.items():
        if isinstance(v, float):
            assert abs(tres[k] - v) <= 1e-5 * abs(v), (k, tres[k], v)
        else:
            assert tres[k] == v, (k, tres[k], v)
    assert tres["views_registered"] == 100 and tres["partial"] is False


def test_stress_resume_from_a_mid_run_autosave_ends_in_the_same_state(tmp_path):
    """An autosave made mid-run, resumed by a fresh reconstructor, ends
    in the uninterrupted run's state bit for bit (the smoke script holds
    the 100-view run on the card to the same)."""
    import numpy as np
    import shutil
    from reconstructor_tpu_torch.pipeline import checkpoint
    state, gt, _ = stress_synth.scene(8, 150, 32)
    rec = stress_synth.reconstructor(state, seed=0, device="cpu", verbose=False)
    rec.config = rec.config.with_(checkpoint_every_views=1)
    ckpt, mid = str(tmp_path / "run.npz"), str(tmp_path / "mid.npz")
    autosave = rec._autosave

    def copying(st, path):
        autosave(st, path)
        if len(st.registered) == 4 and not os.path.exists(mid):
            shutil.copy(path, mid)
    rec._autosave = copying
    full, info = stress_synth.drive(rec, state, ckpt)
    assert os.path.exists(mid) and info["ba_calls"]["dense"] > 0
    rec2 = stress_synth.reconstructor(state, seed=0, device="cpu", verbose=False)
    rec2.config = rec2.config.with_(checkpoint_every_views=1)
    again, _ = stress_synth.drive(rec2, None, mid)
    a, b = checkpoint.arrays_of(full), checkpoint.arrays_of(again)
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    rep = stress_report.report(ckpt, 8, 150, 32)
    assert rep == stress_synth.report(full, gt, partial=False)
