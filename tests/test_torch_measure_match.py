"""The port's matching measurements of the 100-image headline
(``scripts/measure_match100.py``, ``bench_knn_dtype.py``,
``profile_match100_decomp.py``, ``exp_match_regression.py``) against the
JAX package on the CPU, on ``test_integration``'s rendered views (4 views
of 256x320, ``max_keypoints=256``) tiled 2x to 8 images (28 pairs); and
the six photograph-measuring scripts' ``main()`` without the photographs.

- ``tile_state`` equals the TPU scripts' ``dataclasses.replace`` field for
  field, with and without ``kp_score``.
- The ungated ``match_features`` table of the tiled state equals the JAX
  package's, and each tiled copy of a pair its pair's; both start from
  the JAX detection (carried through the checkpoint layout), so matching
  alone is compared.
- The decomposition's gated chunks (fixed B, (0, 0)-padded) against JAX
  ``match_and_gate_jit`` on the same chunks, given the draws the JAX keys
  ``split(PRNGKey(7), B)`` make (``torch_parity.draws``) through ``pos``:
  at most one slot in a thousand of the inliers differs and no pair's
  count by more than one (a slot on the F-gate's inlier threshold, where
  the packages' float32 rounding differs; ROADMAP queue C 3). Its kNN-only
  chunks equal JAX ``knn.match_all_pairs``: index outputs, equal.
- ``exp_match_regression``'s raw outputs, packed and not, equal JAX
  ``_knn_topk2(..., interpret=True)`` per chunk: indices equal, distances
  within 2e-6 (float32 dot products of unit descriptors summed in another
  order) and, for the packed kernel, equal on its 2^-17 grid.
- ``measure_match100.measure`` and ``bench_knn_dtype.bench`` run on the
  tiled state: float32 matching on the CPU whatever the setting, so the
  bf16 agreement reads 1.0 (as in the JAX package).
- Each ``main()`` stops with ``SystemExit`` naming ``reference/data`` when
  the photographs are missing (and ``exp_quality`` the golden cloud).
"""

import dataclasses as dc
import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconstructor_tpu import config as jconfig
from reconstructor_tpu.matching import gated as jgated
from reconstructor_tpu.matching import knn as jknn
from reconstructor_tpu.matching import pallas_knn
from reconstructor_tpu.pipeline.incremental import IncrementalReconstructor as JaxRec
from reconstructor_tpu_torch.config import ReconstructorConfig as TorchConfig
from reconstructor_tpu_torch.pipeline import checkpoint as torch_checkpoint
from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor as TorchRec
from reconstructor_tpu_torch.scripts import bench_knn_dtype as tbk
from reconstructor_tpu_torch.scripts import distill_fountain
from reconstructor_tpu_torch.scripts import exp_match_regression as ter
from reconstructor_tpu_torch.scripts import measure_match100 as tmm
from reconstructor_tpu_torch.scripts import profile_match100_decomp as tdec

from torch_parity import MEASURE_KW as KW, draws, rendered_folder, t, time_limit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 2
SCRIPTS = ("measure_match100", "bench_knn_dtype", "profile_match100_decomp",
           "exp_match_regression", "profile_detect", "exp_quality")


def jax_tile(state, tile, kp_score=True):
    """The TPU scripts' tiling, as written in ``measure_match100.py:39-52``
    (``bench_knn_dtype.py:30-41`` tiles ``kp_score`` unconditionally)."""
    return dc.replace(
        state,
        num_images=state.num_images * tile,
        xy=np.tile(state.xy, (tile, 1, 1)),
        desc=np.tile(state.desc, (tile, 1, 1)),
        kp_mask=np.tile(state.kp_mask, (tile, 1)),
        colors=np.tile(state.colors, (tile, 1, 1)),
        shapes=np.tile(state.shapes, (tile, 1)),
        intrinsics=np.tile(state.intrinsics, (tile, 1)),
        kp_score=None if state.kp_score is None
        else np.tile(state.kp_score, (tile, 1)),
        matches={}, poses={}, registered=[], feat2lm=None,
        lm_xyz=None, lm_rgb=None, lm_obs_img=None, lm_obs_feat=None,
        lm_obs_mask=None, lm_initial=None)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The rendered views and the JAX package's detection on them."""
    folder, _, _ = rendered_folder(tmp_path_factory.mktemp("views"))
    jstate = JaxRec(jconfig.ReconstructorConfig(**KW), verbose=False).detect_features(folder)
    return {"jstate": jstate, "arrays": torch_checkpoint.arrays_of(jstate)}


def port_state(scene):
    """The JAX detection as a port state (checkpoint layout, copies)."""
    return torch_checkpoint.state_from_arrays(scene["arrays"])


@pytest.fixture(scope="module")
def tiled(scene):
    """(desc, mask, xy) at the matching width, tiled, as numpy."""
    rec = TorchRec(TorchConfig(**KW), verbose=False, device="cpu")
    return tuple(np.concatenate([a.numpy()] * TILE) for a in rec._device_frontend(
        port_state(scene)))


@pytest.mark.parametrize("score", [True, False], ids=["kp_score", "no_kp_score"])
def test_tile_state_equals_the_jax_scripts_replace(scene, score):
    js, ts = scene["jstate"], port_state(scene)
    if not score:
        js = dc.replace(js, kp_score=None)
        ts.kp_score = None
    a, b = jax_tile(js, TILE), tmm.tile_state(ts, TILE)
    assert a.num_images == b.num_images == TILE * js.num_images
    for f in dc.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb or (va is None and vb is None), f.name


@time_limit(60)
def test_ungated_match_table_equals_jax(scene):
    jstate = jax_tile(scene["jstate"], TILE)
    JaxRec(jconfig.ReconstructorConfig(**KW), verbose=False).match_features(jstate, filter=False)
    tstate = tmm.tile_state(port_state(scene), TILE)
    TorchRec(TorchConfig(**KW), verbose=False, device="cpu").match_features(tstate, filter=False)
    assert len(jstate.matches) > 20
    assert sorted(jstate.matches) == sorted(tstate.matches)
    for k, m in jstate.matches.items():
        np.testing.assert_array_equal(m, tstate.matches[k], err_msg=str(k))
    # the tiled copies of a pair give its table
    n = scene["jstate"].num_images
    for (i, j), m in tstate.matches.items():
        if i % n < j % n:
            np.testing.assert_array_equal(m, tstate.matches[(i % n, j % n)])


@pytest.mark.parametrize("B", [16, 32])
@time_limit(60)
def test_decomposition_chunks_equal_jax(scene, tiled, B):
    """Gated chunks with the JAX keys' draws, and kNN-only chunks."""
    desc, mask, xy = tiled
    cfg = TorchConfig(**KW)
    H = cfg.fundamental_num_hypotheses
    pair_np = tdec.pairing.exhaustive_pairs(desc.shape[0])
    chunks = tdec.padded_chunks(pair_np, B, torch.device("cpu"))
    assert chunks[-1].shape[0] == B and not chunks[-1][-1].any()   # (0, 0)-padded
    keys = jax.random.split(jax.random.PRNGKey(tdec.DRAW_SEED), B)
    pos = t(np.stack([draws(k, (H, 8)) for k in keys]))
    gated = tdec.gated_chunks(t(desc), t(mask), t(xy), chunks, cfg, H, pos)
    knn = tdec.knn_chunks(t(desc), t(mask), chunks, cfg)
    inliers = differ = 0
    for c, (mi, cnt), (ki, km) in zip(chunks, gated, knn):
        mi_j, cnt_j = jgated.match_and_gate_jit(
            keys, jnp.asarray(desc), jnp.asarray(mask), jnp.asarray(xy), jnp.asarray(c.numpy()),
            ratio_thresh=cfg.ratio_thresh, cross_check=cfg.cross_check, use_fused=False,
            num_hypotheses=H, thresh_px=cfg.fundamental_thresh_px,
            min_matches=cfg.min_matches_for_filter, compute_dtype="float32")
        mi_j, cnt_j = np.asarray(mi_j), np.asarray(cnt_j)
        differ += int((mi_j != mi.numpy()).sum())
        assert np.abs(cnt_j - cnt.numpy()).max() <= 1
        inliers += int(cnt_j.sum())
        ki_j, km_j = jknn.match_all_pairs(jnp.asarray(desc), jnp.asarray(mask),
                                          jnp.asarray(c.numpy()), ratio_thresh=cfg.ratio_thresh,
                                          cross_check=cfg.cross_check)
        np.testing.assert_array_equal(np.asarray(km_j), km.numpy())
        np.testing.assert_array_equal(np.where(np.asarray(km_j), np.asarray(ki_j), -1),
                                      torch.where(km, ki, -1).numpy())
    assert inliers > 1000
    # the F-gate's float32 sums differ between the packages: at B=16 one
    # slot of pair (4, 5) sits on the inlier threshold (measured: 1 slot
    # of 1,352 inliers; B=32: none)
    assert differ <= inliers / 1000, (differ, inliers)


@time_limit(60)
def test_decompose_times_the_b256_cases_and_keeps_case_c(scene, tiled):
    """Cases A-D and F (E and G differ from A in B alone, which the chunk
    test above covers)."""
    cfg = TorchConfig(**KW)
    res = tdec.decompose(port_state(scene), cfg, "cpu", cases="ABCDF", reps=1, tile=TILE,
                         keep="C")
    assert list(res["cases"]) == ["A", "B", "C", "D", "F"]
    assert (res["imgs"], res["kt"], res["pairs"]) == (8, 256, 28)
    for c in res["cases"].values():
        assert np.isfinite(c["pairs_per_s"]) and c["min_s"] <= c["med_s"] <= c["max_s"]
    desc, mask, _ = tiled
    (mi, mm), = res["outputs"]["C"]
    ki, km = jknn.match_all_pairs(jnp.asarray(desc), jnp.asarray(mask),
                                  jnp.asarray(tdec.pairing.exhaustive_pairs(8)),
                                  ratio_thresh=cfg.ratio_thresh, cross_check=cfg.cross_check)
    np.testing.assert_array_equal(np.where(np.asarray(km), np.asarray(ki), -1),
                                  torch.where(mm, mi, -1).numpy()[:28])


@time_limit(60)
def test_measure_and_bench_on_the_tiled_state(scene):
    cfg = TorchConfig(**KW)
    res = tmm.measure(port_state(scene), cfg, "cpu", tile=TILE, reps=1)
    assert (res["n_pairs"], res["kt"]) == (28, 256)
    assert res["pairs_matched"] == res["pairs_matched_cold"] == len(res["state"].matches) > 20
    assert 0 < res["match100_warm_s"] and np.isfinite(res["match100_pairs_per_s"])
    out = tbk.bench(port_state(scene), cfg, "cpu", tile=TILE, reps=1)
    assert out["total_inliers_float32"] == out["total_inliers_bfloat16"] > 1000
    assert out["agreement_bf16_vs_f32"] == 1.0
    m32, m16 = out["matches"]["float32"], out["matches"]["bfloat16"]
    assert m32.keys() == m16.keys() and all((m32[k] == m16[k]).all() for k in m32)
    m32[(0, 1)] = np.where(m32[(0, 1)] >= 0, m32[(0, 1)] + 1, -1)
    assert tbk.agreement(m32, m16) < 1.0


@pytest.mark.parametrize("packed", [False, True], ids=["float", "packed"])
@time_limit(60)
def test_raw_knn_equals_pallas_interpret(scene, packed):
    st = port_state(scene)
    desc, kmask = np.tile(st.desc, (TILE, 1, 1)), np.tile(st.kp_mask, (TILE, 1))
    kts = ter.widths(kmask, min(ter.FULL_KT, desc.shape[1]))
    assert kts == [256, 256]
    B = 16
    res = ter.run(desc, kmask, kts[0], packed, "float32", B, "cpu", reps=1, keep=True)
    assert res["pairs_per_s"] > 0
    d, bias = ter.inputs(desc, kmask, kts[0], packed, "float32", torch.device("cpu"))
    chunks = tdec.padded_chunks(tdec.pairing.exhaustive_pairs(desc.shape[0]), B,
                                torch.device("cpu"))
    for c, out in zip(chunks, res["outputs"]):
        ref = pallas_knn._knn_topk2(jnp.asarray(d.numpy()), jnp.asarray(bias.numpy()),
                                    jnp.asarray(c.numpy()), interpret=True, packed=packed)
        best, second, arg, colarg = (np.asarray(r) for r in ref)
        np.testing.assert_array_equal(arg, out[2].numpy())
        np.testing.assert_array_equal(colarg, out[3].numpy())
        for a, b in ((best, out[0].numpy()), (second, out[1].numpy())):
            if packed:
                np.testing.assert_array_equal(a, b)
            else:
                fin = a < 1e29
                np.testing.assert_array_equal(fin, b < 1e29)
                np.testing.assert_allclose(a[fin], b[fin], atol=2e-6)


@pytest.mark.parametrize("name", SCRIPTS)
def test_main_needs_the_photographs_inside_the_checkout(tmp_path, monkeypatch, name):
    mod = importlib.import_module(f"reconstructor_tpu_torch.scripts.{name}")
    assert distill_fountain.DATA == os.path.join(REPO, "reference", "data")
    missing = str(tmp_path / "reference" / "data")
    monkeypatch.setattr(distill_fountain, "DATA", missing)
    with pytest.raises(SystemExit, match=re.escape(f"{missing} is missing")):
        mod.main(["--device", "cpu"])
    if name == "exp_quality":
        os.makedirs(missing)
        golden = str(tmp_path / "reference" / "cloud_fountain.ply")
        monkeypatch.setattr(distill_fountain, "GOLDEN", golden)
        with pytest.raises(SystemExit, match=re.escape(f"{golden} is missing")):
            mod.main(["default", "--device", "cpu"])
