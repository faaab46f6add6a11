"""The port's profiling hooks and stage profiler, on the CPU.

``utils/profiling.trace`` / ``annotate`` write a Chrome trace that holds
the annotation names; ``stage_summary`` is checked on a hand-made trace
with device events (a CPU run records none); and
``scripts/profile_incremental`` profiles a small rendered scene with the
same result as an unprofiled run.
"""

import json
import os

import numpy as np
import pytest
import torch

from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.eval import render
from reconstructor_tpu_torch.io import images as io_images
from reconstructor_tpu_torch.scripts import profile_incremental
from reconstructor_tpu_torch.utils import profiling

import torch_parity  # noqa: F401  (sets the worker's torch thread count)


def test_trace_holds_the_annotations(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu"):
        with profiling.annotate("alpha"):
            x = torch.randn(64, 64)
            x = x @ x
        with profiling.annotate("beta"):
            (x + 1).sum()
    path = tmp_path / profiling.TRACE_FILE
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"alpha", "beta"} <= names
    s = profiling.stage_summary(str(path), ["alpha", "beta", "gamma"])
    assert s["alpha"]["windows"] == 1 and s["beta"]["windows"] == 1
    assert s["gamma"]["windows"] == 0 and s["gamma"]["wall_s"] == 0.0
    assert s["alpha"]["wall_s"] > 0
    # a CPU trace has no device events: busy time is not measured
    assert s["alpha"]["busy_s"] is None and s["alpha"]["launches"] == 0
    assert profiling.busy_share(s["alpha"]) is None


def test_trace_disabled_writes_nothing(tmp_path):
    with profiling.trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not os.path.exists(tmp_path / "off")


def test_stage_summary_clips_device_time_to_the_windows(tmp_path):
    """Device intervals are merged (overlaps count once), clipped to each
    name's windows, and launches counted where their host call falls."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "stage", "ts": 100.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "stage", "ts": 300.0, "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "name": "other", "ts": 400.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 90.0, "dur": 30.0},      # 20 inside
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 110.0, "dur": 20.0},     # overlaps k1
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 150.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 340.0, "dur": 30.0},  # 10 in
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 420.0, "dur": 10.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 105.0, "dur": 2.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 106.0, "dur": 2.0},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 310.0, "dur": 2.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 410.0, "dur": 2.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "stage", "ts": 0.0, "dur": 1e6},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = profiling.stage_summary(str(path), ["stage", "other"])
    st = s["stage"]
    assert st["windows"] == 2
    assert st["wall_s"] == pytest.approx(150e-6)
    # k1 + k2 merged: [100, 130) inside -> 30; memcpy 10; memset [340, 350) -> 10
    assert st["busy_s"] == pytest.approx(50e-6)
    assert st["launches"] == 2
    assert profiling.busy_share(st) == pytest.approx(50 / 150)
    assert s["other"]["busy_s"] == pytest.approx(10e-6) and s["other"]["launches"] == 1
    assert s["all"]["busy_s"] == pytest.approx(((130 - 90) + 10 + 30 + 10) * 1e-6)
    assert s["all"]["launches"] == 3
    # kernel time inside the windows, by name: k1 [100, 120), k2 [110, 130)
    assert [k for k, _ in st["top_kernels"]] == ["k1", "k2"]
    assert [v for _, v in st["top_kernels"]] == pytest.approx([20e-6, 20e-6])
    assert s["other"]["top_kernels"] == [["k2", pytest.approx(10e-6)]]



def test_stage_summary_attributes_device_time_to_launches(tmp_path):
    """``launched_busy_s`` counts the device events whose runtime call
    (same correlation id) starts inside the windows, whole, wherever the
    card's timestamps put them: a kernel traced before its launch (the
    two clocks drifted) still counts, where the clipped ``busy_s`` loses
    it; a kernel launched outside the windows does not count, though it
    runs inside one."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "call", "ts": 100.0, "dur": 20.0},
        {"ph": "X", "cat": "user_annotation", "name": "call", "ts": 200.0, "dur": 20.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 102.0, "dur": 3.0,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 60.0, "dur": 2.0,
         "args": {"correlation": 1}},                                   # drifted 40 early
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 202.0, "dur": 3.0,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 207.0, "dur": 2.0,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemsetAsync", "ts": 203.0, "dur": 1.0,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 208.0, "dur": 4.0,
         "args": {"correlation": 3}},                                   # overlaps k: once
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 150.0, "dur": 3.0,
         "args": {"correlation": 4}},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 210.0, "dur": 5.0,
         "args": {"correlation": 4}},                                   # launched outside
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    st = profiling.stage_summary(str(path), ["call"])["call"]
    assert st["launches"] == 2
    # k [207, 209) + memset [208, 212) -> 5; the drifted k -> 2
    assert st["launched_busy_s"] == pytest.approx(7e-6)
    assert st["launched_kernels"] == [["k", pytest.approx(4e-6)]]
    # clipped: [207, 215) from k, memset and "late"; the drifted k is lost
    assert st["busy_s"] == pytest.approx(8e-6)
    assert [k for k, _ in st["top_kernels"]] == ["late", "k"]

@pytest.fixture(scope="module")
def small_scene():
    sc = render.make_scene(seed=0, n_views=5, h=192, w=256, n_blobs=200, tex_size=512,
                           focal_px=1.2 * 256)
    return [io_images.from_rgb(np.repeat((im * 255).astype(np.uint8)[..., None], 3, -1))
            for im in sc["images"]]


def test_profile_incremental_matches_an_unprofiled_run(small_scene, tmp_path):
    """Five 192x256 views: the profiled run registers what an unprofiled
    run of the same views and seed registers (and the same landmarks), and
    the report lists every stage with its calls; on the CPU no device time
    is reported."""
    cfg = ReconstructorConfig(max_keypoints=256, ransac_num_hypotheses=256,
                              pnp_num_hypotheses=256, fundamental_num_hypotheses=128,
                              final_refinement_rounds=1)
    rep = profile_incremental.profile(small_scene, cfg, str(tmp_path), device="cpu")
    plain = profile_incremental.unprofiled(small_scene, cfg, device="cpu")
    assert rep["registered"] == plain["registered"] == 5
    assert rep["landmarks"] == plain["landmarks"]
    assert set(rep["stages"]) == set(profile_incremental.STAGES)
    for name in ("match_features", "choose_initial_pair", "triangulate_initial_pair",
                 "add_next_view", "check_landmark_validity", "bundle_adjust",
                 "remove_landmarks", "complete_tracks"):
        assert rep["stages"][name]["calls"] >= 1, name
        assert rep["stages"][name]["busy_s"] is None
    assert rep["stages"]["add_next_view"]["calls"] == 3
    text = open(tmp_path / "profile_incremental.txt").read()
    assert "choose_initial_pair" in text and "cumulative" in text
    assert os.path.exists(rep["trace"])
    # without the trace: the same run, ticks only, nothing device-side
    bare = profile_incremental.profile(small_scene, cfg, str(tmp_path / "bare"), device="cpu",
                                       trace=False)
    assert (bare["registered"], bare["landmarks"]) == (rep["registered"], rep["landmarks"])
    assert bare["trace"] is None and not os.path.exists(tmp_path / "bare" / "trace.json")
    assert all(st["launches"] is None for st in bare["stages"].values())
    assert "not measured" in profile_incremental.format_report(bare)


def test_profile_incremental_cli_repeats_in_one_process(tmp_path):
    """The entry point on a folder, on the CPU, twice in one process
    without the trace: each run writes its own report, and both give the
    same reconstruction (a new reconstructor, the same seed)."""
    from PIL import Image
    sc = render.make_scene(seed=0, n_views=4, h=192, w=256, n_blobs=200, tex_size=512,
                           focal_px=1.2 * 256)
    folder = tmp_path / "views"
    folder.mkdir()
    for i, im in enumerate(sc["images"]):
        Image.fromarray((im * 255).astype(np.uint8)).convert("RGB").save(
            str(folder / f"{i:02d}.png"))
    out = tmp_path / "prof"
    rep = profile_incremental.main([str(folder), "--device", "cpu", "--max-views", "4",
                                    "--repeat", "2", "--no-trace", "--out", str(out)])
    assert rep["views"] == 4 and rep["registered"] == 4
    first = open(out / "run1" / "profile_incremental.txt").read().splitlines()[0]
    second = open(out / "run2" / "profile_incremental.txt").read().splitlines()[0]
    assert first == second            # device, views, registered and landmarks
    assert not (out / "run1" / "trace.json").exists()
