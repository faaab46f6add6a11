"""The port's multi-process run: ``reconstructor_tpu_torch/scripts/
run_multiproc_dryrun.py`` starts 2 CPU ranks joined by gloo, each runs
sharded gated matching and ``solve_distributed`` (the TPU package's
worker loads) and then the driver with ``mesh=`` on 5 rendered views, and
the merged report must say both ranks reached the same replicated result. The counterpart of ``tests/test_multiprocess.py``; the
ranks import no JAX (the worker imports none)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.multiprocess
def test_two_process_distributed_dryrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "reconstructor_tpu_torch.scripts.run_multiproc_dryrun", "2",
         "--device", "cpu", "--timeout", "240"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    assert rep["ok"] and rep["n_processes"] == 2 and rep["backend"] == "gloo"
    w0, w1 = rep["workers"]
    assert (w0["rank"], w1["rank"]) == (0, 1)
    # the collectives crossed the process boundary: both ranks hold the
    # same replicated solve, match table and generator state
    for key in ("ba_cost_final", "ba_state_sha256", "match_table_sha256", "generator_sha256",
                "driver_sha256", "all_reduces"):
        assert w0[key] == w1[key], key
    assert w0["ba_cost_final"] < w0["ba_cost_initial"] / 100
    assert w0["match_table_shape"] == [300, 512] and w0["matched"] > 0
    assert w0["driver_registered"] == 5 and w0["driver_landmarks"] > 0
    assert os.listdir(tmp_path) == []        # the runner writes no file
