"""The port runs where neither JAX, nor the JAX package, nor PIL exists.

A fresh interpreter blocks ``jax``, ``reconstructor_tpu`` and ``PIL``
(and, where it imports every module, ``optax``: ``sys.modules[name] =
None`` makes any import of them fail), imports
every module of ``reconstructor_tpu_torch`` and ``chip_smoke`` (without
running it), then runs the CPU end-to-end slice on a tiny rendered scene
through the same entry points ``chip_smoke.py`` drives on the card: the
default path, and in a second interpreter the learned path (SuperPoint
from ``tests/data/superpoint_synth.npz``, the structured SuperGlue).
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "optax", "reconstructor_tpu", "PIL"):
    sys.modules[name] = None
import importlib, json, pkgutil
import numpy as np
import reconstructor_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(reconstructor_tpu_torch.__path__,
                                              "reconstructor_tpu_torch.")
        if not m.name.endswith("__main__")]        # that one runs the CLI
for m in mods:
    importlib.import_module(m)
import chip_smoke  # noqa: F401  (module import only)
import torch.distributed as dist
group_at_import = dist.is_initialized()
from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.eval import render, synth
from reconstructor_tpu_torch.io import images as io_images
from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
sc = render.make_scene(seed=0, n_views=5, h=192, w=256, n_blobs=200, tex_size=512,
                       focal_px=1.2 * 256)
imgs = [io_images.from_rgb(np.repeat((im * 255).astype(np.uint8)[..., None], 3, -1))
        for im in sc["images"]]
cfg = ReconstructorConfig(max_keypoints=256, ransac_num_hypotheses=256,
                          pnp_num_hypotheses=256, fundamental_num_hypotheses=128,
                          final_refinement_rounds=1)
rec = IncrementalReconstructor(cfg, verbose=False, device="cpu")
state = rec.reconstruct_from_state(rec.detect_features_from_images(imgs))
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "optax", "reconstructor_tpu", "PIL")
                and sys.modules[k] is not None)
print(json.dumps({"modules": len(mods), "module_names": mods, "group_at_import": group_at_import,
                  "registered": len(state.registered),
                  "landmarks": int(state.num_landmarks), "leaked": leaked,
                  "ate": synth.pose_ate(state.poses, sc["poses"])["ate_rmse_normalized"]}))
"""


LEARNED = r"""
import sys
for name in ("jax", "jaxlib", "reconstructor_tpu", "PIL"):
    sys.modules[name] = None
import json
import numpy as np
from reconstructor_tpu_torch.config import ReconstructorConfig
from reconstructor_tpu_torch.eval import render, synth
from reconstructor_tpu_torch.io import images as io_images
from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
sc = render.make_scene(seed=21, n_views=6, h=160, w=160)
imgs = [io_images.from_rgb(np.repeat((im * 255).astype(np.uint8)[..., None], 3, -1))
        for im in sc["images"]]
cfg = ReconstructorConfig(detector="superpoint", matcher="superglue",
                          superpoint_weights="tests/data/superpoint_synth.npz",
                          superglue_weights="structured", max_keypoints=256, focal_px=170.0,
                          superglue_sinkhorn_iters=20, ransac_num_hypotheses=256,
                          pnp_num_hypotheses=256, fundamental_num_hypotheses=128,
                          ba_local_window=0, final_refinement_rounds=1)
rec = IncrementalReconstructor(cfg, verbose=False, device="cpu")
state = rec.reconstruct_from_state(rec.detect_features_from_images(imgs))
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "reconstructor_tpu", "PIL")
                and sys.modules[k] is not None)
print(json.dumps({"registered": len(state.registered), "landmarks": int(state.num_landmarks),
                  "leaked": leaked,
                  "ate": synth.pose_ate(state.poses, sc["poses"])["ate_rmse_normalized"]}))
"""


NATIVE_DECODE = r"""
import sys
for name in ("jax", "jaxlib", "reconstructor_tpu", "PIL"):
    sys.modules[name] = None
import json
from reconstructor_tpu_torch.io import images as io_images, native
imgs = io_images.load_folder(sys.argv[1], 512)
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "reconstructor_tpu", "PIL")
                and sys.modules[k] is not None)
print(json.dumps({"native": native.available(), "shapes": [list(i.shape) for i in imgs],
                  "downscale": [i.downscale for i in imgs], "leaked": leaked}))
"""


def test_native_folder_decode_without_jax_pil_or_the_jax_package(tmp_path):
    """A JPEG folder decodes through the native loader in an interpreter
    with jax, the JAX package and PIL blocked (the card machine has none of
    them); skipped where the native library does not load."""
    from reconstructor_tpu_torch.io import native
    if not native.available():
        pytest.skip("native/libreconstructor_native.so does not load here")
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(3)
    for i in range(2):
        im = rng.integers(0, 256, (300, 400, 3)).astype(np.uint8)
        Image.fromarray(im).save(str(tmp_path / f"{i}.jpg"), quality=85)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", NATIVE_DECODE, str(tmp_path)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"native": True, "shapes": [[300, 400], [300, 400]],
                   "downscale": [1.0, 1.0], "leaked": []}


def test_learned_path_runs_without_jax_pil_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", LEARNED], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    # 6 views of test_learned_e2e's scene at 256 keypoints: measured 6/6,
    # 119 landmarks, 7.5% normalised ATE; the learned path's 10% bar
    assert res["registered"] == 6
    assert res["landmarks"] > 60
    assert res["ate"] < 0.10


def test_port_runs_without_jax_pil_or_the_jax_package():
    # two torch threads, as in the other parity tests (six pytest workers)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["modules"] >= 25
    assert res["leaked"] == []
    # the multi-device modules import without JAX and join no process group
    assert {"reconstructor_tpu_torch.parallel.mesh", "reconstructor_tpu_torch.parallel.sharding",
            "reconstructor_tpu_torch.scripts.multiproc_worker",
            "reconstructor_tpu_torch.scripts.run_multiproc_dryrun"} <= set(res["module_names"])
    # the fixed-order segment sums and the stress and BA scripts too
    assert {"reconstructor_tpu_torch.ba.cuda_segsum", "reconstructor_tpu_torch.ba.cuda_schur",
            "reconstructor_tpu_torch.scripts.stress_synth",
            "reconstructor_tpu_torch.scripts.stress_report",
            "reconstructor_tpu_torch.scripts.exp_ba", "reconstructor_tpu_torch.scripts.profile_ba",
            "reconstructor_tpu_torch.scripts.profile_ba_latency",
            "reconstructor_tpu_torch.scripts.profile_pcg_path"} <= set(res["module_names"])
    # the training, BA-variant and rank-scaling scripts, with optax blocked too
    assert {"reconstructor_tpu_torch.scripts.train_frontend",
            "reconstructor_tpu_torch.scripts.check_ba_variants",
            "reconstructor_tpu_torch.scripts.bench_scaling",
            "reconstructor_tpu_torch.scripts.diag_scaling"} <= set(res["module_names"])
    assert res["group_at_import"] is False
    # 5 rendered views, 256 keypoints: every view registers (measured
    # 5/5, 125 landmarks, 5.8% normalised ATE); bound the ATE at 15%
    assert res["registered"] == 5
    assert res["landmarks"] > 50
    assert res["ate"] < 0.15


def test_sources_import_no_jax():
    """No module of the port or the smoke script names jax, the JAX
    package or PIL at import level (PIL is allowed inside the function that
    decodes files and inside the drawing functions of ``utils/viz.py``)."""
    import ast
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "reconstructor_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "optax", "reconstructor_tpu"), (path, n)
                if top == "PIL":
                    assert path.endswith((os.path.join("io", "images.py"),
                                          os.path.join("utils", "viz.py"))), path
                    assert node.col_offset > 0, (path, "PIL imported at module level")
