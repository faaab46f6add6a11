"""The port's BA quality sweep (``scripts/exp_quality.py``) against the
JAX package's on the CPU, on ``test_integration``'s rendered views (4
views of 256x320, ``max_keypoints=256``).

Both packages run the variants ``default`` and ``noretri``: the JAX
script's ``main()`` with ``detect_features``, its config and the golden
path patched to the rendered views, the port's ``sweep`` on its own
detection and matching of the same folder. RANSAC draws differ between
the packages (JAX keys, a torch generator), so the runs are compared by
their statistics, as ``test_torch_pipeline`` compares the drivers: equal
registered counts, every view, and each package's normalised ATE against
the golden cloud of the true centres under 10% (that test's bound on
these views).
"""

import functools
import importlib.util
import json
import os


from reconstructor_tpu import config as jconfig
from reconstructor_tpu.eval import ate as jate
from reconstructor_tpu.pipeline.incremental import IncrementalReconstructor as JaxRec
from reconstructor_tpu_torch.config import ReconstructorConfig as TorchConfig
from reconstructor_tpu_torch.io import images as io_images
from reconstructor_tpu_torch.scripts import exp_quality as teq

from torch_parity import MEASURE_KW, rendered_folder, time_limit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATE_BOUND = 0.10
# one final refinement round of the default six: the variants' BA settings
# still apply to every round, at a sixth of the JAX package's solves
KW = dict(MEASURE_KW, final_refinement_rounds=1)


def jax_script(name):
    """A root ``scripts/*.py`` module of the JAX package, from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@time_limit(120)
def test_quality_sweep_matches_jax(tmp_path, monkeypatch, capsys):
    """Both packages' ``default`` and ``noretri`` on the rendered views."""
    folder, golden, _ = rendered_folder(tmp_path)
    jeq = jax_script("exp_quality")
    orig = JaxRec.detect_features
    monkeypatch.setattr(JaxRec, "detect_features",
                        lambda self, _: orig(self, folder))
    monkeypatch.setattr(jconfig, "ReconstructorConfig",
                        functools.partial(jconfig.ReconstructorConfig, **KW))
    orig_ate = jate.ate_vs_golden
    monkeypatch.setattr(jate, "ate_vs_golden", lambda c, path: orig_ate(c, golden))
    monkeypatch.setattr("sys.argv", ["exp_quality.py", "default,noretri"])
    jeq.main()
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{\"")]
    jres = {k: v for ln in lines for k, v in ln.items()}
    cfg = TorchConfig(**KW)
    state0 = teq.matched_state(io_images.load_folder(folder, cfg.img_max_size), cfg,
                               "cpu")
    tres = teq.sweep(state0, cfg, golden, "cpu", variants="default,noretri")
    assert list(jres) == list(tres) == ["default", "noretri"]
    for name in tres:
        assert "error" not in jres[name], jres[name]
        assert jres[name]["registered"] == tres[name]["registered"] == 4
        assert jres[name]["ate_norm"] < ATE_BOUND and tres[name]["ate_norm"] < ATE_BOUND, \
            (name, jres[name], tres[name])
        assert tres[name]["landmarks"] > 50
        assert tres[name]["observations"] >= 2 * tres[name]["landmarks"]


