"""The level-by-level kNN of the port's profiling script against the TPU
package's script, on the CPU.

``reconstructor_tpu_torch.scripts.profile_knn_kernel.run_plain`` (what
``run`` computes for CPU tensors, and what ``scripts/csrc/knn_levels.cu``
is held against on the card) is compared at every level with the JAX
script's ``run(..., interpret=True)``. The script lives outside the JAX
package (``scripts/profile_knn_kernel.py``), so it is loaded from its file;
it puts the repository on ``sys.path`` when it runs, which is undone.
"""

import importlib.util
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from reconstructor_tpu.matching import pallas_knn
from reconstructor_tpu_torch.matching import cuda_knn
from reconstructor_tpu_torch.scripts import profile_knn_kernel as pk
from reconstructor_tpu_torch.utils import cuda_build

from torch_parity import t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = 2.0 ** -17


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_profile_knn_kernel", os.path.join(REPO, "scripts", "profile_knn_kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


def inputs(kind):
    """N=3, K=256, D=128. ``unit``: unit descriptors; ``unnormalised``: the
    script's own standard normals, on which max(2 - 2 sim, 0) clips most
    rows' best to 0, so the lowest-index tie rule decides the argmins."""
    rng = np.random.default_rng(31)
    desc = rng.standard_normal((3, 256, 128)).astype(np.float32)
    if kind == "unit":
        desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return desc, np.array([[0, 1], [1, 2], [2, 0], [1, 1]], np.int32)


@pytest.mark.parametrize("kind", ["unit", "unnormalised"])
@pytest.mark.parametrize("level", pk.LEVELS, ids=str)
def test_levels_equal_the_jax_script(jax_script, level, kind):
    """Index outputs equal. Distances: the float levels within a few
    float32 ulps of their scale (the 128 products are summed in another
    order), the packed level within one 2^-17 step."""
    desc, pairs = inputs(kind)
    out_j = jax_script.run(jnp.asarray(desc), jnp.swapaxes(jnp.asarray(desc), 1, 2),
                           jnp.asarray(pairs), level, interpret=True)
    out_j = [np.asarray(x)[:, 0] for x in out_j]
    out_t = [x.numpy() for x in pk.run(t(desc), t(pairs), level)]
    np.testing.assert_array_equal(out_j[2], out_t[2], err_msg="arg")
    np.testing.assert_array_equal(out_j[3], out_t[3], err_msg="colarg")
    scale = float(np.abs(out_j[0]).max()) + float(np.abs(out_j[1]).max()) + 1.0
    atol = STEP if level == "packed" else 8 * np.finfo(np.float32).eps * scale
    for a, b, what in zip(out_j[:2], out_t[:2], ("best", "second")):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=what)
    if kind == "unnormalised":
        assert (out_t[0] == 0).mean() > 0.9     # the saturation the script's inputs have


def test_level3_is_the_top2_kernel_with_zero_bias():
    """Level 3 is knn_topk2_plain with a zero bias, and that is the JAX
    package's float kernel with zero bias (interpret mode)."""
    desc, pairs = inputs("unit")
    zero = np.zeros(desc.shape[:2], np.float32)
    lvl = pk.run_plain(t(desc), t(pairs), 3)
    top2 = cuda_knn.knn_topk2_plain(t(desc), t(zero), t(pairs))
    jx = pallas_knn._knn_topk2(jnp.asarray(desc), jnp.asarray(zero), jnp.asarray(pairs),
                               interpret=True, packed=False)
    for a, b, c in zip(lvl, top2, jx):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy()[:, :], np.asarray(c))


def test_run_contract():
    desc, pairs = inputs("unit")
    before = cuda_build.launches()
    pk.run(t(desc), t(pairs), 0)
    assert cuda_build.launches() == before      # the plain version is not counted
    with pytest.raises(ValueError, match="level"):
        pk.run(t(desc), t(pairs), 5)
    with pytest.raises(ValueError, match="4096"):
        pk.run(torch.zeros((1, 4224, 128)), torch.zeros((1, 2), dtype=torch.int32), "packed")


def test_main_sweep_on_the_cpu():
    """The entry point with ``--device cpu`` at a small size: every tag of
    the quick sweep, keyed as the TPU script keys them (without its _TR
    suffix), times from the host clock and the device named."""
    out = pk.main(["--device", "cpu", "--quick", "--keypoints", "256", "--pairs", "4"])
    assert out["device"] == "cpu"
    for name in ("full", "packed"):
        assert out[f"bfloat16_K256_{name}_ms_per_pair"] > 0
        assert out[f"bfloat16_K256_{name}_pairs_per_s"] > 0
    assert not any("_TR" in k for k in out)
