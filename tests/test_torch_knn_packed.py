"""The packed-int32 top-2 kNN of the PyTorch port against the JAX package,
on the CPU.

``cuda_knn.knn_topk2_packed_plain`` (what ``knn_topk2(..., packed=True)``
runs for CPU tensors, and what ``csrc/knn_packed.cu`` is held against on
the card) is compared with ``pallas_knn._knn_topk2(packed=True)`` in
interpret mode. Distances are quantised to 2^-17 and packed with their
slot in one int32 key, masked slots carry ``_DMAX`` and a row with no
valid column reads 1e30. The kernel itself runs only on a card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from reconstructor_tpu.matching import pallas_knn
from reconstructor_tpu_torch.matching import cuda_knn
from reconstructor_tpu_torch.scripts import check_packed
from reconstructor_tpu_torch.utils import cuda_build

from torch_parity import t

STEP = 2.0 ** -17


def exact(rng, shape):
    """k/32 values with |k| <= 4: every dot product over 128 channels is
    exact in float32, so both packages quantise the same distances."""
    return rng.integers(-4, 5, shape).astype(np.float32) / 32.0


def case_ragged_masks():
    rng = np.random.default_rng(21)
    desc = exact(rng, (4, 256, 128))
    mask = np.zeros((4, 256), bool)
    for n, count in enumerate((256, 200, 131, 77)):
        mask[n, :count] = True
    return desc, mask, np.array([[0, 1], [1, 2], [2, 3], [3, 0], [1, 1]], np.int32)


def case_fully_masked():
    rng = np.random.default_rng(22)
    mask = np.zeros((2, 128), bool)
    mask[0] = True
    return exact(rng, (2, 128, 128)), mask, np.array([[0, 1], [1, 0]], np.int32)


def case_lone_valid_column():
    rng = np.random.default_rng(23)
    desc = exact(rng, (2, 128, 128))
    desc[1, 0] = desc[0, 5]
    mask = np.zeros((2, 128), bool)
    mask[0] = True
    mask[1, 0] = True
    return desc, mask, np.array([[0, 1]], np.int32)


def case_exact_ties():
    """Duplicated rows make exact distance ties: the lowest slot wins rows
    and columns."""
    rng = np.random.default_rng(24)
    q = exact(rng, (64, 128))
    desc = np.stack([np.concatenate([q, q]), np.concatenate([q[::-1], q])])
    mask = np.ones((2, 128), bool)
    mask[1, 100:110] = False
    return desc, mask, np.array([[0, 1], [1, 0], [0, 0]], np.int32)


def case_k384():
    rng = np.random.default_rng(25)
    base = exact(rng, (384, 128))
    noise = rng.integers(-1, 2, (2, 384, 128)).astype(np.float32) / 32.0
    return base[None] + noise, np.ones((2, 384), bool), np.array([[0, 1], [1, 0]], np.int32)


CASES = {"ragged_masks": case_ragged_masks, "fully_masked": case_fully_masked,
         "lone_valid_column": case_lone_valid_column, "exact_ties": case_exact_ties,
         "k384": case_k384}


def packed_bias(mask):
    return np.where(mask, 0, pallas_knn._DMAX).astype(np.int32)


def both(desc, mask, pairs):
    bias = packed_bias(mask)
    out_j = pallas_knn._knn_topk2(jnp.asarray(desc), jnp.asarray(bias), jnp.asarray(pairs),
                                  interpret=True, packed=True)
    out_t = cuda_knn.knn_topk2(t(desc), t(bias), t(pairs), packed=True)
    return [np.asarray(a) for a in out_j], [b.numpy() for b in out_t]


@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_plain_equals_pallas_interpret(name):
    desc, mask, pairs = CASES[name]()
    out_j, out_t = both(desc, mask, pairs)
    for a, b, what in zip(out_j, out_t, ("best", "second", "arg", "colarg")):
        np.testing.assert_array_equal(a, b, err_msg=what)
    best, second, arg, colarg = out_t
    if name == "fully_masked":
        assert (best[0] == 1e30).all() and (second[0] == 1e30).all()
    if name == "lone_valid_column":
        # one valid column: second best is the sentinel, so the ratio test
        # passes, and the column's best row is the planted duplicate
        assert second[0, 5] == np.float32(1e30)
        assert best[0, 5] < 0.49 * second[0, 5]
        assert arg[0, 5] == 0 and colarg[0, 0] == 5


def test_random_unit_descriptors_agree():
    """Random unit descriptors: the two packages sum the 128 products in
    other orders, which can move a distance across one 2^-17 step, so
    distances agree within one step and the argmins on >= 99.9% of rows."""
    rng = np.random.default_rng(26)
    desc = rng.standard_normal((5, 512, 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    mask = rng.uniform(size=(5, 512)) < 0.85
    pairs = np.array([[0, 1], [2, 3], [4, 0], [1, 3]], np.int32)
    (bj, sj, aj, cj), (bt, st, at, ct) = both(desc, mask, pairs)
    for a, b in ((bj, bt), (sj, st)):
        np.testing.assert_array_equal(a >= 1e29, b >= 1e29)
        fin = b < 1e29
        assert np.abs(a - b)[fin].max() <= STEP
    rows = mask[pairs[:, 0]]
    assert (aj == at)[rows].mean() >= 0.999
    assert (cj == ct)[mask[pairs[:, 1]]].mean() >= 0.999


def test_check_packed_on_the_plain_versions():
    """The port's check_packed on the CPU (both kernels' plain versions):
    the packed outputs agree with the float ones at the rates the card run
    requires (argmins on >= 99.9%, best within one 2^-17 step plus 1e-6,
    the sentinel everywhere), and its float32 figures are the JAX
    package's on the same inputs (packed against float, both in interpret
    mode)."""
    out = check_packed.main(["--device", "cpu"])
    assert out["device"] == "cpu"
    for dt in ("float32", "bfloat16"):
        assert out[f"{dt}_arg_agree"] >= 0.999
        assert out[f"{dt}_colarg_agree"] >= 0.999
        assert out[f"{dt}_best_maxerr"] <= STEP + 1e-6
        assert out[f"{dt}_sentinel_agree"] == 1.0
    desc, mask, pidx = check_packed.inputs()
    args = [jnp.asarray(x) for x in (desc, packed_bias(mask), pidx)]
    packed = pallas_knn._knn_topk2(*args, interpret=True, packed=True)
    args[1] = jnp.asarray(np.where(mask, 0.0, pallas_knn._BIG).astype(np.float32))
    flt = pallas_knn._knn_topk2(*args, interpret=True, packed=False)
    want = check_packed.compare([torch.from_numpy(np.asarray(x)) for x in packed],
                                [torch.from_numpy(np.asarray(x)) for x in flt])
    for k, v in want.items():
        assert out[f"float32_{k}"] == pytest.approx(v, abs=1e-12), k


def test_wrapper_refuses_what_the_kernel_cannot_take():
    """Twelve bits hold the slot (K <= 4096), and the packed kernel's bias
    is int32 (0 / _DMAX): a float bias is refused, as is an int32 bias on
    the float kernel. A CPU tensor, float32 or bfloat16, takes the plain
    version and is not counted as a launch."""
    desc, mask, pairs = case_fully_masked()
    with pytest.raises(ValueError, match="bias"):
        cuda_knn.knn_topk2(t(desc), t(np.where(mask, 0.0, 1e30).astype(np.float32)), t(pairs),
                           packed=True)
    with pytest.raises(ValueError, match="bias"):
        cuda_knn.knn_topk2(t(desc), t(packed_bias(mask)), t(pairs))
    big = torch.zeros((1, 4096 + 128, 128))
    with pytest.raises(ValueError, match="4096"):
        cuda_knn.knn_topk2(big, torch.zeros((1, 4096 + 128), dtype=torch.int32),
                           torch.zeros((1, 2), dtype=torch.int32), packed=True)
    before = cuda_build.launches()
    for dtype in (torch.float32, torch.bfloat16):
        cuda_knn.knn_topk2(t(desc).to(dtype), t(packed_bias(mask)), t(pairs), packed=True)
    assert cuda_build.launches() == before


def test_fused_matcher_keeps_the_packed_kernel_off():
    """As in the JAX package (pallas_knn.py:247), the matcher runs the
    float kernel: its matches equal the JAX fused matcher's."""
    desc, mask, pairs = case_ragged_masks()
    fi, fm = pallas_knn.match_all_pairs_fused(jnp.asarray(desc), jnp.asarray(mask),
                                              jnp.asarray(pairs), interpret=True)
    before = cuda_build.launches()
    ti, tm = cuda_knn.match_all_pairs_fused(t(desc), t(mask), t(pairs))
    np.testing.assert_array_equal(np.asarray(fi), ti.numpy())
    np.testing.assert_array_equal(np.asarray(fm), tm.numpy())
    after = cuda_build.launches()
    assert all(after[k] == before[k] for k in ("knn_packed_launch", "knn_packed_launch_bf16"))


def test_packed_column_extents_use_the_int32_rule():
    """The bf16 packed kernel skips the column tiles past each image's last
    valid slot, from ``column_extents(bias, valid_below=_DMAX)``: a slot is
    valid when its int32 bias is below ``_DMAX``. The float kernel's rule
    (bias below 1e30 / 2) would count every int32 slot valid, 0 and
    ``_DMAX`` alike, and give K for every image."""
    K = 256
    mask = np.zeros((6, K), bool)
    for n, count in enumerate((200, 1, 0, 70, 129)):
        mask[n, :count] = True
    mask[5, :150] = True
    mask[5, 40:90] = False                       # a hole
    mask[5, 200] = True                          # a lone valid slot past it
    bias = t(packed_bias(mask))
    ext = cuda_knn.column_extents(bias, valid_below=cuda_knn._DMAX).numpy()
    np.testing.assert_array_equal(ext, [200, 1, 0, 70, 129, 201])
    assert ext.dtype == np.int32
    np.testing.assert_array_equal(cuda_knn.column_extents(bias).numpy(), [K] * 6)
