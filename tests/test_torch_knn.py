"""kNN matching of the PyTorch port against the JAX package, on the CPU.

The port's plain matcher (``matching/knn.py``) is held against
``reconstructor_tpu.matching.knn``; the CUDA kernel's module
(``matching/cuda_knn.py``, which runs its plain version for CPU tensors)
is held against the Pallas kernel in interpret mode, on the cases of
``tests/test_pallas_kernels.py`` and on exact ties. All comparisons are
float32 and index for index. The kernel itself runs only on a card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from reconstructor_tpu.matching import knn as jknn
from reconstructor_tpu.matching import pallas_knn
from reconstructor_tpu_torch.matching import cuda_knn, knn as tknn
from reconstructor_tpu_torch.utils import cuda_build

from torch_parity import t


def unit(rng, shape):
    d = rng.standard_normal(shape).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def case_random_pairs():
    rng = np.random.default_rng(11)
    desc = unit(rng, (5, 256, 128))
    mask = rng.uniform(size=(5, 256)) < 0.8
    return desc, mask, np.array([[0, 1], [2, 3], [1, 4], [3, 0]], np.int32), 0.8


def case_fully_masked():
    rng = np.random.default_rng(12)
    desc = rng.standard_normal((2, 128, 128)).astype(np.float32)
    mask = np.zeros((2, 128), bool)
    mask[0] = True
    return desc, mask, np.array([[0, 1]], np.int32), 0.7


def case_k384():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((384, 128)).astype(np.float32)
    desc = np.stack([base + 0.1 * rng.standard_normal((384, 128)).astype(np.float32)
                     for _ in range(2)])
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return desc, np.ones((2, 384), bool), np.array([[0, 1]], np.int32), 0.7


def case_lone_valid_column():
    rng = np.random.default_rng(13)
    desc = unit(rng, (2, 128, 128))
    desc[1, 0] = desc[0, 5]
    mask = np.zeros((2, 128), bool)
    mask[0] = True
    mask[1, 0] = True
    return desc, mask, np.array([[0, 1]], np.int32), 0.7


def case_exact_ties():
    """Descriptors k/32 with small integer k: every dot product is exact in
    float32, duplicated rows make exact distance ties, so the
    lowest-index rule decides rows and columns."""
    rng = np.random.default_rng(14)
    q = rng.integers(-4, 5, (64, 128)).astype(np.float32) / 32.0
    desc = np.stack([np.concatenate([q, q]), np.concatenate([q[::-1], q])])
    mask = np.ones((2, 128), bool)
    mask[1, 100:110] = False
    return desc, mask, np.array([[0, 1], [1, 0], [0, 0]], np.int32), 0.7


def case_superpoint_width():
    """SuperPoint's 256-wide descriptors (the learned detector with the
    kNN matcher), which the kernel takes as two 128-wide slices."""
    rng = np.random.default_rng(15)
    base = unit(rng, (300, 256))
    desc = np.zeros((3, 256, 256), np.float32)
    mask = np.zeros((3, 256), bool)
    for n, count in enumerate((256, 230, 180)):
        d = base[rng.choice(300, count, replace=False)]
        d = d + 0.1 * rng.standard_normal(d.shape).astype(np.float32)
        desc[n, :count] = d / np.linalg.norm(d, axis=-1, keepdims=True)
        mask[n, :count] = True
    return desc, mask, np.array([[0, 1], [0, 2], [1, 2]], np.int32), 0.8


CASES = {"random_pairs": case_random_pairs, "fully_masked": case_fully_masked,
         "k384": case_k384, "lone_valid_column": case_lone_valid_column,
         "exact_ties": case_exact_ties, "superpoint_width": case_superpoint_width}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("cross", [True, False])
def test_plain_matcher_equals_jax(name, cross):
    desc, mask, pairs, ratio = CASES[name]()
    ri, rm = jknn.match_all_pairs(jnp.asarray(desc), jnp.asarray(mask), jnp.asarray(pairs),
                                  ratio_thresh=ratio, cross_check=cross)
    ti, tm = tknn.match_all_pairs(t(desc), t(mask), t(pairs), ratio_thresh=ratio,
                                  cross_check=cross)
    np.testing.assert_array_equal(np.asarray(rm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(ri), ti.numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_matches_equal_pallas_interpret(name):
    desc, mask, pairs, ratio = CASES[name]()
    fi, fm = pallas_knn.match_all_pairs_fused(
        jnp.asarray(desc), jnp.asarray(mask), jnp.asarray(pairs),
        ratio_thresh=ratio, cross_check=True, interpret=True)
    ti, tm = cuda_knn.match_all_pairs_fused(t(desc), t(mask), t(pairs), ratio_thresh=ratio,
                                            cross_check=True)
    np.testing.assert_array_equal(np.asarray(fm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(fi), ti.numpy())
    if name == "fully_masked":
        assert not tm.numpy().any()
    if name == "lone_valid_column":
        assert tm.numpy()[0, 5]


@pytest.mark.parametrize("name", ["exact_ties", "fully_masked", "lone_valid_column"])
def test_raw_top2_equals_pallas_interpret(name):
    """best / second / arg / colarg of the kernel's function, including the
    column accumulator's 1e30 rule and the lowest-index tie rule."""
    desc, mask, pairs, _ = CASES[name]()
    bias = np.where(mask, 0.0, 1e30).astype(np.float32)
    out_j = pallas_knn._knn_topk2(jnp.asarray(desc), jnp.asarray(bias), jnp.asarray(pairs),
                                  interpret=True, packed=False)
    out_t = cuda_knn.knn_topk2(t(desc), t(bias), t(pairs))
    for a, b, what in zip(out_j, out_t, ("best", "second", "arg", "colarg")):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=what)


def test_bf16_compute_agrees_with_f32():
    """bf16 descriptors, float32 accumulation: final matches agree with the
    float32 path on nearly every row (the TPU package measured 99.1%
    inlier agreement on fountain); here >= 95% of valid rows."""
    desc, mask, pairs, ratio = case_random_pairs()
    i32, _ = cuda_knn.match_all_pairs_fused(t(desc), t(mask), t(pairs), ratio_thresh=ratio)
    i16, _ = cuda_knn.match_all_pairs_fused(t(desc), t(mask), t(pairs), ratio_thresh=ratio,
                                            compute_dtype="bfloat16")
    rows = mask[pairs[:, 0]]
    assert (i32.numpy() == i16.numpy())[rows].mean() >= 0.95


def test_wrapper_dispatches_by_device():
    """Contract checks live on the CUDA branch; a CPU tensor always takes
    the plain version, an unknown device is refused."""
    desc, mask, pairs, _ = case_fully_masked()
    bias = np.where(mask, 0.0, 1e30).astype(np.float32)
    before = cuda_build.launches()
    cuda_knn.knn_topk2(t(desc), t(bias), t(pairs))
    assert cuda_build.launches() == before      # the plain version is not counted
    with pytest.raises(ValueError):
        cuda_knn.knn_topk2(t(desc).to("meta"), t(bias).to("meta"), t(pairs).to("meta"))
    assert cuda_knn.supported(1280, 128) and not cuda_knn.supported(1000, 128)
    assert cuda_knn.supported(1024, 256) and not cuda_knn.supported(1024, 192)


def test_frontend_pads_keypoints_past_max_keypoints():
    """The driver fits the keypoint axis to the busiest view's count
    rounded up to 256 (the kernel's tile multiple), padding with masked
    slots where that passes ``max_keypoints`` (here 300 -> 512). The
    padding must not change a match: the driver's match tables equal the
    JAX package's plain matcher on the unpadded arrays, index for index
    (float32)."""
    from reconstructor_tpu_torch.config import ReconstructorConfig
    from reconstructor_tpu_torch.pipeline.incremental import IncrementalReconstructor
    from reconstructor_tpu_torch.pipeline.state import ReconstructionState

    rng = np.random.default_rng(5)
    N, K = 3, 300
    base = unit(rng, (400, 128))
    desc = np.zeros((N, K, 128), np.float32)
    mask = np.zeros((N, K), bool)
    for n, count in enumerate((300, 290, 200)):
        d = base[rng.choice(400, count, replace=False)]
        d = d + 0.05 * rng.standard_normal(d.shape).astype(np.float32)
        desc[n, :count] = d / np.linalg.norm(d, axis=-1, keepdims=True)
        mask[n, :count] = True
    state = ReconstructionState(
        num_images=N, max_keypoints=K, xy=rng.uniform(0, 100, (N, K, 2)).astype(np.float32),
        desc=desc, kp_mask=mask, colors=np.zeros((N, K, 3), np.uint8),
        shapes=np.full((N, 2), 100, np.int32), intrinsics=np.zeros((N, 6), np.float32))
    rec = IncrementalReconstructor(ReconstructorConfig(max_keypoints=K), verbose=False,
                                   device="cpu")
    desc_d, mask_d, _ = rec._device_frontend(state)
    assert tuple(desc_d.shape) == (N, 512, 128)
    assert not bool(mask_d[:, K:].any())
    rec.match_features(state, filter=False)

    pairs = np.array([[0, 1], [0, 2], [1, 2]], np.int32)
    ji, jm = jknn.match_all_pairs(jnp.asarray(desc), jnp.asarray(mask), jnp.asarray(pairs),
                                  ratio_thresh=0.7)
    want = np.where(np.asarray(jm), np.asarray(ji), -1)
    assert sorted(state.matches) == [(0, 1), (0, 2), (1, 2)]
    for q, (i, j) in enumerate(pairs):
        assert state.matches[(int(i), int(j))].shape == (K,)
        np.testing.assert_array_equal(state.matches[(int(i), int(j))], want[q])
