"""The fixed-order segment sums of the port's PCG bundle adjustment
(``ba/cuda_segsum.py``) on the CPU: the layout against numpy's stable
argsort and bincount, the plain version against ``index_add_`` (bit for
bit) and against the JAX package's ``jax.ops.segment_sum`` (within 1e-6
relative: XLA adds in its own order). The kernel itself is held against
the plain version on the card (``cuda``-marked, skipped here)."""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reconstructor_tpu_torch.ba import cuda_segsum

import torch_parity  # noqa: F401  (two torch threads per worker)


def ragged(seed: int, rows: int, n: int, masked: float, empty_every: int = 0):
    """A random segment index over ``n`` segments (every ``empty_every``-th
    segment never used), a mask with ``masked`` of the rows off, and
    values whose masked rows are exact zeros, as the solver's are."""
    rng = np.random.default_rng(seed)
    used = np.arange(n)
    if empty_every:
        used = used[used % empty_every != 0]
    index = rng.choice(used, rows).astype(np.int64)
    mask = rng.uniform(size=rows) >= masked
    values = rng.standard_normal((rows, 3, 2)).astype(np.float32) * mask[:, None, None]
    return index, mask, values


CASES = {"dense": (0, 500, 40, 0.0, 0), "masked": (1, 700, 64, 0.3, 0),
         "empty_segments": (2, 900, 128, 0.2, 3), "one_segment": (3, 600, 5, 0.1, 0),
         "long_and_short": (4, 3000, 9, 0.25, 0)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_is_a_stable_sort_with_offsets(case):
    seed, rows, n, masked, empty = CASES[case]
    index, mask, _ = ragged(seed, rows, n, masked, empty)
    lay = cuda_segsum.segment_layout(torch.from_numpy(index), n, torch.from_numpy(mask))
    live = np.nonzero(mask)[0]
    want_perm = live[np.argsort(index[live], kind="stable")]
    counts = np.bincount(index[live], minlength=n)
    np.testing.assert_array_equal(lay.perm.numpy(), want_perm)
    assert lay.perm.dtype == torch.int32 and lay.offsets.dtype == torch.int32
    np.testing.assert_array_equal(lay.offsets.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    np.testing.assert_array_equal(lay.rows.numpy(), live)
    np.testing.assert_array_equal(lay.index.numpy(), index[live])
    long = counts >= cuda_segsum.LONG_ROWS
    assert lay.n_long == int(long.sum())
    np.testing.assert_array_equal(lay.seg_ids.numpy(),
                                  np.concatenate([np.nonzero(long)[0], np.nonzero(~long)[0]]))
    assert lay.n == n and lay.size == rows


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_sum_is_index_add_and_segment_sum(case):
    seed, rows, n, masked, empty = CASES[case]
    index, mask, values = ragged(seed, rows, n, masked, empty)
    lay = cuda_segsum.segment_layout(torch.from_numpy(index), n, torch.from_numpy(mask))
    v = torch.from_numpy(values)
    got = cuda_segsum.seg_sum(v, lay)
    assert got.shape == (n, 3, 2)
    # the solver's sums before the layout: index_add_ over every row
    before = torch.zeros(n, 3, 2).index_add_(0, torch.from_numpy(index), v)
    assert torch.equal(got, before)
    # the live rows alone, in row order: bit for bit
    live = torch.from_numpy(np.nonzero(mask)[0])
    alone = torch.zeros(n, 3, 2).index_add_(0, torch.from_numpy(index)[live], v[live])
    assert torch.equal(got, alone)
    # empty segments are exact zeros
    counts = np.bincount(index[mask], minlength=n)
    empty = torch.from_numpy(counts == 0)
    assert torch.equal(got[empty], torch.zeros(int(empty.sum()), 3, 2))
    # the JAX package's segment_sum: within 1e-6 of the absolute sum
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(values), jnp.asarray(index), n))
    scale = np.zeros((n, 3, 2), np.float64)
    np.add.at(scale, index, np.abs(values).astype(np.float64))
    np.testing.assert_array_less(np.abs(got.numpy() - ref), 1e-6 * scale + 1e-30)


def test_plain_sum_ignores_masked_rows_and_all_masked_is_zero():
    index = torch.tensor([2, 0, 2, 1, 0])
    values = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    mask = torch.tensor([True, False, True, False, True])
    lay = cuda_segsum.segment_layout(index, 4, mask)
    got = cuda_segsum.seg_sum(values, lay)
    assert torch.equal(got, torch.tensor([[8.0, 9.0], [0.0, 0.0], [4.0, 6.0], [0.0, 0.0]]))
    none = cuda_segsum.segment_layout(index, 4, torch.zeros(5, dtype=torch.bool))
    assert none.perm.numel() == 0 and none.n_long == 0
    assert torch.equal(cuda_segsum.seg_sum(values, none), torch.zeros(4, 2))
    every = cuda_segsum.segment_layout(index, 4)
    assert torch.equal(cuda_segsum.seg_sum(values, every),
                       torch.zeros(4, 2).index_add_(0, index, values))


def test_layout_rejects_an_index_out_of_range():
    with pytest.raises(ValueError):
        cuda_segsum.segment_layout(torch.tensor([0, 4]), 4)
    with pytest.raises(ValueError):
        cuda_segsum.segment_layout(torch.tensor([0, -1]), 4)
    lay = cuda_segsum.segment_layout(torch.tensor([0, 1]), 4)
    with pytest.raises(ValueError):
        cuda_segsum.seg_sum(torch.zeros(3, 2, device="meta"), lay)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_against_plain_and_repeatable(card):
    """Ragged and empty layouts equal to the plain version bit for bit,
    three calls equal, within 2e-6 of float64 sums at the street
    problem's and the fountain problem's shapes."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    chip_smoke.phase_segsum(card)
