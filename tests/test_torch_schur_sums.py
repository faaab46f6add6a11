"""The fused sums of PCG's Schur matvec (``ba/cuda_schur.py``, kernel 6)
on the CPU: the plain versions against the chain the solver ran before
them (gather, ``einsum``, ``index_add_``; bit for bit) and against the
JAX package's ``einsum`` + ``jax.ops.segment_sum`` (within 1e-6 of the
products' magnitudes: XLA adds in its own order); the per-side index
arrays and chunk tables of ``segment_layout``; the solver's matvec
against the unfused chain. The kernel itself is held against the plain
versions on the card (``cuda``-marked, skipped here; this file imports
JAX only inside the test that compares with it, so on the card

    python -m pytest -q --noconftest -m cuda tests/test_torch_schur_sums.py

runs it)."""

import os
import sys

import numpy as np
import pytest
import torch

from reconstructor_tpu_torch.ba import cuda_schur, cuda_segsum, distributed


def ragged(seed: int, rows: int, n_cam: int, n_pt: int, masked: float, empty_every: int = 0,
           long_pt: float = 0.0, mask: bool = True):
    """Random observations: cameras (every ``empty_every``-th never used),
    landmarks (``long_pt`` of the rows on landmark 0, so that it is long),
    a mask with ``masked`` of the rows off (None when ``mask`` is False),
    and Y, u, z, with Y's masked rows exact zeros, as the solver's are."""
    rng = np.random.default_rng(seed)
    cams = np.arange(n_cam)
    if empty_every:
        cams = cams[cams % empty_every != 0]
    cam = rng.choice(cams, rows).astype(np.int64)
    pt = rng.integers(0, n_pt, rows).astype(np.int64)
    pt[rng.uniform(size=rows) < long_pt] = 0
    live = rng.uniform(size=rows) >= masked
    Y = rng.standard_normal((rows, 12, 3)).astype(np.float32) * live[:, None, None]
    u = rng.standard_normal((n_cam, 12)).astype(np.float32)
    z = rng.standard_normal((n_pt, 3)).astype(np.float32)
    return cam, pt, (live if mask else None), Y, u, z


CASES = {"no_mask": (0, 400, 6, 90, 0.0, 0, 0.0, False),
         "masked_rows": (1, 700, 8, 120, 0.3, 0, 0.0, True),
         "empty_segments": (2, 900, 12, 300, 0.2, 3, 0.0, True),
         "one_segment_holds_every_live_row": (3, 1500, 1, 40, 0.25, 0, 0.5, True),
         "every_row_masked": (4, 300, 5, 50, 1.0, 0, 0.0, True)}


def layout_of(case):
    cam, pt, mask, Y, u, z = ragged(*CASES[case])
    n_cam, n_pt = CASES[case][2], CASES[case][3]
    lay = cuda_schur.schur_layout(torch.from_numpy(cam), torch.from_numpy(pt), n_cam, n_pt,
                                  None if mask is None else torch.from_numpy(mask))
    return lay, (cam, pt, mask, Y, u, z)


def unfused(Y, u, z, cam, pt, n_cam, n_pt):
    """The solver's sums before kernel 6: gather, einsum, index_add_ over
    every row (masked rows are exact zeros)."""
    Y, u, z = map(torch.from_numpy, (Y, u, z))
    cam, pt = torch.from_numpy(cam), torch.from_numpy(pt)
    ytu = torch.zeros(n_pt, 3).index_add_(0, pt, torch.einsum("oij,oi->oj", Y, u[cam]))
    yz = torch.zeros(n_cam, 12).index_add_(0, cam, torch.einsum("oij,oj->oi", Y, z[pt]))
    return ytu, yz


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_sums_equal_the_unfused_chain(case):
    lay, (cam, pt, mask, Y, u, z) = layout_of(case)
    n_cam, n_pt = CASES[case][2], CASES[case][3]
    ytu, yz = unfused(Y, u, z, cam, pt, n_cam, n_pt)
    Yt, ut, zt = map(torch.from_numpy, (Y, u, z))
    for got in (cuda_schur.ytu_sum_plain(Yt, ut, lay), cuda_schur.ytu_sum(Yt, ut, lay)):
        assert got.shape == (n_pt, 3) and torch.equal(got, ytu)
    for got in (cuda_schur.yz_sum_plain(Yt, zt, lay), cuda_schur.yz_sum(Yt, zt, lay)):
        assert got.shape == (n_cam, 12) and torch.equal(got, yz)
    # today's chain through the segment layouts, as the solver ran it
    assert torch.equal(cuda_segsum.seg_sum(torch.einsum("oij,oi->oj", Yt, ut[lay.obs_cam]),
                                           lay.pt), ytu)
    # empty segments are exact zeros
    live = np.ones(len(cam), bool) if mask is None else mask
    for got, index, n in ((ytu, pt, n_pt), (yz, cam, n_cam)):
        empty = torch.from_numpy(np.bincount(index[live], minlength=n) == 0)
        assert not bool(got[empty].any())


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_sums_against_jax_segment_sum(case):
    import jax
    import jax.numpy as jnp
    import torch_parity  # noqa: F401  (two torch threads per worker)
    lay, (cam, pt, mask, Y, u, z) = layout_of(case)
    n_cam, n_pt = CASES[case][2], CASES[case][3]
    Yt = torch.from_numpy(Y)
    got = {"ytu": cuda_schur.ytu_sum(Yt, torch.from_numpy(u), lay).numpy(),
           "yz": cuda_schur.yz_sum(Yt, torch.from_numpy(z), lay).numpy()}
    Yj = jnp.asarray(Y)
    # the JAX package's matvec sums (reconstructor_tpu/ba/distributed.py:118-122)
    ref = {"ytu": jax.ops.segment_sum(jnp.einsum("oij,oi->oj", Yj, jnp.asarray(u)[cam]), pt,
                                      n_pt),
           "yz": jax.ops.segment_sum(jnp.einsum("oij,oj->oi", Yj, jnp.asarray(z)[pt]), cam,
                                     n_cam)}
    Y64 = np.abs(Y.astype(np.float64))
    mag = {"ytu": np.zeros((n_pt, 3)), "yz": np.zeros((n_cam, 12))}
    np.add.at(mag["ytu"], pt, np.einsum("oij,oi->oj", Y64, np.abs(u.astype(np.float64))[cam]))
    np.add.at(mag["yz"], cam, np.einsum("oij,oj->oi", Y64, np.abs(z.astype(np.float64))[pt]))
    for k in got:
        np.testing.assert_array_less(np.abs(got[k] - np.asarray(ref[k])),
                                     1e-6 * mag[k] + 1e-30)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_other_side_and_chunks(case):
    lay, (cam, pt, mask, *_) = layout_of(case)
    for seg, other in ((lay.cam, pt), (lay.pt, cam)):
        perm = seg.perm.numpy()
        assert seg.other.dtype == torch.int32
        np.testing.assert_array_equal(seg.other.numpy(), other[perm])
        # the chunks of each long segment cover its rows in order
        offsets, seg_ids = seg.offsets.numpy(), seg.seg_ids.numpy()
        first, owner = seg.first_chunk.numpy(), seg.chunk_long.numpy()
        assert seg.n_chunks == len(owner) == first[-1]
        assert seg.counters.shape == (seg.n_long,) and not bool(seg.counters.any())
        assert seg.scratch.numel() == seg.n_chunks * cuda_segsum.SCRATCH_W
        for li in range(seg.n_long):
            s = seg_ids[li]
            rows = offsets[s + 1] - offsets[s]
            assert rows >= cuda_segsum.LONG_ROWS
            assert first[li + 1] - first[li] == -(-rows // cuda_segsum.CHUNK_ROWS)
            assert (owner[first[li]:first[li + 1]] == li).all()
    np.testing.assert_array_equal(lay.obs_cam.numpy(), cam)
    np.testing.assert_array_equal(lay.obs_pt.numpy(), pt)


def test_matvec_equals_the_unfused_chain():
    """``distributed._schur_matvec`` on the CPU computes what it computed
    before kernels 6 and 8, bit for bit (H_pp^-1 as ``_inv3x3``'s (9, L)
    planes, multiplied through their strided (L, 3, 3) view)."""
    lay, (cam, pt, mask, Y, u, z) = layout_of("masked_rows")
    n_cam, n_pt = CASES["masked_rows"][2], CASES["masked_rows"][3]
    rng = np.random.default_rng(9)
    H_cc = torch.from_numpy(rng.standard_normal((n_cam, 12, 12)).astype(np.float32))
    H_pp_inv = torch.from_numpy(rng.standard_normal((9, n_pt)).astype(np.float32))  # planes
    Yt, uflat = torch.from_numpy(Y), torch.from_numpy(u).reshape(-1)
    got = distributed._schur_matvec(lay, Yt, H_cc, H_pp_inv, uflat)
    uu = uflat.reshape(n_cam, 12)
    WtU = cuda_segsum.seg_sum(torch.einsum("oij,oi->oj", Yt, uu[lay.obs_cam]), lay.pt)
    zz = torch.einsum("lij,lj->li", H_pp_inv.T.reshape(n_pt, 3, 3), WtU)
    Wz = cuda_segsum.seg_sum(torch.einsum("oij,oj->oi", Yt, zz[lay.obs_pt]), lay.cam)
    want = (torch.einsum("cij,cj->ci", H_cc, uu) - Wz).reshape(-1)
    assert torch.equal(got, want)


def test_rejects_bad_inputs():
    with pytest.raises(ValueError):          # a live row's landmark out of range
        cuda_schur.schur_layout(torch.tensor([0, 1]), torch.tensor([0, 3]), 2, 3)
    # a masked row's may be anything
    lay = cuda_schur.schur_layout(torch.tensor([0, 1]), torch.tensor([0, 3]), 2, 3,
                                  torch.tensor([True, False]))
    assert lay.pt.other.tolist() == [0] and lay.cam.other.tolist() == [0]
    with pytest.raises(ValueError):
        cuda_schur.ytu_sum(torch.zeros(2, 12, 3, device="meta"), torch.zeros(2, 12), lay)
    with pytest.raises(ValueError):
        cuda_schur.yz_sum(torch.zeros(2, 12, 3, device="meta"), torch.zeros(3, 3), lay)
    with pytest.raises(ValueError):
        cuda_segsum.segment_layout(torch.tensor([0, 1]), 2, other=torch.tensor([0]), n_other=1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_against_plain_and_repeatable(card):
    """Both directions equal to the plain versions bit for bit on ragged
    integer inputs (empty, short, long and split segments; u in shared
    memory and not), then three calls equal and within 3e-6 of float64
    sums at the fountain problem's shapes."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    chip_smoke.schur_ragged(card)
    chip_smoke.schur_shapes(chip_smoke.segsum_fountain(card), "fountain problem")
