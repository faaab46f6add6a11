"""The CUDA kernels of reconstructor_tpu_torch on the card.

Marked ``cuda``: a CUDA kernel has no CPU mode, so these skip on a
machine without an NVIDIA GPU. On one, run

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

This file imports no JAX (the GPU machine has none; ``--noconftest``
skips ``tests/conftest.py``, which configures JAX): it drives the same
checks as ``chip_smoke.py``'s kernel phases — the top-2 kNN kernel against
its plain PyTorch version on the TPU package's kernel-test cases, at the
fountain dataset's shape, at SuperPoint's 256-wide descriptors, on masks
that are not prefixes and at the default path's shape, the Sinkhorn
kernel against its plain version on ragged random scores (prefix and
non-prefix masks, 0 to 100 iterations), the
packed-int32 kNN kernel against its plain version and through the port's
``scripts/check_packed.py``, and the level-by-level kNN kernel of
``scripts/profile_knn_kernel.py`` against its plain version at every
level, the F-gate's Sampson-count kernel (kernel 7) against its plain
version at ``chip_smoke.FGATE_CASES``' shapes and over a pass of the
benchmark's matching cell; and, beside the kernels, the homography
decomposition of the initial pair on the card against the CPU's.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_knn_kernel_edge_cases(card):
    chip_smoke.edge_cases(card)


@pytest.mark.cuda
def test_knn_kernel_at_fountain_shape(card):
    chip_smoke.phase_kernels(card)


@pytest.mark.cuda
def test_knn_kernel_superpoint_width(card):
    chip_smoke.knn_superpoint_width(card)


@pytest.mark.cuda
def test_knn_kernel_non_prefix_masks(card):
    chip_smoke.knn_non_prefix_masks(card)


@pytest.mark.cuda
def test_knn_kernel_default_path_shape(card):
    res = chip_smoke.knn_default_shape(card)
    assert res["ms"] > 0


@pytest.mark.cuda
def test_knn_kernel_widest_descriptors(card):
    chip_smoke.knn_wide_descriptors(card)


@pytest.mark.cuda
def test_sinkhorn_kernel_against_plain(card):
    chip_smoke.phase_sinkhorn(card)


@pytest.mark.cuda
def test_packed_knn_kernel_edge_cases(card):
    chip_smoke.packed_edge_cases(card)


@pytest.mark.cuda
def test_packed_knn_kernel_and_check_packed(card):
    launches, res, _ = chip_smoke.phase_packed(card)
    assert launches[torch.float32] > 0 and launches[torch.bfloat16] > 0


@pytest.mark.cuda
def test_level_knn_kernel_at_every_level(card):
    launches, res, _ = chip_smoke.phase_levels(card)
    assert launches > 0


@pytest.mark.cuda
def test_homography_candidates_equal_on_the_card(card):
    """decompose_homography's candidates depend on the signs of the SVD's
    singular vectors; the SVD runs on the host, so a homography on the card
    gives the CPU's candidates (with cuSOLVER's signs the true motion of a
    near-planar ORB pair dropped out of the card's set)."""
    from reconstructor_tpu_torch.geometry import epipolar
    import numpy as np
    rng = np.random.default_rng(2)
    for _ in range(20):
        R = torch.linalg.matrix_exp(torch.tensor(
            [[0.0, -1.0, 1.0], [1.0, 0.0, -1.0], [-1.0, 1.0, 0.0]]) * float(rng.normal(0, 0.05)))
        t = torch.tensor(rng.normal(0, 1, 3), dtype=torch.float32)
        n = torch.tensor([0.1, -0.2, 1.0])
        H = R + torch.outer(t, n) / 6.0
        for (Rc, tc), (Rg, tg) in zip(epipolar.decompose_homography(H),
                                      epipolar.decompose_homography(H.to(card))):
            torch.testing.assert_close(Rg.cpu(), Rc, atol=1e-4, rtol=0)
            torch.testing.assert_close(tg.cpu(), tc, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(chip_smoke.FGATE_CASES))
def test_fgate_counts_kernel_equals_plain(card, case):
    """Kernel 7's inlier counts equal its plain version's bit for bit (an
    all-masked pair, F = 0 and a NaN hypothesis in every case)."""
    chip_smoke.fgate_case(card, case)


@pytest.mark.cuda
def test_fgate_counts_wrapper_refuses_and_counts_launches(card):
    chip_smoke.fgate_wrapper_checks(card)


@pytest.mark.cuda
def test_fgate_counts_cell_pass(card):
    """One launch a gated chunk over a pass of the benchmark's matching
    cell, and the pass's tables equal to the plain chain's."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _, launches, _, _ = chip_smoke.fgate_cell_pass(card, here)
    assert launches == 10
