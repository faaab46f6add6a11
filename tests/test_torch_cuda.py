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
level.
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
    assert launches > 0


@pytest.mark.cuda
def test_level_knn_kernel_at_every_level(card):
    launches, res, _ = chip_smoke.phase_levels(card)
    assert launches > 0
