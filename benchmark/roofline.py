"""The yardstick of the kernels' roofline shares: the chip's published peaks
and the operations and bytes each kernel's work needs.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W
limit): 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in float32
outside them, 3.35 TB/s of HBM. The byte counts are those the repository
measured its kernels against (``chip_smoke.py``: ``knn_flops``,
``knn_bytes``, ``segsum_bytes``, ``schur_bytes``), kept here so that a change
to the program cannot move them: each input read once, each output written
once, and only the products between valid keypoints counted as operations.
"""

from __future__ import annotations

import torch

BF16_PEAK = 989e12          # FLOP/s, bf16 tensor cores
F32_PEAK = 67e12            # FLOP/s, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def knn_flops(valid: torch.Tensor, pairs: torch.Tensor, D: int) -> float:
    """Operations of top-2 kNN over ``pairs`` (B, 2): a product of length D
    between every valid keypoint of image i and every one of image j.
    valid (N,) holds each image's valid keypoint count."""
    n = valid.double()
    pc = pairs.long().to(n.device)
    return 2.0 * D * float((n[pc[:, 0]] * n[pc[:, 1]]).sum())


def knn_bytes(N: int, K: int, D: int, B: int, elt: int, bias_elt: int = 4) -> float:
    """Bytes of one top-2 launch over B pairs of N images of K slots: the
    descriptors and the mask bias once, the pair list, and the four (B, K)
    outputs."""
    return N * K * D * elt + N * K * bias_elt + B * 8 + B * K * 16


def knn_bound_s(valid: torch.Tensor, pairs: torch.Tensor, N: int, K: int, D: int,
                elt: int) -> float:
    """Least seconds of one top-2 launch: operations at the peak of its
    product (bf16 for 2-byte descriptors, float32 otherwise) or bytes at the
    HBM rate, whichever is longer."""
    peak = BF16_PEAK if elt == 2 else F32_PEAK
    return max(knn_flops(valid, pairs, D) / peak,
               knn_bytes(N, K, D, pairs.shape[0], elt) / HBM_BYTES_PER_S)


def segsum_bytes(live: int, n: int, n_chunks: int, n_long: int, W: int) -> float:
    """Bytes of one fixed-order segment sum (kernel 5) of ``live`` rows of W
    float32 values into n segments: each live row and its order entry once,
    the offsets, the segment list, the chunk table and the output once."""
    return (live * (W * 4 + 4) + (n + 1) * 4 + n * 4 + n * W * 4
            + (n_chunks + n_long + 1) * 4)


def schur_bytes(live: int, n: int, n_chunks: int, n_long: int, n_operand: int,
                op_w: int, out_w: int) -> float:
    """Bytes of one direction of the fused Schur sum (kernel 6): each live
    (12, 3) coupling block (144 B) with its order and other-side entries,
    the operand, the offsets, the segment list, the chunk table and the
    output once."""
    return (live * (144 + 8) + n_operand * op_w * 4 + (n + 1) * 4 + n * 4
            + (n_chunks + n_long + 1) * 4 + n * out_w * 4)
