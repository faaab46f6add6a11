"""The Schur matvec's sums over observations, fused: a hand-written CUDA
kernel for Hopper (kernel 6).

Every CG iteration of the implicit-Schur PCG (``ba/distributed.py``)
takes two sums over observations, and each LM trial two more:

- ``ytu_sum(Y, u, lay)``: W^T u, out[l] = sum over the live observations o
  of landmark l of Y_o^T u[obs_cam[o]], (L, 3) (the matvec, the point
  step);
- ``yz_sum(Y, z, lay)``: W z, out[c] = sum over the live observations o
  of camera c of Y_o z[obs_pt[o]], (C, 12) (the matvec, the reduced rhs),

with Y (O, 12, 3) the per-observation coupling Jc^T Jp. The JAX package
writes each as an einsum and a segment sum
(``reconstructor_tpu/ba/distributed.py:118-122, 128-129, 140-141``). The
port ran a gather, an einsum and kernel 5 for each: three launches and
two round trips of an (O, W) tensor through device memory. Here:

- on CUDA tensors one launch of ``csrc/schur_sums.cu`` (or a raise): the
  gather, the product and the sum of each segment in an order fixed by the
  layout and the launch shape, no atomics on values, so a call repeats bit
  for bit;
- on CPU tensors the plain versions ``ytu_sum_plain`` / ``yz_sum_plain``:
  exactly the chain the port ran before (gather, ``einsum``,
  ``seg_sum_plain``), so a CPU solve computes what it computed then.

``schur_layout`` builds the two segment layouts of a solve once, each with
the other side's index in its own order (``segment_layout``'s ``other``),
which the kernel reads beside Y. ``LAUNCHES`` counts kernel launches
(plain-version calls do not count). The kernel is built with ``nvcc`` for
``sm_90a`` at its first call and called through ``ctypes``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from reconstructor_tpu_torch.ba import cuda_segsum
from reconstructor_tpu_torch.ba.cuda_segsum import SegmentLayout

SOURCE = "ba/csrc/schur_sums.cu"
# the matvec's einsum + segment_sum of W^T u (XLA, no Pallas); W z at :121
REPLACES = "reconstructor_tpu/ba/distributed.py:118"

LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


class SchurLayout(NamedTuple):
    """The segment layouts of one solve. cam: the live observations by
    camera, ``cam.other`` their landmarks; pt: by landmark, ``pt.other``
    their cameras; obs_cam, obs_pt (O,) int64: every observation's camera
    and landmark (the plain versions' gathers)."""
    cam: SegmentLayout
    pt: SegmentLayout
    obs_cam: torch.Tensor
    obs_pt: torch.Tensor


def schur_layout(obs_cam: torch.Tensor, obs_pt: torch.Tensor, n_cam: int, n_pt: int,
                 mask=None) -> SchurLayout:
    """The layouts of ``obs_cam`` / ``obs_pt`` (O,) into ``n_cam`` cameras
    and ``n_pt`` landmarks over the rows where ``mask`` is set."""
    obs_cam, obs_pt = obs_cam.long(), obs_pt.long()
    return SchurLayout(
        cam=cuda_segsum.segment_layout(obs_cam, n_cam, mask, other=obs_pt, n_other=n_pt),
        pt=cuda_segsum.segment_layout(obs_pt, n_pt, mask, other=obs_cam, n_other=n_cam),
        obs_cam=obs_cam, obs_pt=obs_pt)


def ytu_sum_plain(Y: torch.Tensor, u: torch.Tensor, lay: SchurLayout) -> torch.Tensor:
    """W^T u in plain PyTorch: gather, ``einsum``, ``seg_sum_plain``."""
    return cuda_segsum.seg_sum_plain(torch.einsum("oij,oi->oj", Y, u[lay.obs_cam]), lay.pt)


def yz_sum_plain(Y: torch.Tensor, z: torch.Tensor, lay: SchurLayout) -> torch.Tensor:
    """W z in plain PyTorch: gather, ``einsum``, ``seg_sum_plain``."""
    return cuda_segsum.seg_sum_plain(torch.einsum("oij,oj->oi", Y, z[lay.obs_pt]), lay.cam)


_VP, _CI = ctypes.c_void_p, ctypes.c_int
# Y, perm, other, operand, n_operand, offsets, seg_ids, chunk_long,
# first_chunk, chunk_rows, counters, scratch, n_long, n_chunks, n_seg,
# out, stream
_ARGS = [_VP, _VP, _VP, _VP, _CI, _VP, _VP, _VP, _VP, _CI, _VP, _VP, _CI, _CI, _CI, _VP, _VP]
_FNS = {"ytu_sum_launch": _ARGS, "yz_sum_launch": _ARGS}


def _fused(fn: str, Y: torch.Tensor, operand: torch.Tensor, seg: SegmentLayout,
           n_operand: int, width: int, out_width: int) -> torch.Tensor:
    """One launch of ``fn`` over layout ``seg``: Y (O, 12, 3) and the
    operand (n_operand, width) on one card, float32 (the launcher refuses
    a Y whose rows are not 16-byte aligned)."""
    dev = Y.device
    if Y.dtype != torch.float32 or operand.dtype != torch.float32:
        raise TypeError(f"{fn}: Y and the operand must be float32, got {Y.dtype}, "
                        f"{operand.dtype}")
    if tuple(Y.shape) != (seg.size, 12, 3) or tuple(operand.shape) != (n_operand, width):
        raise ValueError(f"{fn}: Y {tuple(Y.shape)} and operand {tuple(operand.shape)} for "
                         f"{seg.size} observations and {n_operand} x {width}")
    if operand.device != dev or seg.perm.device != dev:
        raise ValueError(f"{fn}: Y on {dev}, operand on {operand.device}, layout on "
                         f"{seg.perm.device}")
    if not Y.is_contiguous():
        Y = Y.contiguous()
    if not operand.is_contiguous():
        operand = operand.contiguous()
    out = torch.empty(seg.n, out_width, dtype=torch.float32, device=dev)
    fns = cuda_segsum.bind(SOURCE, _FNS, "schur_sum_error_string")
    args = ((Y.data_ptr(), seg.perm.data_ptr(), seg.other.data_ptr(), operand.data_ptr(),
             n_operand) + cuda_segsum.chunk_args(seg, seg.scratch) + (out.data_ptr(),))
    cuda_segsum.launch(fns[fn], args, dev, fns["schur_sum_error_string"], fn)
    global LAUNCHES
    LAUNCHES += 1
    return out


def ytu_sum(Y: torch.Tensor, u: torch.Tensor, lay: SchurLayout) -> torch.Tensor:
    """W^T u: Y (O, 12, 3), u (C, 12) -> (L, 3). On CUDA tensors one launch
    of ``csrc/schur_sums.cu`` (or a raise); the plain version runs only for
    tensors on the CPU."""
    if Y.device.type == "cpu":
        return ytu_sum_plain(Y, u, lay)
    if Y.device.type != "cuda":
        raise ValueError(f"ytu_sum: unsupported device {Y.device}")
    return _fused("ytu_sum_launch", Y, u, lay.pt, lay.cam.n, 12, 3)


def yz_sum(Y: torch.Tensor, z: torch.Tensor, lay: SchurLayout) -> torch.Tensor:
    """W z: Y (O, 12, 3), z (L, 3) -> (C, 12). On CUDA tensors one launch of
    ``csrc/schur_sums.cu`` (or a raise); the plain version runs only for
    tensors on the CPU."""
    if Y.device.type == "cpu":
        return yz_sum_plain(Y, z, lay)
    if Y.device.type != "cuda":
        raise ValueError(f"yz_sum: unsupported device {Y.device}")
    return _fused("yz_sum_launch", Y, z, lay.cam, lay.pt.n, 3, 12)
