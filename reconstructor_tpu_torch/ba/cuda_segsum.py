"""Segment sums in a fixed order: a hand-written CUDA kernel for Hopper.

Bundle adjustment's implicit-Schur PCG (``ba/distributed.py``) sums
per-observation rows into cameras and landmarks: g_c, g_p, H_cc and H_pp
once per LM iteration, W^T u and W z in every CG iteration, the reduced
rhs and the point step. The JAX package does it with
``jax.ops.segment_sum`` (``reconstructor_tpu/ba/distributed.py:84-87,
119, 122, 128, 140``), which adds in one order on its chip. On the card
``index_add_`` is float atomics, whose order changes from run to run, so
two runs of one solve differed in their last bits and drifted apart.

``segment_layout`` builds, once per solve and on the solve's device, a
CSR index of the live observations (a stable sort of the segment index
plus offsets; memory O(O + n)). ``seg_sum`` takes a (rows, ...) tensor and
a layout and returns the (n, ...) sums of the live rows:

- on a CUDA tensor it launches ``csrc/seg_sum.cu`` (or raises): each
  segment summed in an order fixed by the layout and the launch shape,
  no atomics, so every call on the same inputs gives the same bits;
- on a CPU tensor it runs ``seg_sum_plain``: ``index_add_`` over the live
  rows in row order, which is the CPU's order of ``index_add_`` over all
  rows (masked rows of the solver are exact zeros), so the CPU parity
  tests against the JAX package run the sums they ran before.

``LAUNCHES`` counts kernel launches (plain-version calls do not count).
The kernel is built with ``nvcc`` for ``sm_90a`` at its first call and
called through ``ctypes``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from reconstructor_tpu_torch.utils import cuda_build

SOURCE = "ba/csrc/seg_sum.cu"
REPLACES = "reconstructor_tpu/ba/distributed.py:84"   # jax.ops.segment_sum (XLA, no Pallas)
# a segment of at least this many live rows gets a block of the kernel's
# 512 threads (cameras: thousands of observations); shorter ones a warp
# each (landmarks: a few)
LONG_ROWS = 256
_INT32_MAX = 2 ** 31 - 1

LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


class SegmentLayout(NamedTuple):
    """The live rows of a segment index, grouped by segment.

    n: number of segments; size: rows of the index (O). rows (O_live,)
    int64: the live rows in ascending order; index (O_live,) int64: their
    segments (the plain version's ``index_add_``). perm (O_live,) int32: the live rows
    ordered by segment, ascending within each (a stable sort); offsets
    (n + 1,) int32: segment s holds perm[offsets[s]:offsets[s + 1]];
    seg_ids (n,) int32: the segments, the ``n_long`` of at least
    ``LONG_ROWS`` rows first, each group in ascending order."""
    n: int
    size: int
    rows: torch.Tensor
    index: torch.Tensor
    perm: torch.Tensor
    offsets: torch.Tensor
    seg_ids: torch.Tensor
    n_long: int


def segment_layout(index: torch.Tensor, n: int,
                   mask: Optional[torch.Tensor] = None) -> SegmentLayout:
    """The layout of ``index`` (O,) into ``n`` segments over the rows where
    ``mask`` (O,) is set (every row without one), on ``index``'s device.
    Masked rows are left out: the solver's masked rows are exact zeros, and
    its padding slots, which all point at segment 0, would otherwise make
    one long segment. Plain torch (stable sort, bincount, cumsum); a few host
    reads (the index's range, the count of long segments)."""
    if index.dim() != 1:
        raise ValueError(f"segment_layout: index must be (O,), got {tuple(index.shape)}")
    if index.numel() > _INT32_MAX or n > _INT32_MAX - 1:
        raise ValueError("segment_layout: rows and segments must index in 32 bits")
    dev = index.device
    if mask is None:
        rows = torch.arange(index.numel(), device=dev)
    else:
        if tuple(mask.shape) != tuple(index.shape):
            raise ValueError(f"segment_layout: mask {tuple(mask.shape)} for index "
                             f"{tuple(index.shape)}")
        rows = torch.nonzero(mask.to(torch.bool)).reshape(-1)
    seg = index.long()[rows]
    if seg.numel() and not 0 <= int(seg.min()) <= int(seg.max()) < n:
        raise ValueError(f"segment_layout: an index of a live row is outside [0, {n})")
    counts = torch.bincount(seg, minlength=n)
    order = torch.sort(seg, stable=True).indices
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(counts, 0).to(torch.int32)
    long = counts >= LONG_ROWS
    seg_ids = torch.cat([torch.nonzero(long), torch.nonzero(~long)]).reshape(-1)
    return SegmentLayout(n=n, size=index.numel(), rows=rows, index=seg,
                         perm=rows[order].to(torch.int32), offsets=offsets,
                         seg_ids=seg_ids.to(torch.int32), n_long=int(long.sum()))


def seg_sum_plain(values: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``index_add_`` of the live
    rows of ``values`` (rows, ...) into (n, ...), in row order."""
    out = torch.zeros((layout.n,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, layout.index, values.index_select(0, layout.rows))


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    if not getattr(lib, "_seg_sum_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.seg_sum_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, vp]
        lib.seg_sum_launch.restype = ci
        lib.seg_sum_error_string.argtypes = [ci]
        lib.seg_sum_error_string.restype = ctypes.c_char_p
        lib._seg_sum_bound = True
    return lib


def seg_sum(values: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    """Sum the live rows of ``values`` (rows, ...) into the layout's ``n``
    segments: (n, ...). On a CUDA tensor this launches ``csrc/seg_sum.cu``
    (or raises); the plain version runs only for tensors on the CPU."""
    if values.device.type == "cpu":
        return seg_sum_plain(values, layout)
    if values.device.type != "cuda":
        raise ValueError(f"seg_sum: unsupported device {values.device}")
    if values.dtype != torch.float32:
        raise TypeError(f"seg_sum: values must be float32, got {values.dtype}")
    if values.dim() < 1:
        raise ValueError("seg_sum: values must have a row axis")
    if layout.perm.device != values.device:
        raise ValueError(f"seg_sum: layout on {layout.perm.device}, values on {values.device}")
    rows = values.shape[0]
    if rows != layout.size:
        raise ValueError(f"seg_sum: {rows} rows for a layout of {layout.size}")
    tail = tuple(values.shape[1:])
    W = 1
    for d in tail:
        W *= d
    if W > _INT32_MAX:
        raise ValueError(f"seg_sum: rows of {W} values do not index in 32 bits")
    flat = values.reshape(rows, W).contiguous()
    out = torch.empty((layout.n, W), dtype=torch.float32, device=values.device)
    lib = _lib()
    dev = values.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (flat.data_ptr(), layout.perm.data_ptr(), layout.offsets.data_ptr(),
            layout.seg_ids.data_ptr(), layout.n_long, layout.n, W, out.data_ptr(), stream)
    if dev.index is None or dev.index == torch.cuda.current_device():
        status = lib.seg_sum_launch(*args)
    else:
        with torch.cuda.device(dev):
            status = lib.seg_sum_launch(*args)
    if status != 0:
        raise RuntimeError("seg_sum launch failed: " + lib.seg_sum_error_string(status).decode())
    global LAUNCHES
    LAUNCHES += 1
    return out.reshape((layout.n,) + tail)
