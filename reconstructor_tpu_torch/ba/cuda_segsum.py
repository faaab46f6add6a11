"""Segment sums in a fixed order: a hand-written CUDA kernel for Hopper.

Bundle adjustment's implicit-Schur PCG (``ba/distributed.py``) sums
per-observation rows into cameras and landmarks: g_c, g_p, H_cc and H_pp
once per LM iteration (this module), W^T u and W z in every CG iteration,
the reduced rhs and the point step (``ba/cuda_schur.py``, kernel 6, on
the layouts built here). The JAX package does it with
``jax.ops.segment_sum`` (``reconstructor_tpu/ba/distributed.py:84-87``),
which adds in one order on its chip. On the card ``index_add_`` is float
atomics, whose order changes from run to run, so two runs of one solve
differed in their last bits and drifted apart.

``segment_layout`` builds, once per solve and on the solve's device, a
CSR index of the live observations (a stable sort of the segment index
plus offsets; memory O(O + n)), validated once there: the long segments
listed first and cut into chunks of ``CHUNK_ROWS`` rows (one block each
on the card), and, where asked, each row's index on the other side in
the same order. ``seg_sum`` takes a (rows, ...) tensor and a layout and
returns the (n, ...) sums of the live rows:

- on a CUDA tensor it launches ``csrc/seg_sum.cu`` (or raises): each
  segment summed in an order fixed by the layout and the launch shape,
  no atomics on values, so every call on the same inputs gives the same
  bits;
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
# a segment of at least this many live rows is long: cut into chunks of
# CHUNK_ROWS rows, a block of the kernels' 256 threads each (cameras:
# hundreds to thousands of observations); shorter ones take a few threads
# (kernel 5) or one (kernel 6) each (landmarks: a few)
LONG_ROWS = 32
CHUNK_ROWS = 512
# the widest row whose chunk partials fit the layout's scratch (H_cc:
# 144); a wider sum allocates its own
SCRATCH_W = 144
_INT32_MAX = 2 ** 31 - 1

LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


class SegmentLayout(NamedTuple):
    """The live rows of a segment index, grouped by segment.

    n: number of segments; size: rows of the index (O). rows (O_live,)
    int64: the live rows in ascending order; index (O_live,) int64: their
    segments (the plain version's ``index_add_``). perm (O_live,) int32:
    the live rows ordered by segment, ascending within each (a stable
    sort); offsets (n + 1,) int32: segment s holds perm[offsets[s]:
    offsets[s + 1]]; seg_ids (n,) int32: the segments, the ``n_long`` of
    at least ``LONG_ROWS`` rows first, each group in ascending order.
    Chunks: long segment ``li`` (seg_ids[li]) is cut into chunks
    first_chunk[li] .. first_chunk[li + 1] - 1 of ``CHUNK_ROWS`` rows in
    row order; chunk_long (n_chunks,) int32 names each chunk's long
    segment. counters (n_long,) int32, zero between launches, and scratch
    (n_chunks * SCRATCH_W,) float32 are the kernels' working memory for
    the chunks' partials. other (O_live,) int32 or None: each row's index
    on the other side (its landmark when the segments are cameras), in
    perm's order."""
    n: int
    size: int
    rows: torch.Tensor
    index: torch.Tensor
    perm: torch.Tensor
    offsets: torch.Tensor
    seg_ids: torch.Tensor
    n_long: int
    chunk_long: torch.Tensor
    first_chunk: torch.Tensor
    n_chunks: int
    counters: torch.Tensor
    scratch: torch.Tensor
    other: Optional[torch.Tensor] = None


def segment_layout(index: torch.Tensor, n: int, mask: Optional[torch.Tensor] = None,
                   other: Optional[torch.Tensor] = None,
                   n_other: Optional[int] = None) -> SegmentLayout:
    """The layout of ``index`` (O,) into ``n`` segments over the rows where
    ``mask`` (O,) is set (every row without one), on ``index``'s device;
    with ``other`` (O,), an index into ``n_other`` rows on the other side,
    kept for the live rows in the layout's order. Masked rows are left
    out: the solver's masked rows are exact zeros, and its padding slots,
    which all point at segment 0, would otherwise make one long segment.
    Plain torch (stable sort, bincount, cumsum) and two host reads (the
    indices' ranges, checked here once so that the kernels' wrappers check
    only shapes; the counts of long segments and chunks)."""
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
    if other is not None:
        if tuple(other.shape) != tuple(index.shape) or n_other is None:
            raise ValueError(f"segment_layout: other {tuple(other.shape)} for index "
                             f"{tuple(index.shape)}, with n_other {n_other}")
        if n_other > _INT32_MAX:
            raise ValueError("segment_layout: the other side must index in 32 bits")
    seg = index.long()[rows]
    other_live = None if other is None else other.long()[rows]
    reads = [x for ix in (seg, other_live) if ix is not None and ix.numel()
             for x in (ix.min(), ix.max())]
    bounds = iter(torch.stack(reads).tolist() if reads else [])
    for ix, size, what in ((seg, n, "segment"), (other_live, n_other, "other")):
        if ix is not None and ix.numel() and not 0 <= next(bounds) <= next(bounds) < size:
            raise ValueError(f"segment_layout: the {what} index of a live row is outside "
                             f"[0, {size})")
    counts = torch.bincount(seg, minlength=n)
    order = torch.sort(seg, stable=True).indices
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(counts, 0).to(torch.int32)
    long = counts >= LONG_ROWS
    n_chunk = torch.where(long, (counts + CHUNK_ROWS - 1) // CHUNK_ROWS, 0)
    n_long, n_chunks = torch.stack([long.sum(), n_chunk.sum()]).tolist()
    seg_ids = torch.cat([torch.nonzero(long), torch.nonzero(~long)]).reshape(-1)
    per_long = n_chunk[seg_ids[:n_long]]
    first_chunk = torch.zeros(n_long + 1, dtype=torch.int32, device=dev)
    first_chunk[1:] = torch.cumsum(per_long, 0).to(torch.int32)
    chunk_long = torch.repeat_interleave(torch.arange(n_long, device=dev), per_long,
                                         output_size=n_chunks)
    return SegmentLayout(
        n=n, size=index.numel(), rows=rows, index=seg, perm=rows[order].to(torch.int32),
        offsets=offsets, seg_ids=seg_ids.to(torch.int32), n_long=n_long,
        chunk_long=chunk_long.to(torch.int32), first_chunk=first_chunk, n_chunks=n_chunks,
        counters=torch.zeros(n_long, dtype=torch.int32, device=dev),
        scratch=torch.empty(n_chunks * SCRATCH_W, dtype=torch.float32, device=dev),
        other=None if other is None else other_live[order].to(torch.int32))


def seg_sum_plain(values: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``index_add_`` of the live
    rows of ``values`` (rows, ...) into (n, ...), in row order."""
    out = torch.zeros((layout.n,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, layout.index, values.index_select(0, layout.rows))


def bind(source: str, fns, error_fn: str) -> dict:
    """Build (at first use) and load ``source``; set each function's
    argtypes once (``fns``: name -> argtypes, all returning an int status;
    ``error_fn`` maps a status to its message). Returns the bound
    functions by name."""
    lib = cuda_build.load(source)
    bound = getattr(lib, "_bound", None)
    if bound is None:
        bound = {}
        for name, argtypes in fns.items():
            f = getattr(lib, name)
            f.argtypes, f.restype = argtypes, ctypes.c_int
            bound[name] = f
        err = getattr(lib, error_fn)
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        bound[error_fn] = err
        lib._bound = bound
    return bound


# the current stream's handle without building a torch.cuda.Stream object,
# which costs microseconds of host time on every call
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(index: int) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(fn, args, dev: torch.device, error_string, what: str) -> None:
    """Call launcher ``fn`` with ``args`` and the current stream of CUDA
    device ``dev`` (made current for the call if it is not); raise with
    the CUDA error when the launch fails."""
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    if index == current:
        status = fn(*args, _stream(index))
    else:
        with torch.cuda.device(index):
            status = fn(*args, _stream(index))
    if status != 0:
        raise RuntimeError(f"{what} launch failed: " + error_string(status).decode())


def chunk_args(layout: SegmentLayout, scratch: torch.Tensor) -> tuple:
    """The layout's tables in the launchers' order: offsets, seg_ids,
    chunk_long, first_chunk, chunk_rows, counters, scratch, n_long,
    n_chunks, n_seg."""
    return (layout.offsets.data_ptr(), layout.seg_ids.data_ptr(), layout.chunk_long.data_ptr(),
            layout.first_chunk.data_ptr(), CHUNK_ROWS, layout.counters.data_ptr(),
            scratch.data_ptr(), layout.n_long, layout.n_chunks, layout.n)


_VP, _CI = ctypes.c_void_p, ctypes.c_int
# pointer, perm, offsets, seg_ids, chunk_long, first_chunk, chunk_rows,
# counters, scratch, n_long, n_chunks, n_seg, W, out, stream
_SEG_SUM_ARGS = [_VP, _VP, _VP, _VP, _VP, _VP, _CI, _VP, _VP, _CI, _CI, _CI, _CI, _VP, _VP]


def seg_sum(values: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    """Sum the live rows of ``values`` (rows, ...) into the layout's ``n``
    segments: (n, ...). On a CUDA tensor this launches ``csrc/seg_sum.cu``
    (or raises); the plain version runs only for tensors on the CPU."""
    dev = values.device
    if dev.type != "cuda":
        if dev.type == "cpu":
            return seg_sum_plain(values, layout)
        raise ValueError(f"seg_sum: unsupported device {dev}")
    if values.dtype != torch.float32:
        raise TypeError(f"seg_sum: values must be float32, got {values.dtype}")
    if values.dim() < 1 or values.shape[0] != layout.size:
        raise ValueError(f"seg_sum: values {tuple(values.shape)} for a layout of "
                         f"{layout.size} rows")
    if layout.perm.device != dev:
        raise ValueError(f"seg_sum: layout on {layout.perm.device}, values on {dev}")
    tail = values.shape[1:]
    W = 1
    for d in tail:
        W *= d
    if W > _INT32_MAX:
        raise ValueError(f"seg_sum: rows of {W} values do not index in 32 bits")
    if not values.is_contiguous():
        values = values.contiguous()
    out = torch.empty((layout.n,) + tuple(tail), dtype=torch.float32, device=dev)
    scratch = layout.scratch
    if W > SCRATCH_W and layout.n_chunks:
        scratch = torch.empty(layout.n_chunks * W, dtype=torch.float32, device=dev)
    fns = bind(SOURCE, {"seg_sum_launch": _SEG_SUM_ARGS}, "seg_sum_error_string")
    args = ((values.data_ptr(), layout.perm.data_ptr()) + chunk_args(layout, scratch)
            + (W, out.data_ptr()))
    launch(fns["seg_sum_launch"], args, dev, fns["seg_sum_error_string"], "seg_sum")
    global LAUNCHES
    LAUNCHES += 1
    return out
