"""PCG's 3 x 3 point-block products in one streaming pass: a hand-written
CUDA kernel for Hopper (kernel 8).

The implicit-Schur PCG (``ba/distributed.py``) multiplies every landmark's
inverse block H_pp^-1[l] into a (L, 3) vector once every CG iteration (the
matvec's H_pp^-1 W^T u) and twice a trial (the reduced rhs, the point
step). The inverse is kept as ``ba.lm._inv3x3_soa``'s (9, L) planes, plane
3 i + j holding entry (i, j) of every block. ``block3_matvec(h9, v)``
returns out[l] = H_pp^-1[l] v[l], (L, 3):

- on CUDA tensors one launch of ``csrc/point_blocks.cu`` (or a raise): the
  planes and v read once, in place, each output rounded in one fixed
  order, (fma(a1, x1, a0 x0) + a2 x2) + 0, which
  ``block3_matvec_reference`` computes on any device. At the benchmark's
  L it is the order the einsum it replaces took on an H100, so a solve
  there takes the same LM iterations bit for bit;
- on CPU tensors ``block3_matvec_plain``: the einsum the port ran before,
  on the same strided (L, 3, 3) view of the planes, so a CPU solve
  computes what it computed then.

The JAX package leaves these products to XLA
(``reconstructor_tpu/ba/distributed.py:120, 127, 142``); no Pallas kernel.
``LAUNCHES`` counts kernel launches (plain-version calls do not count).
The kernel is built with ``nvcc`` for ``sm_90a`` at its first call and
called through ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from reconstructor_tpu_torch.ba import cuda_segsum

SOURCE = "ba/csrc/point_blocks.cu"
# no Pallas kernel: the einsum XLA runs there (the rhs :127, the point step :142)
REPLACES = "reconstructor_tpu/ba/distributed.py:120"

LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def block3_matvec_plain(h9: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``einsum`` over the (L, 3, 3)
    view of the planes h9 (9, L), with v (L, 3)."""
    return torch.einsum("lij,lj->li", h9.T.reshape(h9.shape[1], 3, 3), v)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """float64 values rounded to float32 (nearest, ties to even), kept in
    float64."""
    return x.float().double()


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fma(a, b, c), rounded once, of float64 tensors that hold
    float32 values: a b is exact in float64 (48 bits); a b + c is rounded
    to odd there (the nearest sum, moved one step towards the exact sum
    when inexact and even), which 53 >= 24 + 2 bits round on to float32
    as the exact sum would."""
    p = a * b
    s = p + c
    pp = s - c
    e = (p - pp) + (c - (s - pp))                       # s + e == p + c exactly
    towards = torch.where(e > 0, torch.inf, -torch.inf).to(s)
    even = (s.view(torch.int64) & 1) == 0
    return _f32(torch.where((e != 0) & even, torch.nextafter(s, towards), s))


def block3_matvec_reference(h9: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel's function in its order and roundings, on any device:
    out[l, i] = (fma(a1, x1, a0 x0) + a2 x2) + 0, a_j = h9[3 i + j, l],
    x_j = v[l, j], each float32 rounding made explicit in float64 (a
    product or a sum of two float32 values rounds there as in float32).
    What the card tests and ``chip_smoke.py`` hold kernel 8 against."""
    h, x = h9.double(), v.double()
    rows = []
    for i in range(3):
        a0, a1, a2 = h[3 * i], h[3 * i + 1], h[3 * i + 2]
        t = _fma32(a1, x[:, 1], _f32(a0 * x[:, 0]))
        rows.append(_f32(t + _f32(a2 * x[:, 2])) + 0.0)
    return torch.stack(rows, 1).float()


_VP = ctypes.c_void_p
# h9, v, out, L, stream
_FNS = {"block3_matvec_launch": [_VP, _VP, _VP, ctypes.c_longlong, _VP]}


def block3_matvec(h9: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """H_pp^-1[l] v[l] for every landmark: h9 (9, L) planes, v (L, 3) ->
    (L, 3). On CUDA tensors one launch of ``csrc/point_blocks.cu`` (or a
    raise: float32, contiguous, one card); the plain version runs only for
    tensors on the CPU."""
    dev = h9.device
    if dev.type == "cpu":
        return block3_matvec_plain(h9, v)
    if dev.type != "cuda":
        raise ValueError(f"block3_matvec: unsupported device {dev}")
    if h9.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"block3_matvec: h9 and v must be float32, got {h9.dtype}, {v.dtype}")
    if h9.dim() != 2 or h9.shape[0] != 9 or tuple(v.shape) != (h9.shape[1], 3):
        raise ValueError(f"block3_matvec: h9 {tuple(h9.shape)} and v {tuple(v.shape)}, "
                         "want (9, L) and (L, 3)")
    if v.device != dev:
        raise ValueError(f"block3_matvec: h9 on {dev}, v on {v.device}")
    if not (h9.is_contiguous() and v.is_contiguous()):
        raise ValueError("block3_matvec: h9 and v must be contiguous")
    L = h9.shape[1]
    out = torch.empty(L, 3, dtype=torch.float32, device=dev)
    if L == 0:
        return out
    fns = cuda_segsum.bind(SOURCE, _FNS, "block3_matvec_error_string")
    args = (h9.data_ptr(), v.data_ptr(), out.data_ptr(), L)
    cuda_segsum.launch(fns["block3_matvec_launch"], args, dev,
                       fns["block3_matvec_error_string"], "block3_matvec")
    global LAUNCHES
    LAUNCHES += 1
    return out
