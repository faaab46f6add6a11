"""Fused exact top-2 kNN matching: a hand-written CUDA kernel for Hopper.

Counterpart of ``reconstructor_tpu/matching/pallas_knn.py``: the TPU
package's Pallas ``_knn_kernel`` becomes ``csrc/knn_top2.cu`` (whose
header says what bounds it on an H100 and how its design answers that),
built with ``nvcc`` for ``sm_90a`` at first use and called through
``ctypes``. Per pair (i, j) of a pair table it returns the row best,
second best and argmin of the masked squared-distance matrix and the
column argmin over image i for the mutual check; the (K, K) distance
matrix never reaches device memory. ``match_all_pairs_fused`` applies
the Lowe ratio and mutual test on those outputs, with the contract of the
TPU package's function of the same name.

``knn_topk2`` is the wrapper: on a CUDA tensor it launches the kernel or
raises; on a CPU tensor it runs ``knn_topk2_plain``, the same function in
plain PyTorch, which is also what the kernel is held against on the card.
bf16 descriptors take the kernel's tensor-core (``wgmma``) product, which
skips the column tiles past each image's last valid slot
(``column_extents``); float32 ones its SIMT product. The packed variant
below takes the same product (``csrc/knn_wgmma.cuh``) and skips the same
way.

Masked slots ride a large-finite bias (1e30) instead of inf so no
inf - inf NaNs can appear in the reductions.

``knn_topk2(..., packed=True)`` is the TPU package's packed variant
(``_knn_kernel_packed``, ``csrc/knn_packed.cu``, its launches counted by
``utils.cuda_build`` under ``knn_packed_launch`` in float32 and
``knn_packed_launch_bf16`` in bf16): each distance is quantised to 2^-17
and packed with its slot in one int32 key, so one integer min gives value
and argmin; its bias is int32 (0 valid / ``_DMAX`` masked) and K <= 4096. As in the TPU
package, ``match_all_pairs_fused`` keeps it off: it is reached only from
the profiling scripts (``scripts/check_packed.py``).
"""

from __future__ import annotations

import ctypes

import torch

from reconstructor_tpu_torch.utils import cuda_build

SOURCE = "matching/csrc/knn_top2.cu"
REPLACES = "reconstructor_tpu/matching/pallas_knn.py:100"   # _knn_kernel
PACKED_SOURCE = "matching/csrc/knn_packed.cu"
PACKED_REPLACES = "reconstructor_tpu/matching/pallas_knn.py:52"   # _knn_kernel_packed
_BIG = 1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# packed keys: distances in [0, 4] scaled by 2^17 into 19 bits, shifted
# over a 12-bit slot; _DMAX marks a masked slot (real distances clip to
# _DMAX - 1), so a best key >= _DMAX << 12 means "no valid column"
_SCALE = 131072.0
_DMAX = (1 << 19) - 1
_INT_MAX = 2**31 - 1
PACKED_MAX_K = 4096

_VP, _CI = ctypes.c_void_p, ctypes.c_int
# desc, dtype code, bias, pair_idx, extent, B, K, D, best, second, arg,
# colarg, (top-2 kernel:) colbest, stream
_TOP2_ARGS = [_VP, _CI, _VP, _VP, _VP, _CI, _CI, _CI, _VP, _VP, _VP, _VP]
_FNS = {"knn_top2_launch": _TOP2_ARGS + [_VP, _VP],
        "knn_top2_wgmma_plan": [_CI, _CI, ctypes.POINTER(_CI)]}
_PACKED_FNS = {"knn_packed_launch": _TOP2_ARGS + [_VP]}


def wgmma_plan(D: int, device: torch.device) -> dict:
    """The bf16 kernel's launch at descriptor width D on ``device``:
    pipeline stages and dynamic shared memory bytes."""
    lib = cuda_build.bind(SOURCE, _FNS, "knn_top2_error_string")
    out = (_CI * 2)()
    cuda_build.check(lib, lib["knn_top2_wgmma_plan"](D, device.index, out), "knn_topk2")
    return {"stages": out[0], "smem_bytes": out[1]}


def supported(K: int, D: int) -> bool:
    """Whether the kernel handles this descriptor layout: K a multiple of
    128, D a multiple of 128 up to 512 (SIFT 128, SuperPoint 256)."""
    return K % 128 == 0 and D % 128 == 0 and 0 < D <= 512


def column_extents(bias: torch.Tensor, valid_below: float = _BIG * 0.5) -> torch.Tensor:
    """Per image, the last valid slot + 1 (0 for none), int32 (N,): the
    bf16 kernels compute the column tiles of image j below its extent only
    and give the masked columns past it in closed form. Any mask, not only
    a prefix: a valid slot is one whose bias is below ``valid_below``,
    1e30 / 2 for the float bias (0 / 1e30) and ``_DMAX`` for the packed
    kernel's int32 bias (0 / ``_DMAX``), which passes the float rule
    everywhere."""
    K = bias.shape[1]
    pos = torch.arange(1, K + 1, dtype=torch.int32, device=bias.device)
    return torch.where(bias < valid_below, pos, 0).amax(1).to(torch.int32).contiguous()


def knn_topk2_plain(desc: torch.Tensor, bias: torch.Tensor, pair_idx: torch.Tensor,
                    pairs_per_batch: int = 16):
    """The kernel's function in plain PyTorch (float32 accumulation).

    desc: (N, K, D) float32 or bfloat16; bias: (N, K) float32 (0 valid /
    1e30 masked); pair_idx: (B, 2) int. Returns (best (B,K), second (B,K),
    arg (B,K) int32, colarg (B,K) int32).
    """
    K = desc.shape[1]
    outs = []
    cols = torch.arange(K, device=desc.device)
    for s in range(0, pair_idx.shape[0], pairs_per_batch):
        pc = pair_idx[s:s + pairs_per_batch].long()
        i, j = pc[:, 0], pc[:, 1]
        sim = torch.matmul(desc[i].float(), desc[j].float().transpose(1, 2))
        dist = torch.clamp(2.0 - 2.0 * sim, min=0.0) + bias[j][:, None, :]
        best, arg = torch.min(dist, dim=2)
        second = torch.amin(torch.where(cols == arg[:, :, None], _BIG, dist), dim=2)
        dist_c = dist + bias[i][:, :, None]
        colmin, colarg = torch.min(dist_c, dim=1)
        # the TPU kernel's running accumulator starts at 1e30 and only
        # takes strictly smaller minima: a column with none keeps row 0
        colarg = torch.where(colmin < _BIG, colarg, 0)
        outs.append((best, second, arg.to(torch.int32), colarg.to(torch.int32)))
    return tuple(torch.cat(t) for t in zip(*outs))


def packed_keys_plain(desc: torch.Tensor, bias: torch.Tensor, pair_idx: torch.Tensor,
                      clip_hi: int, sentinel: bool, pairs_per_batch: int = 16):
    """Packed-key top-2 in plain PyTorch: per pair, int32 distances
    ``di = clip((2 - 2 sim) * 2^17, 0, clip_hi)`` raised to the int32 bias
    of image j, row keys ``(di << 12) | col`` and column keys
    ``(max(di, bias_i) << 12) | row``. A best or second key at or above
    ``_DMAX << 12`` reads 1e30 when ``sentinel``. Shared by the packed
    kernel's plain version and the profiling script's packed level."""
    K = desc.shape[1]
    cols = torch.arange(K, device=desc.device, dtype=torch.int32)
    outs = []
    for s in range(0, pair_idx.shape[0], pairs_per_batch):
        pc = pair_idx[s:s + pairs_per_batch].long()
        i, j = pc[:, 0], pc[:, 1]
        sim = torch.matmul(desc[i].float(), desc[j].float().transpose(1, 2))
        # 2 * sim and the scale are exact: one rounding, as in the kernels
        di = torch.clamp((2.0 - 2.0 * sim) * _SCALE, 0.0, float(clip_hi)).to(torch.int32)
        di = torch.maximum(di, bias[j][:, None, :])
        keys = (di << 12) | cols
        bestk = keys.amin(2)
        secondk = torch.where(keys == bestk[:, :, None], _INT_MAX, keys).amin(2)
        di_c = torch.maximum(di, bias[i][:, :, None])
        colk = ((di_c << 12) | cols[:, None]).amin(1)

        def value(k):
            v = (k >> 12).to(torch.float32) * (1.0 / _SCALE)
            return torch.where(k >= (_DMAX << 12), _BIG, v) if sentinel else v
        outs.append((value(bestk), value(secondk), bestk & 4095, colk & 4095))
    return tuple(torch.cat(t) for t in zip(*outs))


def knn_topk2_packed_plain(desc: torch.Tensor, bias: torch.Tensor, pair_idx: torch.Tensor):
    """The packed kernel's function in plain PyTorch: ``_knn_kernel_packed``
    of the TPU package. bias: (N, K) int32, 0 valid / ``_DMAX`` masked.
    Returns (best, second, arg, colarg) as ``knn_topk2_plain`` does, with
    distances on the 2^-17 grid and masked bests as 1e30."""
    return packed_keys_plain(desc, bias, pair_idx, clip_hi=_DMAX - 1, sentinel=True)


def knn_topk2(desc: torch.Tensor, bias: torch.Tensor, pair_idx: torch.Tensor,
              packed: bool = False):
    """Top-2 kNN outputs for every pair; see ``knn_topk2_plain`` (or, with
    ``packed``, ``knn_topk2_packed_plain``, whose bias is int32).

    On a CUDA tensor this launches ``csrc/knn_top2.cu`` (``packed``:
    ``csrc/knn_packed.cu``) or raises; the plain version runs only for
    tensors on the CPU.
    """
    name = "knn_topk2(packed)" if packed else "knn_topk2"
    N, K, D = desc.shape
    bias_dtype = torch.int32 if packed else torch.float32
    if bias.dtype != bias_dtype or tuple(bias.shape) != (N, K):
        raise ValueError(f"{name}: bias must be {bias_dtype} (N, K), "
                         f"got {bias.dtype} {tuple(bias.shape)}")
    if packed and K > PACKED_MAX_K:
        raise ValueError(f"{name}: the 12-bit slot of a packed key holds K <= "
                         f"{PACKED_MAX_K}, got K={K}")
    if desc.device.type == "cpu":
        return (knn_topk2_packed_plain if packed else knn_topk2_plain)(desc, bias, pair_idx)
    if desc.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {desc.device}")
    B = pair_idx.shape[0]
    if desc.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: descriptors must be float32 or bfloat16, got {desc.dtype}")
    if not supported(K, D):
        raise ValueError(f"{name}: need K % 128 == 0 and D a multiple of 128 up to 512, "
                         f"got K={K} D={D}")
    if pair_idx.dtype != torch.int32 or pair_idx.dim() != 2 or pair_idx.shape[1] != 2:
        raise ValueError(f"{name}: pair_idx must be int32 (B, 2)")
    if not 0 < B <= 65535:
        raise ValueError(f"{name}: 0 < B <= 65535 pairs per launch, got {B}")
    for arg_name, t in (("desc", desc), ("bias", bias), ("pair_idx", pair_idx)):
        if t.device != desc.device:
            raise ValueError(f"{name}: {arg_name} on {t.device}, descriptors on {desc.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg_name} must be contiguous")
    dev = desc.device
    best = torch.empty((B, K), dtype=torch.float32, device=dev)
    second = torch.empty((B, K), dtype=torch.float32, device=dev)
    arg = torch.empty((B, K), dtype=torch.int32, device=dev)
    colarg = torch.empty((B, K), dtype=torch.int32, device=dev)
    outs = (best.data_ptr(), second.data_ptr(), arg.data_ptr(), colarg.data_ptr())
    if packed:
        # the bf16 product skips tiles past the extents; float32's reads none
        bf16 = desc.dtype == torch.bfloat16
        extent = column_extents(bias, valid_below=_DMAX) if bf16 else None
        args = (desc.data_ptr(), _DTYPE_CODE[desc.dtype], bias.data_ptr(), pair_idx.data_ptr(),
                None if extent is None else extent.data_ptr(), B, K, D) + outs
        cuda_build.launch(cuda_build.bind(PACKED_SOURCE, _PACKED_FNS, "knn_packed_error_string"),
                          "knn_packed_launch", args, dev,
                          key="knn_packed_launch_bf16" if bf16 else None)
    else:
        colbest = torch.empty((B, K), dtype=torch.int64, device=dev)   # 64-bit keys
        extent = column_extents(bias)
        args = (desc.data_ptr(), _DTYPE_CODE[desc.dtype], bias.data_ptr(), pair_idx.data_ptr(),
                extent.data_ptr(), B, K, D) + outs + (colbest.data_ptr(),)
        cuda_build.launch(cuda_build.bind(SOURCE, _FNS, "knn_top2_error_string"),
                          "knn_top2_launch", args, dev)
    return best, second, arg, colarg


def match_all_pairs_fused(desc: torch.Tensor, mask: torch.Tensor,
                          pair_idx: torch.Tensor,
                          ratio_thresh: float = 0.7,
                          cross_check: bool = True,
                          compute_dtype: str = "float32"):
    """Fused equivalent of ``matching.knn.match_all_pairs``.

    desc: (N, K, D); mask: (N, K); pair_idx: (P, 2) int32.
    Returns (match_idx (P, K) int32 into image j or -1, match_mask (P, K)).

    compute_dtype="bfloat16" streams descriptors as bf16 with float32
    accumulation: the rounding perturbs distances by ~2^-9 relative, which
    the ratio test and the epipolar gate absorb.
    """
    if compute_dtype == "bfloat16":
        desc = desc.to(torch.bfloat16)
    # the packed kernel stays off here, as at pallas_knn.py:247 (the TPU
    # package measured it slower there); the profiling scripts reach it
    desc = desc.contiguous()
    pair_idx = pair_idx.to(device=desc.device, dtype=torch.int32).contiguous()
    bias = torch.where(mask, 0.0, _BIG).to(torch.float32).contiguous()
    best, second, arg, colarg = knn_topk2(desc, bias, pair_idx)

    i = pair_idx[:, 0].long()
    ratio_ok = best < (ratio_thresh * ratio_thresh) * second
    ok = ratio_ok & mask[i] & (best < _BIG * 0.5)
    if cross_check:
        rows = torch.arange(arg.shape[1], dtype=torch.int32, device=arg.device)
        ok = ok & (torch.gather(colarg, 1, arg.long()) == rows)
    return torch.where(ok, arg, -1).to(torch.int32), ok
