"""Rounding to the precisions that the references and their controls use.

A control runs a reference in the precision just below the one that the
configuration states: the matcher's bfloat16 descriptors become float8
(e4m3), and bundle adjustment's float32 products with TF32 off become TF32
products. Each rounding here is exact and the same on the CPU and on the
card, so a control reads the same wherever it runs.
"""

from __future__ import annotations

import torch


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (nearest even), held in float32."""
    return x.float().to(torch.bfloat16).float()


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 (nearest even, saturating), held in
    float32."""
    return x.float().clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits (nearest even), held
    in float32: what a TF32 tensor-core product reads of its operands."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + (((i >> 13) & 1) + 0xFFF)) & -8192
    return i.view(torch.float32)


ROUNDERS = {"float64": None, "float32": None, "bfloat16": round_bf16,
            "float8": round_fp8, "tf32": round_tf32}


def rounder(name: str):
    """The rounding of precision ``name`` (None: values stay as they are)."""
    if name not in ROUNDERS:
        raise ValueError(f"unknown precision {name!r} (one of {', '.join(ROUNDERS)})")
    return ROUNDERS[name]
