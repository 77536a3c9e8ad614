"""Rounding of float32 values to the float types below it, for the
references and their controls: an input rounded so, then multiplied in
float64, is what a product in that type with float32 or wider
accumulation computes."""

from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    away from zero), as the tensor cores read float32 inputs in TF32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 (values within its range of ±448)."""
    return x.to(torch.float8_e4m3fn).float()


ROUNDINGS = {"fp32": lambda x: x.float(), "tf32": tf32, "bf16": bf16,
             "fp8": fp8}
