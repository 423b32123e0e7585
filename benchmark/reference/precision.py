"""Matrix products of the plain reference at a stated precision.

"f32" is exact float32 (TF32 off). The lower precisions, used only by the
controls, round both operands and multiply exactly in float32, so that a
control reads the same on any device:
  "tf32"  operands rounded to 10 mantissa bits (TensorFloat-32);
  "bf16"  operands rounded to bfloat16;
  "fp8"   operands scaled per tensor to float8_e4m3fn's range and rounded.
"""
from __future__ import annotations

import torch

MODES = ("f32", "tf32", "bf16", "fp8")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    # round to nearest even on the 13 mantissa bits TF32 drops
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def rounded(x: torch.Tensor, mode: str) -> torch.Tensor:
    """x rounded to `mode`, differentiable as the identity (a straight
    pass of the gradient, as a low-precision product's backward sees
    it)."""
    if mode == "f32":
        return x
    if mode == "tf32":
        r = _tf32(x.detach())
    elif mode == "bf16":
        r = x.detach().to(torch.bfloat16).to(torch.float32)
    elif mode == "fp8":
        r = _fp8(x.detach())
    else:
        raise ValueError(f"unknown precision {mode!r}; one of {MODES}")
    return x + (r - x).detach()


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           mode: str = "f32") -> torch.Tensor:
    """x @ w + b, w (in, out), with both operands at `mode`."""
    return torch.matmul(rounded(x, mode), rounded(w, mode)) + b
