"""Matrix products of the reference at a stated precision.

"f32" is the reference's own: float32 operands, float32 accumulation, TF32
off. "tf32" is the control that must come out as not correct for a float32
configuration: each operand rounded to TF32's 10-bit mantissa, as the
tensor cores do with TF32 on, accumulated in float32.
"""

from __future__ import annotations

import torch

def set_exact_matmul() -> None:
    """Switch TF32 off for every float32 product (CUDA and cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """`x` (float32) rounded to `precision`, returned as float32."""
    if precision == "f32":
        return x
    if precision == "tf32":
        bits = x.contiguous().view(torch.int32)
        # round to nearest on the 13 dropped mantissa bits
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """a @ b with both operands at `precision`, float32 accumulation."""
    return torch.matmul(round_operand(a, precision), round_operand(b, precision))


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """x @ weight.T + bias, weight [out, in]."""
    return matmul(x, weight.t(), precision) + bias
