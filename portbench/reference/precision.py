"""The reference's arithmetic: float64, or the control's float32 with
TF32 products.

The configuration states float32 with TF32 off (the program sets
torch.backends.cuda.matmul.allow_tf32 = False).  The nearest precision
below it is TF32: float32 storage and sums, with the operands of every
product a tensor core would take rounded to TF32's 10-bit mantissa.  The
control emulates that where such products occur: the pair displacement
vectors before r^2 and before the force product, and the PME spline
weights and charges of the spread and the gather.
"""

from __future__ import annotations

import dataclasses

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to nearest-even at TF32's 10-bit mantissa."""
    if x.dtype != torch.float32:
        raise ValueError("TF32 rounding takes float32")
    i = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = ((i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF) & 0xFFFFFFFF
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.to(torch.int32).view(torch.float32).reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class Arith:
    """dtype of every quantity; `product` rounds a product's operand."""
    name: str
    dtype: torch.dtype

    def product(self, x: torch.Tensor) -> torch.Tensor:
        return round_tf32(x) if self.name == "tf32" else x


F64 = Arith("f64", torch.float64)
TF32 = Arith("tf32", torch.float32)
