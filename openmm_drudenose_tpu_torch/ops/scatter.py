"""Scatter-adds that sum in the same order on every call.

On a CUDA tensor `Tensor.index_add_` adds by atomics, in whatever order
the threads reach memory, so two runs from the same state drift apart by
float32 rounding within a few hundred steps and a checkpoint does not
replay bit for bit.  `Tensor.index_put_(..., accumulate=True)` on the
card sorts the indices (a stable radix sort) and adds each run of equal
indices in that order: the same bits every call, without PyTorch's global
deterministic mode.  On the CPU `index_add_` already adds in index order.

Every scatter-add of the port goes through this module: `index_add_`
in general, and the int64 fixed-point sum (`fixed_point_shift`,
`fixed_point_add_`, `from_fixed_point`) where a bound on the sums is
known and the sort would cost too much, as in the PME charge spread
(millions of entries a call: sorted, they doubled the PME pass at 100k
atoms on an H100).  Integer adds are exact, so the atomics' order does
not show, and with 62 bits for the bound the sum is finer than a
float32 one.
"""

from __future__ import annotations

import math

import torch


def index_add_(out: torch.Tensor, index: torch.Tensor,
               src: torch.Tensor) -> torch.Tensor:
    """out[index[k]] += src[k] along dim 0, in place, in an order fixed by
    `index`; returns `out`."""
    if out.is_cuda:
        return out.index_put_((index,), src, accumulate=True)
    return out.index_add_(0, index, src)


def zero_rows_(out: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """out[index] = 0 along dim 0, in place; returns `out`.  The indexed
    assignment `out[index] = 0.0` makes a host tensor of the 0 and copies
    it to the card, a copy that waits for the stream; index_fill_ takes
    the 0 as a kernel argument."""
    return out.index_fill_(0, index, 0.0)


def fixed_point_shift(bound: float) -> int:
    """Binary digits after the point of an int64 sum whose partial sums
    never exceed `bound` in magnitude (62 bits for the bound and the
    digits together, one spare)."""
    return 62 - max(0, math.ceil(math.log2(max(float(bound), 1.0))))


def fixed_point_add_(acc: torch.Tensor, index: torch.Tensor,
                     src: torch.Tensor, shift: int) -> torch.Tensor:
    """acc (int64) [index[k]] += round(src[k] * 2**shift) along dim 0, in
    place: the same bits in any order of the adds."""
    fixed = torch.round(src * (2.0 ** shift)).to(torch.int64)
    return acc.index_add_(0, index, fixed)


def from_fixed_point(acc: torch.Tensor, shift: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """The int64 fixed-point sums as `dtype`."""
    return (acc.to(torch.float64) * (2.0 ** -shift)).to(dtype)
