"""Precision policy: torch dtypes for state and for reductions.

  "single" : positions/velocities/forces and NH-chain/KE scalars in f32
  "mixed"  : f32 state, f64 NH-chain and KE scalars (as the reference's
             mixed precision keeps its chain and KE buffers in double)
  "double" : everything f64 (the ground truth the tests and the chip
             script hold single precision against)

Single precision keeps the two-float compensated positions of
core/state.py for Drude pairs.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    real: torch.dtype      # positions / velocities / forces
    accum: torch.dtype     # KE reductions and NH chain state


_POLICIES = {
    "single": (torch.float32, torch.float32),
    "mixed": (torch.float32, torch.float64),
    "double": (torch.float64, torch.float64),
}


def get_precision(name_or_policy) -> Precision:
    if isinstance(name_or_policy, Precision):
        return name_or_policy
    if name_or_policy not in _POLICIES:
        raise ValueError(f"unknown precision {name_or_policy!r}; "
                         "expected single|mixed|double")
    real, accum = _POLICIES[name_or_policy]
    return Precision(name_or_policy, real, accum)
