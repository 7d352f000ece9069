"""Device copies of a compiled object's host tables, made once.

A force term keeps its plan on the host: forces/cellpair.py's
CellPairConfig and forces/pme.py's PmeSetup are frozen dataclasses of
tuples and numpy arrays.  A pass needs some of them on the device, and a
copy from pageable host memory there waits for the stream: one such copy
in each force pass is a host round trip in every step.  `table` makes
each copy once per owner, name, device and dtype and keeps it as long as
the owner lives (a WeakKeyDictionary keyed by the owner: a replan or a
capacity growth makes a new config, and with it new copies).
"""

from __future__ import annotations

import weakref

import torch

_tables: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def table(owner, name: str, build, device, dtype=None) -> torch.Tensor:
    """`owner`'s table `name` on `device` (in `dtype` where given):
    torch.as_tensor(build(), dtype, device) at the first call, the same
    tensor after.  `build` returns host data (a numpy array, a tuple)."""
    device = torch.device(device)
    per = _tables.get(owner)
    if per is None:
        per = _tables[owner] = {}
    key = (name, str(device), dtype)
    hit = per.get(key)
    if hit is None:
        hit = per[key] = torch.as_tensor(build(), dtype=dtype,
                                         device=device)
    return hit
