"""Carry a JAX-package SystemSpec / SimState across as numpy arrays.

The caller turns the JAX NamedTuples into dicts of numpy arrays
(`{k: np.asarray(v) for k, v in spec._asdict().items()}`); these
functions build the port's dataclasses from them.  The port never imports
JAX: only the tests hold both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.spec import SystemSpec
from .core.state import SimState

_HOST_SPEC = ("nh_nkbt", "nh_eta_mass", "nh_kbt_chain", "nh_link_active")
_SCALAR_SPEC = ("dt", "max_drude_distance", "hardwall_scale",
                "baro_pressure", "baro_kt")
_HOST_STATE = ("eta", "eta_dot", "eta_dot_dot", "ke_sum", "group_ke")


def _tensor(a, device):
    """A copy on `device`; index arrays widen to int64 (torch's index
    type)."""
    t = torch.as_tensor(np.array(a))
    if t.dtype in (torch.int32, torch.int16, torch.int8, torch.uint8):
        t = t.to(torch.int64)
    return t.to(device)


def spec_from_numpy(d: dict, device="cpu") -> SystemSpec:
    """The port's SystemSpec from the JAX SystemSpec fields (numpy)."""
    kw = {}
    for f in SystemSpec.__dataclass_fields__:
        v = d[f]
        if f in _SCALAR_SPEC:
            kw[f] = float(np.asarray(v))
        elif f in _HOST_SPEC:
            kw[f] = _tensor(v, "cpu")
        else:
            kw[f] = _tensor(v, device)
    return SystemSpec(**kw)


def state_from_numpy(d: dict, device="cpu") -> SimState:
    """The port's SimState from the JAX SimState fields (numpy); the cell
    sort (`neighbors`) is rebuilt by the Context, not carried."""
    kw = {}
    for f in ("positions", "velocities", "forces", "potential_energy",
              "box"):
        kw[f] = _tensor(d[f], device)
    for f in _HOST_STATE:
        kw[f] = _tensor(d[f], "cpu")
    kw["step"] = int(np.asarray(d["step"]))
    kw["time"] = float(np.asarray(d["time"]))
    hw = d.get("hardwall_runaway")
    kw["hardwall_runaway"] = torch.as_tensor(
        bool(np.asarray(hw)) if hw is not None else False, device=device)
    pe = d.get("pos_err")
    kw["pos_err"] = _tensor(pe, device) if pe is not None else None
    if "baro_scale" in d:
        kw["baro_scale"] = float(np.asarray(d["baro_scale"]))
        kw["baro_naccept"] = int(np.asarray(d["baro_naccept"]))
        kw["baro_nattempt"] = int(np.asarray(d["baro_nattempt"]))
    kw["baro_gen"] = torch.Generator(device="cpu").manual_seed(0)
    return SimState(**kw)
