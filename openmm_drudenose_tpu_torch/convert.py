"""Carry a JAX-package SystemSpec / SimState across as numpy arrays.

The caller turns the JAX NamedTuples into dicts of numpy arrays
(`{k: np.asarray(v) for k, v in spec._asdict().items()}`); these
functions build the port's dataclasses from them.  The port never imports
JAX: only the tests hold both packages.

`state_from_jax_checkpoint` reads a checkpoint file of the JAX package
(its app/serialization.py::save_checkpoint: the flattened SimState as
`leaf_0` ... `leaf_{n-1}` and `_n_leaves`), and `load_jax_checkpoint`
puts it into a Context, so a run of the port continues a JAX trajectory.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.spec import SystemSpec
from .core.state import SimState

_SCALAR_SPEC = ("dt", "max_drude_distance", "hardwall_scale",
                "baro_pressure", "baro_kt")
# the NH chain's state (on the device, as the chain's constants)
_CHAIN_STATE = ("eta", "eta_dot", "eta_dot_dot", "ke_sum", "group_ke")


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
    for f in _CHAIN_STATE:
        kw[f] = _tensor(d[f], device)
    kw["step"] = int(np.asarray(d["step"]))
    kw["time"] = float(np.asarray(d["time"]))
    hw = d.get("hardwall_runaway")
    kw["hardwall_runaway"] = torch.as_tensor(
        bool(np.asarray(hw)) if hw is not None else False, device=device)
    pe = d.get("pos_err")
    kw["pos_err"] = _tensor(pe, device) if pe is not None else None
    if d.get("rep_scale") is not None:
        # flat-ensemble NPT: (R,) host scales, move sizes and counters
        kw["rep_scale"] = torch.as_tensor(
            np.array(d["rep_scale"], np.float64))
        kw["baro_scale"] = torch.as_tensor(
            np.array(d["baro_scale"], np.float64))
        for f in ("baro_naccept", "baro_nattempt"):
            kw[f] = torch.as_tensor(np.array(d[f], np.int64))
    elif "baro_scale" in d:
        kw["baro_scale"] = float(np.asarray(d["baro_scale"]))
        kw["baro_naccept"] = int(np.asarray(d["baro_naccept"]))
        kw["baro_nattempt"] = int(np.asarray(d["baro_nattempt"]))
    kw["baro_gen"] = torch.Generator(device="cpu").manual_seed(0)
    return SimState(**kw)


# The JAX SimState's fields in order (openmm_drudenose_tpu/core/state.py:
# 18-52 there); jax.tree.flatten drops the optional ones that are None.
# Each entry: (field, leaf kind, optional).
_JAX_STATE = (
    ("positions", "atoms3_f", False), ("velocities", "atoms3_f", False),
    ("forces", "atoms3_f", False), ("potential_energy", "scalar_f", False),
    ("box", "box", False), ("eta", "f", False), ("eta_dot", "f", False),
    ("eta_dot_dot", "f", False), ("ke_sum", "f", False),
    ("group_ke", "f", False), ("step", "scalar_i", False),
    ("time", "scalar_f", False), ("key", "key", False),
    ("baro_scale", "f", False), ("baro_naccept", "i", False),
    ("baro_nattempt", "i", False), ("hardwall_runaway", "scalar_b", True),
    ("neighbors", "sort", True), ("pos_err", "atoms3_f", True),
    ("rep_scale", "vector_f", True))
# The JAX cell sort's fields in order (forces/cellpair.py:38-75 there,
# CellSort); the port rebuilds the sort, so these leaves are skipped.
_JAX_SORT = (
    ("slot_atom", "vector_i", False), ("inv_slot", "atoms_i", False),
    ("overflow", "scalar_b", False), ("ref_positions", "atoms3_f", False),
    ("image", "atoms3_i", False), ("stencil_invalid", "scalar_b", True),
    ("drift_exceeded", "scalar_b", True), ("pen_atom", "vector_i", True),
    ("pen_inv", "atoms_i", True), ("excl_span_exceeded", "scalar_b", True))


def _leaf_is(a: np.ndarray, kind: str, n: int) -> bool:
    """Whether leaf `a` can be a field of leaf kind `kind` (n atoms)."""
    f = np.issubdtype(a.dtype, np.floating)
    i = np.issubdtype(a.dtype, np.integer)
    b = a.dtype == np.bool_
    return {
        "atoms3_f": f and a.shape == (n, 3),
        "atoms3_i": i and a.shape == (n, 3),
        "atoms_i": i and a.shape == (n,),
        "box": f and a.shape == (3, 3),
        "scalar_f": f and a.shape == (),
        "scalar_i": i and a.shape == (),
        "scalar_b": b and a.shape == (),
        "vector_f": f and a.ndim == 1,
        "vector_i": i and a.ndim == 1,
        "key": a.dtype == np.uint32 and a.shape == (2,),
        "f": f, "i": i,
    }[kind]


def _take(fields, leaves, at, n, path):
    """Match `leaves[at:]` against the field list: ({field: leaf}, the
    next index).  An optional field whose kind does not match the next
    leaf was None in the JAX tree."""
    out = {}
    for name, kind, optional in fields:
        if at < len(leaves) and _leaf_is(leaves[at], kind, n):
            out[name] = leaves[at]
            at += 1
        elif not optional:
            got = (f"leaf_{at} of shape {leaves[at].shape} and dtype "
                   f"{leaves[at].dtype}" if at < len(leaves)
                   else "no more leaves")
            raise ValueError(f"{path}: cannot place the JAX field {name!r}"
                             f" ({kind}): {got}")
    return out, at


def read_jax_checkpoint(path: str) -> dict:
    """The JAX SimState fields of a JAX checkpoint, as numpy arrays by
    name, the cell sort's leaves under "neighbors" (a dict).  Raises
    where the leaf count or a leaf's shape cannot be placed on the JAX
    field lists (a strategy-"cell" Context's neighbour lists among
    them)."""
    with np.load(path, allow_pickle=False) as data:
        if "_n_leaves" not in data:
            raise ValueError(f"{path} is not a JAX checkpoint (no "
                             "_n_leaves)")
        n_leaves = int(data["_n_leaves"])
        names = {f"leaf_{i}" for i in range(n_leaves)}
        extra = set(data.files) - names - {"_n_leaves"}
        if extra or len(names - set(data.files)):
            raise ValueError(f"{path}: the leaves do not match _n_leaves ="
                             f" {n_leaves} (extra {sorted(extra)}, missing "
                             f"{sorted(names - set(data.files))})")
        leaves = [data[f"leaf_{i}"] for i in range(n_leaves)]
    if not leaves or leaves[0].ndim != 2 or leaves[0].shape[1] != 3:
        raise ValueError(f"{path}: leaf_0 is not an (N, 3) positions "
                         "array")
    n = leaves[0].shape[0]
    head = [f for f in _JAX_STATE if f[0] != "neighbors"]
    out, at = _take(head[:17], leaves, 0, n, path)
    if at < n_leaves and _leaf_is(leaves[at], "vector_i", n):
        out["neighbors"], at = _take(_JAX_SORT, leaves, at, n, path)
    tail, at = _take(head[17:], leaves, at, n, path)
    out.update(tail)
    if at != n_leaves:
        raise ValueError(f"{path}: {n_leaves - at} leaves from leaf_{at} "
                         f"on (shape {leaves[at].shape}, dtype "
                         f"{leaves[at].dtype}) fit no JAX SimState field")
    lead = out["group_ke"].shape[:-1]
    if out["eta"].shape[:-2] != lead or out["eta_dot"].shape \
            != out["eta"].shape[:-1] + (out["eta"].shape[-1] + 1,):
        raise ValueError(f"{path}: the chain arrays' shapes {out['eta'].shape}"
                         f", {out['eta_dot'].shape}, group_ke "
                         f"{out['group_ke'].shape} do not agree")
    return out


def state_from_jax_checkpoint(path: str, device=None) -> SimState:
    """The port's SimState from a checkpoint of the JAX package, on
    `device` (CUDA unless the caller passes another).  The positions,
    velocities, cached forces and energy, box, Nose-Hoover chain, the
    step and time, the hard-wall latch, the compensation `pos_err` and,
    in a flat-ensemble NPT run, the per-replica scales with the
    barostat's move sizes and counters are carried.  The cell sort is
    not: the Context rebuilds it.  The JAX PRNG key has no counterpart
    (the port's barostat draws from a torch.Generator seeded by the
    Context's seed), so an NPT run continued from a JAX checkpoint takes
    other random moves than the JAX run would have."""
    from .app.context import default_device
    dev = default_device(device)
    d = read_jax_checkpoint(path)
    d.pop("neighbors", None)
    d.pop("key")
    if d.get("rep_scale") is None:
        for f in ("baro_scale", "baro_naccept", "baro_nattempt"):
            if np.asarray(d[f]).shape != ():
                raise ValueError(f"{path}: {f} of shape "
                                 f"{np.asarray(d[f]).shape} without "
                                 "per-replica scales")
    return state_from_numpy(d, dev)


def load_jax_checkpoint(path: str, context) -> None:
    """Put a JAX checkpoint's state into `context`, built from the same
    System with the same number of replicas: each field in the
    Context's dtype, the cell sort rebuilt at the next step.  The cached
    forces are the JAX run's, so the next step continues it."""
    st = state_from_jax_checkpoint(path, context._device)
    tpl = context._state
    if tuple(st.positions.shape) != tuple(tpl.positions.shape):
        raise ValueError(f"{path} holds {st.positions.shape[0]} atoms, the "
                         f"context {tpl.positions.shape[0]}")
    kw = {}
    for name in ("positions", "velocities", "forces", "potential_energy",
                 "box") + _CHAIN_STATE:
        v, like = getattr(st, name), getattr(tpl, name)
        if tuple(v.shape) != tuple(like.shape):
            raise ValueError(f"{path}: {name} of shape {tuple(v.shape)}, "
                             f"the context's {tuple(like.shape)}")
        kw[name] = v.to(like.device, like.dtype)
    # the compensation where the Context keeps one (float32 with Drude
    # pairs, as setPositions starts it); else folded into the positions
    pe = st.pos_err
    if context._prec.real == torch.float32 and context._static.has_pairs:
        kw["pos_err"] = (pe if pe is not None else torch.zeros_like(
            st.positions)).to(tpl.positions.device, torch.float32)
    else:
        kw["pos_err"] = None
        if pe is not None:
            kw["positions"] = (st.positions.double() + pe.double()).to(
                tpl.positions.dtype)
    if (st.rep_scale is None) != (tpl.rep_scale is None):
        raise ValueError(f"{path}: per-replica scales in the file "
                         f"{st.rep_scale is not None}, in the context "
                         f"{tpl.rep_scale is not None}")
    context._state = st.replace(baro_gen=tpl.baro_gen, neighbors=None, **kw)
    context._forces_valid = True
    context._ke_valid = True
    context._pe_valid = False
