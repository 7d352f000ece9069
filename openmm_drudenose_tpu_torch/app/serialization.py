"""Checkpoints: the whole dynamic state of a Context in one .npz file
(save_checkpoint / load_checkpoint, the checkpoint half of the JAX
package's app/serialization.py).

The file holds every SimState tensor (positions, velocities, forces,
the (3, 3) box, triclinic or not, the compensation, the Nose-Hoover
chain, the latches), the step and time, the barostat's move size,
counters and generator state, and the cell sort with the plan it belongs
to (the (3, 3) box the grid was planned at and the nonbonded options,
such as a grown capacity).  Loading it into a Context of the same System
continues the saved trajectory bit for bit: the same sort, the same sums
(on the card every scatter-add sums in a fixed order, ops/scatter.py,
and both sweep kernels sum in a fixed order), the same random draws.
The format is the port's own (it does not read the JAX package's
checkpoints).  numpy arrays only, no pickled objects.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..forces.cellpair import CellSort

FORMAT = "openmm_drudenose_tpu_torch checkpoint 1"
_TENSORS = ("positions", "velocities", "forces", "potential_energy", "box",
            "eta", "eta_dot", "eta_dot_dot", "ke_sum", "group_ke",
            "hardwall_runaway", "pos_err")
_SORT = ("slot_atom", "inv_slot", "overflow", "ref_positions", "image",
         "stencil_invalid", "drift_exceeded", "excl_span_exceeded")


def save_checkpoint(path: str, context) -> None:
    """Write the Context's full state to `path` (.npz)."""
    st = context._state
    arrays = {"format": np.asarray(FORMAT)}
    for name in _TENSORS:
        v = getattr(st, name)
        if v is not None:
            arrays[f"state.{name}"] = v.detach().cpu().numpy()
    arrays["scalars"] = np.asarray(
        [st.step, st.time, st.baro_scale, st.baro_naccept,
         st.baro_nattempt], np.float64)
    arrays["baro_gen"] = st.baro_gen.get_state().numpy()
    arrays["plan_box"] = np.asarray(context._plan_box, np.float64)
    arrays["nb_options"] = np.asarray(json.dumps(context._nb_options,
                                                 sort_keys=True))
    if st.neighbors is not None:
        for name in _SORT:
            v = getattr(st.neighbors, name)
            if v is not None:
                arrays[f"sort.{name}"] = v.detach().cpu().numpy()
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_checkpoint(path: str, context) -> None:
    """Restore a state written by save_checkpoint into `context`, built
    from the same System; where the saved cell plan differs (a grid
    planned again at another box, a grown capacity), the Context is
    compiled again with the saved one first."""
    with open(path, "rb") as f:
        data = dict(np.load(f, allow_pickle=False))
    if str(data["format"]) != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of this format")
    n = data["state.positions"].shape[0]
    if n != context._static.n_atoms:
        raise ValueError(f"the checkpoint holds {n} atoms, the context "
                         f"{context._static.n_atoms}")
    options = json.loads(str(data["nb_options"]))
    plan_box = data["plan_box"]
    if (options != context._nb_options
            or not np.array_equal(plan_box, context._plan_box)):
        context._nb_options = options
        context._system.setDefaultPeriodicBoxVectors(*map(tuple, plan_box))
        context._build_potential()
    st = context._state
    dev = context._device
    kw = {}
    for name in _TENSORS:
        key = f"state.{name}"
        template = getattr(st, name)
        if key not in data:
            kw[name] = None
            continue
        like = template if template is not None else st.positions
        on_host = like.device.type == "cpu" and name in (
            "eta", "eta_dot", "eta_dot_dot", "ke_sum", "group_ke")
        kw[name] = torch.as_tensor(data[key], dtype=like.dtype,
                                   device="cpu" if on_host else dev)
    step, time, scale, nacc, natt = data["scalars"].tolist()
    gen = torch.Generator(device="cpu")
    gen.set_state(torch.as_tensor(data["baro_gen"]))
    neighbors = None
    if "sort.slot_atom" in data:
        neighbors = CellSort(**{
            name: (torch.as_tensor(data[f"sort.{name}"], device=dev)
                   if f"sort.{name}" in data else None) for name in _SORT})
    context._state = st.replace(
        step=int(step), time=float(time), baro_scale=float(scale),
        baro_naccept=int(nacc), baro_nattempt=int(natt), baro_gen=gen,
        neighbors=neighbors, **kw)
    context._forces_valid = True
    context._ke_valid = True
    context._pe_valid = False
