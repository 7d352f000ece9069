"""What decides `correct`: the program's outputs against the plain
reference of the configuration's system module (portbench/systems/;
SWM4-NDP water's is portbench/reference/), run after the window has closed, the
peak memory has been read and the program has been freed.

MD is chaotic, so no reference follows a whole window; it is checked at
both ends.

  the start   The program's first call (check_steps steps through the
              window's own entry, in set-up) from the benchmark's
              inputs, against the reference's float64 steps from the
              same inputs:
                start_x_nm      largest position gap of a massive site
                start_v_rel     rms velocity gap over rms velocity
                start_nh_rel    largest gap of a bath's chain velocity
                                over the largest chain velocity
  the end     The forces of the window's last force pass, at the
              positions the window reached and in the program's own
              boxes (a barostat moves them), against the reference's
              float64 forces there:
                end_f_rms_rel   rms force gap over rms force
                end_f_max_rel   largest force gap over largest force
              and the guarantees the configuration states, at those
              positions:
                wall_ratio      largest core-Drude distance over the
                                hard wall (the wall is the last move of
                                a Drude in a step)
                steps_missing   steps asked for less steps the state
                                counts (limit 0)
              The rigid bonds are no guarantee at a step's end: the
              hard wall moves a core after SHAKE, and float32
              coordinates hold a bond to a few ulps of the box edge
              (4e-5 of its length at 1M).  The start's positions check
              the constraint step against the reference's SHAKE.

The control is the reference in float32 with TF32 products
(reference/precision.py) in the program's place: its first steps and its
forces after them, against the float64 reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import precision


# the numbers the control gives (the guarantees are the program's alone)
CONTROLLED = ("start_x_nm", "start_v_rel", "start_nh_rel", "end_f_rms_rel",
              "end_f_max_rel")


def _massive(topo):
    return np.asarray(topo.massive)


def _gap_x(a, b, edge):
    d = a - b
    return d - edge * np.round(d / edge)


def start_numbers(topo, ref_state, got: dict) -> dict:
    """The start's numbers of `got` (host arrays x, v, eta_dot) against
    the reference's state after the same steps (in the configuration's
    box: no barostat attempt comes before them)."""
    m = _massive(topo)
    xr = ref_state.x.double().cpu().numpy()
    vr = ref_state.v.double().cpu().numpy()
    er = ref_state.eta_dot.double().cpu().numpy()
    dx = _gap_x(got["x"], xr, topo.box)[:, m]
    dv = (got["v"] - vr)[:, m]
    de = got["eta_dot"] - er
    return {
        "start_x_nm": float(np.sqrt(np.max(np.sum(dx * dx, -1)))),
        "start_v_rel": float(np.sqrt(np.sum(dv * dv)
                                     / np.sum(vr[:, m] ** 2))),
        "start_nh_rel": float(np.max(np.abs(de)) / np.max(np.abs(er))),
    }


def force_numbers(topo, f_ref, f_got) -> dict:
    m = _massive(topo)
    fr, fg = f_ref[:, m], f_got[:, m]
    d = fg - fr
    n2r = np.sum(fr * fr, -1)
    n2d = np.sum(d * d, -1)
    return {"end_f_rms_rel": float(np.sqrt(n2d.mean() / n2r.mean())),
            "end_f_max_rel": float(np.sqrt(n2d.max() / n2r.max()))}


def guarantee_numbers(topo, cfg, x, steps_missing) -> dict:
    core, drude = topo.drude_pairs
    r_od = np.linalg.norm(x[:, drude] - x[:, core], axis=-1)
    wall = cfg["integrator"]["max_drude_distance_nm"]
    return {"wall_ratio": float(r_od.max() / wall),
            "steps_missing": float(steps_missing)}


def forces_at(field, x, boxes) -> np.ndarray:
    """The reference's forces (R, n0, 3) at positions x (R, n0, 3), each
    replica in its own (3, 3) box of `boxes` (R, 3, 3), as float64 host
    arrays; replicas that share a box in one call."""
    boxes = np.asarray(boxes, np.float64)
    out = np.empty(x.shape, np.float64)
    uniq, which = np.unique(boxes.reshape(len(boxes), 9), axis=0,
                            return_inverse=True)
    for k, box in enumerate(uniq):
        idx = np.flatnonzero(which.reshape(-1) == k)
        f = field.at_box(box.reshape(3, 3)).forces(
            torch.as_tensor(x[idx], device=field.device))
        out[idx] = f.double().cpu().numpy()
    return out


def program_numbers(sysmod, cfg, traffic, x0, v0, start, end,
                    expected_steps, device) -> dict:
    """Every number of the program's run (start and end states as host
    arrays, Program.state's form); the reference is the system module's
    (portbench/systems/).  The end's forces are the reference's at the
    program's positions, in the program's boxes."""
    w, field, integ = sysmod.reference(cfg, device, precision.F64)
    st = integ.start(torch.as_tensor(x0), torch.as_tensor(v0))
    for _ in range(int(traffic["check_steps"])):
        st = integ.step(st)
    out = start_numbers(w, st, start)
    del st
    f_ref = forces_at(field, end["x"], end["box"])
    out.update(force_numbers(w, f_ref, end["f"]))
    out.update(guarantee_numbers(w, cfg, end["x"],
                                 expected_steps - end["step"]))
    return out


def control_numbers(sysmod, cfg, traffic, x0, v0, device) -> dict:
    """The control's numbers: the TF32 reference in the program's
    place, its check_steps steps and its forces after them against the
    float64 reference."""
    w, field, integ = sysmod.reference(cfg, device, precision.F64)
    _, cfield, cinteg = sysmod.reference(cfg, device, precision.TF32)
    st = integ.start(torch.as_tensor(x0), torch.as_tensor(v0))
    ct = cinteg.start(torch.as_tensor(x0), torch.as_tensor(v0))
    for _ in range(int(traffic["check_steps"])):
        st = integ.step(st)
        ct = cinteg.step(ct)
    got = {"x": ct.x.double().cpu().numpy(), "v": ct.v.double().cpu().numpy(),
           "eta_dot": ct.eta_dot.double().cpu().numpy()}
    out = start_numbers(w, st, got)
    x = st.x
    f_ref = field.forces(x).double().cpu().numpy()
    f_ctl = cfield.forces(x.float()).double().cpu().numpy()
    out.update(force_numbers(w, f_ref, f_ctl))
    return out


def judge(numbers: dict, limits: dict) -> list:
    """[(name, value, limit, ok)] for every number the cell limits; a
    limited number that is missing or not finite fails."""
    rows = []
    for name, lim in limits.items():
        v = numbers.get(name)
        ok = v is not None and np.isfinite(v) and v <= float(lim)
        rows.append((name, v, float(lim), bool(ok)))
    return rows
