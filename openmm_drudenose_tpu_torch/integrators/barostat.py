"""Monte Carlo isotropic barostat (MonteCarloBarostat), as the JAX
package's integrators/barostat.py::maybe_attempt_mc_move does it: every
`baro_freq` steps propose dV, scale the molecules' centres of mass (not
the atoms: each molecule keeps its geometry), evaluate the potential at
the trial box and at the current one, and take the NPT Metropolis test
with OpenMM's adaptive move size.

The host knows the step count, so it chooses the attempt steps itself;
nothing is read back on other steps.  An attempt reads the box once and
the two energies once (one float64 pair), decides on the host and, on
acceptance, runs one force pass at the new configuration (the in-step
force pass is force-only, so the current energy is recomputed too, as
the JAX package's `recompute_current`).  The draws come from the state's
torch.Generator, not jax.random: tests feed both packages the same
numbers through `draws`.
"""

from __future__ import annotations

import math

import torch

from ..constraints.vsites import apply_vsites
from ..forces import boxutils
from ..ops import scatter


def residue_sum(spec, static, x):
    """Per-residue sums (R, 3) of per-atom rows (N, 3)."""
    out = torch.zeros((static.n_residues, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    return scatter.index_add_(out, spec.resid, x)


def scale_molecules(spec, static, positions, box, ls: float):
    """(positions, box) with every molecule's centre of mass scaled by
    `ls` and the whole (3, 3) box by `ls` (a reduced triclinic box stays
    reduced); virtual sites re-placed."""
    mom = residue_sum(spec, static, spec.mass[:, None] * positions)
    com = mom * spec.res_inv_mass[:, None]
    new_pos = positions + (ls - 1.0) * com[spec.resid]
    return apply_vsites(spec, static, new_pos), box * ls


def maybe_attempt_mc_move(spec, static, state, energy_fn, forces_fn,
                          n_mol: int | None = None, draws=None):
    """The state after the barostat's move at this step (unchanged on
    steps that are not a multiple of static.baro_freq).

    energy_fn(positions, box, neighbors, pos_err) -> potential energy (a
    0-d tensor, read as a float64); forces_fn(...) -> forces, run once on
    acceptance.  n_mol defaults to the residue count.  draws: (u_dv,
    u_acc) in [0, 1) in place of the two numbers drawn from
    state.baro_gen."""
    freq = static.baro_freq
    if freq <= 0 or state.step % freq:
        return state
    if n_mol is None:
        n_mol = static.n_residues
    if draws is None:
        draws = torch.rand(2, generator=state.baro_gen,
                           dtype=torch.float64).tolist()
    u_dv, u_acc = (float(u) for u in draws)
    vol = float(boxutils.volume(state.box.double().cpu()))
    scale = state.baro_scale if state.baro_scale > 0 else 0.01 * vol
    dv = scale * (2.0 * u_dv - 1.0)
    new_vol = vol + dv
    ls = (new_vol / vol) ** (1.0 / 3.0)
    new_pos, new_box = scale_molecules(spec, static, state.positions,
                                       state.box, ls)
    pe = torch.stack([
        energy_fn(new_pos, new_box, state.neighbors,
                  state.pos_err).double(),
        energy_fn(state.positions, state.box, state.neighbors,
                  state.pos_err).double()]).tolist()
    kt = spec.baro_kt
    w = (pe[0] - pe[1] + spec.baro_pressure * dv
         - n_mol * kt * math.log(new_vol / vol))
    accept = w <= 0 or u_acc < math.exp(-w / kt)
    if accept:
        state = state.replace(
            positions=new_pos, box=new_box,
            forces=forces_fn(new_pos, new_box, state.neighbors,
                             state.pos_err))
    naccept = state.baro_naccept + int(accept)
    nattempt = state.baro_nattempt + 1
    # adaptive move size (OpenMM MonteCarloBarostatImpl's schedule)
    if nattempt >= 10:
        frac = naccept / nattempt
        if frac < 0.25:
            scale, naccept, nattempt = scale / 1.1, 0, 0
        elif frac > 0.75:
            scale, naccept, nattempt = min(scale * 1.1, vol * 0.3), 0, 0
    return state.replace(baro_scale=scale, baro_naccept=naccept,
                         baro_nattempt=nattempt)
