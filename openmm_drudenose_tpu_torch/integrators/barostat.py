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

A flattened replica ensemble with a barostat (flat-ensemble NPT) moves
each replica's volume on its own (`maybe_attempt_mc_move_ensemble`):
its box is the template box times its scale s_r (SimState.rep_scale),
and the energies it compares are the per-replica `mc_energies` of the
terms a volume move changes; `check_ensemble_forces` refuses a force
that would change without such a hook.
"""

from __future__ import annotations

import math

import numpy as np
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


# force types whose energy a molecule-COM volume move leaves unchanged
# (intramolecular: the molecules are the bonded clusters) or that carry
# no energy, and the types whose intermolecular share has a per-replica
# `mc_energies` hook (forces/nonbonded.py, forces/drude.py)
_COM_INVARIANT = ("HarmonicBondForce", "HarmonicAngleForce",
                  "PeriodicTorsionForce", "HarmonicTorsionForce",
                  "CMMotionRemover", "MonteCarloBarostat")
_WITH_HOOK = ("NonbondedForce", "DrudeForce")


def check_ensemble_forces(system) -> None:
    """Raise unless every force of a flat-ensemble NPT system is
    invariant under a molecule-COM volume move or has a per-replica
    mc_energies hook: a force with neither would take part in the
    dynamics but not in the Metropolis test, and bias the volume (the
    JAX package's CustomExternalForce restraints do so, ROADMAP.md C6).
    A force type that gains a hook (the custom forces of ROADMAP.md
    A15) joins _WITH_HOOK with it."""
    for f in system.getForces():
        name = type(f).__name__
        if name not in _COM_INVARIANT + _WITH_HOOK:
            raise ValueError(
                f"flat-ensemble NPT cannot take a {name}: a volume move "
                "changes its energy and it has no per-replica mc_energies "
                "hook for the Metropolis test")


def scale_molecules_per_replica(spec, static, positions, ls):
    """positions with every molecule's centre of mass scaled by its
    replica's ls (R,) (replica-major residues); virtual sites
    re-placed."""
    R = static.ensemble_r
    mom = residue_sum(spec, static, spec.mass[:, None] * positions)
    com = mom * spec.res_inv_mass[:, None]
    ls_res = torch.repeat_interleave(
        torch.as_tensor(ls, dtype=positions.dtype, device=positions.device),
        static.n_residues // R)
    new_pos = positions + (ls_res[spec.resid] - 1.0)[:, None] \
        * com[spec.resid]
    return apply_vsites(spec, static, new_pos)


def maybe_attempt_mc_move_ensemble(spec, static, state, mc_energies_fn,
                                   forces_fn, draws=None):
    """The state after the barostat's per-replica moves at this step
    (unchanged on steps that are not a multiple of static.baro_freq): the
    JAX package's maybe_attempt_mc_move_ensemble (integrators/
    barostat.py:92-177 there).  Each of the R replicas draws its own dV
    at its own volume V0 s_r^3, scales its own molecules' centres, and
    takes its own Metropolis test against its own energy; the molecule
    count is n_residues / R.

    mc_energies_fn(positions, box, neighbors, pos_err, rep_scale) -> (R,)
    float64 energies of the terms a volume move changes, read for the
    trial and the current state in one device-to-host copy;
    forces_fn(..., rep_scale) -> forces, run once at the mixed outcome
    where a replica accepted.  draws: (2, R) numbers in [0, 1) (the dV
    and the acceptance draws) in place of those drawn from
    state.baro_gen.  The adaptive move size follows OpenMM's schedule
    per replica."""
    freq = static.baro_freq
    if freq <= 0 or state.step % freq:
        return state
    R = static.ensemble_r
    n_mol = static.n_residues // R
    if draws is None:
        draws = torch.rand((2, R), generator=state.baro_gen,
                           dtype=torch.float64)
    draws = np.asarray(draws, np.float64).reshape(2, R)
    u_dv, u_acc = draws[0], draws[1]
    vol0 = float(boxutils.volume(state.box.double().cpu()))
    s_old = state.rep_scale.double().numpy()
    vol = vol0 * s_old ** 3
    scale = np.asarray(state.baro_scale, np.float64)
    scale = np.where(scale > 0, scale, 0.01 * vol)
    dv = scale * (2.0 * u_dv - 1.0)
    new_vol = vol + dv
    ls = (new_vol / vol) ** (1.0 / 3.0)
    new_pos = scale_molecules_per_replica(spec, static, state.positions, ls)
    s_new = torch.from_numpy(s_old * ls)
    pe = torch.stack([
        mc_energies_fn(new_pos, state.box, state.neighbors, state.pos_err,
                       s_new),
        mc_energies_fn(state.positions, state.box, state.neighbors,
                       state.pos_err, state.rep_scale)]).cpu().numpy()
    kt = spec.baro_kt
    w = (pe[0] - pe[1] + spec.baro_pressure * dv
         - n_mol * kt * np.log(new_vol / vol))
    with np.errstate(over="ignore"):
        accept = (w <= 0) | (u_acc < np.exp(-w / kt))
    if accept.all():
        state = state.replace(positions=new_pos, rep_scale=s_new)
    elif accept.any():
        acc_atom = torch.repeat_interleave(
            torch.as_tensor(accept, device=new_pos.device),
            static.n_atoms // R)
        state = state.replace(
            positions=torch.where(acc_atom[:, None], new_pos,
                                  state.positions),
            rep_scale=torch.from_numpy(np.where(accept, s_old * ls, s_old)))
    if accept.any():
        state = state.replace(forces=forces_fn(
            state.positions, state.box, state.neighbors, state.pos_err,
            state.rep_scale))
    naccept = np.asarray(state.baro_naccept, np.int64) + accept
    nattempt = np.asarray(state.baro_nattempt, np.int64) + 1
    adapt = nattempt >= 10
    frac = naccept / np.maximum(nattempt, 1)
    shrink = adapt & (frac < 0.25)
    grow = adapt & (frac > 0.75)
    scale = np.where(shrink, scale / 1.1, scale)
    scale = np.where(grow, np.minimum(scale * 1.1, vol * 0.3), scale)
    reset = shrink | grow
    return state.replace(
        baro_scale=torch.from_numpy(scale),
        baro_naccept=torch.from_numpy(np.where(reset, 0, naccept)),
        baro_nattempt=torch.from_numpy(np.where(reset, 0, nattempt)))
