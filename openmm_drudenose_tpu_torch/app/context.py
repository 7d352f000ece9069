"""Context: binds a System and a DrudeTGNHIntegrator into a simulation.

OpenMM-shaped semantics (setPositions, setVelocities,
setVelocitiesToTemperature, setPeriodicBoxVectors, applyConstraints,
applyVelocityConstraints, minimizeEnergy, reinitialize, getState, step,
setParameter / getParameter(s)) as in the JAX package's app/context.py.  The in-step force pass
(`_forces_only`, the JAX forces_only :248) adds the direct-space sweep
forces (kernel B1 or B2 in float32 on the cell-pair strategy, the dense
sum on the dense one), the analytic PME reciprocal forces (Ewald/PME), the
exception/correction/NBFIX terms and the Drude forces at the
virtual-site-composed positions, then moves site forces onto their
parents.  The pair and reciprocal sums of the nonbonded term come from
the Context's `_pair_sum` (`PairSum`, this process's whole sums; parallel/
sharded.py swaps in one split over torch.distributed ranks), the rest of
the pass is the same whichever it is.  `_potential` is the energy (the kernels' energy instantiation
for the direct space in float32 on the cell-pair strategy), summed in
float64.  `step` (:564 there) alternates a cell-sort rebuild with a
block of `rebuild_interval` fused steps and reads the overflow and
stencil latches once per 8 blocks; the drift, excl-span and hard-wall
latches are checked at the end of each call (:630-700 there).  A
MonteCarloBarostat moves the volume inside the steps
(integrators/barostat.py); where a shrink leaves the cell stencil short
of the cutoff, the cell grid and the PME grid are planned again at the
current box (:438-447 there).

Boxes are orthorhombic or triclinic in OpenMM's reduced form
(forces/boxutils.py).  The state holds the (3, 3) box; the terms take
its diagonal for an orthorhombic system (every sum as before, bit for
bit) and the whole matrix for a triclinic one (`_box_arg`, the JAX
package's mi_box).

A flattened replica ensemble (ensemble_r = R > 1, built by
parallel/flatrep.py with nb_options={"ensemble": [R, rx, rz]}; the JAX
package's app/context.py:80-116) holds R replica-major copies of one
replica's system in one box: (R, G+2) baths, per-replica KE sums and
group temperatures, capacity growth binned in the replicas' frame.  With
a MonteCarloBarostat it runs flat-ensemble NPT (the JAX package's
SimState.rep_scale): the state's box is the template box, replica r's is
that times s_r, every force and energy pass takes the scales (their
device copy, `_dev_scale`), each replica moves its own volume
(integrators/barostat.py::maybe_attempt_mc_move_ensemble, against
`_mc_energies`), and the cells are binned at p / s_r on the template
grid.  Where the smallest replica outgrows the stencil's slack, the grid
is planned again at the template box times min(s), the scales divided by
it (`_replan_at_box`); a box too small for a regular grid there raises.

The custom forces' global parameters live in the Context
(`_parameters`, from the forces' defaults): setParameter changes the
compiled terms' values and leaves the System as it is, as OpenMM's
Context does (the JAX package writes the System's default: ROADMAP.md
C19).

Entry points run on CUDA unless the caller passes device="cpu"; a Context
without a device on a machine without CUDA raises.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from .. import precision as precision_mod
from ..constraints import settle, shake
from ..constraints.vsites import (apply_vsites, apply_vsites_relative,
                                  spread_vsite_forces)
from ..core import spec as spec_mod
from ..core.state import zeros_state
from ..forces import boxutils, cellpair
from ..integrators import barostat, tgnh
from ..units import BOLTZ


def default_device(device=None) -> torch.device:
    """The device entry points run on: CUDA unless the caller asks for
    another; without CUDA and without a choice this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return torch.device("cuda")


def exact_positions(spec, static, positions, pos_err):
    """Float64 positions with the virtual sites, at positions + pos_err:
    the positions the integrator carries, before rounding to float32
    (None without pos_err).  The nonbonded terms take their distances
    from them: an SWM4-NDP core and its Drude carry +-1.7 e about
    0.01 nm apart, and the independent float32 rounding of the two
    (~1e-6 nm at 16 nm from the origin) shows in the field of that
    dipole at ~1e-4 of max|F|."""
    if pos_err is None:
        return None
    return apply_vsites_relative(spec, static,
                                 positions.double() + pos_err.double())


def compensation(term, pos_err, exact) -> dict:
    """The compensation a term reads: the float64 positions (`exact`)
    for the bonded terms, pos_err for the Drude springs."""
    if getattr(term, "takes_exact", False):
        return {"exact": exact}
    return {"pos_err": pos_err}


def force_pass(spec, static, positions, pos_err, box_t, pair, terms,
               with_forces=True, exact_fn=None, term_kw=None):
    """The force pass over one set of rows: the total force, or with
    with_forces off the potential energy (float64, 0-d, each part in the
    positions' type summed in float64).  The virtual sites are composed
    and their float64 form taken (`exact_fn(positions, pos_err)`, by
    default exact_positions); pair(pos, exact) gives the nonbonded sums'
    forces or energy; each term adds its own, reading its `compensation`
    and term_kw(term); the forces on the sites are spread onto their
    parents.  A Context runs it on its whole system; parallel/resident.py
    on a rank's molecules."""
    pos = apply_vsites(spec, static, positions)
    exact = (exact_fn(positions, pos_err) if exact_fn is not None
             else exact_positions(spec, static, positions, pos_err))
    out = pair(pos, exact)
    for term in terms:
        kw = compensation(term, pos_err, exact)
        if term_kw is not None:
            kw.update(term_kw(term))
        r = term.energy_forces(pos, box_t, with_forces=with_forces, **kw)
        out = out + (r[1] if with_forces else r[0].double())
    if not with_forces:
        return out
    return spread_vsite_forces(spec, static, out, pos)


class PairSum:
    """The nonbonded term's direct-space sweep and PME reciprocal sum, in
    this process: a Context's default `_pair_sum`.  parallel/sharded.py::
    ShardedForcePass takes its place where the ranks of a torch.
    distributed mesh split the two sums; every other term of the force
    pass stays the Context's."""

    def pair_forces(self, nb, pos, box_t, neighbors, exact, s):
        """The sweep's and the reciprocal sum's forces (N, 3)."""
        f = nb.sweep_forces(pos, box_t, neighbors, exact, rep_scale=s)
        if nb.pme is not None:
            f = f + nb.recip(pos, box_t, exact, rep_scale=s)[1]
        return f

    def pair_energy(self, nb, pos, box_t, neighbors, exact, s):
        """Their energy, each part in the positions' type summed in
        float64."""
        e = nb.sweep_energy(pos, box_t, neighbors, exact,
                            rep_scale=s).double()
        if nb.pme is not None:
            e = e + nb.recip_energy(pos, box_t, exact, rep_scale=s).double()
        return e


class State:
    """Snapshot of simulation data, OpenMM State-shaped."""

    def __init__(self, positions=None, velocities=None, forces=None,
                 kinetic_energy=None, potential_energy=None, time=None,
                 box=None, group_temperatures=None, step=None):
        self._positions = positions
        self._velocities = velocities
        self._forces = forces
        self._ke = kinetic_energy
        self._pe = potential_energy
        self._time = time
        self._box = box
        self._group_temps = group_temperatures
        self._step = step

    def getPositions(self, asNumpy: bool = True):
        return self._positions

    def getVelocities(self, asNumpy: bool = True):
        return self._velocities

    def getForces(self, asNumpy: bool = True):
        return self._forces

    def getKineticEnergy(self):
        return self._ke

    def getPotentialEnergy(self):
        return self._pe

    def getTime(self):
        return self._time

    def getStepCount(self):
        return self._step

    def getPeriodicBoxVectors(self, asNumpy: bool = True):
        return self._box

    def getGroupTemperatures(self):
        """Per-bath temperatures [group0..G-1, COM, Drude] in K."""
        return self._group_temps


class Context:
    def __init__(self, system, integrator, precision="single",
                 strategy: str = "auto", seed: int = 0,
                 hardwall_strict: bool = False,
                 nb_options: dict | None = None, device=None,
                 ensemble_r: int = 1):
        """strategy: the nonbonded pair sum, "dense", "cellpair", "cell"
        (neighbour lists, forces/neighborlist.py) or "auto" (the JAX
        package's rule, forces/nonbonded.py::choose_strategy).  seed: the barostat's generator.
        hardwall_strict: raise when a Drude moved more than twice past
        the hard wall (the Reference platform's throw) instead of
        bouncing it, warning once and latching hardwallRunaway.
        nb_options: {"capacity": C} pins the cell capacity (the bench
        pins the one its snapshot was measured with); {"grid_x_multiple":
        D} rounds the cell grid's x down to a multiple of D (x-slabs over
        D ranks, parallel/sharded.py); {"use_pallas": 3}
        sends the float32 sweep to the chunked kernel B2 whatever the
        gates say (the JAX option of that name); "skin",
        "rebuild_interval", "max_neighbors", "density_margin" size the
        neighbour lists of strategy "cell".  ensemble_r: the
        replicas of a flattened ensemble (parallel/flatrep.py, which
        also passes nb_options {"ensemble": [R, rx, rz]} and, with a
        MonteCarloBarostat, sets the per-replica scales)."""
        # full-float32 products wherever a matmul could reach r^2 or
        # forces (TF32 keeps ~3 decimal digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._device = default_device(device)
        self._system = system
        self._integrator = integrator
        integrator._context = self
        self._strategy = strategy
        self._seed = int(seed)
        self._hardwall_strict = bool(hardwall_strict)
        self._hardwall_warned = False
        self._drift_warned = False
        self._prec = precision_mod.get_precision(precision)
        self._nb_options = dict(nb_options or {})
        self._ensemble_r = int(ensemble_r)
        # the Context's values of the custom forces' global parameters,
        # from the forces' defaults (OpenMM's Context::setParameter
        # changes these, not the System)
        self._parameters = self._default_parameters()
        if self._ensemble_r > 1 and any(
                type(f).__name__ == "MonteCarloBarostat"
                for f in system.getForces()):
            barostat.check_ensemble_forces(system)
        # (host scales, their device copy) of the last few rep_scale
        # tensors (the current, a move's trial and its outcome)
        self._scale_cache = []
        # the nonbonded pair and reciprocal sums (a parallel/sharded.py
        # ShardedForcePass over ranks)
        self._pair_sum = PairSum()
        self._state = None
        self._init_spec_and_state()

    def _init_spec_and_state(self) -> None:
        """Compile the system and start a zero state (positions,
        velocities and thermostat state unset)."""
        r, a = self._prec.real, self._prec.accum
        self._spec, self._static, init_edd = spec_mod.build_spec(
            self._system, self._integrator, r, a, self._device,
            ensemble_r=self._ensemble_r)
        self._ke_valid = False
        self._state = None
        self._build_potential()
        box = np.array(self._system.getDefaultPeriodicBoxVectors(),
                       np.float64)
        st = zeros_state(self._static.n_atoms, self._static.n_baths,
                         self._static.n_chains, box, r, a, self._device,
                         seed=self._seed, ensemble_r=self._ensemble_r)
        self._state = st.replace(eta_dot_dot=torch.as_tensor(init_edd,
                                                             dtype=a))
        self._forces_valid = False
        self._pe_valid = False

    # -- compilation ----------------------------------------------------------
    def _build_potential(self) -> None:
        """(Re)compile the force terms; re-run when the cell capacity
        grows, the exclusion skip is turned off or the cell grid is
        planned again at a new box."""
        r = self._prec.real
        self._nb = None
        self._terms = []
        for f in self._system.getForces():
            if type(f).__name__ == "NonbondedForce":
                term = f.compile(self._system, r, self._device,
                                 nb_options=self._nb_options,
                                 strategy=self._strategy)
                if self._nb is not None:
                    raise NotImplementedError("one NonbondedForce only")
                self._nb = term
            elif hasattr(f, "compile"):
                term = f.compile(self._system, r, self._device)
                if term is not None:
                    self._terms.append(term)
        self._push_parameters()
        self._cp_cfg = self._nb.cfg if self._nb is not None else None
        self._rebuild_interval = (self._cp_cfg.rebuild_interval
                                  if self._cp_cfg is not None else None)
        self._plan_box = np.array(self._system.getDefaultPeriodicBoxVectors(),
                                  np.float64)
        self._triclinic = boxutils.is_triclinic(self._plan_box)
        stats = getattr(getattr(self, "_stepper", None), "shake_stats", None)
        self._stepper = tgnh.Stepper(
            self._static, self._forces_only,
            self._mc_move if self._static.baro_freq else None)
        # a recompile (capacity growth, a replan) keeps the SHAKE counts
        self._stepper.shake_stats = stats
        self._pe_valid = False
        if self._state is not None:
            self._state = self._state.replace(neighbors=None)
            self._forces_valid = False

    def _mc_move(self, spec, state):
        """The barostat's move at this step (integrators/barostat.py):
        one box, or each replica's with per-replica scales."""
        if state.rep_scale is not None:
            return barostat.maybe_attempt_mc_move_ensemble(
                spec, self._static, state, self._mc_energies,
                self._forces_only)
        return barostat.maybe_attempt_mc_move(
            spec, self._static, state, self._potential, self._forces_only)

    def _dev_scale(self, rep_scale):
        """The device copy of host scales (None for None), made once per
        scale tensor: the state's scales change only on an accepted
        move."""
        if rep_scale is None:
            return None
        for host, dev in self._scale_cache:
            if host is rep_scale:
                return dev
        dev = rep_scale.to(device=self._device, dtype=torch.float64)
        self._scale_cache = [(rep_scale, dev)] + self._scale_cache[:2]
        return dev

    def _scale_kw(self, term, scale):
        """The per-atom scales a term takes with per-replica boxes (the
        DrudeForce's NBTHOLE pairs image in their replica's box)."""
        if scale is None or not hasattr(term, "mc_energies"):
            return {}
        return {"scale": scale}

    def _exact_positions(self, positions, pos_err):
        """exact_positions on the Context's system."""
        return exact_positions(self._spec, self._static, positions,
                               pos_err)

    def _box_arg(self, box):
        """The box the terms take: the (3, 3) matrix when the system is
        triclinic, else its diagonal (boxutils.mi_box)."""
        return boxutils.mi_box(box, self._triclinic)

    def _forces_only(self, positions, box, neighbors, pos_err,
                     rep_scale=None, pair_sum=None):
        """Total force on the particles (no energy); rep_scale: the host
        per-replica scales of flat-ensemble NPT; pair_sum: the nonbonded
        pair and reciprocal sums (None: the Context's `_pair_sum`)."""
        return self._pass(positions, box, neighbors, pos_err, rep_scale,
                          pair_sum, True)

    def _potential(self, positions, box, neighbors, pos_err,
                   rep_scale=None, pair_sum=None):
        """Total potential energy, a float64 0-d tensor: each part in the
        positions' type (the direct space by the kernels' energy
        instantiation on the cell-pair strategy in float32, in float64
        there) and the parts summed in float64, so that the barostat's
        Metropolis test sees no float32 rounding of |E| (~1e6 kJ/mol at
        100k atoms, where a float32 ulp is 0.06-0.12 kJ/mol).  rep_scale,
        pair_sum: as _forces_only."""
        return self._pass(positions, box, neighbors, pos_err, rep_scale,
                          pair_sum, False)

    def _pass(self, positions, box, neighbors, pos_err, rep_scale,
              pair_sum, with_forces):
        """force_pass on the Context's terms."""
        box_t = self._box_arg(box)
        nb = self._nb
        s = self._dev_scale(rep_scale)
        atom_s = None if s is None else cellpair.atom_scales(
            s, positions.shape[0])
        sums = pair_sum or self._pair_sum

        def pair(pos, exact):
            if nb is None:
                return (torch.zeros_like(pos) if with_forces else
                        torch.zeros((), dtype=torch.float64,
                                    device=pos.device))
            if with_forces:
                f = sums.pair_forces(nb, pos, box_t, neighbors, exact, s)
                return f + nb.extras(pos, box_t, exact, rep_scale=s)[1]
            e = sums.pair_energy(nb, pos, box_t, neighbors, exact, s)
            return e + nb.extras(pos, box_t, exact, with_forces=False,
                                 rep_scale=s)[0].double()

        return force_pass(self._spec, self._static, positions, pos_err,
                          box_t, pair, self._terms, with_forces,
                          self._exact_positions,
                          lambda term: self._scale_kw(term, atom_s))

    def _mc_energies(self, positions, box, neighbors, pos_err, rep_scale):
        """(R,) float64 per-replica energies of every term a molecule-COM
        volume move changes (the JAX Context's summed mc_energies hooks):
        the NonbondedForce's (sweep, PME, dispersion, NBFIX) and the
        DrudeForce's NBTHOLE pairs."""
        box_t = self._box_arg(box)
        pos = apply_vsites(self._spec, self._static, positions)
        exact = self._exact_positions(positions, pos_err)
        s = self._dev_scale(rep_scale)
        e = self._nb.mc_energies(pos, box_t, neighbors, exact, s)
        atom_s = cellpair.atom_scales(s, pos.shape[0])
        for term in self._terms:
            if hasattr(term, "mc_energies"):
                e = e + term.mc_energies(pos, box_t, atom_s,
                                         self._ensemble_r)
        return e

    # -- state manipulation ---------------------------------------------------
    def setPositions(self, positions) -> None:
        pos64 = np.asarray(positions, np.float64)
        if pos64.shape != (self._static.n_atoms, 3):
            raise ValueError(f"positions must have shape "
                             f"({self._static.n_atoms}, 3)")
        pos = torch.as_tensor(pos64, device=self._device).to(self._prec.real)
        pos = apply_vsites(self._spec, self._static, pos)
        pos_err = None
        if self._prec.real == torch.float32 and self._static.has_pairs:
            # start from the exact f64 rounding residual (vsite rows were
            # recomputed above, so their residual is meaningless)
            res = pos64 - pos.double().cpu().numpy()
            res[np.abs(res) > 1e-5] = 0.0
            pos_err = torch.as_tensor(res, dtype=torch.float32,
                                      device=self._device)
        self._state = self._state.replace(positions=pos, neighbors=None,
                                          pos_err=pos_err)
        self._forces_valid = False
        self._pe_valid = False
        self._ke_valid = False

    def getPositions(self):
        return self._state.positions.double().cpu().numpy()

    def setVelocities(self, velocities) -> None:
        vel = torch.as_tensor(np.asarray(velocities, np.float64),
                              device=self._device).to(self._prec.real)
        self._state = self._state.replace(velocities=vel)
        self._ke_valid = False

    def setVelocitiesToTemperature(self, temperature: float,
                                   seed: Optional[int] = None) -> None:
        """Maxwell-Boltzmann velocities from a torch.Generator seeded with
        `seed` (other numbers than the JAX package's jax.random)."""
        gen = torch.Generator(device="cpu")
        gen.manual_seed(0 if seed is None else int(seed))
        sigma = np.sqrt(BOLTZ * float(temperature)
                        * self._spec.inv_mass.double().cpu().numpy())
        v = torch.randn((self._static.n_atoms, 3), generator=gen,
                        dtype=torch.float64) * torch.as_tensor(sigma)[:, None]
        self._state = self._state.replace(
            velocities=v.to(device=self._device, dtype=self._prec.real))
        self._ke_valid = False

    def _periodic_cutoff(self) -> float:
        """Largest cutoff of a periodic cutoff NonbondedForce, or 0.0: the
        quantity that the rule cutoff <= min box width / 2 bounds."""
        cut = 0.0
        for f in self._system.getForces():
            if (type(f).__name__ == "NonbondedForce"
                    and f.usesPeriodicBoundaryConditions()
                    and f.getNonbondedMethod() != f.NoCutoff):
                cut = max(cut, f.getCutoffDistance())
        return cut

    def _validate_box_widths(self, box, origin: str) -> None:
        """Raise where the cutoff exceeds half the smallest box width
        (the diagonal of a reduced box: its perpendicular widths):
        minimum imaging would miss images."""
        cut = self._periodic_cutoff()
        if not cut:
            return
        w_min = float(np.min(np.diagonal(np.asarray(box, np.float64))))
        if cut > w_min / 2 + 1e-9:
            raise ValueError(
                f"{origin}: cutoff {cut} exceeds half the smallest "
                f"perpendicular box width {w_min} — minimum imaging "
                "would miss images (shrink the cutoff or enlarge the "
                "box)")

    def setPeriodicBoxVectors(self, a, b, c) -> None:
        """The box, reduced as OpenMM does.  An orthorhombic Context does
        not take a triclinic box (its terms minimum-image against the
        diagonal: the JAX package's app/context.py:357-372)."""
        box = boxutils.reduce_box([a, b, c])
        if boxutils.is_triclinic(box) and not self._triclinic:
            raise ValueError(
                "cannot switch an orthorhombic context to a triclinic "
                "box: the compiled strategy minimum-images against the "
                "diagonal — build the Context with the triclinic box "
                "instead")
        self._validate_box_widths(box, "setPeriodicBoxVectors")
        self._state = self._state.replace(
            box=torch.as_tensor(box, dtype=self._prec.real,
                                device=self._device), neighbors=None)
        self._forces_valid = False
        self._pe_valid = False

    def _all_constraints(self):
        """Every distance constraint as (idx (C, 2), dist (C,)): the SHAKE
        pairs, then the SETTLE triangles' three sides, in the JAX
        package's order (app/context.py:974-986 there)."""
        spec = self._spec
        t = spec.settle_idx
        idx = torch.cat([spec.shake_idx, t[:, (0, 1)], t[:, (0, 2)],
                         t[:, (1, 2)]], dim=0)
        d = spec.settle_dist
        dist = torch.cat([spec.shake_dist, d[:, 0], d[:, 0], d[:, 1]],
                         dim=0)
        return idx, dist

    def applyConstraints(self, tol: float) -> None:
        """Project the positions onto the constraints (Jacobi SHAKE from
        the current directions, constraints/shake.py), then place the
        virtual sites."""
        spec, static = self._spec, self._static
        if not (static.n_settle or static.n_shake):
            return
        idx, dist = self._all_constraints()
        pos = self._state.positions
        delta = shake.apply_position_constraints(
            pos, torch.zeros_like(pos), spec.inv_mass, idx, dist,
            float(tol), static.shake_max_iter)
        self._state = self._state.replace(
            positions=apply_vsites(spec, static, pos + delta))
        self._forces_valid = False
        self._pe_valid = False

    def applyVelocityConstraints(self, tol: float) -> None:
        """Remove the velocity components along the constraints: the
        rigid-triangle solve of constraints/settle.py (exact), then
        RATTLE on the other constraints to `tol`."""
        spec, static = self._spec, self._static
        v = self._state.velocities
        if static.n_settle:
            v = settle.apply_velocity_constraints(
                self._state.positions, v, spec.inv_mass, spec.settle_idx,
                spec.settle_dist)
        if static.n_shake:
            v = shake.apply_velocity_constraints(
                self._state.positions, v, spec.inv_mass, spec.shake_idx,
                spec.shake_dist, float(tol), static.shake_max_iter,
                pos_err=self._state.pos_err)
        self._state = self._state.replace(velocities=v)
        self._ke_valid = False

    # -- neighbour structure and forces ---------------------------------------
    def _ensure_neighbors(self) -> None:
        if self._cp_cfg is None or self._state.neighbors is not None:
            return
        for _ in range(8):
            nbl = self._nb.cellsort(self._state.positions,
                                    self._box_arg(self._state.box),
                                    self._dev_scale(self._state.rep_scale))
            if (nbl.excl_span_exceeded is not None
                    and bool(nbl.excl_span_exceeded)):
                # an excluded pair already spans >= 2 cells at setup: the
                # far-offset exclusion skip is unsound for this system
                self._nb_options["excl_skip"] = False
                self._build_potential()
                continue
            if bool(nbl.stencil_invalid):
                # a barostat shrink left the stencil short of the cutoff:
                # plan the cell grid (and the cell-aligned PME grid) again
                # at the current box
                self._replan_at_box()
                continue
            if not bool(nbl.overflow):
                break
            self._grow_pair_capacity()
        else:
            raise RuntimeError("cell capacity still overflowing after "
                               "growth")
        self._state = self._state.replace(neighbors=nbl)

    def _replan_at_box(self) -> None:
        """Make the current box the system's default and recompile: a new
        cell grid, stencil and PME grid (the kernels' device tables and
        B2's plan follow the new config).

        With per-replica scales the state's box is the template box,
        which a replan at it would plan the same grid for (the JAX
        Context does so, ROADMAP.md C17): the template box becomes the
        smallest replica's, box * min(s), and every scale is divided by
        min(s), so each replica keeps its box and the grid's window
        covers r_list in all of them.  Where that box is too small for a
        regular grid, this raises."""
        st = self._state
        box = st.box.double().cpu().numpy()
        if st.rep_scale is not None:
            s = st.rep_scale.double()
            s_min = float(torch.min(s))
            box = box * s_min
            st = st.replace(rep_scale=s / s_min,
                            box=torch.as_tensor(box, dtype=st.box.dtype,
                                                device=st.box.device))
        old = self._system.getDefaultPeriodicBoxVectors()
        self._system.setDefaultPeriodicBoxVectors(
            tuple(box[0]), tuple(box[1]), tuple(box[2]))
        try:
            self._build_potential()
        except ValueError as err:
            if st.rep_scale is None:
                raise
            self._system.setDefaultPeriodicBoxVectors(*old)
            self._build_potential()
            raise RuntimeError(
                "flat-ensemble NPT: a replica shrank past the cell "
                "stencil's slack and the grid cannot be planned again at "
                f"its box {np.diagonal(box).tolist()} nm ({err}); a "
                "replica box this small needs the dense strategy") from err
        self._state = st.replace(neighbors=None)

    def _grow_pair_capacity(self, positions=None) -> None:
        """Grow the cell capacity from the occupancy measured at
        `positions` (the state's by default) and recompile (capacity + 8
        at least, so a retry always progresses).  A flattened ensemble
        bins in the replicas' frame: an extended cell is a (replica,
        cell of its grid)."""
        if self._nb.strategy == "cell":
            # the neighbour-list strategy: larger cell and list
            # capacities, no recompile
            self._nb.grow()
            self._state = self._state.replace(neighbors=None)
            return
        cfg = self._cp_cfg
        if positions is None:
            positions = self._state.positions
        frac = boxutils.frac_coords(
            cellpair.stored(positions, self._state.rep_scale).cpu(),
            self._box_arg(self._state.box.double().cpu())).numpy()
        grid = np.asarray(cfg.phys_grid)
        frac = frac - np.floor(frac)
        cell = np.minimum((frac * grid).astype(np.int64), grid - 1)
        flat = (cell[:, 0] * grid[1] + cell[:, 1]) * grid[2] + cell[:, 2]
        if cfg.n_replicas > 1:
            rep = np.arange(len(flat)) // (len(flat) // cfg.n_replicas)
            flat = rep * int(np.prod(grid)) + flat
        occ_max = int(np.bincount(flat, minlength=cfg.n_cells).max())
        new_cap = max(-(-int(occ_max * 1.1 + 2) // 8) * 8, cfg.capacity + 8)
        self._nb_options["capacity"] = min(new_cap, self._static.n_atoms)
        self._build_potential()

    def _neighbor_fn(self, positions, box, rep_scale=None):
        return self._nb.cellsort(positions, self._box_arg(box),
                                 self._dev_scale(rep_scale))

    def _ensure_forces(self) -> None:
        if not self._forces_valid:
            self._ensure_neighbors()
            st = self._state
            f = self._forces_only(st.positions, st.box, st.neighbors,
                                  st.pos_err, st.rep_scale)
            self._state = st.replace(forces=f)
            self._forces_valid = True

    def _ensure_pe(self) -> None:
        if self._pe_valid:
            return
        self._ensure_neighbors()
        st = self._state
        pe = self._potential(st.positions, st.box, st.neighbors, st.pos_err,
                             st.rep_scale)
        self._state = st.replace(potential_energy=pe.to(self._prec.accum))
        self._pe_valid = True

    # -- stepping -------------------------------------------------------------
    def step(self, steps: int) -> None:
        """Advance `steps` steps.  Dense strategy: one fused multi-step.
        Cell-pair strategy: [rebuild -> rebuild_interval fused steps]
        blocks; the overflow and stencil latches are read once per 8
        blocks.  A chunk that overflowed is rerun from its saved start
        (the barostat's generator too) with a larger capacity; after a
        chunk whose rebuilds found the stencil short of cutoff + skin,
        the grid is planned again before the next.  The 8 x 16 steps of a
        chunk hold a few volume moves of ~1e-3 of a cell width each, so
        the stencil ends such a chunk short of cutoff + skin by a small
        fraction of the 0.1 nm skin."""
        self._ensure_forces()
        steps = int(steps)
        spec = self._spec
        if self._cp_cfg is None:
            self._state = self._stepper.multi_step(spec, self._state, steps)
            if self._static.baro_freq:
                # no stencil latch here: hold the box to the
                # minimum-image rule after the volume moves
                self._validate_box_widths(self._state.box.double().cpu(),
                                          "barostat volume move")
        else:
            interval = self._rebuild_interval
            chunk = 8 * interval
            remaining = steps
            while remaining > 0:
                k_chunk = min(chunk, remaining)
                self._ensure_neighbors()
                saved = self._state
                gen0 = saved.baro_gen.get_state()
                for _ in range(8):
                    st = saved
                    r = k_chunk
                    while r > 0:
                        k = min(interval, r)
                        st = tgnh.rebuild_neighbors(st, self._neighbor_fn,
                                                    self._cp_cfg.skin)
                        st = self._stepper.multi_step(spec, st, k)
                        r -= k
                    overflow, short = torch.stack(
                        [st.neighbors.overflow,
                         st.neighbors.stencil_invalid]).tolist()
                    if overflow:
                        saved.baro_gen.set_state(gen0)
                        self._state = saved
                        self._grow_pair_capacity()
                        self._state = self._state.replace(neighbors=None)
                        self._ensure_neighbors()
                        saved = self._state
                        continue
                    self._state = st
                    break
                else:
                    raise RuntimeError("cell capacity still overflowing "
                                       "after growth")
                remaining -= k_chunk
                if short:
                    self._check_rebuild_drift()
                    self._check_excl_span()
                    self._replan_at_box()
                    # the state's forces are those of its positions
                    self._forces_valid = True
            self._check_rebuild_drift()
            self._check_excl_span()
        self._ke_valid = True
        self._pe_valid = False
        self._check_hardwall_runaway()

    def _check_rebuild_drift(self) -> None:
        nbl = self._state.neighbors
        if nbl is None or self._drift_warned:
            return
        if bool(nbl.drift_exceeded):
            self._drift_warned = True
            warnings.warn(
                "an atom moved further than the neighbor skin between "
                "rebuilds — pair interactions may have been missed; "
                "reduce the step size or the rebuild interval",
                RuntimeWarning, stacklevel=3)

    def _check_excl_span(self) -> None:
        nbl = self._state.neighbors
        span = nbl.excl_span_exceeded if nbl is not None else None
        if span is not None and bool(span):
            raise RuntimeError(
                "an excluded pair stretched across >= 2 cells mid-run while "
                "the sweep skipped the exclusion test at far stencil "
                "offsets — recent forces double-counted it (pass "
                "nb_options={'excl_skip': False} if the geometry is "
                "intentional)")

    def _check_hardwall_runaway(self) -> None:
        hw = self._state.hardwall_runaway
        if hw is None or not bool(hw):
            return
        if self._hardwall_strict:
            self.clearHardwallRunaway()
            raise RuntimeError(
                "Drude particle moved too far beyond hard wall constraint "
                "(displacement exceeded 2x maxDrudeDistance); the system "
                "has likely become unstable — reduce the step size or "
                "check initial positions")
        if not self._hardwall_warned:
            self._hardwall_warned = True
            warnings.warn(
                "a Drude particle transiently moved >2x past the hard wall "
                "(bounced back; set hardwall_strict=True to raise instead)",
                RuntimeWarning, stacklevel=3)

    @property
    def hardwallRunaway(self) -> bool:
        hw = self._state.hardwall_runaway
        return bool(hw) if hw is not None else False

    def clearHardwallRunaway(self) -> None:
        self._state = self._state.replace(hardwall_runaway=torch.zeros(
            (), dtype=torch.bool, device=self._device))
        self._hardwall_warned = False

    def minimizeEnergy(self, tolerance: float = 10.0,
                       maxIterations: int = 500) -> None:
        """FIRE minimization (the JAX package's, app/context.py:740-826):
        the same dt/alpha schedule, the 0.01 nm cap on each iteration's
        largest displacement, the stop at force RMS <= tolerance
        (kJ/mol/nm) or maxIterations; kept only where the energy fell;
        then the constraints are projected, Drudes clamped to 0.99 of the
        hard wall and the virtual sites placed.

        The loop reads forces only (one force pass and one host read an
        iteration); the energy is read before and after.  On the
        cell-pair strategy the cells are sorted again whenever an atom
        has moved more than half the skin since the last sort (the JAX
        loop keeps its first sort throughout, ROADMAP.md Queue C)."""
        spec, static = self._spec, self._static
        self._ensure_neighbors()
        st = self._state
        box = st.box
        rs = st.rep_scale
        movable = (spec.inv_mass > 0)[:, None]
        pos = st.positions
        neighbors = st.neighbors
        sort_ref = pos
        half_skin = (0.5 * self._cp_cfg.skin if self._cp_cfg is not None
                     else None)
        pe_before = float(self._potential(pos, box, neighbors, None, rs))
        vel = torch.zeros_like(pos)
        dt = torch.tensor(1e-4, dtype=pos.dtype, device=pos.device)
        alpha = torch.tensor(0.1, dtype=pos.dtype, device=pos.device)
        n_pos = 0
        self._minimize_sorts = 1
        for _ in range(int(maxIterations)):
            f = self._forces_only(pos, box, neighbors, None, rs)
            f = torch.where(movable, f, torch.zeros_like(f))
            p = torch.sum(f * vel)
            f_norm = torch.sqrt(torch.sum(f * f))
            v_norm = torch.sqrt(torch.sum(vel * vel))
            up = p > 0
            vel = torch.where(
                up, (1 - alpha) * vel + alpha * f
                * (v_norm / torch.clamp(f_norm, min=1e-12)),
                torch.zeros_like(vel))
            # the JAX loop's counter of uphill-free iterations passes 5
            fast = up & (n_pos >= 5)
            dt = torch.where(fast, torch.clamp(dt * 1.1, max=1e-2),
                             torch.where(up, dt, dt * 0.5))
            alpha = torch.where(fast, alpha * 0.99,
                                torch.where(up, alpha, torch.full_like(
                                    alpha, 0.1)))
            vel = vel + dt * f
            move = dt * vel
            max_move = torch.max(torch.abs(move))
            pos = pos + move * torch.clamp(
                0.01 / torch.clamp(max_move, min=1e-12), max=1.0)
            rms = f_norm / float(np.sqrt(pos.numel()))
            if half_skin is not None:
                d = pos - sort_ref
                disp2 = torch.max(torch.sum(d * d, dim=1))
                host = torch.stack([rms.double(), up.double(),
                                    disp2.double()]).tolist()
            else:
                host = torch.stack([rms.double(), up.double()]).tolist()
            n_pos = n_pos + 1 if host[1] else 0
            if host[0] <= tolerance:
                break
            if half_skin is not None and host[2] > half_skin * half_skin:
                neighbors = self._sort_for_minimize(pos, box, rs)
                sort_ref = pos
                self._minimize_sorts += 1
        pe_after = float(self._potential(pos, box, neighbors, None, rs))
        if not pe_after < pe_before:
            return  # never make things worse (already near a minimum)
        self._state = self._state.replace(
            positions=pos,
            pos_err=(None if st.pos_err is None
                     else torch.zeros_like(st.pos_err)))
        self.applyConstraints(self._integrator.getConstraintTolerance())
        if static.has_hardwall and static.has_pairs:
            # the minimizer knows nothing of the integrator's hard wall:
            # clamp Drude offsets back inside it, so that the first step
            # does not (rightly) latch a runaway
            p_ = self._state.positions
            is_drude = (spec.is_pair & ~spec.is_parent)[:, None]
            parent = p_[spec.partner]
            delta = p_ - parent
            dist = torch.sqrt(torch.clamp(torch.sum(delta * delta, dim=-1),
                                          min=1e-24))
            scale = torch.clamp(0.99 * spec.max_drude_distance / dist,
                                max=1.0)
            p_ = torch.where(is_drude, parent + delta * scale[:, None], p_)
            self._state = self._state.replace(positions=p_)
        self._state = self._state.replace(
            positions=apply_vsites(spec, static, self._state.positions),
            neighbors=None)
        self._forces_valid = False
        self._pe_valid = False
        self._ke_valid = False

    def _sort_for_minimize(self, positions, box, rep_scale=None):
        """A fresh cell sort at `positions`, the capacity grown until no
        cell overflows."""
        for _ in range(8):
            nbl = self._nb.cellsort(positions, self._box_arg(box),
                                    self._dev_scale(rep_scale))
            if not bool(nbl.overflow):
                return nbl
            self._grow_pair_capacity(positions)
        raise RuntimeError("cell capacity still overflowing after growth")

    @property
    def neighborListOverflowed(self) -> bool:
        nbl = self._state.neighbors
        return bool(nbl.overflow) if nbl is not None else False

    def _on_step_size_changed(self) -> None:
        self._spec.dt = float(self._integrator.getStepSize())

    # -- queries --------------------------------------------------------------
    def getConservedEnergy(self) -> float:
        """KE + PE + the chain terms sum_g [1/2 Q_g0 etaDot_g0^2 +
        N_g kbT_g eta_g0 + sum_{i>=1} (1/2 Q_gi etaDot_gi^2 +
        kbT_chain eta_gi)] — its drift measures integrator fidelity."""
        self._ensure_forces()
        self._ensure_pe()
        st = self._state
        spec = self._spec
        m = spec.mass.double().cpu().numpy()
        v = st.velocities.double().cpu().numpy()
        ke = 0.5 * float(np.sum(m * np.sum(v * v, axis=-1)))
        pe = float(st.potential_energy)
        # the chain arrays of a flattened ensemble carry a leading (R,)
        eta = st.eta.double().numpy()
        eta_dot = st.eta_dot.double().numpy()[..., :-1]
        q = spec.nh_eta_mass.double().numpy()
        nkbt = spec.nh_nkbt.double().numpy()
        kbt_chain = spec.nh_kbt_chain.double().numpy()
        chain = 0.5 * np.sum(q * eta_dot ** 2)
        chain += float(np.sum(nkbt * eta[..., 0]))
        if eta.shape[-1] > 1:
            chain += float(np.sum(kbt_chain[:, None] * eta[..., 1:]))
        return ke + pe + float(chain)

    def getState(self, positions: bool = False, velocities: bool = False,
                 forces: bool = False, energy: bool = False,
                 groups: bool = False, enforcePeriodicBox: bool = False,
                 **kwargs) -> State:
        """OpenMM's keyword spellings (getPositions=True, ...) are taken
        too.  enforcePeriodicBox wraps whole molecules: each residue moves
        by the box image of its geometric centre (the image of its
        fractional coordinates in a triclinic box)."""
        positions = positions or kwargs.get("getPositions", False)
        velocities = velocities or kwargs.get("getVelocities", False)
        forces = forces or kwargs.get("getForces", False)
        energy = energy or kwargs.get("getEnergy", False)
        st = self._state
        kw = {"time": float(st.time), "step": int(st.step),
              "box": st.box.double().cpu().numpy()}
        if positions:
            pos = st.positions.double().cpu().numpy()
            if enforcePeriodicBox:
                box_d = np.diagonal(kw["box"])
                resid = self._spec.resid.cpu().numpy()
                n_res = self._static.n_residues
                counts = np.bincount(resid, minlength=n_res).astype(
                    np.float64)
                centers = np.stack([
                    np.bincount(resid, weights=pos[:, c], minlength=n_res)
                    for c in range(3)], axis=1) / counts[:, None]
                if self._triclinic:
                    box_t = torch.as_tensor(kw["box"])
                    shift = torch.floor(boxutils.frac_coords(
                        torch.as_tensor(centers), box_t))
                    pos = pos - boxutils.rows_combo(shift, box_t).numpy()[
                        resid]
                else:
                    if st.rep_scale is not None:
                        # each residue in its replica's box
                        box_d = box_d[None, :] * np.repeat(
                            st.rep_scale.double().numpy(),
                            n_res // self._ensemble_r)[:, None]
                    pos = pos - (np.floor(centers / box_d) * box_d)[resid]
            kw["positions"] = pos
        if velocities:
            kw["velocities"] = st.velocities.double().cpu().numpy()
        if forces:
            self._ensure_forces()
            kw["forces"] = self._state.forces.double().cpu().numpy()
        if energy or groups:
            self._ensure_forces()
            self._ensure_pe()
            kw["potential_energy"] = float(self._state.potential_energy)
            if self._ke_valid:
                # a flattened ensemble caches per-replica sums (R,)
                ke = float(np.sum(self._state.ke_sum.double().numpy()))
            else:
                m = self._spec.mass.double().cpu().numpy()
                v = self._state.velocities.double().cpu().numpy()
                ke = 0.5 * float(np.sum(m * np.sum(v * v, axis=-1)))
            kw["kinetic_energy"] = ke
        if groups:
            # group_ke holds 2*KE per bath: T_g = T_target * 2KE_g / NkbT_g
            # ((R, G+2) per replica in a flattened ensemble)
            two_ke = self._state.group_ke.double().numpy()
            nkbt = self._spec.nh_nkbt.double().numpy()
            temps = np.where(nkbt > 0, two_ke / np.where(nkbt > 0, nkbt,
                                                         1.0), 0.0)
            targets = np.full_like(temps, self._integrator.getTemperature())
            targets[..., -1] = self._integrator.getDrudeTemperature()
            kw["group_temperatures"] = temps * targets
        return State(**kw)

    def getSystem(self):
        return self._system

    def reinitialize(self, preserveState: bool = True) -> None:
        """Recompile after System or Integrator edits (OpenMM's
        Context::reinitialize).  With preserveState the positions,
        velocities, box, time, step, barostat and compensation carry
        over, and the thermostat chain where its shape is unchanged."""
        old = self._state
        kept = self._parameters
        self._parameters = self._default_parameters()
        if preserveState:
            self._parameters.update({k: v for k, v in kept.items()
                                     if k in self._parameters})
        self._init_spec_and_state()
        st = self._state
        if preserveState and old.positions.shape == st.positions.shape:
            st = st.replace(
                positions=old.positions, velocities=old.velocities,
                box=old.box, time=old.time, step=old.step,
                pos_err=old.pos_err, baro_scale=old.baro_scale,
                baro_naccept=old.baro_naccept,
                baro_nattempt=old.baro_nattempt, baro_gen=old.baro_gen,
                rep_scale=old.rep_scale)
            if old.eta.shape == st.eta.shape:
                st = st.replace(eta=old.eta, eta_dot=old.eta_dot,
                                eta_dot_dot=old.eta_dot_dot)
        self._state = st

    def getIntegrator(self):
        return self._integrator

    # -- global parameters of the custom forces ------------------------------
    def _default_parameters(self) -> dict:
        out: dict = {}
        for f in self._system.getForces():
            for name, v in (getattr(f, "_globals", None) or ()):
                out.setdefault(name, float(v))
        return out

    def _push_parameters(self) -> None:
        """The Context's parameter values into the compiled terms."""
        for term in self._terms:
            glb = getattr(term, "globals", None)
            if glb is not None:
                for name in glb:
                    glb[name] = self._parameters[name]

    def setParameter(self, name: str, value: float) -> None:
        """Set a global parameter of the custom forces in this Context
        (OpenMM's Context::setParameter).  The System's default stays as
        it is, so another Context of the same System starts from the
        default (the JAX package writes the value into the force's
        default, app/context.py:906-925 there: ROADMAP.md C19).  The
        compiled terms read the new value at their next evaluation."""
        if name not in self._parameters:
            raise ValueError(
                f"no force declares a global parameter {name!r}")
        self._parameters[name] = float(value)
        self._push_parameters()
        self._forces_valid = False
        self._pe_valid = False

    def getParameter(self, name: str) -> float:
        if name not in self._parameters:
            raise ValueError(
                f"no force declares a global parameter {name!r}")
        return self._parameters[name]

    def getParameters(self) -> dict:
        return dict(self._parameters)
