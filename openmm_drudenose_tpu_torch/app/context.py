"""Context: binds a System and a DrudeTGNHIntegrator into a simulation.

OpenMM-shaped semantics (setPositions, setVelocities,
setVelocitiesToTemperature, getState, step) as in the JAX package's
app/context.py.  The in-step force pass (`_forces_only`, the JAX
forces_only :248) adds the direct-space sweep forces (kernel B1 or B2
in float32), the analytic PME reciprocal forces, the exception/correction
terms and the Drude forces at the virtual-site-composed positions, then
moves site forces onto their parents.  `step` (:564 there) alternates a
cell-sort rebuild with a block of `rebuild_interval` fused steps and reads
the overflow latch once per 8 blocks; the drift, excl-span and hard-wall
latches are checked at the end of each call (:630-700 there).

Entry points run on CUDA unless the caller passes device="cpu"; a Context
without a device on a machine without CUDA raises.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from .. import precision as precision_mod
from ..constraints.vsites import (apply_vsites, apply_vsites_relative,
                                  spread_vsite_forces)
from ..core import spec as spec_mod
from ..core.state import zeros_state
from ..integrators import tgnh
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
                 nb_options: dict | None = None, device=None):
        """nb_options: {"capacity": C} pins the cell capacity (the bench
        pins the one its snapshot was measured with); {"use_pallas": 3}
        sends the float32 sweep to the chunked kernel B2 whatever the
        gates say (the JAX option of that name)."""
        # full-float32 products wherever a matmul could reach r^2 or
        # forces (TF32 keeps ~3 decimal digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._device = default_device(device)
        self._system = system
        self._integrator = integrator
        integrator._context = self
        self._hardwall_warned = False
        self._drift_warned = False
        self._prec = precision_mod.get_precision(precision)
        r, a = self._prec.real, self._prec.accum
        self._spec, self._static, init_edd = spec_mod.build_spec(
            system, integrator, r, a, self._device)
        self._nb_options = dict(nb_options or {})
        self._ke_valid = False
        self._state = None
        self._build_potential()
        box = np.array(system.getDefaultPeriodicBoxVectors(), np.float64)
        st = zeros_state(self._static.n_atoms, self._static.n_baths,
                         self._static.n_chains, box, r, a, self._device)
        self._state = st.replace(eta_dot_dot=torch.as_tensor(init_edd,
                                                             dtype=a))
        self._forces_valid = False
        self._pe_valid = False

    # -- compilation ----------------------------------------------------------
    def _build_potential(self) -> None:
        """(Re)compile the force terms; re-run when the cell capacity
        grows or the exclusion skip is turned off."""
        r = self._prec.real
        self._nb = None
        self._terms = []
        for f in self._system.getForces():
            if type(f).__name__ == "NonbondedForce":
                term = f.compile(self._system, r, self._device,
                                 nb_options=self._nb_options)
                if self._nb is not None:
                    raise NotImplementedError("one NonbondedForce only")
                self._nb = term
            elif hasattr(f, "compile"):
                term = f.compile(self._system, r, self._device)
                if term is not None:
                    self._terms.append(term)
        self._cp_cfg = self._nb.cfg if self._nb is not None else None
        self._rebuild_interval = (self._cp_cfg.rebuild_interval
                                  if self._cp_cfg is not None else None)
        self._stepper = tgnh.Stepper(self._static, self._forces_only)
        self._pe_valid = False
        if self._state is not None:
            self._state = self._state.replace(neighbors=None)
            self._forces_valid = False

    def _exact_positions(self, positions, pos_err):
        """Float64 positions with the virtual sites, at positions + pos_err:
        the positions the integrator carries, before rounding to float32
        (None without pos_err).  The nonbonded terms take their distances
        from them: an SWM4-NDP core and its Drude carry +-1.7 e about
        0.01 nm apart, and the independent float32 rounding of the two
        (~1e-6 nm at 16 nm from the origin) shows in the field of that
        dipole at ~1e-4 of max|F|."""
        if pos_err is None:
            return None
        return apply_vsites_relative(self._spec, self._static,
                                     positions.double() + pos_err.double())

    def _forces_only(self, positions, box, neighbors, pos_err):
        """Total force on the particles (no energy)."""
        spec, static = self._spec, self._static
        box_diag = torch.diagonal(box)
        pos = apply_vsites(spec, static, positions)
        f = torch.zeros_like(pos)
        nb = self._nb
        if nb is not None:
            exact = self._exact_positions(positions, pos_err)
            f = nb.sweep_forces(pos, box_diag, neighbors, exact)
            f = f + nb.recip(pos, box_diag, exact)[1]
            f = f + nb.extras(pos, box_diag, exact)[1]
        for term in self._terms:
            f = f + term.energy_forces(pos, box_diag, pos_err=pos_err)[1]
        return spread_vsite_forces(spec, static, f)

    def _potential(self, positions, box, neighbors, pos_err):
        """Total potential energy (the plain sweep for the direct space)."""
        box_diag = torch.diagonal(box)
        pos = apply_vsites(self._spec, self._static, positions)
        e = torch.zeros((), dtype=pos.dtype, device=pos.device)
        nb = self._nb
        if nb is not None:
            exact = self._exact_positions(positions, pos_err)
            e = e + nb.sweep_energy(pos, box_diag, neighbors, exact)
            e = e + nb.recip_energy(pos, box_diag, exact)
            e = e + nb.extras(pos, box_diag, exact)[0]
        for term in self._terms:
            e = e + term.energy_forces(pos, box_diag, pos_err=pos_err)[0]
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

    # -- neighbour structure and forces ---------------------------------------
    def _ensure_neighbors(self) -> None:
        if self._nb is None or self._state.neighbors is not None:
            return
        for _ in range(8):
            box_diag = torch.diagonal(self._state.box)
            nbl = self._nb.cellsort(self._state.positions, box_diag)
            if (nbl.excl_span_exceeded is not None
                    and bool(nbl.excl_span_exceeded)):
                # an excluded pair already spans >= 2 cells at setup: the
                # far-offset exclusion skip is unsound for this system
                self._nb_options["excl_skip"] = False
                self._build_potential()
                continue
            if bool(nbl.stencil_invalid):
                raise RuntimeError("the cell stencil no longer covers the "
                                   "cutoff at the current box")
            if not bool(nbl.overflow):
                break
            self._grow_pair_capacity()
        else:
            raise RuntimeError("cell capacity still overflowing after "
                               "growth")
        self._state = self._state.replace(neighbors=nbl)

    def _grow_pair_capacity(self) -> None:
        """Grow the cell capacity from the measured occupancy and
        recompile (capacity + 8 at least, so a retry always progresses)."""
        cfg = self._cp_cfg
        pos = self._state.positions.double().cpu().numpy()
        box = np.diagonal(self._state.box.double().cpu().numpy())
        grid = np.asarray(cfg.grid)
        frac = pos / box
        frac = frac - np.floor(frac)
        cell = np.minimum((frac * grid).astype(np.int64), grid - 1)
        flat = (cell[:, 0] * grid[1] + cell[:, 1]) * grid[2] + cell[:, 2]
        occ_max = int(np.bincount(flat, minlength=cfg.n_cells).max())
        new_cap = max(-(-int(occ_max * 1.1 + 2) // 8) * 8, cfg.capacity + 8)
        self._nb_options["capacity"] = min(new_cap, self._static.n_atoms)
        self._build_potential()

    def _neighbor_fn(self, positions, box):
        return self._nb.cellsort(positions, torch.diagonal(box))

    def _ensure_forces(self) -> None:
        if not self._forces_valid:
            self._ensure_neighbors()
            st = self._state
            f = self._forces_only(st.positions, st.box, st.neighbors,
                                  st.pos_err)
            self._state = st.replace(forces=f)
            self._forces_valid = True

    def _ensure_pe(self) -> None:
        if self._pe_valid:
            return
        self._ensure_neighbors()
        st = self._state
        pe = self._potential(st.positions, st.box, st.neighbors, st.pos_err)
        self._state = st.replace(potential_energy=pe.to(self._prec.accum))
        self._pe_valid = True

    # -- stepping -------------------------------------------------------------
    def step(self, steps: int) -> None:
        """Advance `steps` steps: [rebuild -> rebuild_interval fused steps]
        blocks; the overflow latch is read once per 8 blocks, and a chunk
        that overflowed is rerun from its saved start with a larger
        capacity."""
        self._ensure_forces()
        steps = int(steps)
        spec = self._spec
        if self._nb is None:
            self._state = self._stepper.multi_step(spec, self._state, steps)
        else:
            interval = self._rebuild_interval
            chunk = 8 * interval
            remaining = steps
            while remaining > 0:
                k_chunk = min(chunk, remaining)
                self._ensure_neighbors()
                saved = self._state
                for _ in range(8):
                    st = saved
                    r = k_chunk
                    while r > 0:
                        k = min(interval, r)
                        st = tgnh.rebuild_neighbors(st, self._neighbor_fn,
                                                    self._cp_cfg.skin)
                        st = self._stepper.multi_step(spec, st, k)
                        r -= k
                    if bool(st.neighbors.overflow):
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
        if not self._hardwall_warned:
            self._hardwall_warned = True
            warnings.warn(
                "a Drude particle transiently moved >2x past the hard wall "
                "(bounced back; the sticky hardwallRunaway flag is set)",
                RuntimeWarning, stacklevel=3)

    @property
    def hardwallRunaway(self) -> bool:
        hw = self._state.hardwall_runaway
        return bool(hw) if hw is not None else False

    def clearHardwallRunaway(self) -> None:
        self._state = self._state.replace(hardwall_runaway=torch.zeros(
            (), dtype=torch.bool, device=self._device))
        self._hardwall_warned = False

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
        eta = st.eta.double().numpy()
        eta_dot = st.eta_dot.double().numpy()[:, :-1]
        q = spec.nh_eta_mass.double().numpy()
        nkbt = spec.nh_nkbt.double().numpy()
        kbt_chain = spec.nh_kbt_chain.double().numpy()
        chain = 0.5 * np.sum(q * eta_dot ** 2)
        chain += float(np.sum(nkbt * eta[:, 0]))
        if eta.shape[1] > 1:
            chain += float(np.sum(kbt_chain[:, None] * eta[:, 1:]))
        return ke + pe + float(chain)

    def getState(self, positions: bool = False, velocities: bool = False,
                 forces: bool = False, energy: bool = False,
                 groups: bool = False) -> State:
        st = self._state
        kw = {"time": float(st.time), "step": int(st.step),
              "box": st.box.double().cpu().numpy()}
        if positions:
            kw["positions"] = st.positions.double().cpu().numpy()
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
                ke = float(self._state.ke_sum)
            else:
                m = self._spec.mass.double().cpu().numpy()
                v = self._state.velocities.double().cpu().numpy()
                ke = 0.5 * float(np.sum(m * np.sum(v * v, axis=-1)))
            kw["kinetic_energy"] = ke
        if groups:
            # group_ke holds 2*KE per bath: T_g = T_target * 2KE_g / NkbT_g
            two_ke = self._state.group_ke.double().numpy()
            nkbt = self._spec.nh_nkbt.double().numpy()
            temps = np.where(nkbt > 0, two_ke / np.where(nkbt > 0, nkbt,
                                                         1.0), 0.0)
            targets = np.full_like(temps, self._integrator.getTemperature())
            targets[-1] = self._integrator.getDrudeTemperature()
            kw["group_temperatures"] = temps * targets
        return State(**kw)

    def getSystem(self):
        return self._system

    def getIntegrator(self):
        return self._integrator
