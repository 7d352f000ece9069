"""Flattened replica ensembles: R identical replicas of one system run as
ONE extended system on one embedded cell grid (the JAX package's
parallel/flatrep.py).

A small box (4,000 atoms of water: a 5 x 5 x 5 cell grid) leaves most of
a card idle; R copies of it side by side in one extended grid, (rx px,
py, rz pz) cells, make one cell-pair system of R n0 atoms: one sweep
launch and one sort a rebuild for the whole ensemble.  The physics stays
per replica by construction:

  * the stencil wraps inside each replica's x and z bands
    (forces/cellpair.py::make_ensemble_config), so replicas never
    interact; kernels B1 and B2 take the banded grid (ops/);
  * the PME reciprocal sum runs per replica, R grids in one batched pass
    (forces/pme.py), since replicas overlap in physical coordinates;
  * the Nose-Hoover baths are (R, G+2) with one replica's constants
    (core/spec.py), and every KE and CM reduction is per replica
    (integrators/tgnh.py);
  * bonded terms, constraints and virtual sites are replicated index by
    index (replicate_system).

With a MonteCarloBarostat in the template the ensemble runs NPT, each
replica at its own box (the JAX package's flat NPT, :290-303 there):
replica r's box is the template box times s_r (SimState.rep_scale), the
cells are binned at p / s_r on the one template grid, kernels B1 and B2
read a per-replica shift table (their scaled instantiations), and each
replica moves its own volume against its own energy
(integrators/barostat.py::maybe_attempt_mc_move_ensemble).
"""

from __future__ import annotations

import numpy as np
import torch


def _shift_vsite(vs, o: int):
    from ..system import ThreeParticleAverageSite, TwoParticleAverageSite
    if isinstance(vs, TwoParticleAverageSite):
        return TwoParticleAverageSite(vs.particles[0] + o,
                                      vs.particles[1] + o, *vs.weights)
    if isinstance(vs, ThreeParticleAverageSite):
        return ThreeParticleAverageSite(
            *(p + o for p in vs.particles), *vs.weights)
    raise ValueError(f"unsupported virtual site {type(vs).__name__}")


def _replicate_force(f, R: int, n0: int):
    """R replica-major copies of force `f` of an n0-atom system, for the
    force types the port has; the others raise, as the JAX package
    raises on a CustomNonbondedForce."""
    from ..forces.bonded import (HarmonicAngleForce, HarmonicBondForce,
                                 HarmonicTorsionForce, PeriodicTorsionForce)
    from ..forces.cmmotion import CMMotionRemover, MonteCarloBarostat
    from ..forces.drude import DrudeForce
    from ..forces.nonbonded import NonbondedForce

    if isinstance(f, NonbondedForce):
        g = NonbondedForce()
        g.setNonbondedMethod(f.getNonbondedMethod())
        g.setCutoffDistance(f.getCutoffDistance())
        g.setReactionFieldDielectric(f.getReactionFieldDielectric())
        g.setUseSwitchingFunction(f.getUseSwitchingFunction())
        g.setSwitchingDistance(f.getSwitchingDistance())
        g.setEwaldErrorTolerance(f.getEwaldErrorTolerance())
        g.setUseDispersionCorrection(f.getUseDispersionCorrection())
        g._pme_params = tuple(f._pme_params)
        for _ in range(R):
            for i in range(f.getNumParticles()):
                g.addParticle(*f.getParticleParameters(i))
        for r in range(R):
            o = r * n0
            for e in range(f.getNumExceptions()):
                i, j, qq, sig, eps = f.getExceptionParameters(e)
                g.addException(i + o, j + o, qq, sig, eps)
            for set1, set2, sig, eps in f._lj_overrides:
                g.addLJPairOverride([p + o for p in set1],
                                    [p + o for p in set2], sig, eps)
        return g

    if isinstance(f, DrudeForce):
        g = DrudeForce()
        np0 = f.getNumParticles()
        for r in range(R):
            o = r * n0
            for i in range(np0):
                p = f.getParticleParameters(i)
                g.addParticle(*[x + o if x >= 0 else -1 for x in p[:5]],
                              *p[5:])
        for r in range(R):
            op = r * np0          # screened/NBTHOLE pairs index the pairs
            for i in range(f.getNumScreenedPairs()):
                a, b, thole = f.getScreenedPairParameters(i)
                g.addScreenedPair(a + op, b + op, thole)
            for a, b, thole in f._nbthole:
                g.addNBTholePair(a + op, b + op, thole)
        return g

    if isinstance(f, HarmonicBondForce):
        g = HarmonicBondForce()
        for r in range(R):
            o = r * n0
            for i in range(f.getNumBonds()):
                p1, p2, length, k = f.getBondParameters(i)
                g.addBond(p1 + o, p2 + o, length, k)
        return g

    if isinstance(f, HarmonicAngleForce):
        g = HarmonicAngleForce()
        for r in range(R):
            o = r * n0
            for i in range(f.getNumAngles()):
                p1, p2, p3, th, k = f.getAngleParameters(i)
                g.addAngle(p1 + o, p2 + o, p3 + o, th, k)
        return g

    if isinstance(f, (PeriodicTorsionForce, HarmonicTorsionForce)):
        g = type(f)()
        for r in range(R):
            o = r * n0
            for i in range(f.getNumTorsions()):
                t = f.getTorsionParameters(i)
                g.addTorsion(*(p + o for p in t[:4]), *t[4:])
        return g

    if isinstance(f, CMMotionRemover):
        return CMMotionRemover(f.getFrequency())

    if isinstance(f, MonteCarloBarostat):
        return MonteCarloBarostat(f.getDefaultPressure(),
                                  f.getDefaultTemperature(),
                                  f.getFrequency())

    raise ValueError(f"cannot replicate force {type(f).__name__}")


def replicate_system(system, n_replicas: int):
    """A new System with `n_replicas` replica-major copies of `system`
    (the same box; every index offset per replica)."""
    from ..system import System
    R = int(n_replicas)
    n0 = system.getNumParticles()
    ext = System()
    for _ in range(R):
        for i in range(n0):
            ext.addParticle(system.getParticleMass(i))
    for r in range(R):
        o = r * n0
        for ci in range(system.getNumConstraints()):
            p1, p2, d = system.getConstraintParameters(ci)
            ext.addConstraint(p1 + o, p2 + o, d)
        for i in range(n0):
            if system.isVirtualSite(i):
                ext.setVirtualSite(
                    i + o, _shift_vsite(system.getVirtualSite(i), o))
    ext.setDefaultPeriodicBoxVectors(*system.getDefaultPeriodicBoxVectors())
    for f in system.getForces():
        ext.addForce(_replicate_force(f, R, n0))
    return ext


def _clone_integrator(integ, R: int):
    """The template's integrator for R replicas: the same parameters,
    its particle groups repeated per replica."""
    from ..app.integrator import DrudeTGNHIntegrator
    g = DrudeTGNHIntegrator(
        integ.getTemperature(), integ.getCouplingTime(),
        integ.getDrudeTemperature(), integ.getDrudeCouplingTime(),
        integ.getStepSize(), integ.getDrudeStepsPerRealStep(),
        integ.getNumNHChains(), integ.getUseDrudeNHChains(),
        integ.getUseCOMTempGroup())
    g.setMaxDrudeDistance(integ.getMaxDrudeDistance())
    g.setConstraintTolerance(integ.getConstraintTolerance())
    g._temp_groups = list(integ._temp_groups)
    if integ._particle_temp_group:
        g._particle_temp_group = list(integ._particle_temp_group) * R
    return g


class FlatReplicaEnsemble:
    """R identical replicas of `context`'s system advanced as one
    flattened extended Context, on the card through the replica-band
    path of kernels B1 and B2.

        ens = FlatReplicaEnsemble(ctx, n_replicas=64)
        ens.setVelocitiesToTemperature(300.0)
        ens.step(1000)
        ke = ens.kinetic_energies()          # (64,)
        t = ens.group_temperatures()         # (64, G+2)

    rx / rz: the replica bands along the extended x and z cell axes.  The
    default layout (`_auto_layout`, the JAX package's) may pad the
    ensemble with extra replicas (rx * rz >= R); pad replicas are real,
    independent trajectories that no accessor reports.  Positions
    default to R copies of the template's current positions; pad
    replicas take copies of replica 0's positions and velocities."""

    def __init__(self, context, n_replicas: int, rx: int | None = None,
                 rz: int | None = None, seed: int = 0,
                 nb_options: dict | None = None, pad_replicas: bool = True):
        from ..app.context import Context
        R = int(n_replicas)
        if rx is None and rz is None:
            rx, rz = self._auto_layout(context, R, nb_options, pad_replicas)
        elif rz is None:
            if R % rx:
                raise ValueError("rx must divide n_replicas")
            rz = R // rx
        elif rx is None:
            if R % rz:
                raise ValueError("rz must divide n_replicas")
            rx = R // rz
        if rx * rz < R:
            raise ValueError("rx*rz must be >= n_replicas")
        R_int = rx * rz
        self._n_replicas = R
        self._r_int = R_int
        self._layout = (int(rx), int(rz))
        self._n0 = context._system.getNumParticles()
        self._template = context
        nb = dict(context._nb_options)
        nb.update(nb_options or {})
        nb["ensemble"] = [R_int, int(rx), int(rz)]
        self.context = Context(
            replicate_system(context._system, R_int),
            _clone_integrator(context._integrator, R_int),
            precision=context._prec, strategy="cellpair", seed=seed,
            hardwall_strict=context._hardwall_strict, nb_options=nb,
            device=context._device, ensemble_r=R_int)
        if any(type(f).__name__ == "MonteCarloBarostat"
               for f in context._system.getForces()):
            # per-replica NPT: unit scales, each replica's own move size
            # and counters (the JAX flatrep.py:290-303)
            self.context._state = self.context._state.replace(
                rep_scale=torch.ones(R_int, dtype=torch.float64),
                baro_scale=torch.zeros(R_int, dtype=torch.float64),
                baro_naccept=torch.zeros(R_int, dtype=torch.int64),
                baro_nattempt=torch.zeros(R_int, dtype=torch.int64))
        pos0 = context._state.positions.double().cpu().numpy()
        self.setPositions(np.broadcast_to(pos0, (R,) + pos0.shape))

    @staticmethod
    def _auto_layout(context, R: int, nb_options,
                     pad_replicas: bool = True) -> tuple:
        """(rx, rz) minimizing the JAX package's modelled step cost, kept
        as it is so that the same call builds the same ensemble.

        The model is the TPU sweep's (calibrated on a v5e): the sweep
        scales with the padded 128-lane slots rx * ceil(n_yz0 rz / 128) *
        128 and everything else with the internal replica count, half
        and half, with a 2.5x penalty where the TPU kernel's gate
        disengages; rx * rz may exceed R by up to 25% with
        pad_replicas."""
        nb = dict(context._nb_options)
        nb.update(nb_options or {})
        nbf = [f for f in context._system.getForces()
               if type(f).__name__ == "NonbondedForce"]
        if not nbf:
            return 1, R
        r_list = nbf[0].getCutoffDistance() + nb.get("skin", 0.1)
        target = r_list / nb.get("cells_per_cutoff", 2)
        box0 = np.diagonal(np.array(
            context._system.getDefaultPeriodicBoxVectors(), np.float64))
        pg = [max(int(np.floor(L / target)), 1) for L in box0]
        n_yz0 = pg[1] * pg[2]
        cell = box0 / np.array(pg)
        w = int(np.ceil(r_list / cell[0]))
        n_lay = 2 * w + 1
        cap = nb.get("capacity")
        if not cap:
            n0 = context._system.getNumParticles()
            density = n0 / float(np.prod(box0))
            cap = int(np.ceil(density * np.prod(cell) * 1.35)) + 2
            cap = max(int(np.ceil(cap / 8)) * 8, 8)
        best = None
        for rz in range(1, R + 1):
            rx = -(-R // rz)
            if not pad_replicas and R % rz:
                continue
            r_int = rx * rz
            if r_int > max(R + 1, int(R * 1.25)):
                continue
            n_yz = n_yz0 * rz
            lanes = -(-n_yz // 128) * 128
            lay_stride = -(-2 * n_yz // 128) * 128
            fr_stride = lanes
            vmem = 4 * cap * n_lay * (8 * lay_stride + 6 * fr_stride)
            pallas_ok = (n_yz >= 128 and vmem <= 12 * 1024 * 1024
                         and pg[0] >= n_lay)
            pallas_penalty = 1.0 if pallas_ok else 2.5
            cost = (0.5 * pallas_penalty * (rx * lanes) / (R * n_yz0)
                    + 0.5 * r_int / R)
            key = (cost, r_int, rz)
            if best is None or key < best[0]:
                best = (key, (rx, rz))
        return best[1]

    # -- state I/O ----------------------------------------------------------

    def _padded(self, x) -> np.ndarray:
        """(R, N0, 3) per-replica rows (or (N0, 3), broadcast), with the
        pad replicas' rows copied from replica 0's, as (R_int N0, 3)."""
        x = np.asarray(x, np.float64)
        if x.ndim == 2:
            x = np.broadcast_to(x, (self._n_replicas,) + x.shape)
        if x.shape[0] == self._n_replicas and self._r_int > self._n_replicas:
            pad = np.broadcast_to(
                x[0], (self._r_int - self._n_replicas,) + x.shape[1:])
            x = np.concatenate([x, pad], axis=0)
        return x.reshape(-1, 3)

    def setPositions(self, positions) -> None:
        """(R, N0, 3) per-replica positions (or (N0, 3), broadcast)."""
        self.context.setPositions(self._padded(positions))

    def setVelocities(self, velocities) -> None:
        """(R, N0, 3) per-replica velocities (or (N0, 3), broadcast)."""
        self.context.setVelocities(self._padded(velocities))

    def setVelocitiesToTemperature(self, temperature: float,
                                   seed: int = 0) -> None:
        self.context.setVelocitiesToTemperature(temperature, seed=seed)

    def _per_replica(self, t) -> np.ndarray:
        return t.double().cpu().numpy().reshape(
            self._r_int, self._n0, 3)[:self._n_replicas]

    def positions(self) -> np.ndarray:
        """(R, N0, 3)."""
        return self._per_replica(self.context._state.positions)

    def velocities(self) -> np.ndarray:
        """(R, N0, 3)."""
        return self._per_replica(self.context._state.velocities)

    def kinetic_energies(self) -> np.ndarray:
        """(R,) per-replica KE: the value cached at the last NH half step
        (the reference's KESum), or 1/2 m v^2 per replica before any
        step has run."""
        ctx = self.context
        if ctx._ke_valid:
            return ctx._state.ke_sum.double().numpy()[:self._n_replicas]
        m = ctx._spec.mass.double().cpu().numpy()
        v = ctx._state.velocities.double().cpu().numpy()
        ke = 0.5 * m * np.sum(v * v, axis=-1)
        return ke.reshape(self._r_int, self._n0).sum(
            axis=1)[:self._n_replicas]

    def group_temperatures(self) -> np.ndarray:
        """(R, G+2) per-replica per-bath temperatures (K)."""
        st = self.context.getState(energy=True, groups=True)
        return np.asarray(st.getGroupTemperatures(),
                          np.float64)[:self._n_replicas]

    def potential_energies(self) -> np.ndarray:
        """(R,) per-replica potential energies: the template Context's
        potential at each replica's positions and box (the flattened
        pass gives the ensemble's total only).  A loop over the replicas:
        a reporting path, not the hot one."""
        tpl = self._template
        st = self.context._state
        R, n0 = self._n_replicas, self._n0
        pos = st.positions.reshape(self._r_int, n0, 3)
        err = (None if st.pos_err is None
               else st.pos_err.reshape(self._r_int, n0, 3))
        boxes = torch.as_tensor(self.boxes(), dtype=st.box.dtype,
                                device=tpl._device)
        out = np.empty(R)
        for r in range(R):
            p = pos[r].to(tpl._device)
            e = None if err is None else err[r].to(tpl._device)
            nbl = (None if tpl._cp_cfg is None
                   else tpl._sort_for_minimize(p, boxes[r]))
            out[r] = float(tpl._potential(p, boxes[r], nbl, e))
        return out

    def total_potential_energy(self) -> float:
        """The R requested replicas' PEs summed (pad replicas left
        out)."""
        if self._r_int != self._n_replicas:
            return float(self.potential_energies().sum())
        return float(self.context.getState(energy=True)
                     .getPotentialEnergy())

    def boxes(self) -> np.ndarray:
        """(R, 3, 3) per-replica box vectors: the template box times each
        replica's scale in NPT, copies of the one box otherwise."""
        st = self.context._state
        box = st.box.double().cpu().numpy()
        if st.rep_scale is None:
            return np.broadcast_to(box, (self._n_replicas, 3, 3)).copy()
        s = st.rep_scale.double().numpy()[:self._n_replicas]
        return box[None, :, :] * s[:, None, None]

    def densities(self, total_mass_amu: float = None) -> np.ndarray:
        """(R,) per-replica mass densities in g/mL (the mass defaults to
        the template system's)."""
        if total_mass_amu is None:
            s = self._template._system
            total_mass_amu = sum(s.getParticleMass(i)
                                 for i in range(s.getNumParticles()))
        vols = np.linalg.det(self.boxes())  # nm^3
        return total_mass_amu * 1.66053906660 / (vols * 1e3)

    # -- dynamics -----------------------------------------------------------

    def step(self, n: int) -> None:
        self.context._integrator.step(n)

    @property
    def layout(self) -> tuple:
        """(rx, rz): the replica bands along x and z."""
        return self._layout

    @property
    def n_replicas(self) -> int:
        return self._n_replicas

    @property
    def n_replicas_padded(self) -> int:
        """The internal rx * rz replica count (n_replicas unless the auto
        layout padded the ensemble)."""
        return self._r_int
