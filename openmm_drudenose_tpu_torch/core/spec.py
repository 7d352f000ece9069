"""Compile a System and a DrudeTGNHIntegrator into tensors.

Once, on the host, as the JAX package's core/spec.py::build_spec (:195)
does and as the reference plugin's initialize() does
(CudaDrudeTGNHKernels.cpp:75-282):

  - find the single DrudeForce
  - residues (= molecules) and their masses
  - temperature baths: user groups 0..G-1, G = molecular COM, G+1 = Drude
  - DOF accounting with the COM reduced-mass correction
    (tempGroupRedMass, CudaDrudeTGNHKernels.cpp:130-132, 219-220) and the
    constraint and CMMotionRemover deductions
  - NH chain masses and initial accelerations
  - SETTLE triangles, the other constraints as SHAKE pairs (the JAX
    spec's shake_idx / shake_dist, core/spec.py:341-346 there), and the
    tables of the average, out-of-plane and local-coordinates sites
  - the MonteCarloBarostat's frequency, pressure and kT

Per-atom tables and the NH chain constants go to the simulation device,
where the chain is integrated (ops/nh_chain.py).

A flattened replica ensemble (ensemble_r = R > 1, parallel/flatrep.py:
R identical replicas, replica-major) keeps one replica's bath constants:
the extended system's DOF, reduced masses and Drude DOF divided by R,
with a CM removed per replica; its baths are (R, G+2).

The TPU layout tables of the JAX package (lane shifts, gather tables)
have no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..units import BAR_TO_KJ_PER_MOL_NM3, BOLTZ
from . import topology


class SpecError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class StaticSpec:
    n_atoms: int
    n_residues: int
    n_temp_groups: int          # G; baths = G + 2
    n_chains: int               # NH chain length M
    drude_steps: int            # NH multi-timestep substeps per half step
    use_drude_nh_chains: bool
    use_com_temp_group: bool
    has_pairs: bool
    has_hardwall: bool
    n_settle: int
    n_vsites_avg: int
    cm_freq: int                # 0 = no CMMotionRemover
    baro_freq: int = 0          # 0 = no MonteCarloBarostat
    ensemble_r: int = 1         # replicas of a flattened ensemble
    n_shake: int = 0            # constraints outside SETTLE triangles
    n_vsites_oop: int = 0       # out-of-plane sites
    n_vsites_lc: int = 0        # local-coordinates sites
    constraint_tol: float = 1e-5
    shake_max_iter: int = 150

    @property
    def n_baths(self) -> int:
        return self.n_temp_groups + 2


@dataclasses.dataclass
class SystemSpec:
    mass: torch.Tensor          # (N,)
    inv_mass: torch.Tensor      # (N,) 0 for massless
    tg: torch.Tensor            # (N,) temperature group
    resid: torch.Tensor         # (N,) residue id
    res_mass: torch.Tensor      # (R,)
    res_inv_mass: torch.Tensor  # (R,)
    is_pair: torch.Tensor       # (N,) bool, member of a Drude pair
    is_parent: torch.Tensor     # (N,) bool, core of a pair
    partner: torch.Tensor       # (N,) pair partner (self if unpaired)
    nh_nkbt: torch.Tensor       # (G+2,)
    nh_eta_mass: torch.Tensor   # (G+2, M)
    nh_kbt_chain: torch.Tensor  # (G+2,)
    nh_link_active: torch.Tensor  # (G+2, M) bool
    dt: float                   # step size, ps
    max_drude_distance: float
    hardwall_scale: float       # sqrt(kB T_drude)
    settle_idx: torch.Tensor    # (S, 3) [central, sat1, sat2]
    settle_dist: torch.Tensor   # (S, 2) [d_central_sat, d_sat_sat]
    vs_avg_idx: torch.Tensor    # (Va,)
    vs_avg_p: torch.Tensor      # (Va, 3)
    vs_avg_w: torch.Tensor      # (Va, 3)
    baro_pressure: float = 0.0  # kJ/mol/nm^3
    baro_kt: float = 0.0        # kB T of the barostat, kJ/mol
    shake_idx: torch.Tensor = None   # (C, 2)
    shake_dist: torch.Tensor = None  # (C,)
    vs_oop_idx: torch.Tensor = None  # (Vo,)
    vs_oop_p: torch.Tensor = None    # (Vo, 3)
    vs_oop_w: torch.Tensor = None    # (Vo, 3) [w12, w13, wcross]
    vs_lc_idx: torch.Tensor = None   # (Vl,)
    vs_lc_p: torch.Tensor = None     # (Vl, K) parents, padded with 0
    vs_lc_ow: torch.Tensor = None    # (Vl, K) origin weights, pad 0
    vs_lc_xw: torch.Tensor = None    # (Vl, K) x-direction weights
    vs_lc_yw: torch.Tensor = None    # (Vl, K) y-direction weights
    vs_lc_local: torch.Tensor = None  # (Vl, 3) local position


def _find_drude_force(system):
    from ..forces.drude import DrudeForce
    found = [f for f in system.getForces() if isinstance(f, DrudeForce)]
    if len(found) > 1:
        raise SpecError("The System contains multiple DrudeForces")
    if not found:
        raise SpecError("The System does not contain a DrudeForce")
    return found[0]


def partition_constraints(system, masses):
    """Split constraints into SETTLE triangles and the rest (clusters in
    order of their first constraint, as the JAX package orders them)."""
    cons = [system.getConstraintParameters(i)
            for i in range(system.getNumConstraints())]
    edges = np.array([(c[0], c[1]) for c in cons], np.int64).reshape(-1, 2)
    label = topology.component_labels(system.getNumParticles(), edges)
    clusters: dict[int, list] = {}
    for c in cons:
        clusters.setdefault(int(label[c[0]]), []).append(c)
    settle, other = [], []
    for cl in clusters.values():
        atoms = sorted({a for c in cl for a in (c[0], c[1])})
        ok = False
        if len(cl) == 3 and len(atoms) == 3:
            for center in atoms:
                others = [a for a in atoms if a != center]
                d_cs = [c[2] for c in cl if center in (c[0], c[1])]
                d_ss = [c[2] for c in cl if center not in (c[0], c[1])]
                if (len(d_cs) == 2 and len(d_ss) == 1
                        and abs(d_cs[0] - d_cs[1]) < 1e-10
                        and abs(masses[others[0]] - masses[others[1]]) < 1e-10
                        and masses[others[0]] > 0 and masses[center] > 0):
                    settle.append((center, others[0], others[1], d_cs[0],
                                   d_ss[0]))
                    ok = True
                    break
        if not ok:
            other.extend(cl)
    return settle, other


def build_spec(system, integrator, real_dtype, accum_dtype, device,
               ensemble_r: int = 1):
    """Returns (SystemSpec, StaticSpec, initial eta_dot_dot (numpy));
    with ensemble_r = R > 1 (the JAX package's build_spec :196-305, :541)
    the bath constants are one replica's and the initial eta_dot_dot is
    (R, G+2, M)."""
    from ..forces.cmmotion import CMMotionRemover, MonteCarloBarostat
    from ..system import (LocalCoordinatesSite, OutOfPlaneSite,
                          ThreeParticleAverageSite, TwoParticleAverageSite)

    n = system.getNumParticles()
    drude_force = _find_drude_force(system)
    masses = np.array([system.getParticleMass(i) for i in range(n)],
                      np.float64)
    inv_mass = np.where(masses > 0,
                        1.0 / np.where(masses > 0, masses, 1.0), 0.0)
    resid = topology.molecule_ids(system)
    res_mass = topology.residue_masses(system, resid)
    n_res = len(res_mass)
    res_inv_mass = np.where(res_mass > 0,
                            1.0 / np.where(res_mass > 0, res_mass, 1.0), 0.0)

    G = max(integrator.getNumTempGroups(), 1)
    tg = (np.array(integrator._particle_temp_group, np.int64)
          if integrator._particle_temp_group else np.zeros(n, np.int64))
    if len(tg) != n:
        raise SpecError("Number of particle temperature groups must match "
                        "the number of particles in the System")
    if tg.min() < 0 or tg.max() >= G:
        raise SpecError("Particle temperature group out of range")

    n_pairs = drude_force.getNumParticles()
    pp = np.array([drude_force.getParticleParameters(i)[:2]
                   for i in range(n_pairs)], np.int64).reshape(-1, 2)
    d_idx, c_idx = pp[:, 0], pp[:, 1]
    if np.any(tg[d_idx] != tg[c_idx]):
        raise SpecError("Temperature group for drude particle must be the "
                        "same as the parent particle")
    is_pair = np.zeros(n, bool)
    is_parent = np.zeros(n, bool)
    partner = np.arange(n, dtype=np.int64)
    is_pair[d_idx] = is_pair[c_idx] = True
    is_parent[c_idx] = True
    partner[d_idx] = c_idx
    partner[c_idx] = d_idx

    # ---- DOF accounting (CudaDrudeTGNHKernels.cpp:109-235) ------------
    use_com = bool(integrator.getUseCOMTempGroup())
    dof = np.zeros(G + 2)
    red_mass = np.zeros(G + 2)
    massive = masses != 0.0
    np.add.at(dof, tg[massive], 3)
    if use_com:
        np.add.at(red_mass, tg[massive],
                  3 * masses[massive] * res_inv_mass[resid[massive]])
    drude_dof = 3 * n_pairs
    np.add.at(dof, tg[d_idx], -3)
    cons = np.array([system.getConstraintParameters(i)[:2]
                     for i in range(system.getNumConstraints())],
                    np.int64).reshape(-1, 2)
    if np.any(tg[cons[:, 0]] != tg[cons[:, 1]]):
        raise SpecError("Temperature group of constrained particles must "
                        "be the same")
    np.add.at(dof, tg[cons[:, 0]], -1)
    if use_com:
        dof[G] = 3 * n_res
    dof[G + 1] = drude_dof

    cm_freq = 0
    baro_freq, baro_pressure, baro_kt = 0, 0.0, 0.0
    for f in system.getForces():
        if isinstance(f, CMMotionRemover):
            cm_freq = f.getFrequency()
            if use_com:
                # a flattened ensemble removes each replica's own CM
                dof[G] -= 3 * ensemble_r
        elif isinstance(f, MonteCarloBarostat):
            baro_freq = f.getFrequency()
            baro_pressure = f.getDefaultPressure() * BAR_TO_KJ_PER_MOL_NM3
            baro_kt = BOLTZ * f.getDefaultTemperature()

    if ensemble_r > 1:
        if n % ensemble_r or n_res % ensemble_r or n_pairs % ensemble_r:
            raise SpecError("flattened ensemble: atom/residue/pair counts "
                            "must be divisible by the replica count")
        # identical replicas: the extended accounting is R x one
        # replica's (the CM's -3 applied per replica above)
        dof = dof / ensemble_r
        red_mass = red_mass / ensemble_r
        drude_dof = drude_dof // ensemble_r

    # ---- NH chain constants (CudaDrudeTGNHKernels.cpp:214-235) --------
    M = integrator.getNumNHChains()
    real_kbt = BOLTZ * integrator.getTemperature()
    drude_kbt = BOLTZ * integrator.getDrudeTemperature()
    real_unit = real_kbt * integrator.getCouplingTime() ** 2
    drude_unit = drude_kbt * integrator.getDrudeCouplingTime() ** 2
    nkbt = np.zeros(G + 2)
    eta_mass = np.zeros((G + 2, M))
    kbt_chain = np.zeros(G + 2)
    init_edd = np.zeros((G + 2, M))
    for i in range(G + 1):
        nkbt[i] = (dof[i] - red_mass[i]) * real_kbt
        eta_mass[i, 0] = (dof[i] - red_mass[i]) * real_unit
        kbt_chain[i] = real_kbt
        for ich in range(1, M):
            eta_mass[i, ich] = real_unit
            init_edd[i, ich] = -real_kbt / eta_mass[i, ich]
    nkbt[G + 1] = drude_dof * drude_kbt
    eta_mass[G + 1, 0] = drude_dof * drude_unit
    kbt_chain[G + 1] = drude_kbt
    use_drude_chains = bool(integrator.getUseDrudeNHChains())
    for ich in range(1, M):
        eta_mass[G + 1, ich] = drude_unit
        if use_drude_chains:
            init_edd[G + 1, ich] = -drude_kbt / eta_mass[G + 1, ich]
    link_active = np.ones((G + 2, M), bool)
    if not use_drude_chains:
        link_active[G + 1, 1:] = False

    # ---- constraints ---------------------------------------------------
    settle, shake = partition_constraints(system, masses)
    shake_idx = np.array([c[:2] for c in shake], np.int64).reshape(-1, 2)
    shake_dist = np.array([c[2] for c in shake], np.float64)
    settle_idx = np.array([s[:3] for s in settle], np.int64).reshape(-1, 3)
    settle_dist = np.array([s[3:] for s in settle],
                           np.float64).reshape(-1, 2)

    # ---- virtual sites ---------------------------------------------------
    avg_idx, avg_p, avg_w = [], [], []
    oop_idx, oop_p, oop_w = [], [], []
    lc = []
    for i in range(n):
        if not system.isVirtualSite(i):
            continue
        vs = system.getVirtualSite(i)
        if isinstance(vs, TwoParticleAverageSite):
            avg_idx.append(i)
            avg_p.append((vs.particles[0], vs.particles[1], vs.particles[0]))
            avg_w.append((vs.weights[0], vs.weights[1], 0.0))
        elif isinstance(vs, ThreeParticleAverageSite):
            avg_idx.append(i)
            avg_p.append(vs.particles)
            avg_w.append(vs.weights)
        elif isinstance(vs, OutOfPlaneSite):
            oop_idx.append(i)
            oop_p.append(vs.particles)
            oop_w.append(vs.weights)
        elif isinstance(vs, LocalCoordinatesSite):
            lc.append((i, vs))
        else:
            raise SpecError(
                f"Unsupported virtual site type {type(vs).__name__}")
    lc_k = max((len(v.particles) for _, v in lc), default=1)
    lc_p = np.zeros((len(lc), lc_k), np.int64)
    lc_w = np.zeros((3, len(lc), lc_k), np.float64)
    lc_local = np.zeros((len(lc), 3), np.float64)
    for row, (i, vs) in enumerate(lc):
        k = len(vs.particles)
        lc_p[row, :k] = vs.particles
        lc_w[0, row, :k] = vs.origin_weights
        lc_w[1, row, :k] = vs.x_weights
        lc_w[2, row, :k] = vs.y_weights
        lc_local[row] = vs.local_position
    is_site = np.zeros(n, bool)
    is_site[avg_idx + oop_idx + [i for i, _ in lc]] = True
    parents = [p for row in avg_p + oop_p for p in row] + [
        p for _, vs in lc for p in vs.particles]
    if any(is_site[p] for p in parents):
        raise NotImplementedError("virtual sites built on virtual sites "
                                  "are not ported yet")

    static = StaticSpec(
        n_atoms=n, n_residues=n_res, n_temp_groups=G, n_chains=M,
        drude_steps=integrator.getDrudeStepsPerRealStep(),
        use_drude_nh_chains=use_drude_chains, use_com_temp_group=use_com,
        has_pairs=n_pairs > 0,
        has_hardwall=integrator.getMaxDrudeDistance() > 0,
        n_settle=len(settle), n_vsites_avg=len(avg_idx), cm_freq=cm_freq,
        baro_freq=baro_freq, ensemble_r=int(ensemble_r),
        n_shake=len(shake), n_vsites_oop=len(oop_idx), n_vsites_lc=len(lc),
        constraint_tol=float(integrator.getConstraintTolerance()))

    r, a = real_dtype, accum_dtype
    dev = lambda x, dt=None: torch.as_tensor(x, dtype=dt, device=device)
    spec = SystemSpec(
        mass=dev(masses, r), inv_mass=dev(inv_mass, r),
        tg=dev(tg), resid=dev(resid.astype(np.int64)),
        res_mass=dev(res_mass, r), res_inv_mass=dev(res_inv_mass, r),
        is_pair=dev(is_pair), is_parent=dev(is_parent), partner=dev(partner),
        nh_nkbt=dev(nkbt, a), nh_eta_mass=dev(eta_mass, a),
        nh_kbt_chain=dev(kbt_chain, a), nh_link_active=dev(link_active),
        dt=float(integrator.getStepSize()),
        max_drude_distance=float(integrator.getMaxDrudeDistance()),
        hardwall_scale=float(np.sqrt(BOLTZ
                                     * integrator.getDrudeTemperature())),
        settle_idx=dev(settle_idx), settle_dist=dev(settle_dist, r),
        vs_avg_idx=dev(np.array(avg_idx, np.int64)),
        vs_avg_p=dev(np.array(avg_p, np.int64).reshape(-1, 3)),
        vs_avg_w=dev(np.array(avg_w, np.float64).reshape(-1, 3), r),
        baro_pressure=float(baro_pressure), baro_kt=float(baro_kt),
        shake_idx=dev(shake_idx), shake_dist=dev(shake_dist, r),
        vs_oop_idx=dev(np.array(oop_idx, np.int64)),
        vs_oop_p=dev(np.array(oop_p, np.int64).reshape(-1, 3)),
        vs_oop_w=dev(np.array(oop_w, np.float64).reshape(-1, 3), r),
        vs_lc_idx=dev(np.array([i for i, _ in lc], np.int64)),
        vs_lc_p=dev(lc_p), vs_lc_ow=dev(lc_w[0], r),
        vs_lc_xw=dev(lc_w[1], r), vs_lc_yw=dev(lc_w[2], r),
        vs_lc_local=dev(lc_local, r))
    if ensemble_r > 1:
        init_edd = np.broadcast_to(init_edd,
                                   (ensemble_r,) + init_edd.shape).copy()
    return spec, static, init_edd
