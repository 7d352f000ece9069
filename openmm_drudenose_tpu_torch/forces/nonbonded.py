"""NonbondedForce: Lennard-Jones + Coulomb with exclusions and exceptions.

The builder half mirrors OpenMM's API (as the JAX package's
forces/nonbonded.py does).  `compile` takes every method but switched LJ
on one of the JAX package's two fast strategies, chosen by its "auto"
rule (`choose_strategy`): the dense all-pairs sum (forces/dense.py) for
n <= 4096 atoms or a non-periodic method, else the cell-pair sweep.  The
Coulomb kinds are the JAX package's (forces/nonbonded.py:202-210,
:384-389 there): Ewald/PME (erfc real space plus the PME reciprocal
sum), CutoffPeriodic and CutoffNonPeriodic (the reaction field,
krf = (eps_rf - 1) / ((2 eps_rf + 1) rc^3), crf = 3 eps_rf / ((2 eps_rf
+ 1) rc), no PME and no exclusion correction) and NoCutoff (plain
Coulomb over every pair, no minimum image).  The compiled term splits
the work as the JAX force-only step does (forces/nonbonded.py:823-898
there):

  sweep_forces : direct-space forces; on the cell-pair strategy in
                 float32 a hand-written kernel, B1 (ops/sweep.py) or the
                 chunked B2 (ops/sweep_chunked.py) as the JAX gates route
                 the config (ops/sweep.py::route), in its Ewald or
                 reaction-field instantiation, the plain sweep otherwise;
                 the dense sum on the dense strategy
  sweep_energy : the direct-space energy, by the same kernel's energy
                 instantiation in float32 on the cell-pair strategy
  recip        : PME reciprocal energy and analytic forces (forces/pme.py;
                 Ewald/PME only: `pme` is None otherwise)
  extras       : exceptions, reciprocal exclusion corrections (Ewald/PME),
                 NBFIX overrides, the Ewald self term and the dispersion
                 tail (periodic cutoff methods) (forces/pairterms.py)

A triclinic periodic box (reduced form, forces/boxutils.py) runs on both
strategies, as in the JAX package (forces/nonbonded.py:168-195 there):
the cutoff is held to half the smallest perpendicular width, the
cell-pair plan takes the full (3, 3) box, and the PME grid keeps OpenMM's
choice (it is not rounded to the cell grid); every term then takes the
(3, 3) box where the Context passes it (boxutils.mi_box).

Exceptions are excluded from the main pair sum and added back as explicit
pair terms (plain Coulomb chargeProd/r + LJ, no cutoff), as in OpenMM.
NBFIX overrides (addLJPairOverride) replace the combined LJ of their
pairs inside the cutoff by a correction term over those pairs.

nb_options={"ensemble": (R, rx, rz)} compiles a flattened replica
ensemble (parallel/flatrep.py; the JAX package's branch at
forces/nonbonded.py:499-560): the System holds R replica-major copies of
one replica in one orthorhombic box; the cell-pair plan embeds them in
rx x rz replica bands (cellpair.make_ensemble_config), the dispersion
constant is divided by R (replicas do not interact), the PME grid is
planned on one replica's cell grid and the reciprocal sum runs for the R
replicas in one batched pass (pme.recip_energy_forces, n_replicas); the
exception and exclusion-correction terms are the replicas' copies
through the same pair terms.

Flat-ensemble NPT (the JAX package's rep_scale route, forces/
nonbonded.py:641-796 there): every method of the compiled term takes
`rep_scale`, the (R,) float64 box scales on the device.  The sweep runs
the kernels' scaled instantiations on physical fields (cellpair.py), the
PME sum each replica at its own box (pme.py), the pair terms
minimum-image in each pair's replica box, and the dispersion tail is
disp / R / (V s_r^3) a replica.  `mc_energies` gives the (R,) float64
per-replica energies of every term that changes under a molecule-COM
volume move (the sweep, PME, the dispersion tail, the NBFIX overrides);
the others cancel in the Metropolis difference.  `route` sends a scaled
config to B1 or B2 by the same gates.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..ops import sweep, sweep_chunked
from ..units import ONE_4PI_EPS0
from . import boxutils, cellpair, dense, pairterms, pme as pme_mod

# the JAX package's "auto" rule: at most this many atoms go to the dense
# strategy (forces/nonbonded.py:188-190 there)
DENSE_MAX_ATOMS = 4096


class NonbondedForce:
    NoCutoff = 0
    CutoffNonPeriodic = 1
    CutoffPeriodic = 2
    Ewald = 3
    PME = 4

    def __init__(self):
        self._particles: List[Tuple[float, float, float]] = []
        self._exceptions: List[Tuple[int, int, float, float, float]] = []
        self._lj_overrides: List[Tuple] = []  # (set1, set2, sigma, eps)
        self._method = self.NoCutoff
        self._cutoff = 1.0
        self._use_switching = False
        self._switching_distance = -1.0
        self._ewald_tol = 5e-4
        self._rf_dielectric = 78.3
        self._use_dispersion_correction = True
        self._pme_params = (0.0, 0, 0, 0)

    def addParticle(self, charge: float, sigma: float,
                    epsilon: float) -> int:
        self._particles.append((float(charge), float(sigma),
                                float(epsilon)))
        return len(self._particles) - 1

    def getNumParticles(self) -> int:
        return len(self._particles)

    def getParticleParameters(self, index: int):
        return self._particles[index]

    def setParticleParameters(self, index: int, charge, sigma, epsilon):
        self._particles[index] = (float(charge), float(sigma),
                                  float(epsilon))

    def addException(self, particle1: int, particle2: int,
                     chargeProd: float, sigma: float, epsilon: float,
                     replace: bool = False) -> int:
        self._exceptions.append((int(particle1), int(particle2),
                                 float(chargeProd), float(sigma),
                                 float(epsilon)))
        return len(self._exceptions) - 1

    def addLJPairOverride(self, particles1, particles2, sigma: float,
                          epsilon: float) -> int:
        """NBFIX pair-specific LJ: every (i in particles1, j in
        particles2) pair interacts with this sigma/epsilon in place of
        the Lorentz-Berthelot combination (CHARMM NBFIX)."""
        self._lj_overrides.append((tuple(int(p) for p in particles1),
                                   tuple(int(p) for p in particles2),
                                   float(sigma), float(epsilon)))
        return len(self._lj_overrides) - 1

    def getNumExceptions(self) -> int:
        return len(self._exceptions)

    def getExceptionParameters(self, index: int):
        return self._exceptions[index]

    def setNonbondedMethod(self, method: int) -> None:
        self._method = int(method)

    def getNonbondedMethod(self) -> int:
        return self._method

    def setCutoffDistance(self, cutoff: float) -> None:
        self._cutoff = float(cutoff)

    def getCutoffDistance(self) -> float:
        return self._cutoff

    def setUseSwitchingFunction(self, use: bool) -> None:
        self._use_switching = bool(use)

    def getUseSwitchingFunction(self) -> bool:
        return self._use_switching

    def setSwitchingDistance(self, distance: float) -> None:
        self._switching_distance = float(distance)

    def getSwitchingDistance(self) -> float:
        return self._switching_distance

    def setEwaldErrorTolerance(self, tol: float) -> None:
        self._ewald_tol = float(tol)

    def getEwaldErrorTolerance(self) -> float:
        return self._ewald_tol

    def setReactionFieldDielectric(self, eps: float) -> None:
        self._rf_dielectric = float(eps)

    def getReactionFieldDielectric(self) -> float:
        return self._rf_dielectric

    def setUseDispersionCorrection(self, use: bool) -> None:
        self._use_dispersion_correction = bool(use)

    def getUseDispersionCorrection(self) -> bool:
        return self._use_dispersion_correction

    def setPMEParameters(self, alpha: float, nx: int, ny: int,
                         nz: int) -> None:
        self._pme_params = (float(alpha), int(nx), int(ny), int(nz))

    def usesPeriodicBoundaryConditions(self) -> bool:
        return self._method in (self.CutoffPeriodic, self.Ewald, self.PME)

    def bonded_pairs(self) -> List[Tuple[int, int]]:
        """Exceptions link particles into molecules (OpenMM's
        getMolecules())."""
        return [(e[0], e[1]) for e in self._exceptions]

    def compile(self, system, dtype, device, nb_options=None,
                strategy: str = "auto"):
        n = len(self._particles)
        if n == 0:
            return None
        if n != system.getNumParticles():
            raise ValueError("NonbondedForce must define parameters for "
                             "every particle")
        if strategy == "auto":
            strategy = choose_strategy(n, self._method)
        if self._method not in (self.NoCutoff, self.CutoffNonPeriodic,
                                self.CutoffPeriodic, self.Ewald, self.PME):
            raise ValueError(f"unknown nonbonded method {self._method}")
        if (self._use_switching and self._switching_distance >= 0
                and self._method != self.NoCutoff):
            raise NotImplementedError("switched LJ is not ported yet")
        opts = dict(nb_options or {})
        if self.triclinic(system):
            box = np.array(system.getDefaultPeriodicBoxVectors(), np.float64)
            w_min = float(np.min(np.diagonal(box)))
            if self._cutoff > w_min / 2:
                raise ValueError(
                    f"cutoff {self._cutoff} exceeds half the smallest "
                    f"perpendicular width {w_min} of the triclinic box — "
                    "the sequential minimum-image reduction would miss "
                    "images")
        if strategy == "dense":
            if opts.get("ensemble"):
                raise ValueError("a flattened replica ensemble runs on the "
                                 "cell-pair strategy (its replicas share "
                                 "one box)")
            return DenseTerm(self, system, dtype, device)
        if strategy == "cellpair":
            if not self.usesPeriodicBoundaryConditions():
                raise ValueError("the cell-pair strategy takes periodic "
                                 "methods (CutoffPeriodic, Ewald, PME)")
            return CellPairTerm(self, system, dtype, device, opts)
        raise ValueError(f"unknown strategy {strategy!r}; the port has "
                         "'auto', 'dense' and 'cellpair'")

    def triclinic(self, system) -> bool:
        """Whether the force runs in a triclinic box: a periodic cutoff
        method and off-diagonal box entries."""
        return (self._method in (self.CutoffPeriodic, self.Ewald, self.PME)
                and boxutils.is_triclinic(
                    system.getDefaultPeriodicBoxVectors()))


def choose_strategy(n_atoms: int, method: int) -> str:
    """The JAX package's "auto" rule: the dense all-pairs sum for at most
    DENSE_MAX_ATOMS atoms or a non-periodic method, else the cell-pair
    sweep."""
    if n_atoms <= DENSE_MAX_ATOMS or method in (
            NonbondedForce.NoCutoff, NonbondedForce.CutoffNonPeriodic):
        return "dense"
    return "cellpair"


def override_pairs(force, exc_i, exc_j):
    """NBFIX correction pairs, as the JAX package lists them: per
    override, every (a, b) of its two sets with a != b, not excluded, once
    each, as (i, j, sigma, epsilon) arrays."""
    excluded = {(min(a, b), max(a, b))
                for a, b in zip(exc_i.tolist(), exc_j.tolist())}
    out = []
    for set1, set2, sig_o, eps_o in force._lj_overrides:
        seen = set()
        for a in set1:
            for b in set2:
                key = (min(a, b), max(a, b))
                if a == b or key in excluded or key in seen:
                    continue
                seen.add(key)
                out.append((key[0], key[1], sig_o, eps_o))
    arr = np.array(out, np.float64).reshape(-1, 4)
    return (arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64),
            arr[:, 2], arr[:, 3])


def dispersion_coefficient(sigma, eps, cutoff):
    """C with E_disp = C / V: the mean LJ pair tail beyond the cutoff under
    Lorentz-Berthelot mixing (O(N) via the binomial expansion)."""
    n = len(sigma)
    sqrt_eps = np.sqrt(eps)

    def pair_mean(p):
        moments = [np.mean(sqrt_eps * sigma ** k) for k in range(p + 1)]
        return sum(math.comb(p, k) * moments[k] * moments[p - k]
                   for k in range(p + 1)) / 2.0 ** p

    sig6 = pair_mean(6)
    sig12 = pair_mean(12)
    integral = 16.0 * np.pi * (sig12 / (9.0 * cutoff ** 9)
                               - sig6 / (3.0 * cutoff ** 3))
    return 0.5 * n * n * integral


class NonbondedTerm:
    """Compiled NonbondedForce: what both strategies share, the Coulomb
    kind (`coulomb`: the keyword arguments of the pair sums), the PME
    reciprocal sum (Ewald/PME) and the pair-list extras.  `cell_grid`
    rounds the PME grid up to the cell grid, as the JAX package plans it
    for the cell-pair strategy."""

    cfg = None
    n_replicas = 1

    def __init__(self, force, system, dtype, device, cell_grid=None):
        p = force._particles
        n = len(p)
        charge = np.array([x[0] for x in p], np.float64)
        sigma = np.array([x[1] for x in p], np.float64)
        eps = np.array([x[2] for x in p], np.float64)
        ex = force._exceptions
        exc_i = np.array([e[0] for e in ex], np.int64)
        exc_j = np.array([e[1] for e in ex], np.int64)
        exc_qq = np.array([e[2] for e in ex], np.float64)
        exc_sigma = np.array([e[3] for e in ex], np.float64)
        exc_eps = np.array([e[4] for e in ex], np.float64)
        box0 = np.diagonal(np.array(system.getDefaultPeriodicBoxVectors(),
                                    np.float64)).copy()
        cutoff = force._cutoff
        method = force._method
        ewald = method in (force.Ewald, force.PME)
        self.periodic = force.usesPeriodicBoundaryConditions()
        self.use_cutoff = method != force.NoCutoff
        self.n_atoms = n
        self.dtype = dtype
        self.device = device
        self.cutoff = cutoff
        self._exc = (exc_i, exc_j)
        t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=device)
        self.params = {"charge": t(charge), "sigma": t(sigma), "eps": t(eps)}
        self.pme = None
        self.alpha = 0.0
        self.pme_self = 0.0
        if ewald:
            alpha0, gx, gy, gz = force._pme_params
            self.pme = pme_mod.setup_pme(
                cutoff=cutoff, tol=force._ewald_tol, box_diag=box0,
                alpha=alpha0 or None, grid=(gx, gy, gz) if gx > 0 else None,
                cell_grid=None if force.triclinic(system) else cell_grid)
            self.alpha = self.pme.alpha
            # the JAX package's pencil locality gate (the windows cover
            # at most a quarter of the (x, y) grid plane), recorded; the
            # port's spread is the generic one whatever it says
            self.pme_pencil_gate = pme_mod.pencil_gate(self.pme.grid,
                                                       cell_grid)
            # bounds every PME grid value (pme.spread's fixed-point sum):
            # one replica's charges in a flattened ensemble
            R = self.n_replicas
            self.charge_bound = float(np.sum(np.abs(charge[:n // R])))
            self.pme_self = float(-self.alpha / np.sqrt(np.pi)
                                  * ONE_4PI_EPS0 * np.sum(charge ** 2))
            self.coulomb = {"method": "ewald"}
        elif self.use_cutoff:
            # the reaction field (forces/nonbonded.py:207-210 there)
            eps_rf = force._rf_dielectric
            self.coulomb = {
                "method": "rf",
                "krf": (1.0 / cutoff ** 3) * (eps_rf - 1.0)
                / (2.0 * eps_rf + 1.0),
                "crf": (1.0 / cutoff) * (3.0 * eps_rf)
                / (2.0 * eps_rf + 1.0)}
        else:
            self.coulomb = {"method": "none"}
        self.disp = (dispersion_coefficient(sigma, eps, cutoff)
                     if force._use_dispersion_correction and self.periodic
                     else None)
        if self.disp is not None and self.n_replicas > 1:
            # the coefficient counts (R n0)^2 pairs; replicas do not
            # interact: R n0^2 (the JAX package's disp / ens_r)
            self.disp = self.disp / self.n_replicas

        self.pair_terms = []
        act = (exc_qq != 0.0) | (exc_eps != 0.0)
        if np.any(act):
            self.pair_terms.append(pairterms.make_pair_list_term(
                exc_i[act], exc_j[act], pairterms.exception_eg(
                    t(ONE_4PI_EPS0 * exc_qq[act]), t(exc_sigma[act]),
                    t(exc_eps[act])), device, self.periodic))
        if len(ex) and ewald:
            self.pair_terms.append(pairterms.make_pair_list_term(
                exc_i, exc_j, pairterms.ewald_correction_eg(
                    t(ONE_4PI_EPS0 * charge[exc_i] * charge[exc_j]),
                    self.alpha), device))
        self.override_term = None
        self.overrides_uniform = True
        if force._lj_overrides:
            oi, oj, sig_o, eps_o = override_pairs(force, exc_i, exc_j)
            if len(oi):
                self.override_term = pairterms.make_pair_list_term(
                    oi, oj, pairterms.lj_override_eg(
                        t(sig_o), t(eps_o),
                        t(0.5 * (sigma[oi] + sigma[oj])),
                        t(np.sqrt(eps[oi] * eps[oj])),
                        cutoff if self.use_cutoff else math.inf), device,
                    self.periodic)
                self.pair_terms.append(self.override_term)
                R = self.n_replicas
                rep_i, rep_j = oi // (n // R), oj // (n // R)
                P = len(oi)
                # per-replica sums need replica-major pair lists of one
                # length a replica (replicate_system builds them so)
                self.overrides_uniform = bool(
                    P % R == 0
                    and np.array_equal(rep_i, np.arange(P) // (P // R))
                    and np.array_equal(rep_i, rep_j))
        self._eterms = []

    def _eterm(self, box, rep_scale, dtype):
        """The per-replica PME eterm of these scales (pme.scaled_eterm),
        built once per set of scales: an accepted move makes new ones.
        The last three are kept (the current scales, a move's trial and
        its outcome), keyed by the scale tensor and the box's storage,
        both held."""
        for rs, _, ptr, et in self._eterms:
            if (rs is rep_scale and ptr == box.data_ptr()
                    and et.dtype == dtype):
                return et
        et = pme_mod.scaled_eterm(self.pme, box, rep_scale, dtype)
        self._eterms = [(rep_scale, box, box.data_ptr(), et)] \
            + self._eterms[:2]
        return et

    def recip(self, positions, box, exact=None, rep_scale=None):
        """(energy, forces) of the PME reciprocal sum (Ewald/PME only;
        the replicas' sums in one batched pass in a flattened
        ensemble, each at its own box with rep_scale).  `box` here and
        below: the (3,) diagonal or the (3, 3) triclinic matrix
        (boxutils.mi_box)."""
        eterm = (None if rep_scale is None
                 else self._eterm(box, rep_scale, positions.dtype))
        e, f = pme_mod.recip_energy_forces(
            self.pme, self.params["charge"], positions, box, exact,
            self.charge_bound, self.n_replicas, rep_scale, eterm)
        return (e if self.n_replicas == 1 else torch.sum(e)), f

    def recip_energy(self, positions, box, exact=None, rep_scale=None,
                     per_replica=False):
        eterm = (None if rep_scale is None
                 else self._eterm(box, rep_scale, positions.dtype))
        return pme_mod.reciprocal_energy(self.pme, self.params["charge"],
                                         positions, box, exact,
                                         self.charge_bound,
                                         self.n_replicas, rep_scale, eterm,
                                         per_replica)

    def _dispersion(self, box, rep_scale=None):
        """The dispersion tail, or with rep_scale its (R,) per-replica
        values disp / R / (V s_r^3) in float64."""
        vol = boxutils.volume(box)
        if rep_scale is None:
            return self.disp / vol
        return (self.disp / self.n_replicas) / (
            vol.double() * rep_scale.double() ** 3)

    def extras(self, positions, box, exact=None, with_forces=True,
               rep_scale=None):
        """(energy, forces; None without with_forces): exceptions,
        exclusion corrections, NBFIX overrides, self term, dispersion
        tail (each where the method has it); with rep_scale each pair
        imaged in its replica's box and each replica's tail at its
        volume."""
        e = positions.new_zeros(()) + self.pme_self
        f = torch.zeros_like(positions) if with_forces else None
        scale = (None if rep_scale is None
                 else cellpair.atom_scales(rep_scale, positions.shape[0]))
        for term in self.pair_terms:
            et, ft = term(positions, box, exact, with_forces, scale)
            e = e + et
            if with_forces:
                f = f + ft
        if self.disp is not None:
            d = self._dispersion(box, rep_scale)
            e = e + (d if rep_scale is None else torch.sum(d).to(e.dtype))
        return e, f

    def mc_energies(self, positions, box, neighbors, exact, rep_scale):
        """(R,) float64 per-replica energies of the terms that change
        under a molecule-COM volume move (the JAX package's mc_energies,
        forces/nonbonded.py:767-796 there): the direct-space sweep, the
        PME reciprocal sum, the dispersion tail and the NBFIX overrides.
        Exceptions, exclusion corrections and the self term are
        intramolecular or constant and cancel in the Metropolis
        difference."""
        e = self.sweep_energy(positions, box, neighbors, exact, rep_scale,
                              per_replica=True).double()
        if self.pme is not None:
            e = e + self.recip_energy(positions, box, exact, rep_scale,
                                      per_replica=True).double()
        if self.override_term is not None:
            if not self.overrides_uniform:
                raise ValueError(
                    "flat-ensemble NPT needs replica-uniform NBFIX override "
                    "pair lists (every replica the same overrides, "
                    "replica-major)")
            scale = cellpair.atom_scales(rep_scale, positions.shape[0])
            e = e + self.override_term(
                positions, box, exact, False, scale,
                n_replicas=self.n_replicas)[0].double()
        if self.disp is not None:
            e = e + self._dispersion(box, rep_scale)
        return e


class DenseTerm(NonbondedTerm):
    """The dense strategy: the all-pairs direct-space sum of
    forces/dense.py over a static (N, N) exclusion mask; no neighbour
    structure."""

    strategy = "dense"

    def __init__(self, force, system, dtype, device):
        super().__init__(force, system, dtype, device)
        n = self.n_atoms
        exc_i, exc_j = self._exc
        mask = np.ones((n, n), dtype=bool)
        np.fill_diagonal(mask, False)
        mask[exc_i, exc_j] = False
        mask[exc_j, exc_i] = False
        self.pair_mask = torch.as_tensor(mask, device=device)

    def _sweep(self, positions, box, exact, with_energy):
        return dense.pair_energy_forces(
            self.params, positions, box, self.pair_mask, self.cutoff,
            self.alpha, ONE_4PI_EPS0, with_energy=with_energy, exact=exact,
            periodic=self.periodic, use_cutoff=self.use_cutoff,
            **self.coulomb)

    def sweep_forces(self, positions, box, neighbors=None, exact=None,
                     rep_scale=None):
        """rep_scale: None (per-replica scales are a cell-pair
        ensemble's)."""
        assert rep_scale is None
        return self._sweep(positions, box, exact, False)[1]

    def sweep_energy(self, positions, box, neighbors=None, exact=None,
                     rep_scale=None):
        assert rep_scale is None
        return self._sweep(positions, box, exact, True)[0]


class CellPairTerm(NonbondedTerm):
    """The cell-pair strategy (periodic methods): sorted fields, the sweep
    kernels B1/B2 in float32 in the instantiation of the method's Coulomb
    kind (their plain versions on the CPU), the plain sweep in
    float64."""

    strategy = "cellpair"

    def __init__(self, force, system, dtype, device, opts):
        n = len(force._particles)
        exc_i = np.array([e[0] for e in force._exceptions], np.int64)
        exc_j = np.array([e[1] for e in force._exceptions], np.int64)
        box0 = np.array(system.getDefaultPeriodicBoxVectors(), np.float64)
        triclinic = force.triclinic(system)
        if not triclinic:
            box0 = np.diagonal(box0).copy()
        ens = opts.get("ensemble")
        if ens:
            R, rx, rz = (int(v) for v in ens)
            if triclinic:
                raise ValueError("flattened replica ensembles require an "
                                 "orthorhombic replica box")
            if n % R:
                raise ValueError("ensemble atom count not divisible by the "
                                 "replica count")
            self.n_replicas = R
            self.cfg = cellpair.make_ensemble_config(
                force._cutoff, box0, n // R, R, exc_i, exc_j, rx=rx, rz=rz,
                capacity=opts.get("capacity"))
        else:
            self.cfg = cellpair.make_config(force._cutoff, box0, n, exc_i,
                                            exc_j,
                                            capacity=opts.get("capacity"))
        super().__init__(force, system, dtype, device,
                         cell_grid=self.cfg.phys_grid)
        self.params["excl_words"] = torch.as_tensor(
            cellpair.build_exclusion_words(n, exc_i, exc_j,
                                           self.cfg.excl_window,
                                           self.cfg.excl_words),
            device=device)
        # the kernels (float32) skip the exclusion test at far stencil
        # offsets; every rebuild then latches whether that stays sound.
        # Which kernel, and the JAX gate's chunk height, are recorded as
        # the JAX force records uses_pallas / pallas_chunk
        self.use_kernel = dtype == torch.float32
        self.sweep_kernel, self.pallas_chunk = (
            sweep.route(self.cfg, opts.get("use_pallas"),
                        sweep_chunked.card_limits(device))
            if self.use_kernel else (None, None))
        self.excl_skip = self.use_kernel and bool(
            opts.get("excl_skip", True))
        self.excl_ij = ((torch.as_tensor(exc_i, device=device),
                         torch.as_tensor(exc_j, device=device))
                        if self.excl_skip else None)

    def cellsort(self, positions, box, rep_scale=None):
        return cellpair.build_cellsort(positions, box, self.cfg,
                                       excl_ij=self.excl_ij,
                                       rep_scale=rep_scale)

    def fields(self, positions, box, cellsort, exact=None, rep_scale=None):
        return cellpair.sorted_fields(self.params, positions, box,
                                      cellsort, self.cfg, exact, rep_scale)

    def _kernel(self):
        return sweep_chunked if self.sweep_kernel == "b2" else sweep

    def sweep_forces(self, positions, box, cellsort, exact=None,
                     rep_scale=None):
        """Direct-space forces (N, 3), atom order; physical with
        rep_scale (the kernels' scaled instantiations)."""
        fields = self.fields(positions, box, cellsort, exact, rep_scale)
        shifts = cellpair.offset_shifts(self.cfg, box, rep_scale)
        if self.use_kernel:
            f = self._kernel().pair_forces(fields, self.cfg, shifts,
                                           self.alpha, ONE_4PI_EPS0,
                                           excl_skip=self.excl_skip,
                                           **self.coulomb)
        else:
            _, f = cellpair.sweep(fields, self.cfg, shifts, self.alpha,
                                  ONE_4PI_EPS0, with_energy=False,
                                  **self.coulomb)
        return f[cellsort.inv_slot]

    def sweep_energy(self, positions, box, cellsort, exact=None,
                     rep_scale=None, per_replica=False):
        """Direct-space energy (exact erfc): in float32 the energy
        instantiation of the kernel that `route` chose (float64 on the
        card; its plain version on the CPU), else the plain sweep.  With
        rep_scale the scaled instantiation: the (R,) per-replica energies
        with per_replica, else their sum."""
        fields = self.fields(positions, box, cellsort, exact, rep_scale)
        shifts = cellpair.offset_shifts(self.cfg, box, rep_scale)
        if self.use_kernel:
            e = self._kernel().pair_energy(fields, self.cfg, shifts,
                                           self.alpha, ONE_4PI_EPS0,
                                           excl_skip=self.excl_skip,
                                           **self.coulomb)
        else:
            e, _ = cellpair.sweep(fields, self.cfg, shifts, self.alpha,
                                  ONE_4PI_EPS0, with_energy=True,
                                  per_replica=rep_scale is not None,
                                  **self.coulomb)
        if rep_scale is not None and not per_replica:
            e = torch.sum(e.double())
        return e
