"""NonbondedForce: Lennard-Jones + Coulomb with exclusions and exceptions.

The builder half mirrors OpenMM's API (as the JAX package's
forces/nonbonded.py does).  `compile` takes the path the bench
configuration runs: Ewald/PME with the cell-pair strategy.  The compiled
term splits the work as the JAX force-only step does
(forces/nonbonded.py:823-898 there):

  sweep_forces : direct-space forces; in float32 a hand-written kernel,
                 B1 (ops/sweep.py) or the chunked B2
                 (ops/sweep_chunked.py) as the JAX gates route the config
                 (ops/sweep.py::route), the plain sweep otherwise
  recip        : PME reciprocal energy and analytic forces (forces/pme.py)
  extras       : exceptions, reciprocal exclusion corrections, the Ewald
                 self term and the dispersion tail (forces/pairterms.py)

Exceptions are excluded from the main pair sum and added back as explicit
pair terms (plain Coulomb chargeProd/r + LJ, no cutoff), as in OpenMM.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..ops import sweep, sweep_chunked
from ..units import ONE_4PI_EPS0
from . import cellpair, pairterms, pme as pme_mod


class NonbondedForce:
    NoCutoff = 0
    CutoffNonPeriodic = 1
    CutoffPeriodic = 2
    Ewald = 3
    PME = 4

    def __init__(self):
        self._particles: List[Tuple[float, float, float]] = []
        self._exceptions: List[Tuple[int, int, float, float, float]] = []
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

    def compile(self, system, dtype, device, nb_options=None):
        n = len(self._particles)
        if n == 0:
            return None
        if n != system.getNumParticles():
            raise ValueError("NonbondedForce must define parameters for "
                             "every particle")
        if self._method not in (self.Ewald, self.PME):
            raise NotImplementedError(
                "the PyTorch port runs Ewald/PME on the cell-pair "
                "strategy only")
        if self._use_switching and self._switching_distance >= 0:
            raise NotImplementedError("switched LJ is not ported yet")
        return NonbondedTerm(self, system, dtype, device,
                             dict(nb_options or {}))


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
    """Compiled NonbondedForce (Ewald/PME, cell-pair strategy)."""

    def __init__(self, force, system, dtype, device, opts):
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
        self.n_atoms = n
        self.dtype = dtype
        self.device = device
        t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=device)

        self.cfg = cellpair.make_config(cutoff, box0, n, exc_i, exc_j,
                                        capacity=opts.get("capacity"))
        alpha0, gx, gy, gz = force._pme_params
        self.pme = pme_mod.setup_pme(
            cutoff=cutoff, tol=force._ewald_tol, box_diag=box0,
            alpha=alpha0 or None, grid=(gx, gy, gz) if gx > 0 else None,
            cell_grid=self.cfg.grid)
        self.alpha = self.pme.alpha
        self.params = {
            "charge": t(charge), "sigma": t(sigma), "eps": t(eps),
            "excl_words": torch.as_tensor(cellpair.build_exclusion_words(
                n, exc_i, exc_j, self.cfg.excl_window, self.cfg.excl_words),
                device=device),
        }
        self.pme_self = float(-self.alpha / np.sqrt(np.pi) * ONE_4PI_EPS0
                              * np.sum(charge ** 2))
        self.disp = (dispersion_coefficient(sigma, eps, cutoff)
                     if force._use_dispersion_correction else None)

        act = (exc_qq != 0.0) | (exc_eps != 0.0)
        self.exc_term = None
        if np.any(act):
            self.exc_term = pairterms.make_pair_list_term(
                exc_i[act], exc_j[act], pairterms.exception_eg(
                    t(ONE_4PI_EPS0 * exc_qq[act]), t(exc_sigma[act]),
                    t(exc_eps[act])), device)
        self.corr_term = None
        if len(ex):
            self.corr_term = pairterms.make_pair_list_term(
                exc_i, exc_j, pairterms.ewald_correction_eg(
                    t(ONE_4PI_EPS0 * charge[exc_i] * charge[exc_j]),
                    self.alpha), device)
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

    def cellsort(self, positions, box_diag):
        return cellpair.build_cellsort(positions, box_diag, self.cfg,
                                       excl_ij=self.excl_ij)

    def fields(self, positions, box_diag, cellsort, exact=None):
        return cellpair.sorted_fields(self.params, positions, box_diag,
                                      cellsort, self.cfg, exact)

    def sweep_forces(self, positions, box_diag, cellsort, exact=None):
        """Direct-space forces (N, 3), atom order."""
        fields = self.fields(positions, box_diag, cellsort, exact)
        shifts = cellpair.offset_shifts(self.cfg, box_diag)
        if self.use_kernel:
            kernel = (sweep_chunked if self.sweep_kernel == "b2" else sweep)
            f = kernel.pair_forces(fields, self.cfg, shifts, self.alpha,
                                   ONE_4PI_EPS0, excl_skip=self.excl_skip)
        else:
            _, f = cellpair.sweep(fields, self.cfg, shifts, self.alpha,
                                  ONE_4PI_EPS0, with_energy=False)
        return f[cellsort.inv_slot]

    def sweep_energy(self, positions, box_diag, cellsort, exact=None):
        """Direct-space energy (the plain sweep, exact erfc)."""
        fields = self.fields(positions, box_diag, cellsort, exact)
        shifts = cellpair.offset_shifts(self.cfg, box_diag)
        e, _ = cellpair.sweep(fields, self.cfg, shifts, self.alpha,
                              ONE_4PI_EPS0, with_energy=True)
        return e

    def recip(self, positions, box_diag, exact=None):
        """(energy, forces) of the PME reciprocal sum."""
        return pme_mod.recip_energy_forces(self.pme, self.params["charge"],
                                           positions, box_diag, exact)

    def recip_energy(self, positions, box_diag, exact=None):
        return pme_mod.reciprocal_energy(self.pme, self.params["charge"],
                                         positions, box_diag, exact)

    def extras(self, positions, box_diag, exact=None):
        """(energy, forces): exceptions, exclusion corrections, self term,
        dispersion tail."""
        e = positions.new_zeros(()) + self.pme_self
        f = torch.zeros_like(positions)
        for term in (self.exc_term, self.corr_term):
            if term is not None:
                et, ft = term(positions, box_diag, exact)
                e = e + et
                f = f + ft
        if self.disp is not None:
            e = e + self.disp / (box_diag[0] * box_diag[1] * box_diag[2])
        return e, f
