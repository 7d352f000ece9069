"""DrudeForce: core-shell harmonic springs and Thole-screened dipole pairs.

  spring:   E = 1/2 k r^2, k = ONE_4PI_EPS0 q^2 / alpha (isotropic)
  screened: E = sum over the 4 core/shell cross pairs of s qq S(u) / r,
            S(u) = 1 - (1 + u/2) exp(-u), u = thole r / (a1 a2)^(1/6),
            signs (+,-,-,+) for (d1,d2), (d1,c2), (c1,d2), (c1,c2).

  NBTHOLE:  between non-bonded core/shell pairs of different molecules
            (CHARMM NBTHOLE), only the screening deficit
            s qq (S(u) - 1) / r = -s qq (1 + u/2) exp(-u) / r over the 4
            cross pairs (the plain Coulomb is in the nonbonded sum),
            minimum-imaged.

The same physics as the JAX package's forces/drude.py.  Forces here are
analytic (no autograd): F = -dE/dr along each pair.  Anisotropic springs
are not on the ported path and are refused.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..ops import scatter
from ..units import ONE_4PI_EPS0
from .boxutils import min_image


class DrudeForce:
    """OpenMM's DrudeForce API.

    addParticle(particle, particle1, particle2, particle3, particle4,
                charge, polarizability, aniso12, aniso34)
      particle  : the Drude (shell) particle
      particle1 : the parent (core) particle
      particle2..4 : anisotropy axis particles (-1 if unused)
    """

    def __init__(self):
        self._particles: List[Tuple] = []
        self._screened_pairs: List[Tuple[int, int, float]] = []
        self._nbthole: List[Tuple[int, int, float]] = []

    def addParticle(self, particle, particle1, particle2, particle3,
                    particle4, charge, polarizability, aniso12,
                    aniso34) -> int:
        self._particles.append((int(particle), int(particle1),
                                int(particle2), int(particle3),
                                int(particle4), float(charge),
                                float(polarizability), float(aniso12),
                                float(aniso34)))
        return len(self._particles) - 1

    def getNumParticles(self) -> int:
        return len(self._particles)

    def getParticleParameters(self, index: int):
        return self._particles[index]

    def setParticleParameters(self, index, particle, particle1, particle2,
                              particle3, particle4, charge, polarizability,
                              aniso12, aniso34):
        self._particles[index] = (int(particle), int(particle1),
                                  int(particle2), int(particle3),
                                  int(particle4), float(charge),
                                  float(polarizability), float(aniso12),
                                  float(aniso34))

    def addScreenedPair(self, particle1: int, particle2: int,
                        thole: float) -> int:
        """particle1/particle2 index this force's Drude particle list."""
        self._screened_pairs.append((int(particle1), int(particle2),
                                     float(thole)))
        return len(self._screened_pairs) - 1

    def getNumScreenedPairs(self) -> int:
        return len(self._screened_pairs)

    def getScreenedPairParameters(self, index: int):
        return self._screened_pairs[index]

    def addNBTholePair(self, particle1: int, particle2: int,
                       thole: float) -> int:
        self._nbthole.append((int(particle1), int(particle2), float(thole)))
        return len(self._nbthole) - 1

    def usesPeriodicBoundaryConditions(self) -> bool:
        return False

    def bonded_pairs(self) -> List[Tuple[int, int]]:
        """Drude-parent links, used for molecule detection."""
        return [(p[0], p[1]) for p in self._particles]

    def compile(self, system, dtype, device):
        if not self._particles:
            return None
        p = self._particles
        if any(x[2] >= 0 or x[3] >= 0 for x in p):
            raise NotImplementedError(
                "anisotropic Drude springs are not ported yet")
        drude = np.array([x[0] for x in p], np.int64)
        parent = np.array([x[1] for x in p], np.int64)
        charge = np.array([x[5] for x in p], np.float64)
        alpha = np.array([x[6] for x in p], np.float64)
        k3 = ONE_4PI_EPS0 * charge * charge / alpha
        term = DrudeTerm(
            drude=torch.as_tensor(drude, device=device),
            parent=torch.as_tensor(parent, device=device),
            k3=torch.as_tensor(k3, dtype=dtype, device=device))
        if self._screened_pairs:
            sp = self._screened_pairs
            sp1 = np.array([s[0] for s in sp], np.int64)
            sp2 = np.array([s[1] for s in sp], np.int64)
            thole = np.array([s[2] for s in sp], np.float64)
            t = lambda a, dt=None: torch.as_tensor(a, dtype=dt,
                                                   device=device)
            term.screened = (
                t(drude[sp1]), t(parent[sp1]), t(drude[sp2]),
                t(parent[sp2]),
                t(thole / (alpha[sp1] * alpha[sp2]) ** (1.0 / 6.0), dtype),
                t(ONE_4PI_EPS0 * charge[sp1] * charge[sp2], dtype))
        if self._nbthole:
            nt = self._nbthole
            nt1 = np.array([x[0] for x in nt], np.int64)
            nt2 = np.array([x[1] for x in nt], np.int64)
            a_thole = np.array([x[2] for x in nt], np.float64)
            t = lambda a, dt=None: torch.as_tensor(a, dtype=dt,
                                                   device=device)
            term.nbthole = (
                t(drude[nt1]), t(parent[nt1]), t(drude[nt2]),
                t(parent[nt2]),
                t(a_thole / (alpha[nt1] * alpha[nt2]) ** (1.0 / 6.0), dtype),
                t(ONE_4PI_EPS0 * charge[nt1] * charge[nt2], dtype))
        return term


class DrudeTerm:
    """Compiled DrudeForce: energy_forces(positions, box, pos_err); `box`
    is the (3,) diagonal or the (3, 3) triclinic matrix
    (boxutils.mi_box)."""

    def __init__(self, drude, parent, k3):
        self.drude = drude
        self.parent = parent
        self.k3 = k3
        self.screened = None
        self.nbthole = None

    def energy_forces(self, positions, box=None, pos_err=None,
                      with_forces=True, scale=None):
        """(energy, forces (N, 3); None without with_forces).  scale
        ((N,) float64, flat-ensemble NPT): the NBTHOLE pairs are
        minimum-imaged in their replica's box."""
        delta = positions[self.drude] - positions[self.parent]
        if pos_err is not None:
            # two-float compensation (core/state.py): the dropped low bits
            # of the tiny core-shell displacement live in pos_err
            delta = delta + (pos_err[self.drude] - pos_err[self.parent])
        r2 = torch.sum(delta * delta, dim=-1)
        energy = 0.5 * torch.sum(self.k3 * r2)
        if not with_forces:
            if self.screened is not None:
                energy = energy + screened_energy_forces(
                    self.screened, positions, False)[0]
            if self.nbthole is not None:
                energy = energy + nbthole_energy_forces(
                    self.nbthole, positions, box, False, scale)[0]
            return energy, None
        fd = -self.k3[:, None] * delta
        forces = torch.zeros_like(positions)
        scatter.index_add_(forces, self.drude, fd)
        scatter.index_add_(forces, self.parent, -fd)
        if self.screened is not None:
            e_s, f_s = screened_energy_forces(self.screened, positions)
            energy = energy + e_s
            forces = forces + f_s
        if self.nbthole is not None:
            e_t, f_t = nbthole_energy_forces(self.nbthole, positions, box,
                                             atom_scale=scale)
            energy = energy + e_t
            forces = forces + f_t
        return energy, forces

    def mc_energies(self, positions, box, scale, n_replicas: int):
        """(R,) float64 per-replica NBTHOLE sums, the DrudeForce's share of
        a flat-ensemble NPT move (the JAX package's hook,
        forces/drude.py:203-216 there): intermolecular, so they change
        under a volume move; the springs and the screened pairs are
        intramolecular and cancel.  Zeros without NBTHOLE pairs; raises
        where their count is not replica-uniform."""
        R = int(n_replicas)
        if self.nbthole is None:
            return torch.zeros(R, dtype=torch.float64,
                               device=positions.device)
        n_pairs = self.nbthole[0].shape[0]
        if n_pairs % R:
            raise ValueError("NBTHOLE pair count is not replica-uniform: "
                             "flat-ensemble NPT needs identical replicas")
        e = nbthole_energy_forces(self.nbthole, positions, box, False,
                                  scale, per_pair=True)[0]
        return torch.sum(e.double().reshape(R, -1), dim=1)


def screened_energy_forces(screened, positions, with_forces=True):
    """Thole-screened energy over the 4 core/shell cross pairs and its
    analytic forces: dE/dr = s qq (S'(u) scale / r - S(u) / r^2) with
    S'(u) = (1 + u) exp(-u) / 2."""
    d1, c1, d2, c2, scale, qq = screened
    energy = positions.new_zeros(())
    forces = torch.zeros_like(positions) if with_forces else None
    for ia, ib, sign in ((d1, d2, 1.0), (d1, c2, -1.0), (c1, d2, -1.0),
                         (c1, c2, 1.0)):
        delta = positions[ia] - positions[ib]
        r = torch.sqrt(torch.sum(delta * delta, dim=-1))
        u = scale * r
        expu = torch.exp(-u)
        s = 1.0 - (1.0 + 0.5 * u) * expu
        energy = energy + torch.sum(sign * qq * s / r)
        if not with_forces:
            continue
        dedr = sign * qq * (0.5 * (1.0 + u) * expu * scale / r - s / (r * r))
        f = (-dedr / r)[:, None] * delta
        scatter.index_add_(forces, ia, f)
        scatter.index_add_(forces, ib, -f)
    return energy, forces


def nbthole_energy_forces(nbthole, positions, box, with_forces=True,
                          atom_scale=None, per_pair=False):
    """NBTHOLE deficit -s qq (1 + u/2) exp(-u) / r over the 4 core/shell
    cross pairs, minimum-imaged, and its analytic forces:
    dE/dr = s qq exp(-u) (scale (1 + u) / (2 r) + (1 + u/2) / r^2).
    atom_scale ((N,) float64): each pair imaged in its replica's box (the
    diagonal times its first atom's scale).  per_pair: the energy of
    each NBTHOLE pair, (P,)."""
    d1, c1, d2, c2, scale, qq = nbthole
    energy = positions.new_zeros(d1.shape if per_pair else ())
    forces = torch.zeros_like(positions) if with_forces else None
    for ia, ib, sign in ((d1, d2, 1.0), (d1, c2, -1.0), (c1, d2, -1.0),
                         (c1, c2, 1.0)):
        delta = positions[ia] - positions[ib]
        if atom_scale is None:
            delta = min_image(delta, box)
        else:
            pbox = (box.double()[None, :] * atom_scale[ia][:, None]).to(
                delta.dtype)
            delta = delta - pbox * torch.round(delta / pbox)
        r = torch.sqrt(torch.sum(delta * delta, dim=-1))
        u = scale * r
        expu = torch.exp(-u)
        e_pair = sign * qq * (1.0 + 0.5 * u) * expu / r
        energy = energy - (e_pair if per_pair else torch.sum(e_pair))
        if not with_forces:
            continue
        dedr = sign * qq * expu * (0.5 * scale * (1.0 + u) / r
                                   + (1.0 + 0.5 * u) / (r * r))
        f = (-dedr / r)[:, None] * delta
        scatter.index_add_(forces, ia, f)
        scatter.index_add_(forces, ib, -f)
    return energy, forces
