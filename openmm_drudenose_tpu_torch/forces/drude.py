"""DrudeForce: core-shell harmonic springs and Thole-screened dipole pairs.

  spring:   E = 1/2 k r^2, k = ONE_4PI_EPS0 q^2 / alpha (isotropic)
  screened: E = sum over the 4 core/shell cross pairs of s qq S(u) / r,
            S(u) = 1 - (1 + u/2) exp(-u), u = thole r / (a1 a2)^(1/6),
            signs (+,-,-,+) for (d1,d2), (d1,c2), (c1,d2), (c1,c2).

The same physics as the JAX package's forces/drude.py.  Forces here are
analytic (no autograd): F = -dE/dr along each pair.  Anisotropic springs
and NBTHOLE pairs are not on the ported path and are refused.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..units import ONE_4PI_EPS0


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
        if self._nbthole:
            raise NotImplementedError("NBTHOLE pairs are not ported yet")
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
        return term


class DrudeTerm:
    """Compiled DrudeForce: energy_forces(positions, box_diag, pos_err)."""

    wants_pos_err = True

    def __init__(self, drude, parent, k3):
        self.drude = drude
        self.parent = parent
        self.k3 = k3
        self.screened = None

    def energy_forces(self, positions, box_diag=None, pos_err=None):
        delta = positions[self.drude] - positions[self.parent]
        if pos_err is not None:
            # two-float compensation (core/state.py): the dropped low bits
            # of the tiny core-shell displacement live in pos_err
            delta = delta + (pos_err[self.drude] - pos_err[self.parent])
        r2 = torch.sum(delta * delta, dim=-1)
        energy = 0.5 * torch.sum(self.k3 * r2)
        fd = -self.k3[:, None] * delta
        forces = torch.zeros_like(positions)
        forces.index_add_(0, self.drude, fd)
        forces.index_add_(0, self.parent, -fd)
        if self.screened is not None:
            e_s, f_s = screened_energy_forces(self.screened, positions)
            energy = energy + e_s
            forces = forces + f_s
        return energy, forces


def screened_energy_forces(screened, positions):
    """Thole-screened energy over the 4 core/shell cross pairs and its
    analytic forces: dE/dr = s qq (S'(u) scale / r - S(u) / r^2) with
    S'(u) = (1 + u) exp(-u) / 2."""
    d1, c1, d2, c2, scale, qq = screened
    energy = positions.new_zeros(())
    forces = torch.zeros_like(positions)
    for ia, ib, sign in ((d1, d2, 1.0), (d1, c2, -1.0), (c1, d2, -1.0),
                         (c1, c2, 1.0)):
        delta = positions[ia] - positions[ib]
        r = torch.sqrt(torch.sum(delta * delta, dim=-1))
        u = scale * r
        expu = torch.exp(-u)
        s = 1.0 - (1.0 + 0.5 * u) * expu
        energy = energy + torch.sum(sign * qq * s / r)
        dedr = sign * qq * (0.5 * (1.0 + u) * expu * scale / r - s / (r * r))
        f = (-dedr / r)[:, None] * delta
        forces.index_add_(0, ia, f)
        forces.index_add_(0, ib, -f)
    return energy, forces
