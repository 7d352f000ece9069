"""Bonded force terms: harmonic bonds and angles, periodic and harmonic
torsions.

  bond:     E = 1/2 k (r - r0)^2
  angle:    E = 1/2 k (theta - theta0)^2
  periodic: E = k (1 + cos(n phi - phase))
  harmonic: E = k wrap(phi - theta0)^2, wrap into [-pi, pi] (CHARMM
            impropers; k without the 1/2)

The same builders and energies as the JAX package's forces/bonded.py
(:16-228 there), with its dihedral convention: b1 = r_j - r_i,
b2 = r_k - r_j, b3 = r_l - r_k, c1 = b1 x b2, c2 = b2 x b3,
phi = atan2((c1 x b2/|b2|) . c2, c1 . c2).  Like the JAX package, the
terms take no minimum image: a molecule is whole in the positions
(bonded_pairs() makes it one molecule, core/topology.py).

In float32 the Context passes the compensated positions in float64
(`exact`: the float32 positions plus the integrator's compensation, the
positions the nonbonded terms read too): each term is evaluated in
float64 from them and its energy and forces rounded once.  From rounded
float32 absolute positions a bond of k = 9e4 kJ/mol/nm^2 16 nm from the
origin carries ~1e-6 nm of rounding in its length, ~0.1 kJ/mol/nm of
force: the float32 force pass of the 100k-atom ionic liquid missed
float64 by 6.5e-6 of max|F| (rms) that way (an NVIDIA H100 80GB HBM3 at
700 W).

Forces are analytic, not autograd (as forces/drude.py): the bond along
its axis, the angle by dtheta/dv1 = (v1 x n) / (|v1|^2 |n|) and
dtheta/dv2 = (n x v2) / (|v2|^2 |n|) with n = v1 x v2, and the torsion
by the Blondel-Karplus form (J. Comput. Chem. 17 (1996) 1132), whose
only divisors are |c1|^2, |c2|^2 and |b2|: no 1/sin(phi), so it stays
exact where phi passes 0 or pi, and the 1/|c1|^2 growth as three atoms
turn collinear is the true derivative's (where |c1| or |c2| is exactly
zero the angle is undefined and the force is zero).  Per-atom sums go
through ops/scatter.py::index_add_.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..ops import scatter


def _index(a, device):
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


class _Term:
    """A compiled bonded force: energy_forces(positions, box=None,
    pos_err=None, with_forces=True, exact=None) -> (energy, forces (N,
    3); None without with_forces), in the positions' type.  `exact`
    (float64 positions) replaces the positions where given; the box and
    pos_err are not read."""

    takes_exact = True

    def __init__(self, idx, params):
        self.idx = idx          # per-term atom index tensors
        self.params = params    # per-term parameter tensors

    def energy_forces(self, positions, box=None, pos_err=None,
                      with_forces=True, exact=None):
        src = positions if exact is None else exact
        e, grads = self._eval([src[i] for i in self.idx], with_forces)
        e = e.to(positions.dtype)
        if not with_forces:
            return e, None
        forces = torch.zeros_like(positions)
        for i, g in zip(self.idx, grads):
            scatter.index_add_(forces, i, (-g).to(positions.dtype))
        return e, forces


class _BondTerm(_Term):
    def _eval(self, p, with_forces):
        r0, k = self.params
        delta = p[0] - p[1]
        r = torch.sqrt(torch.sum(delta * delta, dim=-1))
        dr = r - r0
        e = 0.5 * torch.sum(k * dr * dr)
        if not with_forces:
            return e, None
        g = torch.where(r > 0, k * dr / torch.where(r > 0, r, 1.0),
                        torch.zeros_like(r))[:, None] * delta
        return e, (g, -g)


def _angle(v1, v2):
    """(theta, n = v1 x v2, |n|): the angle between v1 and v2 by atan2,
    exact at both ends of [0, pi]."""
    n = torch.linalg.cross(v1, v2, dim=-1)
    nn = torch.sqrt(torch.sum(n * n, dim=-1))
    return torch.atan2(nn, torch.sum(v1 * v2, dim=-1)), n, nn


class _AngleTerm(_Term):
    def _eval(self, p, with_forces):
        theta0, k = self.params
        v1 = p[0] - p[1]
        v2 = p[2] - p[1]
        theta, n, nn = _angle(v1, v2)
        dth = theta - theta0
        e = 0.5 * torch.sum(k * dth * dth)
        if not with_forces:
            return e, None
        ok = nn > 0
        safe = torch.where(ok, nn, torch.ones_like(nn))
        de = torch.where(ok, k * dth / safe, torch.zeros_like(nn))[:, None]
        g1 = de * torch.linalg.cross(v1, n, dim=-1) \
            / torch.sum(v1 * v1, dim=-1, keepdim=True)
        g3 = de * torch.linalg.cross(n, v2, dim=-1) \
            / torch.sum(v2 * v2, dim=-1, keepdim=True)
        return e, (g1, -(g1 + g3), g3)


def _dihedral(p):
    """(phi by the JAX package's convention, the bond and cross vectors
    _dihedral_grad reads) of torsions p = [r_i, r_j, r_k, r_l]."""
    b1 = p[1] - p[0]
    b2 = p[2] - p[1]
    b3 = p[3] - p[2]
    c1 = torch.linalg.cross(b1, b2, dim=-1)
    c2 = torch.linalg.cross(b2, b3, dim=-1)
    nb2 = torch.sqrt(torch.sum(b2 * b2, dim=-1))
    safe_nb2 = torch.where(nb2 > 0, nb2, torch.ones_like(nb2))
    p1 = torch.sum(c1 * c2, dim=-1)
    p2 = torch.sum(torch.linalg.cross(c1, b2 / safe_nb2[:, None], dim=-1)
                   * c2, dim=-1)
    return torch.atan2(p2, p1), (b1, b2, b3, c1, c2, nb2)


def _dihedral_grad(geo):
    """dphi/dr_i, dr_j, dr_k, dr_l of _dihedral's phi (zero where it is
    undefined: |c1|, |c2| or |b2| zero)."""
    b1, b2, b3, c1, c2, nb2 = geo
    m2 = torch.sum(c1 * c1, dim=-1)
    n2 = torch.sum(c2 * c2, dim=-1)
    ok = (m2 > 0) & (n2 > 0) & (nb2 > 0)
    one = torch.ones_like(m2)
    m2s = torch.where(ok, m2, one)
    n2s = torch.where(ok, n2, one)
    nb2s = torch.where(ok, nb2, one)
    zero = torch.zeros_like(m2)
    # the JAX package's phi is minus the IUPAC angle, whose gradient on
    # the outer atoms is -|b2| c1 / |c1|^2 (i) and |b2| c2 / |c2|^2 (l)
    gi = torch.where(ok, nb2s / m2s, zero)[:, None] * c1
    gl = -torch.where(ok, nb2s / n2s, zero)[:, None] * c2
    s1 = (torch.sum(b1 * b2, dim=-1) / (nb2s * nb2s))[:, None]
    s3 = (torch.sum(b3 * b2, dim=-1) / (nb2s * nb2s))[:, None]
    gj = -(1.0 + s1) * gi + s3 * gl
    gk = s1 * gi - (1.0 + s3) * gl
    return gi, gj, gk, gl


class _PeriodicTorsionTerm(_Term):
    def _eval(self, p, with_forces):
        period, phase, k = self.params
        phi, geo = _dihedral(p)
        arg = period * phi - phase
        e = torch.sum(k * (1.0 + torch.cos(arg)))
        if not with_forces:
            return e, None
        de = (-k * period * torch.sin(arg))[:, None]
        return e, tuple(de * g for g in _dihedral_grad(geo))


class _HarmonicTorsionTerm(_Term):
    def _eval(self, p, with_forces):
        theta0, k = self.params
        phi, geo = _dihedral(p)
        d = phi - theta0
        d = d - 2.0 * math.pi * torch.round(d / (2.0 * math.pi))
        e = torch.sum(k * d * d)
        if not with_forces:
            return e, None
        de = (2.0 * k * d)[:, None]
        return e, tuple(de * g for g in _dihedral_grad(geo))


def _compile(rows, n_atoms, term_cls, param_cols, dtype, device):
    """A term over `rows` (tuples: n_atoms indices, then parameters)."""
    if not rows:
        return None
    arr = np.array(rows, np.float64)
    idx = [_index(arr[:, c].astype(np.int64), device)
           for c in range(n_atoms)]
    params = tuple(torch.as_tensor(arr[:, c], dtype=dtype, device=device)
                   for c in param_cols)
    return term_cls(idx, params)


class HarmonicBondForce:
    def __init__(self):
        self._bonds: List[Tuple[int, int, float, float]] = []

    def addBond(self, particle1: int, particle2: int, length: float,
                k: float) -> int:
        self._bonds.append((int(particle1), int(particle2), float(length),
                            float(k)))
        return len(self._bonds) - 1

    def getNumBonds(self) -> int:
        return len(self._bonds)

    def getBondParameters(self, index: int):
        return self._bonds[index]

    def setBondParameters(self, index, particle1, particle2, length, k):
        self._bonds[index] = (int(particle1), int(particle2), float(length),
                              float(k))

    def usesPeriodicBoundaryConditions(self) -> bool:
        return False

    def bonded_pairs(self):
        return [(b[0], b[1]) for b in self._bonds]

    def compile(self, system, dtype, device):
        return _compile(self._bonds, 2, _BondTerm, (2, 3), dtype, device)


class HarmonicAngleForce:
    def __init__(self):
        self._angles: List[Tuple[int, int, int, float, float]] = []

    def addAngle(self, p1: int, p2: int, p3: int, angle: float,
                 k: float) -> int:
        self._angles.append((int(p1), int(p2), int(p3), float(angle),
                             float(k)))
        return len(self._angles) - 1

    def getNumAngles(self) -> int:
        return len(self._angles)

    def getAngleParameters(self, index: int):
        return self._angles[index]

    def usesPeriodicBoundaryConditions(self) -> bool:
        return False

    def bonded_pairs(self):
        out = []
        for a in self._angles:
            out.append((a[0], a[1]))
            out.append((a[1], a[2]))
        return out

    def compile(self, system, dtype, device):
        return _compile(self._angles, 3, _AngleTerm, (3, 4), dtype, device)


class _TorsionBase:
    def __init__(self):
        self._torsions: List[Tuple] = []

    def getNumTorsions(self) -> int:
        return len(self._torsions)

    def getTorsionParameters(self, index: int):
        return self._torsions[index]

    def usesPeriodicBoundaryConditions(self) -> bool:
        return False

    def bonded_pairs(self):
        out = []
        for t in self._torsions:
            out.append((t[0], t[1]))
            out.append((t[1], t[2]))
            out.append((t[2], t[3]))
        return out


class PeriodicTorsionForce(_TorsionBase):
    def addTorsion(self, p1, p2, p3, p4, periodicity, phase, k) -> int:
        self._torsions.append((int(p1), int(p2), int(p3), int(p4),
                               int(periodicity), float(phase), float(k)))
        return len(self._torsions) - 1

    def compile(self, system, dtype, device):
        return _compile(self._torsions, 4, _PeriodicTorsionTerm, (4, 5, 6),
                        dtype, device)


class HarmonicTorsionForce(_TorsionBase):
    """Harmonic (CHARMM-improper-style) torsion: E = k wrap(theta -
    theta0)^2, wrap into (-pi, pi]; k without the 1/2 (the JAX package's
    HarmonicTorsionForce)."""

    def addTorsion(self, p1, p2, p3, p4, theta0, k) -> int:
        self._torsions.append((int(p1), int(p2), int(p3), int(p4),
                               float(theta0), float(k)))
        return len(self._torsions) - 1

    def setTorsionParameters(self, index, p1, p2, p3, p4, theta0, k):
        self._torsions[index] = (int(p1), int(p2), int(p3), int(p4),
                                 float(theta0), float(k))

    def compile(self, system, dtype, device):
        return _compile(self._torsions, 4, _HarmonicTorsionTerm, (4, 5),
                        dtype, device)
