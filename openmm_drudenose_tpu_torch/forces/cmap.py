"""CMAPTorsionForce: CHARMM's correction maps on pairs of dihedrals
(phi, psi), as the JAX package's forces/cmap.py defines them.

On the host, in float64, once: each size x size energy grid becomes
(size^2, 4, 4) bicubic patch coefficients, the knot derivatives from C2
periodic cubic splines (one dense cyclic solve a axis) and the 16
Hermite constraints a cell inverted once through a 16 x 16 monomial
matrix (_map_coefficients, a copy of the JAX package's).  The patches
are C1: corner values and derivatives are shared between cells, so the
force is continuous where an angle lands on a knot.

On the device: the two dihedrals of each torsion, one (T, 4, 4)
coefficient gather and the polynomial p(u, v) = sum c[m, k] u^m v^k in
the cell's unit coordinates.  Energy and forces are float64 from the
compensated positions, as forces/bonded.py computes its terms: the force
is analytic, dE/dphi = dp/du n / (2 pi) times the dihedral gradient of
bonded._dihedral_grad (no autograd through the angle).

Grid convention: point (a, b) of a size-n map is the energy at
(phi, psi) = (-pi + a h, -pi + b h), h = 2 pi / n, stored at
energy[a + n b] (angle1 fastest, CMAPTorsionForce.h's order).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..ops import scatter
from .bonded import _dihedral, _dihedral_grad

_TWO_PI = 2.0 * np.pi


def _periodic_spline_deriv_matrix(n: int, h: float) -> np.ndarray:
    """D with (D @ y) = knot first derivatives of the C2 periodic cubic
    spline through samples y at spacing h (cyclic tridiagonal system
    m[i-1] + 4 m[i] + m[i+1] = 3 (y[i+1] - y[i-1]) / h)."""
    A = np.zeros((n, n))
    B = np.zeros((n, n))
    for i in range(n):
        A[i, (i - 1) % n] += 1.0
        A[i, i] += 4.0
        A[i, (i + 1) % n] += 1.0
        B[i, (i + 1) % n] += 3.0 / h
        B[i, (i - 1) % n] -= 3.0 / h
    return np.linalg.solve(A, B)


def _bicubic_constraint_inverse() -> np.ndarray:
    """Inverse of the 16 x 16 system mapping monomial coefficients c[m,k]
    (p(u,v) = sum c[m,k] u^m v^k) to the Hermite corner data
    [p, p_u, p_v, p_uv] at (u,v) in {0,1}^2 (row order: corner-major
    (00,10,01,11), datum-minor)."""
    M = np.zeros((16, 16))
    for ci, (u, v) in enumerate(((0.0, 0.0), (1.0, 0.0),
                                 (0.0, 1.0), (1.0, 1.0))):
        for m in range(4):
            for k in range(4):
                col = 4 * m + k
                um = u ** m
                vk = v ** k
                dum = m * u ** (m - 1) if m else 0.0
                dvk = k * v ** (k - 1) if k else 0.0
                M[4 * ci + 0, col] = um * vk
                M[4 * ci + 1, col] = dum * vk
                M[4 * ci + 2, col] = um * dvk
                M[4 * ci + 3, col] = dum * dvk
    return np.linalg.inv(M)


def _map_coefficients(energy: np.ndarray) -> np.ndarray:
    """(n, n) periodic energy grid -> (n*n, 4, 4) bicubic patch
    coefficients in UNIT-square coordinates (cell (a, b) covers
    phi in [-pi + a h, -pi + (a+1) h) x psi likewise; flat index
    a * n + b)."""
    n = energy.shape[0]
    h = _TWO_PI / n
    D = _periodic_spline_deriv_matrix(n, h)
    E = energy  # E[a, b]: phi index a (axis 0), psi index b (axis 1)
    Ex = D @ E
    Ey = E @ D.T
    Exy = D @ Ey
    Minv = _bicubic_constraint_inverse()

    a = np.arange(n)
    # corner data scaled to the unit square: d/du = h * d/dphi
    data = np.zeros((n, n, 16))
    corners = ((0, 0), (1, 0), (0, 1), (1, 1))
    for ci, (da, db) in enumerate(corners):
        ia = (a[:, None] + da) % n
        ib = (a[None, :] + db) % n
        data[:, :, 4 * ci + 0] = E[ia, ib]
        data[:, :, 4 * ci + 1] = Ex[ia, ib] * h
        data[:, :, 4 * ci + 2] = Ey[ia, ib] * h
        data[:, :, 4 * ci + 3] = Exy[ia, ib] * h * h
    c = data @ Minv.T  # (n, n, 16), monomial order c[4*m + k]
    return c.reshape(n * n, 4, 4)


class CMAPTorsionForce:
    """Energy-correction maps applied to pairs of dihedrals
    (OpenMM CMAPTorsionForce API surface; CMAPTorsionForce.h)."""

    def __init__(self):
        self._maps: List[Tuple[int, np.ndarray]] = []   # (size, energy flat)
        self._torsions: List[Tuple[int, ...]] = []      # (map, a1..a4, b1..b4)

    # ------------------------------------------------------------ maps
    def addMap(self, size: int, energy) -> int:
        energy = np.asarray(energy, np.float64).reshape(-1)
        if energy.size != size * size:
            raise ValueError(
                f"CMAP map needs size*size={size * size} energies, "
                f"got {energy.size}")
        self._maps.append((int(size), energy.copy()))
        return len(self._maps) - 1

    def getNumMaps(self) -> int:
        return len(self._maps)

    def getMapParameters(self, index: int):
        size, energy = self._maps[index]
        return size, energy.copy()

    def setMapParameters(self, index: int, size: int, energy) -> None:
        energy = np.asarray(energy, np.float64).reshape(-1)
        if energy.size != size * size:
            raise ValueError("energy size mismatch")
        self._maps[index] = (int(size), energy.copy())

    # -------------------------------------------------------- torsions
    def addTorsion(self, map_index: int, a1, a2, a3, a4,
                   b1, b2, b3, b4) -> int:
        self._torsions.append(tuple(int(x) for x in
                                    (map_index, a1, a2, a3, a4,
                                     b1, b2, b3, b4)))
        return len(self._torsions) - 1

    def getNumTorsions(self) -> int:
        return len(self._torsions)

    def getTorsionParameters(self, index: int):
        return self._torsions[index]

    def setTorsionParameters(self, index: int, map_index: int, a1, a2, a3,
                             a4, b1, b2, b3, b4) -> None:
        self._torsions[index] = tuple(int(x) for x in
                                      (map_index, a1, a2, a3, a4,
                                       b1, b2, b3, b4))

    def usesPeriodicBoundaryConditions(self) -> bool:
        return False

    def bonded_pairs(self):
        # the consecutive covalent pairs of each dihedral (these atoms are
        # bonded in any chemically valid deck; reporting them keeps the
        # residue=molecule map identical whether or not the bond force
        # lists them first)
        out = []
        for t in self._torsions:
            a = t[1:5]
            b = t[5:9]
            for quad in (a, b):
                out.extend([(quad[0], quad[1]), (quad[1], quad[2]),
                            (quad[2], quad[3])])
        return out

    # --------------------------------------------------------- compile
    def compile(self, system, dtype, device):
        if not self._torsions or not self._maps:
            return None
        tables, offsets, sizes = [], [], []
        off = 0
        for n, energy in self._maps:
            # energy[a + n*b] -> E[a, b] (angle1 index fastest)
            tables.append(_map_coefficients(energy.reshape(n, n, order="F")))
            offsets.append(off)
            sizes.append(n)
            off += n * n
        tor = np.array(self._torsions, np.int64)
        m = tor[:, 0]
        t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)
        return CMAPTerm(
            table=t(np.concatenate(tables, axis=0), torch.float64),
            off=t(np.array([offsets[i] for i in m], np.int64)),
            n=t(np.array([sizes[i] for i in m], np.int64)),
            a=[t(tor[:, 1 + k]) for k in range(4)],
            b=[t(tor[:, 5 + k]) for k in range(4)])


class CMAPTerm:
    """Compiled CMAPTorsionForce: energy_forces(positions, box=None,
    pos_err=None, with_forces=True, exact=None), evaluated in float64
    from `exact` where given (else from the positions, in float64)."""

    takes_exact = True

    def __init__(self, table, off, n, a, b):
        self.table, self.off, self.n = table, off, n
        self.a, self.b = a, b

    def energy_forces(self, positions, box=None, pos_err=None,
                      with_forces=True, exact=None):
        src = (positions if exact is None else exact).double()
        phi, geo_a = _dihedral([src[i] for i in self.a])
        psi, geo_b = _dihedral([src[i] for i in self.b])
        nf = self.n.double()
        # local grid coordinates; phi = +pi wraps to cell 0 at u = 0
        t_u = (phi + np.pi) / _TWO_PI * nf
        t_v = (psi + np.pi) / _TWO_PI * nf
        iu = torch.floor(t_u)
        iv = torch.floor(t_v)
        u = t_u - iu
        v = t_v - iv
        ix = torch.remainder(iu.long(), self.n)
        iy = torch.remainder(iv.long(), self.n)
        c = self.table[self.off + ix * self.n + iy]       # (T, 4, 4)
        one = torch.ones_like(u)
        zero = torch.zeros_like(u)
        um = torch.stack([one, u, u * u, u * u * u], dim=-1)
        vk = torch.stack([one, v, v * v, v * v * v], dim=-1)
        e = torch.sum(c * um[:, :, None] * vk[:, None, :])
        e_out = e.to(positions.dtype)
        if not with_forces:
            return e_out, None
        dum = torch.stack([zero, one, 2.0 * u, 3.0 * u * u], dim=-1)
        dvk = torch.stack([zero, one, 2.0 * v, 3.0 * v * v], dim=-1)
        scale = nf / _TWO_PI
        de_phi = torch.sum(c * dum[:, :, None] * vk[:, None, :],
                           dim=(1, 2)) * scale
        de_psi = torch.sum(c * um[:, :, None] * dvk[:, None, :],
                           dim=(1, 2)) * scale
        forces = torch.zeros_like(positions)
        for idx, geo, de in ((self.a, geo_a, de_phi),
                             (self.b, geo_b, de_psi)):
            for i, g in zip(idx, _dihedral_grad(geo)):
                scatter.index_add_(forces, i,
                                   (-de[:, None] * g).to(positions.dtype))
        return e_out, forces
