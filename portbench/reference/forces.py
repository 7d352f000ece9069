"""Forces of R independent replicas of a SWM4-NDP box, in plain PyTorch.

Positions are (R, n0, 3), each replica in its own cubic box of edge L
(the same for all).  The total force is

  Ewald direct space  k_e q_i q_j erfc(alpha r) / r and LJ 4 eps
                      ((s/r)^12 - (s/r)^6), Lorentz-Berthelot, for pairs
                      of different molecules with r < r_c (minimum
                      image), found on the reference's own cell list;
  smooth PME          (Essmann et al., J. Chem. Phys. 103, 8577 (1995)):
                      order-n cardinal B-splines, the moduli |b(m)|^2
                      (a zero of the denominator takes the mean of its
                      neighbours), E = k_e / (2 pi V) sum_{m != 0}
                      exp(-pi^2 m^2 / alpha^2) / m^2 |b(m)|^2 |S(m)|^2;
  exclusion correction  -k_e q_i q_j erf(alpha r) / r for every pair of
                      one molecule;
  Drude springs       k d^2 / 2 between each core and its Drude;
  the M site          placed at w_O O + w_H (H1 + H2), its force spread
                      onto O, H1 and H2 by the same weights.

alpha = sqrt(-ln(2 tol)) / r_c (OpenMM's rule).  The dispersion tail
correction moves no force.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from .precision import F64, Arith

ONE_4PI_EPS0 = 138.935456   # kJ nm / (mol e^2), OpenMM's value
# pair slots a block of the direct-space loop holds (bounds its memory)
PAIR_BLOCK = 1 << 23


def ewald_alpha(cutoff: float, tol: float) -> float:
    return math.sqrt(-math.log(2.0 * tol)) / cutoff


class Field:
    """The reference's force field for one Water, device and arithmetic.
    Built from the configuration alone."""

    def __init__(self, water, cfg: dict, device, arith: Arith = F64):
        self.w = water
        self.arith = arith
        self.device = torch.device(device)
        self.cutoff = float(cfg["cutoff_nm"])
        self.alpha = ewald_alpha(self.cutoff, float(cfg["ewald_tolerance"]))
        self.order = int(cfg["pme_order"])
        self.grid = tuple(int(k) for k in cfg["pme_grid"])
        dt = arith.dtype
        t = lambda x: torch.as_tensor(water.per_atom(x), dtype=dt,
                                      device=self.device)
        self.q = t(water.charge)
        self.sig = t(water.sigma)
        self.eps = t(water.epsilon)
        self.mol = torch.arange(water.n0, device=self.device) // 5
        self.L = float(water.box)
        self.bm2 = self._moduli()

    def at_box(self, box) -> "Field":
        """This field in the (3, 3) box `box` (rows are box vectors), as a
        barostat leaves it; the box has to be cubic."""
        b = np.asarray(box, np.float64)
        edge = float(b[0, 0])
        if np.any(b != np.diag([edge] * 3)):
            raise ValueError(f"the reference takes a cubic box, not {b}")
        f = copy.copy(self)
        f.L = edge
        return f

    # -- sites -------------------------------------------------------------
    def place_m(self, x):
        """x with each molecule's M site placed from its O and H's."""
        w = self.w
        x = x.clone()
        v = x.view(x.shape[0], w.n_mol, 5, 3)
        o, h1, h2, m = (w.site(s) for s in ("O", "H1", "H2", "M"))
        _, wh1, wh2 = w.w_m
        v[:, :, m] = (v[:, :, o] + wh1 * (v[:, :, h1] - v[:, :, o])
                      + wh2 * (v[:, :, h2] - v[:, :, o]))
        return x

    def spread_m(self, f):
        w = self.w
        f = f.clone()
        v = f.view(f.shape[0], w.n_mol, 5, 3)
        o, h1, h2, m = (w.site(s) for s in ("O", "H1", "H2", "M"))
        fm = v[:, :, m].clone()
        v[:, :, o] += w.w_m[0] * fm
        v[:, :, h1] += w.w_m[1] * fm
        v[:, :, h2] += w.w_m[2] * fm
        v[:, :, m] = 0.0
        return f

    # -- direct space ------------------------------------------------------
    def _cells(self, x):
        """(table (R * ncell, C) of flat atom indices, -1 padded; each
        atom's cell; the cells of each offset) of a cubic cell grid of
        edge >= r_c, or one cell where fewer than 3 fit."""
        R, n0, _ = x.shape
        nc = int(self.L // self.cutoff)
        if nc < 3:
            nc = 1
        frac = x / self.L
        frac = frac - torch.floor(frac)
        c3 = torch.clamp((frac * nc).long(), max=nc - 1)
        cid = (c3[..., 0] * nc + c3[..., 1]) * nc + c3[..., 2]
        ncell = nc ** 3
        gc = (cid + ncell * torch.arange(R, device=x.device)[:, None]
              ).reshape(-1)
        order = torch.argsort(gc, stable=True)
        counts = torch.bincount(gc, minlength=R * ncell)
        start = torch.cumsum(counts, 0) - counts
        C = int(counts.max())
        slot = torch.arange(R * n0, device=x.device) - start[gc[order]]
        table = torch.full((R * ncell, C), -1, dtype=torch.long,
                           device=x.device)
        table[gc[order], slot] = order
        offs = [0] if nc == 1 else [-1, 0, 1]
        cz = torch.arange(ncell, device=x.device)
        cxyz = torch.stack([cz // (nc * nc), (cz // nc) % nc, cz % nc], 1)
        nbrs = []
        for ox in offs:
            for oy in offs:
                for oz in offs:
                    o = torch.tensor([ox, oy, oz], device=x.device)
                    n3 = torch.remainder(cxyz + o, nc)
                    nbrs.append((n3[:, 0] * nc + n3[:, 1]) * nc + n3[:, 2])
        return table, gc, ncell, nbrs

    def _pair_blocks(self, x):
        """Yields (i, j, d) blocks: flat atoms i (B,), their candidate
        partners j (B, C) (-1 padded) in one neighbour cell, and the
        minimum-image displacements x_i - x_j (B, C, 3)."""
        R, n0, _ = x.shape
        flat = x.reshape(-1, 3)
        table, gc, ncell, nbrs = self._cells(x)
        C = table.shape[1]
        rep = gc // ncell
        cell = gc % ncell
        block = max(PAIR_BLOCK // C, 1)
        L = self.L
        for nbr in nbrs:
            for s in range(0, R * n0, block):
                i = torch.arange(s, min(s + block, R * n0), device=x.device)
                j = table[rep[i] * ncell + nbr[cell[i]]]
                xj = flat[j.clamp(min=0)]
                d = flat[i][:, None, :] - xj
                d = self.arith.product(d - L * torch.round(d / L))
                yield i, j, d

    def pair_count(self, x) -> int:
        """Pairs of sites of different molecules within r_c (each once)."""
        rc2 = self.cutoff ** 2
        n = 0
        for i, j, d in self._pair_blocks(x):
            r2 = torch.sum(d * d, dim=-1)
            ok = (j >= 0) & (r2 < rc2) & (self.mol[j.clamp(min=0)
                                                    % self.w.n0]
                                           != self.mol[i % self.w.n0][:, None])
            n += int(ok.sum())
        return n // 2

    def direct(self, x):
        """Ewald direct space and LJ forces (R, n0, 3)."""
        R, n0, _ = x.shape
        dt = self.arith.dtype
        out = torch.zeros((R * n0, 3), dtype=dt, device=x.device)
        rc2 = self.cutoff ** 2
        a = self.alpha
        two_a_pi = 2.0 * a / math.sqrt(math.pi)
        for i, j, d in self._pair_blocks(x):
            i0 = i % n0
            j0 = j.clamp(min=0) % n0
            r2 = torch.sum(d * d, dim=-1)
            ok = (j >= 0) & (r2 < rc2) & (self.mol[j0] != self.mol[i0][:, None])
            r2 = torch.where(ok, r2, torch.ones_like(r2))
            r = torch.sqrt(r2)
            inv_r2 = 1.0 / r2
            qq = ONE_4PI_EPS0 * self.q[i0][:, None] * self.q[j0]
            fc = qq * (torch.special.erfc(a * r) / r
                       + two_a_pi * torch.exp(-a * a * r2)) * inv_r2
            sig = 0.5 * (self.sig[i0][:, None] + self.sig[j0])
            eps = torch.sqrt(self.eps[i0][:, None] * self.eps[j0])
            s6 = (sig * sig * inv_r2) ** 3
            flj = 24.0 * eps * (2.0 * s6 * s6 - s6) * inv_r2
            fs = torch.where(ok, fc + flj, torch.zeros_like(r2))
            out.index_add_(0, i, torch.sum(fs[..., None] * d, dim=1))
        return out.reshape(R, n0, 3)

    # -- exclusions and springs --------------------------------------------
    def exclusions_and_springs(self, x):
        """The erf correction of every intra-molecular pair and the Drude
        springs: forces (R, n0, 3)."""
        w = self.w
        R = x.shape[0]
        v = x.view(R, w.n_mol, 5, 3)
        f = torch.zeros_like(v)
        a = self.alpha
        two_a_pi = 2.0 * a / math.sqrt(math.pi)
        q = torch.as_tensor(w.charge, dtype=x.dtype, device=x.device)
        for s in range(5):
            for t in range(s):
                d = v[:, :, s] - v[:, :, t]
                r2 = torch.sum(d * d, dim=-1)
                r = torch.sqrt(r2)
                small = r < 1e-4
                rs = torch.where(small, torch.ones_like(r), r)
                # F_s = k_e q q [2a/sqrt(pi) exp(-a^2 r^2) / r
                #                - erf(a r) / r^2] d / r
                g = (two_a_pi * torch.exp(-a * a * rs * rs) / rs
                     - torch.special.erf(a * rs) / (rs * rs)) / rs
                # its series at small r: -(4 a^3 / (3 sqrt(pi))) (1 - 3/5 a^2 r^2)
                g0 = -(2.0 / 3.0) * a * a * two_a_pi * (
                    1.0 - 0.6 * a * a * r2)
                g = torch.where(small, g0, g) * (ONE_4PI_EPS0 * q[s] * q[t])
                fs = g[..., None] * d
                f[:, :, s] += fs
                f[:, :, t] -= fs
        o, dd = w.site("O"), w.site("D")
        d = v[:, :, dd] - v[:, :, o]
        f[:, :, dd] -= w.k_drude * d
        f[:, :, o] += w.k_drude * d
        return f.reshape(x.shape)

    # -- reciprocal space --------------------------------------------------
    @staticmethod
    def _bspline(n: int, x):
        """M_n(x), the cardinal B-spline of order n."""
        if n == 2:
            return torch.clamp(1.0 - torch.abs(x - 1.0), min=0.0)
        return (x * Field._bspline(n - 1, x)
                + (n - x) * Field._bspline(n - 1, x - 1.0)) / (n - 1)

    def _moduli(self):
        """|b(m)|^2 of each axis as float64 on the device."""
        n = self.order
        out = []
        for K in self.grid:
            k = torch.arange(n - 1, dtype=torch.float64)
            mk = self._bspline(n, k + 1.0)
            m = torch.arange(K, dtype=torch.float64)
            ph = 2.0 * math.pi * m[:, None] * k[None, :] / K
            re = torch.sum(mk * torch.cos(ph), dim=1)
            im = torch.sum(mk * torch.sin(ph), dim=1)
            den = re * re + im * im
            bad = den < 1e-14
            b = torch.where(bad, torch.zeros_like(den),
                            1.0 / torch.where(bad, torch.ones_like(den), den))
            for i in torch.nonzero(bad).flatten().tolist():
                b[i] = 0.5 * (b[(i - 1) % K] + b[(i + 1) % K])
            out.append(b.to(self.device))
        return out

    def _taps(self, x):
        """Per axis: grid indices (N, n), weights and their derivatives
        M_n(w + j), dM_n/du, j = 0..n-1, for the grid point floor(u) - j."""
        n = self.order
        idx, th, dth = [], [], []
        j = torch.arange(n, device=x.device, dtype=x.dtype)
        for d, K in enumerate(self.grid):
            frac = x[:, d] / self.L
            u = (frac - torch.floor(frac)) * K
            t = torch.floor(u)
            w = (u - t)[:, None] + j
            idx.append(torch.remainder(t.long()[:, None]
                                       - j.long(), K))
            th.append(self._bspline(n, w))
            dth.append(self._bspline(n - 1, w) - self._bspline(n - 1, w - 1.0))
        return idx, th, dth

    def reciprocal(self, x, energy: bool = False):
        """PME forces (R, n0, 3) (and the energy of each replica)."""
        R, n0, _ = x.shape
        K1, K2, K3 = self.grid
        n = self.order
        dt = self.arith.dtype
        pr = self.arith.product
        flat = x.reshape(-1, 3)
        N = R * n0
        rep = torch.arange(N, device=x.device) // n0
        q = pr(self.q.repeat(R))
        Q = torch.zeros(R * K1 * K2 * K3, dtype=dt, device=x.device)
        block = max(PAIR_BLOCK // (n ** 3), 1)
        for s in range(0, N, block):
            sl = slice(s, min(s + block, N))
            (ix, iy, iz), (tx, ty, tz), _ = self._taps(flat[sl])
            tx, ty, tz = pr(tx), pr(ty), pr(tz)
            val = (q[sl][:, None, None, None] * tx[:, :, None, None]
                   * ty[:, None, :, None] * tz[:, None, None, :])
            gi = (((rep[sl][:, None, None, None] * K1 + ix[:, :, None, None])
                   * K2 + iy[:, None, :, None]) * K3 + iz[:, None, None, :])
            Q.index_add_(0, gi.reshape(-1), val.reshape(-1))
        Q = Q.reshape(R, K1, K2, K3)
        S = torch.fft.fftn(Q, dim=(1, 2, 3))
        f64 = dict(dtype=torch.float64, device=x.device)
        m1 = torch.fft.fftfreq(K1, d=1.0 / K1, **f64) / self.L
        m2 = torch.fft.fftfreq(K2, d=1.0 / K2, **f64) / self.L
        m3 = torch.fft.fftfreq(K3, d=1.0 / K3, **f64) / self.L
        msq = (m1[:, None, None] ** 2 + m2[None, :, None] ** 2
               + m3[None, None, :] ** 2)
        b = (self.bm2[0][:, None, None] * self.bm2[1][None, :, None]
             * self.bm2[2][None, None, :])
        safe = torch.where(msq > 0, msq, torch.ones_like(msq))
        vol = self.L ** 3
        G = torch.where(msq > 0, torch.exp(-math.pi ** 2 * safe
                                           / self.alpha ** 2) / safe * b,
                        torch.zeros_like(msq))
        G = (ONE_4PI_EPS0 / (math.pi * vol) * G).to(dt)
        phi = torch.fft.ifftn(G * S, dim=(1, 2, 3)).real * (K1 * K2 * K3)
        phi = phi.reshape(-1)
        out = torch.zeros((N, 3), dtype=dt, device=x.device)
        for s in range(0, N, block):
            sl = slice(s, min(s + block, N))
            (ix, iy, iz), (tx, ty, tz), (dx, dy, dz) = self._taps(flat[sl])
            tx, ty, tz = pr(tx), pr(ty), pr(tz)
            dx, dy, dz = pr(dx), pr(dy), pr(dz)
            gi = (((rep[sl][:, None, None, None] * K1 + ix[:, :, None, None])
                   * K2 + iy[:, None, :, None]) * K3 + iz[:, None, None, :])
            p = phi[gi]
            gx = torch.sum(p * dx[:, :, None, None] * ty[:, None, :, None]
                           * tz[:, None, None, :], dim=(1, 2, 3)) * (K1 / self.L)
            gy = torch.sum(p * tx[:, :, None, None] * dy[:, None, :, None]
                           * tz[:, None, None, :], dim=(1, 2, 3)) * (K2 / self.L)
            gz = torch.sum(p * tx[:, :, None, None] * ty[:, None, :, None]
                           * dz[:, None, None, :], dim=(1, 2, 3)) * (K3 / self.L)
            out[sl] = -q[sl][:, None] * torch.stack([gx, gy, gz], 1)
        out = out.reshape(R, n0, 3)
        if not energy:
            return out
        e = 0.5 * torch.sum(Q.reshape(R, -1) * phi.reshape(R, -1), dim=1)
        return out, e

    # -- total -------------------------------------------------------------
    def forces(self, x):
        """Total forces at positions x (R, n0, 3) whose M rows are placed
        here; the M rows of the result are zero."""
        x = self.place_m(x.to(self.arith.dtype))
        f = (self.direct(x) + self.reciprocal(x)
             + self.exclusions_and_springs(x))
        return self.spread_m(f)
