"""Static pair-list energy terms with analytic forces.

OpenMM exceptions and the Ewald/PME reciprocal-space exclusion corrections
are O(n_pairs) terms over index lists fixed at compile time.  Each pair
function eg(r2_safe, r2_raw) -> (e, g = dE/dr^2) gives the energy and,
through f_i = -2 g delta = -f_j, the forces, which are summed per atom
with index_add_.  The same math as the JAX package's forces/pairterms.py
(exception_eg, ewald_correction_eg).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def min_image(delta, box_diag):
    """Orthorhombic minimum image of (P, 3) displacements."""
    return delta - box_diag * torch.round(delta / box_diag)


def make_pair_list_term(i_idx, j_idx, eg_fn, device, periodic: bool = True):
    """term(positions, box_diag) -> (energy, forces (N, 3))."""
    ii = torch.as_tensor(np.asarray(i_idx, np.int64), device=device)
    jj = torch.as_tensor(np.asarray(j_idx, np.int64), device=device)

    def term(positions, box_diag):
        delta = positions[ii] - positions[jj]
        if periodic:
            delta = min_image(delta, box_diag)
        r2 = torch.sum(delta * delta, dim=-1)
        r2s = torch.clamp(r2, min=1e-10)
        e, g = eg_fn(r2s, r2)
        fpair = (-2.0 * g)[:, None] * delta           # force on i; -f on j
        forces = torch.zeros_like(positions)
        forces.index_add_(0, ii, fpair)
        forces.index_add_(0, jj, -fpair)
        return torch.sum(e), forces

    return term


def exception_eg(qq, sigma, eps):
    """OpenMM exception pair: LJ + plain Coulomb (qq pre-scaled by
    ONE_4PI_EPS0)."""

    def eg(r2s, r2):
        inv_r = torch.rsqrt(r2s)
        inv_r2 = inv_r * inv_r
        x6 = (sigma * sigma * inv_r2) ** 3
        e_lj = 4.0 * eps * x6 * (x6 - 1.0)
        g_lj = -4.0 * eps * (6.0 * x6 * x6 - 3.0 * x6) * inv_r2
        e_c = qq * inv_r
        g_c = -0.5 * qq * inv_r2 * inv_r
        return e_lj + e_c, g_lj + g_c

    return eg


def ewald_correction_eg(qq, alpha: float):
    """Reciprocal-space exclusion correction -qq erf(ar)/r (qq pre-scaled
    by ONE_4PI_EPS0); r -> 0 limit -qq 2a/sqrt(pi), zero force."""
    two_over_sqrt_pi = 2.0 / math.sqrt(math.pi)

    def eg(r2s, r2):
        near0 = r2 < 1e-10
        inv_r = torch.rsqrt(r2s)
        inv_r2 = inv_r * inv_r
        r = r2s * inv_r
        ar = alpha * r
        erf_ar = torch.special.erf(ar)
        e = -qq * torch.where(near0, two_over_sqrt_pi * alpha,
                              erf_ar * inv_r)
        dedr = -qq * (two_over_sqrt_pi * alpha * torch.exp(-ar * ar)
                      - erf_ar * inv_r) * inv_r
        g = torch.where(near0, torch.zeros_like(dedr), 0.5 * dedr * inv_r)
        return e, g

    return eg
