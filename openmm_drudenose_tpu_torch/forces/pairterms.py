"""Static pair-list energy terms with analytic forces.

OpenMM exceptions and the Ewald/PME reciprocal-space exclusion corrections
are O(n_pairs) terms over index lists fixed at compile time.  Each pair
function eg(r2_safe, r2_raw) -> (e, g = dE/dr^2) gives the energy and,
through f_i = -2 g delta = -f_j, the forces, which are summed per atom
with ops/scatter.py::index_add_.  The same math as the JAX package's
forces/pairterms.py (exception_eg, ewald_correction_eg, lj_override_eg),
but the correction's force takes a series at small r, where the closed
form loses float32 precision.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import scatter
from .boxutils import min_image
from .cellpair import switch


def make_pair_list_term(i_idx, j_idx, eg_fn, device, periodic: bool = True):
    """term(positions, box, exact=None, with_forces=True, scale=None,
    n_replicas=0) -> (energy, forces (N, 3), None without with_forces);
    `box` is the (3,) diagonal or the (3, 3) triclinic matrix
    (boxutils.mi_box); `exact` (float64 positions) gives the
    displacements, rounded once.  scale ((N,) float64, flat-ensemble
    NPT): each pair is minimum-imaged in its replica's box, the diagonal
    times its first atom's scale.  n_replicas = R > 0: the energy as
    (R,) per-replica sums (the pairs replica-major, P / R a replica; no
    forces)."""
    ii = torch.as_tensor(np.asarray(i_idx, np.int64), device=device)
    jj = torch.as_tensor(np.asarray(j_idx, np.int64), device=device)

    def term(positions, box, exact=None, with_forces=True, scale=None,
             n_replicas=0):
        def image(delta):
            if not periodic:
                return delta
            if scale is None:
                return min_image(delta, box.to(delta.dtype))
            # (P, 3) orthorhombic replica boxes
            pbox = (box.double()[None, :] * scale[ii][:, None]).to(
                delta.dtype)
            return delta - pbox * torch.round(delta / pbox)

        if exact is None:
            delta = image(positions[ii] - positions[jj])
        else:
            delta = image(exact[ii] - exact[jj]).to(positions.dtype)
        r2 = torch.sum(delta * delta, dim=-1)
        r2s = torch.clamp(r2, min=1e-10)
        e, g = eg_fn(r2s, r2)
        if n_replicas:
            return torch.sum(e.reshape(n_replicas, -1), dim=1), None
        if not with_forces:
            return torch.sum(e), None
        fpair = (-2.0 * g)[:, None] * delta           # force on i; -f on j
        forces = torch.zeros_like(positions)
        scatter.index_add_(forces, ii, fpair)
        scatter.index_add_(forces, jj, -fpair)
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


def lj_override_eg(sig_new, eps_new, sig_old, eps_old, cutoff: float,
                   r_switch=None):
    """NBFIX correction: LJ(new parameters) - LJ(combination-rule
    parameters) inside the cutoff, zero beyond it, switched from r_switch
    (None: no switch) as the main sum is (the JAX package's
    lj_override_eg, forces/pairterms.py:229-260 there), so the override
    replaces the combined interaction that the main sum holds."""
    def lj(sig, eps, inv_r2):
        x6 = (sig * sig * inv_r2) ** 3
        return (4.0 * eps * x6 * (x6 - 1.0),
                -4.0 * eps * (6.0 * x6 * x6 - 3.0 * x6) * inv_r2)

    def eg(r2s, r2):
        inv_r = torch.rsqrt(r2s)
        inv_r2 = inv_r * inv_r
        e_n, g_n = lj(sig_new, eps_new, inv_r2)
        e_o, g_o = lj(sig_old, eps_old, inv_r2)
        e, g = e_n - e_o, g_n - g_o
        if r_switch is not None:
            s, ds = switch(r2s, inv_r, r_switch, cutoff)
            g = g * s + e * ds
            e = e * s
        inside = r2 < cutoff * cutoff
        zero = torch.zeros_like(e)
        return torch.where(inside, e, zero), torch.where(inside, g, zero)

    return eg


# x = alpha r below which the correction's force takes the series: the
# closed form subtracts two nearly equal terms there (float32 keeps
# ~eps / x^2 of it), and a core-Drude pair a fraction of a picometre
# apart loses every float32 digit
SERIES_X = 0.5
# N(x) / x^3 = (2 / sqrt(pi)) sum_n c_n x^(2n-2) with
# N(x) = erf(x) - (2x / sqrt(pi)) exp(-x^2) and
# c_n = (-1)^(n+1) 2n / ((2n + 1) n!); thirteen terms leave < 1e-17 of
# it at x <= SERIES_X
_SERIES_C = tuple((-1) ** (n + 1) * 2 * n / ((2 * n + 1) * math.factorial(n))
                  for n in range(1, 14))


def ewald_correction_eg(qq, alpha: float):
    """Reciprocal-space exclusion correction -qq erf(ar)/r (qq pre-scaled
    by ONE_4PI_EPS0); r -> 0 limit -qq 2a/sqrt(pi), zero force.

    dE/dr^2 = qq N(ar) / (2 r^3) with N(x) = erf(x) - (2x/sqrt(pi))
    exp(-x^2).  Below x = SERIES_X it comes from the series of N(x)/x^3
    (the JAX package's closed form cancels there: in float32 its error
    grows as 1/r as a Drude closes on its core); above, from the closed
    form."""
    two_over_sqrt_pi = 2.0 / math.sqrt(math.pi)

    def eg(r2s, r2):
        near0 = r2 < 1e-10
        inv_r = torch.rsqrt(r2s)
        r = r2s * inv_r
        ar = alpha * r
        erf_ar = torch.special.erf(ar)
        e = -qq * torch.where(near0, two_over_sqrt_pi * alpha,
                              erf_ar * inv_r)
        dedr = -qq * (two_over_sqrt_pi * alpha * torch.exp(-ar * ar)
                      - erf_ar * inv_r) * inv_r
        x2 = ar * ar
        series = torch.full_like(x2, _SERIES_C[-1])
        for c in _SERIES_C[-2::-1]:
            series = series * x2 + c
        g_series = (0.5 * two_over_sqrt_pi * alpha ** 3) * qq * series
        g = torch.where(ar < SERIES_X, g_series, 0.5 * dedr * inv_r)
        g = torch.where(near0, torch.zeros_like(g), g)
        return e, g

    return eg
