"""Smooth particle-mesh Ewald reciprocal space (Essmann et al. 1995).

Cardinal B-splines of order 5, a scatter-add charge spread (ops/scatter.py),
the reciprocal energy over the rfftn half spectrum, and analytic
interpolation forces
    F_d[i] = -q_i (K_d / L_d) sum_taps dM_d M_e M_f Phi[tap],
with Phi = dE/dQ from one irfftn.  B-spline derivatives are analytic
(dM_n(x) = M_{n-1}(x) - M_{n-1}(x-1)); nothing differentiates through the
Cox-de Boor |x| kinks, which f32 rounding can land exactly on.

Parameter choice and energy follow the JAX package's forces/pme.py
(setup_pme :191, grid_energy :844, recip_forces :159).  A `box` is the
(3,) diagonal or the (3, 3) reduced triclinic matrix
(forces/boxutils.py): the taps read fractional coordinates, the
reciprocal vectors are m* = m1 a* + m2 b* + m3 c* from the inverse box
(pme.py:859-870 there), the volume is the determinant, and the forces
go back through the inverse box, F_k = -q sum_d K_d inv[k, d] dE/du_d.

A flattened replica ensemble (`n_replicas` = R > 1: R replicas of n0
atoms, replica-major, overlapping in one box) takes R reciprocal sums in
one pass, in place of the JAX package's jax.vmap of its generic sum
(forces/nonbonded.py:653-690 there): one int64 fixed-point spread into
an (R K1 K2 K3) grid, each atom's taps offset by its replica's K1 K2 K3,
one batched rfftn / irfftn over the last three axes, and batched tap
gathers.  Each replica's grid is bounded by its own sum |q|.

Per-replica box scales (flat-ensemble NPT: replica r's box is the
template box times s_r; the JAX package's per-replica boxes,
forces/pme.py:754-755, :784-787 there): a replica's fractional
coordinates at box template * s_r are those of p / s_r in the template
box, so the taps, the spread, the FFTs and the gathers run on the stored
coordinates as they stand.  Only three things change per replica: the
reciprocal vectors m / s_r in the eterm (`scaled_eterm`, built once per
set of scales in float64), the volume V0 s_r^3 in the prefactor, and
the gathered forces times 1 / s_r.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import numpy as np
import torch

from ..ops import scatter
from ..units import ONE_4PI_EPS0
from ..utils import tables
from . import boxutils, cellpair

PME_ORDER = 5


def find_fft_dimension(minimum: int) -> int:
    """Smallest 2,3,5-smooth integer >= minimum."""
    n = max(int(minimum), 5)
    while True:
        m = n
        for f in (2, 3, 5):
            while m % f == 0:
                m //= f
        if m == 1:
            return n
        n += 1


def choose_alpha(cutoff: float, tol: float) -> float:
    return math.sqrt(-math.log(2.0 * tol)) / cutoff


def choose_grid(alpha: float, box_diag, tol: float):
    return tuple(find_fft_dimension(
        int(math.ceil(2.0 * alpha * L / (3.0 * tol ** 0.2))))
        for L in box_diag)


def _Mn_np(n: int, x: np.ndarray) -> np.ndarray:
    if n == 2:
        return np.clip(1.0 - np.abs(x - 1.0), 0.0, None)
    return (x * _Mn_np(n - 1, x) + (n - x) * _Mn_np(n - 1, x - 1.0)) / (n - 1)


def bspline_moduli(order: int, K: int) -> np.ndarray:
    """|b(m)|^2 of the Euler exponential spline; zeros of the denominator
    are interpolated from their neighbours, as OpenMM does."""
    knots = _Mn_np(order, np.arange(1, order, dtype=np.float64))
    m = np.arange(K)
    k = np.arange(order - 1)
    denom = np.sum(knots[None, :] * np.exp(
        2j * np.pi * m[:, None] * k[None, :] / K), axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        bm2 = 1.0 / np.abs(denom) ** 2
    bad = ~np.isfinite(bm2) | (np.abs(denom) < 1e-7)
    for i in np.nonzero(bad)[0]:
        bm2[i] = 0.5 * (bm2[(i - 1) % K] + bm2[(i + 1) % K])
    return bm2


def pencil_gate(grid, cell_grid, order: int = PME_ORDER) -> bool:
    """The JAX package's decision for its packed pencil spread
    (forces/pme.py::_pencil_plan there, and the locality gate of
    forces/nonbonded.py:531-557): the grid divides into the cell grid in
    x and y and each pencil's (x, y) window, ppc + 2 order points wide
    rounded up to a multiple of ppc, covers at most a quarter of the
    (x, y) grid plane.  The port records it and always takes the generic
    spread (the packed one carries fault C3 of ROADMAP.md)."""
    if cell_grid is None:
        return False
    lw = []
    for K, g in zip(grid[:2], cell_grid[:2]):
        if K % g:
            return False
        ppc = K // g
        w = -(-(ppc + 2 * order) // ppc) * ppc
        if w >= K:
            return False
        lw.append(w)
    return lw[0] * lw[1] * 4 <= grid[0] * grid[1]


def _M(n, x):
    if n == 2:
        return torch.clamp(1.0 - torch.abs(x - 1.0), min=0.0)
    return (x * _M(n - 1, x) + (n - x) * _M(n - 1, x - 1.0)) / (n - 1)


def bspline_weights(w, order: int = PME_ORDER):
    """M_order(w + j), j = 0..order-1, for w in [0, 1): shape w + (order,)."""
    x = w[..., None] + torch.arange(order, dtype=w.dtype, device=w.device)
    return _M(order, x)


def bspline_weights_d(w, order: int = PME_ORDER):
    """dM_order/du at the taps: M_{order-1}(x) - M_{order-1}(x - 1)."""
    x = w[..., None] + torch.arange(order, dtype=w.dtype, device=w.device)
    return _M(order - 1, x) - _M(order - 1, x - 1.0)


@dataclasses.dataclass(frozen=True, eq=False)
class PmeSetup:
    alpha: float
    grid: tuple
    bm2x: np.ndarray
    bm2y: np.ndarray
    bm2z: np.ndarray


def setup_pme(cutoff: float, tol: float, box_diag, alpha=None, grid=None,
              cell_grid=None, device=None, dtype=None) -> PmeSetup:
    """alpha and grid as OpenMM chooses them; with `cell_grid` each K is
    rounded up to a multiple of the cell grid, as the JAX package plans
    it for the cell-pair strategy (a denser grid is only more accurate).
    With `device` (and `dtype`, the grid's type) the B-spline moduli
    product and the grid size are placed there now (`moduli_product`,
    `grid_size`), so that no pass copies them from the host."""
    a = alpha if alpha else choose_alpha(cutoff, tol)
    g = tuple(int(k) for k in (grid if grid else
                               choose_grid(a, box_diag, tol)))
    if cell_grid is not None:
        g = tuple(-(-k // c) * c for k, c in zip(g, cell_grid))
    setup = PmeSetup(alpha=a, grid=g,
                     bm2x=bspline_moduli(PME_ORDER, g[0]),
                     bm2y=bspline_moduli(PME_ORDER, g[1]),
                     bm2z=bspline_moduli(PME_ORDER, g[2]))
    if device is not None:
        for dt in {dtype or torch.float64, torch.float64}:
            moduli_product(setup, dt, device)
            grid_size(setup, dt, device)
    return setup


def moduli_product(setup: PmeSetup, dtype, device) -> torch.Tensor:
    """(K1, K2, K3 // 2 + 1) |b(m)|^2 = bm2x bm2y bm2z on the rfft half
    grid, each factor rounded to `dtype` and the product formed in it;
    made once per setup, dtype and device (utils/tables.py)."""
    def build():
        K3h = setup.grid[2] // 2 + 1
        bx, by, bz = (torch.as_tensor(b, dtype=dtype) for b in (
            setup.bm2x, setup.bm2y, setup.bm2z[:K3h]))
        return bx[:, None, None] * by[None, :, None] * bz[None, None, :]
    return tables.table(setup, "bm2", build, device, dtype)


def grid_size(setup: PmeSetup, dtype, device) -> torch.Tensor:
    """(3,) (K1, K2, K3) in `dtype` on `device`, made once."""
    return tables.table(setup, "grid", lambda: setup.grid, device, dtype)


# the last few eterms of each setup, with the box each was made at
_eterms: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _eterm(setup: PmeSetup, box, dtype, device):
    """_eterm_at, made once per box value: a pass at the box of one of
    the last three (the same storage, version, shape and strides) takes
    its eterm.  The box is held, so its storage is not reused while it
    is a key."""
    key = (box.data_ptr(), box._version, tuple(box.shape),
           tuple(box.stride()), box.dtype, dtype, str(torch.device(device)))
    hits = _eterms.get(setup)
    if hits is None:
        hits = _eterms[setup] = []
    for _, k, et in hits:
        if k == key:
            return et
    et = _eterm_at(setup, box, dtype, device)
    hits.insert(0, (box, key, et))
    del hits[3:]
    return et


def _eterm_at(setup: PmeSetup, box, dtype, device):
    """exp(-pi^2 m^2 / alpha^2) / m^2 * |b(m)|^2 on the rfft half grid
    (zero at m = 0), without the conjugate-pair doubling."""
    K1, K2, K3 = setup.grid
    K3h = K3 // 2 + 1
    kw = dict(dtype=dtype, device=device)
    m1 = torch.fft.fftfreq(K1, d=1.0 / K1, **kw)
    m2 = torch.fft.fftfreq(K2, d=1.0 / K2, **kw)
    m3 = torch.arange(K3h, **kw)
    if box.dim() == 2:
        # m* = m1 a* + m2 b* + m3 c*, a*_j = column j of the inverse
        ib = boxutils.inv_box(box).to(dtype)
        f1, f2, f3 = m1[:, None, None], m2[None, :, None], m3[None, None, :]
        mx = f1 * ib[0, 0] + f2 * ib[0, 1] + f3 * ib[0, 2]
        my = f1 * ib[1, 0] + f2 * ib[1, 1] + f3 * ib[1, 2]
        mz = f1 * ib[2, 0] + f2 * ib[2, 1] + f3 * ib[2, 2]
    else:
        mx = m1[:, None, None] / box[0]
        my = m2[None, :, None] / box[1]
        mz = m3[None, None, :] / box[2]
    m_sq = mx * mx + my * my + mz * mz
    bm2 = moduli_product(setup, dtype, device)
    m_sq_safe = torch.where(m_sq > 0, m_sq, torch.ones_like(m_sq))
    return torch.where(m_sq > 0, torch.exp(-math.pi ** 2 * m_sq_safe
                                           / (setup.alpha ** 2))
                       / m_sq_safe * bm2, torch.zeros_like(m_sq))


def scaled_eterm(setup: PmeSetup, box, rep_scale, dtype):
    """(R, K1, K2, K3 // 2 + 1) eterm of R replicas whose boxes are the
    diagonal `box` times rep_scale (R,): _eterm's formula at m^2 / s_r^2,
    formed in float64 in one batched pass and rounded once."""
    K1, K2, K3 = setup.grid
    K3h = K3 // 2 + 1
    kw = dict(dtype=torch.float64, device=box.device)
    b = box.double()
    m1 = torch.fft.fftfreq(K1, d=1.0 / K1, **kw)[:, None, None] / b[0]
    m2 = torch.fft.fftfreq(K2, d=1.0 / K2, **kw)[None, :, None] / b[1]
    m3 = torch.arange(K3h, **kw)[None, None, :] / b[2]
    s2 = rep_scale.to(**kw)[:, None, None, None] ** 2
    m_sq = (m1 * m1 + m2 * m2 + m3 * m3)[None] / s2
    bm2 = moduli_product(setup, torch.float64, box.device)
    m_safe = torch.where(m_sq > 0, m_sq, torch.ones_like(m_sq))
    out = torch.where(m_sq > 0, torch.exp(-math.pi ** 2 * m_safe
                                          / setup.alpha ** 2)
                      / m_safe * bm2[None], torch.zeros_like(m_sq))
    return out.to(dtype)


def _taps(setup: PmeSetup, positions, box, exact=None, derivs=True):
    """Per-atom tap indices (N, order), weights and (with derivs) their
    derivatives per dimension.  With `exact` (float64 positions) the grid
    coordinates are formed in float64 and only the in-cell fractions
    rounded to the positions' type."""
    src = positions if exact is None else exact
    K = grid_size(setup, src.dtype, positions.device)
    frac = boxutils.frac_coords(src, box.to(src.dtype))
    u = (frac - torch.floor(frac)) * K
    ti = torch.floor(u)
    w = (u - ti).to(positions.dtype)
    ti = ti.to(torch.int64)
    j = torch.arange(PME_ORDER, device=positions.device)
    idx = [torch.remainder(ti[:, d:d + 1] - j, setup.grid[d])
           for d in range(3)]
    wts = [bspline_weights(w[:, d]) for d in range(3)]
    dwts = ([bspline_weights_d(w[:, d]) for d in range(3)] if derivs
            else None)
    return idx, wts, dwts


def _grid_shape(setup: PmeSetup, n_replicas: int) -> tuple:
    """(K1, K2, K3), or (R, K1, K2, K3) for R replicas."""
    return tuple(setup.grid) if n_replicas == 1 \
        else (n_replicas,) + tuple(setup.grid)


def _yz_index(setup: PmeSetup, idx, n: int, n_replicas: int, rep=None):
    """(N, order^2) flat (y, z) tap indices, offset by each atom's
    replica's grid (replica-major atoms) where n_replicas > 1; `rep`:
    each atom's replica where the atoms are a chunk of the system's (by
    default atom // (n / n_replicas))."""
    K1, K2, K3 = setup.grid
    yz = (idx[1][:, :, None] * K3 + idx[2][:, None, :]).reshape(n, -1)
    if n_replicas > 1:
        if rep is None:
            rep = torch.arange(n, device=yz.device) // (n // n_replicas)
        yz = yz + (rep * (K1 * K2 * K3))[:, None]
    return yz


def spread_fixed(setup: PmeSetup, charges, idx, wts, charge_bound=None,
                 n_replicas: int = 1, rep=None):
    """The charge grid as `spread` sums it: (the flat int64 fixed-point
    grid, its shift).  Grids of disjoint chunks of the atoms spread with
    one charge_bound (the whole system's) add exactly, in any order, to
    the whole's (parallel/sharded.py all-reduces them so); `rep` as in
    _yz_index."""
    K1, K2, K3 = setup.grid
    n = charges.shape[0]
    if charge_bound is None:
        q = torch.abs(charges)
        charge_bound = float(torch.sum(q) if n_replicas == 1 else
                             torch.max(torch.sum(q.reshape(n_replicas, -1),
                                                 dim=1)))
    shift = scatter.fixed_point_shift(charge_bound)
    acc = torch.zeros(n_replicas * K1 * K2 * K3, dtype=torch.int64,
                      device=charges.device)
    yz = _yz_index(setup, idx, n, n_replicas, rep)
    wyz = (wts[1][:, :, None] * wts[2][:, None, :]).reshape(n, -1)
    for t in range(PME_ORDER):
        flat = idx[0][:, t:t + 1] * (K2 * K3) + yz
        val = (charges * wts[0][:, t])[:, None] * wyz
        scatter.fixed_point_add_(acc, flat.reshape(-1), val.reshape(-1),
                                 shift)
    return acc, shift


def spread(setup: PmeSetup, charges, idx, wts, charge_bound=None,
           n_replicas: int = 1):
    """B-spline charge grid (K1, K2, K3) ((R, K1, K2, K3) for R
    replicas), one x tap at a time to bound the (N, order^2)
    temporaries, summed in int64 fixed point (ops/scatter.py): the same
    bits on the card whatever order its atomics take.  Every grid value
    is bounded by sum |q| (the taps' weights are >= 0 and sum to 1; one
    replica's sum for R replicas); `charge_bound` passes it in, else it
    is read from `charges` (one host read)."""
    acc, shift = spread_fixed(setup, charges, idx, wts, charge_bound,
                              n_replicas)
    return scatter.from_fixed_point(acc, shift, charges.dtype).reshape(
        _grid_shape(setup, n_replicas))


_FFT_DIMS = (-3, -2, -1)


def _grid_energy(setup: PmeSetup, F, eterm, box, rep_scale=None):
    """Reciprocal energy of the charge grid's spectrum F (rfftn): a 0-d
    tensor, or (R,) per-replica energies of a batch of R grids (each at
    the volume V0 s_r^3 with rep_scale); also the prefactor c (R, 1, 1,
    1 with rep_scale)."""
    K3 = setup.grid[2]
    S2 = F.real ** 2 + F.imag ** 2
    k3 = torch.arange(K3 // 2 + 1, device=F.device)
    double = ((k3 >= 1) & (k3 <= (K3 - 1) // 2)).to(eterm.dtype) + 1.0
    volume = boxutils.volume(box)
    if rep_scale is not None:
        volume = (volume.double() * rep_scale.to(
            F.device, torch.float64) ** 3).to(eterm.dtype)
    c = ONE_4PI_EPS0 / (2.0 * math.pi * volume)
    w = eterm * double
    if F.dim() == 3:
        return c * torch.sum(w * S2), c
    e = c * torch.sum(w * S2, dim=_FFT_DIMS)
    return e, (c[:, None, None, None] if rep_scale is not None else c)


def grid_energy_and_potential(setup: PmeSetup, Q, box, eterm=None,
                              rep_scale=None):
    """(energy, Phi = dE/dQ) of a charge grid (or a batch of grids along
    a leading axis): one rfftn, one irfftn.  eterm / rep_scale: a batch's
    per-replica eterm (scaled_eterm) and scales."""
    K1, K2, K3 = setup.grid
    if eterm is None:
        eterm = _eterm(setup, box, Q.dtype, Q.device)
    F = torch.fft.rfftn(Q, dim=_FFT_DIMS)
    energy, c = _grid_energy(setup, F, eterm, box, rep_scale)
    phi = (2.0 * c * (K1 * K2 * K3)) * torch.fft.irfftn(
        eterm * F, s=(K1, K2, K3), dim=_FFT_DIMS)
    return energy, phi


def _stored(positions, exact, rep_scale):
    """(positions, exact) in the stored frame p / s_r of per-replica
    scales (replica-major atoms), formed in float64; unchanged
    without."""
    if rep_scale is None:
        return positions, exact
    s = cellpair.atom_scales(rep_scale.to(positions.device),
                             positions.shape[0])[:, None]
    return ((positions.double() / s).to(positions.dtype),
            None if exact is None else exact / s)


def reciprocal_energy(setup: PmeSetup, charges, positions, box,
                      exact=None, charge_bound=None, n_replicas: int = 1,
                      rep_scale=None, eterm=None, per_replica=False):
    """The reciprocal energy alone: one rfftn, no potential grid (the
    sum of the R replicas' energies for n_replicas = R, or the (R,)
    energies with per_replica).  rep_scale ((R,), flat-ensemble NPT)
    with its scaled_eterm (built here where not given): each replica at
    its own box."""
    positions, exact = _stored(positions, exact, rep_scale)
    idx, wts, _ = _taps(setup, positions, box, exact, derivs=False)
    Q = spread(setup, charges, idx, wts, charge_bound, n_replicas)
    if eterm is None:
        eterm = (_eterm(setup, box, Q.dtype, Q.device) if rep_scale is None
                 else scaled_eterm(setup, box, rep_scale, Q.dtype))
    e = _grid_energy(setup, torch.fft.rfftn(Q, dim=_FFT_DIMS), eterm,
                     box, rep_scale)[0]
    return e if n_replicas == 1 or per_replica else torch.sum(e)


def recip_energy_forces(setup: PmeSetup, charges, positions, box,
                        exact=None, charge_bound=None, n_replicas: int = 1,
                        rep_scale=None, eterm=None):
    """(energy, forces (N, 3)) of the reciprocal sum, forces analytic;
    `exact` as in _taps.  For n_replicas = R the R replicas' sums in one
    batched pass: (per-replica energies (R,), forces); rep_scale and
    eterm as reciprocal_energy (the forces then times 1 / s_r)."""
    n = positions.shape[0]
    positions, exact = _stored(positions, exact, rep_scale)
    idx, wts, dwts = _taps(setup, positions, box, exact)
    Q = spread(setup, charges, idx, wts, charge_bound, n_replicas)
    if rep_scale is not None and eterm is None:
        eterm = scaled_eterm(setup, box, rep_scale, Q.dtype)
    energy, phi = grid_energy_and_potential(setup, Q, box, eterm, rep_scale)
    inv_s = (None if rep_scale is None else 1.0 / cellpair.atom_scales(
        rep_scale.to(positions.device), n))
    return energy, interpolate_forces(setup, charges, positions, box, idx,
                                      wts, dwts, phi, n_replicas, inv_s)


def interpolate_forces(setup: PmeSetup, charges, positions, box, idx, wts,
                       dwts, phi, n_replicas: int = 1, inv_scale=None,
                       rep=None):
    """The analytic interpolation forces (N, 3) of the atoms whose taps
    are (idx, wts, dwts), from the potential grid phi = dE/dQ (any shape
    of K1 K2 K3 values a replica); inv_scale: each atom's 1 / s_r
    (float64) with per-replica scales; rep as in _yz_index (the atoms
    may be a chunk of the system's)."""
    K1, K2, K3 = setup.grid
    n = positions.shape[0]
    phi = phi.reshape(-1)
    yz = _yz_index(setup, idx, n, n_replicas, rep)
    w_yz = (wts[1][:, :, None] * wts[2][:, None, :]).reshape(n, -1)
    dy_z = (dwts[1][:, :, None] * wts[2][:, None, :]).reshape(n, -1)
    y_dz = (wts[1][:, :, None] * dwts[2][:, None, :]).reshape(n, -1)
    gx = gy = gz = torch.zeros(n, dtype=positions.dtype,
                               device=positions.device)
    for t in range(PME_ORDER):
        ph = phi[idx[0][:, t:t + 1] * (K2 * K3) + yz]          # (N, 25)
        gx = gx + dwts[0][:, t] * torch.sum(w_yz * ph, dim=1)
        gy = gy + wts[0][:, t] * torch.sum(dy_z * ph, dim=1)
        gz = gz + wts[0][:, t] * torch.sum(y_dz * ph, dim=1)
    K = grid_size(setup, positions.dtype, positions.device)
    if box.dim() == 2:
        # dE/dr_k = sum_d K_d inv[k, d] dE/du_d (inv lower triangular)
        ib = boxutils.inv_box(box.to(positions.dtype))
        ux, uy, uz = K[0] * gx, K[1] * gy, K[2] * gz
        grad = torch.stack([ux * ib[0, 0],
                            ux * ib[1, 0] + uy * ib[1, 1],
                            ux * ib[2, 0] + uy * ib[2, 1] + uz * ib[2, 2]],
                           dim=1)
        return -charges[:, None] * grad
    scale = K / box
    forces = -charges[:, None] * torch.stack([gx, gy, gz], dim=1) * scale
    if inv_scale is not None:
        forces = forces * inv_scale.to(positions.dtype)[:, None]
    return forces
