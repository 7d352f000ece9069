"""Distributed PME reciprocal sum: the slab-decomposed 3D FFT over
torch.distributed ranks (the JAX package's parallel/distfft.py:
shardable :27, local_energy :32).

The charge grid lives in x-slabs, one a rank (parallel/sharded.py
reduce-scatters the int64 spread grids into them).  Each rank 2D-FFTs
its slab over (y, z); one all_to_all re-shards the x-slabs into y-pencils
(each rank the whole x extent of its chunk of y); a 1D FFT over x
completes the transform, and the reciprocal energy is summed over the
local pencil and all-reduced.  The FFTs are torch.fft's (cuFFT on the
card), as the JAX package's are XLA's: no Pallas kernel sits here.

The port's forces come from the potential grid Phi = dE/dQ, not from
autodiff, so the inverse runs the same way back: the pencil's spectrum
times the eterm, an inverse FFT over x, the all_to_all back to x-slabs,
an inverse 2D FFT over (y, z): each rank's slab of Phi.  With the full
complex spectrum (not the replicated path's rfftn half) Phi = 2 c
K1 K2 K3 Re(ifftn(eterm F)) and E = c sum eterm |F|^2, c = 1 / (4 pi
eps0 2 pi V): the replicated sum's, to rounding.  Orthorhombic boxes
only, as the JAX function.
"""

from __future__ import annotations

import math

import torch

from ..units import ONE_4PI_EPS0
from ..utils import tables
from . import comm


def shardable(grid, n_ranks: int) -> bool:
    """Whether a PME grid's x and y divide into `n_ranks` slabs and
    pencils."""
    K1, K2, _ = grid
    return K1 % n_ranks == 0 and K2 % n_ranks == 0


def pencil_eterm(setup, box, y_lo: int, y_hi: int, dtype, device):
    """exp(-pi^2 m^2 / alpha^2) / m^2 |b(m)|^2 on the full (K1, y_hi -
    y_lo, K3) pencil of y rows [y_lo, y_hi) (zero at m = 0); box: the
    (3,) diagonal."""
    K1, K2, K3 = setup.grid
    kw = dict(dtype=dtype, device=device)
    b = box.to(dtype)
    mx = torch.fft.fftfreq(K1, d=1.0 / K1, **kw)[:, None, None] / b[0]
    my = torch.fft.fftfreq(K2, d=1.0 / K2, **kw)[y_lo:y_hi][
        None, :, None] / b[1]
    mz = torch.fft.fftfreq(K3, d=1.0 / K3, **kw)[None, None, :] / b[2]
    m_sq = mx * mx + my * my + mz * mz
    bm2 = tables.table(setup, f"bm2_pencil_{y_lo}_{y_hi}", lambda: (
        torch.as_tensor(setup.bm2x, dtype=dtype)[:, None, None]
        * torch.as_tensor(setup.bm2y[y_lo:y_hi], dtype=dtype)[None, :, None]
        * torch.as_tensor(setup.bm2z, dtype=dtype)[None, None, :]),
        device, dtype)
    m_safe = torch.where(m_sq > 0, m_sq, torch.ones_like(m_sq))
    return torch.where(m_sq > 0, torch.exp(-math.pi ** 2 * m_safe
                                           / setup.alpha ** 2)
                       / m_safe * bm2, torch.zeros_like(m_sq))


def energy_and_potential(setup, Q_loc, box, mesh, axis: str,
                         with_potential: bool = True):
    """(the reciprocal energy, all-reduced; this rank's x-slab of Phi =
    dE/dQ (K1 / n, K2, K3), or None without with_potential) of the grid
    whose x-slab `Q_loc` (K1 / n, K2, K3) each rank of `mesh[axis]`
    holds."""
    n = mesh.size(axis)
    d = mesh.index(axis)
    K1, K2, K3 = setup.grid
    k1, k2 = K1 // n, K2 // n
    real = Q_loc.dtype
    cplx = torch.complex128 if real == torch.float64 else torch.complex64
    # 2D FFT over (y, z) of the slab, then x-slabs -> y-pencils
    F = torch.fft.fftn(Q_loc.to(cplx), dim=(1, 2))
    blocks = F.reshape(k1, n, k2, K3).movedim(1, 0).contiguous()
    F = comm.all_to_all(mesh, axis, blocks).reshape(K1, k2, K3)
    F = torch.fft.fft(F, dim=0)
    eterm = pencil_eterm(setup, box, d * k2, (d + 1) * k2, real,
                         Q_loc.device)
    volume = torch.prod(box.to(real))
    c = ONE_4PI_EPS0 / (2.0 * math.pi * volume)
    e = comm.all_reduce_sum(mesh, axis, c * torch.sum(
        eterm * (F.real ** 2 + F.imag ** 2)))
    if not with_potential:
        return e, None
    # the way back: y-pencils -> x-slabs
    G = torch.fft.ifft(eterm * F, dim=0).reshape(n, k1, k2, K3)
    G = comm.all_to_all(mesh, axis, G.contiguous())
    G = G.movedim(0, 1).reshape(k1, K2, K3)
    phi = (2.0 * c * (K1 * K2 * K3)) * torch.fft.ifftn(G, dim=(1, 2)).real
    return e, phi.contiguous()
