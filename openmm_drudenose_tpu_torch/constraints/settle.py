"""Rigid-triangle (water) constraints: a fixed 6-iteration Newton solve on
the three Lagrange multipliers for positions, and one exact 3x3 solve for
velocities.  Corrections run along the pre-step bond directions, so this
is the SHAKE/SETTLE solution, quadratically convergent to machine
precision.  The same solver as the JAX package's constraints/settle.py.
"""

from __future__ import annotations

import torch

from ..ops import scatter

NEWTON_ITERS = 6


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _solve33(J, f):
    """Batched 3x3 solve by the adjugate; J nested 3x3 of (S,), f 3 x (S,)."""
    (a, b, c), (d, e, g), (h, i, j) = J
    A = e * j - g * i
    B = -(d * j - g * h)
    C = d * i - e * h
    D = -(b * j - c * i)
    E = a * j - c * h
    F = -(a * i - b * h)
    G = b * g - c * e
    H = -(a * g - c * d)
    I = a * e - b * d
    inv_det = 1.0 / (a * A + b * B + c * C)
    return ((A * f[0] + D * f[1] + G * f[2]) * inv_det,
            (B * f[0] + E * f[1] + H * f[2]) * inv_det,
            (C * f[0] + F * f[1] + I * f[2]) * inv_det)


def _coef_matrix(wa, wb, wc):
    """C[k][j]: coefficient of lambda_j u_j in bond vector k (ab, ac, bc)."""
    return ((wa + wb, wa, -wb),
            (wa, wa + wc, wc),
            (-wb, wc, wb + wc))


def _apply(target, settle_idx, corr):
    out = target.clone()
    for role in range(3):
        scatter.index_add_(out, settle_idx[:, role], corr[role])
    return out


def apply_position_constraints(positions, delta, inv_mass, settle_idx,
                               settle_dist):
    """Adjust `delta` so that positions + delta satisfies the triangles
    (positions satisfy them already and give the reference directions)."""
    if settle_idx.shape[0] == 0:
        return delta
    ia, ib, ic = settle_idx[:, 0], settle_idx[:, 1], settle_idx[:, 2]
    d2 = (settle_dist[:, 0] ** 2, settle_dist[:, 0] ** 2,
          settle_dist[:, 1] ** 2)
    wa, wb, wc = inv_mass[ia], inv_mass[ib], inv_mass[ic]
    pa, pb, pc = positions[ia], positions[ib], positions[ic]
    u = [pa - pb, pa - pc, pb - pc]
    qa, qb, qc = pa + delta[ia], pb + delta[ib], pc + delta[ic]
    r0 = [qa - qb, qa - qc, qb - qc]
    C = _coef_matrix(wa, wb, wc)
    zero = torch.zeros_like(wa)
    lam = (zero, zero, zero)
    for _ in range(NEWTON_ITERS):
        r = [r0[k] + sum(C[k][j][:, None] * lam[j][:, None] * u[j]
                         for j in range(3)) for k in range(3)]
        f = tuple(_dot(r[k], r[k]) - d2[k] for k in range(3))
        J = tuple(tuple(2.0 * C[k][j] * _dot(r[k], u[j]) for j in range(3))
                  for k in range(3))
        dx = _solve33(J, f)
        lam = tuple(lam[k] - dx[k] for k in range(3))
    la, lb, lc = (x[:, None] for x in lam)
    corr = (wa[:, None] * (la * u[0] + lb * u[1]),
            wb[:, None] * (-la * u[0] + lc * u[2]),
            wc[:, None] * (-lb * u[1] - lc * u[2]))
    return _apply(delta, settle_idx, corr)


def apply_velocity_constraints(positions, velocities, inv_mass, settle_idx,
                               settle_dist):
    """Exact velocity projection: bond-direction relative velocities -> 0."""
    if settle_idx.shape[0] == 0:
        return velocities
    ia, ib, ic = settle_idx[:, 0], settle_idx[:, 1], settle_idx[:, 2]
    wa, wb, wc = inv_mass[ia], inv_mass[ib], inv_mass[ic]
    pa, pb, pc = positions[ia], positions[ib], positions[ic]
    va, vb, vc = velocities[ia], velocities[ib], velocities[ic]
    u = [pa - pb, pa - pc, pb - pc]
    v = [va - vb, va - vc, vb - vc]
    C = _coef_matrix(wa, wb, wc)
    f = tuple(-_dot(u[k], v[k]) for k in range(3))
    J = tuple(tuple(C[k][j] * _dot(u[k], u[j]) for j in range(3))
              for k in range(3))
    la, lb, lc = (x[:, None] for x in _solve33(J, f))
    corr = (wa[:, None] * (la * u[0] + lb * u[1]),
            wb[:, None] * (-la * u[0] + lc * u[2]),
            wc[:, None] * (-lb * u[1] - lc * u[2]))
    return _apply(velocities, settle_idx, corr)
