"""Jacobi SHAKE projection onto distance constraints, for
Context.applyConstraints (the JAX package's constraints/shake.py::
apply_position_constraints): all constraints updated together each sweep
from fixed reference directions, until every r^2/d^2 lies within
[1 - 2 tol, 1 + 2 tol] (OpenMM's criterion) or max_iter sweeps.  Used
for the initial projection, where the rigid-triangle Newton solve of
constraints/settle.py would need valid reference directions."""

from __future__ import annotations

import torch

from ..ops import scatter

# sweeps at most (the JAX package's StaticSpec.shake_max_iter)
MAX_ITER = 150


def apply_position_constraints(positions, delta, inv_mass, idx, dist, tol,
                               max_iter: int):
    """`delta` adjusted so that positions + delta meets |r_ij| = d for
    every constraint (idx (C, 2), dist (C,)); `positions` give the
    reference directions.  One host read a sweep (the convergence
    test)."""
    if idx.shape[0] == 0:
        return delta
    i, j = idx[:, 0], idx[:, 1]
    r_ref = positions[i] - positions[j]
    wi = inv_mass[i][:, None]
    wj = inv_mass[j][:, None]
    d2 = dist * dist
    lower = (1.0 - 2.0 * tol) * d2
    upper = (1.0 + 2.0 * tol) * d2
    for _ in range(max_iter):
        rp = r_ref + delta[i] - delta[j]
        rp2 = torch.sum(rp * rp, dim=-1)
        denom = 2.0 * (wi[:, 0] + wj[:, 0]) * torch.sum(rp * r_ref, dim=-1)
        ok = torch.abs(denom) > 1e-12
        g = torch.where(ok, (rp2 - d2) / torch.where(
            ok, denom, torch.ones_like(denom)), torch.zeros_like(denom))
        corr = g[:, None] * r_ref
        delta = scatter.index_add_(delta.clone(), i, -wi * corr)
        scatter.index_add_(delta, j, wj * corr)
        if bool(torch.all((rp2 >= lower) & (rp2 <= upper))):
            break
    return delta
