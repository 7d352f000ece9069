"""Distance constraints outside the SETTLE triangles: Jacobi SHAKE on
positions and the RATTLE projection of velocities (the JAX package's
constraints/shake.py).  Every constraint is corrected together each
sweep, from fixed reference directions, until every r^2/d^2 lies within
[1 - 2 tol, 1 + 2 tol] (OpenMM's criterion), or for velocities every
|r.v|/d^2 <= tol, or max_iter sweeps.

In float32 with compensated positions (core/state.py pos_err) the bond
vectors are taken from positions + pos_err, r_ij = (p_i - p_j) + (e_i -
e_j), the positions the integrator carries: from the rounded positions
alone a bond 8 nm from the origin is off by ~1e-6 nm, which is 2e-5 of
r^2/d^2 for an O-H bond, the whole 2 tol band, and |r.v|/d^2 then reads
~1e-4 after an exact projection (the JAX package takes the rounded ones;
in float64 there is no pos_err and the two are the same).

The JAX package runs the sweeps in a lax.while_loop, whose test reads a
flag on the device.  A host loop that read the flag after every sweep
would wait for the card's queue that often in every step.  Here the flag
stays on the device: each sweep's correction is multiplied by "not done
before this sweep", so the sweeps after convergence change nothing, and
the host reads the flag once every `check_every` sweeps and at max_iter.
The sweeps that take effect are the JAX loop's, for any check_every: the
sweep that finds the constraints met still applies its correction, as
the JAX body does, and stops the loop.  The caller's `stats`
(ShakeStats) counts the sweeps that took effect (on the device) and the
host reads.
"""

from __future__ import annotations

import torch

from ..ops import scatter

# sweeps between two host reads of the convergence flag
CHECK_EVERY = 8


class ShakeStats:
    """Sweeps that took effect, one 0-d device tensor a call ("pos" for
    SHAKE, "vel" for RATTLE), the host reads of the flag, and each SHAKE
    call's max |r^2/d^2 - 1| at its result (a 0-d device tensor)."""

    def __init__(self):
        self.sweeps = {"pos": [], "vel": []}
        self.reads = 0
        self.violation = []

    def per_call(self, kind: str):
        """The host list of sweeps per call of `kind` (one read)."""
        s = self.sweeps[kind]
        return torch.stack(s).cpu().tolist() if s else []


def _sweep_loop(body, state, max_iter, check_every, stats, kind, device):
    """Run body(state) -> (state, converged) under the device-side done
    mask: body gets `live` (1 before convergence, 0 after)."""
    done = torch.zeros((), dtype=torch.bool, device=device)
    count = torch.zeros((), dtype=torch.int64, device=device)
    for it in range(max_iter):
        live = ~done
        state, conv = body(state, live)
        count = count + live.to(torch.int64)
        done = done | conv
        if (it + 1) % check_every == 0 or it + 1 == max_iter:
            if stats is not None:
                stats.reads += 1
            if bool(done):
                break
    if stats is not None:
        stats.sweeps[kind].append(count)
    return state


def _bonds(positions, i, j, pos_err):
    r = positions[i] - positions[j]
    if pos_err is not None:
        r = r + (pos_err[i] - pos_err[j])
    return r


def apply_position_constraints(positions, delta, inv_mass, idx, dist, tol,
                               max_iter: int, check_every: int = CHECK_EVERY,
                               stats: ShakeStats | None = None,
                               pos_err=None):
    """`delta` adjusted so that positions (+ pos_err) + delta meets
    |r_ij| = d for every constraint (idx (C, 2), dist (C,)); `positions`
    meet the constraints already and give the reference directions."""
    if idx.shape[0] == 0:
        return delta
    i, j = idx[:, 0], idx[:, 1]
    r_ref = _bonds(positions, i, j, pos_err)
    wi = inv_mass[i][:, None]
    wj = inv_mass[j][:, None]
    d2 = dist * dist
    lower = (1.0 - 2.0 * tol) * d2
    upper = (1.0 + 2.0 * tol) * d2
    denom0 = 2.0 * (wi[:, 0] + wj[:, 0])

    def body(delta, live):
        rp = r_ref + delta[i] - delta[j]
        rp2 = torch.sum(rp * rp, dim=-1)
        denom = denom0 * torch.sum(rp * r_ref, dim=-1)
        ok = torch.abs(denom) > 1e-12
        g = torch.where(ok, (rp2 - d2) / torch.where(
            ok, denom, torch.ones_like(denom)), torch.zeros_like(denom))
        corr = (g * live.to(g.dtype))[:, None] * r_ref
        delta = scatter.index_add_(delta.clone(), i, -wi * corr)
        scatter.index_add_(delta, j, wj * corr)
        return delta, torch.all((rp2 >= lower) & (rp2 <= upper))

    delta = _sweep_loop(body, delta, max_iter, check_every, stats, "pos",
                        delta.device)
    if stats is not None:
        rp = r_ref + delta[i] - delta[j]
        stats.violation.append(torch.max(torch.abs(
            torch.sum(rp * rp, dim=-1) / d2 - 1.0)))
    return delta


def apply_velocity_constraints(positions, velocities, inv_mass, idx, dist,
                               tol, max_iter: int,
                               check_every: int = CHECK_EVERY,
                               stats: ShakeStats | None = None,
                               pos_err=None):
    """RATTLE: remove the velocity components along the constrained
    bonds (r_ij . v_ij -> 0), Jacobi style."""
    if idx.shape[0] == 0:
        return velocities
    i, j = idx[:, 0], idx[:, 1]
    r = _bonds(positions, i, j, pos_err)
    d2 = dist * dist
    wi = inv_mass[i][:, None]
    wj = inv_mass[j][:, None]
    inv_denom = 1.0 / ((wi[:, 0] + wj[:, 0]) * d2)

    def body(vel, live):
        rv = torch.sum(r * (vel[i] - vel[j]), dim=-1)
        g = -rv * inv_denom * live.to(rv.dtype)
        corr = g[:, None] * r
        vel = scatter.index_add_(vel.clone(), i, wi * corr)
        scatter.index_add_(vel, j, -wj * corr)
        return vel, torch.all(torch.abs(rv) / d2 <= tol)

    return _sweep_loop(body, velocities, max_iter, check_every, stats,
                       "vel", velocities.device)
