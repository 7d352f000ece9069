"""Virtual sites: positions from their parents, and the transpose (J^T)
that moves a site's force onto its parents.  The same sites as the JAX
package's constraints/vsites.py (apply_vsites :37): 2- and 3-particle
averages, out-of-plane sites and local-coordinates sites, placed in that
order.

The spread of an average site uses its constant weights (the JAX
package's sparse J^T table, :19).  The out-of-plane spread is analytic:
with site = p1 + w12 r12 + w13 r13 + wc (r12 x r13), a force F on the
site puts w12 F + wc (r13 x F) on p2, w13 F + wc (F x r12) on p3 and
the rest of F on p1.  The local-coordinates spread is the vector-Jacobian
product of the site function (torch.func.vjp; the JAX package falls back
to jax.vjp for both kinds).  Site rows come out exactly zero.
"""

from __future__ import annotations

import torch

from ..ops import scatter


def _has_sites(static):
    return static.n_vsites_avg or static.n_vsites_oop or static.n_vsites_lc


def _oop_sites(spec, p1, p2, p3):
    w = spec.vs_oop_w.to(p1.dtype)
    r12 = p2 - p1
    r13 = p3 - p1
    return (p1 + w[:, 0:1] * r12 + w[:, 1:2] * r13
            + w[:, 2:3] * torch.linalg.cross(r12, r13, dim=-1))


def _lc_sites(spec, p):
    """Sites of the local-coordinates frames of parents p (Vl, K, 3)."""
    dt = p.dtype
    origin = torch.sum(spec.vs_lc_ow.to(dt)[:, :, None] * p, dim=1)
    xdir = torch.sum(spec.vs_lc_xw.to(dt)[:, :, None] * p, dim=1)
    ydir = torch.sum(spec.vs_lc_yw.to(dt)[:, :, None] * p, dim=1)
    zdir = torch.linalg.cross(xdir, ydir, dim=-1)
    xhat = xdir / torch.linalg.norm(xdir, dim=-1, keepdim=True)
    zhat = zdir / torch.linalg.norm(zdir, dim=-1, keepdim=True)
    yhat = torch.linalg.cross(zhat, xhat, dim=-1)
    local = spec.vs_lc_local.to(dt)
    return (origin + local[:, 0:1] * xhat + local[:, 1:2] * yhat
            + local[:, 2:3] * zhat)


def _place_oop_lc(spec, static, out):
    if static.n_vsites_oop:
        p = spec.vs_oop_p
        out[spec.vs_oop_idx] = _oop_sites(spec, out[p[:, 0]], out[p[:, 1]],
                                          out[p[:, 2]])
    if static.n_vsites_lc:
        out[spec.vs_lc_idx] = _lc_sites(spec, out[spec.vs_lc_p])
    return out


def apply_vsites(spec, static, positions):
    if not _has_sites(static):
        return positions
    out = positions.clone()
    if static.n_vsites_avg:
        p = positions[spec.vs_avg_p]                  # (Va, 3, 3)
        out[spec.vs_avg_idx] = torch.sum(spec.vs_avg_w[:, :, None] * p,
                                         dim=1)
    return _place_oop_lc(spec, static, out)


def apply_vsites_relative(spec, static, positions):
    """apply_vsites with the average sites in the form p0 + w1 (p1 - p0)
    + w2 (p2 - p0), for float64 positions with the spec's float32
    weights: their rounding then moves a site by ~1e-8 of its offset from
    its first parent, not by ~1e-7 of its distance from the origin (the
    out-of-plane and local-coordinates forms are relative already)."""
    if not _has_sites(static):
        return positions
    out = positions.clone()
    if static.n_vsites_avg:
        p = positions[spec.vs_avg_p]                  # (Va, 3, 3)
        w = spec.vs_avg_w.to(positions.dtype)
        out[spec.vs_avg_idx] = p[:, 0] + torch.sum(
            w[:, 1:, None] * (p[:, 1:] - p[:, :1]), dim=1)
    return _place_oop_lc(spec, static, out)


def spread_vsite_forces(spec, static, forces, positions=None):
    """Site forces onto their parents; site rows -> 0.  `positions` (the
    composed positions) are needed where there are out-of-plane or
    local-coordinates sites, whose Jacobians depend on them."""
    if not _has_sites(static):
        return forces
    out = forces.clone()
    if static.n_vsites_lc:
        idx = spec.vs_lc_idx
        fs = out[idx]
        scatter.zero_rows_(out, idx)
        p = positions[spec.vs_lc_p].to(forces.dtype)
        _, vjp = torch.func.vjp(lambda q: _lc_sites(spec, q), p)
        (g,) = vjp(fs)                                # (Vl, K, 3)
        for k in range(g.shape[1]):
            scatter.index_add_(out, spec.vs_lc_p[:, k], g[:, k])
    if static.n_vsites_oop:
        idx, par = spec.vs_oop_idx, spec.vs_oop_p
        fs = out[idx]
        scatter.zero_rows_(out, idx)
        w = spec.vs_oop_w.to(forces.dtype)
        p1 = positions[par[:, 0]].to(forces.dtype)
        r12 = positions[par[:, 1]].to(forces.dtype) - p1
        r13 = positions[par[:, 2]].to(forces.dtype) - p1
        f2 = w[:, 0:1] * fs + w[:, 2:3] * torch.linalg.cross(r13, fs,
                                                            dim=-1)
        f3 = w[:, 1:2] * fs + w[:, 2:3] * torch.linalg.cross(fs, r12,
                                                            dim=-1)
        scatter.index_add_(out, par[:, 0], fs - f2 - f3)
        scatter.index_add_(out, par[:, 1], f2)
        scatter.index_add_(out, par[:, 2], f3)
    if static.n_vsites_avg:
        fs = out[spec.vs_avg_idx]                     # (Va, 3)
        scatter.zero_rows_(out, spec.vs_avg_idx)
        for k in range(3):
            scatter.index_add_(out, spec.vs_avg_p[:, k],
                               spec.vs_avg_w[:, k:k + 1] * fs)
    return out
