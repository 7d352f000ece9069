"""Average virtual sites: positions from their parents, and the transpose
(J^T) that moves a site's force onto its parents.  The same functions as
the JAX package's constraints/vsites.py (apply_vsites :37,
spread_vsite_forces :19) for 2- and 3-particle average sites."""

from __future__ import annotations

import torch

from ..ops import scatter


def apply_vsites(spec, static, positions):
    if not static.n_vsites_avg:
        return positions
    p = positions[spec.vs_avg_p]                      # (Va, 3, 3)
    site = torch.sum(spec.vs_avg_w[:, :, None] * p, dim=1)
    out = positions.clone()
    out[spec.vs_avg_idx] = site
    return out


def apply_vsites_relative(spec, static, positions):
    """apply_vsites in the form p0 + w1 (p1 - p0) + w2 (p2 - p0), for
    float64 positions with the spec's float32 weights: their rounding
    then moves a site by ~1e-8 of its offset from its first parent, not
    by ~1e-7 of its distance from the origin."""
    if not static.n_vsites_avg:
        return positions
    p = positions[spec.vs_avg_p]                      # (Va, 3, 3)
    w = spec.vs_avg_w.to(positions.dtype)
    site = p[:, 0] + torch.sum(w[:, 1:, None] * (p[:, 1:] - p[:, :1]),
                               dim=1)
    out = positions.clone()
    out[spec.vs_avg_idx] = site
    return out


def spread_vsite_forces(spec, static, forces):
    """Site forces onto parents with the site weights; site rows -> 0."""
    if not static.n_vsites_avg:
        return forces
    fs = forces[spec.vs_avg_idx]                       # (Va, 3)
    out = forces.clone()
    out[spec.vs_avg_idx] = 0.0
    for k in range(3):
        scatter.index_add_(out, spec.vs_avg_p[:, k],
                           spec.vs_avg_w[:, k:k + 1] * fs)
    return out
