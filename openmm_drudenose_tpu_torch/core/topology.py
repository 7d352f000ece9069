"""Molecule (residue) decomposition.

Particles share a molecule when constraints, force-defined bonds
(nonbonded exceptions, Drude pairs) or virtual-site dependencies connect
them, as OpenMM's Context::getMolecules() defines it.  Components come
from vectorised min-label propagation and are numbered in order of their
first atom, the order the JAX package's union-find gives.
"""

from __future__ import annotations

import numpy as np


def link_edges(system) -> np.ndarray:
    edges = []
    for ci in range(system.getNumConstraints()):
        p1, p2, _ = system.getConstraintParameters(ci)
        edges.append((p1, p2))
    for f in system.getForces():
        edges.extend(getattr(f, "bonded_pairs", lambda: [])())
    for i in range(system.getNumParticles()):
        if system.isVirtualSite(i):
            for p in system.getVirtualSite(i).particles:
                edges.append((i, p))
    return np.array(edges, np.int64).reshape(-1, 2)


def component_labels(n: int, edges: np.ndarray) -> np.ndarray:
    """Smallest atom index of each atom's connected component."""
    label = np.arange(n, dtype=np.int64)
    if len(edges) == 0:
        return label
    a, b = edges[:, 0], edges[:, 1]
    while True:
        m = np.minimum(label[a], label[b])
        new = label.copy()
        np.minimum.at(new, a, m)
        np.minimum.at(new, b, m)
        new = new[new]
        while True:                       # pointer jumping
            nxt = new[new]
            if np.array_equal(nxt, new):
                break
            new = nxt
        if np.array_equal(new, label):
            return label
        label = new


def molecule_ids(system) -> np.ndarray:
    """Per-particle molecule ids 0..M-1, numbered in order of first
    appearance."""
    n = system.getNumParticles()
    label = component_labels(n, link_edges(system))
    _, ids = np.unique(label, return_inverse=True)
    return ids.astype(np.int32)


def residue_masses(system, resid: np.ndarray) -> np.ndarray:
    """Total mass of each residue."""
    n_res = int(resid.max()) + 1 if len(resid) else 0
    masses = np.array([system.getParticleMass(i) for i in range(len(resid))])
    out = np.zeros(n_res)
    np.add.at(out, resid, masses)
    return out
