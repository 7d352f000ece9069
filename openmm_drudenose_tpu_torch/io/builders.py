"""The benchmark and example systems, built in code: SWM4-NDP water, and
NaCl in SWM4-NDP water (the reference example's system).

The same parameters, lattices, random orientations and shuffles as the
JAX package's io/builders.py (build_water_box, build_nacl_water_box), so
both packages build identical systems from the same arguments (the
committed 100k-atom snapshot was made there).
"""

from __future__ import annotations

import numpy as np

from ..forces.cmmotion import CMMotionRemover
from ..forces.drude import DrudeForce
from ..forces.nonbonded import NonbondedForce
from ..system import System, ThreeParticleAverageSite
from ..units import ONE_4PI_EPS0

# SWM4-NDP site parameters (Lamoureux, Harder, Vorobyov, Roux, MacKerell,
# Chem. Phys. Lett. 418 (2006) 245), M site at r_OM = 0.24034 A.
SWM4_O_MASS = 15.6
SWM4_D_MASS = 0.4
SWM4_H_MASS = 1.0
SWM4_Q_D = -1.71636
SWM4_Q_H = 0.55733
SWM4_Q_M = -1.11466
SWM4_O_SIGMA = 0.318395
SWM4_O_EPS = 0.21094 * 4.184
SWM4_ALPHA = ONE_4PI_EPS0 * SWM4_Q_D ** 2 / (100000 * 4.184)
SWM4_D_OH = 0.09572
SWM4_D_HH = 0.15139
SWM4_R_OM = 0.024034  # nm
_D_OHMID = float(np.sqrt(SWM4_D_OH ** 2 - (SWM4_D_HH / 2.0) ** 2))
SWM4_M_W23 = SWM4_R_OM / (2.0 * _D_OHMID)
SWM4_M_W1 = 1.0 - 2.0 * SWM4_M_W23

# number density of water at ~1 g/cm3, molecules / nm^3
WATER_NUMBER_DENSITY = 33.33


def add_swm4_molecule(system: System, nonbonded: NonbondedForce,
                      drude: DrudeForce) -> int:
    start = system.getNumParticles()
    system.addParticle(SWM4_O_MASS)
    system.addParticle(SWM4_D_MASS)
    system.addParticle(SWM4_H_MASS)
    system.addParticle(SWM4_H_MASS)
    system.addParticle(0.0)
    nonbonded.addParticle(-SWM4_Q_D, SWM4_O_SIGMA, SWM4_O_EPS)
    nonbonded.addParticle(SWM4_Q_D, 1.0, 0.0)
    nonbonded.addParticle(SWM4_Q_H, 1.0, 0.0)
    nonbonded.addParticle(SWM4_Q_H, 1.0, 0.0)
    nonbonded.addParticle(SWM4_Q_M, 1.0, 0.0)
    for j in range(5):
        for k in range(j):
            nonbonded.addException(start + j, start + k, 0, 1, 0)
    system.addConstraint(start, start + 2, SWM4_D_OH)
    system.addConstraint(start, start + 3, SWM4_D_OH)
    system.addConstraint(start + 2, start + 3, SWM4_D_HH)
    system.setVirtualSite(start + 4, ThreeParticleAverageSite(
        start, start + 2, start + 3, SWM4_M_W1, SWM4_M_W23, SWM4_M_W23))
    drude.addParticle(start + 1, start, -1, -1, -1, SWM4_Q_D, SWM4_ALPHA,
                      1, 1)
    return start


def swm4_molecule_positions(origin: np.ndarray) -> np.ndarray:
    """Site positions of one molecule at rest geometry."""
    return origin + np.array([
        [0.0, 0.0, 0.0],
        [0.0, 0.0, 0.0],
        [SWM4_D_OH, 0.0, 0.0],
        [-0.023999, 0.092663, 0.0],
        [0.0, 0.0, 0.0],
    ])


def build_water_box(n_molecules: int, method: int = NonbondedForce.PME,
                    cutoff: float = 1.0, ewald_tol: float = 5e-4,
                    add_cm_motion: bool = True,
                    density: float = WATER_NUMBER_DENSITY,
                    shape=(1, 1, 1)):
    """SWM4-NDP water in a cubic box at the given number density, on a
    uniform random subset of lattice sites with random orientations.
    Returns (system, positions); 20000 molecules give the 100k-atom
    benchmark system.  `shape` elongates the box: edge lengths
    proportional to it at the same density (the JAX package's option:
    (8, 1, 1) gives the dryrun's resident slabs many x-planes from few
    molecules); the cubic box's formula is unchanged."""
    s = np.asarray(shape, np.int64)
    if tuple(s) == (1, 1, 1):
        grid = int(np.ceil(n_molecules ** (1.0 / 3.0)))
        box = (n_molecules / density) ** (1.0 / 3.0)
        spacing = box / grid
        grid3, box3 = (grid,) * 3, (box,) * 3
    else:
        g = int(np.ceil((n_molecules / float(s.prod())) ** (1.0 / 3.0)))
        grid3 = tuple(int(g * v) for v in s)
        spacing = (n_molecules
                   / (density * float(np.prod(grid3)))) ** (1.0 / 3.0)
        box3 = tuple(gi * spacing for gi in grid3)

    system = System()
    nonbonded = NonbondedForce()
    drude = DrudeForce()
    system.addForce(nonbonded)
    system.addForce(drude)
    system.setDefaultPeriodicBoxVectors((box3[0], 0, 0), (0, box3[1], 0),
                                        (0, 0, box3[2]))
    nonbonded.setNonbondedMethod(method)
    nonbonded.setCutoffDistance(cutoff)
    nonbonded.setEwaldErrorTolerance(ewald_tol)

    positions = []
    rng = np.random.default_rng(1234)
    sites = np.sort(rng.choice(int(np.prod(grid3)), size=n_molecules,
                               replace=False))
    for site in sites:
        i = site // (grid3[1] * grid3[2])
        j = (site // grid3[2]) % grid3[1]
        k = site % grid3[2]
        origin = (np.array([i, j, k]) + 0.5) * spacing
        mol = swm4_molecule_positions(origin)
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        rot = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)],
        ])
        mol = (mol - origin) @ rot.T + origin
        add_swm4_molecule(system, nonbonded, drude)
        positions.append(mol)
    if add_cm_motion:
        system.addForce(CMMotionRemover())
    return system, np.concatenate(positions, axis=0)


# Drude ion parameters (charge, sigma nm, eps kJ/mol, polarizability nm^3,
# Drude mass, mass): the CHARMM Drude-2013 ion model
NACL_IONS = {
    "NA": (1.0, 0.2430, 0.1305 * 4.184, 0.000157, 0.4, 22.5898),
    "CL": (-1.0, 0.4612, 0.0719 * 4.184, 0.003969, 0.4, 35.0527),
}


def build_nacl_water_box(n_water: int, n_na: int, n_cl: int,
                         method: int = NonbondedForce.PME,
                         cutoff: float = 1.0):
    """NaCl in SWM4-NDP water, the reference example's system shape
    (example/nacl_tg.py: ~1 M NaCl), with polarizable Na+/Cl-: waters and
    ions shuffled (default_rng(7)) over a uniform random subset of the
    sites of a cubic lattice at water density.  Returns (system,
    positions)."""
    density = WATER_NUMBER_DENSITY
    n_sites = n_water + n_na + n_cl
    grid = int(np.ceil(n_sites ** (1.0 / 3.0)))
    box = (n_sites / density) ** (1.0 / 3.0)
    spacing = box / grid

    system = System()
    nonbonded = NonbondedForce()
    drude = DrudeForce()
    system.addForce(nonbonded)
    system.addForce(drude)
    system.setDefaultPeriodicBoxVectors((box, 0, 0), (0, box, 0),
                                        (0, 0, box))
    nonbonded.setNonbondedMethod(method)
    nonbonded.setCutoffDistance(cutoff)

    positions = []
    kinds = ["NA"] * n_na + ["CL"] * n_cl + ["W"] * n_water
    rng = np.random.default_rng(7)
    rng.shuffle(kinds)
    sites = np.sort(rng.choice(grid ** 3, size=len(kinds), replace=False))
    for count, site in enumerate(sites):
        i, j, k = (site // (grid * grid), (site // grid) % grid,
                   site % grid)
        origin = (np.array([i, j, k]) + 0.5) * spacing
        kind = kinds[count]
        if kind == "W":
            add_swm4_molecule(system, nonbonded, drude)
            positions.append(swm4_molecule_positions(origin))
        else:
            q, sigma, eps, alpha, d_mass, mass = NACL_IONS[kind]
            q_d = -np.sqrt(alpha * 100000 * 4.184 / ONE_4PI_EPS0)
            start = system.getNumParticles()
            system.addParticle(mass - d_mass)
            system.addParticle(d_mass)
            nonbonded.addParticle(q - q_d, sigma, eps)
            nonbonded.addParticle(q_d, 1.0, 0.0)
            nonbonded.addException(start, start + 1, 0, 1, 0)
            drude.addParticle(start + 1, start, -1, -1, -1, q_d,
                              alpha, 1, 1)
            positions.append(np.array([origin, origin]))
    system.addForce(CMMotionRemover())
    return system, np.concatenate(positions, axis=0)
