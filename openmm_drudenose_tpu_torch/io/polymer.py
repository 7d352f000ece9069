"""Solvated polarizable polymer: united-atom PEO-like chains (backbone
beads with Drude shells, harmonic bonds and angles, periodic torsions) in
SWM4-NDP water, with the polymer and the water in temperature groups of
their own.

The same System as the JAX package's io/polymer.py, from the same
arguments, with two differences (ROADMAP.md Queue C):

  * C13, the positions: the JAX builder wraps each bead into the box
    (np.mod), and bonded terms take no minimum image in either package,
    so a chain that crosses a face starts with bonds stretched by about
    a box length.  This builder writes the chain's own walk, unwrapped;
    the water lattice is skipped around the beads' wrapped images
    exactly as there, so the waters are the same.
  * C15, the exclusions: the JAX builder excludes bead(i-1) and bead(i)
    with each other's shells, and bead(i-2) with bead(i), but not the
    two shells of a 1-2 pair nor the shells of a 1-3 pair.  The 1-3
    pair then keeps shell-bead, bead-shell and shell-shell Coulomb
    terms whose sum is -qb^2/r (qb = 1.9 e: -501/r kJ/mol) with no
    repulsion to stop it (the beads' own LJ is excluded), only the weak
    angle term, so chains fold onto their 1-3 neighbours (a
    polarization catastrophe: Drude runaways, then non-finite energies,
    within a few hundred steps of the 100-chain system at 300 K).  This
    builder excludes every pair of the two Drude pairs of a 1-2 or 1-3
    bead pair, as OpenMM's createExceptionsFromBonds does for Drude
    particles.
"""

from __future__ import annotations

import numpy as np

from ..forces.bonded import (HarmonicAngleForce, HarmonicBondForce,
                             PeriodicTorsionForce)
from ..forces.cmmotion import CMMotionRemover
from ..forces.drude import DrudeForce
from ..forces.nonbonded import NonbondedForce
from ..system import System
from ..units import KCAL_PER_MOL, ONE_4PI_EPS0
from .builders import add_swm4_molecule, swm4_molecule_positions

K_DRUDE = 1000 * KCAL_PER_MOL * 100


def build_solvated_polymer(n_chains: int, chain_length: int, n_water: int,
                           method: int = NonbondedForce.PME,
                           cutoff: float = 1.0,
                           density: float = 33.33):
    """Returns (system, positions, polymer_atoms, water_atoms): n_chains
    chains of chain_length beads (bead + Drude shell each), random walks
    from uniform origins (default_rng(17)), then up to n_water waters on
    a cubic lattice, skipping every site within 0.35 nm of a bead."""
    box = ((n_water + n_chains * chain_length * 3) / density) ** (1 / 3)
    box = max(box, 0.45 * chain_length / 2 + 1.0)  # fit the chains

    system = System()
    nonbonded = NonbondedForce()
    drude = DrudeForce()
    bonds = HarmonicBondForce()
    angles = HarmonicAngleForce()
    torsions = PeriodicTorsionForce()
    for f in (nonbonded, drude, bonds, angles, torsions):
        system.addForce(f)
    system.setDefaultPeriodicBoxVectors((box, 0, 0), (0, box, 0),
                                        (0, 0, box))
    nonbonded.setNonbondedMethod(method)
    nonbonded.setCutoffDistance(cutoff)

    alpha = 0.0012  # nm^3 per backbone bead
    q_d = -np.sqrt(alpha * K_DRUDE / ONE_4PI_EPS0)
    polymer_atoms = []
    positions = []
    wrapped = []   # the beads' images in the box: the water lattice's test
    rng = np.random.default_rng(17)

    bead_spacing = 0.36
    for _ in range(n_chains):
        origin = rng.uniform(0.5, box - 0.5, 3)
        direction = rng.normal(size=3)
        direction /= np.linalg.norm(direction)
        prev = []
        for _ in range(chain_length):
            base = system.getNumParticles()
            bead, shell = base, base + 1
            system.addParticle(44.0 - 0.4)   # CH2-O-CH2 monomer bead
            system.addParticle(0.4)
            nonbonded.addParticle(-q_d, 0.41, 0.6 * KCAL_PER_MOL * 4.184
                                  / 4.184)
            nonbonded.addParticle(q_d, 1.0, 0.0)
            nonbonded.addException(bead, shell, 0, 1, 0)
            drude.addParticle(shell, bead, -1, -1, -1, q_d, alpha, 1, 1)
            polymer_atoms.extend([bead, shell])
            if prev:
                pb = prev[-1]
                bonds.addBond(pb, bead, bead_spacing, 60000.0)
                nonbonded.addException(pb, bead, 0, 1, 0)
                nonbonded.addException(pb, shell, 0, 1, 0)
                nonbonded.addException(prev[-1] + 1, bead, 0, 1, 0)
            if len(prev) >= 2:
                angles.addAngle(prev[-2], prev[-1], bead,
                                np.deg2rad(130.0), 300.0)
                nonbonded.addException(prev[-2], bead, 0, 1, 0)
            # the shell pairs of the 1-2 and 1-3 bead pairs that the JAX
            # builder leaves in (Queue C15)
            if prev:
                nonbonded.addException(prev[-1] + 1, shell, 0, 1, 0)
            if len(prev) >= 2:
                p2 = prev[-2]
                for a, b in ((p2, shell), (p2 + 1, bead), (p2 + 1, shell)):
                    nonbonded.addException(a, b, 0, 1, 0)
            if len(prev) >= 3:
                torsions.addTorsion(prev[-3], prev[-2], prev[-1], bead,
                                    3, 0.0, 2.0)
            prev.append(bead)
            # mild random walk to avoid a perfectly straight rod
            step_dir = direction + rng.normal(0, 0.25, 3)
            step_dir /= np.linalg.norm(step_dir)
            origin = origin + step_dir * bead_spacing
            positions.append(np.array([origin, origin]))
            wrapped.append(np.mod(origin, box))

    # solvate: water lattice sites, skipping any site within 0.35 nm of a
    # bead (minimum image), so the start is overlap-free
    bead_pos = np.array(wrapped) if wrapped else np.zeros((0, 3))
    water_start = system.getNumParticles()
    gw = int(np.ceil((n_water * 1.3) ** (1 / 3)))
    count = 0
    for i in range(gw):
        for j in range(gw):
            for k in range(gw):
                if count >= n_water:
                    break
                origin = (np.array([i, j, k]) + 0.5) * (box / gw)
                d = bead_pos - origin
                d -= box * np.round(d / box)
                if len(bead_pos) and (np.sum(d * d, axis=1)
                                      < 0.35 ** 2).any():
                    continue
                add_swm4_molecule(system, nonbonded, drude)
                positions.append(swm4_molecule_positions(origin))
                count += 1
    water_atoms = list(range(water_start, system.getNumParticles()))
    system.addForce(CMMotionRemover())
    return (system, np.concatenate(positions, axis=0), polymer_atoms,
            water_atoms)


def make_tgnh_integrator(polymer_atoms, water_atoms, n_atoms,
                         temperature=300.0, drude_temperature=1.0,
                         step_size=0.001):
    """The polymer in bath 0, the water in bath 1, then the
    molecular-COM bath and the Drude bath."""
    from ..app.integrator import DrudeTGNHIntegrator
    integ = DrudeTGNHIntegrator(temperature, 0.1, drude_temperature, 0.1,
                                step_size, 20)
    integ.addTempGroup()  # polymer
    integ.addTempGroup()  # water
    for _ in range(n_atoms):
        integ.addParticleTempGroup(1)
    for i in polymer_atoms:
        integ.setParticleTempGroup(i, 0)
    return integ
