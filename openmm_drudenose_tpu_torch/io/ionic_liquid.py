"""Coarse-grained polarizable ionic liquid (BMIM/BF4-like), the paper's
use case: separate Nose-Hoover baths for cations, anions and the Drude
oscillators, assigned per ion (Son, McDaniel, Cui, Yethiraj, JPCL 2019).

The same System, lattice, shuffle and parameters as the JAX package's
io/ionic_liquid.py, so both packages build identical systems from the
same arguments.  A model system for the engine, not a quantitative force
field:

  cation (BMIM+-like): IM (+0.8, with a Drude shell) bonded to C1 and C2,
                       with the angle C1-IM-C2
  anion  (BF4--like):  B (-0.6, with a Drude shell) bonded to F (-0.4)

Every intra-ion pair is excluded; the bonds and angles are harmonic
(forces/bonded.py).
"""

from __future__ import annotations

import numpy as np

from ..forces.bonded import HarmonicAngleForce, HarmonicBondForce
from ..forces.cmmotion import CMMotionRemover
from ..forces.drude import DrudeForce
from ..forces.nonbonded import NonbondedForce
from ..system import System
from ..units import KCAL_PER_MOL, ONE_4PI_EPS0

K_DRUDE = 1000 * KCAL_PER_MOL * 100  # kJ/mol/nm^2


def _qd(alpha_nm3):
    return -np.sqrt(alpha_nm3 * K_DRUDE / ONE_4PI_EPS0)


def build_ionic_liquid(n_pairs: int, density: float = 3.2,
                       method: int = NonbondedForce.PME,
                       cutoff: float = 1.2,
                       add_cm_motion: bool = True):
    """Returns (system, positions, cation_atoms, anion_atoms): n_pairs ion
    pairs (7 atoms each) on a cubic lattice at `density` ion pairs / nm^3
    (~3.2 approximates BMIM/BF4 at 400 K), cations and anions shuffled
    over its sites (default_rng(99)).  The lattice start overlaps
    neighbouring ions: minimize before dynamics."""
    n_sites = 2 * n_pairs
    grid = int(np.ceil(n_sites ** (1 / 3)))
    box = (n_sites / (2 * density)) ** (1 / 3)
    spacing = box / grid

    system = System()
    nonbonded = NonbondedForce()
    drude = DrudeForce()
    bonds = HarmonicBondForce()
    angles = HarmonicAngleForce()
    for f in (nonbonded, drude, bonds, angles):
        system.addForce(f)
    system.setDefaultPeriodicBoxVectors((box, 0, 0), (0, box, 0),
                                        (0, 0, box))
    nonbonded.setNonbondedMethod(method)
    nonbonded.setCutoffDistance(cutoff)

    alpha_im = 0.0020   # nm^3
    alpha_bf4 = 0.0023
    cation_atoms, anion_atoms = [], []
    positions = []
    rng = np.random.default_rng(99)
    kinds = ["C"] * n_pairs + ["A"] * n_pairs
    rng.shuffle(kinds)
    for count, kind in enumerate(kinds):
        site = np.array([count // (grid * grid), (count // grid) % grid,
                         count % grid])
        origin = (site + 0.5) * spacing
        base = system.getNumParticles()
        if kind == "C":
            im, d, c1, c2 = base, base + 1, base + 2, base + 3
            system.addParticle(80.0 - 0.4)  # IM ring bead
            system.addParticle(0.4)         # Drude
            system.addParticle(15.0)        # C1 (methyl-ish)
            system.addParticle(43.0)        # C2 (butyl-ish)
            q_d = _qd(alpha_im)
            nonbonded.addParticle(0.8 - q_d, 0.45, 2.0)
            nonbonded.addParticle(q_d, 1.0, 0.0)
            nonbonded.addParticle(0.1, 0.37, 0.8)
            nonbonded.addParticle(0.1, 0.42, 1.2)
            atoms = (im, d, c1, c2)
            for a in atoms:
                for b in atoms:
                    if a < b:
                        nonbonded.addException(a, b, 0, 1, 0)
            bonds.addBond(im, c1, 0.35, 80000.0)
            bonds.addBond(im, c2, 0.40, 80000.0)
            angles.addAngle(c1, im, c2, np.deg2rad(120.0), 400.0)
            drude.addParticle(d, im, -1, -1, -1, q_d, alpha_im, 1, 1)
            cation_atoms.extend(atoms)
            positions.append(np.array([
                origin, origin, origin + [0.35, 0, 0],
                origin + [-0.2, 0.35, 0]]))
        else:
            b0, d, b1 = base, base + 1, base + 2
            system.addParticle(48.0 - 0.4)   # central bead
            system.addParticle(0.4)          # Drude
            system.addParticle(38.8)         # satellite bead
            q_d = _qd(alpha_bf4)
            nonbonded.addParticle(-0.6 - q_d, 0.42, 1.5)
            nonbonded.addParticle(q_d, 1.0, 0.0)
            nonbonded.addParticle(-0.4, 0.38, 1.0)
            atoms = (b0, d, b1)
            for a in atoms:
                for b in atoms:
                    if a < b:
                        nonbonded.addException(a, b, 0, 1, 0)
            bonds.addBond(b0, b1, 0.30, 90000.0)
            drude.addParticle(d, b0, -1, -1, -1, q_d, alpha_bf4, 1, 1)
            anion_atoms.extend(atoms)
            positions.append(np.array([origin, origin,
                                       origin + [0.30, 0, 0]]))
    if add_cm_motion:
        system.addForce(CMMotionRemover())
    return (system, np.concatenate(positions, axis=0), cation_atoms,
            anion_atoms)


def make_tgnh_integrator(cation_atoms, anion_atoms, n_atoms,
                         temperature=400.0, drude_temperature=1.0,
                         step_size=0.001):
    """The paper's TGNH setup: the cations in bath 0, the anions in bath
    1, then the molecular-COM bath and the Drude bath."""
    from ..app.integrator import DrudeTGNHIntegrator
    integ = DrudeTGNHIntegrator(temperature, 0.1, drude_temperature, 0.1,
                                step_size, 20)
    integ.addTempGroup()
    integ.addTempGroup()
    for _ in range(n_atoms):
        integ.addParticleTempGroup(0)
    for i in cation_atoms:
        integ.setParticleTempGroup(i, 0)
    for i in anion_atoms:
        integ.setParticleTempGroup(i, 1)
    return integ
