"""The reference's bundled NaCl(aq)/SWM4-NDP example system built from
its PDB layout (example/nacl_1m_pos.pdb: HOH residues as OH2/H1/H2/OM/
DOH2, SOD/CLA ions with DSOD/DCLA Drude shells), with typed parameters in
code, as the JAX package's io/nacl.py::load_nacl_swm4 builds it (the
reference assembles it through OpenMM's ForceField and
charmm_polar_2013.xml):

  * SWM4-NDP water (Lamoureux et al., Chem. Phys. Lett. 2006): q_D =
    -1.71636, q_H = 0.55733, q_M = -1.11466, O LJ eps = 0.21094 kcal/mol,
    Rmin/2 = 1.78693 A, O-H 0.09572 nm and H-H 0.15139 nm constraints,
    the M site at r_OM = 0.24034 A, k_D = 1000 kcal/mol/A^2.
  * the Na+/Cl- Drude ion model (Yu et al., JCTC 2010): alpha_Na =
    0.157 A^3, alpha_Cl = 3.969 A^3, LJ below.
  * Drude masses of 0.4 Da taken off the parent.

NBFIX pair-specific LJ (NonbondedForce.addLJPairOverride) and NBTHOLE
screening between ions (DrudeForce.addNBTholePair) are applied from the
tables passed as nbfix= / nbthole= (keyed by residue-name pairs); their
values live in charmm_polar_2013.xml, which is not bundled.
"""

from __future__ import annotations

import numpy as np

from ..forces.cmmotion import CMMotionRemover
from ..forces.drude import DrudeForce
from ..forces.nonbonded import NonbondedForce
from ..system import System, ThreeParticleAverageSite
from ..units import KCAL_PER_MOL, ONE_4PI_EPS0
from . import pdbfile
from .builders import SWM4_M_W1, SWM4_M_W23

# force constant of all CHARMM Drude bonds: 1000 kcal/mol/A^2
K_DRUDE = 1000 * KCAL_PER_MOL * 100  # kJ/mol/nm^2


def _alpha_from_qd(q_d: float) -> float:
    return ONE_4PI_EPS0 * q_d * q_d / K_DRUDE


def _qd_from_alpha(alpha_nm3: float) -> float:
    return -np.sqrt(alpha_nm3 * K_DRUDE / ONE_4PI_EPS0)


def _sigma_from_rmin2(rmin2_angstrom: float) -> float:
    return 2.0 * rmin2_angstrom * 0.1 / 2.0 ** (1.0 / 6.0)


SWM4 = {
    "q_d": -1.71636, "q_h": 0.55733, "q_m": -1.11466,
    "sigma_o": _sigma_from_rmin2(1.78693),
    "eps_o": 0.21094 * KCAL_PER_MOL,
    "d_oh": 0.09572, "d_hh": 0.15139,
    # the SWM4-NDP M placement, r_OM = 0.24034 A
    "m_w1": SWM4_M_W1, "m_w23": SWM4_M_W23,
    "mass_o": 15.9994, "mass_h": 1.008, "mass_d": 0.4,
}

IONS = {
    # name: (charge, alpha A^3, Rmin/2 A, eps kcal/mol, mass)
    "SOD": (1.0, 0.157, 1.461, 0.0315, 22.98977),
    "CLA": (-1.0, 3.969, 2.07, 0.071, 35.45327),
}


def load_nacl_swm4(pdb_path: str, cutoff: float = 1.0,
                   nonbonded_method: int = NonbondedForce.PME,
                   ewald_tol: float = 5e-4, add_cm_motion: bool = True,
                   nbfix: dict | None = None, nbthole: dict | None = None):
    """Returns (system, positions, topology).  Expects the Drude-including
    position file (nacl_1m_pos.pdb layout).

    nbfix   : {("SOD", "CLA"): (rmin_angstrom, eps_kcal), ...} pair-specific
              LJ overrides between ion cores (CHARMM NBFIX; values from
              charmm_polar_2013.xml).
    nbthole : {("SOD", "CLA"): a_thole, ...} pair-specific Thole screening
              between ion Drude pairs (CHARMM NBTHOLE)."""
    pdb = pdbfile.PDBFile(pdb_path)
    atoms = pdb.topology.atoms
    positions = pdb.positions

    system = System()
    nonbonded = NonbondedForce()
    drude = DrudeForce()
    system.addForce(nonbonded)
    system.addForce(drude)
    if pdb.box is not None:
        b = np.diagonal(pdb.box)
        system.setDefaultPeriodicBoxVectors((b[0], 0, 0), (0, b[1], 0),
                                            (0, 0, b[2]))
    nonbonded.setNonbondedMethod(nonbonded_method)
    nonbonded.setCutoffDistance(cutoff)
    nonbonded.setEwaldErrorTolerance(ewald_tol)

    i = 0
    n = len(atoms)
    w = SWM4
    while i < n:
        res = atoms[i].res_name
        if res == "HOH":
            names = [atoms[i + k].name for k in range(5)]
            if names != ["OH2", "H1", "H2", "OM", "DOH2"]:
                raise ValueError(f"unexpected SWM4 atom order at {i}: {names}")
            o, h1, h2, m, d = i, i + 1, i + 2, i + 3, i + 4
            system.addParticle(w["mass_o"] - w["mass_d"])  # O
            system.addParticle(w["mass_h"])
            system.addParticle(w["mass_h"])
            system.addParticle(0.0)                         # M virtual
            system.addParticle(w["mass_d"])                 # Drude
            nonbonded.addParticle(-w["q_d"], w["sigma_o"], w["eps_o"])
            nonbonded.addParticle(w["q_h"], 1.0, 0.0)
            nonbonded.addParticle(w["q_h"], 1.0, 0.0)
            nonbonded.addParticle(w["q_m"], 1.0, 0.0)
            nonbonded.addParticle(w["q_d"], 1.0, 0.0)
            for a in range(5):
                for b2 in range(a):
                    nonbonded.addException(i + a, i + b2, 0, 1, 0)
            system.addConstraint(o, h1, w["d_oh"])
            system.addConstraint(o, h2, w["d_oh"])
            system.addConstraint(h1, h2, w["d_hh"])
            system.setVirtualSite(m, ThreeParticleAverageSite(
                o, h1, h2, w["m_w1"], w["m_w23"], w["m_w23"]))
            drude.addParticle(d, o, -1, -1, -1, w["q_d"],
                              _alpha_from_qd(w["q_d"]), 1, 1)
            i += 5
        elif res in IONS:
            q, alpha_a3, rmin2, eps_kcal, mass = IONS[res]
            alpha = alpha_a3 * 1e-3  # A^3 -> nm^3
            q_d = _qd_from_alpha(alpha)
            core, shell = i, i + 1
            if atoms[shell].name[0] != "D":
                raise ValueError(f"expected Drude shell after ion at {i}")
            system.addParticle(mass - 0.4)
            system.addParticle(0.4)
            nonbonded.addParticle(q - q_d, _sigma_from_rmin2(rmin2),
                                  eps_kcal * KCAL_PER_MOL)
            nonbonded.addParticle(q_d, 1.0, 0.0)
            nonbonded.addException(core, shell, 0, 1, 0)
            drude.addParticle(shell, core, -1, -1, -1, q_d, alpha, 1, 1)
            i += 2
        else:
            raise ValueError(f"unknown residue {res!r} at atom {i}")
    # NBFIX / NBTHOLE between ion species (pair tables keyed by residue
    # names, order-insensitive)
    if nbfix or nbthole:
        cores_by_res: dict[str, list[int]] = {}
        drude_rows_by_res: dict[str, list[int]] = {}
        row = 0
        k = 0
        while k < len(atoms):
            res = atoms[k].res_name
            if res == "HOH":
                row += 1  # one Drude pair per water
                k += 5
            elif res in IONS:
                cores_by_res.setdefault(res, []).append(k)
                drude_rows_by_res.setdefault(res, []).append(row)
                row += 1
                k += 2
            else:
                k += 1
        for (ra, rb), val in (nbfix or {}).items():
            rmin_a, eps_kcal = val
            nonbonded.addLJPairOverride(
                cores_by_res.get(ra, []), cores_by_res.get(rb, []),
                _sigma_from_rmin2(rmin_a / 2.0), eps_kcal * KCAL_PER_MOL)
        for (ra, rb), a_thole in (nbthole or {}).items():
            for i in drude_rows_by_res.get(ra, []):
                for j in drude_rows_by_res.get(rb, []):
                    if i < j or ra != rb:
                        drude.addNBTholePair(i, j, a_thole)
    if add_cm_motion:
        system.addForce(CMMotionRemover())
    return system, positions, pdb.topology
