"""The reference's example workflow through the force-field XML path:

    PDBFile -> ForceField(xml) -> Modeller.addExtraParticles ->
    createSystem(PME, HBonds, rigidWater) -> Drude mass repartition ->
    MonteCarloBarostat -> DrudeTGNHIntegrator -> minimize -> NPT

(the shape of the reference plugin's example/nacl_tg.py, and of the JAX
package's examples/nacl_tg_ff.py), through the PyTorch port.

    python3 -m openmm_drudenose_tpu_torch.examples.nacl_tg_ff \\
        [ffxml] [pdb] [n_steps]

Runs on the CUDA card (main(..., device="cpu") runs it on the CPU).  The
force field defaults to tests/data/swm4_nacl.xml (SWM4-NDP water and the
Yu 2010 Na+/Cl- Drude ions, with NBFIX and NBTHOLE).  CHARMM's
charmm_polar_2013.xml ships with OpenMM installations, not with this
repository: pass its path.  Without a PDB the module generates the
example's box (io/builders.build_nacl_water_box: 492 waters, 10 Na+,
10 Cl-), writes it as a PDB of bare residues (OH2/H1/H2, SOD, CLA) under
build/nacl_tg_ff/ and reads that back, so the whole ingestion path runs.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu_torch.app import (ForceField, HBonds, Modeller,
                                            PDBFile, PME)
from openmm_drudenose_tpu_torch.io import builders, pdbfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FFXML = os.path.join(ROOT, "tests", "data", "swm4_nacl.xml")
WATER_NAMES = ("OH2", "H1", "H2", "OM", "DOH2")
# the builder's water order (O, Drude, H1, H2, M) in the PDB's order
WATER_ORDER = (0, 2, 3, 4, 1)


def write_nacl_pdbs(system, positions, bare_path, pos_path=None):
    """Write a build_nacl_water_box system as PDB files: `bare_path` with
    bare residues (HOH as OH2/H1/H2, SOD, CLA), and `pos_path` (if given)
    with the Drudes and M sites as io/nacl.load_nacl_swm4 reads them
    (OH2/H1/H2/OM/DOH2, SOD/DSOD, CLA/DCLA).  Residue numbers and serials
    wrap as io/pdbfile.py writes them."""
    bare_atoms, bare_pos, atoms, pos = [], [], [], []
    positions = np.asarray(positions, np.float64)
    i, res, n = 0, 0, system.getNumParticles()
    while i < n:
        res += 1
        if i + 4 < n and system.isVirtualSite(i + 4):
            for k, name in zip(WATER_ORDER, WATER_NAMES):
                atoms.append(pdbfile.PDBAtom(0, name, "HOH", "A", res, ""))
                pos.append(positions[i + k])
                if name in WATER_NAMES[:3]:
                    bare_atoms.append(atoms[-1])
                    bare_pos.append(positions[i + k])
            i += 5
        else:
            # an ion: core then Drude; Cl- is the heavier core
            name = "CLA" if system.getParticleMass(i) > 30.0 else "SOD"
            atoms += [pdbfile.PDBAtom(0, name, name, "A", res, ""),
                      pdbfile.PDBAtom(0, "D" + name, name, "A", res, "")]
            pos += [positions[i], positions[i + 1]]
            bare_atoms.append(atoms[-2])
            bare_pos.append(positions[i])
            i += 2
    box = np.diagonal(np.array(system.getDefaultPeriodicBoxVectors()))
    pdbfile.write_pdb(bare_path, np.array(bare_pos),
                      pdbfile.PDBTopology(bare_atoms), box)
    if pos_path is not None:
        pdbfile.write_pdb(pos_path, np.array(pos),
                          pdbfile.PDBTopology(atoms), box)


def repartition(system, topology):
    """The reference example's Drude mass repartition
    (example/nacl_tg.py:49-53): 0.4 Da from each heavy parent to its
    Drude (a CHARMM deck leaves the Drudes massless)."""
    for i, atom in enumerate(topology.atoms):
        if system.getParticleMass(i) > 1.1:
            system.setParticleMass(i, system.getParticleMass(i) - 0.4)
        if atom.name.startswith("D"):
            system.setParticleMass(i, 0.4)


def build(ffxml, pdb_path, cutoff=1.0, rigid_water=True,
          switch_distance=None):
    """(system, modeller, host seconds of each stage): the PDB read,
    Modeller.addExtraParticles and createSystem (the LJ switched from
    switch_distance where given), then the repartition."""
    t = time.perf_counter()
    pdb = PDBFile(pdb_path)
    t_pdb = time.perf_counter()
    forcefield = ForceField(ffxml)
    modeller = Modeller(pdb.topology, pdb.positions)
    modeller.addExtraParticles(forcefield)
    t_mod = time.perf_counter()
    switch = ({} if switch_distance is None
              else {"switchDistance": switch_distance})
    system = forcefield.createSystem(modeller.topology, nonbondedMethod=PME,
                                     nonbondedCutoff=cutoff,
                                     constraints=HBonds,
                                     rigidWater=rigid_water, **switch)
    t_sys = time.perf_counter()
    repartition(system, modeller.topology)
    return system, modeller, {"pdb": t_pdb - t, "modeller": t_mod - t_pdb,
                              "createSystem": t_sys - t_mod}


def generated_pdb(n_water=492, n_na=10, n_cl=10):
    """The example's generated box as a bare PDB under build/nacl_tg_ff/;
    returns its path."""
    system, positions = builders.build_nacl_water_box(n_water, n_na, n_cl)
    path = os.path.join(ROOT, "build", "nacl_tg_ff",
                        f"nacl_{n_water}_{n_na}_{n_cl}.pdb")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_nacl_pdbs(system, positions, path)
    return path


def main(ffxml=None, pdb=None, n_steps: int = 2000, device=None,
         report_every=None, out=None, min_iterations: int = 200):
    out = out or sys.stdout
    ffxml = ffxml or FFXML
    if pdb is None:
        pdb = generated_pdb()
        print(f"no PDB given; generated {pdb}")
    system, modeller, seconds = build(ffxml, pdb)
    print(f"{system.getNumParticles()} atoms, {system.getNumConstraints()} "
          f"constraints; ingestion (s): " + ", ".join(
              f"{k} {v:.2f}" for k, v in seconds.items()))

    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20)
    integ.setMaxDrudeDistance(0.02)
    system.addForce(dt.MonteCarloBarostat(1.0, 300.0))

    sim = dt.Simulation(modeller.topology, system, integ,
                        precision="single", device=device)
    sim.context.setPositions(modeller.positions)
    print("minimizing...")
    sim.minimizeEnergy(maxIterations=min_iterations)
    sim.context.setVelocitiesToTemperature(300.0)
    sim.reporters.append(dt.StateDataReporter(
        out, report_every or max(1, n_steps // 10), step=True,
        potentialEnergy=True, temperature=True, density=True, speed=True,
        groupTemperatures=True))
    print("simulating...")
    t0 = time.time()
    sim.step(n_steps)
    elapsed = time.time() - t0
    pe = sim.context.getState(energy=True).getPotentialEnergy()
    print(f"done: PE {pe:.1f} kJ/mol; {n_steps} steps in {elapsed:.1f} s")
    return sim


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None,
         sys.argv[2] if len(sys.argv) > 2 else None,
         int(sys.argv[3]) if len(sys.argv) > 3 else 2000)
