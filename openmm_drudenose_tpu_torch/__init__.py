"""openmm_drudenose_tpu_torch — the PyTorch/CUDA port of the Drude TGNH
engine, beside the JAX package it is held against.

The main path: build a System (io/builders.build_water_box gives the
SWM4-NDP benchmark water, build_nacl_water_box the reference example's
NaCl solution, io/ionic_liquid.build_ionic_liquid the coarse-grained
ionic liquid with per-ion temperature groups and io/polymer.
build_solvated_polymer the polarizable polymer in water), bind a
DrudeTGNHIntegrator into a Context (or a Simulation with its reporters)
and step it, with a MonteCarloBarostat for NPT; ReplicaEnsemble
(parallel/ensemble.py) and FlatReplicaEnsemble (parallel/flatrep.py)
run many replicas of a small box as one system.  The direct-space sweep of large systems and its energy run in
hand-written CUDA kernels (ops/sweep.py, ops/sweep_chunked.py, csrc/);
everything else is plain PyTorch.  Entry points run on CUDA unless the
caller passes device="cpu".

A System also comes from a force-field XML and a PDB, as the reference's
own workflow builds it (app/forcefield.py; examples/nacl_tg_ff.py):

    ff = dt.ForceField("tests/data/swm4_nacl.xml")
    pdb = dt.PDBFile("box.pdb")
    modeller = dt.Modeller(pdb.topology, pdb.positions)
    modeller.addExtraParticles(ff)
    system = ff.createSystem(modeller.topology, nonbondedMethod=PME,
                             nonbondedCutoff=1.0, constraints=HBonds)

with PME and HBonds from openmm_drudenose_tpu_torch.app.

    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.io.builders import build_water_box
    system, pos = build_water_box(20000)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision="single")
    ctx.setPositions(pos)
    integ.step(100)
"""

from .app.context import Context, State
from .app.forcefield import ForceField, Modeller
from .app.integrator import DrudeTGNHIntegrator
from .app.serialization import (XmlSerializer, deserialize_integrator,
                                deserialize_system, load_checkpoint,
                                save_checkpoint, serialize_integrator,
                                serialize_system)
from .app.simulation import (CheckpointReporter, DCDReporter, PDBReporter,
                             Simulation, StateDataReporter)
from .forces.bonded import (HarmonicAngleForce, HarmonicBondForce,
                            HarmonicTorsionForce, PeriodicTorsionForce)
from .forces.cmap import CMAPTorsionForce
from .forces.cmmotion import CMMotionRemover, MonteCarloBarostat
from .forces.custom import (CustomAngleForce, CustomBondForce,
                            CustomExternalForce, CustomNonbondedForce,
                            CustomTorsionForce)
from .forces.drude import DrudeForce
from .forces.nonbonded import NonbondedForce
from .io.pdbfile import PDBFile
from .parallel.ensemble import ReplicaEnsemble
from .parallel.flatrep import FlatReplicaEnsemble
from .system import (LocalCoordinatesSite, OutOfPlaneSite, System,
                     ThreeParticleAverageSite, TwoParticleAverageSite)
from .units import BOLTZ, ONE_4PI_EPS0

__all__ = [
    "System", "TwoParticleAverageSite", "ThreeParticleAverageSite",
    "OutOfPlaneSite", "LocalCoordinatesSite",
    "DrudeForce", "NonbondedForce", "CMMotionRemover", "MonteCarloBarostat",
    "HarmonicBondForce", "HarmonicAngleForce", "PeriodicTorsionForce",
    "HarmonicTorsionForce", "CMAPTorsionForce",
    "CustomBondForce", "CustomAngleForce", "CustomTorsionForce",
    "CustomNonbondedForce", "CustomExternalForce",
    "DrudeTGNHIntegrator", "Context", "State", "Simulation",
    "StateDataReporter", "CheckpointReporter", "DCDReporter",
    "PDBReporter", "ForceField", "Modeller",
    "PDBFile", "serialize_integrator", "deserialize_integrator",
    "serialize_system", "deserialize_system", "XmlSerializer",
    "save_checkpoint", "load_checkpoint", "ReplicaEnsemble",
    "FlatReplicaEnsemble", "BOLTZ",
    "ONE_4PI_EPS0",
]
