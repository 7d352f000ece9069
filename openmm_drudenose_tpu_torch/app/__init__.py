"""App layer: the OpenMM-shaped user API (ForceField and Modeller, PDB
input, Context, Simulation and its reporters, XML and checkpoints)."""

from .forcefield import (AllBonds, CutoffPeriodic, ForceField,
                         ForceFieldError, HBonds, Modeller, NoCutoff, PME)
from ..io.pdbfile import PDBFile

__all__ = ["ForceField", "ForceFieldError", "Modeller", "PDBFile",
           "NoCutoff", "CutoffPeriodic", "PME", "HBonds", "AllBonds"]
