"""openmm_drudenose_tpu_torch — the PyTorch/CUDA port of the Drude TGNH
engine, beside the JAX package it is held against.

The main path: build a System (io/builders.build_water_box gives the
SWM4-NDP benchmark water), bind a DrudeTGNHIntegrator into a Context and
step it.  The direct-space sweep runs in a hand-written CUDA kernel
(ops/sweep.py, csrc/sweep.cu); everything else is plain PyTorch.  Entry
points run on CUDA unless the caller passes device="cpu".

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
from .app.integrator import DrudeTGNHIntegrator
from .forces.cmmotion import CMMotionRemover
from .forces.drude import DrudeForce
from .forces.nonbonded import NonbondedForce
from .system import System, ThreeParticleAverageSite, TwoParticleAverageSite
from .units import BOLTZ, ONE_4PI_EPS0

__all__ = [
    "System", "TwoParticleAverageSite", "ThreeParticleAverageSite",
    "DrudeForce", "NonbondedForce", "CMMotionRemover",
    "DrudeTGNHIntegrator", "Context", "State", "BOLTZ", "ONE_4PI_EPS0",
]
