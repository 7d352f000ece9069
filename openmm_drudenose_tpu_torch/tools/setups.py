"""Shared set-ups of the tools and of chip_smoke.py.

`bench_context` builds the 100k bench Context (the JAX package's
bench.py:61-72 configuration): build_water_box(20000), 100,000 atoms of
SWM4-NDP water, PME at 1.0 nm on cell pairs, DrudeTGNHIntegrator(300,
0.1, 1, 0.1, 0.001, 20, 1) with a 0.02 nm hard wall, single precision,
the cell capacity pinned from data/bench_equil_100k.npz, started from
that snapshot's positions and velocities.
"""

from __future__ import annotations

import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_SNAPSHOT = os.path.join(ROOT, "data", "bench_equil_100k.npz")


def bench_integrator():
    """DrudeTGNHIntegrator(300, 0.1, 1, 0.1, 0.001, 20, 1), 0.02 nm wall:
    300 K baths of 0.1 ps, a 1 K Drude bath of 0.1 ps, 1 fs steps, 20
    Drude substeps, one chain link."""
    import openmm_drudenose_tpu_torch as dt
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    return integ


def bench_context(device=None, precision: str = "single",
                  capacity: int | None = None, nb_options: dict | None = None,
                  snapshot: str = BENCH_SNAPSHOT, barostat=None):
    """(Context, integrator) of the 100k bench configuration on `device`
    (CUDA unless the caller passes another), at the snapshot's positions
    and velocities.  capacity: the cell capacity (default the
    snapshot's); nb_options: further nonbonded options
    ({"grid_x_multiple": D} for x-slabs over D ranks); barostat: a force
    to add (a MonteCarloBarostat)."""
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.io import builders
    snap = np.load(snapshot)
    system, _ = builders.build_water_box(int(snap["n_atoms"]) // 5)
    if barostat is not None:
        system.addForce(barostat)
    integ = bench_integrator()
    opts = {"capacity": int(snap["capacity"] if capacity is None
                            else capacity)}
    opts.update(nb_options or {})
    ctx = dt.Context(system, integ, precision=precision, device=device,
                     nb_options=opts)
    ctx.setPositions(np.asarray(snap["positions"], np.float64))
    ctx.setVelocities(np.asarray(snap["velocities"], np.float64))
    return ctx, integ
