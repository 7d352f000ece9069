"""The JAX package's NPT density pins (tests/test_npt_density.py) on the
port, on the CPU in f64, at their sizes and bands: SWM4-NDP water under
the Monte Carlo barostat in one Context (64 waters, dense strategy) and
in a flat ensemble of two replicas (200 waters each, cell pairs, one box
scale a replica).  Slow, as there; the on-card runs at the JAX chip
sizes are tools/validate_npt.py and tools/validate_flatnpt.py.  And the
pin of ROADMAP.md C22: the JAX single-box density takes 18.0154 g/mol a
molecule where its water box holds 18.0 amu."""

import os

import numpy as np
import pytest
import torch

import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu_torch.io import builders
from openmm_drudenose_tpu_torch.tools import validate_npt
from openmm_drudenose_tpu_torch.parallel.flatrep import FlatReplicaEnsemble


def _integrator():
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    return integ


@pytest.mark.slow
def test_swm4_npt_density():
    n_mol = 64
    system, positions = builders.build_water_box(n_mol, cutoff=0.58)
    system.addForce(dt.MonteCarloBarostat(1.01325, 300.0, 25))
    integ = _integrator()
    ctx = dt.Context(system, integ, precision="double", strategy="dense",
                     device="cpu")
    ctx.setPositions(positions)
    ctx.setVelocitiesToTemperature(300.0, seed=2)
    integ.step(6000)  # equilibrate
    mass_g = n_mol * 18.0154 / 6.02214076e23
    dens, pe = [], []
    for _ in range(16):
        integ.step(500)
        box = ctx._state.box.double().numpy()
        dens.append(mass_g / (np.prod(np.diagonal(box)) * 1e-21))
        pe.append(ctx.getState(energy=True).getPotentialEnergy() / n_mol)
    rho, u = float(np.mean(dens)), float(np.mean(pe))
    # the JAX wide bands: 64 molecules, ~8 ps sampling
    assert 0.90 < rho < 1.08, (rho, dens)
    assert -50.0 < u < -33.0, (u, pe)


@pytest.mark.slow
def test_flat_ensemble_npt_density():
    """Each replica's box relaxes to liquid density on its own."""
    n_mol = 200
    system, positions = builders.build_water_box(
        n_mol, method=dt.NonbondedForce.PME, cutoff=0.55)
    system.addForce(dt.MonteCarloBarostat(1.01325, 300.0, 25))
    ctx = dt.Context(system, _integrator(), precision="double",
                     strategy="cellpair", device="cpu")
    ctx.setPositions(positions)
    ens = FlatReplicaEnsemble(ctx, 2, rx=2, rz=1)
    ens.setVelocitiesToTemperature(300.0, seed=2)
    ens.step(1200)
    dens = []
    for _ in range(4):
        ens.step(300)
        dens.append(ens.densities())
    dens = np.array(dens)              # (4, 2)
    rho = dens.mean(axis=0)
    s = ens.context._state.rep_scale.double().numpy()
    assert np.all(np.isfinite(dens)), dens
    assert np.all((0.88 < rho) & (rho < 1.10)), (rho, dens)
    # both replicas' boxes moved off the template (the lattice start is
    # under-dense, so accepted moves must have fired)
    assert np.all(np.abs(s - 1.0) > 1e-4), s
    assert torch.all(torch.isfinite(ens.context._state.positions))


def test_jax_npt_density_mass_is_not_the_systems():
    """C22: scripts/validate_npt_tpu.py (and tests/test_npt_density.py)
    divide 18.0154 g/mol a molecule by the volume, but build_water_box's
    SWM4-NDP sites weigh 15.6 + 0.4 + 2 x 1.0 + 0 = 18.0 amu, so its
    density reads 0.086% above the simulated box's; the flat-ensemble
    script (FlatReplicaEnsemble.densities) takes the system's mass.  The
    port's validate_npt keeps the JAX script's mass, so its number
    compares with the JAX one."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    system, _ = jbuilders.build_water_box(500)
    amu = sum(system.getParticleMass(i)
              for i in range(system.getNumParticles())) / 500
    assert amu == pytest.approx(18.0, abs=1e-12)
    with open(os.path.join(root, "scripts", "validate_npt_tpu.py")) as f:
        assert "n_mol * 18.0154 / 6.02214076e23" in f.read()
    assert validate_npt.WATER_AMU == 18.0154
    assert 18.0154 / amu - 1.0 == pytest.approx(8.56e-4, abs=1e-6)
