"""The JAX package's statistical physics pins (tests/test_physics.py) on
the port, on the CPU in f64: the mixed-DOF temperature of an SWM4-NDP
box (the fast +-20% smoke and the slow 5% version) and the TGNH
conserved quantity's drift along a water trajectory (2e-3); and the
conserved quantity sampled along one trajectory from the same start in
both packages (rtol 1e-9 a sample)."""

import numpy as np
import pytest

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
import util
from openmm_drudenose_tpu.app import serialization as jser
from openmm_drudenose_tpu_torch.app import serialization as tser
from openmm_drudenose_tpu_torch.units import BOLTZ
from torch_threads import _one_thread  # noqa: F401


def _water(grid_size):
    """tests/util.py's SWM4 box (the JAX System) and its port."""
    jsys, pos = util.swm4_water_box(grid_size=grid_size)
    return jsys, tser.deserialize_system(jser.serialize_system(jsys)), pos


def _mixed_temperature(system, n_mol, ke):
    n_std = 3 * 3 * n_mol - system.getNumConstraints() - 3
    n_dru = 3 * n_mol
    n_dof = n_std + n_dru
    expected = (n_std * 300.0 + n_dru * 1.0) / n_dof
    return ke / (0.5 * n_dof * BOLTZ), expected


def test_water_temperature_smoke():
    """The JAX fast-tier smoke: a 2x2x2 box sampled briefly, the mixed-DOF
    temperature within +-20% of its target."""
    _, system, positions = _water(2)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.05, 1.0, 0.005, 0.0005, 20, 5,
                                   False)
    integ.setMaxDrudeDistance(0.05)
    ctx = dt.Context(system, integ, precision="double", device="cpu")
    ctx.setPositions(positions)
    ctx.applyConstraints(1e-5)
    ctx.setVelocitiesToTemperature(300.0, seed=3)
    integ.step(1500)
    ke = 0.0
    n_samples = 1200
    for _ in range(n_samples):
        integ.step(2)
        ke += ctx.getState(energy=True).getKineticEnergy()
    got, expected = _mixed_temperature(system, 8, ke / n_samples)
    np.testing.assert_allclose(got, expected, rtol=0.20)


@pytest.mark.slow
def test_water_mixed_temperature():
    """The JAX slow pin (reference testWater, 3x3x3 molecules): the
    mixed-DOF temperature within 5%."""
    _, system, positions = _water(3)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005, 0.0005, 20, 10,
                                   False)
    integ.setMaxDrudeDistance(0.05)
    ctx = dt.Context(system, integ, precision="double", device="cpu")
    ctx.setPositions(positions)
    ctx.applyConstraints(1e-5)
    integ.step(6000)
    ke = 0.0
    n_samples = 4000
    for _ in range(n_samples):
        integ.step(1)
        ke += ctx.getState(energy=True).getKineticEnergy()
    got, expected = _mixed_temperature(system, 27, ke / n_samples)
    np.testing.assert_allclose(got, expected, rtol=0.05)


def _conserved_samples(pkg, system, positions, velocities=None):
    """The JAX test's trajectory: constraints applied, 200 K velocities
    (seed 3, or `velocities`), 200 settling steps, then the conserved
    energy every 50 steps, 10 times; steps of 50 (one JAX scan)."""
    integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005, 0.0005, 20, 3)
    integ.setMaxDrudeDistance(0.05)
    kw = {"device": "cpu"} if pkg is dt else {}
    ctx = pkg.Context(system, integ, precision="double", **kw)
    ctx.setPositions(positions)
    ctx.applyConstraints(1e-7)
    if velocities is None:
        ctx.setVelocitiesToTemperature(200.0, seed=3)
    else:
        ctx.setVelocities(velocities)
    ctx.applyVelocityConstraints(1e-10)
    for _ in range(4):
        integ.step(50)
    e0 = ctx.getConservedEnergy()
    samples = []
    for _ in range(10):
        integ.step(50)
        samples.append(ctx.getConservedEnergy())
    return e0, np.array(samples)


def test_conserved_energy_drift():
    """The JAX pin: the conserved quantity within 2e-3 of its value after
    the settling steps over 500 steps."""
    _, system, positions = _water(2)
    e0, samples = _conserved_samples(dt, system, positions)
    drift = np.max(np.abs(samples - e0)) / max(abs(e0), 1.0)
    assert drift < 2e-3, (e0, samples)


def test_conserved_energy_matches_jax():
    """Both packages from one start (the numpy-seeded velocities, each
    package's constraints applied): the conserved quantity at the end of
    the settling and at each of the 10 samples, rtol 1e-9."""
    jsys, tsys, positions = _water(2)
    v = np.random.default_rng(3).normal(0.0, 0.5, positions.shape)
    je0, jsamples = _conserved_samples(dn, jsys, positions, v)
    te0, tsamples = _conserved_samples(dt, tsys, positions, v)
    np.testing.assert_allclose(te0, je0, rtol=1e-9)
    np.testing.assert_allclose(tsamples, jsamples, rtol=1e-9)
    assert np.max(np.abs(tsamples - te0)) / max(abs(te0), 1.0) < 2e-3
