"""The Context options and state edits of the PyTorch port against the
JAX package on the CPU: precision="mixed" (float32 state, float64 chain
and KE) for 20 steps; hardwall_strict=True raising on a runaway;
applyConstraints (Jacobi SHAKE from the current directions) and
applyVelocityConstraints (1e-10); setPeriodicBoxVectors (its
minimum-image check, the orthorhombic-to-triclinic refusal, a triclinic
change reduced and its energy); reinitialize(preserveState=True); and
getState's enforcePeriodicBox and OpenMM keyword spellings.  The JAX
package's float32 precisions fail under jax_enable_x64 (which its tests
set) wherever a NonbondedForce is present, so the mixed-precision parity
runs on polarizable waters without one (ROADMAP.md, Queue C)."""

import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from torch_threads import _one_thread  # noqa: F401


def _pair(precision, nonbonded=True, n_mol=64):
    out = []
    for pkg, b, kw in ((dn, jbuilders, {}), (dt, tbuilders,
                                            {"device": "cpu"})):
        system, pos = b.build_water_box(n_mol, cutoff=0.5)
        if not nonbonded:
            system.removeForce(0)
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        integ.setMaxDrudeDistance(0.02)
        ctx = pkg.Context(system, integ, precision=precision, **kw)
        ctx.setPositions(pos)
        out.append((ctx, integ))
    return out, pos


def test_mixed_precision_matches_jax():
    """20 steps in mixed precision, 7.3 nm from the origin: positions to
    4 float32 ulps there, bath temperatures to 1e-5, the chain in
    float64."""
    ((jctx, jint), (tctx, tint)), pos = _pair("mixed", nonbonded=False)
    vel = np.random.default_rng(9).normal(0.0, 0.3, pos.shape)
    for ctx, integ in ((jctx, jint), (tctx, tint)):
        ctx.setPositions(pos + 7.3)
        ctx.setVelocities(vel)
        integ.step(20)
    assert tctx._state.positions.dtype == torch.float32
    assert tctx._state.eta.dtype == torch.float64
    assert tctx._state.pos_err is not None
    js = jctx.getState(positions=True, groups=True)
    ts = tctx.getState(positions=True, groups=True)
    np.testing.assert_allclose(ts.getPositions(), js.getPositions(),
                               rtol=0, atol=4 * 4.8e-7)
    np.testing.assert_allclose(ts.getGroupTemperatures(),
                               js.getGroupTemperatures(), rtol=1e-5)
    np.testing.assert_allclose(tctx._state.eta.numpy(),
                               np.asarray(jctx._state.eta), rtol=1e-5,
                               atol=1e-12)


def test_jax_f32_nonbonded_fails_under_x64():
    """The JAX package's fault this file works around: with
    jax_enable_x64 on, a float32 precision with a NonbondedForce stops in
    value_and_grad (float32 and float64 cotangents added); the port's
    runs."""
    ((jctx, _), (tctx, _)), _ = _pair("mixed")
    with pytest.raises(AssertionError):
        jctx.getState(energy=True)
    assert np.isfinite(tctx.getState(energy=True).getPotentialEnergy())


def _pair_system(pkg):
    system = pkg.System()
    system.addParticle(1.0)
    system.addParticle(0.1)
    k = pkg.ONE_4PI_EPS0 * 1.5
    drude = pkg.DrudeForce()
    drude.addParticle(1, 0, -1, -1, -1, 0.1, pkg.ONE_4PI_EPS0 * 0.01 / k,
                      1, 1)
    system.addForce(drude)
    return system


def test_hardwall_strict_raises():
    """A Drude started 0.1 nm from its core, past twice the 0.02 nm wall:
    hardwall_strict raises (and clears the latch, so a recovered state
    runs on); the default warns once and latches."""
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 10.0, 0.005, 0.001, 20, 2,
                                   False)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(_pair_system(dt), integ, precision="double",
                     hardwall_strict=True, device="cpu")
    ctx.setPositions([[0, 0, 0], [0, 0, 0.1]])
    ctx.setVelocities([[0, 0, 0], [0, 0, 0]])
    with pytest.raises(RuntimeError, match="hard wall"):
        integ.step(5)
    ctx.setPositions([[0, 0, 0], [0, 0, 0.01]])
    ctx.setVelocities([[1, 0, 0], [1, 0, 0.01]])
    integ.step(5)
    assert not ctx.hardwallRunaway
    integ2 = dt.DrudeTGNHIntegrator(300.0, 0.1, 10.0, 0.005, 0.001, 20, 2,
                                    False)
    integ2.setMaxDrudeDistance(0.02)
    ctx2 = dt.Context(_pair_system(dt), integ2, precision="double",
                      device="cpu")
    ctx2.setPositions([[0, 0, 0], [0, 0, 0.1]])
    ctx2.setVelocities([[0, 0, 0], [0, 0, 0]])
    with pytest.warns(RuntimeWarning, match="hard wall"):
        integ2.step(5)
    assert ctx2.hardwallRunaway


def test_apply_constraints_match_jax():
    """Positions and velocities perturbed off the constraints: both
    projections against the JAX package's (1e-10), and the constraint
    distances met to the tolerance."""
    ((jctx, _), (tctx, _)), pos = _pair("double")
    rng = np.random.default_rng(5)
    p = pos + rng.uniform(-0.005, 0.005, pos.shape)
    v = rng.normal(0.0, 0.5, pos.shape)
    for ctx in (jctx, tctx):
        ctx.setPositions(p)
        ctx.setVelocities(v)
        ctx.applyConstraints(1e-10)
        ctx.applyVelocityConstraints(1e-10)
    js = jctx.getState(positions=True, velocities=True)
    ts = tctx.getState(positions=True, velocities=True)
    np.testing.assert_allclose(ts.getPositions(), js.getPositions(),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(ts.getVelocities(), js.getVelocities(),
                               rtol=0, atol=1e-10)
    system = tctx.getSystem()
    q = ts.getPositions()
    for c in range(system.getNumConstraints()):
        i, j, d = system.getConstraintParameters(c)
        assert abs(np.linalg.norm(q[i] - q[j]) - d) < 1e-8


def test_set_periodic_box_vectors():
    """An orthorhombic Context: a box too small for the cutoff and a
    triclinic box are refused, both with the JAX package's messages; a
    larger orthorhombic box is taken.  A triclinic Context takes another
    triclinic box, reduced as the JAX package reduces it, with the same
    energy there."""
    ((jctx, _), (tctx, _)), _ = _pair("double")
    box = tctx.getState().getPeriodicBoxVectors()
    w = box[0, 0]
    for ctx in (jctx, tctx):
        with pytest.raises(ValueError, match="half the smallest"):
            ctx.setPeriodicBoxVectors((0.9, 0, 0), (0, w, 0), (0, 0, w))
        with pytest.raises(ValueError, match="orthorhombic context to a "
                                             "triclinic box"):
            ctx.setPeriodicBoxVectors((w, 0, 0), (0.1, w, 0), (0, 0, w))
    tctx.setPeriodicBoxVectors((1.1 * w, 0, 0), (0, w, 0), (0, 0, w))
    np.testing.assert_allclose(
        np.diagonal(tctx.getState().getPeriodicBoxVectors()),
        [1.1 * w, w, w])
    assert np.isfinite(tctx.getState(energy=True).getPotentialEnergy())

    out = []
    for pkg, b, kw in ((dn, jbuilders, {}), (dt, tbuilders,
                                            {"device": "cpu"})):
        system, pos = b.build_water_box(64, cutoff=0.5)
        system.setDefaultPeriodicBoxVectors(
            (w, 0, 0), (0.2 * w, w, 0), (0.1 * w, 0.15 * w, w))
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        ctx = pkg.Context(system, integ, precision="double", **kw)
        ctx.setPositions(pos)
        # an unreduced cell of another shear: reduced on the way in
        ctx.setPeriodicBoxVectors((1.05 * w, 0, 0), (0.8 * w, w, 0),
                                  (-0.6 * w, 0.7 * w, 1.02 * w))
        out.append(ctx.getState(energy=True))
    js, ts = out
    want = np.array([[1.05 * w, 0, 0], [-0.25 * w, w, 0],
                     [-0.35 * w, -0.3 * w, 1.02 * w]])
    np.testing.assert_allclose(ts.getPeriodicBoxVectors(), want, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(ts.getPeriodicBoxVectors(),
                               np.asarray(js.getPeriodicBoxVectors()),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(ts.getPotentialEnergy(),
                               js.getPotentialEnergy(), rtol=1e-10)


def test_reinitialize_preserves_state():
    ((_, _), (tctx, tint)), _ = _pair("double")
    tctx.setVelocitiesToTemperature(300.0, seed=1)
    tint.step(10)
    before = tctx.getState(positions=True, velocities=True)
    eta = tctx._state.eta.clone()
    tint.setDrudeStepsPerRealStep(10)
    tctx.reinitialize(preserveState=True)
    after = tctx.getState(positions=True, velocities=True)
    np.testing.assert_array_equal(after.getPositions(),
                                  before.getPositions())
    np.testing.assert_array_equal(after.getVelocities(),
                                  before.getVelocities())
    assert torch.equal(tctx._state.eta, eta)
    assert tctx._static.drude_steps == 10
    assert tctx._state.step == 10
    tint.step(5)
    assert np.isfinite(tctx.getState(energy=True).getPotentialEnergy())


def test_enforce_periodic_box_matches_jax():
    """Whole molecules wrapped by their centres' images, and OpenMM's
    keyword spellings, against the JAX package."""
    ((jctx, _), (tctx, _)), pos = _pair("double")
    box = np.diagonal(tctx.getState().getPeriodicBoxVectors())
    shift = np.random.default_rng(2).integers(-2, 3, (pos.shape[0] // 5, 3))
    p = pos + np.repeat(shift, 5, axis=0) * box
    for ctx in (jctx, tctx):
        ctx.setPositions(p)
    js = jctx.getState(positions=True, enforcePeriodicBox=True)
    ts = tctx.getState(getPositions=True, enforcePeriodicBox=True)
    np.testing.assert_allclose(ts.getPositions(), js.getPositions(),
                               rtol=0, atol=1e-12)
    q = ts.getPositions().reshape(-1, 5, 3)
    centers = q.mean(axis=1)
    assert np.all((centers >= 0) & (centers < box))
    raw = tctx.getState(getPositions=True).getPositions()
    np.testing.assert_allclose(raw[::5], p[::5], rtol=0, atol=1e-12)
