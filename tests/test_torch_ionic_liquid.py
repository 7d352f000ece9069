"""The ionic liquid (io/ionic_liquid.py) through the PyTorch port against
the JAX package: the same System from both builders; four baths (cation,
anion, molecular COM, Drude) with the JAX package's N k T; 50 steps in
f64 on the dense strategy from the same positions and velocities
(positions to 1e-9 nm); and an f64 cell-pair force pass on 4,200 atoms
(energy 1e-10 relative, forces 1e-8 of max|F|)."""

import numpy as np
import pytest

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.io import ionic_liquid as jil
from openmm_drudenose_tpu_torch.io import ionic_liquid as til
from torch_threads import _one_thread  # noqa: F401

RF = dt.NonbondedForce.CutoffPeriodic


def _builds(n_pairs):
    return (jil.build_ionic_liquid(n_pairs, method=RF, cutoff=1.2),
            til.build_ionic_liquid(n_pairs, method=RF, cutoff=1.2))


def _force(system, name):
    return next(f for f in system.getForces() if type(f).__name__ == name)


def test_builder_matches_jax():
    (js, jpos, jcat, jan), (ts, tpos, tcat, tan) = _builds(32)
    np.testing.assert_array_equal(tpos, jpos)
    assert (tcat, tan) == (jcat, jan)
    assert ts.getNumParticles() == js.getNumParticles() == 32 * 7
    assert [ts.getParticleMass(i) for i in range(ts.getNumParticles())] \
        == [js.getParticleMass(i) for i in range(js.getNumParticles())]
    np.testing.assert_array_equal(
        np.array(ts.getDefaultPeriodicBoxVectors()),
        np.array(js.getDefaultPeriodicBoxVectors()))
    assert [type(f).__name__ for f in ts.getForces()] \
        == [type(f).__name__ for f in js.getForces()]
    for name, attrs in (("NonbondedForce", ("_particles", "_exceptions")),
                        ("DrudeForce", ("_particles",)),
                        ("HarmonicBondForce", ("_bonds",)),
                        ("HarmonicAngleForce", ("_angles",))):
        for a in attrs:
            assert getattr(_force(ts, name), a) \
                == getattr(_force(js, name), a), (name, a)
    assert _force(ts, "NonbondedForce").getNonbondedMethod() == RF


def _contexts(n_pairs, precision="double", strategy="auto"):
    (js, pos, jcat, jan), (ts, _, tcat, tan) = _builds(n_pairs)
    out = []
    for pkg, mod, system, cat, an, kw in (
            (dn, jil, js, jcat, jan, {}),
            (dt, til, ts, tcat, tan, {"device": "cpu"})):
        integ = mod.make_tgnh_integrator(cat, an, system.getNumParticles())
        integ.setMaxDrudeDistance(0.05)
        ctx = pkg.Context(system, integ, precision=precision,
                          strategy=strategy, **kw)
        ctx.setPositions(pos)
        out.append((ctx, integ))
    return out, pos


def test_four_baths_match_jax():
    ((jctx, _), (tctx, _)), _ = _contexts(32)
    ref = np.asarray(jctx._spec.nh_nkbt)
    nkbt = tctx._spec.nh_nkbt.numpy()
    assert len(nkbt) == 4 and np.all(nkbt > 0)
    np.testing.assert_allclose(nkbt, ref, rtol=1e-12)


def test_fifty_steps_f64_dense_match_jax():
    """From the same relaxed positions (20 FIRE iterations of the port
    away from the lattice's overlaps) and the same 400 K velocities."""
    ((jctx, jint), (tctx, tint)), _ = _contexts(32)
    assert tctx._nb.strategy == "dense"
    tctx.minimizeEnergy(maxIterations=20)
    pos = tctx.getPositions()
    rng = np.random.default_rng(5)
    masses = np.array([tctx.getSystem().getParticleMass(i)
                       for i in range(len(pos))])
    vel = rng.normal(size=pos.shape) * np.sqrt(
        dt.BOLTZ * 400.0 / masses)[:, None]
    for ctx in (jctx, tctx):
        ctx.setPositions(pos)
        ctx.setVelocities(vel)
    jint.step(50)
    tint.step(50)
    np.testing.assert_allclose(tctx.getPositions(),
                               np.asarray(jctx.getPositions()),
                               rtol=0, atol=1e-9)
    temps = tctx.getState(groups=True).getGroupTemperatures()
    np.testing.assert_allclose(
        temps, jctx.getState(groups=True).getGroupTemperatures(),
        rtol=1e-8)


def test_cellpair_force_pass_f64_matches_jax():
    """build_ionic_liquid(600): 4,200 atoms (8^3 cells at the 1.2 nm
    cutoff), the cell-pair strategy in f64 on the lattice start."""
    ((jctx, _), (tctx, _)), _ = _contexts(600, strategy="cellpair")
    assert tctx._nb.strategy == "cellpair"
    out = []
    for ctx in (jctx, tctx):
        st = ctx.getState(energy=True, forces=True)
        out.append((st.getPotentialEnergy(), np.asarray(st.getForces())))
    (e_ref, f_ref), (e, f) = out
    np.testing.assert_allclose(e, e_ref, rtol=1e-10)
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())
