"""The slice as a whole: the PyTorch port's builder, spec and Context
against the JAX package's on the same SWM4-NDP water box (PME, cell-pair
sweep, Drude springs, SETTLE, M sites, CMMotionRemover, TGNH with a hard
wall) in f64 — the force pass and potential energy, then 40 steps with
rebuilds (positions and NH state to 1e-9 relative), the fused multi-step
against the unfused one (the twin of tests/test_fused_nh.py), and the hard
wall against the JAX apply_hardwall."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.integrators import tgnh as jtgnh
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu_torch import convert
from openmm_drudenose_tpu_torch.integrators import tgnh
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from torch_threads import _one_thread  # noqa: F401

# ewald_tol 5e-3 gives a 15^3 PME grid, where the JAX package falls back
# from its packed pencil spread to the generic one: the pencil spread
# drops B-spline taps of atoms that drift more than one grid point toward
# lower indices between rebuilds (ROADMAP.md, Queue C), which this hot
# lattice start does within 32 steps
N_MOL, CUTOFF, EWALD_TOL = 216, 0.6, 5e-3


def _pair(precision="double"):
    jsys, pos = jbuilders.build_water_box(N_MOL, cutoff=CUTOFF,
                                          ewald_tol=EWALD_TOL)
    tsys, _ = tbuilders.build_water_box(N_MOL, cutoff=CUTOFF,
                                        ewald_tol=EWALD_TOL)
    vel = np.random.default_rng(9).normal(0.0, 0.3, pos.shape)
    out = []
    for pkg, system, kw in ((dn, jsys, {"strategy": "cellpair"}),
                            (dt, tsys, {"device": "cpu",
                                         "strategy": "cellpair"})):
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        integ.setMaxDrudeDistance(0.02)
        ctx = pkg.Context(system, integ, precision=precision, **kw)
        ctx.setPositions(pos)
        ctx.setVelocities(vel)
        out.append((ctx, integ))
    return out


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_builder_matches_jax():
    jsys, jpos = jbuilders.build_water_box(64, cutoff=0.5)
    tsys, tpos = tbuilders.build_water_box(64, cutoff=0.5)
    np.testing.assert_array_equal(jpos, tpos)
    assert jsys.getNumParticles() == tsys.getNumParticles()
    assert [jsys.getParticleMass(i) for i in range(jsys.getNumParticles())] \
        == [tsys.getParticleMass(i) for i in range(tsys.getNumParticles())]
    assert jsys.getDefaultPeriodicBoxVectors() \
        == tsys.getDefaultPeriodicBoxVectors()
    jf = {type(f).__name__: f for f in jsys.getForces()}
    tf = {type(f).__name__: f for f in tsys.getForces()}
    assert sorted(jf) == sorted(tf)
    assert jf["NonbondedForce"]._particles == tf["NonbondedForce"]._particles
    assert jf["NonbondedForce"]._exceptions \
        == tf["NonbondedForce"]._exceptions
    assert jf["DrudeForce"]._particles == tf["DrudeForce"]._particles
    assert jsys._constraints == tsys._constraints


def test_spec_matches_jax(pair):
    (jctx, _), (tctx, _) = pair
    ref = convert.spec_from_numpy(
        {k: np.asarray(v) for k, v in jctx._spec._asdict().items()
         if v is not None})
    for name in ref.__dataclass_fields__:
        a, b = getattr(tctx._spec, name), getattr(ref, name)
        if isinstance(a, float):
            assert a == pytest.approx(b, rel=1e-15), name
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=name)
    assert tctx._static.n_residues == jctx._static.n_residues
    assert tctx._static.n_settle == jctx._static.n_settle
    np.testing.assert_array_equal(np.asarray(tctx._state.eta_dot_dot),
                                  np.asarray(jctx._state.eta_dot_dot))


def test_force_pass_matches_jax(pair):
    (jctx, _), (tctx, _) = pair
    jnb = next(t[0] for t in jctx._terms if hasattr(t[0], "cellpair_cfg"))
    assert jnb.pme_setup.cell_grid is None    # the generic JAX spread
    js = jctx.getState(forces=True, energy=True)
    ts = tctx.getState(forces=True, energy=True)
    np.testing.assert_allclose(ts.getPotentialEnergy(),
                               js.getPotentialEnergy(), rtol=1e-10)
    f_ref = js.getForces()
    np.testing.assert_allclose(ts.getForces(), f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())


def test_steps_match_jax():
    """40 steps = rebuild + 16, rebuild + 16, rebuild + 8 fused steps, from
    the JAX state carried across by convert.state_from_numpy."""
    (jctx, jint), (tctx, tint) = _pair()
    jctx._ensure_forces()
    tctx._state = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in jctx._state._asdict().items()
         if v is not None and k not in ("neighbors", "key")})
    tctx._forces_valid = True
    jint.step(40)
    tint.step(40)
    js, ts = jctx._state, tctx._state
    assert ts.step == int(js.step) == 40
    for name, tol in (("positions", 1e-9), ("velocities", 1e-9),
                      ("eta", 1e-9), ("eta_dot", 1e-9),
                      ("group_ke", 1e-9)):
        ref = np.asarray(getattr(js, name))
        np.testing.assert_allclose(getattr(ts, name).numpy(), ref,
                                   rtol=tol, atol=tol * np.abs(ref).max(),
                                   err_msg=name)
    assert not tctx.neighborListOverflowed
    np.testing.assert_allclose(tctx.getConservedEnergy(),
                               jctx.getConservedEnergy(), rtol=1e-9)
    jt = jctx.getState(groups=True).getGroupTemperatures()
    tt = tctx.getState(groups=True).getGroupTemperatures()
    np.testing.assert_allclose(tt, jt, rtol=1e-9)


def test_fused_matches_unfused(pair):
    (_, _), (tctx, _) = pair
    tctx._ensure_forces()
    st = tctx._state
    stepper = tctx._stepper
    n = 9
    plain = stepper.multi_step(tctx._spec, st, n, fuse_nh=False)
    fused = stepper.multi_step(tctx._spec, st, n, fuse_nh=True)
    np.testing.assert_allclose(fused.positions.numpy(),
                               plain.positions.numpy(), rtol=0, atol=1e-11)
    np.testing.assert_allclose(fused.velocities.numpy(),
                               plain.velocities.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(fused.eta.numpy(), plain.eta.numpy(),
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(fused.group_ke.numpy(),
                               plain.group_ke.numpy(), rtol=1e-10)
    assert fused.step == plain.step == n
    np.testing.assert_allclose(float(fused.ke_sum), float(plain.ke_sum),
                               rtol=1e-10)


def test_hardwall_matches_jax(pair):
    (jctx, _), (tctx, _) = pair
    rng = np.random.default_rng(12)
    pos = np.asarray(jctx._state.positions, np.float64).copy()
    vel = rng.normal(0.0, 1.0, pos.shape)
    spec = tctx._spec
    drude = np.nonzero((spec.is_pair & ~spec.is_parent).numpy())[0]
    parent = spec.partner.numpy()[drude]
    # shells at 0.5x .. 2.5x the wall: bounces, and runaways past 2x
    disp = rng.normal(size=(len(drude), 3))
    disp *= (0.02 * rng.uniform(0.5, 2.5, len(drude))
             / np.linalg.norm(disp, axis=1))[:, None]
    pos[drude] = pos[parent] + disp
    jp, jv, jrun = jtgnh.apply_hardwall(jctx._spec, jctx._static,
                                        jnp.asarray(pos), jnp.asarray(vel),
                                        jnp.asarray(0.001))
    tp, tv, trun = tgnh.apply_hardwall(spec, tctx._static,
                                       torch.as_tensor(pos),
                                       torch.as_tensor(vel), 0.001)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-10)
    assert bool(trun) == bool(jrun) is True
