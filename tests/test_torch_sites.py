"""The port's out-of-plane and local-coordinates virtual sites
(constraints/vsites.py) against the JAX package in float64 on the CPU:
the site positions (JAX constraints/vsites.py:37-81), the force spread
(the JAX package's jax.vjp fallback against the port's analytic
out-of-plane J^T and its vjp of the local frame), the energy and forces
of a Context whose charges sit on the sites, and steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.constraints import vsites as jvs
from openmm_drudenose_tpu.core import spec as jspec
from openmm_drudenose_tpu_torch.constraints import vsites as tvs
from openmm_drudenose_tpu_torch.core import spec as tspec
from torch_threads import _one_thread  # noqa: F401

# three massive parents a molecule; sites: average2, average3,
# out-of-plane, local coordinates on 3 and on 4 parents
N_MOL = 3


def _system(pkg):
    s = pkg.System()
    nb = pkg.NonbondedForce()
    drude = pkg.DrudeForce()
    rng = np.random.default_rng(3)
    per_mol = 10
    for m in range(N_MOL):
        o = m * per_mol
        for mass in (16.0, 12.0, 14.0, 1.0):
            s.addParticle(mass)
        s.addParticle(0.4)                    # Drude of atom o
        for _ in range(5):
            s.addParticle(0.0)
        s.setVirtualSite(o + 5, pkg.TwoParticleAverageSite(o, o + 1, 0.3,
                                                           0.7))
        s.setVirtualSite(o + 6, pkg.ThreeParticleAverageSite(
            o, o + 1, o + 2, 0.5, 0.25, 0.25))
        s.setVirtualSite(o + 7, pkg.OutOfPlaneSite(o, o + 1, o + 2, 0.2,
                                                   -0.3, 4.0))
        s.setVirtualSite(o + 8, pkg.LocalCoordinatesSite(
            (o, o + 1, o + 2), (0.4, 0.3, 0.3), (-1.0, 1.0, 0.0),
            (-1.0, 0.0, 1.0), (0.03, -0.01, 0.02)))
        s.setVirtualSite(o + 9, pkg.LocalCoordinatesSite(
            (o, o + 1, o + 2, o + 3), (0.25, 0.25, 0.25, 0.25),
            (-1.0, 1.0, 0.0, 0.0), (-1.0, 0.0, 0.0, 1.0),
            (-0.02, 0.04, 0.01)))
        charges = rng.normal(0, 0.4, per_mol)
        charges[4] = -0.8
        for i in range(per_mol):
            nb.addParticle(float(charges[i]), 0.3, 0.2 if i < 4 else 0.0)
        for i in range(per_mol):
            for j in range(i):
                nb.addException(o + i, o + j, 0.0, 1.0, 0.0)
        drude.addParticle(o + 4, o, -1, -1, -1, -0.8, 0.0015, 1, 1)
    s.addForce(nb)
    s.addForce(drude)
    return s


def _positions(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for m in range(N_MOL):
        c = np.array([0.9 * m, 0.2 * m, 0.1])
        parents = c + rng.normal(0, 0.12, (4, 3))
        out.append(np.vstack([parents, parents[:1] + 0.004,
                              np.repeat(c[None], 5, axis=0)]))
    return np.vstack(out)


def _specs():
    ij = dn.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    it = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    js, jst, _ = jspec.build_spec(_system(dn), ij, jnp.float64, jnp.float64)
    ts, tst, _ = tspec.build_spec(_system(dt), it, torch.float64,
                                  torch.float64, "cpu")
    assert (tst.n_vsites_avg, tst.n_vsites_oop, tst.n_vsites_lc) == \
        (jst.n_vsites_avg, jst.n_vsites_oop, jst.n_vsites_lc) == \
        (2 * N_MOL, N_MOL, 2 * N_MOL)
    return js, jst, ts, tst


def test_site_positions_equal_jax():
    js, jst, ts, tst = _specs()
    pos = _positions()
    ref = np.asarray(jvs.apply_vsites(js, jst, jnp.asarray(pos)))
    got = tvs.apply_vsites(ts, tst, torch.tensor(pos)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    rel = tvs.apply_vsites_relative(ts, tst, torch.tensor(pos)).numpy()
    np.testing.assert_allclose(rel, ref, rtol=0, atol=1e-12)


def test_spread_equals_jax_vjp():
    js, jst, ts, tst = _specs()
    pos = _positions(1)
    f = np.random.default_rng(2).normal(0, 50.0, pos.shape)
    comp, vjp = jax.vjp(lambda p: jvs.apply_vsites(js, jst, p),
                        jnp.asarray(pos))
    ref = np.asarray(vjp(jnp.asarray(f))[0])
    got = tvs.spread_vsite_forces(ts, tst, torch.tensor(f),
                                  torch.tensor(np.asarray(comp))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    sites = [i for i in range(pos.shape[0]) if i % 10 >= 5]
    assert np.all(got[sites] == 0.0)


def _contexts():
    out = []
    for pkg, kw in ((dn, {}), (dt, {"device": "cpu"})):
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.0005, 20, 1)
        ctx = pkg.Context(_system(pkg), integ, precision="double", **kw)
        ctx.setPositions(_positions(4))
        out.append((ctx, integ))
    return out


def test_site_context_energy_forces_and_steps_equal_jax():
    (cj, ij), (ct, it) = _contexts()
    a = cj.getState(energy=True, forces=True)
    b = ct.getState(energy=True, forces=True)
    assert b.getPotentialEnergy() == pytest.approx(a.getPotentialEnergy(),
                                                   rel=1e-10)
    fa = np.asarray(a.getForces())
    np.testing.assert_allclose(b.getForces(), fa, rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(fa)))
    vel = np.random.default_rng(6).normal(0, 0.3, (10 * N_MOL, 3))
    for ctx, integ in ((cj, ij), (ct, it)):
        ctx.setVelocities(vel)
        integ.step(10)
    pa = np.asarray(cj.getState(positions=True).getPositions())
    pb = ct.getState(positions=True).getPositions()
    np.testing.assert_allclose(pb, pa, rtol=0, atol=1e-10)
