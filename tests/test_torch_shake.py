"""SHAKE clusters in the port's step (constraints/shake.py,
integrators/tgnh.py) against the JAX package in float64 on the CPU: the
JAX pin test_shake_general_pair, the Jacobi SHAKE and RATTLE sweeps with
the device-side done mask against the JAX lax.while_loop for every
check interval k in {1, 8} (the same sweeps take effect), and fused
steps of a small flexible-water deck (rigidWater=False, HBonds: O-H
constraints, no SETTLE triangles) whose positions and velocities agree
to 1e-10."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
import test_forcefield as jtf
from openmm_drudenose_tpu.app import forcefield as jff
from openmm_drudenose_tpu.constraints import shake as jshake
from openmm_drudenose_tpu.io import pdbfile as jpdb
from openmm_drudenose_tpu_torch.app import forcefield as tff
from openmm_drudenose_tpu_torch.constraints import shake as tshake
from openmm_drudenose_tpu_torch.io import pdbfile as tpdb
from torch_threads import _one_thread  # noqa: F401


def test_shake_general_pair():
    """The JAX pin (tests/test_constraints.py::test_shake_general_pair)
    through the port, and against the JAX result."""
    pos = np.array([[0.0, 0, 0], [0.1, 0, 0], [0.2, 0.01, 0]])
    inv_mass = np.array([1.0, 1.0, 0.5])
    idx = np.array([[0, 1], [1, 2]])
    dist = np.array([0.1, np.linalg.norm([0.1, 0.01, 0])])
    delta = np.random.default_rng(0).normal(0, 0.004, (3, 3))
    out = tshake.apply_position_constraints(
        torch.tensor(pos), torch.tensor(delta), torch.tensor(inv_mass),
        torch.tensor(idx), torch.tensor(dist), 1e-10, 500)
    p = pos + out.numpy()
    np.testing.assert_allclose(np.linalg.norm(p[0] - p[1]), 0.1, rtol=1e-8)
    np.testing.assert_allclose(np.linalg.norm(p[1] - p[2]), dist[1],
                               rtol=1e-8)
    ref = jshake.apply_position_constraints(
        jnp.asarray(pos), jnp.asarray(delta), jnp.asarray(inv_mass),
        jnp.asarray(idx, jnp.int32), jnp.asarray(dist), 1e-10, 500)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-14)


def _chains(n_chain=40, length=4, seed=1):
    """Chains of `length` atoms, every bond constrained: clusters that
    are not triangles, solved by SHAKE only."""
    rng = np.random.default_rng(seed)
    pos, idx, dist, inv_mass = [], [], [], []
    for c in range(n_chain):
        start = len(pos)
        p = rng.uniform(0, 3, 3)
        for k in range(length):
            pos.append(p.copy())
            inv_mass.append(1.0 / rng.uniform(1.0, 16.0))
            if k:
                idx.append((start + k - 1, start + k))
                dist.append(float(np.linalg.norm(pos[-1] - pos[-2])))
            p = p + rng.normal(0, 0.06, 3) + [0.1, 0, 0]
    return (np.array(pos), np.array(idx), np.array(dist),
            np.array(inv_mass))


@pytest.mark.parametrize("k", [1, 8])
def test_done_mask_gives_the_jax_sweeps(k):
    pos, idx, dist, inv_mass = _chains()
    rng = np.random.default_rng(2)
    delta = rng.normal(0, 0.003, pos.shape)
    vel = rng.normal(0, 1.0, pos.shape)
    tol = 1e-5
    t = lambda a: torch.tensor(a)
    stats = tshake.ShakeStats()
    got = tshake.apply_position_constraints(
        t(pos), t(delta), t(inv_mass), t(idx), t(dist), tol, 150,
        check_every=k, stats=stats)
    ref = jshake.apply_position_constraints(
        jnp.asarray(pos), jnp.asarray(delta), jnp.asarray(inv_mass),
        jnp.asarray(idx, jnp.int32), jnp.asarray(dist), tol, 150)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    v_got = tshake.apply_velocity_constraints(
        t(pos), t(vel), t(inv_mass), t(idx), t(dist), tol, 150,
        check_every=k, stats=stats)
    v_ref = jshake.apply_velocity_constraints(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(inv_mass),
        jnp.asarray(idx, jnp.int32), jnp.asarray(dist), tol, 150)
    np.testing.assert_allclose(v_got.numpy(), np.asarray(v_ref), rtol=0,
                               atol=1e-12)
    # the sweeps that took effect do not depend on k; the host read the
    # flag once every k sweeps (and at the end)
    n_pos, n_vel = stats.per_call("pos")[0], stats.per_call("vel")[0]
    assert 1 < n_pos < 150 and 1 < n_vel < 150
    assert stats.reads == -(-n_pos // k) + -(-n_vel // k)
    base = tshake.ShakeStats()
    tshake.apply_position_constraints(
        t(pos), t(delta), t(inv_mass), t(idx), t(dist), tol, 150,
        check_every=1, stats=base)
    assert base.per_call("pos") == [n_pos]


def _flexible(pk, bare):
    ff = pk.ff.ForceField(os.path.join(jtf.DATA, "swm4_nacl.xml"))
    pdb = pk.pdb.PDBFile(bare)
    m = pk.ff.Modeller(pdb.topology, pdb.positions)
    m.addExtraParticles(ff)
    s = ff.createSystem(m.topology, nonbondedMethod=pk.ff.PME,
                        nonbondedCutoff=0.9, constraints=pk.ff.HBonds,
                        rigidWater=False)
    jtf._repartition(s, m.topology)
    return s, np.asarray(m.positions)


def test_flexible_water_steps_equal_jax(tmp_path):
    _, bare = jtf._make_nacl_files(tmp_path, n_side=3)
    runs = []
    for pkg, ffm, pdbm, kw in ((dn, jff, jpdb, {}),
                               (dt, tff, tpdb, {"device": "cpu"})):
        pk = type("P", (), {"ff": ffm, "pdb": pdbm})
        system, pos = _flexible(pk, bare)
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        integ.setMaxDrudeDistance(0.02)
        ctx = pkg.Context(system, integ, precision="double", **kw)
        ctx.setPositions(pos)
        ctx.applyConstraints(1e-10)
        ctx.setVelocities(np.random.default_rng(4).normal(
            0, 0.3, pos.shape))
        ctx.applyVelocityConstraints(1e-10)
        runs.append((ctx, integ))
    ct = runs[1][0]
    assert ct._static.n_shake == 2 * 25 and ct._static.n_settle == 0
    stats = tshake.ShakeStats()
    ct._stepper.shake_stats = stats
    for _ in range(2):
        for _, integ in runs:
            integ.step(8)
        sj, st = (c.getState(positions=True, velocities=True)
                  for c, _ in runs)
        np.testing.assert_allclose(st.getPositions(), sj.getPositions(),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(st.getVelocities(), sj.getVelocities(),
                                   rtol=0, atol=1e-10)
    # every O-H constraint within 2 tol of its length, |r.v|/d^2 <= tol
    # after the projection
    spec = ct._spec
    p = ct._state.positions
    i, j = spec.shake_idx[:, 0], spec.shake_idx[:, 1]
    r = p[i] - p[j]
    d2 = spec.shake_dist ** 2
    assert torch.max(torch.abs(torch.sum(r * r, 1) / d2 - 1)) <= 2e-5
    ct.applyVelocityConstraints(1e-5)
    v = ct._state.velocities
    assert torch.max(torch.abs(torch.sum(r * (v[i] - v[j]), 1)) / d2) \
        <= 1e-5
    assert len(stats.per_call("pos")) == 16 and len(stats.per_call("vel")) \
        == 16


def test_float32_bonds_take_the_compensation():
    """In float32 the bond vectors come from positions + pos_err (the
    positions the integrator carries): there the constraints hold to
    SHAKE's 2 tol and |r.v|/d^2 to tol.  From the rounded positions
    alone (the JAX package's way, pos_err=None here) a 0.1 nm bond 8 nm
    from the origin misses the 2 tol band."""
    pos64, idx, _, inv_mass = _chains(n_chain=400, length=2, seed=3)
    pos64 = pos64 + 8.0
    rng = np.random.default_rng(5)
    # true bonds of 0.1 nm; float32 positions and their residuals
    pos64[1::2] = pos64[0::2] + 0.1 * rng.normal(size=(400, 3)) \
        / np.linalg.norm(rng.normal(size=(400, 3)), axis=1, keepdims=True)
    dist = np.linalg.norm(pos64[idx[:, 0]] - pos64[idx[:, 1]], axis=1)
    p32 = torch.tensor(pos64, dtype=torch.float32)
    err = torch.tensor(pos64 - p32.double().numpy(), dtype=torch.float32)
    delta = torch.tensor(rng.normal(0, 1e-3, pos64.shape),
                         dtype=torch.float32)
    vel = torch.tensor(rng.normal(0, 1.0, pos64.shape), dtype=torch.float32)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    tol = 1e-5
    out = {}
    for name, e in (("compensated", err), ("rounded", None)):
        d = tshake.apply_position_constraints(
            p32, delta, t(inv_mass), torch.tensor(idx), t(dist), tol, 150,
            pos_err=e)
        true = pos64 + d.double().numpy()
        r = true[idx[:, 0]] - true[idx[:, 1]]
        viol = np.max(np.abs(np.sum(r * r, 1) / dist ** 2 - 1))
        v = tshake.apply_velocity_constraints(
            p32, vel, t(inv_mass), torch.tensor(idx), t(dist), tol, 150,
            pos_err=e).double().numpy()
        r0 = pos64[idx[:, 0]] - pos64[idx[:, 1]]
        rv = np.max(np.abs(np.sum(r0 * (v[idx[:, 0]] - v[idx[:, 1]]), 1))
                    / dist ** 2)
        out[name] = (viol, rv)
    assert out["compensated"][0] <= 2 * tol and out["compensated"][1] <= tol
    assert out["rounded"][0] > 2 * tol and out["rounded"][1] > tol
