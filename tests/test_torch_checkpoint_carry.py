"""convert.py's reader of the JAX checkpoint format: a JAX Context's
state, written by the JAX save_checkpoint (the flattened SimState as
leaf_0 ... leaf_{n-1}), read into a port Context field for field, then
STEPS steps in each package from it (positions within 1e-10 nm), for a
dense f64 box, a cell-pair f64 box (its cell-sort leaves skipped) and a
flat-NPT ensemble (per-replica scales and barostat arrays); the JAX
drift run's committed 100k checkpoint (data/drift_100k_state.npz, saved
in float32 with the compensation pos_err: the JAX float32 precisions
fail with a NonbondedForce under x64, ROADMAP.md C12, so its layout is
checked on that file) read field by field against np.load's leaves and
put into the port's bench Context; malformed files refused."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
import util
from openmm_drudenose_tpu.app import serialization as jser
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu.parallel.flatrep import \
    FlatReplicaEnsemble as JaxFlat
from openmm_drudenose_tpu_torch import convert
from openmm_drudenose_tpu_torch.app import serialization as tser
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from openmm_drudenose_tpu_torch.parallel import flatrep
from openmm_drudenose_tpu_torch.tools import measure_drift as md
from openmm_drudenose_tpu_torch.tools import setups
from torch_threads import _one_thread  # noqa: F401

# steps before the JAX checkpoint and after it in each package (one
# count, so the JAX package compiles one scan)
STEPS = 10
SCALES = (1.03, 0.97)
FIELDS = ("positions", "velocities", "forces", "potential_energy", "box",
          "eta", "eta_dot", "eta_dot_dot", "ke_sum", "group_ke")


def _integrators():
    out = []
    for pkg in (dn, dt):
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        integ.setMaxDrudeDistance(0.02)
        out.append(integ)
    return out


def _contexts(kind):
    """(JAX context, its stepper, port context, its stepper, JAX state)
    for `kind`, the JAX one stepped STEPS from seeded velocities."""
    if kind == "dense":
        jsys, pos = util.swm4_water_box(grid_size=2)
        strategy = "dense"
    else:
        jsys, pos = jbuilders.build_water_box(216, cutoff=0.6,
                                              ewald_tol=5e-3)
        strategy = "cellpair"
    tsys = tser.deserialize_system(jser.serialize_system(jsys))
    jint, tint = _integrators()
    jctx = dn.Context(jsys, jint, precision="double", strategy=strategy)
    jctx.setPositions(pos)
    if kind == "dense":
        jctx.applyConstraints(1e-8)
    jctx.setVelocities(np.random.default_rng(7).normal(0.0, 0.3, pos.shape))
    jint.step(STEPS)
    tctx = dt.Context(tsys, tint, precision="double", strategy=strategy,
                      device="cpu")
    tctx.setPositions(pos)
    return jctx, jint.step, tctx, tint.step


def _com_scaled(system, positions, s):
    """Positions after a molecule-COM scaling by s (5-site waters)."""
    m = np.array([system.getParticleMass(i)
                  for i in range(system.getNumParticles())]).reshape(-1, 5)
    p = np.asarray(positions, np.float64).reshape(-1, 5, 3)
    com = (m[:, :, None] * p).sum(axis=1) / m.sum(axis=1)[:, None]
    return (p + (s - 1.0) * com[:, None, :]).reshape(-1, 3)


def _flat_contexts():
    """2 replicas of 100 waters (cutoff 0.45) at scales (1.03, 0.97), with
    a barostat every 1000 steps: no attempt in the steps compared (the
    JAX PRNG key has no counterpart in the port)."""
    jsys, pos = jbuilders.build_water_box(
        100, method=dn.NonbondedForce.PME, cutoff=0.45)
    jsys.addForce(dn.MonteCarloBarostat(1.01325, 300.0, 1000))
    tsys = tser.deserialize_system(jser.serialize_system(jsys))
    jint, tint = _integrators()
    jtpl = dn.Context(jsys, jint, precision="double", strategy="cellpair")
    jtpl.setPositions(pos)
    jtpl.applyConstraints(1e-8)
    p0 = np.asarray(jtpl._state.positions, np.float64)
    jens = JaxFlat(jtpl, 2, rx=2, rz=1)
    jens.context._state = jens.context._state._replace(
        rep_scale=jnp.asarray(np.array(SCALES)))
    jens.setPositions(np.stack([_com_scaled(jsys, p0, s) for s in SCALES]))
    jens.setVelocities(np.random.default_rng(8).normal(
        0.0, 0.3, (2,) + pos.shape))
    jens.step(STEPS)
    ttpl = dt.Context(tsys, tint, precision="double", strategy="cellpair",
                      device="cpu")
    ttpl.setPositions(pos)
    tens = flatrep.FlatReplicaEnsemble(ttpl, 2, rx=2, rz=1)
    return jens.context, jens.step, tens.context, tens.step


@pytest.mark.parametrize("kind", ["dense", "cellpair", "flatnpt"])
def test_jax_checkpoint_carries_into_the_port(tmp_path, kind):
    jctx, jstep, tctx, tstep = (_flat_contexts() if kind == "flatnpt"
                                else _contexts(kind))
    path = os.path.join(tmp_path, f"{kind}.npz")
    jser.save_checkpoint(path, jctx)
    js = jctx._state
    convert.load_jax_checkpoint(path, tctx)
    ts = tctx._state
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    assert ts.step == int(js.step) == STEPS
    assert ts.time == float(js.time)
    assert bool(ts.hardwall_runaway) == bool(js.hardwall_runaway)
    assert ts.pos_err is None and js.pos_err is None      # f64
    assert ts.neighbors is None
    if kind == "flatnpt":
        for name in ("rep_scale", "baro_scale", "baro_naccept",
                     "baro_nattempt"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)),
                                          err_msg=name)
        assert ts.rep_scale.dtype == torch.float64
    else:
        assert ts.rep_scale is None
        assert ts.baro_scale == float(js.baro_scale)
        assert ts.baro_nattempt == int(js.baro_nattempt)
    jstep(STEPS)
    tstep(STEPS)
    np.testing.assert_allclose(tctx._state.positions.numpy(),
                               np.asarray(jctx._state.positions), rtol=0,
                               atol=1e-10)
    assert tctx._state.step == int(jctx._state.step) == 2 * STEPS


def test_committed_drift_checkpoint_reads_leaf_for_leaf():
    """data/drift_100k_state.npz: 28 leaves, the 17 SimState fields, the
    10 of the cell sort (skipped) and pos_err, each field the leaf the
    JAX field order puts it at; in the port's bench Context its group KE
    reads the JAX series' last temperatures."""
    raw = np.load(md.JAX_STATE)
    assert int(raw["_n_leaves"]) == 28
    d = convert.read_jax_checkpoint(md.JAX_STATE)
    order = [f for f, _, _ in convert._JAX_STATE]
    for i, name in enumerate(order[:17]):
        np.testing.assert_array_equal(d[name], raw[f"leaf_{i}"],
                                      err_msg=name)
    assert list(d["neighbors"]) == [f for f, _, _ in convert._JAX_SORT]
    for i, name in enumerate(d["neighbors"]):
        np.testing.assert_array_equal(d["neighbors"][name],
                                      raw[f"leaf_{17 + i}"], err_msg=name)
    np.testing.assert_array_equal(d["pos_err"], raw["leaf_27"])
    assert d["pos_err"].dtype == np.float32 and "rep_scale" not in d
    st = convert.state_from_jax_checkpoint(md.JAX_STATE, "cpu")
    assert st.step == 331000 and st.neighbors is None
    np.testing.assert_array_equal(st.pos_err.numpy(), raw["leaf_27"])
    ctx, _ = setups.bench_context("cpu")
    convert.load_jax_checkpoint(md.JAX_STATE, ctx)
    np.testing.assert_array_equal(ctx._state.positions.numpy(),
                                  raw["leaf_0"])
    np.testing.assert_array_equal(ctx._state.pos_err.numpy(),
                                  raw["leaf_27"])
    last = md.read_csv(md.JAX_CSV)[-1]
    with open(md.JAX_STATE + ".ps") as f:
        assert int(f.read()) == int(last[0]) == 326
    np.testing.assert_allclose(md.temperatures(ctx), last[1:], rtol=0,
                               atol=1e-4)


def _malformed(tmp_path, name, leaves, n=None):
    path = os.path.join(tmp_path, f"{name}.npz")
    arrays = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    arrays["_n_leaves"] = np.asarray(len(leaves) if n is None else n)
    np.savez(path, **arrays)
    return path


@pytest.mark.parametrize("case, match", [
    ("count", "do not match _n_leaves"),
    ("box", "cannot place the JAX field 'box'"),
    ("trailing", "fit no JAX SimState field"),
    ("missing", "cannot place the JAX field"),
    ("port", "not a JAX checkpoint"),
])
def test_malformed_checkpoints_are_refused(tmp_path, case, match):
    raw = np.load(md.JAX_STATE)
    leaves = [raw[f"leaf_{i}"] for i in range(int(raw["_n_leaves"]))]
    if case == "count":
        path = _malformed(tmp_path, case, leaves, n=len(leaves) + 1)
    elif case == "box":
        leaves[4] = np.zeros(3, np.float32)
        path = _malformed(tmp_path, case, leaves)
    elif case == "trailing":
        path = _malformed(tmp_path, case,
                          leaves + [np.zeros((2, 2), np.int32)])
    elif case == "missing":
        path = _malformed(tmp_path, case, leaves[:12])
    else:
        system, pos = tbuilders.build_water_box(100, cutoff=0.45)
        tctx = dt.Context(system, _integrators()[1], precision="double",
                          device="cpu")
        tctx.setPositions(pos)
        path = os.path.join(tmp_path, "port.npz")
        dt.save_checkpoint(path, tctx)
    with pytest.raises(ValueError, match=match):
        convert.state_from_jax_checkpoint(path, "cpu")
