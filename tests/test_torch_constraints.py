"""SETTLE and average virtual sites of the PyTorch port against the JAX
package in f64 (to 1e-10), on a small SWM4-NDP water box."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.constraints import settle as jsettle
from openmm_drudenose_tpu.constraints import vsites as jvsites
from openmm_drudenose_tpu.core import spec as jspec
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu_torch.constraints import settle, vsites
from openmm_drudenose_tpu_torch.core import spec as tspec
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from torch_threads import _one_thread  # noqa: F401

N_MOL = 64


@pytest.fixture(scope="module")
def specs():
    jsys, pos = jbuilders.build_water_box(N_MOL, cutoff=0.5)
    tsys, pos_t = tbuilders.build_water_box(N_MOL, cutoff=0.5)
    np.testing.assert_array_equal(pos, pos_t)
    ji = dn.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    ti = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    js, jst, _ = jspec.build_spec(jsys, ji, jnp.float64, jnp.float64)
    ts, tst, _ = tspec.build_spec(tsys, ti, torch.float64, torch.float64,
                                  "cpu")
    return js, jst, ts, tst, pos


def test_settle_positions(specs):
    js, _, ts, _, pos = specs
    rng = np.random.default_rng(1)
    delta = rng.normal(0, 2e-3, pos.shape)
    ref = jsettle.apply_position_constraints(
        jnp.asarray(pos), jnp.asarray(delta), js.inv_mass, js.settle_idx,
        js.settle_dist, js.settle_gather)
    got = settle.apply_position_constraints(
        torch.as_tensor(pos), torch.as_tensor(delta), ts.inv_mass,
        ts.settle_idx, ts.settle_dist)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-10)
    # the constraint distances hold after the projection
    q = pos + got.numpy()
    si = ts.settle_idx.numpy()
    d = np.linalg.norm(q[si[:, 0]] - q[si[:, 1]], axis=1)
    np.testing.assert_allclose(d, ts.settle_dist[:, 0].numpy(), atol=1e-10)


def test_settle_velocities(specs):
    js, _, ts, _, pos = specs
    rng = np.random.default_rng(2)
    vel = rng.normal(0, 0.5, pos.shape)
    ref = jsettle.apply_velocity_constraints(
        jnp.asarray(pos), jnp.asarray(vel), js.inv_mass, js.settle_idx,
        js.settle_dist, js.settle_gather)
    got = settle.apply_velocity_constraints(
        torch.as_tensor(pos), torch.as_tensor(vel), ts.inv_mass,
        ts.settle_idx, ts.settle_dist)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-10)


def test_apply_vsites(specs):
    js, jst, ts, tst, pos = specs
    rng = np.random.default_rng(3)
    p = pos + rng.normal(0, 1e-2, pos.shape)
    ref = jvsites.apply_vsites(js, jst, jnp.asarray(p))
    got = vsites.apply_vsites(ts, tst, torch.as_tensor(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-10)


def test_spread_vsite_forces(specs):
    js, jst, ts, tst, pos = specs
    rng = np.random.default_rng(4)
    f = rng.normal(0, 100.0, pos.shape)
    ref = jvsites.spread_vsite_forces(js, jst, jnp.asarray(f))
    got = vsites.spread_vsite_forces(ts, tst, torch.as_tensor(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-10)
