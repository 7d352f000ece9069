"""The plain reference against the port's CPU path in float64 on a
small SWM4-NDP box: forces, and three TGNH steps (the port's fused
multi-step against the reference's one step at a time).  Lets the
reference's own faults show before the card."""

import numpy as np
import pytest
import torch

from conftest import ROOT, small_config
from portbench import program
from portbench.generators import md
from portbench.systems import swm4ndp_water
from portbench.reference import forces, precision, tgnh, water

SMALL = {"temperature_K": 300.0, "relative_temperature_K": 1.0}


@pytest.fixture(scope="module")
def port_and_ref():
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.io import builders
    cfg = small_config()
    inputs = program.load_inputs(cfg, ROOT)
    x = inputs["positions"]
    system, _ = builders.build_water_box(cfg["n_molecules"])
    swm4ndp_water.check_system(system, cfg)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision="double", device="cpu")
    cfg["pme_grid"] = list(ctx._nb.pme.grid)
    v = md.velocities(water.from_config(cfg), SMALL, 1, 11)
    ctx.setPositions(x)
    ctx.setVelocities(v[0])
    w = water.from_config(cfg)
    field = forces.Field(w, cfg, "cpu")
    return ctx, integ, cfg, field, x, v


def massive(w):
    return np.tile(w.mass > 0, w.n_mol)


def test_forces_agree(port_and_ref):
    ctx, _, cfg, field, x, _ = port_and_ref
    ctx._ensure_forces()
    fp = ctx._state.forces.numpy()
    fr = field.forces(torch.as_tensor(x)[None])[0].numpy()
    m = massive(field.w)
    d = fp[m] - fr[m]
    assert np.sqrt(np.sum(d * d) / np.sum(fr[m] ** 2)) < 1e-11
    assert np.abs(d).max() < 1e-9 * np.abs(fr[m]).max()


def test_three_steps_agree(port_and_ref):
    ctx, integ, cfg, field, x, v = port_and_ref
    ref = tgnh.TGNH(field, cfg)
    st = ref.start(torch.as_tensor(x)[None], torch.as_tensor(v))
    integ.step(3)
    for _ in range(3):
        st = ref.step(st)
    m = massive(field.w)
    xp = ctx._state.positions.numpy()
    vp = ctx._state.velocities.numpy()
    assert np.abs(xp[m] - st.x[0].numpy()[m]).max() < 1e-12
    dv = vp[m] - st.v[0].numpy()[m]
    assert np.sqrt(np.sum(dv ** 2) / np.sum(vp[m] ** 2)) < 1e-11
    ed = ctx._state.eta_dot.numpy()[:, :1]
    np.testing.assert_allclose(ed[:, 0], st.eta_dot[0, :, 0].numpy(),
                               rtol=1e-9, atol=1e-12)


def test_reciprocal_energy_against_ewald_sum():
    """Smooth PME's energy against the plain Ewald reciprocal sum over
    |m| <= 8 on a small random neutral box (float64)."""
    cfg = small_config()
    cfg["n_molecules"] = 8
    cfg["number_density_per_nm3"] = 1.0
    cfg["pme_grid"] = [32, 32, 32]
    w = water.from_config(cfg)
    field = forces.Field(w, cfg, "cpu")
    rng = np.random.default_rng(0)
    x = rng.uniform(0, w.box, size=(w.n0, 3))
    _, e = field.reciprocal(torch.as_tensor(x)[None], energy=True)
    q = w.per_atom(w.charge)
    a, L = field.alpha, w.box
    k = np.arange(-8, 9)
    mx, my, mz = np.meshgrid(k, k, k, indexing="ij")
    m = np.stack([mx, my, mz], -1).reshape(-1, 3) / L
    m = m[np.any(m != 0, 1)]
    m2 = np.sum(m * m, 1)
    s = np.exp(-2j * np.pi * (x @ m.T)).T @ q
    ewald = forces.ONE_4PI_EPS0 / (2 * np.pi * L ** 3) * np.sum(
        np.exp(-np.pi ** 2 * m2 / a ** 2) / m2 * np.abs(s) ** 2)
    assert float(e[0]) == pytest.approx(ewald, rel=1e-5)


def test_replicas_are_independent():
    cfg = small_config()
    w = water.from_config(cfg)
    inputs = program.load_inputs(cfg, ROOT)
    x = np.broadcast_to(inputs["positions"], (2, w.n0, 3)).copy()
    v = md.velocities(w, SMALL, 2, 5)
    ref = tgnh.TGNH(forces.Field(w, cfg, "cpu"), cfg)
    both = ref.step(ref.start(torch.as_tensor(x), torch.as_tensor(v)))
    one = ref.step(ref.start(torch.as_tensor(x[1:]), torch.as_tensor(v[1:])))
    np.testing.assert_array_equal(both.x[1].numpy(), one.x[0].numpy())
    np.testing.assert_array_equal(both.v[1].numpy(), one.v[0].numpy())


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0000002],
                     dtype=torch.float32)
    got = precision.round_tf32(x)
    assert got.tolist() == [1.0, 1.0, 1.0 + 4 * 2 ** -11, -3.0]
