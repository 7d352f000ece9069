"""The PyTorch port's MonteCarloBarostat against the JAX package's on the
CPU in f64.  The port draws from a torch.Generator, the JAX package from
jax.random, so both are fed the same two numbers (the proposal's uniform
and the Metropolis uniform): the JAX package's maybe_attempt_mc_move
through a stand-in for jax.random.uniform while it is traced, the port's
through `draws`.  Checked: one move (positions, box, the accept flag,
move size and counters, 1e-10), the adaptive move-size schedule over 12
moves, the cell grid planned again after a shrink (the port's twin of
tests/test_guards.py::test_npt_shrink_replans_stencil), and the energy
with the plain sweep after the box changed (1e-10); a Context stepping
with a barostat attempts on the steps the host picks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.integrators import barostat as jbaro
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu_torch.integrators import barostat as tbaro
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from torch_threads import _one_thread  # noqa: F401


def _pair(build, strategy, freq=1):
    out = []
    for pkg, b, kw in ((dn, jbuilders, {}), (dt, tbuilders,
                                            {"device": "cpu"})):
        system, pos = build(b)
        system.addForce(pkg.MonteCarloBarostat(1.01325, 300.0, freq))
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        integ.setMaxDrudeDistance(0.02)
        ctx = pkg.Context(system, integ, precision="double",
                          strategy=strategy, **kw)
        ctx.setPositions(pos)
        ctx._ensure_neighbors()
        out.append(ctx)
    return out


def _nacl(b):
    return b.build_nacl_water_box(60, 2, 2, cutoff=0.6)


def _jax_move(jctx):
    """jit(state, draws) -> state: the JAX package's move with its two
    jax.random.uniform draws replaced by draws[0] and draws[1]."""
    spec, static = jctx._spec, jctx._static

    def move(state, draws):
        seq = iter([draws[0], draws[1]])
        real = jax.random.uniform
        jax.random.uniform = lambda key, *a, dtype=None, **k: \
            next(seq).astype(dtype)
        try:
            return jbaro.maybe_attempt_mc_move(
                spec, static, state, jctx._energy_and_forces,
                recompute_current=True)
        finally:
            jax.random.uniform = real

    return jax.jit(move)


def _port_move(tctx, state, draws):
    return tbaro.maybe_attempt_mc_move(tctx._spec, tctx._static, state,
                                       tctx._potential, tctx._forces_only,
                                       draws=draws)


def _assert_same(js, ts):
    np.testing.assert_allclose(ts.positions.numpy(),
                               np.asarray(js.positions), rtol=0, atol=1e-10)
    np.testing.assert_allclose(ts.box.numpy(), np.asarray(js.box),
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(ts.baro_scale, float(js.baro_scale),
                               rtol=1e-10)
    assert ts.baro_naccept == int(js.baro_naccept)
    assert ts.baro_nattempt == int(js.baro_nattempt)


@pytest.fixture(scope="module")
def nacl_pair():
    jctx, tctx = _pair(_nacl, "dense")
    return jctx, tctx, _jax_move(jctx)


# (proposal uniform, Metropolis uniform): large moves either way, with
# Metropolis draws at both ends, so that both outcomes occur
DRAWS = [(0.97, 1e-9), (0.03, 1.0 - 1e-9), (0.5, 0.5), (0.0, 0.9),
         (1.0 - 1e-9, 1e-9)]


def test_one_move_matches_jax(nacl_pair):
    jctx, tctx, jmove = nacl_pair
    outcomes = set()
    for draws in DRAWS:
        js = jmove(jctx._state, jnp.asarray(draws))
        ts = _port_move(tctx, tctx._state, draws)
        _assert_same(js, ts)
        accepted = ts.baro_naccept == 1
        outcomes.add(accepted)
        if accepted:
            np.testing.assert_allclose(ts.forces.numpy(),
                                       np.asarray(js.forces), rtol=0,
                                       atol=1e-8 * float(np.abs(np.asarray(
                                           js.forces)).max()))
        else:
            assert ts.positions is tctx._state.positions
    assert outcomes == {True, False}


def test_adaptive_schedule_matches_jax(nacl_pair):
    """12 moves in a row, proposals from one numpy stream and Metropolis
    draws of 1e-12 (almost every move accepted): after the 10th attempt
    the move size grows by 1.1 and the counters restart."""
    jctx, tctx, jmove = nacl_pair
    rng = np.random.default_rng(11)
    js, ts = jctx._state, tctx._state
    scales = []
    for _ in range(12):
        draws = (float(rng.uniform()), 1e-12)
        js = jmove(js, jnp.asarray(draws))
        ts = _port_move(tctx, ts, draws)
        _assert_same(js, ts)
        scales.append(ts.baro_scale)
    assert scales[9] == pytest.approx(1.1 * scales[8], rel=1e-12)
    assert ts.baro_nattempt == 2


def _water(b):
    # 216 waters, cutoff 0.5 nm: 6^3 cells of 0.312 nm, window 2 (0.623
    # nm >= r_list 0.6); a 4% linear shrink leaves 0.598 < 0.6, and the
    # grid planned again at that box is 5^3
    return b.build_water_box(216, cutoff=0.5, ewald_tol=5e-3)


@pytest.fixture(scope="module")
def water_pair():
    return _pair(_water, "cellpair", freq=4)


def test_shrink_replans_stencil(water_pair):
    """The box and positions shrunk by 4%: the next sort plans the cell
    grid and the PME grid again at the new box, as the JAX package does,
    instead of raising; the new stencil covers r_list; the energy with
    the plain sweep at the new grid matches the JAX cell-pair energy."""
    jctx, tctx = water_pair
    s = 0.96
    grid0 = tctx._cp_cfg.grid
    jctx._state = jctx._state._replace(box=jctx._state.box * s,
                                       positions=jctx._state.positions * s,
                                       neighbors=None)
    jctx._forces_valid = False
    tctx._state = tctx._state.replace(box=tctx._state.box * s,
                                      positions=tctx._state.positions * s,
                                      neighbors=None)
    tctx._forces_valid = False
    jctx._ensure_neighbors()
    tctx._ensure_neighbors()
    cfg = tctx._cp_cfg
    assert cfg.grid != grid0
    assert cfg.grid == jctx._cp_cfg.grid
    assert tctx._nb.pme.grid == tuple(
        next(t[0] for t in jctx._terms
             if hasattr(t[0], "cellpair_cfg")).pme_setup.grid)
    box = np.diagonal(tctx._state.box.numpy())
    assert np.all(np.asarray(cfg.window) * box / np.asarray(cfg.grid)
                  >= cfg.r_list - 1e-9)
    je = jctx.getState(energy=True).getPotentialEnergy()
    te = tctx.getState(energy=True).getPotentialEnergy()
    np.testing.assert_allclose(te, je, rtol=1e-10)


def test_energy_after_move_matches_jax(water_pair):
    """An accepted volume move on the cell-pair strategy (trial energy at
    the old sort and the new box, as both packages take it), then the
    energy at the moved state with that sort."""
    jctx, tctx = water_pair
    jctx._ensure_neighbors()
    tctx._ensure_neighbors()
    draws = (0.9, 1e-12)
    js = _jax_move(jctx)(jctx._state, jnp.asarray(draws))
    ts = _port_move(tctx, tctx._state, draws)
    assert ts.baro_naccept == 1
    _assert_same(js, ts)
    je = float(jax.jit(jctx._potential)(js.positions, js.box, js.neighbors,
                                        None))
    te = float(tctx._potential(ts.positions, ts.box, ts.neighbors, None))
    np.testing.assert_allclose(te, je, rtol=1e-10)


def test_context_attempts_on_host_chosen_steps():
    """A Context stepping with MonteCarloBarostat(frequency 4): attempts
    at steps 0, 4, 8, ... (both in the unfused first step and between the
    fused NH halves), counted by the host."""
    system, pos = tbuilders.build_nacl_water_box(60, 2, 2, cutoff=0.6)
    system.addForce(dt.MonteCarloBarostat(1.01325, 300.0, 4))
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision="double", device="cpu")
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, seed=1)
    seen = []
    real = tbaro.maybe_attempt_mc_move

    def spy(spec, static, state, *a, **k):
        if state.step % static.baro_freq == 0:
            seen.append(state.step)
        return real(spec, static, state, *a, **k)

    tbaro.maybe_attempt_mc_move = spy
    try:
        integ.step(10)
        integ.step(3)
    finally:
        tbaro.maybe_attempt_mc_move = real
    assert seen == [0, 4, 8, 12]
    assert ctx._state.baro_nattempt == 4
    assert np.isfinite(ctx.getState(energy=True).getPotentialEnergy())


def test_midrun_shrink_replans_and_jax_keeps_its_grid():
    """A box shrunk past the stencil while a cell sort is in place (as
    volume moves do between sorts): the port's in-step rebuilds latch the
    stencil flag and the grid is planned again after the chunk; the JAX
    package's rebuilds drop the flag, and its Context replans only when
    the sort is cleared, so its stale grid stays (ROADMAP.md, Queue C)."""
    jctx, tctx = _pair(_water, "cellpair", freq=10 ** 6)
    s = 0.96
    grid0 = tctx._cp_cfg.grid
    jctx._state = jctx._state._replace(box=jctx._state.box * s,
                                       positions=jctx._state.positions * s)
    jctx._ensure_neighbors()                  # a sort is in place: no-op
    assert jctx._cp_cfg.grid == grid0
    tctx._state = tctx._state.replace(box=tctx._state.box * s,
                                      positions=tctx._state.positions * s)
    tctx.setVelocities(np.zeros((tctx._static.n_atoms, 3)))
    tctx.step(17)                             # two rebuilds in one chunk
    assert tctx._cp_cfg.grid != grid0
    box = np.diagonal(tctx._state.box.numpy())
    cfg = tctx._cp_cfg
    assert np.all(np.asarray(cfg.window) * box / np.asarray(cfg.grid)
                  >= cfg.r_list - 1e-9)
    assert np.isfinite(tctx.getState(energy=True).getPotentialEnergy())


def test_mc_energies_are_float64():
    """The port's Metropolis energies are float64 in single precision; the
    JAX package's are float32 there (accum = eta.dtype), where |E| of the
    100k bench state (~8.3e5 kJ/mol) rounds to 0.0625 kJ/mol, 2.5% of
    kT at 300 K (ROADMAP.md, Queue C)."""
    system, pos = tbuilders.build_nacl_water_box(60, 2, 2, cutoff=0.6)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    ctx = dt.Context(system, integ, precision="single", device="cpu")
    ctx.setPositions(pos)
    st = ctx._state
    e = ctx._potential(st.positions, st.box, st.neighbors, st.pos_err)
    assert e.dtype == torch.float64
    assert dn.precision.get_precision("single").accum == jnp.float32
    ulp = float(np.spacing(np.float32(826377.0)))
    assert ulp == 0.0625
    assert ulp / (dt.BOLTZ * 300.0) == pytest.approx(0.025, rel=0.01)
