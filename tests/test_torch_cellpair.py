"""Cell sort and direct-space sweep of the PyTorch port against the JAX
package: identical plan and slot tables, the same latches (overflow,
drift, excl span; the twins of tests/test_cellpair.py and
tests/test_excl_span.py), the plain sweep against the JAX
_sweep_regular (f64: energy 1e-10, forces 1e-8 x max|f|; f32: 2e-5 x
max|f|), and kernel B1's plain version against the JAX TPU kernel run in
interpret mode (2e-5 x max|f|, as tests/test_pallas_sweep.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.forces import cellpair as jcp
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu.ops import pallas_sweep as jps
from openmm_drudenose_tpu_torch.core.state import SimState
from openmm_drudenose_tpu_torch.forces import cellpair as tcp
from openmm_drudenose_tpu_torch.integrators import tgnh
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from openmm_drudenose_tpu_torch.ops import sweep
from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
from torch_threads import _one_thread  # noqa: F401

N_MOL, CUTOFF = 216, 0.6


def _contexts(precision):
    jsys, pos = jbuilders.build_water_box(N_MOL, cutoff=CUTOFF)
    tsys, _ = tbuilders.build_water_box(N_MOL, cutoff=CUTOFF)
    out = []
    for pkg, system, kw in ((dn, jsys, {"strategy": "cellpair"}),
                            (dt, tsys, {"device": "cpu",
                                         "strategy": "cellpair"})):
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        ctx = pkg.Context(system, integ, precision=precision, **kw)
        ctx.setPositions(pos)
        ctx._ensure_neighbors()
        out.append(ctx)
    return out


@pytest.fixture(scope="module")
def ctx64():
    return _contexts("double")


@pytest.fixture(scope="module")
def ctx32():
    return _contexts("single")


def _drifted(ctx, seed, dtype):
    rng = np.random.default_rng(seed)
    pos = np.asarray(ctx._state.positions, np.float64)
    return (pos + rng.uniform(-0.03, 0.03, pos.shape)).astype(dtype)


def test_plan_and_slot_tables_match(ctx64):
    jctx, tctx = ctx64
    jc, tc = jctx._cp_cfg, tctx._cp_cfg
    assert tc.grid == jc.grid and tc.capacity == jc.capacity
    assert tc.window == tuple(jc.window)
    np.testing.assert_array_equal(tc.offsets, np.array(jc.offsets))
    nbr_flat, nbr_shape = jc.nbr_map
    np.testing.assert_array_equal(
        tc.nbr_map, np.array(nbr_flat).reshape(nbr_shape))
    assert tc.excl_window == jc.excl_window
    jn, tn = jctx._state.neighbors, tctx._state.neighbors
    np.testing.assert_array_equal(tn.slot_atom.numpy(),
                                  np.asarray(jn.slot_atom))
    np.testing.assert_array_equal(tn.inv_slot.numpy(),
                                  np.asarray(jn.inv_slot))
    np.testing.assert_array_equal(tn.image.numpy(), np.asarray(jn.image))
    assert not bool(tn.overflow) and not bool(jn.overflow)


def test_exclusion_words_match(ctx64):
    jctx, tctx = ctx64
    jparams = next(t for t in jctx._terms
                   if hasattr(t[0], "cellpair_cfg"))[1]
    np.testing.assert_array_equal(
        tctx._nb.params["excl_words"].numpy(),
        np.asarray(jparams["excl_words"]))


def test_overflow_latch_matches():
    rng = np.random.default_rng(0)
    n, L = 500, 3.0
    pos = rng.uniform(0, L, (n, 3))
    pos[:40] = 0.1 + rng.uniform(0, 0.05, (40, 3))       # one dense cell
    for cap in (16, 64):
        jc = jcp.make_config(1.0, [L] * 3, n, [], [], capacity=cap)
        tc = tcp.make_config(1.0, [L] * 3, n, [], [], capacity=cap)
        js = jcp.build_cellsort(jnp.asarray(pos), jnp.asarray([L] * 3), jc)
        ts = tcp.build_cellsort(torch.as_tensor(pos),
                                torch.as_tensor([L] * 3), tc)
        assert bool(ts.overflow) == bool(js.overflow) == (cap == 16)
        if cap == 64:
            np.testing.assert_array_equal(ts.slot_atom.numpy(),
                                          np.asarray(js.slot_atom))


def _span_cfg():
    box = np.array([2.0, 2.0, 2.0])
    cfg = tcp.make_config(0.4, box, 6, [0], [1], skin=0.1)
    assert cfg.grid == (8, 8, 8)
    return cfg, torch.as_tensor(box, dtype=torch.float32)


def _sort(pos, excl):
    cfg, box = _span_cfg()
    ij = None if excl is None else tuple(torch.as_tensor(e) for e in excl)
    return tcp.build_cellsort(torch.as_tensor(pos, dtype=torch.float32),
                              box, cfg, excl_ij=ij)


def test_excl_span_latch():
    pos = np.full((6, 3), 1.0)
    pos[2] = [0.30, 1.0, 1.0]
    pos[3] = [0.95, 1.0, 1.0]          # two cells apart
    assert bool(_sort(pos, ([2], [3])).excl_span_exceeded)
    pos = np.full((6, 3), 1.0)
    pos[0], pos[1] = [0.30, 1.0, 1.0], [0.45, 1.0, 1.0]
    pos[2], pos[3] = [0.01, 0.5, 0.5], [1.99, 0.5, 0.5]   # via the wrap
    assert not bool(_sort(pos, ([0, 2], [1, 3])).excl_span_exceeded)
    assert _sort(pos, None).excl_span_exceeded is None


def _fake_state(pos, neighbors):
    z = torch.zeros(())
    p = torch.as_tensor(pos, dtype=torch.float32)
    return SimState(positions=p, velocities=p, forces=p,
                    potential_energy=z, box=torch.eye(3) * 2.0, eta=z,
                    eta_dot=z, eta_dot_dot=z, ke_sum=z, group_ke=z,
                    neighbors=neighbors)


def test_rebuild_latches_carry_forward():
    """Excl-span and drift latches survive a rebuild at healthy positions;
    a > 2x skin move latches drift."""
    cfg, _ = _span_cfg()
    good = np.full((6, 3), 1.0)
    good[2], good[3] = [0.30, 1.0, 1.0], [0.40, 1.0, 1.0]
    bad = good.copy()
    bad[3] = [0.95, 1.0, 1.0]
    excl = ([2], [3])
    latched = _sort(bad, excl)
    latched.ref_positions = torch.as_tensor(good, dtype=torch.float32)
    fn = lambda p, b: tcp.build_cellsort(
        p, torch.diagonal(b), cfg,
        excl_ij=tuple(torch.as_tensor(e) for e in excl))
    out = tgnh.rebuild_neighbors(_fake_state(good, latched), fn, cfg.skin)
    assert bool(out.neighbors.excl_span_exceeded)
    assert not bool(out.neighbors.drift_exceeded)
    moved = good.copy()
    moved[0] += [0.25, 0.0, 0.0]      # > 2x the 0.1 nm skin
    out = tgnh.rebuild_neighbors(_fake_state(moved, out.neighbors), fn,
                                 cfg.skin)
    assert bool(out.neighbors.drift_exceeded)


def _jax_nb(jctx):
    return next(t for t in jctx._terms if hasattr(t[0], "cellpair_cfg"))


@pytest.mark.parametrize("drift", [False, True])
def test_sweep_f64_matches_jax(ctx64, drift):
    jctx, tctx = ctx64
    nb_fn, nb_params = _jax_nb(jctx)
    pos = (_drifted(tctx, 1, np.float64) if drift
           else tctx._state.positions.numpy())
    jbox = jnp.diagonal(jctx._state.box)
    e_ref, f_ref = jcp.pair_energy_forces(
        nb_params, jnp.asarray(pos), jbox, jctx._state.neighbors,
        jctx._cp_cfg, nb_fn.pair_eg, nb_fn.coulomb_scale, with_energy=True)
    nb = tctx._nb
    tbox = torch.diagonal(tctx._state.box)
    p = torch.as_tensor(pos)
    e = nb.sweep_energy(p, tbox, tctx._state.neighbors)
    f = nb.sweep_forces(p, tbox, tctx._state.neighbors)
    f_ref = np.asarray(f_ref)
    np.testing.assert_allclose(float(e), float(e_ref), rtol=1e-10)
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())


def _port_b1_plain(tctx, pos):
    nb = tctx._nb
    tbox = torch.diagonal(tctx._state.box)
    p = torch.as_tensor(pos)
    fields = nb.fields(p, tbox, tctx._state.neighbors)
    shifts = tcp.offset_shifts(nb.cfg, tbox)
    f_slots = sweep.pair_forces(fields, nb.cfg, shifts, nb.alpha,
                                ONE_4PI_EPS0, excl_skip=True)
    return f_slots[tctx._state.neighbors.inv_slot].numpy()


def test_b1_plain_matches_jax_sweep_f32(ctx32):
    jctx, tctx = ctx32
    nb_fn, nb_params = _jax_nb(jctx)
    pos = _drifted(tctx, 2, np.float32)
    _, f_ref = jcp.pair_energy_forces(
        nb_params, jnp.asarray(pos), jnp.diagonal(jctx._state.box),
        jctx._state.neighbors, jctx._cp_cfg, nb_fn.pair_eg,
        nb_fn.coulomb_scale, with_energy=False)
    f_ref = np.asarray(f_ref)
    f = _port_b1_plain(tctx, pos)
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=2e-5 * np.abs(f_ref).max())


def test_b1_plain_matches_jax_pallas_interpret(ctx32):
    jctx, tctx = ctx32
    nb_fn, nb_params = _jax_nb(jctx)
    pos = _drifted(tctx, 3, np.float32)
    f_ref = np.asarray(jps.pair_forces_pallas(
        nb_params, jnp.asarray(pos), jnp.diagonal(jctx._state.box),
        jctx._state.neighbors, jctx._cp_cfg, "ewald",
        alpha=nb_fn.pme_setup.alpha, interpret=True))
    f = _port_b1_plain(tctx, pos)
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=2e-5 * np.abs(f_ref).max())


def _two_word_contexts():
    """The JAX and the port's f32 Context with one more exclusion, over 20
    atom indices: W = 20, two mask words."""
    out = []
    for pkg, build, kw in ((dn, jbuilders, {"strategy": "cellpair"}),
                           (dt, tbuilders, {"device": "cpu",
                                              "strategy": "cellpair"})):
        system, pos = build.build_water_box(N_MOL, cutoff=CUTOFF)
        nonbonded = next(f for f in system.getForces()
                         if type(f).__name__ == "NonbondedForce")
        nonbonded.addException(0, 20, 0.0, 1.0, 0.0)
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        ctx = pkg.Context(system, integ, precision="single", **kw)
        ctx.setPositions(pos)
        ctx._ensure_neighbors()
        out.append(ctx)
    return out


def test_kernel_wrapper_refuses_unsupported_config():
    """The wrapper takes exclusion masks of two words (the kernel takes
    any number): on the CPU its plain version matches the JAX sweep, which
    runs such a config on XLA, to 2e-5 x max|f|."""
    jctx, tctx = _two_word_contexts()
    assert tctx._cp_cfg.excl_window == 20 and tctx._cp_cfg.excl_words == 2
    nb_fn, nb_params = _jax_nb(jctx)
    pos = _drifted(tctx, 4, np.float32)
    _, f_ref = jcp.pair_energy_forces(
        nb_params, jnp.asarray(pos), jnp.diagonal(jctx._state.box),
        jctx._state.neighbors, jctx._cp_cfg, nb_fn.pair_eg,
        nb_fn.coulomb_scale, with_energy=False)
    f_ref = np.asarray(f_ref)
    nb = tctx._nb
    box = torch.diagonal(tctx._state.box)
    fields = nb.fields(torch.as_tensor(pos), box, tctx._state.neighbors)
    f_slots = sweep.pair_forces(fields, nb.cfg, tcp.offset_shifts(nb.cfg,
                                box), nb.alpha, ONE_4PI_EPS0,
                                excl_skip=False)
    f = f_slots[tctx._state.neighbors.inv_slot].numpy()
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=2e-5 * np.abs(f_ref).max())
