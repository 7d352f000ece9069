"""Kernel B2 of the PyTorch port (ops/sweep_chunked.py) on the CPU: its
plain version, which sums through the kernel's chunk frames and
fixed-order overlap-add, against the JAX TPU kernel
pair_forces_pallas_chunked in interpret mode (2e-5 x max|f|, as
tests/test_pallas_sweep.py) and against the port's B1 plain version at
every brick (f64: 1e-8 x max|f|, sum order only; f32: 2e-5 x max|f|);
the chunk plan's tables (every frame entry added exactly once); the
port's copies of the JAX gates supports/choose_chunk against the JAX
functions; and the routing of a Context's float32 sweep to B2, by the
gates and by {"use_pallas": 3}.  The 216-molecule, 0.6 nm-cutoff config
of tests/test_torch_cellpair.py: 5^3 cells, C = 32."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.forces import cellpair as jcp
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu.ops import pallas_sweep as jps
from openmm_drudenose_tpu_torch.forces import cellpair as tcp
from openmm_drudenose_tpu_torch.forces.drude import DrudeForce
from openmm_drudenose_tpu_torch.forces.nonbonded import NonbondedForce
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
from openmm_drudenose_tpu_torch.system import System
from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
from torch_threads import _one_thread  # noqa: F401

N_MOL, CUTOFF = 216, 0.6
BRICKS = [(1, 1, 1), (2, 2, 2), (3, 3, 3), (4, 4, 4), (5, 5, 5),
          (1, 2, 3), (3, 1, 5), (2, 5, 1)]


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
def ctx32():
    return _contexts("single")


@pytest.fixture(scope="module")
def tctx64():
    return _contexts("double")[1]


def _drifted(ctx, seed, dtype):
    rng = np.random.default_rng(seed)
    pos = np.asarray(ctx._state.positions, np.float64)
    return (pos + rng.uniform(-0.03, 0.03, pos.shape)).astype(dtype)


def _args(tctx, pos):
    nb = tctx._nb
    box = torch.diagonal(tctx._state.box)
    fields = nb.fields(torch.as_tensor(pos), box, tctx._state.neighbors)
    return fields, nb.cfg, tcp.offset_shifts(nb.cfg, box), nb.alpha, \
        ONE_4PI_EPS0


def test_b2_plain_matches_jax_chunked_interpret(ctx32):
    """cy = 1: with wy = 2 > cy the JAX halos span two chunks."""
    jctx, tctx = ctx32
    assert tctx._cp_cfg.grid == (5, 5, 5) and tctx._cp_cfg.capacity == 32
    nb_fn, nb_params = next(t for t in jctx._terms
                            if hasattr(t[0], "cellpair_cfg"))
    pos = _drifted(tctx, 5, np.float32)
    f_ref = np.asarray(jps.pair_forces_pallas_chunked(
        nb_params, jnp.asarray(pos), jnp.diagonal(jctx._state.box),
        jctx._state.neighbors, jctx._cp_cfg, "ewald", 1,
        alpha=nb_fn.pme_setup.alpha, interpret=True))
    f_slots = sweep_chunked.pair_forces(*_args(tctx, pos))
    f = f_slots[tctx._state.neighbors.inv_slot].numpy()
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=2e-5 * np.abs(f_ref).max())


@pytest.fixture(scope="module")
def b1_reference(ctx32, tctx64):
    """Per precision: drifted fields and B1's plain forces on them."""
    out = {}
    for precision, tctx, dtype in (("double", tctx64, np.float64),
                                   ("single", ctx32[1], np.float32)):
        args = _args(tctx, _drifted(tctx, 6, dtype))
        out[precision] = (args, sweep.pair_forces_plain(*args))
    return out


@pytest.mark.parametrize("brick", BRICKS)
@pytest.mark.parametrize("precision", ["double", "single"])
def test_b2_plain_matches_b1_plain(b1_reference, precision, brick):
    args, f1 = b1_reference[precision]
    f2 = sweep_chunked.pair_forces_plain(*args, brick=brick)
    tol = 1e-8 if precision == "double" else 2e-5
    scale = float(torch.max(torch.abs(f1)))
    assert float(torch.max(torch.abs(f2 - f1))) <= tol * scale


@pytest.mark.parametrize("grid", [(5, 5, 5), (7, 6, 5), (33, 33, 33)])
@pytest.mark.parametrize("brick", [(1, 1, 1), (2, 2, 2), (3, 2, 4)])
def test_plan_adds_every_frame_entry_once(tctx64, grid, brick):
    """The overlap-add tables cover every (chunk, frame cell) exactly
    once, and at each offset the home cells' frame rows are distinct
    rows of their own chunk."""
    cfg = dataclasses.replace(tctx64._cp_cfg, grid=grid)
    plan = sweep_chunked.make_plan(cfg, brick)
    n_rows = plan.total_chunks * plan.n_frame_cells
    cover = plan.cover_rows
    assert cover.shape[0] == int(np.prod(grid))
    real = np.sort(cover[cover < n_rows])
    np.testing.assert_array_equal(real, np.arange(n_rows))
    rows = plan.frame_rows
    assert rows.min() >= 0 and rows.max() < n_rows
    for o in range(rows.shape[1]):
        assert len(np.unique(rows[:, o])) == rows.shape[0]
    own_chunk = rows[:, 0] // plan.n_frame_cells
    np.testing.assert_array_equal(rows // plan.n_frame_cells,
                                  np.repeat(own_chunk[:, None],
                                            rows.shape[1], axis=1))
    # a cell's own row is covered in its own chunk's frame
    assert all(rows[c, 0] in cover[c] for c in range(rows.shape[0]))


def test_frame_rows_match_tables(tctx64):
    """The frame row of (cell, offset) lies in the cover list of the cell
    the offset reaches, which is what the overlap-add reads."""
    cfg = tctx64._cp_cfg
    plan = sweep_chunked.make_plan(cfg, (2, 2, 2))
    rows = plan.frame_rows
    cover = plan.cover_rows
    for o in range(cfg.n_offsets):
        for c in range(cfg.n_cells):
            assert rows[c, o] in cover[cfg.nbr_map[c, o]]


def test_choose_brick_fits_the_card(tctx64):
    """Without a register count (the H100's published figures), the brick
    of the JAX 1M configuration's 33^3 grid keeps eight CTAs or more
    resident, and its frames index in int32."""
    cfg = tctx64._cp_cfg
    for C, want, ctas in ((32, (1, 2, 2), 10), (48, (1, 2, 2), 10),
                          (56, (1, 2, 2), 9), (128, (1, 2, 2), 8)):
        c = dataclasses.replace(cfg, capacity=C, grid=(33, 33, 33))
        brick = sweep_chunked.choose_brick(c)
        assert brick == want
        plan = sweep_chunked.make_plan(c, brick)
        assert sweep_chunked.smem_bytes(brick, C) \
            <= sweep_chunked.H100.smem_block
        assert sweep_chunked.resident_ctas(brick, C) == ctas
        assert plan.frame_floats(C) <= sweep_chunked.INT32_MAX
        assert plan.total_chunks >= 132


GRIDS = [None, (15, 15, 15), (30, 30, 30), (32, 32, 32), (33, 33, 33)]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("capacity", [None, 40, 48])
def test_gates_match_jax(ctx32, grid, capacity):
    jctx, tctx = ctx32
    jcfg, tcfg = jctx._cp_cfg, tctx._cp_cfg
    kw = {}
    if grid is not None:
        kw["grid"] = grid
    if capacity is not None:
        kw["capacity"] = capacity
    jcfg = dataclasses.replace(jcfg, **kw)
    tcfg = dataclasses.replace(tcfg, **kw)
    assert sweep.supports(tcfg) == jps.supports(jcfg, jnp.float32)
    for force in (False, True):
        assert sweep.choose_chunk(tcfg, force=force) \
            == jps.choose_chunk(jcfg, jnp.float32, force=force)
    jax_chunked = (not jps.supports(jcfg, jnp.float32)
                   and jps.choose_chunk(jcfg, jnp.float32) is not None)
    kernel, cy = sweep.route(tcfg)
    assert (kernel == "b2") == jax_chunked
    assert cy == (jps.choose_chunk(jcfg, jnp.float32) if jax_chunked
                  else None)


def _slab():
    """Dilute SWM4-NDP water, one molecule in every other cell along y
    and every third along z, in a box whose 5 x 56 x 63 cells (cutoff
    0.6 nm, capacity 8) the JAX gates send to the chunked kernel: the
    (y, z) plane overflows the full-layer kernel's VMEM budget."""
    box = np.array([1.8, 19.7, 22.2])
    system = System()
    nonbonded, drude = NonbondedForce(), DrudeForce()
    system.addForce(nonbonded)
    system.addForce(drude)
    system.setDefaultPeriodicBoxVectors((box[0], 0, 0), (0, box[1], 0),
                                        (0, 0, box[2]))
    nonbonded.setNonbondedMethod(NonbondedForce.PME)
    nonbonded.setCutoffDistance(CUTOFF)
    h = box / np.array([5, 56, 63])
    pos = []
    for i in range(5):
        for j in range(0, 56, 2):
            for k in range(0, 63, 3):
                tbuilders.add_swm4_molecule(system, nonbonded, drude)
                pos.append(tbuilders.swm4_molecule_positions(
                    (np.array([i, j, k]) + 0.5) * h))
    return system, np.concatenate(pos)


def test_context_routes_by_gates_to_b2(monkeypatch):
    system, pos = _slab()
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    ctx = dt.Context(system, integ, precision="single", device="cpu",
                     strategy="cellpair")
    ctx.setPositions(pos)
    ctx._ensure_neighbors()
    nb, cfg = ctx._nb, ctx._cp_cfg
    assert cfg.grid == (5, 56, 63) and cfg.capacity == 8
    assert not sweep.supports(cfg)
    assert nb.sweep_kernel == "b2"
    assert nb.pallas_chunk == sweep.choose_chunk(cfg) is not None
    calls = []
    plain = sweep_chunked.pair_forces_plain

    def spy(*a, **k):
        f = plain(*a, **k)
        calls.append((a, f))
        return f

    monkeypatch.setattr(sweep_chunked, "pair_forces_plain", spy)
    ctx._ensure_forces()
    assert len(calls) == 1
    assert torch.all(torch.isfinite(ctx._state.forces))
    # what the force pass's sweep gave, against B1's plain version on the
    # same fields
    args, f2 = calls[0]                   # (fields, ..., excl_skip, brick)
    f1 = sweep.pair_forces_plain(*args[:6])
    scale = float(torch.max(torch.abs(f1)))
    assert float(torch.max(torch.abs(f2 - f1))) <= 2e-5 * scale


def test_use_pallas_3_forces_b2(monkeypatch):
    system, pos = tbuilders.build_water_box(N_MOL, cutoff=CUTOFF)
    ctxs = {}
    for opts in ({}, {"use_pallas": 3}):
        integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        ctx = dt.Context(system, integ, precision="single", device="cpu",
                         strategy="cellpair", nb_options=opts)
        ctx.setPositions(pos)
        ctxs[bool(opts)] = ctx
    calls = []
    plain = sweep_chunked.pair_forces_plain

    def spy(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(sweep_chunked, "pair_forces_plain", spy)
    ctxs[False]._ensure_forces()
    assert ctxs[False]._nb.sweep_kernel == "b1" and not calls
    ctxs[True]._ensure_forces()
    assert ctxs[True]._nb.sweep_kernel == "b2" and len(calls) == 1
    assert ctxs[True]._nb.pallas_chunk is None   # no JAX chunk at 5^3
    f0, f3 = ctxs[False]._state.forces, ctxs[True]._state.forces
    scale = float(torch.max(torch.abs(f0)))
    assert float(torch.max(torch.abs(f3 - f0))) <= 2e-5 * scale


def test_float64_context_runs_the_plain_sweep(tctx64):
    assert tctx64._nb.sweep_kernel is None


def test_wrapper_refuses_unsupported_config():
    """Like B1's wrapper, B2's takes exclusion masks of two words (the
    kernel takes any number): on the CPU its plain version matches the
    JAX sweep, which runs such a config on XLA, to 2e-5 x max|f|."""
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
    jctx, tctx = out
    assert tctx._cp_cfg.excl_window == 20 and tctx._cp_cfg.excl_words == 2
    nb_fn, nb_params = next(t for t in jctx._terms
                            if hasattr(t[0], "cellpair_cfg"))
    pos = _drifted(tctx, 7, np.float32)
    _, f_ref = jcp.pair_energy_forces(
        nb_params, jnp.asarray(pos), jnp.diagonal(jctx._state.box),
        jctx._state.neighbors, jctx._cp_cfg, nb_fn.pair_eg,
        nb_fn.coulomb_scale, with_energy=False)
    f_ref = np.asarray(f_ref)
    fields, cfg, shifts, alpha, scale = _args(tctx, pos)
    f_slots = sweep_chunked.pair_forces(fields, cfg, shifts, alpha, scale,
                                        excl_skip=False)
    f = f_slots[tctx._state.neighbors.inv_slot].numpy()
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=2e-5 * np.abs(f_ref).max())
