"""The work-sharded force pass and step of the PyTorch port
(parallel/sharded.py) on CPU gloo ranks, in f64, against the JAX
package: the counterpart of tests/test_sharded.py.

The JAX sharded function equals the JAX single-device Context to
rounding (its own tests pin that), so the port's engine is held against
the JAX Context's force pass and trajectory, and against the JAX sharded
function for a force pass on conftest's 8 virtual devices.  The system
is tests/test_sharded.py's swm4_water_box(grid_size=3) at a 0.7 nm
cutoff: at 1.0 nm its 2.4 nm box has no regular cell grid, which the
port's cell-pair sweep needs; at 0.7 nm it has 6^3 cells (72 a rank on
3 ranks, 27 a device on 8) and a 30^3 PME grid.  Tolerances (ROADMAP.md):
energies 1e-10 relative, forces 1e-8 of max|F|, positions 1e-10 nm,
the NH chain 1e-12; the ranks' states equal bit for bit.  Also the
plain sweep's home-slab range (ops/sweep.py, forces/cellpair.py),
grid_x_multiple against the JAX planner, and the refusals."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
import torch_ranks
import util
from openmm_drudenose_tpu.app import serialization as jser
from openmm_drudenose_tpu.forces import cellpair as jcp
from openmm_drudenose_tpu.parallel import sharded as jsharded
from openmm_drudenose_tpu_torch.app import serialization as tser
from openmm_drudenose_tpu_torch.forces import cellpair as tcp
from openmm_drudenose_tpu_torch.ops import sweep
from openmm_drudenose_tpu_torch.parallel import sharded
from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
from torch_threads import _one_thread  # noqa: F401

CUTOFF = 0.7
RANKS = 3
STEPS = 8
METHODS = (dn.NonbondedForce.PME, dn.NonbondedForce.CutoffPeriodic)


def _jax_context(method):
    """tests/test_sharded.py's _context at CUTOFF."""
    system, positions = util.swm4_water_box(grid_size=3, cutoff=CUTOFF,
                                            add_cm_motion=False)
    system.getForce(0).setNonbondedMethod(method)
    integ = dn.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005, 0.0005, 20, 2)
    integ.setMaxDrudeDistance(0.05)
    ctx = dn.Context(system, integ, precision="double", strategy="cellpair")
    ctx.setPositions(positions)
    ctx.applyConstraints(1e-6)
    ctx.setVelocitiesToTemperature(200.0, seed=0)
    ctx._ensure_forces()
    return ctx, integ, system


def _inputs(jctx, system):
    return (jser.serialize_system(system),
            np.asarray(jctx._state.positions),
            np.asarray(jctx._state.velocities))


def _growth_inputs():
    """The PME box, its positions as built and numpy velocities (the
    growth and barostat runs hold the port against itself)."""
    system, positions = util.swm4_water_box(grid_size=3, cutoff=CUTOFF,
                                            add_cm_motion=False)
    system.getForce(0).setNonbondedMethod(dn.NonbondedForce.PME)
    velocities = np.random.default_rng(5).normal(
        size=positions.shape) * 0.3
    velocities[4::5] = 0.0                 # the M sites (virtual)
    return jser.serialize_system(system), positions, velocities


@pytest.fixture(scope="module")
def runs():
    """The JAX Contexts of both methods, and the port's runs on RANKS
    ranks (torch_ranks.sharded_suite) started beside the JAX work."""
    jax_runs = {m: _jax_context(m) for m in METHODS}
    fut = torch_ranks.launch_beside(
        torch_ranks.sharded_suite, RANKS,
        *(_inputs(jctx, system) for jctx, _, system in jax_runs.values()),
        _growth_inputs(), STEPS)
    return jax_runs, fut


@pytest.mark.parametrize("method", METHODS)
def test_sharded_force_pass_and_steps(runs, method):
    """The sharded force pass on 3 ranks against the JAX Context's (and,
    with PME, the JAX sharded function's on 8 virtual devices); with PME,
    STEPS ShardedContext steps against the JAX Context's, the ranks
    bit-identical."""
    jax_runs, fut = runs
    jctx, jinteg, _ = jax_runs[method]
    pme = method == dn.NonbondedForce.PME
    st = jctx._state
    pe, f = jax.jit(jctx._energy_and_forces)(st.positions, st.box,
                                             st.neighbors)
    refs = [(float(pe), np.asarray(f))]
    if pme:
        mesh = Mesh(np.array(jax.devices()[:8]), ("atom",))
        with mesh:
            pe_s, f_s = jax.jit(jsharded.make_sharded_energy_and_forces(
                jctx, mesh))(st.positions, st.box, st.neighbors)
        refs.append((float(pe_s), np.asarray(f_s)))
        jinteg.step(STEPS)
    got = [r["pme" if pme else "rf"] for r in fut.result()]
    scale = np.abs(refs[0][1]).max()
    for out in got:
        for ref_e, ref_f in refs:
            np.testing.assert_allclose(out["e"], ref_e, rtol=1e-10)
            np.testing.assert_allclose(out["f"], ref_f, atol=1e-8 * scale)
        # and the port's own one-rank pass, to the order of the sums
        np.testing.assert_allclose(out["e"], out["e1"], rtol=1e-12)
        np.testing.assert_allclose(out["f"], out["f1"], atol=1e-12 * scale)
        assert out["f"].tobytes() == got[0]["f"].tobytes()
    if pme:
        for out in got:
            np.testing.assert_allclose(out["positions"],
                                       np.asarray(jctx._state.positions),
                                       atol=1e-10)
            np.testing.assert_allclose(out["eta"],
                                       np.asarray(jctx._state.eta),
                                       atol=1e-12)
            assert out["positions"].tobytes() == \
                got[0]["positions"].tobytes()
            assert out["eta"].tobytes() == got[0]["eta"].tobytes()


def test_sharded_context_keeps_growth_and_barostat(runs):
    """Context.step's machinery under the sharded pass (3 ranks): a cell
    capacity too small, grown before the first step (the recompile's
    Stepper takes the sharded pass), and a MonteCarloBarostat attempting
    every other step; each against the port's one-rank Context stepped
    alike (positions 1e-10 nm, the same box and capacity), the ranks'
    positions the same bits."""
    got = runs[1].result()
    for out in got:
        for case in ("growth", "npt"):
            r = out[case]
            assert r["dx"] <= 1e-10
            np.testing.assert_allclose(r["box"][0], r["box"][1], rtol=1e-12)
            assert r["capacity"][0] == r["capacity"][1]
            assert r["sharded_stepper"]
            assert r["positions"].tobytes() == \
                got[0][case]["positions"].tobytes()
        assert out["growth"]["capacity"][0] > 2
        # a volume move was accepted (the box starts at 2.4 nm)
        assert abs(out["npt"]["box"][0][0, 0] - 2.4) > 1e-6


def _port_context(method, nb_options=None, precision="double"):
    js, positions = util.swm4_water_box(grid_size=3, cutoff=CUTOFF,
                                        add_cm_motion=False)
    js.getForce(0).setNonbondedMethod(method)
    system = tser.deserialize_system(jser.serialize_system(js))
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005, 0.0005, 20, 2)
    ctx = dt.Context(system, integ, precision=precision,
                     strategy="cellpair", device="cpu",
                     nb_options=nb_options)
    ctx.setPositions(positions)
    ctx._ensure_neighbors()
    return ctx


@pytest.mark.parametrize("precision", ["double", "single"])
def test_slab_range_of_the_plain_sweep(precision):
    """The home-slab range of the plain sweep (cellpair.sweep) and of
    B1's plain versions: the full range is the whole sweep bit for bit,
    the x-slabs of 3 ranks sum to it (to rounding), an empty range is
    zero, and a range outside the grid raises."""
    ctx = _port_context(dn.NonbondedForce.PME, precision=precision)
    nb, cfg, st = ctx._nb, ctx._cp_cfg, ctx._state
    box = torch.diagonal(st.box)
    fields = nb.fields(st.positions, box, st.neighbors)
    args = (fields, cfg, tcp.offset_shifts(cfg, box), nb.alpha,
            ONE_4PI_EPS0)
    nc = cfg.n_cells
    m = nc // RANKS
    slabs = [(d * m, (d + 1) * m) for d in range(RANKS)]
    if precision == "double":
        e, f = tcp.sweep(*args)
        parts = [tcp.sweep(*args, cells=c) for c in slabs]
        e_full, f_full = tcp.sweep(*args, cells=(0, nc))
        e_none, f_none = tcp.sweep(*args, cells=(5, 5))
        tol = 1e-12
    else:
        e, f = sweep.pair_energy(*args), sweep.pair_forces(*args)
        parts = [(sweep.pair_energy(*args, cells=c),
                  sweep.pair_forces(*args, cells=c)) for c in slabs]
        e_full = sweep.pair_energy(*args, cells=(0, nc))
        f_full = sweep.pair_forces(*args, cells=(0, nc))
        e_none = sweep.pair_energy(*args, cells=(5, 5))
        f_none = sweep.pair_forces(*args, cells=(5, 5))
        tol = 2e-6
    assert torch.equal(e_full, e) and torch.equal(f_full, f)
    assert float(e_none) == 0.0 and not torch.any(f_none)
    scale = float(torch.max(torch.abs(f)))
    assert float(torch.max(torch.abs(sum(p[1] for p in parts) - f))) \
        <= tol * scale
    np.testing.assert_allclose(float(sum(p[0] for p in parts)), float(e),
                               rtol=tol)
    with pytest.raises(ValueError, match="cell range"):
        tcp.sweep(*args, cells=(0, nc + 1))


@pytest.mark.parametrize("multiple", [2, 3])
def test_grid_x_multiple_matches_jax(multiple):
    """nb_options grid_x_multiple plans the JAX make_config's grid."""
    ctx = _port_context(dn.NonbondedForce.PME, {"grid_x_multiple": multiple})
    box = np.diagonal(np.asarray(ctx._system.getDefaultPeriodicBoxVectors()))
    want = jcp.make_config(CUTOFF, box, ctx._static.n_atoms, [0], [1],
                           grid_x_multiple=multiple)
    assert ctx._cp_cfg.grid == tuple(want.grid)
    assert ctx._cp_cfg.grid[0] % multiple == 0


class _Ranks:
    """A stand-in for a Mesh of n ranks along "atom" (rank 0): what the
    refusals read."""

    def __init__(self, n):
        self.n = n

    def size(self, axis):
        return self.n

    def index(self, axis):
        return 0


def test_refusals():
    """The JAX module's refusals: the cell-pair strategy only, a cell grid
    whose x (x-slabs) and cell count divide into the ranks, PME and a PME
    grid divisible in x and y for the distributed FFT."""
    ctx = _port_context(dn.NonbondedForce.PME)            # 6^3 cells
    with pytest.raises(ValueError, match="divide into 5 ranks"):
        sharded.ShardedForcePass(ctx, _Ranks(5))
    # 216 cells divide into 4 ranks, the 6 x-planes do not
    with pytest.raises(ValueError, match="divide into 4 ranks"):
        sharded.ShardedForcePass(ctx, _Ranks(4))
    sharded.ShardedForcePass(ctx, _Ranks(3), distributed_fft=True)
    # (8, 9, 9) cells in 2 x-slabs, a (48, 45, 45) PME grid: y is odd
    js, positions = util.swm4_water_box(grid_size=5, cutoff=CUTOFF,
                                        add_cm_motion=False)
    js.getForce(0).setNonbondedMethod(dn.NonbondedForce.PME)
    wide = dt.Context(tser.deserialize_system(jser.serialize_system(js)),
                      dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005, 0.0005,
                                             20, 2), precision="double",
                      strategy="cellpair", device="cpu",
                      nb_options={"grid_x_multiple": 2})
    assert wide._nb.pme.grid[1] % 2
    sharded.ShardedForcePass(wide, _Ranks(2))
    with pytest.raises(ValueError, match="PME grid"):
        sharded.ShardedForcePass(wide, _Ranks(2), distributed_fft=True)
    rf = _port_context(dn.NonbondedForce.CutoffPeriodic)
    with pytest.raises(ValueError, match="requires PME"):
        sharded.ShardedForcePass(rf, _Ranks(2), distributed_fft=True)
    js, positions = util.swm4_water_box(grid_size=2, add_cm_motion=False)
    system = tser.deserialize_system(jser.serialize_system(js))
    dense = dt.Context(system, dt.DrudeTGNHIntegrator(
        300.0, 0.1, 1.0, 0.005, 0.0005, 20, 2), precision="double",
        strategy="dense", device="cpu")
    with pytest.raises(ValueError, match="cellpair strategy"):
        sharded.ShardedForcePass(dense, _Ranks(2))
