"""The flattened replica ensemble through the PyTorch port, against the
JAX package on the CPU with seeded numpy inputs: the ensemble cell-pair
plan (grid, periods, offsets, the band-wrapped neighbour map and its
reverse, the replica and local index of every cell: equal); the plain
versions of kernels B1 and B2 on banded fields against the JAX XLA
ensemble sweep in f64 (energy 1e-10, forces 1e-8 of max|F|); B2's
band-wrapped plan tables against a brute-force cover of each band,
also where the brick does not divide a band; replicas isolated bit for
bit; the ensemble plan of 64 x 4k SWM4-NDP (JAX `_auto_layout` (7, 10),
grid, capacity, stencil, PME grid, the pencil gate, the route to B1);
FlatReplicaEnsemble against the JAX one (PE 1e-10, forces 1e-8 of
max|F|, 32 TGNH steps 1e-9, the per-replica accessors), padded too;
against independent port Contexts; flat NPT builds with unit scales.
The TPU kernels
in interpret mode against the plain versions: test_torch_flatrep_
interpret.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.forces import cellpair as jcp
from openmm_drudenose_tpu.forces import pme as jpme
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu.parallel.flatrep import \
    FlatReplicaEnsemble as JaxFlat
from openmm_drudenose_tpu_torch import convert
from openmm_drudenose_tpu_torch.forces import cellpair as tcp
from openmm_drudenose_tpu_torch.forces import pme as tpme
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
from openmm_drudenose_tpu_torch.parallel import flatrep
from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
from torch_threads import _one_thread  # noqa: F401

# tests/test_flatrep.py's replica: 96 random LJ particles in a 1.6 nm box
N0, L, CUTOFF = 96, 1.6, 0.5
ALPHA = 3.0


def lj_ensemble(R, seed=5, box=(L, L, L)):
    """R replicas of N0 random charged LJ particles, replica-major, with
    the template's exclusions (i, i + 1) and (i, i + 3) for i = 0, 4,
    .., 20 copied into every replica: (positions, charge, sigma, eps,
    template exclusions, all exclusions)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (R * N0, 3)) * np.asarray(box)
    q = rng.normal(0, 0.2, R * N0)
    sig = rng.uniform(0.2, 0.3, R * N0)
    eps = rng.uniform(0.1, 0.8, R * N0)
    ti = np.array([i for i in range(0, 24, 4)] * 2)
    tj = ti + np.repeat([1, 3], 6)
    off = np.repeat(np.arange(R) * N0, len(ti))
    return (pos, q, sig, eps, (ti, tj),
            (np.tile(ti, R) + off, np.tile(tj, R) + off))


@pytest.mark.parametrize("rx,rz", [(2, 2), (1, 4), (3, 2)])
def test_ensemble_config_matches_jax(rx, rz):
    R = rx * rz
    jc = jcp.make_ensemble_config(CUTOFF, [L] * 3, N0, R, [0], [3], rx=rx,
                                  rz=rz, skin=0.1, capacity=16)
    tc = tcp.make_ensemble_config(CUTOFF, [L] * 3, N0, R, [0], [3], rx=rx,
                                  rz=rz, capacity=16)
    assert tc.grid == jc.grid and tc.phys_grid == jc.phys_grid
    assert (tc.n_replicas, tc.x_period, tc.z_period) == (
        jc.n_replicas, jc.x_period, jc.z_period)
    assert tc.bands == (rx, rz)
    assert (tc.capacity, tc.window, tc.trimmed, tc.excl_window,
            tc.excl_words) == (jc.capacity, jc.window, jc.trimmed,
                               jc.excl_window, jc.excl_words)
    np.testing.assert_array_equal(tc.offsets, np.array(jc.offsets))
    np.testing.assert_array_equal(
        tc.nbr_map, np.array(jc.nbr_map[0]).reshape(jc.nbr_map[1]))
    np.testing.assert_array_equal(
        sweep.reverse_neighbors(tc),
        np.array(jc.inv_map[0]).reshape(jc.inv_map[1]))
    np.testing.assert_array_equal(tcp.rep_of_cell(tc), jcp.rep_of_cell(jc))
    np.testing.assert_array_equal(tcp.local_c3(tc), jcp._local_c3(jc))
    # the capacity the JAX package plans with none given
    auto_j = jcp.make_ensemble_config(CUTOFF, [L] * 3, N0, R, [], [],
                                      rx=rx, rz=rz)
    auto_t = tcp.make_ensemble_config(CUTOFF, [L] * 3, N0, R, [], [],
                                      rx=rx, rz=rz)
    assert auto_t.capacity == auto_j.capacity
    with pytest.raises(ValueError, match="n_replicas"):
        tcp.make_ensemble_config(CUTOFF, [L] * 3, N0, R + 1, [], [],
                                 rx=rx, rz=rz)


@pytest.fixture(scope="module")
def ens_case():
    """A 2 x 2 ensemble of the random LJ replicas with exclusions, sorted
    by both packages; the JAX XLA ensemble sweep (the kernels' A&S
    erfc) in f64 and the port's fields."""
    rx, rz = 2, 2
    R = rx * rz
    pos, q, sig, eps, (ti, tj), (ei, ej) = lj_ensemble(R)
    jc = jcp.make_ensemble_config(CUTOFF, [L] * 3, N0, R, ti, tj, rx=rx,
                                  rz=rz, skin=0.1, capacity=16)
    words = jcp.build_exclusion_words(R * N0, ei, ej, jc.excl_window,
                                      jc.excl_words)
    params = {"charge": jnp.asarray(q), "sigma": jnp.asarray(sig),
              "eps": jnp.asarray(eps), "excl_words": jnp.asarray(words)}
    box = jnp.asarray([L] * 3)
    nbl = jcp.build_cellsort(jnp.asarray(pos), box, jc)
    pair_eg = jcp.make_pair_eg("ewald", CUTOFF, alpha=ALPHA,
                               erfc_fn=jcp.erfc_approx, excl_in_sweep=False)
    e_ref, f_ref = jcp.pair_energy_forces(params, jnp.asarray(pos), box,
                                          nbl, jc, pair_eg, ONE_4PI_EPS0)
    tc = tcp.make_ensemble_config(CUTOFF, [L] * 3, N0, R, ti, tj, rx=rx,
                                  rz=rz, capacity=16)
    tparams = {"charge": torch.as_tensor(q), "sigma": torch.as_tensor(sig),
               "eps": torch.as_tensor(eps),
               "excl_words": torch.as_tensor(tcp.build_exclusion_words(
                   R * N0, ei, ej, tc.excl_window, tc.excl_words))}
    tpos, tbox = torch.as_tensor(pos), torch.as_tensor([L] * 3,
                                                       dtype=torch.float64)
    tnbl = tcp.build_cellsort(tpos, tbox, tc)
    np.testing.assert_array_equal(tnbl.slot_atom.numpy(),
                                  np.asarray(nbl.slot_atom))
    np.testing.assert_array_equal(tnbl.image.numpy(), np.asarray(nbl.image))
    assert not bool(tnbl.overflow) and not bool(tnbl.stencil_invalid)
    fields = tcp.sorted_fields(tparams, tpos, tbox, tnbl, tc)
    args = (fields, tc, tcp.offset_shifts(tc, tbox), ALPHA, ONE_4PI_EPS0)
    return dict(args=args, inv=tnbl.inv_slot, e_ref=float(e_ref),
                f_ref=np.asarray(f_ref), tparams=tparams, tc=tc, pos=pos)


@pytest.mark.parametrize("version", ["b1", "b2"])
def test_plain_versions_match_jax_xla_ensemble_sweep(ens_case, version):
    c = ens_case
    kernel = sweep if version == "b1" else sweep_chunked
    f = kernel.pair_forces(*c["args"], excl_skip=False)[c["inv"]].numpy()
    np.testing.assert_allclose(f, c["f_ref"], rtol=0,
                               atol=1e-8 * np.abs(c["f_ref"]).max())
    e, _ = tcp.sweep(*c["args"], erfc_fn=tcp.erfc_approx)
    np.testing.assert_allclose(float(e), c["e_ref"], rtol=1e-10)


def _brute_cover(cfg, brick):
    """{(chunk, frame cell): the cell it stands for}, by walking every
    home cell of every chunk through every offset (chunks numbered as
    the plan numbers them: each band of each dimension cut into its own
    ceil(period / brick) chunks), and whether any chunk's home cells
    span two bands."""
    periods = cfg.phys_grid
    per_band = [-(-p // b) for p, b in zip(periods, brick)]
    n_chunks = [g // p * k for g, p, k in zip(cfg.grid, periods, per_band)]
    lo = np.asarray(cfg.offsets).min(axis=0)
    hi = np.asarray(cfg.offsets).max(axis=0)
    frame = np.asarray(brick) + hi - lo
    cover, straddles = {}, False
    for chunk in np.ndindex(*n_chunks):
        bands = set()
        for home in np.ndindex(*brick):
            band = [c // k for c, k in zip(chunk, per_band)]
            loc = [(c % k) * b + h for c, k, b, h in
                   zip(chunk, per_band, brick, home)]
            if any(v >= p for v, p in zip(loc, periods)):
                continue                       # past the band's edge
            bands.add(tuple(band))
            for o in cfg.offsets:
                cell = [bd * p + (v + od) % p for bd, p, v, od in
                        zip(band, periods, loc, o)]
                fcell = tuple(np.asarray(home) + o - lo)
                assert all(0 <= f < fr for f, fr in zip(fcell, frame))
                key = (chunk, fcell)
                assert cover.setdefault(key, tuple(cell)) == tuple(cell)
        straddles |= len(bands) > 1
    return cover, straddles


@pytest.mark.parametrize("brick", [(1, 2, 2), (2, 2, 3), (1, 1, 5)])
def test_b2_plan_covers_each_band(brick):
    """Every frame cell a home cell writes stands for one cell of its
    band, and that cell's cover lists it (and lists nothing else that
    is written); no chunk spans two bands, though the brick does not
    divide the period of 5 for (1, 2, 2) and (2, 2, 3) (a brick laid
    over the whole grid would straddle every other band edge)."""
    cfg = tcp.make_ensemble_config(CUTOFF, [L] * 3, N0, 6, [], [], rx=2,
                                   rz=3, capacity=16)
    plan = sweep_chunked.make_plan(cfg, brick)
    assert plan.periods == (5, 5, 5) and plan.brick == brick
    assert plan.n_chunks == tuple(
        g // 5 * -(-5 // b) for g, b in zip(cfg.grid, brick))
    cover, straddles = _brute_cover(cfg, brick)
    assert not straddles
    f = plan.frame
    n_chunk = plan.n_chunks
    listed = {}
    for cell in range(cfg.n_cells):
        c3 = np.unravel_index(cell, cfg.grid)
        for d, tab in enumerate(plan.tables):
            assert np.all(tab[c3[d], :, 0][tab[c3[d], :, 0] < 0] == -1)
        for i in plan.tables[0][c3[0]]:
            for j in plan.tables[1][c3[1]]:
                for k in plan.tables[2][c3[2]]:
                    if i[0] < 0 or j[0] < 0 or k[0] < 0:
                        continue
                    key = ((i[0], j[0], k[0]), (i[1], j[1], k[1]))
                    assert key not in listed
                    listed[key] = c3
    for key, cell in cover.items():
        assert listed[key] == cell, key
    # the plain version's rows agree with the tables
    rows = plan.frame_rows
    nf = int(np.prod(f))
    for cell in range(0, cfg.n_cells, 7):
        for o in range(cfg.n_offsets):
            chunk, fcell = divmod(int(rows[cell, o]), nf)
            key = (np.unravel_index(chunk, n_chunk),
                   np.unravel_index(fcell, f))
            key = (tuple(int(v) for v in key[0]),
                   tuple(int(v) for v in key[1]))
            nb = np.unravel_index(cfg.nbr_map[cell, o], cfg.grid)
            assert cover[key] == tuple(int(v) for v in nb)


@pytest.mark.parametrize("version", ["b1", "b2"])
def test_replicas_isolated(ens_case, version):
    """Moving every atom of replica 0 changes its forces and leaves every
    other replica's, bit for bit."""
    c = ens_case
    kernel = sweep if version == "b1" else sweep_chunked
    tc, tbox = c["tc"], torch.as_tensor([L] * 3, dtype=torch.float64)

    def forces(pos):
        tpos = torch.as_tensor(pos)
        nbl = tcp.build_cellsort(tpos, tbox, tc)
        fields = tcp.sorted_fields(c["tparams"], tpos, tbox, nbl, tc)
        return kernel.pair_forces(fields, tc, tcp.offset_shifts(tc, tbox),
                                  ALPHA, ONE_4PI_EPS0)[nbl.inv_slot]

    fa = forces(c["pos"])
    moved = c["pos"].copy()
    rng = np.random.default_rng(3)
    moved[:N0] = np.mod(moved[:N0] + rng.normal(0, 0.05, (N0, 3)), L)
    fb = forces(moved)
    assert float(torch.max(torch.abs(fa[:N0] - fb[:N0]))) > 1e-6
    assert torch.equal(fa[N0:], fb[N0:])


def test_plan_of_64_waters_4k_matches_jax():
    """The ensemble of the JAX package's scripts/bench_replicas.py --flat:
    64 replicas of build_water_box(800), the auto layout (7, 10) with 70
    internal replicas, the (35, 5, 50) grid, C = 48, 63 offsets, the PME
    grid 25^3 that the JAX plan gives, its pencil gate closed, and the
    route to B1."""
    jsys, _ = jbuilders.build_water_box(800)
    tsys, _ = tbuilders.build_water_box(800)
    integ = dn.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    jctx = dn.Context(jsys, integ, precision="double")
    tinteg = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    tctx = dt.Context(tsys, tinteg, precision="double", device="cpu")
    assert tctx._nb.strategy == "dense"
    layout = flatrep.FlatReplicaEnsemble._auto_layout(tctx, 64, None)
    assert layout == JaxFlat._auto_layout(jctx, 64, None) == (7, 10)
    rx, rz = layout
    nbf = next(f for f in tsys.getForces()
               if type(f).__name__ == "NonbondedForce")
    box0 = np.diagonal(np.array(tsys.getDefaultPeriodicBoxVectors()))
    exc = np.array([e[:2] for e in nbf._exceptions])
    tc = tcp.make_ensemble_config(nbf.getCutoffDistance(), box0, 4000, 70,
                                  exc[:, 0], exc[:, 1], rx=rx, rz=rz)
    jc = jcp.make_ensemble_config(nbf.getCutoffDistance(), box0, 4000, 70,
                                  exc[:, 0], exc[:, 1], rx=rx, rz=rz)
    assert tc.grid == jc.grid == (35, 5, 50)
    assert tc.phys_grid == (5, 5, 5) and tc.window == (2, 2, 2)
    assert tc.capacity == jc.capacity == 48 and tc.n_offsets == 63
    np.testing.assert_array_equal(
        tc.nbr_map, np.array(jc.nbr_map[0]).reshape(jc.nbr_map[1]))
    assert sweep.route(tc) == ("b1", None)
    assert sweep.supports(tc) and sweep.b1_takes(tc)
    tp = tpme.setup_pme(nbf.getCutoffDistance(), nbf.getEwaldErrorTolerance(),
                        box0, cell_grid=tc.phys_grid)
    jp = jpme.setup_pme(cutoff=nbf.getCutoffDistance(),
                        tol=nbf.getEwaldErrorTolerance(), box_diag=box0,
                        cell_grid=jc.phys_grid)
    assert tp.grid == tuple(jp.grid) == (25, 25, 25)
    np.testing.assert_allclose(tp.alpha, jp.alpha, rtol=1e-15)
    plan = jpme._pencil_plan(jp.grid, jc.phys_grid)
    jax_gate = (plan is not None and plan[0][1] * plan[1][1] * 4
                <= jp.grid[0] * jp.grid[1])
    assert tpme.pencil_gate(tp.grid, tc.phys_grid) == jax_gate is False


def _water(pkg, builders, n_mol=100, cutoff=0.45):
    system, pos = builders.build_water_box(
        n_mol, method=pkg.NonbondedForce.PME, cutoff=cutoff)
    integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005, 0.001, 20, 2,
                                    False)
    integ.setMaxDrudeDistance(0.02)
    return system, pos, integ


# the auto capacity (8) holds the lattice start: no growth in either
# package
NB = {}


def _velocities(system, R, seed):
    """(R, n0, 3) seeded velocities, zero on massless sites."""
    n0 = system.getNumParticles()
    m = np.array([system.getParticleMass(i) for i in range(n0)])
    v = np.random.default_rng(seed).normal(0, 0.3, (R, n0, 3))
    v[:, m == 0] = 0.0
    return v


def _ensembles(R, rx=None, rz=None):
    """The JAX and the port's FlatReplicaEnsemble of the 100-water
    template (f64), with the same seeded velocities."""
    out = []
    for pkg, builders, kw in ((dn, jbuilders, {}),
                              (dt, tbuilders, {"device": "cpu"})):
        system, pos, integ = _water(pkg, builders)
        ctx = pkg.Context(system, integ, precision="double",
                          strategy="cellpair", nb_options=dict(NB), **kw)
        ctx.setPositions(pos)
        ens = (JaxFlat if pkg is dn else flatrep.FlatReplicaEnsemble)(
            ctx, R, rx=rx, rz=rz)
        ens.setVelocities(_velocities(system, R, 11))
        out.append(ens)
    return out


def test_flat_ensemble_forces_match_jax():
    jens, tens = _ensembles(2)
    assert tens.layout == (1, 2) and tens.context._static.ensemble_r == 2
    assert tens.context._cp_cfg.grid == jens.context._cp_cfg.grid
    jpme_setup = next(fn.pme_setup for fn, _ in jens.context._terms
                      if getattr(fn, "pme_setup", None) is not None)
    assert tens.context._nb.pme.grid == tuple(jpme_setup.grid)
    js = jens.context.getState(forces=True, energy=True)
    ts = tens.context.getState(forces=True, energy=True)
    np.testing.assert_allclose(ts.getPotentialEnergy(),
                               js.getPotentialEnergy(), rtol=1e-10)
    f_ref = np.asarray(js.getForces())
    np.testing.assert_allclose(ts.getForces(), f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())


def test_padded_flat_ensemble_steps_match_jax():
    """3 replicas in a 2 x 2 layout (one pad replica), 32 TGNH steps from
    the JAX state (its (R, G+2) baths carried across), at
    tests/test_torch_slice.py's tolerances; the accessors report the 3
    replicas."""
    jens, tens = _ensembles(3, rx=2, rz=2)
    assert tens.n_replicas == 3 and tens.n_replicas_padded == 4
    jctx, tctx = jens.context, tens.context
    jctx._ensure_forces()
    d = {k: np.asarray(v) for k, v in jctx._state._asdict().items()
         if v is not None and k not in ("neighbors", "key")}
    assert d["eta"].shape == (4, 3, 2) and d["group_ke"].shape == (4, 3)
    tctx._state = convert.state_from_numpy(d)
    tctx._forces_valid = True
    jens.step(32)
    tens.step(32)
    js, ts = jctx._state, tctx._state
    assert ts.step == int(js.step) == 32
    for name in ("positions", "velocities", "eta", "eta_dot", "group_ke",
                 "ke_sum"):
        ref = np.asarray(getattr(js, name))
        np.testing.assert_allclose(getattr(ts, name).numpy(), ref,
                                   rtol=1e-9, atol=1e-9 * np.abs(ref).max(),
                                   err_msg=name)
    assert not tctx.neighborListOverflowed
    np.testing.assert_allclose(tens.kinetic_energies(),
                               jens.kinetic_energies(), rtol=1e-9)
    np.testing.assert_allclose(tens.group_temperatures(),
                               jens.group_temperatures(), rtol=1e-9)
    assert tens.group_temperatures().shape == (3, 3)
    pe = tens.potential_energies()
    np.testing.assert_allclose(pe, jens.potential_energies(), rtol=1e-10)
    np.testing.assert_allclose(tens.total_potential_energy(), pe.sum(),
                               rtol=1e-12)
    np.testing.assert_allclose(tens.positions(), jens.positions(),
                               rtol=0, atol=1e-9)
    assert tens.positions().shape == tens.velocities().shape == (
        3, tens._n0, 3)
    np.testing.assert_allclose(tens.densities(), jens.densities(),
                               rtol=1e-12)
    assert tens.boxes().shape == (3, 3, 3)
    # the JAX package's getConservedEnergy does not take the (R, G+2)
    # baths (ROADMAP.md C16); the port's is the replicas' sum
    with pytest.raises(ValueError):
        jctx.getConservedEnergy()
    m = tctx._spec.mass.numpy()
    v = ts.velocities.numpy()
    q = tctx._spec.nh_eta_mass.numpy()
    nkbt = tctx._spec.nh_nkbt.numpy()
    kbt = tctx._spec.nh_kbt_chain.numpy()
    chain = sum(0.5 * np.sum(q * ts.eta_dot.numpy()[r, :, :-1] ** 2)
                + np.sum(nkbt * ts.eta.numpy()[r, :, 0])
                + np.sum(kbt[:, None] * ts.eta.numpy()[r, :, 1:])
                for r in range(4))
    expected = (0.5 * np.sum(m * np.sum(v * v, axis=1))
                + tctx.getState(energy=True).getPotentialEnergy() + chain)
    np.testing.assert_allclose(tctx.getConservedEnergy(), expected,
                               rtol=1e-12)


def test_flat_ensemble_matches_independent_contexts():
    """Two replicas in one flat ensemble and two port Contexts on the
    cell-pair strategy, 20 steps from the same velocities."""
    R = 2
    system, pos, integ = _water(dt, tbuilders)
    vels = _velocities(system, R, 23)
    ref = []
    for r in range(R):
        s, p, it = _water(dt, tbuilders)
        ctx = dt.Context(s, it, precision="double", strategy="cellpair",
                         nb_options=dict(NB), device="cpu")
        ctx.setPositions(p)
        ctx.setVelocities(vels[r])
        it.step(20)
        st = ctx.getState(positions=True, energy=True, groups=True)
        ref.append((st.getPositions(), st.getKineticEnergy(),
                    st.getGroupTemperatures(), st.getPotentialEnergy()))
    tctx = dt.Context(system, integ, precision="double",
                      strategy="cellpair", nb_options=dict(NB),
                      device="cpu")
    tctx.setPositions(pos)
    ens = flatrep.FlatReplicaEnsemble(tctx, R)
    ens.setVelocities(vels)
    ens.step(20)
    got = (ens.positions(), ens.kinetic_energies(),
           ens.group_temperatures(), ens.potential_energies())
    for r in range(R):
        np.testing.assert_allclose(got[0][r], ref[r][0], rtol=0, atol=1e-9)
        np.testing.assert_allclose(got[1][r], ref[r][1], rtol=1e-9)
        np.testing.assert_allclose(got[2][r], ref[r][2], rtol=1e-8)
        np.testing.assert_allclose(got[3][r], ref[r][3], rtol=1e-9)
    np.testing.assert_allclose(got[3].sum(), ens.total_potential_energy(),
                               rtol=1e-9)


def test_flat_npt_and_unported_forces_raise():
    system, pos, integ = _water(dt, tbuilders)
    system.addForce(dt.MonteCarloBarostat(1.01325, 300.0, 25))
    ctx = dt.Context(system, integ, precision="double", strategy="cellpair",
                     nb_options=dict(NB), device="cpu")
    ctx.setPositions(pos)
    # flat NPT builds (its physics: tests/test_torch_flatnpt.py): unit
    # scales, each replica its own move size and counters
    ens = flatrep.FlatReplicaEnsemble(ctx, 2)
    st = ens.context._state
    assert torch.equal(st.rep_scale, torch.ones(2, dtype=torch.float64))
    assert torch.equal(st.baro_scale, torch.zeros(2, dtype=torch.float64))
    assert st.baro_naccept.tolist() == st.baro_nattempt.tolist() == [0, 0]
    box = np.array(system.getDefaultPeriodicBoxVectors(), np.float64)
    np.testing.assert_allclose(ens.boxes(), [box, box], rtol=1e-7)

    class CustomNonbondedForce:
        pass

    with pytest.raises(ValueError, match="cannot replicate"):
        flatrep._replicate_force(CustomNonbondedForce(), 2, 10)
    # the dense strategy takes an ensemble of R replica-major copies
    # (parallel/ensemble.py's block-diagonal sum), not a system whose
    # atoms do not split into R replicas
    nbf = next(f for f in system.getForces()
               if type(f).__name__ == "NonbondedForce")
    assert system.getNumParticles() % 3
    with pytest.raises(ValueError, match="not divisible"):
        nbf.compile(system, torch.float64, "cpu",
                    nb_options={"ensemble": [3, 1, 3]}, strategy="dense")
