"""Flat-ensemble NPT through the PyTorch port (one box scale a replica,
SimState.rep_scale), on the CPU in f64 with seeded numpy inputs.

The fast pins of the JAX package's tests/test_flatnpt.py at its
tolerances, against independent port Contexts built at the scaled boxes
with the flat template's PME plan: the energy in sum and per replica
(1e-10), the forces (1e-8 of max|F|), the Metropolis energy difference
of a move (rtol 1e-8, atol 1e-7), also with NBTHOLE and NBFIX (both
hooks).  Then against the JAX package itself: the port's mc_energies
(1e-10), the scaled plain versions of kernels B1 and B2 against the JAX
XLA sweep with rep_scale (energy per replica 1e-10, forces 1e-8 of
max|F|), one ensemble move with the JAX move's draws fed through `draws`
(positions, scales, accept flags and move sizes 1e-10); a replica shrunk
past the stencil's slack (the JAX Context plans the same grid again
until it reports a capacity overflow, ROADMAP.md C17; the port plans a
grid at the smallest replica box); the JAX per-replica pair energies
imaging a pair across a replica's face in the template box (ROADMAP.md
C18; the port images it in the replica's); the refusal of forces
without a per-replica hook; a few flat NPT steps and a checkpoint
replay.  The
JAX end-to-end runs stay slow here as there.  The scaled CUDA
instantiations are held against these plain versions on the card
(chip_smoke.py phase 11, tests/test_torch_gpu.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.forces import cellpair as jcp
from openmm_drudenose_tpu.integrators import barostat as jbaro
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu.parallel.flatrep import \
    FlatReplicaEnsemble as JaxFlat
from openmm_drudenose_tpu_torch.forces import cellpair as tcp
from openmm_drudenose_tpu_torch.integrators import barostat as tbaro
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
from openmm_drudenose_tpu_torch.parallel import flatrep
from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0

# tests/test_flatnpt.py's replicas and scales
N_MOL = 200
CUTOFF = 0.55
SCALES = (1.04, 0.95)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small tensors (it leaves the
    cores to the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(pkg, builders, cutoff=CUTOFF, extras=False, barostat=False,
            n_mol=N_MOL):
    system, pos = builders.build_water_box(
        n_mol, method=pkg.NonbondedForce.PME, cutoff=cutoff)
    if extras:
        # tests/test_flatnpt.py's intermolecular extras: NBTHOLE between
        # two molecules' Drude pairs, NBFIX between two oxygens
        drude = next(f for f in system.getForces()
                     if isinstance(f, pkg.DrudeForce))
        drude.addNBTholePair(0, 1, 1.3)
        nb = next(f for f in system.getForces()
                  if isinstance(f, pkg.NonbondedForce))
        nb.addLJPairOverride([10], [15], 0.31, 0.8)
    if barostat:
        system.addForce(pkg.MonteCarloBarostat(1.01325, 300.0, 2))
    return system, pos


def _integrator(pkg):
    integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005, 0.0005, 20, 2)
    integ.setMaxDrudeDistance(0.05)
    return integ


def _template(pkg=dt, builders=tbuilders, **kw):
    system, pos = _system(pkg, builders, **kw)
    dev = {"device": "cpu"} if pkg is dt else {}
    ctx = pkg.Context(system, _integrator(pkg), precision="double",
                      strategy="cellpair", **dev)
    ctx.setPositions(pos)
    ctx.applyConstraints(1e-8)
    return ctx, system


def _com_scaled(system, positions, s):
    """Positions after a molecule-COM scaling by s (5-site waters,
    contiguous)."""
    m = np.array([system.getParticleMass(i)
                  for i in range(system.getNumParticles())]).reshape(-1, 5)
    p = np.asarray(positions, np.float64).reshape(-1, 5, 3)
    com = (m[:, :, None] * p).sum(axis=1) / m.sum(axis=1)[:, None]
    return (p + (s - 1.0) * com[:, None, :]).reshape(-1, 3)


def _independent(s, positions, pme, cutoff=CUTOFF, extras=False,
                 n_mol=N_MOL):
    """A port Context of one replica at the box template * s, its PME
    plan pinned to the flat template's (the JAX _independent_ctx)."""
    system, _ = _system(dt, tbuilders, cutoff=cutoff, extras=extras,
                        n_mol=n_mol)
    box = np.array(system.getDefaultPeriodicBoxVectors(), np.float64) * s
    system.setDefaultPeriodicBoxVectors(*box)
    nb = next(f for f in system.getForces()
              if isinstance(f, dt.NonbondedForce))
    nb.setPMEParameters(pme.alpha, *pme.grid)
    ctx = dt.Context(system, _integrator(dt), precision="double",
                     strategy="cellpair", device="cpu")
    ctx.setPositions(positions)
    return ctx


def _pe(ctx):
    """A Context's potential energy, without its forces."""
    ctx._ensure_pe()
    return float(ctx._state.potential_energy)


def _scaled_ensemble(scales=SCALES, **kw):
    """The port's 2-replica ensemble at `scales`, each replica the
    template's positions COM-scaled by its scale."""
    tpl, system = _template(**kw)
    ens = flatrep.FlatReplicaEnsemble(tpl, 2, rx=2, rz=1)
    p0 = tpl._state.positions.numpy()
    pos = np.stack([_com_scaled(system, p0, s) for s in scales])
    ens.context._state = ens.context._state.replace(
        rep_scale=torch.tensor(scales, dtype=torch.float64))
    ens.setPositions(pos)
    return ens, system, pos


@pytest.fixture(scope="module")
def parity():
    ens, system, pos = _scaled_ensemble()
    pme = ens.context._nb.pme
    indep = [_independent(s, p, pme) for s, p in zip(SCALES, pos)]
    return ens, system, indep


def test_flat_npt_energy_matches_independent(parity):
    ens, _, indep = parity
    pe = ens.context.getState(energy=True).getPotentialEnergy()
    pes = [c.getState(energy=True).getPotentialEnergy() for c in indep]
    np.testing.assert_allclose(pe, sum(pes), rtol=1e-10)
    np.testing.assert_allclose(ens.potential_energies(), pes, rtol=1e-10)


def test_flat_npt_forces_match_independent(parity):
    ens, _, indep = parity
    f = ens.context.getState(forces=True).getForces().reshape(2, -1, 3)
    for r, c in enumerate(indep):
        ref = c.getState(forces=True).getForces()
        np.testing.assert_allclose(f[r], ref, rtol=0,
                                   atol=1e-8 * np.abs(ref).max())


def _mc_delta(ens, system, pme, extras=False, ls=1.015, pe_a=None):
    """mc_energies before and after a further COM scaling of replica 0
    by ls, and the full-PE difference of independent Contexts at the
    two states of replica 0 (pe_a: the first's energy, where known)."""
    ctx = ens.context
    ctx._ensure_neighbors()
    st = ctx._state
    e0 = ctx._mc_energies(st.positions, st.box, st.neighbors, None,
                          st.rep_scale).numpy()
    p = st.positions.numpy().reshape(2, -1, 3)
    p_new = p.copy()
    p_new[0] = _com_scaled(system, p[0], ls)
    s_new = torch.tensor(np.array(SCALES) * [ls, 1.0])
    e1 = ctx._mc_energies(torch.as_tensor(p_new.reshape(-1, 3)), st.box,
                          st.neighbors, None, s_new).numpy()
    if pe_a is None:
        pe_a = _pe(_independent(SCALES[0], p[0], pme, extras=extras))
    pe_b = _pe(_independent(SCALES[0] * ls, p_new[0], pme, extras=extras))
    return e0, e1, pe_b - pe_a


def test_flat_npt_mc_delta_matches_independent(parity):
    ens, system, indep = parity
    e0, e1, ref = _mc_delta(ens, system, ens.context._nb.pme,
                            pe_a=_pe(indep[0]))
    assert e0.dtype == np.float64 and e0.shape == (2,)
    np.testing.assert_allclose(e1[0] - e0[0], ref, rtol=1e-8, atol=1e-7)
    np.testing.assert_allclose(e1[1], e0[1], rtol=1e-12)


def test_flat_npt_mc_delta_with_nbthole_nbfix():
    ens, system, _ = _scaled_ensemble(extras=True)
    ctx = ens.context
    hooks = [t for t in [ctx._nb] + ctx._terms if hasattr(t, "mc_energies")]
    assert len(hooks) == 2, "both the nonbonded and the Drude hooks"
    assert ctx._nb.override_term is not None and ctx._nb.overrides_uniform
    e0, e1, ref = _mc_delta(ens, system, ctx._nb.pme, extras=True)
    np.testing.assert_allclose(e1[0] - e0[0], ref, rtol=1e-8, atol=1e-7)
    np.testing.assert_allclose(e1[1], e0[1], rtol=1e-12)


# -- against the JAX package ---------------------------------------------------

# the comparisons with the JAX package run on a smaller replica (100
# waters, cutoff 0.45: tests/test_torch_flatrep.py's), to keep the file
# short on one worker; its window leaves 4.8% of slack, so the scales
# stay inside it
SMALL = dict(n_mol=100, cutoff=0.45)
SMALL_SCALES = (1.03, 0.97)


def _jax_ensemble(extras=False):
    jtpl, system = _template(dn, jbuilders, extras=extras, barostat=True,
                             **SMALL)
    jens = JaxFlat(jtpl, 2, rx=2, rz=1)
    p0 = np.asarray(jtpl._state.positions, np.float64)
    pos = np.stack([_com_scaled(system, p0, s) for s in SMALL_SCALES])
    jens.context._state = jens.context._state._replace(
        rep_scale=jnp.asarray(np.array(SMALL_SCALES)))
    jens.setPositions(pos)
    jens.context._ensure_neighbors()
    return jens, pos


def _jax_mc(jctx):
    """The JAX Context's summed mc_energies hooks (its step's `mc`)."""
    hooks = [(t[0].mc_energies, t[1]) for t in jctx._terms
             if getattr(t[0], "mc_energies", None)]

    def mc(pos, box, nbl, rs):
        return sum(f(p, pos, box, nbl, rs) for f, p in hooks)
    return mc


def _jax_move_and_mc(jctx):
    """jit(state, draws) -> (state after the JAX package's ensemble move
    with its two jax.random.uniform draws replaced by draws[0] and
    draws[1] ((R,) each), mc_energies at the state): one compilation
    serves both tests."""
    spec, static = jctx._spec, jctx._static
    mc = _jax_mc(jctx)

    def move(state, draws):
        seq = iter([draws[0], draws[1]])
        real = jax.random.uniform
        jax.random.uniform = lambda key, *a, dtype=None, **k: \
            next(seq).astype(dtype)
        try:
            out = jbaro.maybe_attempt_mc_move_ensemble(
                spec, static, state, jctx._energy_and_forces, mc)
        finally:
            jax.random.uniform = real
        return out, mc(state.positions, state.box, state.neighbors,
                       state.rep_scale)

    return jax.jit(move)


# (dV uniform, Metropolis uniform) per replica: a large expansion and a
# large compression, with Metropolis draws at both ends
DRAWS = [((0.99, 0.01), (1e-9, 1e-9)), ((0.01, 0.99), (1 - 1e-9, 0.5))]


@pytest.fixture(scope="module")
def jax_pair():
    """The JAX and the port's 2-replica NPT ensembles with NBTHOLE and
    NBFIX at the same scaled positions, and the JAX move (and
    mc_energies) for each of DRAWS."""
    jens, pos = _jax_ensemble(extras=True)
    tens, _, tpos = _scaled_ensemble(SMALL_SCALES, extras=True,
                                     barostat=True, **SMALL)
    np.testing.assert_allclose(tpos, pos, rtol=0, atol=1e-14)
    tens.setPositions(pos)
    tens.context._ensure_forces()
    jmove = _jax_move_and_mc(jens.context)
    moves = [jmove(jens.context._state, jnp.asarray(np.array(d)))
             for d in DRAWS]
    return tens, moves


def test_mc_energies_match_jax(jax_pair):
    tens, moves = jax_pair
    ts = tens.context._state
    got = tens.context._mc_energies(ts.positions, ts.box, ts.neighbors,
                                    None, ts.rep_scale)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(moves[0][1]),
                               rtol=1e-10)


def test_ensemble_move_matches_jax(jax_pair):
    tens, moves = jax_pair
    tctx = tens.context
    seen = set()
    for draws, (js, _) in zip(DRAWS, moves):
        ts = tbaro.maybe_attempt_mc_move_ensemble(
            tctx._spec, tctx._static, tctx._state, tctx._mc_energies,
            tctx._forces_only, draws=draws)
        np.testing.assert_allclose(ts.positions.numpy(),
                                   np.asarray(js.positions), rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(ts.rep_scale.numpy(),
                                   np.asarray(js.rep_scale), rtol=1e-10)
        np.testing.assert_allclose(ts.baro_scale.numpy(),
                                   np.asarray(js.baro_scale), rtol=1e-10)
        acc = ts.baro_naccept.numpy()
        np.testing.assert_array_equal(acc, np.asarray(js.baro_naccept))
        np.testing.assert_array_equal(ts.baro_nattempt.numpy(),
                                      np.asarray(js.baro_nattempt))
        f_ref = np.asarray(js.forces)
        np.testing.assert_allclose(ts.forces.numpy(), f_ref, rtol=0,
                                   atol=1e-8 * np.abs(f_ref).max())
        seen |= set(acc.tolist())
    assert seen == {0, 1}, "both outcomes, and a mixed one"


@pytest.fixture(scope="module")
def lj_scaled():
    """tests/test_torch_flatrep.py's replicas (96 random charged LJ
    particles in a 1.6 nm box, 2 x 2 bands, the exclusions (i, i + 1)
    and (i, i + 3) for i = 0, 4, .., 20 in each) at four distinct
    scales: the stored coordinates p / s_r uniform in the template
    box."""
    rx, rz, N0, L = 2, 2, 96, 1.6
    R = rx * rz
    rng = np.random.default_rng(9)
    pos = rng.uniform(0, L, (R * N0, 3))
    ti = np.array([i for i in range(0, 24, 4)] * 2)
    tj = ti + np.repeat([1, 3], 6)
    off = np.repeat(np.arange(R) * N0, len(ti))
    s = np.array([1.03, 0.97, 1.0, 0.985])
    return dict(R=R, rx=rx, rz=rz, phys=pos * np.repeat(s, N0)[:, None],
                stored=pos, q=rng.normal(0, 0.2, R * N0),
                sig=rng.uniform(0.2, 0.3, R * N0),
                eps=rng.uniform(0.1, 0.8, R * N0), t=(ti, tj),
                e=(np.tile(ti, R) + off, np.tile(tj, R) + off), s=s, L=L,
                N0=N0, alpha=3.0)


@pytest.mark.parametrize("version", ["b1", "b2"])
def test_scaled_plain_versions_match_jax(lj_scaled, version):
    """B1's and B2's scaled plain versions (physical fields, per-replica
    shifts) against the JAX XLA sweep in stored coordinates with
    rep_scale: per-replica energies 1e-10, forces 1e-8 of max|F|."""
    c = lj_scaled
    R, L, N0 = c["R"], c["L"], c["N0"]
    cut = 0.5
    jc = jcp.make_ensemble_config(cut, [L] * 3, N0, R, *c["t"],
                                  rx=c["rx"], rz=c["rz"], skin=0.1,
                                  capacity=16)
    words = jcp.build_exclusion_words(R * N0, *c["e"], jc.excl_window,
                                      jc.excl_words)
    params = {"charge": jnp.asarray(c["q"]), "sigma": jnp.asarray(c["sig"]),
              "eps": jnp.asarray(c["eps"]),
              "excl_words": jnp.asarray(words)}
    box = jnp.asarray([L] * 3)
    rs = jnp.asarray(c["s"])
    nbl = jcp.build_cellsort(jnp.asarray(c["stored"]), box, jc,
                             rep_scale=rs)
    pair_eg = jcp.make_pair_eg("ewald", cut, alpha=c["alpha"],
                               erfc_fn=jcp.erfc_approx, excl_in_sweep=False)
    e_ref, f_ref = jax.jit(lambda p, x, n, r: jcp.pair_energy_forces(
        p, x, box, n, jc, pair_eg, ONE_4PI_EPS0, rep_scale=r,
        energy_per_replica=True))(params, jnp.asarray(c["stored"]), nbl, rs)
    e_ref, f_ref = np.asarray(e_ref), np.asarray(f_ref)

    tc = tcp.make_ensemble_config(cut, [L] * 3, N0, R, *c["t"],
                                  rx=c["rx"], rz=c["rz"], capacity=16)
    tparams = {"charge": torch.as_tensor(c["q"]),
               "sigma": torch.as_tensor(c["sig"]),
               "eps": torch.as_tensor(c["eps"]),
               "excl_words": torch.as_tensor(tcp.build_exclusion_words(
                   R * N0, *c["e"], tc.excl_window, tc.excl_words))}
    tpos = torch.as_tensor(c["phys"])
    tbox = torch.as_tensor([L] * 3, dtype=torch.float64)
    trs = torch.as_tensor(c["s"])
    tnbl = tcp.build_cellsort(tpos, tbox, tc, rep_scale=trs)
    np.testing.assert_array_equal(tnbl.slot_atom.numpy(),
                                  np.asarray(nbl.slot_atom))
    assert not bool(tnbl.overflow) and not bool(tnbl.stencil_invalid)
    fields = tcp.sorted_fields(tparams, tpos, tbox, tnbl, tc, rep_scale=trs)
    shifts = tcp.offset_shifts(tc, tbox, trs)
    assert tuple(shifts.shape) == (R, tc.n_offsets, 3)
    kernel = sweep if version == "b1" else sweep_chunked
    args = (fields, tc, shifts, c["alpha"], ONE_4PI_EPS0)
    f = kernel.pair_forces(*args, excl_skip=False)[tnbl.inv_slot].numpy()
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())
    e, _ = tcp.sweep(*args, erfc_fn=tcp.erfc_approx, per_replica=True)
    np.testing.assert_allclose(e.numpy(), e_ref, rtol=1e-10)
    # the energy instantiation's plain version (the exact erfc) per
    # replica, by both kernels' entry points
    e_exact = kernel.pair_energy(*args, excl_skip=False)
    assert tuple(e_exact.shape) == (R,)
    np.testing.assert_allclose(e_exact.numpy(), e.numpy(), rtol=1e-6)


def test_scaled_rows_and_launch_keys(lj_scaled):
    """The per-replica partial tables the scaled energy kernels sum: each
    replica's B1 work units and B2 home-cell partials, every one once;
    the scaled launches count apart."""
    c = lj_scaled
    tc = tcp.make_ensemble_config(0.5, [c["L"]] * 3, c["N0"], c["R"],
                                  [], [], rx=c["rx"], rz=c["rz"],
                                  capacity=40)
    rows = sweep.unit_rows(tc)
    parts, groups = 2, -(-tc.n_offsets // 8)
    assert rows.shape == (c["R"], tc.n_cells // c["R"] * parts * groups)
    assert sorted(rows.ravel().tolist()) == list(range(rows.size))
    rep = tcp.rep_of_cell(tc)
    assert np.all(rep[rows // (parts * groups)]
                  == np.arange(c["R"])[:, None])
    plan = sweep_chunked.plan_for(tc)
    erows = sweep_chunked.energy_rows(tc, plan)
    nh = int(np.prod(plan.brick))
    assert sorted(erows.ravel().tolist()) == list(
        range(plan.total_chunks * nh))
    # a chunk's home cells (inside its band) belong to the row's replica
    frame_rows = plan.frame_rows[:, 0] // plan.n_frame_cells
    for r in range(c["R"]):
        chunks = set((erows[r] // nh).tolist())
        assert set(frame_rows[rep == r].tolist()) <= chunks
    assert sweep.launch_key("b1", False, "ewald", tc, True) \
        == "b1_sweep_scaled"
    assert sweep.launch_key("b2", True, "ewald", tc, True) \
        == "b2_energy_scaled"
    assert {"b1_sweep_scaled", "b1_energy_scaled", "b2_sweep_scaled",
            "b2_energy_scaled"} <= set(sweep.launches)


def test_stencil_latch_replans_at_the_smallest_replica():
    """A replica shrunk past the stencil's slack (0.88 against the
    window's 0.906 at cutoff 0.45): the JAX Context plans the grid again
    at the template box, the same grid, until it reports a capacity
    overflow (ROADMAP.md C17); the port plans it at the smallest replica
    box and divides the scales by its scale, each replica keeping its
    box, and the energy is the independent Contexts' sum."""
    cut, s = 0.45, (1.0, 0.88)
    jtpl, _ = _template(dn, jbuilders, cutoff=cut, barostat=True)
    jens = JaxFlat(jtpl, 2, rx=2, rz=1)
    jens.context._state = jens.context._state._replace(
        rep_scale=jnp.asarray(s), neighbors=None)
    grid0 = jens.context._cp_cfg.grid
    with pytest.raises(RuntimeError, match="capacity still overflowing"):
        jens.context._ensure_neighbors()
    assert jens.context._cp_cfg.grid == grid0

    tpl, system = _template(cutoff=cut, barostat=True)
    ens = flatrep.FlatReplicaEnsemble(tpl, 2, rx=2, rz=1)
    ctx = ens.context
    assert ctx._cp_cfg.grid == grid0
    p0 = tpl._state.positions.numpy()
    pos = np.stack([_com_scaled(system, p0, v) for v in s])
    ctx._state = ctx._state.replace(
        rep_scale=torch.tensor(s, dtype=torch.float64))
    ens.setPositions(pos)
    boxes = ens.boxes()
    pe = _pe(ctx)
    cfg = ctx._cp_cfg
    assert cfg.grid != grid0
    np.testing.assert_allclose(ens.boxes(), boxes, rtol=1e-15)
    np.testing.assert_allclose(ctx._state.rep_scale.numpy(),
                               [1.0 / 0.88, 1.0], rtol=1e-15)
    assert not bool(ctx._state.neighbors.stencil_invalid)
    box = np.diagonal(ctx._state.box.numpy())
    assert np.all(np.asarray(cfg.window) * box / np.asarray(cfg.phys_grid)
                  >= cfg.r_list)
    pme = ctx._nb.pme
    pes = [_pe(_independent(v, p, pme, cutoff=cut))
           for v, p in zip(s, pos)]
    np.testing.assert_allclose(pe, sum(pes), rtol=1e-10)
    # a replica too small for a regular grid: a clear error, no loop
    ctx._state = ctx._state.replace(
        rep_scale=torch.tensor([1.0, 0.7], dtype=torch.float64) / 0.88,
        neighbors=None)
    with pytest.raises(RuntimeError, match="cannot be planned again"):
        ctx._ensure_neighbors()


def test_forces_without_a_hook_are_refused():
    """A force whose energy a volume move changes and that has no
    per-replica mc_energies hook is refused beside a barostat (ROADMAP.md
    C6), and replicate_system still raises on a CustomExternalForce."""
    class CustomExternalForce:
        pass

    system, _ = _system(dt, tbuilders, barostat=True)
    tbaro.check_ensemble_forces(system)
    system.addForce(CustomExternalForce())
    with pytest.raises(ValueError, match="mc_energies hook"):
        tbaro.check_ensemble_forces(system)
    with pytest.raises(ValueError, match="mc_energies hook"):
        dt.Context(system, _integrator(dt), precision="double",
                   strategy="cellpair", device="cpu", ensemble_r=2,
                   nb_options={"ensemble": [2, 2, 1]})
    with pytest.raises(ValueError, match="cannot replicate"):
        flatrep.replicate_system(system, 2)


def test_flat_npt_steps_and_replays(tmp_path):
    """A few flat NPT steps on 2 replicas (a move every 2 steps): every
    replica attempts, the scales stay sane, the per-replica accessors
    follow them; a checkpoint replays 4 steps with attempts bit for
    bit."""
    tpl, _ = _template(barostat=True, **SMALL)
    ens = flatrep.FlatReplicaEnsemble(tpl, 2, rx=2, rz=1)
    st = ens.context._state
    assert torch.equal(st.rep_scale, torch.ones(2, dtype=torch.float64))
    ens.setVelocitiesToTemperature(300.0, seed=5)
    ens.step(4)
    st = ens.context._state
    assert np.all(np.isfinite(st.positions.numpy()))
    tries = st.baro_nattempt.numpy() + st.baro_naccept.numpy()
    assert tries.min() > 0
    s = st.rep_scale.numpy()
    assert np.all((s > 0.9) & (s < 1.1))
    np.testing.assert_allclose(ens.boxes()[:, 0, 0] / st.box.numpy()[0, 0],
                               s, rtol=1e-12)
    dens = ens.densities()
    vols = np.prod(np.diagonal(ens.boxes(), axis1=1, axis2=2), axis=1)
    np.testing.assert_allclose(dens * vols, dens[0] * vols[0], rtol=1e-12)
    pes = ens.potential_energies()
    np.testing.assert_allclose(pes.sum(), ens.total_potential_energy(),
                               rtol=1e-9)
    path = os.path.join(tmp_path, "flatnpt.npz")
    dt.save_checkpoint(path, ens.context)
    ens.step(4)
    first = (ens.context._state.positions.clone(),
             ens.context._state.rep_scale.clone())
    dt.load_checkpoint(path, ens.context)
    ens.step(4)
    assert torch.equal(ens.context._state.positions, first[0])
    assert torch.equal(ens.context._state.rep_scale, first[1])


@pytest.mark.slow
def test_flat_npt_runs_and_replicas_decouple():
    """End to end (the JAX slow pin's twin): per-replica moves fire, the
    scales part, everything stays finite."""
    tpl, _ = _template(barostat=True)
    ens = flatrep.FlatReplicaEnsemble(tpl, 2, rx=2, rz=1)
    ens.setVelocitiesToTemperature(300.0, seed=5)
    ens.step(12)
    st = ens.context._state
    assert np.all(np.isfinite(st.positions.numpy()))
    assert (st.baro_nattempt.numpy() + st.baro_naccept.numpy()).min() > 0
    s = st.rep_scale.numpy()
    assert np.all(np.isfinite(s)) and np.all((s > 0.5) & (s < 2.0))
    assert s[0] != s[1]
    assert np.all(np.isfinite(ens.potential_energies()))


@pytest.mark.slow
def test_flat_npt_runs_with_nbthole_nbfix():
    tpl, _ = _template(extras=True, barostat=True)
    ens = flatrep.FlatReplicaEnsemble(tpl, 2, rx=2, rz=1)
    ens.setVelocitiesToTemperature(300.0, seed=7)
    ens.step(8)
    st = ens.context._state
    assert np.all(np.isfinite(st.positions.numpy()))
    assert (st.baro_nattempt.numpy() + st.baro_naccept.numpy()).min() > 0
    s = st.rep_scale.numpy()
    assert np.all(np.isfinite(s)) and np.all((s > 0.5) & (s < 2.0))


def test_jax_flat_npt_images_pair_terms_in_the_template_box():
    """An NBFIX pair across replica 0's periodic face (box template x
    1.05): the JAX per-replica pair energies image it in the template
    box, 0.05 nm apart where the pair is 0.15 nm apart (ROADMAP.md C18);
    the port images each pair in its replica's box, as an independent
    Context does."""
    from openmm_drudenose_tpu.forces import pairterms as jpt
    from openmm_drudenose_tpu_torch.forces import pairterms as tpt
    L, s = 2.0, np.array([1.05, 1.0])
    pos = np.array([[0.05, 1.0, 1.0], [L * s[0] - 0.1, 1.0, 1.0],
                    [0.5, 1.0, 1.0], [0.8, 1.0, 1.0]])
    ii, jj = np.array([0, 2]), np.array([1, 3])
    sig, eps, cut = (0.31, 0.31), (0.8, 0.8), 0.5
    old = (0.3, 0.3), (0.5, 0.5)
    j_e = np.asarray(jpt.make_pair_list_energies_rep(
        2, ii, jj, jpt.lj_override_eg(jnp.asarray(sig), jnp.asarray(eps),
                                      jnp.asarray(old[0]),
                                      jnp.asarray(old[1]), cut))(
        jnp.asarray(pos), jnp.asarray([L] * 3)))
    t = lambda v: torch.as_tensor(v, dtype=torch.float64)
    term = tpt.make_pair_list_term(
        ii, jj, tpt.lj_override_eg(t(sig), t(eps), t(old[0]), t(old[1]),
                                   cut), "cpu")
    t_e = term(t(pos), t([L] * 3), None, False,
               tcp.atom_scales(t(s), 4), n_replicas=2)[0].numpy()

    def lj(r, sg, ep):
        x6 = (sg / r) ** 6
        return 4 * ep * x6 * (x6 - 1)

    true = [lj(0.15, 0.31, 0.8) - lj(0.15, 0.3, 0.5),
            lj(0.3, 0.31, 0.8) - lj(0.3, 0.3, 0.5)]
    np.testing.assert_allclose(t_e, true, rtol=1e-12)
    np.testing.assert_allclose(j_e[1], true[1], rtol=1e-12)
    wrong = lj(0.05, 0.31, 0.8) - lj(0.05, 0.3, 0.5)
    np.testing.assert_allclose(j_e[0], wrong, rtol=1e-9)
    assert abs(j_e[0] - true[0]) > 1e3 * abs(true[0])
