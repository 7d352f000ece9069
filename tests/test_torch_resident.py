"""The state-resident decomposition of the PyTorch port (parallel/
resident.py) on CPU gloo ranks, in f64, against the JAX package: the
counterpart of tests/test_resident.py, on its deck (swm4_water_box(
grid_size=6, cutoff=0.7): 1,080 atoms, a 10^3 cell grid, window 2, so
two slabs of 5 planes take the w + 2 = 4 plane halo).

The ranks import only torch_ranks.py and the port (spawned, one thread
each); the JAX side runs in the test process meanwhile.  Bounds (the JAX
test's, test_resident.py:40-53): positions 1e-9 nm and eta 1e-11 after
16 steps in rebuild blocks of 8 (two segments, a migration between);
the ranks' eta and box the same bits.  Also: the host analysis against
the JAX `analyze`, the refusals with the JAX exception types, a
migration that only relabels (positions moved by box_x / 4, each rank's
molecule count the JAX engine's), a MonteCarloBarostat run and the
NBTHOLE dense block (the two cases that reach the global molecule count
and the all_gather), a world-1 resident run in this process, and the
Stepper's reduce hook on the path."""

import gc
import weakref

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
import torch_ranks
import util
from openmm_drudenose_tpu.app import serialization as jser
from openmm_drudenose_tpu.parallel import resident as jres
from openmm_drudenose_tpu.units import ONE_4PI_EPS0
from openmm_drudenose_tpu_torch.app import serialization as tser
from openmm_drudenose_tpu_torch.parallel import comm, resident
from torch_threads import _one_thread  # noqa: F401

RANKS, STEPS, INTERVAL = 2, 16, 8
PME, CUT = dn.NonbondedForce.PME, dn.NonbondedForce.CutoffPeriodic
# the barostat run's (proposal, Metropolis) uniforms: two growths of
# 0.1 % and 0.2 % of the volume, both accepted
DRAWS = [(0.55, 1e-12), (0.6, 1e-12), (0.4, 0.5), (0.45, 0.5)]


def _water(method=PME, rigid_hh=True):
    system, positions = util.swm4_water_box(grid_size=6, cutoff=0.7,
                                            add_cm_motion=False,
                                            rigid_hh=rigid_hh)
    system.getForce(0).setNonbondedMethod(method)
    return system, positions


def _nbthole():
    """tests/test_resident.py::test_resident_nbthole_matches_single's
    deck: six ions in lattice holes, every cross pair listed."""
    from openmm_drudenose_tpu.forces.drude import DrudeForce
    ion = {"NA": (1.0, 0.2430, 0.546, 0.000157, 0.4, 22.59),
           "CL": (-1.0, 0.4612, 0.301, 0.003969, 0.4, 35.05)}
    system, positions = _water()
    nb = system.getForce(0)
    df = next(f for f in system.getForces() if isinstance(f, DrudeForce))
    holes = [(0, 0, 0), (1, 2, 3), (2, 4, 1), (3, 1, 4), (4, 3, 2),
             (4, 0, 0)]
    kinds = ["NA", "CL", "NA", "CL", "NA", "CL"]
    pos_list, ions = [positions], []
    for (i, j, k), kind in zip(holes, kinds):
        q, sigma, eps, alpha, d_mass, mass = ion[kind]
        q_d = -np.sqrt(alpha * 100000 * 4.184 / ONE_4PI_EPS0)
        start = system.addParticle(mass - d_mass)
        system.addParticle(d_mass)
        nb.addParticle(q - q_d, sigma, eps)
        nb.addParticle(q_d, 1.0, 0.0)
        nb.addException(start, start + 1, 0, 1, 0)
        ions.append((df.addParticle(start + 1, start, -1, -1, -1, q_d,
                                    alpha, 1, 1), kind))
        center = (np.array([i, j, k]) + 0.5) * 0.6
        pos_list.append(np.array([center, center]))
    thole = {("NA", "NA"): 1.0, ("CL", "CL"): 1.2, ("NA", "CL"): 0.8,
             ("CL", "NA"): 0.8}
    for a in range(len(ions)):
        for b in range(a + 1, len(ions)):
            df.addNBTholePair(ions[a][0], ions[b][0],
                              thole[(ions[a][1], ions[b][1])])
    return system, np.concatenate(pos_list, axis=0)


def _jax_context(system, positions, seed=0, integrator=None,
                 nb_options=None):
    """The JAX test's Context: f64, cell pairs, constraints applied,
    velocities at 200 K (the ionic liquid's `integrator`: no
    constraints, 300 K)."""
    integ = integrator or dn.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005,
                                                 0.0005, 20, 2)
    integ.setMaxDrudeDistance(0.05)
    ctx = dn.Context(system, integ, precision="double", strategy="cellpair",
                     nb_options=nb_options)
    ctx.setPositions(positions)
    if integrator is None:
        ctx.applyConstraints(1e-6)
        ctx.setVelocitiesToTemperature(200.0, seed=seed)
    else:
        ctx.setVelocitiesToTemperature(300.0, seed=seed)
    ctx._ensure_forces()
    return ctx


def _case(name, kind, jctx, system, **kw):
    return dict(name=name, kind=kind, xml=jser.serialize_system(system),
                pos=np.asarray(jctx._state.positions),
                vel=np.asarray(jctx._state.velocities), **kw)


def _jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("atom",))


@pytest.fixture(scope="module")
def runs():
    """The ranks' cases in one launch, and beside it the JAX references:
    single Contexts stepped alike, the JAX ResidentContext on two of
    conftest's virtual devices (CutoffPeriodic) and its migration."""
    decks = {m: _water(m) for m in (PME, CUT)}
    jctx = {m: _jax_context(*decks[m]) for m in decks}
    nt_sys, nt_pos = _nbthole()
    nt_ctx = _jax_context(nt_sys, nt_pos, seed=5)
    box_x = float(np.diagonal(np.asarray(jctx[PME]._state.box))[0])
    npt = tser.deserialize_system(jser.serialize_system(decks[PME][0]))
    npt.addForce(dt.MonteCarloBarostat(1.01325, 300.0, 4))
    cases = [
        _case("traj_pme", "traj", jctx[PME], decks[PME][0], steps=STEPS,
              interval=INTERVAL),
        _case("traj_cut", "traj", jctx[CUT], decks[CUT][0], steps=STEPS,
              interval=INTERVAL),
        _case("migrate", "migrate", jctx[PME], decks[PME][0], Rc=200,
              Ec=96, shift=box_x / 4),
        dict(_case("npt", "npt", jctx[PME], decks[PME][0], steps=8,
                   interval=4, draws=DRAWS),
             xml=tser.serialize_system(npt)),
        _case("nbthole", "nbthole", nt_ctx, nt_sys, steps=8)]
    fut = torch_ranks.launch_beside(torch_ranks.resident_suite, RANKS,
                                    cases)
    ref = {}
    # the JAX engine's migration of the same state
    rctx = jres.ResidentContext(jctx[PME], _jax_mesh(2), Rc=200, Ec=96)
    with rctx._mesh:
        st = rctx._get_reb()(rctx._st)
        st = dict(st)
        shift = np.zeros(3)
        shift[0] = box_x / 4
        st["pos"] = st["pos"] + shift
        ref["migrate_n_mol"] = np.asarray(rctx._get_reb()(st)["n_mol"])
    # the JAX ResidentContext over two devices (CutoffPeriodic)
    jr = jres.ResidentContext(_jax_context(*decks[CUT]), _jax_mesh(2))
    jr._rebuild_interval = INTERVAL
    jr.step(STEPS)
    ref["jax_resident_cut"] = (jr.positions(), np.asarray(jr.state["eta"]))
    for m, tag in ((PME, "traj_pme"), (CUT, "traj_cut")):
        jctx[m].getIntegrator().step(STEPS)
        ref[tag] = (jctx[m].getPositions(), np.asarray(jctx[m]._state.eta))
    nt_ctx.getIntegrator().step(8)
    ref["nbthole"] = nt_ctx.getPositions()
    return fut.result(), ref


@pytest.mark.parametrize("tag", ["traj_pme", "traj_cut"])
def test_trajectory_two_ranks(runs, tag):
    """16 steps in two rebuild segments over two ranks == the JAX single
    Context (PME and CutoffPeriodic); the ranks' eta and box the same
    bits, every molecule owned once."""
    got, ref = runs
    pos, eta = ref[tag]
    for out in got:
        r = out[tag]
        np.testing.assert_allclose(r["pos"], pos, rtol=0, atol=1e-9)
        np.testing.assert_allclose(r["eta"], eta, rtol=0, atol=1e-11)
        assert r["eta"].tobytes() == got[0][tag]["eta"].tobytes()
        assert r["box"].tobytes() == got[0][tag]["box"].tobytes()
        assert r["step"] == STEPS
    assert sum(out[tag]["n_mol"] for out in got) == 216


def test_trajectory_matches_jax_resident(runs):
    """The same run against the JAX ResidentContext on two virtual
    devices (CutoffPeriodic)."""
    got, ref = runs
    pos, eta = ref["jax_resident_cut"]
    for out in got:
        np.testing.assert_allclose(out["traj_cut"]["pos"], pos, rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(out["traj_cut"]["eta"], eta, rtol=0,
                                   atol=1e-11)


def test_migration_relabels_only(runs):
    """A rebuild after every position moved by box_x / 4 (~2.5 planes:
    many anchors change owner) is a pure relabelling: the gathered
    positions are p0 + shift and the velocities unchanged, the global
    count conserved, each rank's count the JAX engine's."""
    got, ref = runs
    for d, out in enumerate(got):
        r = out["migrate"]
        shift = np.zeros(3)
        shift[0] = float(np.diagonal(r["box"])[0]) / 4
        assert not r["overflow"]
        np.testing.assert_allclose(r["pos"], r["p0"] + shift, rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(r["vel"], r["v0"], rtol=0, atol=1e-12)
        assert r["n_mol"] == int(ref["migrate_n_mol"][d])
    n0 = [out["migrate"]["n0"] for out in got]
    n1 = [out["migrate"]["n_mol"] for out in got]
    assert sum(n0) == sum(n1) == 216
    assert n0 != n1, "the shift should move molecules"


def test_barostat_short(runs):
    """8 steps with a MonteCarloBarostat every 4 (two attempts, fed
    draws, both accepted) against the one-rank Context from the same
    draws: positions 1e-9 nm, the box 1e-12, the counters; the volume
    moved and every rank's box is the same bits."""
    got, _ = runs
    for out in got:
        r = out["npt"]
        np.testing.assert_allclose(r["pos"], r["one_pos"], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(r["box"], r["one_box"], rtol=1e-12)
        assert tuple(r["counts"]) == tuple(r["one_counts"]) == (2, 2)
        assert r["box"].tobytes() == got[0]["npt"]["box"].tobytes()
    assert abs(float(got[0]["npt"]["box"][0, 0]) - 4.2) > 1e-6


def test_nbthole_short(runs):
    """The NBTHOLE deck (type-complete cross-molecule ion pairs) through
    the dense all_gather block: 8 steps against the JAX single Context's
    explicit pair list."""
    got, ref = runs
    for out in got:
        np.testing.assert_allclose(out["nbthole"]["pos"], ref["nbthole"],
                                   rtol=0, atol=1e-9)
    assert all(out["nbthole"]["n_mol"] > 0 for out in got)


def _port(system, positions, strategy="cellpair", integrator=None):
    """A port Context (f64, CPU) on the JAX System's XML."""
    tsys = tser.deserialize_system(jser.serialize_system(system))
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005, 0.0005, 20, 2)
    integ.setMaxDrudeDistance(0.05)
    ctx = dt.Context(tsys, integ, precision="double", strategy=strategy,
                     device="cpu")
    ctx.setPositions(positions)
    return ctx


@pytest.mark.parametrize("deck", ["water", "nbthole"])
def test_analyze_matches_jax(deck):
    """The port's templates, molecule types and bases and maxima equal
    the JAX analyze's on the same system (the fields both keep)."""
    system, positions = _water() if deck == "water" else _nbthole()
    jctx = dn.Context(system, dn.DrudeTGNHIntegrator(
        300.0, 0.1, 1.0, 0.005, 0.0005, 20, 2), precision="double",
        strategy="cellpair")
    jtp, jtype, jbase, jmx = jres.analyze(jctx)
    tp, mtype, mbase, mx = resident.analyze(_port(system, positions))
    np.testing.assert_array_equal(mtype, jtype)
    np.testing.assert_array_equal(mbase, jbase)
    shared = sorted(set(tp) & set(jtp))
    assert len(shared) == len(tp) - 1         # all but res_inv_mass
    for k in shared:
        a, b = tp[k], np.asarray(jtp[k])
        assert a.shape == b.shape, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-13, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("s_max", "va_max", "vo_max", "vl_max", "d_max", "sp_max",
              "e_max", "x_max", "b_max", "a_max", "t_max", "sh_max",
              "lc_k", "n_words", "K", "has_aniso1", "has_aniso2"):
        assert mx[k] == jmx[k], k
    if deck == "nbthole":
        np.testing.assert_allclose(mx["nt_tab"], jmx["nt_tab"], rtol=1e-13)
        assert int((tp["nt_class"] > 0).sum()) == 4   # water + NA + CL


class _Mesh:
    """What ResidentContext reads of a comm.Mesh before its first
    collective: the refusals come before it."""

    def __init__(self, n):
        self.n, self.device, self.backend = n, torch.device("cpu"), "gloo"

    def size(self, axis):
        return self.n

    def index(self, axis):
        return 0


def _refused(case):
    """The port Context of a refusal case and the mesh size."""
    if case.startswith("nt_"):
        system, positions = _nbthole()
    else:
        system, positions = _water()
    ctx = _port(system, positions,
                strategy="dense" if case == "strategy" else "cellpair")
    tsys = ctx._system
    df = next(f for f in tsys.getForces() if isinstance(f, dt.DrudeForce))
    nb = next(f for f in tsys.getForces()
              if isinstance(f, dt.NonbondedForce))
    if case == "nt_incomplete":
        df._nbthole.pop()
    elif case == "nt_duplicate":
        df.addNBTholePair(*df._nbthole[0])
    elif case == "nt_degenerate":
        p = df._nbthole[0][0]
        df.addNBTholePair(p, p, 1.0)
    elif case == "nt_within":
        # an exception binds the first two ions into one molecule
        a, b = (df.getParticleParameters(p)[1] for p in df._nbthole[0][:2])
        nb.addException(a, b, 0.0, 1.0, 0.0)
    elif case == "row_across":
        df.addScreenedPair(0, 1, 2.6)
    elif case == "force":
        tor = dt.HarmonicTorsionForce()
        tor.addTorsion(0, 1, 2, 3, 0.0, 1.0)
        tsys.addForce(tor)
    elif case == "nbfix":
        nb.addLJPairOverride([0], [5], 0.3, 0.5)
    if case in ("nt_incomplete", "nt_duplicate", "nt_degenerate",
                "nt_within", "row_across", "force", "nbfix"):
        ctx.reinitialize()
        ctx.setPositions(positions)
    return ctx, {"grid": 3, "slab": 5}.get(case, 2)


@pytest.mark.parametrize("case, err", [
    ("nt_incomplete", NotImplementedError),
    ("nt_duplicate", NotImplementedError),
    ("nt_degenerate", NotImplementedError),
    ("nt_within", NotImplementedError),
    ("row_across", AssertionError),
    ("force", NotImplementedError),
    ("nbfix", NotImplementedError),
    ("strategy", ValueError),
    ("grid", ValueError),
    ("slab", ValueError),
    ("capacity", ValueError)])
def test_refusals(case, err):
    """Each refusal of the host analysis and of the constructor raises
    the JAX module's exception type: an NBTHOLE list that is not
    type-complete, has a duplicate or degenerate pair or a pair within
    one molecule; a term row across molecules; a force outside the scope
    (a harmonic torsion; NBFIX overrides, which the JAX module does not
    check); another strategy; a grid x not divisible by the ranks, slabs
    narrower than w + 2 planes, an initial count above Rc."""
    ctx, n = _refused(case)
    kw = {"Rc": 10} if case == "capacity" else {}
    with pytest.raises(err):
        resident.ResidentContext(ctx, _Mesh(n), **kw)


def test_world_one_in_process():
    """A one-rank CPU ResidentContext in this process (gloo, world 1)
    against the port's single Context: 16 steps, 1e-10 nm.  It keeps
    no reference to the Context it was built from, which is freed before
    the steps."""
    system, positions = _water()
    ref = _port(system, positions)
    ref.setVelocitiesToTemperature(200.0, seed=1)
    vel = ref._state.velocities.numpy().copy()
    ctx = _port(system, positions)
    ctx.setVelocities(vel)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        rctx = resident.ResidentContext(ctx, comm.Mesh(("atom",)))
        gone = weakref.ref(ctx)
        del ctx
        gc.collect()
        assert gone() is None
        rctx.step(STEPS)
        got, eta = rctx.positions(), rctx.state["eta"].numpy()
    finally:
        dist.destroy_process_group()
    ref.step(STEPS)
    np.testing.assert_allclose(got, ref.getPositions(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(eta, ref._state.eta.numpy(), rtol=0,
                               atol=1e-12)


def test_stepper_reduce_is_on_the_path():
    """The Stepper's reduce sees every KE on its way to the host: one
    that doubles it changes the chain, the identity leaves every bit."""
    system, positions = _water(CUT)
    runs = {}
    for name, fn in (("none", None), ("same", lambda h: h),
                     ("double", lambda h: 2.0 * h)):
        ctx = _port(system, positions)
        ctx.setVelocitiesToTemperature(200.0, seed=2)
        ctx._ensure_forces()
        ctx._stepper.reduce = fn
        ctx.step(4)
        runs[name] = (ctx._state.eta.numpy(), ctx._state.positions.numpy())
    for a, b in zip(runs["none"], runs["same"]):
        assert a.tobytes() == b.tobytes()
    assert np.abs(runs["double"][0] - runs["none"][0]).max() > 1e-6


def _slow_case(name, system, positions, steps=8, ranks=2, integrator=None,
               nb_options=None, ions=None):
    """Run one case on `ranks` ranks beside the JAX single Context."""
    kw = {} if nb_options is None else {"nb_options": nb_options}
    jctx = _jax_context(system, positions, 3 if integrator else 0,
                        integrator, nb_options)
    case = _case(name, "traj", jctx, system, steps=steps, **kw)
    if ions is not None:
        case["ions"] = ions
    fut = torch_ranks.launch_beside(torch_ranks.resident_suite, ranks,
                                    [case])
    jctx.getIntegrator().step(steps)
    ref = jctx.getPositions()
    for out in fut.result():
        np.testing.assert_allclose(out[name]["pos"], ref, rtol=0,
                                   atol=1e-9)


@pytest.mark.slow
def test_four_ranks():
    """Four slabs (the grid_size=10 box: 16 planes, 4 a slab) against
    the JAX single Context, 8 steps."""
    system, positions = util.swm4_water_box(grid_size=10, cutoff=0.7,
                                            add_cm_motion=False)
    system.getForce(0).setNonbondedMethod(PME)
    _slow_case("four", system, positions, ranks=4)


@pytest.mark.slow
def test_eight_ranks():
    """All eight slabs of the JAX dryrun's elongated (8, 1, 1) box (40
    x-planes, 5 a slab), 8 steps."""
    from openmm_drudenose_tpu.io import builders
    system, positions = builders.build_water_box(
        216, method=PME, cutoff=0.7, add_cm_motion=False, density=3.375,
        shape=(8, 1, 1))
    _slow_case("eight", system, positions, ranks=8,
               nb_options={"grid_x_multiple": 8})


@pytest.mark.slow
def test_shake():
    """SHAKE clusters (the H-H constraint dropped) through the per-type
    templates, 8 steps."""
    _slow_case("shake", *_water(PME, rigid_hh=False))


@pytest.mark.slow
def test_bonded_multigroup():
    """Bonds and angles, four baths (cation, anion, COM, Drude) and the
    reaction field: the ionic liquid of the JAX test, 8 steps."""
    from openmm_drudenose_tpu.io import ionic_liquid
    system, positions, cations, anions = ionic_liquid.build_ionic_liquid(
        n_pairs=140, density=0.5, method=CUT, cutoff=1.2,
        add_cm_motion=False)
    integ = ionic_liquid.make_tgnh_integrator(
        cations, anions, system.getNumParticles(), temperature=400.0,
        step_size=0.0005)
    _slow_case("il", system, positions, integrator=integ,
               ions=(list(cations), list(anions)))
