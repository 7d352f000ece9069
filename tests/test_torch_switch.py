"""Switched Lennard-Jones in the PyTorch port against the JAX package's
XLA route (use_pallas 0, its CPU default; its Pallas route drops the
switch, ROADMAP.md Queue C14, pinned in tests/test_torch_rf.py).

In f64 on the CPU with the same inputs: Contexts of a switched water box
on the dense and cell-pair (plain sweep) strategies, Ewald/PME and the
reaction field, orthorhombic and triclinic (energy 1e-10 relative, forces
1e-8 of max|F|); the reference plugin's own switched PME system
(tests/util.py::ion_pair_pme_box, testForceEnergyConsistency); switched
NBFIX overrides; the dispersion coefficient with the switching window
(1e-12); the per-replica mc_energies of a switched flat-NPT ensemble
(1e-10); the switched force-field deck on the cell-pair strategy.  In
f32, kernels B1's and B2's plain versions with the switch against the
JAX XLA sweep (2e-5 of max|F|).  The CUDA kernels are held against these
plain versions on the card (chip_smoke.py phase 15,
tests/test_torch_gpu.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
import test_forcefield as jtf
import util
from openmm_drudenose_tpu.app import forcefield as jff
from openmm_drudenose_tpu.app import serialization as jser
from openmm_drudenose_tpu.forces import cellpair as jcp
from openmm_drudenose_tpu.forces import nonbonded as jnb
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu.io import pdbfile as jpdb
from openmm_drudenose_tpu.parallel.flatrep import \
    FlatReplicaEnsemble as JaxFlat
from openmm_drudenose_tpu_torch.app import forcefield as tff
from openmm_drudenose_tpu_torch.app import serialization as tser
from openmm_drudenose_tpu_torch.forces import cellpair as tcp
from openmm_drudenose_tpu_torch.forces import nonbonded as tnb
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from openmm_drudenose_tpu_torch.io import pdbfile as tpdb
from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
from openmm_drudenose_tpu_torch.parallel import flatrep
from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
from torch_threads import _one_thread  # noqa: F401

NB = dt.NonbondedForce
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# the smallest water box with a regular cell grid at this cutoff (5^3),
# switched over the last 0.1 nm
N_MOL, CUTOFF, R_ON = 125, 0.5, 0.4
SHEAR = (0.2, 0.1, 0.15)
METHODS = {"ewald": NB.PME, "rf": NB.CutoffPeriodic}


def _switched(system, r_on=R_ON):
    nbf = next(f for f in system.getForces()
               if type(f).__name__ == "NonbondedForce")
    nbf.setUseSwitchingFunction(True)
    nbf.setSwitchingDistance(r_on)
    return nbf


def _water(pkg, build, method, triclinic=False, n_mol=N_MOL, cutoff=CUTOFF):
    system, pos = build.build_water_box(n_mol, method=method, cutoff=cutoff)
    _switched(system)
    if triclinic:
        L = np.array(system.getDefaultPeriodicBoxVectors())[0, 0]
        a, b, c = SHEAR
        system.setDefaultPeriodicBoxVectors(
            (L, 0, 0), (a * L, L, 0), (b * L, c * L, L))
    return system, pos


def _energy_forces(pkg, system, pos, strategy="auto", precision="double"):
    kw = {"device": "cpu"} if pkg is dt else {}
    integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    ctx = pkg.Context(system, integ, precision=precision, strategy=strategy,
                      **kw)
    ctx.setPositions(pos)
    st = ctx.getState(energy=True, forces=True)
    return st.getPotentialEnergy(), np.asarray(st.getForces()), ctx


def _assert_match(ref, got):
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-10)
    np.testing.assert_allclose(got[1], ref[1], rtol=0,
                               atol=1e-8 * np.abs(ref[1]).max())


@pytest.mark.parametrize("geometry", ["orthorhombic", "triclinic"])
@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("strategy", ["dense", "cellpair"])
def test_switched_context_matches_jax(strategy, method, geometry):
    tri = geometry == "triclinic"
    out = []
    for pkg, build in ((dn, jbuilders), (dt, tbuilders)):
        system, pos = _water(pkg, build, METHODS[method], tri)
        pos = pos + np.random.default_rng(7).uniform(-0.01, 0.01, pos.shape)
        out.append(_energy_forces(pkg, system, pos, strategy))
    nb = out[1][2]._nb
    assert nb.strategy == strategy and nb.r_switch == R_ON
    assert nb.coulomb["method"] == method and nb.coulomb["r_switch"] == R_ON
    _assert_match(out[0], out[1])


def test_reference_switched_pme_system_matches_jax():
    """The reference plugin's force/energy consistency system
    (Test*DrudeTGNHIntegrator.cpp:194-231): core-shell pairs, PME with the
    LJ switched from 0.9 nm to the 1.0 nm cutoff."""
    js, pos = util.ion_pair_pme_box()
    ts = tser.deserialize_system(jser.serialize_system(js))
    pos = pos + np.random.default_rng(3).normal(0, 0.01, pos.shape)
    ref = _energy_forces(dn, js, pos)
    got = _energy_forces(dt, ts, pos)
    assert got[2]._nb.r_switch == 0.9
    _assert_match(ref, got)


def test_switched_nbfix_matches_jax():
    """NBFIX overrides between two sets of oxygens, switched as the main
    sum (the JAX package's lj_override_eg with use_switch)."""
    out = []
    for pkg, build in ((dn, jbuilders), (dt, tbuilders)):
        system, pos = _water(pkg, build, NB.PME)
        nbf = next(f for f in system.getForces()
                   if type(f).__name__ == "NonbondedForce")
        nbf.addLJPairOverride(list(range(0, 150, 5)),
                              list(range(150, 400, 5)), 0.33, 1.7)
        out.append(_energy_forces(pkg, system, pos, "dense"))
    assert out[1][2]._nb.override_term is not None
    _assert_match(out[0], out[1])


@pytest.mark.parametrize("r_switch", [None, 0.75, 0.9, 0.999])
def test_dispersion_coefficient_matches_jax(r_switch):
    rng = np.random.default_rng(11)
    sigma = rng.uniform(0.1, 0.45, 300)
    eps = rng.uniform(0.0, 1.2, 300)
    ref = jnb._dispersion_coefficient(sigma, eps, 1.0, r_switch is not None,
                                      -1.0 if r_switch is None else r_switch)
    got = tnb.dispersion_coefficient(sigma, eps, 1.0, r_switch)
    assert got == pytest.approx(ref, rel=1e-12)


@pytest.fixture(scope="module")
def switched32():
    """The f32 cell-pair Contexts of both packages on the switched water
    box of each Coulomb kind, at drifted positions (the JAX XLA sweep's
    neighbours)."""
    out = {}
    for method in METHODS:
        ctxs = []
        for pkg, build in ((dn, jbuilders), (dt, tbuilders)):
            system, pos = _water(pkg, build, METHODS[method])
            kw = {"device": "cpu"} if pkg is dt else {}
            ctx = pkg.Context(system, pkg.DrudeTGNHIntegrator(
                300.0, 0.1, 1.0, 0.1, 0.001, 20, 1), precision="single",
                strategy="cellpair", **kw)
            ctx.setPositions(pos)
            ctx._ensure_neighbors()
            ctxs.append(ctx)
        pos = np.asarray(ctxs[1]._state.positions, np.float64)
        pos = (pos + np.random.default_rng(3).uniform(-0.03, 0.03,
                                                      pos.shape)
               ).astype(np.float32)
        out[method] = (*ctxs, pos)
    return out


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("kernel", [sweep, sweep_chunked], ids=["b1", "b2"])
def test_switched_plain_versions_match_jax_xla(switched32, kernel, method):
    """B1's and B2's plain versions (the CPU's side of their wrappers)
    with the switch against the JAX XLA sweep's switched pair function
    (its A&S erfc in f32) on the same f32 positions."""
    jctx, tctx, pos = switched32[method]
    nb_fn, nb_params = next(t for t in jctx._terms
                            if hasattr(t[0], "cellpair_cfg"))
    nb = tctx._nb
    kw = {"alpha": nb.alpha} if method == "ewald" else \
        {"krf": nb.coulomb["krf"], "crf": nb.coulomb["crf"]}
    pair_eg = jcp.make_pair_eg(method, CUTOFF, use_switch=True,
                               r_switch=R_ON, excl_in_sweep=False, **kw)
    _, f_ref = jcp.pair_energy_forces(
        nb_params, jnp.asarray(pos), jnp.diagonal(jctx._state.box),
        jctx._state.neighbors, jctx._cp_cfg, pair_eg, nb_fn.coulomb_scale,
        with_energy=False)
    f_ref = np.asarray(f_ref)
    tbox = torch.diagonal(tctx._state.box)
    fields = nb.fields(torch.as_tensor(pos), tbox, tctx._state.neighbors)
    f = kernel.pair_forces(fields, nb.cfg, tcp.offset_shifts(nb.cfg, tbox),
                           nb.alpha, ONE_4PI_EPS0, excl_skip=True,
                           **nb.coulomb)
    f = f[tctx._state.neighbors.inv_slot].numpy()
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=2e-5 * np.abs(f_ref).max())


def test_switch_arguments_and_launch_keys():
    """The wrappers pass (use_switch, r_on, r_off - r_on) and refuse a
    switch outside [0, cutoff); switched launches count under "_sw"."""
    cfg = tcp.make_config(1.2, [6.0] * 3, 1000, [0], [1])
    assert sweep.switch_args(cfg, None) == (0, 0.0, 1.0)
    on, r_on, width = sweep.switch_args(cfg, 1.0)
    assert on == 1 and r_on == 1.0 and width == pytest.approx(0.2)
    for bad in (1.2, 1.5, -0.1, float("nan")):
        with pytest.raises(ValueError):
            sweep.switch_args(cfg, bad)
    assert sweep.launch_key("b1", False, "ewald", cfg, False, True) \
        == "b1_sweep_sw"
    assert sweep.launch_key("b2", True, "rf", cfg, True, True) \
        == "b2_energy_rf_scaled_sw"
    assert all(k in sweep.launches for k in
               ("b1_sweep_sw", "b1_energy_rf_sw", "b2_sweep_bands_sw",
                "b2_energy_scaled_sw"))


def _flat_npt(pkg, build, ens_cls):
    """A 2-replica switched flat-NPT ensemble at scales (1.03, 0.97),
    NBFIX and NBTHOLE between two molecules (tests/test_flatnpt.py's
    extras), each replica the template COM-scaled by its scale."""
    system, pos = build.build_water_box(100, method=pkg.NonbondedForce.PME,
                                        cutoff=0.45)
    _switched(system, 0.35)
    next(f for f in system.getForces()
         if isinstance(f, pkg.DrudeForce)).addNBTholePair(0, 1, 1.3)
    next(f for f in system.getForces()
         if isinstance(f, pkg.NonbondedForce)).addLJPairOverride(
             [10], [15], 0.31, 0.8)
    system.addForce(pkg.MonteCarloBarostat(1.01325, 300.0, 2))
    kw = {"device": "cpu"} if pkg is dt else {}
    integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005, 0.0005, 20, 2)
    tpl = pkg.Context(system, integ, precision="double",
                      strategy="cellpair", **kw)
    tpl.setPositions(pos)
    ens = ens_cls(tpl, 2, rx=2, rz=1)
    m = np.array([system.getParticleMass(i)
                  for i in range(system.getNumParticles())]).reshape(-1, 5)
    p = np.asarray(pos, np.float64).reshape(-1, 5, 3)
    com = (m[:, :, None] * p).sum(axis=1) / m.sum(axis=1)[:, None]
    scales = (1.03, 0.97)
    out = np.stack([(p + (s - 1.0) * com[:, None, :]).reshape(-1, 3)
                    for s in scales])
    return ens, scales, out


def test_switched_flat_npt_mc_energies_match_jax():
    """The per-replica energies of a volume move (sweep, PME, the
    switched tail, switched NBFIX; NBTHOLE) against the JAX Context's
    mc_energies hooks, in f64."""
    jens, scales, pos = _flat_npt(dn, jbuilders, JaxFlat)
    jens.context._state = jens.context._state._replace(
        rep_scale=jnp.asarray(np.array(scales)))
    jens.setPositions(pos)
    jctx = jens.context
    jctx._ensure_neighbors()
    st = jctx._state
    ref = sum(t[0].mc_energies(t[1], st.positions, st.box, st.neighbors,
                               st.rep_scale)
              for t in jctx._terms if getattr(t[0], "mc_energies", None))
    tens, _, _ = _flat_npt(dt, tbuilders, flatrep.FlatReplicaEnsemble)
    tctx = tens.context
    tctx._state = tctx._state.replace(
        rep_scale=torch.tensor(scales, dtype=torch.float64))
    tens.setPositions(pos)
    tctx._ensure_neighbors()
    assert tctx._nb.r_switch == 0.35 and tctx._nb.override_term is not None
    ts = tctx._state
    got = tctx._mc_energies(ts.positions, ts.box, ts.neighbors, None,
                            ts.rep_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10)


def test_switched_ff_deck_on_cellpair_matches_jax(tmp_path):
    """createSystem(switchDistance=0.55) of the swm4_nacl deck at a 0.65
    nm cutoff (its box has a regular cell grid there, not at 0.9) in a
    Context on the cell-pair strategy, against the JAX Context's XLA
    route (tests/test_torch_forcefield.py holds the deck at 0.9 / 0.8 on
    the dense strategy)."""
    _, bare = jtf._make_nacl_files(tmp_path)
    out = []
    for pkg, ffm, pdbm in ((dn, jff, jpdb), (dt, tff, tpdb)):
        ff = ffm.ForceField(os.path.join(DATA, "swm4_nacl.xml"))
        pdb = pdbm.PDBFile(bare)
        m = ffm.Modeller(pdb.topology, pdb.positions)
        m.addExtraParticles(ff)
        system = ff.createSystem(m.topology, nonbondedMethod=ffm.PME,
                                 nonbondedCutoff=0.65,
                                 constraints=ffm.HBonds,
                                 switchDistance=0.55)
        out.append(_energy_forces(pkg, system,
                                  np.asarray(m.positions, np.float64),
                                  "cellpair"))
    assert out[1][2]._nb.strategy == "cellpair"
    assert out[1][2]._nb.r_switch == 0.55
    _assert_match(out[0], out[1])
