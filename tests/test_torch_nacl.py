"""The reference example's system and workflow through the PyTorch port,
against the JAX package on the CPU in f64: build_nacl_water_box (the same
system and positions); load_nacl_swm4 on a PDB this test writes with the
JAX package's io/pdbfile.write_pdb in the HOH/ion layout io/nacl.py reads
(the same system, NBFIX and NBTHOLE tables included); the energy and
forces those tables add (NBFIX through NonbondedForce.addLJPairOverride,
NBTHOLE through DrudeForce.addNBTholePair), 1e-10 relative and 1e-8 of
max|dF|; Simulation with StateDataReporter and CheckpointReporter for 20
steps (the CSV's header equal, each value within 1e-9 relative or one
unit of its last printed digit); checkpoint resume bit for bit, with a
barostat, on both strategies; and the port's example module for 10
steps on the CPU."""

import io

import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu.io import nacl as jnacl
from openmm_drudenose_tpu.io import pdbfile as jpdb
from openmm_drudenose_tpu_torch.examples import nacl_tg
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from openmm_drudenose_tpu_torch.io import nacl as tnacl
from torch_threads import _one_thread  # noqa: F401

# a small solution: 60 waters, 2 Na+, 2 Cl- in a 1.32 nm box
N_W, N_NA, N_CL, CUTOFF = 60, 2, 2, 0.6
NBFIX = {("SOD", "CLA"): (3.2, 0.08), ("CLA", "CLA"): (4.4, 0.09)}
NBTHOLE = {("SOD", "CLA"): 1.3, ("CLA", "CLA"): 1.1}


def _system_fields(system):
    """Everything a System holds, as plain Python values."""
    forces = {type(f).__name__: f for f in system.getForces()}
    nb, dr = forces["NonbondedForce"], forces["DrudeForce"]
    vs = {i: (type(system.getVirtualSite(i)).__name__,
              system.getVirtualSite(i).particles,
              system.getVirtualSite(i).weights)
          for i in range(system.getNumParticles())
          if system.isVirtualSite(i)}
    return dict(
        masses=[system.getParticleMass(i)
                for i in range(system.getNumParticles())],
        constraints=[system.getConstraintParameters(i)
                     for i in range(system.getNumConstraints())],
        vsites=vs, box=system.getDefaultPeriodicBoxVectors(),
        forces=sorted(forces), nb_particles=nb._particles,
        exceptions=nb._exceptions, overrides=nb._lj_overrides,
        nb_method=(nb.getNonbondedMethod(), nb.getCutoffDistance(),
                   nb.getEwaldErrorTolerance()),
        drude=dr._particles, screened=dr._screened_pairs,
        nbthole=dr._nbthole)


def test_build_nacl_water_box_matches_jax():
    jsys, jpos = jbuilders.build_nacl_water_box(492, 10, 10)
    tsys, tpos = tbuilders.build_nacl_water_box(492, 10, 10)
    np.testing.assert_array_equal(tpos, jpos)
    assert _system_fields(tsys) == _system_fields(jsys)
    assert tsys.getNumParticles() == 2500


def _pdb(tmp_path):
    """A PDB of the small solution in nacl_1m_pos.pdb's layout, written
    by the JAX package: HOH as OH2/H1/H2/OM/DOH2, SOD/DSOD and CLA/DCLA;
    one Cl- moved to 0.28 nm of a Na+ along a cell diagonal (~0.28 nm
    from the nearest lattice sites), where NBFIX and NBTHOLE matter."""
    _, pos = jbuilders.build_nacl_water_box(N_W, N_NA, N_CL)
    kinds = ["NA"] * N_NA + ["CL"] * N_CL + ["W"] * N_W
    np.random.default_rng(7).shuffle(kinds)   # as build_nacl_water_box
    atoms, coords, k, ions = [], [], 0, {"NA": [], "CL": []}
    for res, kind in enumerate(kinds, start=1):
        if kind == "W":
            o, d, h1, h2, m = pos[k:k + 5]
            names, xyz, k = ["OH2", "H1", "H2", "OM", "DOH2"], \
                [o, h1, h2, m, d], k + 5
            rn = "HOH"
        else:
            rn = {"NA": "SOD", "CL": "CLA"}[kind]
            ions[kind].append(len(coords))
            names, xyz, k = [rn, "D" + rn], [pos[k], pos[k + 1]], k + 2
        for name, p in zip(names, xyz):
            atoms.append(jpdb.PDBAtom(serial=len(atoms) + 1, name=name,
                                      res_name=rn, chain="A", res_seq=res,
                                      element=name[0]))
            coords.append(np.array(p))
    coords = np.array(coords)
    na, cl = ions["NA"][0], ions["CL"][0]
    coords[cl] = coords[cl + 1] = coords[na] + 0.28 / np.sqrt(3.0)
    box = np.diagonal(np.array(
        jbuilders.build_nacl_water_box(N_W, N_NA, N_CL)[0]
        .getDefaultPeriodicBoxVectors()))
    path = str(tmp_path / "nacl.pdb")
    jpdb.write_pdb(path, coords, jpdb.PDBTopology(atoms), box_nm=box)
    return path


@pytest.fixture(scope="module")
def pdb_path(tmp_path_factory):
    return _pdb(tmp_path_factory.mktemp("nacl"))


def test_load_nacl_swm4_matches_jax(pdb_path):
    jsys, jpos, jtop = jnacl.load_nacl_swm4(pdb_path, cutoff=CUTOFF,
                                            nbfix=NBFIX, nbthole=NBTHOLE)
    tsys, tpos, ttop = tnacl.load_nacl_swm4(pdb_path, cutoff=CUTOFF,
                                            nbfix=NBFIX, nbthole=NBTHOLE)
    np.testing.assert_array_equal(tpos, jpos)
    assert _system_fields(tsys) == _system_fields(jsys)
    assert len(tsys.getForce(0)._lj_overrides) == 2
    assert len(tsys.getForce(1)._nbthole) == 2 * 2 + 1
    assert [a.name for a in ttop.atoms] == [a.name for a in jtop.atoms]


def _energy_forces(pkg, loader, path, tables):
    kw = dict(nbfix=NBFIX, nbthole=NBTHOLE) if tables else {}
    system, pos, _ = loader.load_nacl_swm4(path, cutoff=CUTOFF, **kw)
    integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    extra = {"device": "cpu"} if pkg is dt else {}
    ctx = pkg.Context(system, integ, precision="double", **extra)
    ctx.setPositions(pos)
    st = ctx.getState(energy=True, forces=True)
    return st.getPotentialEnergy(), st.getForces()


def test_nbfix_nbthole_match_jax(pdb_path):
    """What the NBFIX and NBTHOLE tables add to the energy and forces:
    the same in both packages (and not negligible)."""
    out = {}
    for pkg, loader in ((dn, jnacl), (dt, tnacl)):
        e1, f1 = _energy_forces(pkg, loader, pdb_path, True)
        e0, f0 = _energy_forces(pkg, loader, pdb_path, False)
        out[pkg] = (e1, f1, e1 - e0, f1 - f0)
    je, jf, jde, jdf = out[dn]
    te, tf, tde, tdf = out[dt]
    assert abs(jde) > 1.0
    np.testing.assert_allclose(te, je, rtol=1e-10)
    np.testing.assert_allclose(tde, jde, rtol=1e-10)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-8 * np.abs(jf).max())
    np.testing.assert_allclose(tdf, jdf, rtol=0,
                               atol=1e-8 * np.abs(jdf).max())


def test_energy_only_paths_match_the_force_paths(pdb_path):
    """The energy that Context._potential reads through the energy-only
    paths (the PME energy without its potential grid, the pair-list
    extras and the Drude terms, NBTHOLE included, without forces) is the
    energy of the force paths, in f64."""
    from openmm_drudenose_tpu_torch.constraints.vsites import apply_vsites
    system, pos, _ = tnacl.load_nacl_swm4(pdb_path, cutoff=CUTOFF,
                                          nbfix=NBFIX, nbthole=NBTHOLE)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    ctx = dt.Context(system, integ, precision="double", device="cpu")
    ctx.setPositions(pos)
    st, nb = ctx._state, ctx._nb
    p = apply_vsites(ctx._spec, ctx._static, st.positions)
    box = torch.diagonal(st.box)
    parts = [(nb.recip_energy(p, box), nb.recip(p, box)[0]),
             (nb.extras(p, box, with_forces=False)[0], nb.extras(p, box)[0])]
    parts += [(t.energy_forces(p, box, with_forces=False)[0],
               t.energy_forces(p, box)[0]) for t in ctx._terms]
    assert len(parts) >= 3
    for energy_only, with_forces in parts:
        assert float(energy_only) == pytest.approx(float(with_forces),
                                                   rel=1e-13, abs=1e-12)


def _csv_rows(text):
    lines = text.strip().splitlines()
    return lines[0], [ln.split(",") for ln in lines[1:]]


def test_simulation_reporters_match_jax(pdb_path, tmp_path):
    """20 steps with both reporters (every 10): the CSV against the JAX
    package's, the speed column left out (a wall-clock figure); the
    checkpoint is written and loads."""
    texts, states = {}, {}
    for pkg, loader in ((dn, jnacl), (dt, tnacl)):
        system, pos, top = loader.load_nacl_swm4(
            pdb_path, cutoff=CUTOFF, nbfix=NBFIX, nbthole=NBTHOLE)
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        integ.setMaxDrudeDistance(0.02)
        extra = {"device": "cpu"} if pkg is dt else {}
        sim = pkg.Simulation(top, system, integ, precision="double",
                             **extra)
        sim.context.setPositions(pos)
        sim.context.setVelocities(
            np.random.default_rng(4).normal(0.0, 0.2, pos.shape))
        out = io.StringIO()
        sim.reporters.append(pkg.StateDataReporter(
            out, 10, step=True, time=True, potentialEnergy=True,
            kineticEnergy=True, totalEnergy=True, temperature=True,
            density=True, groupTemperatures=True, speed=True))
        chk = str(tmp_path / f"{pkg.__name__}.chk")
        sim.reporters.append(pkg.CheckpointReporter(chk, 10))
        sim.step(20)
        texts[pkg] = out.getvalue()
        states[pkg] = sim.context.getState(positions=True).getPositions()
        if pkg is dt:
            sim.loadCheckpoint(chk)
            assert sim.currentStep == 20
    jhead, jrows = _csv_rows(texts[dn])
    thead, trows = _csv_rows(texts[dt])
    assert thead == jhead
    assert len(trows) == len(jrows) == 2
    for jr, tr in zip(jrows, trows):
        for jv, tv in zip(jr[:-1], tr[:-1]):
            unit = 10.0 ** -(len(jv.split(".")[1]) if "." in jv else 0)
            assert abs(float(tv) - float(jv)) <= max(
                1e-9 * abs(float(jv)), unit), (jv, tv)
    np.testing.assert_allclose(states[dt], states[dn], rtol=0, atol=1e-9)


def _ckpt_ctx(strategy):
    if strategy == "dense":
        system, pos = tbuilders.build_nacl_water_box(N_W, N_NA, N_CL,
                                                     cutoff=CUTOFF)
    else:
        # 64 waters, 5^3 cells: the smallest regular cell grid
        system, pos = tbuilders.build_water_box(64, cutoff=0.35)
    system.addForce(dt.MonteCarloBarostat(1.01325, 300.0, 4))
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision="single", strategy=strategy,
                     seed=3, device="cpu")
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(50.0, seed=2)
    return ctx, integ


@pytest.mark.parametrize("strategy", ["dense", "cellpair"])
def test_checkpoint_resume_bit_exact(tmp_path, strategy):
    """Save, 20 steps, load into a fresh Context, 20 steps: positions,
    velocities, box and the barostat's state equal bit for bit (the
    cell sort, the NH chain and the generator come back with the
    state)."""
    ctx, integ = _ckpt_ctx(strategy)
    integ.step(20)
    path = str(tmp_path / "state.npz")
    dt.save_checkpoint(path, ctx)
    integ.step(20)
    ref = ctx.getState(positions=True, velocities=True)
    ref_baro = (ctx._state.baro_scale, ctx._state.baro_naccept,
                ctx._state.baro_nattempt)
    assert ctx._state.baro_scale > 0
    ctx2, integ2 = _ckpt_ctx(strategy)
    dt.load_checkpoint(path, ctx2)
    assert ctx2._state.step == 20
    integ2.step(20)
    res = ctx2.getState(positions=True, velocities=True)
    np.testing.assert_array_equal(res.getPositions(), ref.getPositions())
    np.testing.assert_array_equal(res.getVelocities(), ref.getVelocities())
    np.testing.assert_array_equal(res.getPeriodicBoxVectors(),
                                  ref.getPeriodicBoxVectors())
    assert (ctx2._state.baro_scale, ctx2._state.baro_naccept,
            ctx2._state.baro_nattempt) == ref_baro


def test_example_runs_on_cpu(monkeypatch, tmp_path):
    """The port's example module end to end on the CPU for 10 steps
    (reporters every 5), on the small solution in place of its
    2,500-atom box, whose 200 FIRE iterations take half a minute on a
    CPU: minimize, 300 K velocities, barostat, reporters, ns/day."""
    small = tbuilders.build_nacl_water_box(N_W, N_NA, N_CL, cutoff=CUTOFF)
    monkeypatch.setattr(nacl_tg, "build", lambda pdb=None: (*small, None))
    out = io.StringIO()
    sim = nacl_tg.main(10, report_every=5, device="cpu",
                       checkpoint=str(tmp_path / "nacl_eq.chk"), out=out)
    head, rows = _csv_rows(out.getvalue())
    assert head.startswith("#Step,Time (ps),PE (kJ/mol)")
    assert [r[0] for r in rows] == ["5", "10"]
    assert all(np.isfinite(float(v)) for r in rows for v in r)
    assert sim.context._state.baro_nattempt == 1    # at step 0
