"""The solvated polymer (io/polymer.py) through the PyTorch port against
the JAX package: the same System, force for force, and the same waters,
but for two faults of the JAX builder that the port's mends (ROADMAP.md
Queue C), each pinned here: its wrapped beads stretch the bonds of every
chain that crosses a face (C13; the port's chains are unwrapped), and it
leaves the shells of 1-2 and 1-3 bead pairs unexcluded, so a 1-3 pair
attracts as -qb^2/r (C15; the port excludes them).  On the port's
positions, with the JAX System given the same exclusions, energy and
forces in f64 (energy 1e-10 relative, forces 1e-8 of max|F|) under the
reaction field and PME, and 30 steps (positions 1e-9 nm)."""

import numpy as np
import pytest

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.io import polymer as jpoly
from openmm_drudenose_tpu_torch.io import polymer as tpoly
from torch_threads import _one_thread  # noqa: F401

NB = dt.NonbondedForce
# the JAX package's own test system (tests/test_polymer.py)
ARGS = dict(n_chains=2, chain_length=10, n_water=50)

FORCE_LISTS = (("NonbondedForce", ("_particles", "_exceptions")),
               ("DrudeForce", ("_particles",)),
               ("HarmonicBondForce", ("_bonds",)),
               ("HarmonicAngleForce", ("_angles",)),
               ("PeriodicTorsionForce", ("_torsions",)))


def _builds(method=NB.CutoffPeriodic, cutoff=0.9):
    return (jpoly.build_solvated_polymer(**ARGS, method=method,
                                         cutoff=cutoff),
            tpoly.build_solvated_polymer(**ARGS, method=method,
                                         cutoff=cutoff))


def _force(system, name):
    return next(f for f in system.getForces() if type(f).__name__ == name)


def _shell_pairs(poly):
    """The pairs of the port's C15 exclusions: each bead's shell with the
    previous bead's shell, and with the bead two back and its shell, and
    the bead with the shell two back (beads at even indices of `poly`,
    ARGS' chains in order)."""
    L = ARGS["chain_length"]
    beads = poly[::2]
    out = []
    for c in range(ARGS["n_chains"]):
        chain = beads[c * L:(c + 1) * L]
        for i, bead in enumerate(chain):
            shell = bead + 1
            if i >= 1:
                out.append((chain[i - 1] + 1, shell))
            if i >= 2:
                p2 = chain[i - 2]
                out += [(p2, shell), (p2 + 1, bead), (p2 + 1, shell)]
    return out


def _bond_lengths(system, pos):
    b = np.array([x[:2] for x in _force(system, "HarmonicBondForce")._bonds])
    return np.linalg.norm(pos[b[:, 0]] - pos[b[:, 1]], axis=1)


def test_system_matches_jax_force_for_force():
    (js, jpos, jp, jw), (ts, tpos, tp, tw) = _builds()
    assert (tp, tw) == (jp, jw)
    n = js.getNumParticles()
    assert ts.getNumParticles() == n
    assert [ts.getParticleMass(i) for i in range(n)] \
        == [js.getParticleMass(i) for i in range(n)]
    assert ts.getNumConstraints() == js.getNumConstraints()
    assert [ts.getConstraintParameters(i)
            for i in range(ts.getNumConstraints())] \
        == [js.getConstraintParameters(i)
            for i in range(js.getNumConstraints())]
    np.testing.assert_array_equal(
        np.array(ts.getDefaultPeriodicBoxVectors()),
        np.array(js.getDefaultPeriodicBoxVectors()))
    assert [type(f).__name__ for f in ts.getForces()] \
        == [type(f).__name__ for f in js.getForces()]
    for name, attrs in FORCE_LISTS:
        for a in attrs:
            got = getattr(_force(ts, name), a)
            if (name, a) == ("NonbondedForce", "_exceptions"):
                # the JAX list, in order, once the C15 pairs are taken out
                added = set(_shell_pairs(tp))
                assert {e[:2] for e in got if e[:2] in added} == added
                got = [e for e in got if e[:2] not in added]
            assert got == getattr(_force(js, name), a), (name, a)
    # the waters are the same; the beads are the same up to whole boxes
    np.testing.assert_array_equal(tpos[len(tp):], jpos[len(jp):])
    box = np.diagonal(np.array(js.getDefaultPeriodicBoxVectors()))
    np.testing.assert_allclose(np.mod(tpos[:len(tp)], box), jpos[:len(jp)],
                               rtol=0, atol=1e-12)


def test_jax_builder_stretches_bonds_of_wrapped_chains():
    """Queue C13: the JAX builder writes np.mod(bead, box), and bonded
    terms take no minimum image, so the chains that cross a face start
    with bonds about a box length long (2 of 18 here, the longest 3.05
    nm in a 3.25 nm box); the port's unwrapped chains keep every bond at
    the 0.36 nm step of their walk."""
    (js, jpos, _, _), (ts, tpos, _, _) = _builds()
    jl, tl = _bond_lengths(js, jpos), _bond_lengths(ts, tpos)
    assert len(jl) == 18
    assert int(np.sum(jl > 1.0)) == 2
    assert jl.max() == pytest.approx(3.05, abs=0.01)
    np.testing.assert_allclose(tl, 0.36, rtol=1e-12)


def test_jax_builder_leaves_1_3_shells_unexcluded():
    """Queue C15: between the two Drude pairs (bead +qb, shell -qb) of a
    1-3 bead pair the JAX builder excludes only bead-bead, so the
    charge products left sum to -qb^2 (a net attraction, -501/r kJ/mol
    at qb = 1.9 e, with the beads' LJ excluded); in the port's System
    every pair is excluded.  The 1-2 shells repel as +qb^2/r there."""
    (js, _, jp, _), (ts, _, tp, _) = _builds()
    out = []
    for system in (js, ts):
        nb = _force(system, "NonbondedForce")
        q = np.array([p[0] for p in nb._particles])
        excl = {(min(a, b), max(a, b)) for a, b, *_ in nb._exceptions}
        sums = []
        for gap in (1, 2):
            i, j = jp[2 * 4], jp[2 * (4 + gap)]   # beads 4 and 4 + gap
            sums.append(sum(q[a] * q[b] for a in (i, i + 1)
                            for b in (j, j + 1)
                            if (min(a, b), max(a, b)) not in excl))
        out.append((sums, q[jp[0]]))
    (jsums, qb), (tsums, _) = out
    assert qb == pytest.approx(1.9, abs=0.01)
    assert jsums == pytest.approx([qb * qb, -qb * qb], rel=1e-12)
    assert tsums == [0, 0]


def _contexts(method, cutoff):
    """Both packages' Contexts in f64 (the dense strategy: 380 atoms) on
    the port's unwrapped positions, after the constraints are applied;
    the JAX System given the port's C15 exclusions."""
    (js, _, jp, jw), (ts, tpos, tp, tw) = _builds(method, cutoff)
    jnb = _force(js, "NonbondedForce")
    for a, b in _shell_pairs(tp):
        jnb.addException(a, b, 0, 1, 0)
    out = []
    for pkg, mod, system, kw in ((dn, jpoly, js, {}),
                                 (dt, tpoly, ts, {"device": "cpu"})):
        integ = mod.make_tgnh_integrator(jp, jw, system.getNumParticles())
        integ.setMaxDrudeDistance(0.02)
        ctx = pkg.Context(system, integ, precision="double", **kw)
        ctx.setPositions(tpos)
        ctx.applyConstraints(1e-10)
        out.append((ctx, integ))
    return out


@pytest.mark.parametrize("method,cutoff", [(NB.CutoffPeriodic, 0.9),
                                           (NB.PME, 0.9)], ids=["rf", "pme"])
def test_energy_forces_match_jax_on_unwrapped_positions(method, cutoff):
    out = []
    for ctx, _ in _contexts(method, cutoff):
        st = ctx.getState(energy=True, forces=True)
        out.append((st.getPotentialEnergy(), np.asarray(st.getForces()),
                    np.asarray(ctx._spec.nh_nkbt)))
    (e_ref, f_ref, nk_ref), (e, f, nk) = out
    assert len(nk) == 4 and np.all(nk > 0)
    np.testing.assert_allclose(nk, nk_ref, rtol=1e-12)
    np.testing.assert_allclose(e, e_ref, rtol=1e-10)
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())


def test_thirty_steps_f64_match_jax():
    """30 steps of both packages' f64 Contexts from the same relaxed
    positions (40 FIRE iterations of the port) and 300 K velocities:
    positions to 1e-9 nm, the four baths' temperatures to 1e-8."""
    (jctx, jint), (tctx, tint) = _contexts(NB.CutoffPeriodic, 0.9)
    tctx.minimizeEnergy(maxIterations=40)
    pos = tctx.getPositions()
    rng = np.random.default_rng(6)
    m = np.array([tctx.getSystem().getParticleMass(i)
                  for i in range(len(pos))])
    vel = rng.normal(size=pos.shape) * np.sqrt(
        dt.BOLTZ * 300.0 / np.where(m > 0, m, 1.0))[:, None]
    vel[m == 0] = 0.0
    for ctx in (jctx, tctx):
        ctx.setPositions(pos)
        ctx.setVelocities(vel)
        ctx.applyVelocityConstraints(1e-10)
    jint.step(30)
    tint.step(30)
    np.testing.assert_allclose(tctx.getPositions(),
                               np.asarray(jctx.getPositions()),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        tctx.getState(groups=True).getGroupTemperatures(),
        jctx.getState(groups=True).getGroupTemperatures(), rtol=1e-8)
