"""The bonded forces of the PyTorch port (forces/bonded.py) against the
JAX package's (forces/bonded.py there, autodiff forces) in f64: energy to
1e-10 relative, forces to 1e-8 of max|F|; a near-collinear torsion; the
analytic forces against central finite differences of the port's own
energy; the terms through a Context."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.forces import bonded as jb
from torch_threads import _one_thread  # noqa: F401

N_ATOMS, N_TERMS = 30, 12
KINDS = ["HarmonicBondForce", "HarmonicAngleForce", "PeriodicTorsionForce",
         "HarmonicTorsionForce"]


def _forces(kind, rng, rows=None):
    """The same force in both packages, with terms from `rng` (or
    `rows`: tuples of atom indices)."""
    jf, tf = getattr(jb, kind)(), getattr(dt, kind)()
    n_idx = {"HarmonicBondForce": 2, "HarmonicAngleForce": 3}.get(kind, 4)
    if rows is None:
        rows = [tuple(rng.choice(N_ATOMS, n_idx, replace=False))
                for _ in range(N_TERMS)]
    for idx in rows:
        if kind == "HarmonicBondForce":
            args = (*idx, rng.uniform(0.1, 0.3), rng.uniform(1e3, 1e5))
            fn = "addBond"
        elif kind == "HarmonicAngleForce":
            args = (*idx, rng.uniform(1.5, 2.5), rng.uniform(100, 500))
            fn = "addAngle"
        elif kind == "PeriodicTorsionForce":
            args = (*idx, int(rng.integers(1, 4)), rng.uniform(0, np.pi),
                    rng.uniform(0.5, 5))
            fn = "addTorsion"
        else:
            args = (*idx, rng.uniform(-np.pi, np.pi), rng.uniform(5, 50))
            fn = "addTorsion"
        getattr(jf, fn)(*args)
        getattr(tf, fn)(*args)
    return jf, tf


def _jax_energy_forces(jf, pos):
    energy, params = jf.compile(None, jnp.float64)
    box = jnp.eye(3) * 3.0
    e, g = jax.value_and_grad(lambda p: energy(params, p, box))(
        jnp.asarray(pos))
    return float(e), -np.asarray(g)


def _port_energy_forces(tf, pos):
    term = tf.compile(None, torch.float64, "cpu")
    e, f = term.energy_forces(torch.as_tensor(pos), None)
    return float(e), f.numpy()


def _near_collinear(rng):
    """Torsions whose first three atoms lie within 1e-4 rad of a line."""
    pos = rng.normal(size=(N_ATOMS, 3))
    rows = []
    for t in range(N_ATOMS // 4):
        i, j, k, l = 4 * t, 4 * t + 1, 4 * t + 2, 4 * t + 3
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        perp = np.cross(axis, rng.normal(size=3))
        perp /= np.linalg.norm(perp)
        pos[j] = pos[i] + 0.15 * axis
        pos[k] = pos[j] + 0.15 * axis + 0.15 * 1e-4 * perp
        pos[l] = pos[k] + 0.15 * rng.normal(size=3)
        rows.append((i, j, k, l))
    return pos, rows


@pytest.mark.parametrize("kind", KINDS)
def test_matches_jax_f64(kind):
    rng = np.random.default_rng(11)
    pos = rng.normal(size=(N_ATOMS, 3))
    jf, tf = _forces(kind, rng)
    e_ref, f_ref = _jax_energy_forces(jf, pos)
    e, f = _port_energy_forces(tf, pos)
    np.testing.assert_allclose(e, e_ref, rtol=1e-10)
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())


@pytest.mark.parametrize("kind", ["PeriodicTorsionForce",
                                  "HarmonicTorsionForce"])
def test_near_collinear_torsion_matches_jax(kind):
    """Three atoms 1e-4 rad from a line: the derivative grows as 1/|c1|
    (forces ~1e4 x those of a bent torsion) and stays the true one."""
    rng = np.random.default_rng(12)
    pos, rows = _near_collinear(rng)
    jf, tf = _forces(kind, rng, rows)
    e_ref, f_ref = _jax_energy_forces(jf, pos)
    e, f = _port_energy_forces(tf, pos)
    assert np.abs(f_ref).max() > 1e3
    np.testing.assert_allclose(e, e_ref, rtol=1e-10)
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())


@pytest.mark.parametrize("kind", KINDS)
def test_forces_are_minus_the_energy_gradient(kind):
    """Central differences of the port's f64 energy (step 1e-6 nm) give
    its analytic forces to 1e-6 of max|F|."""
    rng = np.random.default_rng(13)
    pos = rng.normal(size=(N_ATOMS, 3))
    _, tf = _forces(kind, rng)
    term = tf.compile(None, torch.float64, "cpu")
    _, f = term.energy_forces(torch.as_tensor(pos), None)
    h = 1e-6
    fd = np.zeros_like(pos)
    for a in range(N_ATOMS):
        for c in range(3):
            plus, minus = pos.copy(), pos.copy()
            plus[a, c] += h
            minus[a, c] -= h
            ep = float(term.energy_forces(torch.as_tensor(plus), None,
                                          with_forces=False)[0])
            em = float(term.energy_forces(torch.as_tensor(minus), None,
                                          with_forces=False)[0])
            fd[a, c] = -(ep - em) / (2 * h)
    f = f.numpy()
    np.testing.assert_allclose(f, fd, rtol=0, atol=1e-6 * np.abs(f).max())


def test_bonded_terms_in_context_match_jax():
    """A chain of eight beads with every bonded force, through each
    package's Context in f64: energy 1e-10, forces 1e-8 of max|F|."""
    rng = np.random.default_rng(14)
    pos = np.cumsum(rng.normal(0.0, 0.15, (8, 3)), axis=0) + 1.0
    # and a Drude pair apart (the integrator needs a DrudeForce)
    pos = np.concatenate([pos, [[3.0, 3.0, 3.0], [3.0, 3.0, 3.005]]])
    out = []
    for pkg, kw in ((dn, {}), (dt, {"device": "cpu"})):
        system = pkg.System()
        for _ in range(8):
            system.addParticle(12.0)
        system.addParticle(15.6)
        system.addParticle(0.4)
        drude = pkg.DrudeForce()
        drude.addParticle(9, 8, -1, -1, -1, -1.0, 0.001, 1, 1)
        system.addForce(drude)
        system.setDefaultPeriodicBoxVectors((4, 0, 0), (0, 4, 0), (0, 0, 4))
        rng_p = np.random.default_rng(15)
        forces = {k: getattr(jb if pkg is dn else dt, k)() for k in KINDS}
        for t in range(5):
            forces["HarmonicBondForce"].addBond(t, t + 1, 0.15, 3e4)
            forces["HarmonicAngleForce"].addAngle(t, t + 1, t + 2, 1.9, 300)
            forces["PeriodicTorsionForce"].addTorsion(
                t, t + 1, t + 2, t + 3, 3, 0.2, 2.0)
            forces["HarmonicTorsionForce"].addTorsion(
                t, t + 1, t + 2, t + 3, rng_p.uniform(-3, 3), 10.0)
        for f in forces.values():
            system.addForce(f)
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20)
        ctx = pkg.Context(system, integ, precision="double", **kw)
        ctx.setPositions(pos)
        st = ctx.getState(energy=True, forces=True)
        out.append((st.getPotentialEnergy(), np.asarray(st.getForces())))
    (e_ref, f_ref), (e, f) = out
    np.testing.assert_allclose(e, e_ref, rtol=1e-10)
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())
