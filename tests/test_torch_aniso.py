"""Anisotropic Drude springs (aniso12 and aniso34, axis particles 2-4)
in the port's DrudeForce against the JAX package in float64 on the CPU:
the spring energy and its analytic forces against JAX autodiff (the JAX
tests/test_forces.py case and a mixed system where only some Drudes are
anisotropic), a Context and steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from torch_threads import _one_thread  # noqa: F401

# (drude, parent, p2, p3, p4, q, alpha, aniso12, aniso34)
ROWS = {
    "jax_case": [(1, 0, 2, 3, 4, 0.5, 0.0015, 0.8, 1.1)],
    "both_axes": [(1, 0, 2, 3, 4, 0.5, 0.0015, 0.8, 1.2)],
    "mixed": [(1, 0, 2, 3, 4, 0.5, 0.0015, 0.8, 1.1),
              (6, 5, 7, -1, -1, -0.7, 0.002, 1.3, 1.0),
              (9, 8, -1, 5, 7, 0.4, 0.001, 1.0, 0.7),
              (11, 10, -1, -1, -1, -1.1, 0.0012, 1.0, 1.0)],
}
MASSES = (16.0, 0.4, 1.0, 1.0, 12.0, 14.0, 0.4, 1.0, 15.0, 0.4, 13.0, 0.4)


def _system(pkg, rows):
    n = max(max(r[:5]) for r in rows) + 1
    s = pkg.System()
    for m in MASSES[:n]:
        s.addParticle(m)
    drude = pkg.DrudeForce()
    for r in rows:
        drude.addParticle(*r)
    s.addForce(drude)
    return s, n


def _positions(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 0.2, (n, 3))
    for r in ROWS["mixed"]:
        if r[0] < n:
            pos[r[0]] = pos[r[1]] + rng.normal(0, 0.01, 3)
    return pos


def _jax_energy_forces(rows, n, pos):
    """The JAX DrudeForce's energy and autodiff forces over `rows`, one
    row at a time (the springs add row by row; see
    test_jax_mixed_axis_rows_give_nan for why not all at once)."""
    e, f = 0.0, np.zeros((n, 3))
    for row in rows:
        s, _ = _system(dn, [row])
        while s.getNumParticles() < n:
            s.addParticle(1.0)
        fn, params = s.getForces()[0].compile(s, jnp.float64)
        box = jnp.eye(3) * 4.0
        pj = jnp.asarray(pos)
        e += float(fn(params, pj, box))
        f -= np.asarray(jax.grad(lambda p: fn(params, p, box))(pj))
    return e, f


@pytest.mark.parametrize("case", sorted(ROWS))
def test_aniso_spring_equals_jax(case):
    st, n = _system(dt, ROWS[case])
    pos = _positions(n, 3)
    e_j, f_j = _jax_energy_forces(ROWS[case], n, pos)
    term = st.getForces()[0].compile(st, torch.float64, "cpu")
    # the JAX case has a3 = a2 (k2 = 0): one axis term
    assert len(term.aniso) == (1 if case == "jax_case" else 2)
    e_t, f_t = term.energy_forces(torch.tensor(pos), torch.full((3,), 4.0,
                                                                dtype=torch.float64))
    e_only, _ = term.energy_forces(torch.tensor(pos), with_forces=False)
    assert float(e_t) == pytest.approx(e_j, rel=1e-10)
    assert float(e_only) == float(e_t)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(f_j)))


def test_jax_mixed_axis_rows_give_nan():
    """ROADMAP.md C20: where one row has a second axis (k2 != 0) and
    another has none (particle3 = particle4 = -1), the JAX DrudeForce
    takes that row's axis as p[0] - p[0] (forces/drude.py:123-136,
    :185-188 there), divides it by its zero norm and gets 0 * NaN: the
    whole energy is NaN.  The port keeps each axis term to its own
    rows."""
    sj, n = _system(dn, ROWS["mixed"])
    st, _ = _system(dt, ROWS["mixed"])
    pos = _positions(n, 3)
    fn, params = sj.getForces()[0].compile(sj, jnp.float64)
    assert np.isnan(float(fn(params, jnp.asarray(pos), jnp.eye(3) * 4.0)))
    e_t, f_t = st.getForces()[0].compile(st, torch.float64, "cpu") \
        .energy_forces(torch.tensor(pos))
    assert np.isfinite(float(e_t)) and torch.all(torch.isfinite(f_t))


def test_aniso_context_and_steps_equal_jax():
    out = []
    pos = _positions(5, 5)
    vel = np.random.default_rng(8).normal(0, 0.2, pos.shape)
    for pkg, kw in ((dn, {}), (dt, {"device": "cpu"})):
        s, _ = _system(pkg, ROWS["both_axes"])
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.0005, 20, 1)
        ctx = pkg.Context(s, integ, precision="double", **kw)
        ctx.setPositions(pos)
        ctx.setVelocities(vel)
        st = ctx.getState(energy=True, forces=True)
        e0, f0 = st.getPotentialEnergy(), np.asarray(st.getForces())
        integ.step(10)
        out.append((e0, f0, np.asarray(
            ctx.getState(positions=True).getPositions())))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-10)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(out[1][2], out[0][2], rtol=0, atol=1e-10)
