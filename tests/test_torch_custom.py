"""The port's expression compiler (utils/expr.py), Custom*Forces
(forces/custom.py) and Context parameters against the JAX package in
float64 on the CPU: expression values and gradients to 1e-12, each
custom force's energy and forces to 1e-10 and 1e-8 (cutoff, switch,
periodic and triclinic periodicdistance included), setParameter /
getParameter(s), and custom forces in a flat ensemble."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.forces import custom as jcustom
from openmm_drudenose_tpu.utils import expr as jexpr
from openmm_drudenose_tpu_torch.forces import boxutils
from openmm_drudenose_tpu_torch.forces import custom as tcustom
from openmm_drudenose_tpu_torch.utils import expr as texpr
from torch_threads import _one_thread  # noqa: F401

F64 = jnp.float64

EXPRESSIONS = [
    ("0.5*k*(r-r0)^2", {"k": 3.0}),
    ("D*(1-exp(-a*(r-r0)))^2", {"D": 300.0, "a": 20.0}),
    ("4*eps*(s6^2-s6); s6=(sig/r)^6", {"eps": 0.7, "sig": 0.31}),
    ("erfc(al*r)/r + erf(r)*sqrt(r) - log(r) + atan2(r, r0)",
     {"al": 3.1}),
    ("step(r-r0)*cube(r) + delta(r-r0) + select(step(r-r0), sin(r), "
     "cos(r))", {}),
    ("min(r, r0)^3 + max(r, r0)^-2 + abs(r-r0) + square(r) + recip(r)",
     {}),
    ("tanh(r) + sinh(r) + cosh(r) + tan(r) + sec(r) + csc(r) + cot(r)",
     {}),
    ("acos(r/2) + asin(r/2) + atan(r) + floor(3*r) + ceil(3*r) + "
     "r^1.5 + 2^r", {}),
    ("a*b; a=2*c; b=sqrt(c)+r; c=r^2", {}),
]


@pytest.mark.parametrize("text,consts", EXPRESSIONS,
                         ids=[e[0][:24] for e in EXPRESSIONS])
def test_expression_values_and_gradients_equal_jax(text, consts):
    r = np.linspace(0.12, 1.9, 23)
    r0 = np.full_like(r, 0.95)
    names = ["r", "r0"] + list(consts)
    jfn = jexpr.compile_expression(text, names)
    tfn = texpr.compile_expression(text, names)

    def jax_e(rr):
        return jnp.sum(jfn(dict(consts, r=rr, r0=jnp.asarray(r0))))

    ej = float(jax_e(jnp.asarray(r)))
    gj = np.asarray(jax.grad(jax_e)(jnp.asarray(r)))
    rt = torch.tensor(r, requires_grad=True)
    et = torch.sum(tfn(dict(consts, r=rt, r0=torch.tensor(r0))))
    (gt,) = torch.autograd.grad(et, rt)
    assert float(et.detach()) == pytest.approx(ej, rel=1e-12, abs=1e-12)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-12, atol=1e-12)


def test_expression_errors_and_names_as_jax():
    bad = [("x + y", ["x"]), ("x +", ["x"]), ("foo(x)", ["x"]),
           ("sqrt(x, y)", ["x", "y"]), ("x $ y", ["x", "y"]), ("", ["x"]),
           ("a*b; a", ["b"]), ("dist(x)", ["x"])]
    for text, names in bad:
        with pytest.raises(jexpr.ExpressionError) as ej:
            jexpr.compile_expression(text, names)
        with pytest.raises(texpr.ExpressionError) as et:
            texpr.compile_expression(text, names)
        assert str(et.value) == str(ej.value)
    for text in ("4*eps*(s^2-s); s=(sig/r)^6",
                 "0.5*k*periodicdistance(x, y, z, x0, y0, z0)^2",
                 "a*b; b=sqrt(abs(a))"):
        assert texpr.expression_names(text) == jexpr.expression_names(text)
        assert texpr.expression_functions(text) == \
            jexpr.expression_functions(text)
    fn = texpr.compile_expression("dist(x, y)^2", ["x", "y"],
                                  extra_fns={"dist": 2})
    assert float(fn({"x": 3.0, "y": 7.0, "dist": lambda a, b: b - a})) == 16
    # a constant integer power of a negative base is defined
    fn = texpr.compile_expression("(r-r0)^2", ["r", "r0"])
    assert float(fn({"r": torch.tensor(0.09), "r0": 0.1})) == \
        pytest.approx(1e-4)


def _system(pkg, n, box=((4.0, 0, 0), (0, 4.0, 0), (0, 0, 4.0))):
    s = pkg.System()
    for _ in range(n):
        s.addParticle(16.0)
    s.setDefaultPeriodicBoxVectors(*box)
    return s


def _pair(build, n, box=((4.0, 0, 0), (0, 4.0, 0), (0, 0, 4.0))):
    """The same force built in both packages, with its two Systems."""
    sj, st = _system(dn, n, box), _system(dt, n, box)
    fj, ft = build(jcustom), build(tcustom)
    sj.addForce(fj)
    st.addForce(ft)
    return sj, fj, st, ft


def _held(sj, fj, st, ft, pos):
    box = np.array(sj.getDefaultPeriodicBoxVectors(), np.float64)
    fn, params = fj.compile(sj, F64)
    pj = jnp.asarray(pos, F64)
    bj = jnp.asarray(box, F64)
    ej = float(fn(params, pj, bj))
    gj = -np.asarray(jax.grad(lambda p: fn(params, p, bj))(pj))
    term = ft.compile(st, torch.float64, "cpu")
    tri = boxutils.is_triclinic(box)
    et, f_t = term.energy_forces(
        torch.tensor(pos), boxutils.mi_box(torch.tensor(box), tri))
    assert float(et) == pytest.approx(ej, rel=1e-10)
    np.testing.assert_allclose(f_t.numpy(), gj, rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(gj)))


def _bond(m):
    f = m.CustomBondForce("scale*D*(1-exp(-aa*(r-r0)))^2")
    for nm in ("D", "aa", "r0"):
        f.addPerBondParameter(nm)
    f.addGlobalParameter("scale", 0.7)
    for i, j in ((0, 1), (2, 3), (4, 5)):
        f.addBond(i, j, [300.0 + i, 20.0, 0.15])
    return f


def _angle(m):
    f = m.CustomAngleForce("0.5*kq*(theta-th0)^2")
    f.addPerAngleParameter("kq")
    f.addPerAngleParameter("th0")
    f.addAngle(0, 1, 2, [90.0, 1.8])
    f.addAngle(3, 4, 5, [70.0, 2.1])
    return f


def _torsion(m):
    f = m.CustomTorsionForce("kt*(1+cos(np*theta-ph))")
    for nm in ("kt", "np", "ph"):
        f.addPerTorsionParameter(nm)
    f.addTorsion(0, 1, 2, 3, [5.0, 2.0, 0.5])
    f.addTorsion(2, 3, 4, 5, [3.0, 3.0, 0.0])
    return f


def _external(m):
    f = m.CustomExternalForce(
        "lam*0.5*kk*periodicdistance(x, y, z, x0, y0, z0)^2 + c*z")
    for nm in ("kk", "x0", "y0", "z0"):
        f.addPerParticleParameter(nm)
    f.addGlobalParameter("lam", 0.75)
    f.addGlobalParameter("c", 0.3)
    f.addParticle(0, [200.0, 3.9, 0.1, 2.0])
    f.addParticle(3, [120.0, 3.8, 3.9, 3.7])
    f.addParticle(3, [80.0, 0.2, 0.3, 0.4])
    return f


def _nonbonded(method, switch):
    def build(m):
        f = m.CustomNonbondedForce(
            "4*eps*(s6^2-s6) + q1*q2/r; s6=(sig/r)^6; "
            "sig=0.5*(sigma1+sigma2); eps=sqrt(epsilon1*epsilon2)")
        for nm in ("sigma", "epsilon", "q"):
            f.addPerParticleParameter(nm)
        rng = np.random.default_rng(9)
        for i in range(12):
            f.addParticle([0.3 + 0.02 * rng.random(), 0.5 + rng.random(),
                           (-1.0) ** i * 0.2])
        f.addExclusion(0, 1)
        f.addExclusion(2, 5)
        f.setNonbondedMethod(method)
        f.setCutoffDistance(0.9)
        if switch:
            f.setUseSwitchingFunction(True)
            f.setSwitchingDistance(0.7)
        return f
    return build


TRICLINIC = ((2.0, 0, 0), (0.5, 2.0, 0), (0.3, 0.4, 2.0))
FORCES = {
    "bond": (_bond, 6, None), "angle": (_angle, 6, None),
    "torsion": (_torsion, 6, None), "external_periodic": (_external, 4, None),
    "external_triclinic": (_external, 4, TRICLINIC),
    "nonbonded_nocutoff": (_nonbonded(0, False), 12, None),
    "nonbonded_cutoff_switch": (_nonbonded(1, True), 12, None),
    "nonbonded_periodic_switch": (_nonbonded(2, True), 12,
                                  ((2.0, 0, 0), (0, 2.0, 0), (0, 0, 2.0))),
    "nonbonded_triclinic": (_nonbonded(2, False), 12, TRICLINIC),
}


@pytest.mark.parametrize("name", sorted(FORCES))
def test_custom_force_energy_and_forces_equal_jax(name):
    build, n, box = FORCES[name]
    rng = np.random.default_rng(len(name))
    if n == 12:
        # a jittered lattice: no two particles closer than ~0.3 nm
        grid = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"),
                        -1).reshape(-1, 3)[:12] * 0.6 + 0.2
        pos = grid + rng.normal(0, 0.03, grid.shape)
    else:
        pos = rng.uniform(0.2, 1.4, (n, 3))
    kw = {} if box is None else {"box": box}
    _held(*_pair(build, n, **kw), pos)


def test_custom_nonbonded_blocking_and_count():
    s = _system(dt, 7)
    f = tcustom.CustomNonbondedForce("q1*q2/r")
    f.addPerParticleParameter("q")
    for i in range(7):
        f.addParticle([(-1.0) ** i])
    pos = torch.tensor(np.random.default_rng(5).uniform(0, 1, (7, 3)))
    vals = [float(f.compile(s, torch.float64, "cpu", block_rows=b)
                  .energy_forces(pos)[0]) for b in (1, 3, 7, 256)]
    np.testing.assert_allclose(vals, vals[0], rtol=1e-12)
    g = tcustom.CustomNonbondedForce("1/r")
    g.addParticle([])
    with pytest.raises(ValueError):
        g.compile(_system(dt, 3), torch.float64, "cpu")


def _param_system(pkg):
    s = pkg.System()
    for m in (16.0, 16.0, 0.4):
        s.addParticle(m)
    drude = pkg.DrudeForce()
    drude.addParticle(2, 0, -1, -1, -1, 0.3, 0.001, 1, 1)
    s.addForce(drude)
    cb = pkg.CustomBondForce("scale*0.5*kb*(r-r0)^2")
    cb.addPerBondParameter("r0")
    cb.addPerBondParameter("kb")
    cb.addGlobalParameter("scale", 1.0)
    cb.addBond(0, 1, [0.1, 1000.0])
    s.addForce(cb)
    return s


def test_set_parameter_scan_equals_jax():
    pos = np.array([[0.0, 0, 0], [0.25, 0, 0], [0.001, 0, 0]])
    ctxs = []
    for pkg, kw in ((dn, {}), (dt, {"device": "cpu"})):
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.0005, 1, 1)
        ctx = pkg.Context(_param_system(pkg), integ, precision="double",
                          strategy="dense", **kw)
        ctx.setPositions(pos)
        ctxs.append(ctx)
    for value in (1.0, 0.25, 0.6, 0.0):
        es = []
        for ctx in ctxs:
            ctx.setParameter("scale", value)
            st = ctx.getState(energy=True, forces=True)
            es.append((st.getPotentialEnergy(), np.asarray(st.getForces())))
            assert ctx.getParameter("scale") == value
            assert ctx.getParameters() == {"scale": value}
        assert es[1][0] == pytest.approx(es[0][0], rel=1e-10, abs=1e-12)
        np.testing.assert_allclose(es[1][1], es[0][1], rtol=1e-8, atol=1e-9)
    for ctx in ctxs:
        with pytest.raises(ValueError, match="no force declares"):
            ctx.setParameter("nope", 1.0)
        with pytest.raises(ValueError, match="no force declares"):
            ctx.getParameter("nope")


def test_jax_set_parameter_writes_the_system_default():
    """ROADMAP.md C19: the JAX Context.setParameter writes the value into
    the force's default (app/context.py:906-925 there), so a second
    Context of the same System starts at it.  OpenMM's Context keeps it
    in the Context; so does the port."""
    out = {}
    for pkg, kw in ((dn, {}), (dt, {"device": "cpu"})):
        s = _param_system(pkg)
        make = lambda: pkg.Context(
            s, pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.0005, 1, 1),
            precision="double", strategy="dense", **kw)
        first = make()
        first.setParameter("scale", 0.25)
        out[pkg.__name__] = (make().getParameter("scale"),
                             s.getForces()[1].getGlobalParameterDefaultValue(0))
    assert out["openmm_drudenose_tpu"] == (0.25, 0.25)
    assert out["openmm_drudenose_tpu_torch"] == (1.0, 1.0)


def test_parameter_survives_reinitialize():
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.0005, 1, 1)
    ctx = dt.Context(_param_system(dt), integ, precision="double",
                     strategy="dense", device="cpu")
    ctx.setPositions(np.array([[0.0, 0, 0], [0.25, 0, 0], [0.001, 0, 0]]))
    ctx.setParameter("scale", 0.5)
    e = ctx.getState(energy=True).getPotentialEnergy()
    ctx.reinitialize(preserveState=True)
    assert ctx.getParameter("scale") == 0.5
    assert ctx.getState(energy=True).getPotentialEnergy() == \
        pytest.approx(e, rel=1e-14)
    ctx.reinitialize(preserveState=False)
    assert ctx.getParameter("scale") == 1.0


def _dynamics_system(pkg):
    """The JAX package's custom-force dynamics system
    (tests/test_custom_forces.py:219)."""
    s = pkg.System()
    for _ in range(4):
        s.addParticle(12.0)
    s.addParticle(0.4)
    drude = pkg.DrudeForce()
    drude.addParticle(4, 0, -1, -1, -1, 0.3, 0.001, 1, 1)
    s.addForce(drude)
    s.setDefaultPeriodicBoxVectors([3.0, 0, 0], [0, 3.0, 0], [0, 0, 3.0])
    cb = pkg.CustomBondForce("0.5*kb*(r-r0)^2")
    cb.addPerBondParameter("r0")
    cb.addPerBondParameter("kb")
    for (i, j) in ((0, 1), (1, 2), (2, 3)):
        cb.addBond(i, j, [0.15, 50000.0])
    ct = pkg.CustomTorsionForce("kt*(1+cos(theta))")
    ct.addPerTorsionParameter("kt")
    ct.addTorsion(0, 1, 2, 3, [20.0])
    s.addForce(cb)
    s.addForce(ct)
    return s


DYN_POS = np.array([[0.0, 0, 0], [0.15, 0, 0], [0.15, 0.15, 0],
                    [0.3, 0.15, 0.05], [0.001, 0.001, 0.0]])


def test_custom_dynamics_steps_equal_jax():
    rng = np.random.default_rng(1)
    vel = rng.normal(0, 0.5, DYN_POS.shape)
    out = []
    for pkg, kw in ((dn, {}), (dt, {"device": "cpu"})):
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.0005, 1, 1)
        ctx = pkg.Context(_dynamics_system(pkg), integ, precision="double",
                          strategy="dense", **kw)
        ctx.setPositions(DYN_POS)
        ctx.setVelocities(vel)
        integ.step(20)
        st = ctx.getState(positions=True, velocities=True, energy=True)
        out.append((np.asarray(st.getPositions()),
                    np.asarray(st.getVelocities()),
                    st.getPotentialEnergy()))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=0, atol=1e-10)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=0, atol=1e-9)
    assert out[1][2] == pytest.approx(out[0][2], rel=1e-9)


def test_custom_forces_in_flat_ensemble():
    """Custom bonded and external forces replicate with index offsets
    (the JAX package's _replicate_force, tests/test_custom_forces.py:
    471); a CustomNonbondedForce is refused as there."""
    from openmm_drudenose_tpu.parallel.flatrep import \
        _replicate_force as jrep
    from openmm_drudenose_tpu_torch.parallel.flatrep import \
        _replicate_force as trep
    import xml.etree.ElementTree as ET
    from openmm_drudenose_tpu.app.serialization import \
        _force_to_xml as jxml
    from openmm_drudenose_tpu_torch.app.serialization import \
        _force_to_xml as txml
    for build in (_bond, _angle, _torsion, _external):
        gj = jrep(build(jcustom), R=3, n0=6)
        gt = trep(build(tcustom), R=3, n0=6)
        assert gt._terms == gj._terms and gt._globals == gj._globals
        assert ET.tostring(txml(gt)) == ET.tostring(jxml(gj))
    with pytest.raises(ValueError, match="CustomNonbondedForce"):
        trep(_nonbonded(0, False)(tcustom), R=2, n0=12)
    with pytest.raises(ValueError, match="CustomNonbondedForce"):
        jrep(_nonbonded(0, False)(jcustom), R=2, n0=12)


def test_restraint_beside_flat_npt_is_refused():
    """A CustomExternalForce has no per-replica mc_energies hook: beside
    a barostat in a flat ensemble it stays refused (ROADMAP.md C6);
    custom bonded terms are intramolecular and pass."""
    from openmm_drudenose_tpu_torch.integrators import barostat
    s = _dynamics_system(dt)
    s.addForce(dt.MonteCarloBarostat(1.0, 300.0))
    barostat.check_ensemble_forces(s)
    s.addForce(_external(tcustom))
    with pytest.raises(ValueError, match="CustomExternalForce"):
        barostat.check_ensemble_forces(s)
