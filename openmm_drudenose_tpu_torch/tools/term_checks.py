"""Small systems of the terms that run in plain PyTorch (no hand kernel:
the JAX package computes them outside Pallas too): CMAP, out-of-plane
and local-coordinates sites, anisotropic Drude springs, each
Custom*Force, a setParameter scan and a System read back from its XML.
Each system has a Drude pair, so that a Context binds it.

    from openmm_drudenose_tpu_torch.tools import term_checks
    worst = term_checks.compare_devices("cuda")   # card f64 against CPU

`compare_devices` evaluates every system in float64 on `device` and on
the CPU and returns, per system, the relative energy difference and
max|dF| / max|F|; `custom_dynamics` steps the custom-force system of the
JAX package's tests/test_custom_forces.py:219 in the given precision.
"""

from __future__ import annotations

import numpy as np

import openmm_drudenose_tpu_torch as dt


def _base(n_heavy, masses=None):
    """A System of n_heavy massive particles and one Drude pair (a
    particle of mass 10 and its 0.4 Da Drude, appended)."""
    s = dt.System()
    for m in (masses or [14.0] * n_heavy):
        s.addParticle(m)
    core = s.addParticle(10.0)
    shell = s.addParticle(0.4)
    drude = dt.DrudeForce()
    drude.addParticle(shell, core, -1, -1, -1, -0.8, 0.0015, 1, 1)
    s.addForce(drude)
    s.setDefaultPeriodicBoxVectors((4.0, 0, 0), (0, 4.0, 0), (0, 0, 4.0))
    return s


def _walk(n, seed, step=0.15):
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3))
    for i in range(1, n):
        d = rng.normal(size=3)
        pos[i] = pos[i - 1] + step * d / np.linalg.norm(d)
    return pos + 1.0


def _with_pair(pos):
    """Positions of the base system's Drude pair appended, the shell on
    its core (no spring force to crowd out the term's)."""
    return np.vstack([pos, [[3.0, 3.0, 3.0], [3.0, 3.0, 3.0]]])


def surface_map(n):
    """cos(phi) + sin(psi) + 0.3 cos(phi + psi) on an n x n grid, angle1
    fastest (the JAX package's tests/test_cmap.py surface)."""
    a = -np.pi + np.arange(n) * 2.0 * np.pi / n
    e = (np.cos(a[:, None]) + np.sin(a[None, :])
         + 0.3 * np.cos(a[:, None] + a[None, :]))
    return e.reshape(-1, order="F")


def cmap_system():
    s = _base(6)
    f = dt.CMAPTorsionForce()
    f.addMap(8, surface_map(8))
    f.addMap(24, 2.0 * surface_map(24))
    f.addTorsion(0, 0, 1, 2, 3, 1, 2, 3, 4)
    f.addTorsion(1, 1, 2, 3, 4, 2, 3, 4, 5)
    s.addForce(f)
    return s, _with_pair(_walk(6, 1))


def sites_system():
    """Three molecules of four parents with average, out-of-plane and
    local-coordinates sites carrying charge, in a NoCutoff
    NonbondedForce."""
    s = dt.System()
    nb = dt.NonbondedForce()
    drude = dt.DrudeForce()
    rng = np.random.default_rng(3)
    pos = []
    for m in range(3):
        o = 10 * m
        for mass in (16.0, 12.0, 14.0, 1.0, 0.4, 0, 0, 0, 0, 0):
            s.addParticle(mass)
        s.setVirtualSite(o + 5, dt.TwoParticleAverageSite(o, o + 1, 0.3,
                                                          0.7))
        s.setVirtualSite(o + 6, dt.ThreeParticleAverageSite(
            o, o + 1, o + 2, 0.5, 0.25, 0.25))
        s.setVirtualSite(o + 7, dt.OutOfPlaneSite(o, o + 1, o + 2, 0.2,
                                                  -0.3, 4.0))
        s.setVirtualSite(o + 8, dt.LocalCoordinatesSite(
            (o, o + 1, o + 2), (0.4, 0.3, 0.3), (-1.0, 1.0, 0.0),
            (-1.0, 0.0, 1.0), (0.03, -0.01, 0.02)))
        s.setVirtualSite(o + 9, dt.LocalCoordinatesSite(
            (o, o + 1, o + 2, o + 3), (0.25,) * 4, (-1.0, 1.0, 0.0, 0.0),
            (-1.0, 0.0, 0.0, 1.0), (-0.02, 0.04, 0.01)))
        q = rng.normal(0, 0.4, 10)
        q[4] = -0.8
        for i in range(10):
            nb.addParticle(float(q[i]), 0.3, 0.2 if i < 4 else 0.0)
            for j in range(i):
                nb.addException(o + i, o + j, 0.0, 1.0, 0.0)
        drude.addParticle(o + 4, o, -1, -1, -1, -0.8, 0.0015, 1, 1)
        parents = np.array([0.9 * m, 0.2 * m, 0.1]) + rng.normal(
            0, 0.12, (4, 3))
        pos.append(np.vstack([parents, parents[:1],
                              np.repeat(parents[:1], 5, axis=0)]))
    s.addForce(nb)
    s.addForce(drude)
    return s, np.vstack(pos)


def aniso_system():
    """Drudes with two axes, one axis and none in one DrudeForce."""
    s = dt.System()
    for m in (16.0, 0.4, 1.0, 1.0, 12.0, 14.0, 0.4, 1.0, 15.0, 0.4):
        s.addParticle(m)
    drude = dt.DrudeForce()
    drude.addParticle(1, 0, 2, 3, 4, 0.5, 0.0015, 0.8, 1.2)
    drude.addParticle(6, 5, 7, -1, -1, -0.7, 0.002, 1.3, 1.0)
    drude.addParticle(9, 8, -1, 5, 7, 0.4, 0.001, 1.0, 0.7)
    s.addForce(drude)
    rng = np.random.default_rng(3)
    pos = rng.normal(0, 0.2, (10, 3)) + 1.0
    for d, p in ((1, 0), (6, 5), (9, 8)):
        pos[d] = pos[p] + rng.normal(0, 0.01, 3)
    return s, pos


def custom_bonded_system():
    s = _base(6)
    cb = dt.CustomBondForce("scale*D*(1-exp(-aa*(r-r0)))^2")
    for name in ("D", "aa", "r0"):
        cb.addPerBondParameter(name)
    cb.addGlobalParameter("scale", 0.7)
    for i in range(5):
        cb.addBond(i, i + 1, [300.0 + i, 20.0, 0.15])
    ca = dt.CustomAngleForce("0.5*kq*(theta-th0)^2")
    ca.addPerAngleParameter("kq")
    ca.addPerAngleParameter("th0")
    for i in range(4):
        ca.addAngle(i, i + 1, i + 2, [90.0, 1.9])
    ct = dt.CustomTorsionForce("kt*(1+cos(np*theta-ph))")
    for name in ("kt", "np", "ph"):
        ct.addPerTorsionParameter(name)
    for i in range(3):
        ct.addTorsion(i, i + 1, i + 2, i + 3, [5.0, 2.0 + i, 0.5])
    ce = dt.CustomExternalForce(
        "lam*0.5*kk*periodicdistance(x, y, z, x0, y0, z0)^2")
    for name in ("kk", "x0", "y0", "z0"):
        ce.addPerParticleParameter(name)
    ce.addGlobalParameter("lam", 0.75)
    ce.addParticle(0, [200.0, 3.9, 0.1, 2.0])
    ce.addParticle(3, [120.0, 3.8, 3.9, 3.7])
    for f in (cb, ca, ct, ce):
        s.addForce(f)
    return s, _with_pair(_walk(6, 2))


def custom_nonbonded_system(triclinic=False):
    """A periodic, switched CustomNonbondedForce over 27 particles (the
    Drude pair excluded from the rest)."""
    n = 27
    s = _base(n)
    if triclinic:
        s.setDefaultPeriodicBoxVectors((2.0, 0, 0), (0.5, 2.0, 0),
                                       (0.3, 0.4, 2.0))
    else:
        s.setDefaultPeriodicBoxVectors((2.0, 0, 0), (0, 2.0, 0),
                                       (0, 0, 2.0))
    f = dt.CustomNonbondedForce(
        "4*eps*(s6^2-s6) + q1*q2/r; s6=(sig/r)^6; "
        "sig=0.5*(sigma1+sigma2); eps=sqrt(epsilon1*epsilon2)")
    for name in ("sigma", "epsilon", "q"):
        f.addPerParticleParameter(name)
    rng = np.random.default_rng(9)
    for i in range(n + 2):
        f.addParticle([0.3 + 0.02 * rng.random(), 0.5 + rng.random(),
                       (-1.0) ** i * 0.2 if i < n else 0.0])
    for i in range(n):
        f.addExclusion(i, n)
        f.addExclusion(i, n + 1)
    f.addExclusion(n, n + 1)
    f.setNonbondedMethod(f.CutoffPeriodic)
    f.setCutoffDistance(0.9)
    f.setUseSwitchingFunction(True)
    f.setSwitchingDistance(0.7)
    s.addForce(f)
    grid = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"),
                    -1).reshape(-1, 3) * 0.62 + 0.2
    pos = grid + rng.normal(0, 0.03, grid.shape)
    return s, np.vstack([pos, [[1.0, 1.3, 1.1], [1.0, 1.3, 1.1]]])


def xml_system():
    """The custom-bonded system with the CMAP force added, read back from
    its XML."""
    s, pos = custom_bonded_system()
    cmap = next(f for f in cmap_system()[0].getForces()
                if isinstance(f, dt.CMAPTorsionForce))
    s.addForce(cmap)
    return dt.deserialize_system(dt.serialize_system(s)), pos


SYSTEMS = {
    "cmap": cmap_system, "sites": sites_system, "aniso": aniso_system,
    "custom_bonded": custom_bonded_system,
    "custom_nonbonded": custom_nonbonded_system,
    "custom_nonbonded_triclinic": lambda: custom_nonbonded_system(True),
    "xml_round_trip": xml_system,
}


def _integrator(dt_ps=0.0005):
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, dt_ps, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    return integ


def energy_forces(system, positions, device):
    """(energy, forces) of `system` in a float64 Context on `device`."""
    ctx = dt.Context(system, _integrator(), precision="double",
                     strategy="dense", device=device)
    ctx.setPositions(positions)
    st = ctx.getState(energy=True, forces=True)
    return st.getPotentialEnergy(), np.asarray(st.getForces())


def parameter_scan(device, values=(1.0, 0.25, 0.6, 0.0)):
    """(energy, forces) of custom_bonded_system at each value of its
    global `scale`, set by Context.setParameter in one Context."""
    system, pos = custom_bonded_system()
    ctx = dt.Context(system, _integrator(), precision="double",
                     strategy="dense", device=device)
    ctx.setPositions(pos)
    out = []
    for v in values:
        ctx.setParameter("scale", v)
        if ctx.getParameter("scale") != v:
            raise RuntimeError("setParameter did not take the value")
        st = ctx.getState(energy=True, forces=True)
        out.append((st.getPotentialEnergy(), np.asarray(st.getForces())))
    return out


def _held(a, b):
    (e_a, f_a), (e_b, f_b) = a, b
    return (abs(e_a - e_b) / max(abs(e_b), 1e-300),
            float(np.max(np.abs(f_a - f_b)) / np.max(np.abs(f_b))))


def compare_devices(device):
    """{name: (|dE| / |E|, max|dF| / max|F|)} of every system, and of
    each value of the parameter scan, in float64 on `device` against the
    CPU."""
    out = {}
    for name, make in SYSTEMS.items():
        system, pos = make()
        out[name] = _held(energy_forces(system, pos, device),
                          energy_forces(system, pos, "cpu"))
    for k, (a, b) in enumerate(zip(parameter_scan(device),
                                   parameter_scan("cpu"))):
        out[f"set_parameter_{k}"] = _held(a, b)
    return out


def custom_dynamics(device, n_steps=200, precision="single"):
    """The custom-force dynamics system (a CustomBondForce chain and a
    CustomTorsionForce with a Drude pair) stepped n_steps; returns the
    (positions, potential energy) at the end."""
    s = dt.System()
    for _ in range(4):
        s.addParticle(12.0)
    s.addParticle(0.4)
    drude = dt.DrudeForce()
    drude.addParticle(4, 0, -1, -1, -1, 0.3, 0.001, 1, 1)
    s.addForce(drude)
    s.setDefaultPeriodicBoxVectors((3.0, 0, 0), (0, 3.0, 0), (0, 0, 3.0))
    cb = dt.CustomBondForce("0.5*kb*(r-r0)^2")
    cb.addPerBondParameter("r0")
    cb.addPerBondParameter("kb")
    for i, j in ((0, 1), (1, 2), (2, 3)):
        cb.addBond(i, j, [0.15, 50000.0])
    ct = dt.CustomTorsionForce("kt*(1+cos(theta))")
    ct.addPerTorsionParameter("kt")
    ct.addTorsion(0, 1, 2, 3, [20.0])
    s.addForce(cb)
    s.addForce(ct)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.0005, 1, 1)
    ctx = dt.Context(s, integ, precision=precision, strategy="dense",
                     device=device)
    ctx.setPositions(np.array([[0.0, 0, 0], [0.15, 0, 0], [0.15, 0.15, 0],
                               [0.3, 0.15, 0.05], [0.001, 0.001, 0.0]]))
    ctx.setVelocitiesToTemperature(300.0, seed=1)
    integ.step(n_steps)
    st = ctx.getState(positions=True, energy=True)
    return np.asarray(st.getPositions()), st.getPotentialEnergy()
