"""The System XML half of the port's app/serialization.py against the
JAX package's: for a System with every force and site the port has, the
two packages write the same text, each reads the other's, and a round
trip gives the same System (and the same energy in a Context); the
integrator document carries every field, temperature groups included."""

import numpy as np
import pytest

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
import test_cmap as jcmap
from openmm_drudenose_tpu.app import serialization as jser
from openmm_drudenose_tpu_torch.app import serialization as tser
from torch_threads import _one_thread  # noqa: F401


def _sink(pkg, triclinic=False):
    """Every force and site kind on 16 particles (two 8-atom molecules)."""
    s = pkg.System()
    for m in range(2):
        for mass in (16.0, 0.4, 1.0, 1.0, 12.0, 0.0, 0.0, 0.0):
            s.addParticle(mass)
    nb = pkg.NonbondedForce()
    nb.setNonbondedMethod(pkg.NonbondedForce.PME)
    nb.setCutoffDistance(0.9)
    nb.setPMEParameters(3.1, 24, 24, 24)
    drude = pkg.DrudeForce()
    hb, ha = pkg.HarmonicBondForce(), pkg.HarmonicAngleForce()
    pt, ht = pkg.PeriodicTorsionForce(), pkg.HarmonicTorsionForce()
    cmap = pkg.CMAPTorsionForce()
    cmap.addMap(8, jcmap._surface_map(8))
    cb = pkg.CustomBondForce("0.5*kb*(r-r0)^2*lam")
    cb.addPerBondParameter("kb")
    cb.addPerBondParameter("r0")
    cb.addGlobalParameter("lam", 0.5)
    ca = pkg.CustomAngleForce("k*(theta-t0)^2")
    ca.addPerAngleParameter("k")
    ca.addPerAngleParameter("t0")
    ct = pkg.CustomTorsionForce("k*(1+cos(2*theta))")
    ct.addPerTorsionParameter("k")
    ce = pkg.CustomExternalForce(
        "0.5*kk*periodicdistance(x, y, z, x0, y0, z0)^2")
    for name in ("kk", "x0", "y0", "z0"):
        ce.addPerParticleParameter(name)
    cn = pkg.CustomNonbondedForce("c1*c2/r^6")
    cn.addPerParticleParameter("c")
    cn.setNonbondedMethod(2)
    cn.setCutoffDistance(0.8)
    cn.setUseSwitchingFunction(True)
    cn.setSwitchingDistance(0.7)
    for m in range(2):
        o = 8 * m
        s.addConstraint(o, o + 2, 0.1)
        s.addConstraint(o + 2, o + 3, 0.15)
        s.setVirtualSite(o + 5, pkg.ThreeParticleAverageSite(
            o, o + 2, o + 3, 0.6, 0.2, 0.2) if m == 0 else
            pkg.TwoParticleAverageSite(o, o + 2, 0.7, 0.3))
        s.setVirtualSite(o + 6, pkg.OutOfPlaneSite(o, o + 2, o + 3, 0.1,
                                                   0.2, 3.0))
        s.setVirtualSite(o + 7, pkg.LocalCoordinatesSite(
            (o, o + 2, o + 4), (0.5, 0.25, 0.25), (-1.0, 1.0, 0.0),
            (-1.0, 0.0, 1.0), (0.01, 0.02, -0.03)))
        for i, q in enumerate((1.2, -1.0, 0.3, 0.3, -0.4, -0.2, 0.1,
                               -0.3)):
            nb.addParticle(q, 0.3, 0.2 if i in (0, 4) else 0.0)
            cn.addParticle([0.01 * (i + 1)])
        for i in range(8):
            for j in range(i):
                nb.addException(o + i, o + j, 0.0, 1.0, 0.0)
                cn.addExclusion(o + i, o + j)
        drude.addParticle(o + 1, o, o + 2, o + 3, o + 4, -1.0, 0.0015, 0.8,
                          1.2)
        hb.addBond(o, o + 4, 0.14, 2e5)
        ha.addAngle(o + 2, o, o + 4, 1.9, 300.0)
        pt.addTorsion(o + 2, o, o + 4, o + 3, 3, 0.1, 2.0)
        ht.addTorsion(o, o + 2, o + 3, o + 4, 0.2, 40.0)
        cmap.addTorsion(0, o + 2, o, o + 4, o + 3, o, o + 4, o + 3, o + 2)
        cb.addBond(o, o + 3, [1000.0, 0.17])
        ca.addAngle(o + 3, o, o + 4, [50.0, 1.7])
        ct.addTorsion(o + 3, o, o + 4, o + 2, [3.0])
        ce.addParticle(o + 4, [100.0, 0.5 + m, 0.6, 0.7])
    drude.addScreenedPair(0, 1, 2.6)
    drude.addNBTholePair(0, 1, 1.3)
    nb.addLJPairOverride([0], [8], 0.31, 0.25)
    for f in (nb, drude, hb, ha, pt, ht, cmap, cb, ca, ct, ce, cn,
              pkg.CMMotionRemover(5),
              pkg.MonteCarloBarostat(1.0, 300.0, 25)):
        s.addForce(f)
    if triclinic:
        s.setDefaultPeriodicBoxVectors((3.0, 0, 0), (0.6, 3.0, 0),
                                       (0.4, 0.5, 3.0))
    else:
        s.setDefaultPeriodicBoxVectors((3.0, 0, 0), (0, 3.1, 0),
                                       (0, 0, 3.2))
    return s


@pytest.mark.parametrize("triclinic", [False, True],
                         ids=["orthorhombic", "triclinic"])
def test_system_xml_equals_jax_and_round_trips(triclinic):
    xj = jser.serialize_system(_sink(dn, triclinic))
    xt = tser.serialize_system(_sink(dt, triclinic))
    assert xt == xj
    back = tser.deserialize_system(xt)
    assert tser.serialize_system(back) == xt
    # each package reads the other's document
    assert tser.serialize_system(tser.deserialize_system(xj)) == xj
    assert jser.serialize_system(jser.deserialize_system(xt)) == xt
    assert dt.XmlSerializer.serialize(back) == xt
    assert isinstance(dt.XmlSerializer.deserialize(xt), dt.System)
    kinds = {type(back.getVirtualSite(i)).__name__
             for i in range(back.getNumParticles())
             if back.isVirtualSite(i)}
    assert kinds == {"TwoParticleAverageSite", "ThreeParticleAverageSite",
                     "OutOfPlaneSite", "LocalCoordinatesSite"}


def test_integrator_xml_equals_jax():
    out = []
    for pkg in (dn, dt):
        integ = pkg.DrudeTGNHIntegrator(310.0, 0.2, 1.5, 0.05, 0.0007, 12,
                                        3, True, False)
        integ.setMaxDrudeDistance(0.025)
        integ.setConstraintTolerance(2e-6)
        integ.addTempGroup()
        integ.addTempGroup()
        for g in (0, 1, 1, 0):
            integ.addParticleTempGroup(g)
        out.append(pkg.XmlSerializer.serialize(integ))
    assert out[1] == out[0]
    back = dt.XmlSerializer.deserialize(out[1])
    assert isinstance(back, dt.DrudeTGNHIntegrator)
    assert dt.serialize_integrator(back) == out[1]
    assert back.getNumTempGroups() == 2
    assert back._particle_temp_group == [0, 1, 1, 0]
    with pytest.raises(ValueError, match="unknown document"):
        dt.XmlSerializer.deserialize("<Nothing/>")


def test_context_from_xml_gives_the_same_energy(tmp_path):
    """A System with the sites, the custom and CMAP forces and the
    anisotropic springs, written, read back and bound in a float64
    Context: the same energy and forces as the original."""
    s = _sink(dt)
    s.removeForce(s.getNumForces() - 1)          # no barostat needed
    path = tmp_path / "system.xml"
    path.write_text(dt.XmlSerializer.serialize(s))
    s2 = dt.XmlSerializer.deserialize(path.read_text())
    rng = np.random.default_rng(0)
    pos = np.vstack([rng.normal(0, 0.12, (8, 3)) + [0.5, 0.5, 0.5],
                     rng.normal(0, 0.12, (8, 3)) + [1.8, 1.6, 1.5]])
    pos[1] = pos[0] + 0.005
    pos[9] = pos[8] + 0.005
    out = []
    for system in (s, s2):
        integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        ctx = dt.Context(system, integ, precision="double", device="cpu")
        ctx.setPositions(pos)
        st = ctx.getState(energy=True, forces=True)
        out.append((st.getPotentialEnergy(), st.getForces()))
    assert np.isfinite(out[0][0])
    assert out[1][0] == out[0][0]
    np.testing.assert_array_equal(out[1][1], out[0][1])
