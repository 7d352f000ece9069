"""System and integrator XML, and checkpoints.

The XML half (the JAX package's app/serialization.py:38-526):
serialize_system / deserialize_system write and read every particle,
constraint, virtual site and force of a System (the NBFIX and NBTHOLE
tables, the custom forces' expressions and parameters, the CMAP maps),
serialize_integrator / deserialize_integrator every field of a
DrudeTGNHIntegrator, the temperature groups and particle assignments
included (the reference plugin's proxy drops those), and XmlSerializer
dispatches on the object or the document.  The documents are the JAX
package's, attribute for attribute: a System serialized by either
package reads back in the other, and the same System gives the same
text.  They do not interchange with OpenMM's own XML.

The checkpoint half: the whole dynamic state of a Context in one .npz
file (save_checkpoint / load_checkpoint).
"""

from __future__ import annotations

import json
import xml.etree.ElementTree as ET

import numpy as np
import torch

from ..forces.cellpair import CellSort
from .integrator import DrudeTGNHIntegrator

_VERSION = 1


def serialize_integrator(integ: DrudeTGNHIntegrator) -> str:
    root = ET.Element("DrudeTGNHIntegrator", {
        "version": str(_VERSION),
        # the reference proxy's 9 fields
        "stepSize": repr(integ.getStepSize()),
        "constraintTolerance": repr(integ.getConstraintTolerance()),
        "temperature": repr(integ.getTemperature()),
        "couplingTime": repr(integ.getCouplingTime()),
        "drudeTemperature": repr(integ.getDrudeTemperature()),
        "drudeCouplingTime": repr(integ.getDrudeCouplingTime()),
        "drudeStepsPerRealStep": str(integ.getDrudeStepsPerRealStep()),
        "numNHChains": str(integ.getNumNHChains()),
        "useDrudeNHChains": str(int(integ.getUseDrudeNHChains())),
        # the fields the reference forgot
        "maxDrudeDistance": repr(integ.getMaxDrudeDistance()),
        "useCOMTempGroup": str(int(integ.getUseCOMTempGroup())),
        "numTempGroups": str(integ.getNumTempGroups()),
    })
    if integ._particle_temp_group:
        groups = ET.SubElement(root, "ParticleTempGroups")
        groups.text = " ".join(str(g) for g in integ._particle_temp_group)
    return ET.tostring(root, encoding="unicode")


def deserialize_integrator(xml: str) -> DrudeTGNHIntegrator:
    root = ET.fromstring(xml)
    if root.tag != "DrudeTGNHIntegrator":
        raise ValueError(f"not a DrudeTGNHIntegrator document: {root.tag}")
    a = root.attrib
    integ = DrudeTGNHIntegrator(
        float(a["temperature"]), float(a["couplingTime"]),
        float(a["drudeTemperature"]), float(a["drudeCouplingTime"]),
        float(a["stepSize"]), int(a["drudeStepsPerRealStep"]),
        int(a["numNHChains"]), bool(int(a["useDrudeNHChains"])),
        bool(int(a.get("useCOMTempGroup", "1"))))
    integ.setConstraintTolerance(float(a["constraintTolerance"]))
    integ.setMaxDrudeDistance(float(a.get("maxDrudeDistance", "0")))
    for _ in range(int(a.get("numTempGroups", "0"))):
        integ.addTempGroup()
    groups = root.find("ParticleTempGroups")
    if groups is not None and groups.text:
        for g in groups.text.split():
            integ.addParticleTempGroup(int(g))
    return integ


# -- System ------------------------------------------------------------------

def _vsite_to_xml(index: int, vs) -> ET.Element:
    from ..system import (LocalCoordinatesSite, OutOfPlaneSite,
                          ThreeParticleAverageSite, TwoParticleAverageSite)
    e = ET.Element("VirtualSite", {"index": str(index)})
    if isinstance(vs, TwoParticleAverageSite):
        e.set("type", "average2")
    elif isinstance(vs, ThreeParticleAverageSite):
        e.set("type", "average3")
    elif isinstance(vs, OutOfPlaneSite):
        e.set("type", "outOfPlane")
    elif isinstance(vs, LocalCoordinatesSite):
        e.set("type", "localCoords")
        e.set("particles", " ".join(map(str, vs.particles)))
        e.set("originWeights", " ".join(map(repr, vs.origin_weights)))
        e.set("xWeights", " ".join(map(repr, vs.x_weights)))
        e.set("yWeights", " ".join(map(repr, vs.y_weights)))
        e.set("localPosition", " ".join(map(repr, vs.local_position)))
        return e
    else:
        raise ValueError(f"unsupported virtual site {type(vs).__name__}")
    e.set("particles", " ".join(map(str, vs.particles)))
    e.set("weights", " ".join(map(repr, vs.weights)))
    return e


def _vsite_from_xml(e: ET.Element):
    from ..system import (LocalCoordinatesSite, OutOfPlaneSite,
                          ThreeParticleAverageSite, TwoParticleAverageSite)
    kind = e.get("type")
    particles = [int(x) for x in e.get("particles").split()]
    if kind == "localCoords":
        return LocalCoordinatesSite(
            particles,
            [float(x) for x in e.get("originWeights").split()],
            [float(x) for x in e.get("xWeights").split()],
            [float(x) for x in e.get("yWeights").split()],
            [float(x) for x in e.get("localPosition").split()])
    weights = [float(x) for x in e.get("weights").split()]
    cls = {"average2": TwoParticleAverageSite,
           "average3": ThreeParticleAverageSite,
           "outOfPlane": OutOfPlaneSite}[kind]
    return cls(*particles, *weights)


def _force_to_xml(f) -> ET.Element:
    from ..forces.bonded import (HarmonicAngleForce, HarmonicBondForce,
                                 PeriodicTorsionForce)
    from ..forces.cmmotion import CMMotionRemover, MonteCarloBarostat
    from ..forces.drude import DrudeForce
    from ..forces.nonbonded import NonbondedForce

    if isinstance(f, NonbondedForce):
        e = ET.Element("Force", {
            "type": "NonbondedForce",
            "method": str(f.getNonbondedMethod()),
            "cutoff": repr(f.getCutoffDistance()),
            "useSwitchingFunction": str(int(f.getUseSwitchingFunction())),
            "switchingDistance": repr(f.getSwitchingDistance()),
            "ewaldTolerance": repr(f.getEwaldErrorTolerance()),
            "rfDielectric": repr(f.getReactionFieldDielectric()),
            "dispersionCorrection":
                str(int(f.getUseDispersionCorrection())),
            "alpha": repr(f._pme_params[0]),
            "nx": str(f._pme_params[1]), "ny": str(f._pme_params[2]),
            "nz": str(f._pme_params[3]),
        })
        ps = ET.SubElement(e, "Particles")
        for q, sig, eps in f._particles:
            ET.SubElement(ps, "Particle", {"q": repr(q), "sig": repr(sig),
                                           "eps": repr(eps)})
        ex = ET.SubElement(e, "Exceptions")
        for p1, p2, qq, sig, eps in f._exceptions:
            ET.SubElement(ex, "Exception", {
                "p1": str(p1), "p2": str(p2), "q": repr(qq),
                "sig": repr(sig), "eps": repr(eps)})
        if f._lj_overrides:
            ov = ET.SubElement(e, "LJPairOverrides")
            for set1, set2, sig, eps in f._lj_overrides:
                ET.SubElement(ov, "Override", {
                    "particles1": " ".join(map(str, set1)),
                    "particles2": " ".join(map(str, set2)),
                    "sig": repr(sig), "eps": repr(eps)})
        return e

    if isinstance(f, DrudeForce):
        e = ET.Element("Force", {"type": "DrudeForce"})
        ps = ET.SubElement(e, "Particles")
        for p in f._particles:
            ET.SubElement(ps, "Particle", {
                "p": str(p[0]), "p1": str(p[1]), "p2": str(p[2]),
                "p3": str(p[3]), "p4": str(p[4]), "q": repr(p[5]),
                "alpha": repr(p[6]), "aniso12": repr(p[7]),
                "aniso34": repr(p[8])})
        sp = ET.SubElement(e, "ScreenedPairs")
        for a, b, thole in f._screened_pairs:
            ET.SubElement(sp, "Pair", {"p1": str(a), "p2": str(b),
                                       "thole": repr(thole)})
        if f._nbthole:
            nb = ET.SubElement(e, "NBTholePairs")
            for a, b, thole in f._nbthole:
                ET.SubElement(nb, "Pair", {"p1": str(a), "p2": str(b),
                                           "thole": repr(thole)})
        return e

    if isinstance(f, HarmonicBondForce):
        e = ET.Element("Force", {"type": "HarmonicBondForce"})
        for p1, p2, length, k in f._bonds:
            ET.SubElement(e, "Bond", {"p1": str(p1), "p2": str(p2),
                                      "d": repr(length), "k": repr(k)})
        return e

    if isinstance(f, HarmonicAngleForce):
        e = ET.Element("Force", {"type": "HarmonicAngleForce"})
        for p1, p2, p3, th, k in f._angles:
            ET.SubElement(e, "Angle", {"p1": str(p1), "p2": str(p2),
                                       "p3": str(p3), "a": repr(th),
                                       "k": repr(k)})
        return e

    if isinstance(f, PeriodicTorsionForce):
        e = ET.Element("Force", {"type": "PeriodicTorsionForce"})
        for p1, p2, p3, p4, per, ph, k in f._torsions:
            ET.SubElement(e, "Torsion", {
                "p1": str(p1), "p2": str(p2), "p3": str(p3), "p4": str(p4),
                "periodicity": str(per), "phase": repr(ph), "k": repr(k)})
        return e

    from ..forces.bonded import HarmonicTorsionForce
    if isinstance(f, HarmonicTorsionForce):
        e = ET.Element("Force", {"type": "HarmonicTorsionForce"})
        for p1, p2, p3, p4, th0, k in f._torsions:
            ET.SubElement(e, "Torsion", {
                "p1": str(p1), "p2": str(p2), "p3": str(p3), "p4": str(p4),
                "theta0": repr(th0), "k": repr(k)})
        return e

    from ..forces.cmap import CMAPTorsionForce
    if isinstance(f, CMAPTorsionForce):
        e = ET.Element("Force", {"type": "CMAPTorsionForce"})
        maps = ET.SubElement(e, "Maps")
        for size, energy in f._maps:
            m = ET.SubElement(maps, "Map", {"size": str(size)})
            m.text = " ".join(repr(float(v)) for v in energy)
        tors = ET.SubElement(e, "Torsions")
        for t in f._torsions:
            ET.SubElement(tors, "Torsion", {
                "map": str(t[0]),
                **{f"a{i+1}": str(t[1 + i]) for i in range(4)},
                **{f"b{i+1}": str(t[5 + i]) for i in range(4)}})
        return e

    if isinstance(f, CMMotionRemover):
        return ET.Element("Force", {"type": "CMMotionRemover",
                                    "frequency": str(f.getFrequency())})

    if isinstance(f, MonteCarloBarostat):
        return ET.Element("Force", {
            "type": "MonteCarloBarostat",
            "pressure": repr(f.getDefaultPressure()),
            "temperature": repr(f.getDefaultTemperature()),
            "frequency": str(f.getFrequency())})

    from ..forces.custom import (CustomAngleForce, CustomBondForce,
                                 CustomExternalForce, CustomNonbondedForce,
                                 CustomTorsionForce)
    if isinstance(f, (CustomBondForce, CustomAngleForce,
                      CustomTorsionForce, CustomExternalForce)):
        e = ET.Element("Force", {"type": type(f).__name__,
                                 "energy": f.getEnergyFunction()})
        pp = ET.SubElement(e, "PerTermParameters")
        for name in f._per_names:
            ET.SubElement(pp, "Parameter", {"name": name})
        gp = ET.SubElement(e, "GlobalParameters")
        for name, default in f._globals:
            ET.SubElement(gp, "Parameter", {"name": name,
                                            "default": repr(default)})
        ts = ET.SubElement(e, "Terms")
        npart = f._N_PARTICLES
        for t in f._terms:
            ET.SubElement(ts, "Term", {
                "particles": " ".join(map(str, t[:npart])),
                "params": " ".join(repr(v) for v in t[npart])})
        return e

    if isinstance(f, CustomNonbondedForce):
        e = ET.Element("Force", {
            "type": "CustomNonbondedForce",
            "energy": f.getEnergyFunction(),
            "method": str(f.getNonbondedMethod()),
            "cutoff": repr(f.getCutoffDistance()),
            "useSwitchingFunction": str(int(f.getUseSwitchingFunction())),
            "switchingDistance": repr(f.getSwitchingDistance())})
        pp = ET.SubElement(e, "PerParticleParameters")
        for name in f._per_names:
            ET.SubElement(pp, "Parameter", {"name": name})
        gp = ET.SubElement(e, "GlobalParameters")
        for name, default in f._globals:
            ET.SubElement(gp, "Parameter", {"name": name,
                                            "default": repr(default)})
        ps = ET.SubElement(e, "Particles")
        for prm in f._particles:
            ET.SubElement(ps, "Particle", {
                "params": " ".join(repr(v) for v in prm)})
        ex = ET.SubElement(e, "Exclusions")
        for a, b in f._exclusions:
            ET.SubElement(ex, "Exclusion", {"p1": str(a), "p2": str(b)})
        return e

    raise ValueError(f"cannot serialize force {type(f).__name__}")


def _force_from_xml(e: ET.Element):
    from ..forces.bonded import (HarmonicAngleForce, HarmonicBondForce,
                                 PeriodicTorsionForce)
    from ..forces.cmmotion import CMMotionRemover, MonteCarloBarostat
    from ..forces.drude import DrudeForce
    from ..forces.nonbonded import NonbondedForce

    kind = e.get("type")
    if kind == "NonbondedForce":
        f = NonbondedForce()
        f.setNonbondedMethod(int(e.get("method")))
        f.setCutoffDistance(float(e.get("cutoff")))
        f.setUseSwitchingFunction(bool(int(e.get("useSwitchingFunction"))))
        f.setSwitchingDistance(float(e.get("switchingDistance")))
        f.setEwaldErrorTolerance(float(e.get("ewaldTolerance")))
        f.setReactionFieldDielectric(float(e.get("rfDielectric")))
        f.setUseDispersionCorrection(
            bool(int(e.get("dispersionCorrection"))))
        f.setPMEParameters(float(e.get("alpha")), int(e.get("nx")),
                           int(e.get("ny")), int(e.get("nz")))
        for p in e.find("Particles"):
            f.addParticle(float(p.get("q")), float(p.get("sig")),
                          float(p.get("eps")))
        for x in e.find("Exceptions"):
            f.addException(int(x.get("p1")), int(x.get("p2")),
                           float(x.get("q")), float(x.get("sig")),
                           float(x.get("eps")))
        ov = e.find("LJPairOverrides")
        if ov is not None:
            for o in ov:
                f.addLJPairOverride(
                    [int(x) for x in o.get("particles1").split()],
                    [int(x) for x in o.get("particles2").split()],
                    float(o.get("sig")), float(o.get("eps")))
        return f

    if kind == "DrudeForce":
        f = DrudeForce()
        for p in e.find("Particles"):
            f.addParticle(int(p.get("p")), int(p.get("p1")),
                          int(p.get("p2")), int(p.get("p3")),
                          int(p.get("p4")), float(p.get("q")),
                          float(p.get("alpha")), float(p.get("aniso12")),
                          float(p.get("aniso34")))
        for x in e.find("ScreenedPairs"):
            f.addScreenedPair(int(x.get("p1")), int(x.get("p2")),
                              float(x.get("thole")))
        nb = e.find("NBTholePairs")
        if nb is not None:
            for x in nb:
                f.addNBTholePair(int(x.get("p1")), int(x.get("p2")),
                                 float(x.get("thole")))
        return f

    if kind == "HarmonicBondForce":
        f = HarmonicBondForce()
        for b in e:
            f.addBond(int(b.get("p1")), int(b.get("p2")),
                      float(b.get("d")), float(b.get("k")))
        return f

    if kind == "HarmonicAngleForce":
        f = HarmonicAngleForce()
        for a in e:
            f.addAngle(int(a.get("p1")), int(a.get("p2")),
                       int(a.get("p3")), float(a.get("a")),
                       float(a.get("k")))
        return f

    if kind == "PeriodicTorsionForce":
        f = PeriodicTorsionForce()
        for t in e:
            f.addTorsion(int(t.get("p1")), int(t.get("p2")),
                         int(t.get("p3")), int(t.get("p4")),
                         int(t.get("periodicity")), float(t.get("phase")),
                         float(t.get("k")))
        return f

    if kind == "HarmonicTorsionForce":
        from ..forces.bonded import HarmonicTorsionForce
        f = HarmonicTorsionForce()
        for t in e:
            f.addTorsion(int(t.get("p1")), int(t.get("p2")),
                         int(t.get("p3")), int(t.get("p4")),
                         float(t.get("theta0")), float(t.get("k")))
        return f

    if kind == "CMAPTorsionForce":
        from ..forces.cmap import CMAPTorsionForce
        f = CMAPTorsionForce()
        for m in e.find("Maps"):
            size = int(m.get("size"))
            f.addMap(size, [float(v) for v in (m.text or "").split()])
        for t in e.find("Torsions"):
            f.addTorsion(int(t.get("map")),
                         *(int(t.get(f"a{i+1}")) for i in range(4)),
                         *(int(t.get(f"b{i+1}")) for i in range(4)))
        return f

    if kind == "CMMotionRemover":
        return CMMotionRemover(int(e.get("frequency")))

    if kind == "MonteCarloBarostat":
        return MonteCarloBarostat(float(e.get("pressure")),
                                  float(e.get("temperature")),
                                  int(e.get("frequency")))

    if kind in ("CustomBondForce", "CustomAngleForce",
                "CustomTorsionForce", "CustomExternalForce"):
        from ..forces.custom import (CustomAngleForce, CustomBondForce,
                                     CustomExternalForce,
                                     CustomTorsionForce)
        cls = {"CustomBondForce": CustomBondForce,
               "CustomAngleForce": CustomAngleForce,
               "CustomTorsionForce": CustomTorsionForce,
               "CustomExternalForce": CustomExternalForce}[kind]
        f = cls(e.get("energy"))
        for p in e.find("PerTermParameters"):
            f._add_per(p.get("name"))
        for p in e.find("GlobalParameters"):
            f.addGlobalParameter(p.get("name"), float(p.get("default")))
        for t in e.find("Terms"):
            particles = [int(x) for x in t.get("particles").split()]
            prm = tuple(float(x) for x in t.get("params").split())
            f._terms.append(tuple(particles) + (prm,))
        return f

    if kind == "CustomNonbondedForce":
        from ..forces.custom import CustomNonbondedForce
        f = CustomNonbondedForce(e.get("energy"))
        f.setNonbondedMethod(int(e.get("method")))
        f.setCutoffDistance(float(e.get("cutoff")))
        f.setUseSwitchingFunction(bool(int(e.get("useSwitchingFunction"))))
        f.setSwitchingDistance(float(e.get("switchingDistance")))
        for p in e.find("PerParticleParameters"):
            f.addPerParticleParameter(p.get("name"))
        for p in e.find("GlobalParameters"):
            f.addGlobalParameter(p.get("name"), float(p.get("default")))
        for p in e.find("Particles"):
            f.addParticle([float(x) for x in p.get("params").split()])
        for x in e.find("Exclusions"):
            f.addExclusion(int(x.get("p1")), int(x.get("p2")))
        return f

    raise ValueError(f"unknown force type in XML: {kind}")


def serialize_system(system) -> str:
    """Non-lossy XML of a System: particles, constraints, virtual sites,
    periodic box, and every force (the role of OpenMM's
    XmlSerializer::serialize<System>)."""
    root = ET.Element("System", {"version": str(_VERSION)})
    box = system.getDefaultPeriodicBoxVectors()
    bv = ET.SubElement(root, "PeriodicBoxVectors")
    for name, v in zip("ABC", box):
        ET.SubElement(bv, name, {"x": repr(v[0]), "y": repr(v[1]),
                                 "z": repr(v[2])})
    ps = ET.SubElement(root, "Particles")
    for i in range(system.getNumParticles()):
        ET.SubElement(ps, "Particle",
                      {"mass": repr(system.getParticleMass(i))})
    cs = ET.SubElement(root, "Constraints")
    for ci in range(system.getNumConstraints()):
        p1, p2, d = system.getConstraintParameters(ci)
        ET.SubElement(cs, "Constraint", {"p1": str(p1), "p2": str(p2),
                                         "d": repr(d)})
    vs = ET.SubElement(root, "VirtualSites")
    for i in sorted(system._virtual_sites):
        vs.append(_vsite_to_xml(i, system.getVirtualSite(i)))
    fs = ET.SubElement(root, "Forces")
    for f in system.getForces():
        fs.append(_force_to_xml(f))
    return ET.tostring(root, encoding="unicode")


def deserialize_system(xml: str):
    from ..system import System
    root = ET.fromstring(xml)
    if root.tag != "System":
        raise ValueError(f"not a System document: {root.tag}")
    system = System()
    for p in root.find("Particles"):
        system.addParticle(float(p.get("mass")))
    for c in root.find("Constraints"):
        system.addConstraint(int(c.get("p1")), int(c.get("p2")),
                             float(c.get("d")))
    for v in root.find("VirtualSites"):
        system.setVirtualSite(int(v.get("index")), _vsite_from_xml(v))
    bv = root.find("PeriodicBoxVectors")
    system.setDefaultPeriodicBoxVectors(
        *[[float(bv.find(n).get(ax)) for ax in "xyz"] for n in "ABC"])
    for f in root.find("Forces"):
        system.addForce(_force_from_xml(f))
    return system


class XmlSerializer:
    """OpenMM-shaped facade: ``XmlSerializer.serialize(obj)`` /
    ``XmlSerializer.deserialize(xml)``, dispatching on object/document
    type (System or DrudeTGNHIntegrator).

    The API shape mirrors OpenMM's, but the document schema is the JAX
    package's own: attribute names and structure differ from OpenMM's
    System XML, so files do not interchange with the OpenMM toolchain in
    either direction.  The integrator
    document additionally round-trips fields OpenMM's proxy drops
    (temp groups, maxDrudeDistance, useCOMTempGroup —
    DrudeTGNHIntegratorProxy.cpp:43-55 is lossy)."""

    @staticmethod
    def serialize(obj) -> str:
        if isinstance(obj, DrudeTGNHIntegrator):
            return serialize_integrator(obj)
        from ..system import System
        if isinstance(obj, System):
            return serialize_system(obj)
        raise TypeError(f"cannot serialize {type(obj).__name__}")

    @staticmethod
    def deserialize(xml: str):
        tag = ET.fromstring(xml).tag
        if tag == "DrudeTGNHIntegrator":
            return deserialize_integrator(xml)
        if tag == "System":
            return deserialize_system(xml)
        raise ValueError(f"unknown document type: {tag}")


# -- checkpoints -------------------------------------------------------------
#
# Checkpoints: the whole dynamic state of a Context in one .npz file
# (save_checkpoint / load_checkpoint, the checkpoint half of the JAX
# package's app/serialization.py).
#
# The file holds every SimState tensor (positions, velocities, forces,
# the (3, 3) box, triclinic or not, the compensation, the Nose-Hoover
# chain, the latches), the step and time, the barostat's move size,
# counters and generator state, and the cell sort with the plan it belongs
# to (the (3, 3) box the grid was planned at and the nonbonded options,
# such as a grown capacity).  Loading it into a Context of the same System
# continues the saved trajectory bit for bit: the same sort, the same sums
# (on the card every scatter-add sums in a fixed order, ops/scatter.py,
# and both sweep kernels sum in a fixed order), the same random draws.
# Flat-ensemble NPT adds the per-replica box scales and the per-replica
# barostat move sizes and counters.
# The format is the port's own (it does not read the JAX package's
# checkpoints).  numpy arrays only, no pickled objects.

FORMAT = "openmm_drudenose_tpu_torch checkpoint 1"
_TENSORS = ("positions", "velocities", "forces", "potential_energy", "box",
            "eta", "eta_dot", "eta_dot_dot", "ke_sum", "group_ke",
            "hardwall_runaway", "pos_err")
_PER_REPLICA = ("rep_scale", "baro_scale", "baro_naccept", "baro_nattempt")
_SORT = ("slot_atom", "inv_slot", "overflow", "ref_positions", "image",
         "stencil_invalid", "drift_exceeded", "excl_span_exceeded")


def save_checkpoint(path: str, context, compressed: bool = False) -> None:
    """Write the Context's full state to `path` (.npz; zip-deflated with
    `compressed`, which load_checkpoint reads alike)."""
    st = context._state
    arrays = {"format": np.asarray(FORMAT)}
    for name in _TENSORS:
        v = getattr(st, name)
        if v is not None:
            arrays[f"state.{name}"] = v.detach().cpu().numpy()
    if st.rep_scale is None:
        arrays["scalars"] = np.asarray(
            [st.step, st.time, st.baro_scale, st.baro_naccept,
             st.baro_nattempt], np.float64)
    else:
        # flat-ensemble NPT: (R,) scales, move sizes and counters
        arrays["scalars"] = np.asarray([st.step, st.time, 0, 0, 0],
                                       np.float64)
        for name in _PER_REPLICA:
            arrays[f"state.{name}"] = getattr(st, name).numpy()
    arrays["baro_gen"] = st.baro_gen.get_state().numpy()
    arrays["plan_box"] = np.asarray(context._plan_box, np.float64)
    arrays["nb_options"] = np.asarray(json.dumps(context._nb_options,
                                                 sort_keys=True))
    if st.neighbors is not None:
        for name in _SORT:
            v = getattr(st.neighbors, name)
            if v is not None:
                arrays[f"sort.{name}"] = v.detach().cpu().numpy()
    with open(path, "wb") as f:
        (np.savez_compressed if compressed else np.savez)(f, **arrays)


def load_checkpoint(path: str, context) -> None:
    """Restore a state written by save_checkpoint into `context`, built
    from the same System; where the saved cell plan differs (a grid
    planned again at another box, a grown capacity), the Context is
    compiled again with the saved one first."""
    with open(path, "rb") as f:
        data = dict(np.load(f, allow_pickle=False))
    if str(data["format"]) != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of this format")
    n = data["state.positions"].shape[0]
    if n != context._static.n_atoms:
        raise ValueError(f"the checkpoint holds {n} atoms, the context "
                         f"{context._static.n_atoms}")
    options = json.loads(str(data["nb_options"]))
    plan_box = data["plan_box"]
    if (options != context._nb_options
            or not np.array_equal(plan_box, context._plan_box)):
        context._nb_options = options
        context._system.setDefaultPeriodicBoxVectors(*map(tuple, plan_box))
        context._build_potential()
    st = context._state
    dev = context._device
    kw = {}
    for name in _TENSORS:
        key = f"state.{name}"
        template = getattr(st, name)
        if key not in data:
            kw[name] = None
            continue
        like = template if template is not None else st.positions
        on_host = like.device.type == "cpu" and name in (
            "eta", "eta_dot", "eta_dot_dot", "ke_sum", "group_ke")
        kw[name] = torch.as_tensor(data[key], dtype=like.dtype,
                                   device="cpu" if on_host else dev)
    step, time, scale, nacc, natt = data["scalars"].tolist()
    gen = torch.Generator(device="cpu")
    gen.set_state(torch.as_tensor(data["baro_gen"]))
    neighbors = None
    if "sort.slot_atom" in data:
        neighbors = CellSort(**{
            name: (torch.as_tensor(data[f"sort.{name}"], device=dev)
                   if f"sort.{name}" in data else None) for name in _SORT})
    baro = dict(baro_scale=float(scale), baro_naccept=int(nacc),
                baro_nattempt=int(natt), rep_scale=None)
    if "state.rep_scale" in data:
        baro = {name: torch.from_numpy(data[f"state.{name}"].copy())
                for name in _PER_REPLICA}
    context._state = st.replace(
        step=int(step), time=float(time), baro_gen=gen,
        neighbors=neighbors, **baro, **kw)
    context._forces_valid = True
    context._ke_valid = True
    context._pe_valid = False
