"""SWM4-NDP water (Lamoureux et al., Chem. Phys. Lett. 418, 245 (2006))
under the DrudeTGNHIntegrator: the port's box of it, held to the
configuration's published parameters, and the plain reference of it
(portbench/reference/).  A configuration names it with
"system": "swm4ndp_water" and gives the model in its "water" group.
"""

from __future__ import annotations

import math

from portbench.reference import forces, tgnh, water
from portbench.reference.precision import F64


def build(cfg: dict, port):
    """(System, DrudeTGNHIntegrator) of the port, at the configuration's
    molecules, cutoff, Ewald tolerance and integrator settings."""
    from openmm_drudenose_tpu_torch.io import builders
    ig = cfg["integrator"]
    system, _ = builders.build_water_box(
        int(cfg["n_molecules"]), cutoff=float(cfg["cutoff_nm"]),
        ewald_tol=float(cfg["ewald_tolerance"]))
    check_system(system, cfg)
    integ = port.DrudeTGNHIntegrator(
        ig["temperature_K"], ig["coupling_time_ps"],
        ig["drude_temperature_K"], ig["drude_coupling_time_ps"],
        ig["step_ps"], ig["drude_substeps"], ig["nh_chains"])
    integ.setMaxDrudeDistance(ig["max_drude_distance_nm"])
    integ.setConstraintTolerance(ig["constraint_tolerance"])
    return system, integ


def topology(cfg: dict) -> water.Water:
    return water.from_config(cfg)


def reference(cfg: dict, device, arith=F64):
    w = topology(cfg)
    field = forces.Field(w, cfg, device, arith)
    return w, field, tgnh.TGNH(field, cfg)


def check_system(system, cfg: dict) -> None:
    """The port's System against the configuration's published SWM4-NDP
    parameters: every molecule's site count, and the first molecule's
    charges, LJ, masses, Drude spring, constraints and M-site weights."""
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
    w = cfg["water"]
    order = w["site_order"]
    kind = [s.rstrip("12") for s in order]
    n = 5 * int(cfg["n_molecules"])
    if system.getNumParticles() != n:
        raise ValueError(f"System has {system.getNumParticles()} sites, "
                         f"the configuration {n}")
    found = {type(f).__name__: f for f in system.getForces()}
    nb, dr = found["NonbondedForce"], found["DrudeForce"]
    bad = []

    def near(a, b, what):
        if not math.isclose(float(a), float(b), rel_tol=1e-9, abs_tol=1e-12):
            bad.append(f"{what}: {a} != {b}")

    lj = w["lennard_jones"]
    for i, k in enumerate(kind):
        q, sig, eps = nb.getParticleParameters(i)
        near(q, w["charge"][k], f"charge {order[i]}")
        near(eps, lj[k][1] if k in lj else 0.0, f"epsilon {order[i]}")
        if k in lj:
            near(sig, lj[k][0], f"sigma {order[i]}")
        near(system.getParticleMass(i), w["mass"][k], f"mass {order[i]}")
    p = dr.getParticleParameters(0)
    core, drude = order.index("O"), order.index("D")
    if (p[0], p[1]) != (drude, core):
        bad.append(f"Drude pair {p[:2]}")
    near(ONE_4PI_EPS0 * p[5] ** 2 / p[6], w["drude_k_kj_per_nm2"],
         "Drude spring")
    lengths = sorted(system.getConstraintParameters(i)[2] for i in range(3))
    for got, want in zip(lengths, sorted([w["r_OH_nm"]] * 2
                                         + [w["r_HH_nm"]])):
        near(got, want, "constraint")
    vs = system.getVirtualSite(order.index("M"))
    r_oh, r_hh = w["r_OH_nm"], w["r_HH_nm"]
    w23 = w["r_OM_nm"] / (2.0 * math.sqrt(r_oh ** 2 - (r_hh / 2.0) ** 2))
    for got, want in zip(vs.weights, (1.0 - 2.0 * w23, w23, w23)):
        near(got, want, "M-site weight")
    if nb.getCutoffDistance() != cfg["cutoff_nm"]:
        bad.append(f"cutoff {nb.getCutoffDistance()}")
    if bad:
        raise ValueError("the System departs from the configuration: "
                         + "; ".join(bad))
