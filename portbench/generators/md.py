"""The general generator of the benchmark's MD traffic.  MD serves no
requests, so a traffic mix is the ensemble, the start velocities and the
way the steps are dispatched, read from portbench/traffic/<name>.json:

  generator           "md" (this module)
  ensemble            "NVT" (the configuration's thermostat alone), or
                      "NPT" with `barostat`
  barostat            NPT only: {"pressure_bar", "temperature_K",
                      "frequency"}, an isotropic MonteCarloBarostat added
                      to the System (a flat ensemble moves each
                      replica's volume on its own); its first attempt
                      comes after `frequency` steps, so frequency >
                      check_steps keeps the checked start at the
                      configuration's box
  temperature_K       the centres of mass of core-Drude pairs and every
                      other massive site, Maxwell-Boltzmann
  relative_temperature_K  the pairs' relative motion
  chunk_steps         steps a call of the window (Simulation.step runs
                      between reporters in such calls)
  check_steps         the program's first call, which the reference
                      follows from the same inputs
  warm_steps          steps of set-up in all (check_steps of them first)
  trace_steps         steps of the call of a --trace 1 run profiled with
                      the card's activity (the device metrics)
  label_steps         steps of the call profiled with the host's ops too
                      (which host op each idle gap falls in)
  sync_steps          steps of the call counted under the sync debug mode

Every seed draws the same amount of work: the same positions and sizes,
other velocities.  The sites come from the configuration's topology
(portbench/systems/): `site_mass` and `drude_pairs`.
"""

from __future__ import annotations

import numpy as np

BOLTZ = 8.31446261815324e-3   # kJ/(mol K)
KEYS = ("ensemble", "temperature_K", "relative_temperature_K",
        "chunk_steps", "check_steps", "warm_steps", "trace_steps",
        "label_steps", "sync_steps")
BAROSTAT_KEYS = ("pressure_bar", "temperature_K", "frequency")


def validate(traffic: dict) -> dict:
    missing = [k for k in KEYS if k not in traffic]
    if missing:
        raise ValueError(f"traffic file lacks {missing}")
    ens = traffic["ensemble"]
    if ens not in ("NVT", "NPT"):
        raise ValueError(f"ensemble {ens!r}: the generator makes NVT and "
                         "NPT traffic")
    baro = traffic.get("barostat")
    if (ens == "NPT") != (baro is not None):
        raise ValueError("a barostat goes with NPT and NPT with a barostat")
    if baro is not None:
        lacks = [k for k in BAROSTAT_KEYS if k not in baro]
        if lacks:
            raise ValueError(f"barostat lacks {lacks}")
        if not int(baro["frequency"]) > int(traffic["check_steps"]):
            raise ValueError("the barostat's first attempt has to come "
                             "after the checked start: frequency > "
                             "check_steps")
    if not 2 <= traffic["check_steps"] < traffic["warm_steps"]:
        raise ValueError("need 2 <= check_steps < warm_steps")
    return traffic


def prepare(system, traffic: dict, port) -> None:
    """Adds what the ensemble needs to the port's System (`port` is the
    port's package) before the Context is built."""
    baro = traffic.get("barostat")
    if baro is not None:
        system.addForce(port.MonteCarloBarostat(
            float(baro["pressure_bar"]), float(baro["temperature_K"]),
            int(baro["frequency"])))


def velocities(topology, traffic: dict, n_replicas: int,
               seed: int) -> np.ndarray:
    """(n_replicas, n0, 3) float64 start velocities drawn from `seed`:
    each replica its own.  A Drude pair's centre of mass and every other
    massive site at temperature_K, the pair's relative motion at
    relative_temperature_K, massless sites at rest."""
    m = np.asarray(topology.site_mass, np.float64)
    core, drude = (np.asarray(i) for i in topology.drude_pairs)
    rng = np.random.default_rng(int(seed) % (1 << 64))
    kt = BOLTZ * float(traffic["temperature_K"])
    kt_rel = BOLTZ * float(traffic["relative_temperature_K"])
    n0 = m.shape[0]
    safe = np.where(m > 0, m, 1.0)
    v = rng.standard_normal((n_replicas, n0, 3)) * np.sqrt(kt / safe)[:, None]
    v[:, m == 0] = 0.0
    mc, md = m[core], m[drude]
    mt = (mc + md)[:, None]
    shape = (n_replicas, core.shape[0], 3)
    cm = rng.standard_normal(shape) * np.sqrt(kt / mt)
    rel = rng.standard_normal(shape) * np.sqrt(kt_rel * mt / (mc * md)[:, None])
    v[:, core] = cm - (md[:, None] / mt) * rel
    v[:, drude] = cm + (mc[:, None] / mt) * rel
    return v
