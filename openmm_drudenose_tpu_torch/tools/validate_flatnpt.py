"""Flat-ensemble NPT on the CUDA card: the counterpart of the JAX
package's scripts/validate_flatnpt_tpu.py.

--replicas (8) x --mol (500) SWM4-NDP waters (build_water_box(500, PME,
cutoff 0.7): a 6^3 grid a replica) under MonteCarloBarostat(1.01325,
300, 25), each replica its own box scale (SimState.rep_scale), as one
FlatReplicaEnsemble through the scaled instantiations of kernel B1;
DrudeTGNHIntegrator(300, 0.1, 1, 0.1, 0.001, 20, 1) with a 0.02 nm wall,
single precision, from the lattice (no minimization, as the JAX script),
300 K velocities (seed 0); --equil-ps of equilibration, then --sample-ps
in 20 chunks.  It prints the layout the ensemble chose (its bands and
pad replicas), the per-replica densities, the ensemble density with the
JAX script's SEM of the 20 chunk means and with the SE of those chunks
inflated for their AR(1) correlation (tools/series.py::block_se), and
the box scales; every replica's density must lie in the JAX script's
0.92-1.06 g/mL, and the ensemble's is held against the JAX run on its
chip (0.9942 +- 0.0006 g/mL).

    python3 -m openmm_drudenose_tpu_torch.tools.validate_flatnpt \\
        [--replicas 8] [--mol 500] [--equil-ps 20] [--sample-ps 40] \\
        [--state PATH --budget-s S]

With --state and --budget-s a run that the budget cuts checkpoints and
exits 4; the same call again resumes it.

On the CUDA card; it exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from openmm_drudenose_tpu_torch.tools import measure_drift as md
from openmm_drudenose_tpu_torch.tools import series, setups

# the JAX run on its chip (COVERAGE.md:89)
JAX_RHO, JAX_RHO_SE = 0.9942, 0.0006
REPLICA_BAND = (0.92, 1.06)
N_CHUNKS = 20


def build(replicas: int, mol: int, device, cutoff: float = 0.7):
    """(ensemble, template Context) from the lattice, 300 K velocities
    (seed 0)."""
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.io import builders
    from openmm_drudenose_tpu_torch.parallel.flatrep import \
        FlatReplicaEnsemble
    system, positions = builders.build_water_box(
        mol, method=dt.NonbondedForce.PME, cutoff=cutoff)
    system.addForce(dt.MonteCarloBarostat(1.01325, 300.0, 25))
    integ = setups.bench_integrator()
    ctx = dt.Context(system, integ, precision="single", strategy="cellpair",
                     device=device)
    ctx.setPositions(positions)
    ens = FlatReplicaEnsemble(ctx, replicas)
    ens.setVelocitiesToTemperature(300.0, seed=0)
    return ens, ctx


def layout(ens) -> dict:
    """The layout the ensemble chose: bands, internal and pad replicas,
    the grid."""
    cfg = ens.context._cp_cfg
    return {"layout": list(ens.layout), "replicas": ens.n_replicas,
            "internal": ens.n_replicas_padded,
            "pad": ens.n_replicas_padded - ens.n_replicas,
            "grid": list(cfg.grid), "replica_grid": list(cfg.phys_grid),
            "capacity": cfg.capacity, "offsets": cfg.n_offsets,
            "atoms": int(ens.context._static.n_atoms)}


def run(ens, equil_ps: float, sample_ps: float, log=print,
        steps_per_ps: int = 1000, state: str | None = None,
        budget_s: float | None = None):
    """Equilibrate (1 ps a call), then N_CHUNKS chunks of the sampling:
    (N_CHUNKS, R) densities at each chunk's end, as the JAX script
    samples them (None where the budget ran out first).  With `state`
    the ensemble's checkpoint and the progress (`state` + ".progress.npz":
    the ps of equilibration done, the chunks' densities) are written when
    --budget-s is spent, and a later call resumes from them."""
    import openmm_drudenose_tpu_torch as dt
    t0 = time.time()
    done, dens = 0, []
    prog = None if state is None else state + ".progress.npz"
    if prog is not None and os.path.exists(prog):
        dt.load_checkpoint(state, ens.context)
        with np.load(prog) as z:
            done, dens = int(z["equil_done"]), list(z["dens"])
        log(f"resumed: {done} ps of equilibration, {len(dens)} chunks")

    def spent():
        if budget_s is None or time.time() - t0 <= budget_s:
            return False
        if prog is not None:
            dt.save_checkpoint(state, ens.context)
            np.savez(prog, equil_done=done, dens=np.array(
                dens, np.float64).reshape(len(dens), ens.n_replicas))
            log(f"budget spent: checkpointed at {done} ps of "
                f"equilibration, {len(dens)} chunks")
        return True

    while done < int(round(equil_ps)):
        ens.step(steps_per_ps)
        done += 1
        if done % 5 == 0:
            log(f"equilibration {done} ps: rho "
                f"{np.round(ens.densities(), 4).tolist()} "
                f"({time.time() - t0:.0f} s; latches "
                f"{md.latches(ens.context)})")
        if spent():
            return None
    per = int(round(sample_ps * steps_per_ps / N_CHUNKS))
    while len(dens) < N_CHUNKS:
        ens.step(per)
        dens.append(ens.densities())
        log(f"chunk {len(dens)}: rho {np.round(dens[-1], 4).tolist()} "
            f"({time.time() - t0:.0f} s)")
        if len(dens) < N_CHUNKS and spent():
            return None
    return np.array(dens)


def summary(dens: np.ndarray, scales: np.ndarray, log=print) -> dict:
    rho_rep = dens.mean(axis=0)
    ens_mean = dens.mean(axis=1)
    sem = float(ens_mean.std() / np.sqrt(len(ens_mean)))
    se, rho, _ = series.block_se(ens_mean, 1)
    held, half = series.within(float(dens.mean()), JAX_RHO, se, JAX_RHO_SE)
    in_band = bool(np.all((REPLICA_BAND[0] < rho_rep)
                          & (rho_rep < REPLICA_BAND[1])))
    log(f"per-replica rho: {np.round(rho_rep, 4).tolist()} "
        f"({'all' if in_band else 'NOT all'} in {REPLICA_BAND})")
    log(f"ensemble rho = {dens.mean():.5f} +- {sem:.5f} g/mL (the JAX "
        f"script's SEM of {len(ens_mean)} chunks; AR1-inflated +- {se:.5f},"
        f" rho {rho:+.3f}); the JAX run {JAX_RHO} +- {JAX_RHO_SE}: band "
        f"+-{half:.5f}, {'held' if held else 'MISSED'}; scales "
        f"{np.round(scales, 4).tolist()}")
    return {"rho_replicas": rho_rep.tolist(), "rho": float(dens.mean()),
            "sem": sem, "se": se, "chunk_rho": rho, "band": half,
            "held": held, "replicas_in_band": in_band,
            "scales": scales.tolist()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--mol", type=int, default=500)
    ap.add_argument("--equil-ps", type=float, default=20.0)
    ap.add_argument("--sample-ps", type=float, default=40.0)
    ap.add_argument("--state", default=None,
                    help="checkpoint of a run the budget cuts (resumed "
                         "where it exists)")
    ap.add_argument("--budget-s", type=float, default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("validate_flatnpt: no CUDA device (the tool runs on the "
              "card)", file=sys.stderr)
        return 1
    card = md.card_line()
    print(card, flush=True)
    t0 = time.time()
    ens, _ = build(args.replicas, args.mol, "cuda")
    lay = layout(ens)
    print(f"ensemble built ({time.time() - t0:.0f} s): {lay}", flush=True)
    dens = run(ens, args.equil_ps, args.sample_ps, state=args.state,
               budget_s=args.budget_s)
    if dens is None:
        return 4
    st = ens.context._state
    res = summary(dens, st.rep_scale.double().numpy(), log=print)
    print(json.dumps({"card": card, **lay, "equil_ps": args.equil_ps,
                      "latches": md.latches(ens.context),
                      "sample_ps": args.sample_ps,
                      "seconds": time.time() - t0, **res}), flush=True)
    return 0 if res["replicas_in_band"] else 1


if __name__ == "__main__":
    sys.exit(main())
