"""Make a pre-equilibrated bench snapshot on the CUDA card: the
counterpart of the JAX package's scripts/make_bench_snapshot.py.

    python3 -m openmm_drudenose_tpu_torch.tools.make_snapshot \\
        --atoms N --out PATH [--equil-steps 4000] [--tile SMALLER] \\
        [--budget-s S]

data/bench_equil_1m.npz was made so: --atoms 125000 --out S, then
--atoms 1000000 --tile S --out data/bench_equil_1m.npz.

The JAX script's steps: build_water_box(atoms // 5) (SWM4-NDP water, PME
at 1.0 nm), the bench integrator (tools/setups.py::bench_integrator:
DrudeTGNHIntegrator(300, 0.1, 1, 0.1, 0.001, 20, 1), 0.02 nm wall),
single precision on the cell-pair strategy; minimizeEnergy() (FIRE, its
500 iterations; the port sorts the cells again past half the skin), 300 K
velocities (seed 0); equilibration in chunks of 64 steps, then 512; the
effective temperature from 6 degrees of freedom a molecule,
2 KE / (6 n_mol k_B), must lie in 270-330 K (a snapshot still warming
from the minimized lattice grows the cells' occupancy later, in the run
that loads it); then a fresh Context (auto capacity) from the positions
and velocities as written takes 128 steps, and the cell capacity it
settles at is stored (a latch there, a drift past the skin, exits 1
after the write: extend the snapshot).  The snapshot is
np.savez_compressed with the JAX keys and dtypes (positions and
velocities float32 (n, 3), n_atoms, equil_steps and capacity int64,
potential_energy float64), which tools/setups.py::bench_context reads;
it is written to a temporary file and moved into place.

Where --out already holds a snapshot of --atoms atoms, the run extends
it (its positions and velocities, no minimization; the JAX script's
branch, here for any size) and stores the steps of both.  --tile starts
instead from a smaller snapshot tiled k x k x k (125,000 atoms tile to
1,000,000 in the same box), equilibrated alike: the 1M lattice start
blows up in its first 64 steps after 500 FIRE iterations or 2,500 (FIRE
scales every atom's move by the largest one's, and stalls at ~-14 kJ/mol
a molecule), while 125k at the same energy a molecule heats to ~550 K
and settles.  --budget-s ends the equilibration at the
chunk boundary before the budget and writes what it reached, so that a
later call extends it.  The tool refuses to write the JAX package's
snapshot (data/bench_equil_100k.npz).
It prints a line a stage and a JSON summary last (the stages' seconds,
FIRE's iterations and sorts, the latches of each chunk, T_eff, the
settled capacity and the grids, the fresh Context's ms/step, the best of
three runs of 128 steps).  On the CUDA card only: it exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from openmm_drudenose_tpu_torch.tools import measure_drift, setups

# the JAX script's: FIRE iterations (minimizeEnergy's default), the
# equilibration's chunks, the fresh Context's steps and its three timed
# runs, the T_eff band; build_water_box's PME cutoff (nm)
MIN_ITERATIONS = 500
FIRST_CHUNK, CHUNK = 64, 512
SETTLE_STEPS = TIMED_STEPS = 128
T_EFF_BAND = (270.0, 330.0)
CUTOFF = 1.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--atoms", type=int, default=100_000)
    ap.add_argument("--equil-steps", type=int, default=4000)
    ap.add_argument("--out", required=True,
                    help="the snapshot (.npz); extended where it holds "
                         "--atoms atoms")
    ap.add_argument("--tile", default=None,
                    help="start from this snapshot tiled k x k x k (k^3 "
                         "times its atoms = --atoms; build_water_box's "
                         "boxes scale so) instead of the lattice")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="wall budget: end the equilibration at a chunk "
                         "boundary before it and write what was reached")
    args = ap.parse_args(argv)
    if os.path.realpath(args.out) == os.path.realpath(
            setups.BENCH_SNAPSHOT):
        raise SystemExit(f"make_snapshot: {args.out} is the JAX package's "
                         "snapshot; write another file")
    return args


def t_eff(ke: float, n_mol: int) -> float:
    """The effective temperature 2 KE / (6 n_mol k_B): 6 degrees of
    freedom a rigid molecule at 300 K, the Drudes' 3 at ~1 K left out."""
    from openmm_drudenose_tpu_torch.units import BOLTZ
    return 2.0 * ke / (6 * n_mol * BOLTZ)


def tile(path: str, atoms: int):
    """(positions, velocities, k) of the snapshot at `path` tiled k x k x
    k to `atoms` atoms: copy (i, j, l) shifted by (i, j, l) times the
    box of build_water_box(its molecules), which is 1/k of the box of
    build_water_box(atoms // 5) at the same density.  Every SWM4-NDP
    molecule has the same topology, so the copies' order is free."""
    from openmm_drudenose_tpu_torch.io import builders
    with np.load(path) as z:
        n = int(z["n_atoms"])
        pos = np.asarray(z["positions"], np.float64)
        vel = np.asarray(z["velocities"], np.float64)
    k = int(round((atoms / n) ** (1.0 / 3.0)))
    if k ** 3 * n != atoms:
        raise SystemExit(f"make_snapshot: {atoms} atoms is no cube of "
                         f"{path}'s {n}")
    box = np.array(builders.water_box_lattice(n // 5)[2])
    shifts = np.array([[i, j, l] for i in range(k) for j in range(k)
                       for l in range(k)], np.float64) * box
    return ((pos[None] + shifts[:, None]).reshape(-1, 3),
            np.tile(vel, (k ** 3, 1)), k)


def _context(args, device, precision):
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.io import builders
    system, positions = builders.build_water_box(args.atoms // 5,
                                                 cutoff=CUTOFF)
    integ = setups.bench_integrator()
    ctx = dt.Context(system, integ, precision=precision, device=device,
                     strategy="cellpair")
    return ctx, integ, positions


def _sync(device):
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def make(args, device="cuda", precision="single", log=print) -> dict:
    """Make (or extend) the snapshot `args.out` on `device`; its summary
    (the fresh Context's latches under "settle_latches").  Raises
    SystemExit, writing nothing, where T_eff leaves its band."""
    t0 = time.time()
    out = {"atoms": args.atoms, "device": str(device)}
    ctx, integ, lattice = _context(args, device, precision)
    n_mol = args.atoms // 5
    prior = None
    if os.path.exists(args.out):
        with np.load(args.out) as z:
            if int(z["n_atoms"]) == args.atoms:
                prior = {k: z[k] for k in z.files}
    out["build_s"] = time.time() - t0
    done = 0
    if prior is not None:
        ctx.setPositions(np.asarray(prior["positions"], np.float64))
        ctx.setVelocities(np.asarray(prior["velocities"], np.float64))
        done = int(prior["equil_steps"])
        out["extended"] = done
        log(f"[{time.time() - t0:7.1f} s] extending {args.out} "
            f"({done} steps)")
    elif args.tile is not None:
        pos, vel, k = tile(args.tile, args.atoms)
        ctx.setPositions(pos)
        ctx.setVelocities(vel)
        out["tiled_from"] = [args.tile, k]
        log(f"[{time.time() - t0:7.1f} s] {args.tile} tiled {k}x{k}x{k}")
    else:
        ctx.setPositions(lattice)
        pe0 = ctx.getState(energy=True).getPotentialEnergy()
        t = time.time()
        ctx.minimizeEnergy(maxIterations=MIN_ITERATIONS)
        pe1 = ctx.getState(energy=True).getPotentialEnergy()
        _sync(device)
        out["minimize"] = {"s": time.time() - t, "pe_before": pe0,
                           "pe_after": pe1,
                           "iterations": ctx._minimize_iterations,
                           "sorts": ctx._minimize_sorts}
        log(f"[{time.time() - t0:7.1f} s] minimized in "
            f"{out['minimize']['s']:.1f} s: {ctx._minimize_iterations} FIRE "
            f"iterations, {ctx._minimize_sorts} cell sorts, PE {pe0:.6e} -> "
            f"{pe1:.6e} kJ/mol")
        ctx.setVelocitiesToTemperature(300.0, seed=0)
    cfg = ctx._cp_cfg
    out["grid"], out["pme_grid"] = list(cfg.grid), list(ctx._nb.pme.grid)
    t = time.time()
    chunks = []
    session = 0
    while session < args.equil_steps:
        if args.budget_s is not None and chunks and (
                time.time() - t0 + 2.0 * chunks[-1]["s"] > args.budget_s):
            log(f"[{time.time() - t0:7.1f} s] --budget-s: the equilibration "
                f"ends at {session} of {args.equil_steps} steps")
            break
        chunk = min(CHUNK if session else FIRST_CHUNK,
                    args.equil_steps - session)
        tc = time.time()
        integ.step(chunk)
        ke = float(ctx.getState(energy=True).getKineticEnergy())
        session += chunk
        row = {"steps": done + session, "s": time.time() - tc,
               "t_eff": t_eff(ke, n_mol),
               "capacity": ctx._cp_cfg.capacity,
               "latches": measure_drift.latches(ctx)}
        chunks.append(row)
        log(f"[{time.time() - t0:7.1f} s] equilibrated {row['steps']} steps "
            f"({row['s'] / chunk * 1e3:.2f} ms/step), KE {ke:.6e}, T_eff "
            f"{row['t_eff']:.2f} K, capacity {row['capacity']}, latches "
            f"{row['latches']}")
        if not np.isfinite(ke):
            raise SystemExit(f"make_snapshot: the run blew up by step "
                             f"{row['steps']} (KE {ke}, latches "
                             f"{row['latches']}); nothing written")
    done += session
    out["equilibrate_s"] = time.time() - t
    out["chunks"] = chunks
    st = ctx.getState(positions=True, velocities=True, energy=True)
    pe = float(st.getPotentialEnergy())
    temp = t_eff(float(st.getKineticEnergy()), n_mol)
    out.update(equil_steps=done, potential_energy=pe, t_eff=temp)
    log(f"[{time.time() - t0:7.1f} s] T_eff {temp:.2f} K, PE {pe:.6e} "
        f"kJ/mol")
    if not (np.isfinite(pe) and T_EFF_BAND[0] < temp < T_EFF_BAND[1]):
        raise SystemExit(f"make_snapshot: not equilibrated: T_eff "
                         f"{temp:.1f} K (band {T_EFF_BAND}), PE {pe}; "
                         f"nothing written")
    pos = np.asarray(st.getPositions(), dtype=np.float32)
    vel = np.asarray(st.getVelocities(), dtype=np.float32)
    del ctx, integ, st

    # a fresh Context, as bench_context builds one but at auto capacity,
    # from the positions and velocities as written: the capacity its
    # growths settle at is the snapshot's
    t = time.time()
    ctx2, integ2, _ = _context(args, device, precision)
    cap0 = ctx2._cp_cfg.capacity
    ctx2.setPositions(np.asarray(pos, np.float64))
    ctx2.setVelocities(np.asarray(vel, np.float64))
    integ2.step(SETTLE_STEPS)
    _sync(device)
    capacity = int(ctx2._cp_cfg.capacity)
    latches = measure_drift.latches(ctx2)
    out.update(settle_s=time.time() - t, capacity_auto=cap0,
               capacity=capacity, settle_latches=latches,
               settled_grid=list(ctx2._cp_cfg.grid))
    log(f"[{time.time() - t0:7.1f} s] a fresh Context's capacity "
        f"{cap0} -> {capacity} in {SETTLE_STEPS} steps; grid "
        f"{tuple(ctx2._cp_cfg.grid)}, latches {latches}")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    tmp = args.out + ".tmp.npz"
    np.savez_compressed(tmp, positions=pos, velocities=vel,
                        n_atoms=np.int64(args.atoms),
                        equil_steps=np.int64(done),
                        potential_energy=np.float64(pe),
                        capacity=np.int64(capacity))
    os.replace(tmp, args.out)
    out["bytes"] = os.path.getsize(args.out)
    log(f"[{time.time() - t0:7.1f} s] wrote {args.out} ({out['bytes']} "
        f"bytes)")

    best = None
    for _ in range(3 if TIMED_STEPS > 0 else 0):
        _sync(device)
        t = time.time()
        integ2.step(TIMED_STEPS)
        _sync(device)
        wall = time.time() - t
        best = wall if best is None else min(best, wall)
    if best is not None:
        from openmm_drudenose_tpu_torch.units import ns_per_day
        out["ms_step"] = best / TIMED_STEPS * 1e3
        out["ns_day"] = ns_per_day(TIMED_STEPS / best,
                                   integ2.getStepSize())
        log(f"[{time.time() - t0:7.1f} s] the fresh Context: "
            f"{out['ms_step']:.3f} ms/step, {out['ns_day']:.4f} ns/day "
            f"(the best of 3 x {TIMED_STEPS} steps, host clock)")
    out["seconds"] = time.time() - t0
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("make_snapshot: no CUDA device (the tool runs on the card)",
              file=sys.stderr)
        return 1
    card = measure_drift.card_line()
    print(card, flush=True)
    out = make(args, "cuda")
    print(json.dumps({"card": card, **out}), flush=True)
    if any(out["settle_latches"].values()):
        print(f"make_snapshot: the fresh Context latched "
              f"{out['settle_latches']}: {args.out} needs more "
              "equilibration (run again to extend it)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
