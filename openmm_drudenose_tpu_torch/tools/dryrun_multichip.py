"""Drive the port's multi-rank paths end to end on N torch.distributed
ranks: the counterpart of the JAX package's __graft_entry__.py::
dryrun_multichip (:38, :80-191).

    python -m openmm_drudenose_tpu_torch.tools.dryrun_multichip \\
        --ranks 3 --backend gloo [--device cuda|cpu]

  part 1   the work-sharded TGNH step (parallel/sharded.py::
           ShardedContext): SWM4-NDP water, PME at cutoff 0.7, single
           precision, the cell-pair sweep in x-slabs over the ranks, the
           PME spread by atom chunks, one step; the ranks' positions the
           same bits.  The JAX dryrun's 48 molecules (a 1.13 nm box,
           under twice that cutoff) have no cell grid the port's sweep
           takes (2 cells of window 2), so the box is the smallest whose
           grid splits into N
           x-slabs (nb_options grid_x_multiple = N);
  part 1b  the state-resident decomposition (parallel/resident.py::
           ResidentContext) at the JAX dryrun's sizes: 216 waters in the
           elongated (8, 1, 1) box at density 3.375 (40 x-planes at
           cutoff 0.7, PME), single precision, grid_x_multiple N, two
           steps: each rank owns an x-slab of molecules, sweeps it and
           its halo on B1, migrates at the rebuild; the ranks' NH chains
           and box the same bits;
  part 2   a replica x atom mesh (2 x N/2, or 1 x N for odd N): a
           ReplicaEnsemble of 32 molecules (CutoffPeriodic, cutoff 0.9,
           the dense strategy), each replica group's force pass split over
           its atom ranks, one step;
  part 2b  flat sub-ensembles over a ("replica",) mesh of N: a
           FlatReplicaEnsemble of two replicas of 200 molecules (PME,
           cutoff 0.55, capacity 48, skin 0.1) on every rank, N x 2
           replicas, two steps.

--device cuda (the default) puts rank r on card r mod the card count,
and fails where there is no card; --device cpu runs the ranks on the
CPU, asked for explicitly.  Several ranks
share one card over gloo only (NCCL refuses two ranks on one device, so
NCCL runs one rank a card).  The last line is a JSON summary; the exit
code is 0 when parts 1, 1b, 2 and 2b passed.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from ..parallel import comm


def _integrator(wall: float = 0.02):
    from ..app.integrator import DrudeTGNHIntegrator
    integ = DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005, 0.001, 20, 2)
    integ.setMaxDrudeDistance(wall)
    return integ


def part1_molecules(n_ranks: int, cutoff: float = 0.7,
                    skin: float = 0.1) -> int:
    """Molecules of the smallest water box whose cell grid (cells of
    r_list / 2) has a multiple of n_ranks x-planes and at least the 5 a
    regular grid needs at window 2."""
    gx = max(5, -(-5 // n_ranks) * n_ranks)
    side = gx * (cutoff + skin) / 2.0 * 1.02
    return int(math.ceil(33.4 * side ** 3))


def _part1(mesh, n_ranks):
    import openmm_drudenose_tpu_torch as dt
    from ..io import builders
    from ..parallel import sharded
    system, positions = builders.build_water_box(
        part1_molecules(n_ranks), method=dt.NonbondedForce.PME, cutoff=0.7)
    ctx = dt.Context(system, _integrator(), precision="single",
                     strategy="cellpair", hardwall_strict=False,
                     nb_options={"grid_x_multiple": n_ranks},
                     device=mesh.device)
    ctx.setPositions(positions)
    ctx.applyConstraints(1e-5)
    ctx.setVelocitiesToTemperature(300.0, seed=0)
    sctx = sharded.ShardedContext(ctx, mesh)
    sctx.step(1)
    pos = sctx.state.positions
    same = comm.all_gather(mesh, "atom", pos)
    return {"atoms": ctx._static.n_atoms, "cells": ctx._cp_cfg.n_cells,
            "grid": list(ctx._cp_cfg.grid),
            "finite": bool(torch.all(torch.isfinite(pos))),
            "ranks_identical": bool(all(torch.equal(same[0], p)
                                        for p in same))}


def _part1b(mesh, n_ranks):
    import openmm_drudenose_tpu_torch as dt
    from ..io import builders
    from ..parallel import resident
    system, positions = builders.build_water_box(
        216, method=dt.NonbondedForce.PME, cutoff=0.7, density=3.375,
        shape=(8, 1, 1))
    ctx = dt.Context(system, _integrator(0.05), precision="single",
                     strategy="cellpair", hardwall_strict=False,
                     nb_options={"grid_x_multiple": n_ranks},
                     device=mesh.device)
    ctx.setPositions(positions)
    ctx.applyConstraints(1e-5)
    ctx.setVelocitiesToTemperature(300.0, seed=0)
    rctx = resident.ResidentContext(ctx, mesh)
    rctx.step(2)
    pos = rctx.positions()
    st = rctx.state
    rep = torch.cat([st["eta"].reshape(-1).double(),
                     st["box"].reshape(-1).double().cpu()])
    same = comm.all_gather(mesh, "atom", rep.to(mesh.device))
    return {"atoms": ctx._static.n_atoms, "planes": ctx._cp_cfg.grid[0],
            "molecules": int(comm.all_reduce_sum(
                mesh, "atom", st["n_mol"].reshape(1))[0]),
            "finite": bool(np.all(np.isfinite(pos))),
            "ranks_identical": bool(all(torch.equal(same[0], x)
                                        for x in same))}


def _part2(n_ranks):
    import openmm_drudenose_tpu_torch as dt
    from ..io import builders
    n_rep = 2 if n_ranks % 2 == 0 else 1
    mesh = comm.Mesh(("replica", "atom"), (n_rep, n_ranks // n_rep))
    system, positions = builders.build_water_box(
        32, method=dt.NonbondedForce.CutoffPeriodic, cutoff=0.9)
    ctx = dt.Context(system, _integrator(), precision="single",
                     strategy="dense", device=mesh.device)
    ctx.setPositions(positions)
    ctx.applyConstraints(1e-5)
    ctx.setVelocitiesToTemperature(300.0, seed=0)
    ens = dt.ReplicaEnsemble(ctx, n_replicas=n_rep, mesh=mesh, seed=42)
    ens.step(1)
    pos = ens.positions()
    return {"mesh": [n_rep, n_ranks // n_rep], "atoms": int(pos.shape[1]),
            "finite": bool(np.all(np.isfinite(pos)))}


def _part2b(n_ranks):
    import openmm_drudenose_tpu_torch as dt
    from ..io import builders
    mesh = comm.Mesh(("replica",))
    system, positions = builders.build_water_box(
        200, method=dt.NonbondedForce.PME, cutoff=0.55)
    tctx = dt.Context(system, _integrator(), precision="single",
                      strategy="cellpair", hardwall_strict=False,
                      nb_options={"capacity": 48, "skin": 0.1},
                      device=mesh.device)
    tctx.setPositions(positions)
    flat = dt.FlatReplicaEnsemble(tctx, 2)
    rens = dt.ReplicaEnsemble(flat.context, n_replicas=n_ranks, mesh=mesh,
                              seed=11)
    rens.setVelocitiesToTemperature(300.0, seed=13)
    rens.step(2)
    ke = rens.kinetic_energies()
    return {"replicas": int(ke.size), "ke_shape": list(ke.shape),
            "atoms_per_rank": flat.context._static.n_atoms,
            "finite": bool(np.all(np.isfinite(ke)))}


def dryrun_rank(n_ranks: int):
    """One rank's parts 1, 1b, 2 and 2b, each timed."""
    out = {}
    for name, part in (("1", lambda: _part1(comm.Mesh(("atom",)),
                                            n_ranks)),
                       ("1b", lambda: _part1b(comm.Mesh(("atom",)),
                                              n_ranks)),
                       ("2", lambda: _part2(n_ranks)),
                       ("2b", lambda: _part2b(n_ranks))):
        t = time.time()
        out[name] = part()
        out[name]["seconds"] = time.time() - t
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    n = args.ranks
    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA card here", flush=True)
        return 2
    if args.backend == "nccl" and (args.device != "cuda"
                                   or n > torch.cuda.device_count()):
        print(f"nccl runs one rank a card: {n} ranks, "
              f"{torch.cuda.device_count()} cards", flush=True)
        return 2
    t = time.time()
    res = comm.launch(dryrun_rank, n, args.backend, args.device,
                      args.timeout, args=(n,),
                      threads=1 if args.device == "cpu" else None)
    r0 = res[0]
    ok = {"1": r0["1"]["finite"] and r0["1"]["ranks_identical"],
          "1b": r0["1b"]["finite"] and r0["1b"]["ranks_identical"]
          and r0["1b"]["molecules"] == 216,
          "2": r0["2"]["finite"], "2b": r0["2b"]["finite"]
          and r0["2b"]["ke_shape"] == [n, 2]}
    p1, p1b, p2, p2b = r0["1"], r0["1b"], r0["2"], r0["2b"]
    print(f"dryrun part 1 {'OK' if ok['1'] else 'FAILED'}: work-sharded "
          f"TGNH step over {n} ranks ({p1['atoms']} atoms, {p1['cells']} "
          f"cells {tuple(p1['grid'])} as x-slabs, sharded PME spreading; "
          f"ranks bit-identical {p1['ranks_identical']})", flush=True)
    print(f"dryrun part 1b {'OK' if ok['1b'] else 'FAILED'}: "
          f"state-resident TGNH steps over {n} ranks ({p1b['atoms']} "
          f"atoms, {p1b['planes']} x-planes as {n} slabs of molecules, "
          f"{p1b['molecules']} owned in all; molecule migration + "
          f"halo-exchange sweep; ranks' chains and box bit-identical "
          f"{p1b['ranks_identical']})", flush=True)
    print(f"dryrun part 2 {'OK' if ok['2'] else 'FAILED'}: mesh "
          f"{tuple(p2['mesh'])} (replica x atom), {p2['atoms']} atoms, the "
          f"dense rows split over the atom ranks, 1 TGNH step", flush=True)
    print(f"dryrun part 2b {'OK' if ok['2b'] else 'FAILED'}: flat "
          f"sub-ensembles over a ({n},) replica mesh, {n} x 2 = "
          f"{p2b['replicas']} replicas, {p2b['atoms_per_rank']} atoms a "
          f"rank", flush=True)
    print(json.dumps({"ranks": n, "backend": args.backend,
                      "device": args.device, "parts": ok,
                      "seconds": time.time() - t,
                      "part_seconds": {k: r0[k]["seconds"] for k in ok}}),
          flush=True)
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
