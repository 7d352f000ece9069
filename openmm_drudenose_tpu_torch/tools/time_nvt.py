#!/usr/bin/env python3
"""Time the port's two NVT cells on one CUDA card, from any tree of the
repository: the 100k water step of chip_smoke.py phase 3 and the 64 x 4k
flat ensemble of phase 10, by their own protocols, and kernel B1's
whole-grid launches on phase 3's fields.

    python3 openmm_drudenose_tpu_torch/tools/time_nvt.py --root TREE \\
        [--cells 100k,flat,b1] [--label NAME] [--out DIR]

TREE is a checkout of the repository (an unpacked `git archive` of
another commit, say): its own package is imported and its own kernels
are built, so two commits are compared on one card in one call (run
them in turns: A, B, B, A).  The script imports nothing from the tree it
lives in.  Each cell prints one line and the script ends with one JSON
line (the card's name and power limit, ms/step of each timed run); with
--out it also writes that JSON to DIR/NAME.json.

  100k: data/bench_equil_100k.npz (100,000 atoms of SWM4-NDP water,
        capacity pinned from the snapshot), DrudeTGNHIntegrator(300,
        0.1, 1, 0.1, 0.001, 20, 1) with a 0.02 nm wall, single
        precision; one force pass and 16 warm-up steps, then
        REPEATS_100K runs of STEPS_100K steps, each closed by
        torch.cuda.synchronize() (phase 3 times one run of 100 after
        its kernel checks).
  flat: build_water_box(800) on the dense strategy settled 500 steps,
        restarted with a fresh chain and settled 500 more,
        FlatReplicaEnsemble(tpl, 64, seed=7), fresh 300 K velocities,
        128 settling steps, then 3 runs of 128 (phase 10's protocol; it
        reports the best).
  b1:   the 100k cell's Context after one force pass and 16 steps; B1's
        force and energy instantiations on its fields over the whole
        grid (the chip_smoke.py phase 3 arguments), device ms a call by
        CUDA events over B1_REPS calls, B1_REPEATS times each (ms a
        call, not a step).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

STEPS_100K, REPEATS_100K = 100, 3
FLAT_MOL, FLAT_REPLICAS, FLAT_SETTLE = 800, 64, 500
FLAT_WARM, FLAT_STEPS, FLAT_REPEATS = 128, 128, 3
B1_REPS, B1_REPEATS = 50, 5


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi gave no answer"


def integrator(dt):
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    return integ


def timed(torch, fn, n_steps, repeats):
    """ms/step of `repeats` runs of fn(n_steps), each closed by a
    synchronize."""
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(n_steps)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / n_steps * 1e3)
    return out


def context_100k(root, dt):
    from openmm_drudenose_tpu_torch.io import builders
    snap = np.load(os.path.join(root, "data", "bench_equil_100k.npz"))
    n = int(snap["n_atoms"])
    system, _ = builders.build_water_box(n // 5)
    integ = integrator(dt)
    ctx = dt.Context(system, integ, precision="single",
                     nb_options={"capacity": int(snap["capacity"])},
                     device="cuda")
    ctx.setPositions(np.asarray(snap["positions"], np.float64))
    ctx.setVelocities(np.asarray(snap["velocities"], np.float64))
    ctx._ensure_forces()
    integ.step(16)
    return ctx, integ


def cell_100k(root, dt, torch):
    _, integ = context_100k(root, dt)
    return timed(torch, integ.step, STEPS_100K, REPEATS_100K)


def events_ms(torch, fn, reps):
    """Mean device ms of fn() over `reps` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cell_b1(root, dt, torch):
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.ops import sweep
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
    ctx, _ = context_100k(root, dt)
    st, nb, cfg = ctx._state, ctx._nb, ctx._cp_cfg
    box = torch.diagonal(st.box)
    args = (nb.fields(st.positions, box, st.neighbors), cfg,
            cellpair.offset_shifts(cfg, box), nb.alpha, ONE_4PI_EPS0)
    out = {}
    for name, fn in (("b1_forces", sweep.pair_forces),
                     ("b1_energy", sweep.pair_energy)):
        out[name] = [events_ms(torch, lambda: fn(*args), B1_REPS)
                     for _ in range(B1_REPEATS)]
    return out


def cell_flat(dt, torch):
    from openmm_drudenose_tpu_torch.io import builders
    system, pos = builders.build_water_box(FLAT_MOL)
    integ = integrator(dt)
    tpl = dt.Context(system, integ, precision="single", device="cuda")
    tpl.setPositions(pos)
    tpl.setVelocitiesToTemperature(300.0, seed=0)
    integ.step(FLAT_SETTLE)
    settled = (tpl._state.positions.double()
               + tpl._state.pos_err.double()).cpu().numpy()
    tpl.reinitialize(preserveState=False)
    tpl.setPositions(settled)
    tpl.setVelocitiesToTemperature(300.0, seed=1)
    integ.step(FLAT_SETTLE)
    ens = dt.FlatReplicaEnsemble(tpl, FLAT_REPLICAS, seed=7)
    ens.setVelocitiesToTemperature(300.0, seed=3)
    ens.step(FLAT_WARM)
    return timed(torch, ens.step, FLAT_STEPS, FLAT_REPEATS)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--cells", default="100k,flat")
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_nvt: no CUDA card")
    import openmm_drudenose_tpu_torch as dt
    pkg = os.path.dirname(os.path.abspath(dt.__file__))
    if os.path.dirname(pkg) != root:
        sys.exit(f"time_nvt: imported {pkg}, not the tree's own package")
    label = args.label or os.path.basename(root)
    result = {"label": label, "root": root, "card": card_line(),
              "ms_per_step": {}, "ms_per_call": {}}
    for cell in args.cells.split(","):
        t0 = time.time()
        if cell == "b1":
            calls = cell_b1(root, dt, torch)
            result["ms_per_call"].update(calls)
            for name, ms in calls.items():
                print(f"[time_nvt {label}] {name}: "
                      + ", ".join(f"{v:.4f}" for v in ms)
                      + f" ms/call (best {min(ms):.4f}) on "
                      f"{result['card']}", flush=True)
            continue
        if cell == "100k":
            ms = cell_100k(root, dt, torch)
        elif cell == "flat":
            ms = cell_flat(dt, torch)
        else:
            sys.exit(f"time_nvt: unknown cell {cell!r}")
        result["ms_per_step"][cell] = ms
        print(f"[time_nvt {label}] {cell}: "
              + ", ".join(f"{v:.3f}" for v in ms)
              + f" ms/step (best {min(ms):.3f}) in {time.time() - t0:.1f} s"
              f" on {result['card']}", flush=True)
    print(json.dumps(result), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"{label}.json"), "w") as f:
            json.dump(result, f)


if __name__ == "__main__":
    main()
