"""The 1M-atom TGNH step over torch.distributed ranks, work-sharded or
state-resident: the counterpart of the JAX package's scripts/dryrun_1m.py.

    python3 -m openmm_drudenose_tpu_torch.tools.dryrun_1m --ranks 8 \\
        [--resident] [--backend gloo|nccl] [--steps 32] [--mol N] \\
        [--cap C] [--rc R] [--ec E] [--snapshot PATH] [--json PATH]
    python3 -m openmm_drudenose_tpu_torch.tools.dryrun_1m --refusals

Each rank builds the JAX script's Context: build_water_box(mol)
(SWM4-NDP water, PME at 1.0 nm), the bench integrator
(tools/setups.py::bench_integrator), single precision, the cell-pair
strategy, nb_options {"grid_x_multiple": ranks} (the grid's x a
multiple of the ranks: 1M atoms give (32, 33, 33), window 2, 4 planes a
slab at 8 ranks) and "capacity" (--cap, else the snapshot's).  It starts
from the snapshot (data/bench_equil_1m.npz, 200,000 molecules) or, with
--mol other than the snapshot's, from build_water_box's lattice with
300 K velocities (seed 0), as the JAX script starts.  Without --resident
the ranks step a ShardedContext (parallel/sharded.py: the state whole on
every rank, B1 on the rank's x-slab of cells, the int64 PME grid
all-reduced); with --resident a ResidentContext(ctx, mesh, Rc, Ec)
(parallel/resident.py: each rank's molecules, B1 on its slab and w + 2
halo planes; Rc, Ec the JAX defaults unless given), the set-up Context
freed before the steps.  The ranks share one card over gloo (cuda:0);
NCCL runs one rank a card.

Checks: B1 on rank 0's slab (or its resident block) against its plain
version (2e-5 of max|F|, two launches bit-identical; timed on the card
with its bound, tools/bounds.py); --steps steps (32: two rebuild blocks)
with the launch counts set to 0 just before and read just after (B1's
slab or resident launches, no plain sweep on the card); the ranks'
gathered positions finite and, after the ranks have ended, within
REF_TOL nm of a single float64 Context stepped alike on the card;
latches clear.  It prints each rank's Context build seconds, memory
held and peak (torch.cuda.max_memory_allocated), molecules owned and
migrated, the grid and window, and ms/step, which is no scaling figure:
the ranks time-share one card.  The last line is a JSON summary; exit 0
when every check held.  On the CUDA card only (exit 1 without one).

--refusals prints, from the plans alone (no Context, no card), which
(atoms, ranks) each engine refuses and why: the water box at 1.0 nm,
x-slabs of grid_x_multiple = ranks (ROADMAP.md F4).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch

from openmm_drudenose_tpu_torch.parallel import comm
from openmm_drudenose_tpu_torch.tools import measure_drift, setups

SNAPSHOT_1M = os.path.join(setups.ROOT, "data", "bench_equil_1m.npz")
# phases 18-19's limits: B1 against its plain version (of max|F|), the
# gathered positions against the single f64 Context (nm)
KERNEL_TOL = 2e-5
REF_TOL = 1e-4
TIMEOUT_S = 900.0


def make_spec(mol, shape=(1, 1, 1), cutoff=1.0, cap=None, rc=None,
              ec=None, steps=32, engines=("sharded",), snapshot=None,
              start=None, precision="single") -> dict:
    """What every rank builds and runs (picklable): build_water_box(mol,
    cutoff, shape) at the capacity `cap` (None: the plan's), started from
    `start` ((positions, velocities)), else the snapshot file, else the
    lattice at 300 K; each of `engines` in turn, `steps` steps, the
    resident engine's Rc and Ec (None: the JAX defaults)."""
    return {"mol": int(mol), "shape": tuple(shape), "cutoff": cutoff,
            "cap": cap, "rc": rc, "ec": ec, "steps": int(steps),
            "engines": list(engines), "snapshot": snapshot, "start": start,
            "precision": precision}


def spec_from_args(args) -> dict:
    """The command line's spec."""
    snap = args.snapshot if os.path.exists(args.snapshot) else None
    n_snap = None
    cap = args.cap
    if snap is not None:
        with np.load(snap) as z:
            n_snap = int(z["n_atoms"]) // 5
            cap_snap = int(z["capacity"])
    mol = args.mol if args.mol is not None else n_snap
    if mol is None:
        raise SystemExit(f"dryrun_1m: no snapshot at {args.snapshot}; "
                         "give --mol for a lattice start")
    start = snap if mol == n_snap else None
    if start is not None and cap is None:
        cap = cap_snap
    return make_spec(mol, cap=cap, rc=args.rc, ec=args.ec,
                     steps=args.steps,
                     engines=["resident" if args.resident else "sharded"],
                     snapshot=start)


def build(spec, device, precision, ranks=1):
    """(ctx, integ): the Context of the spec on `device` in `precision`,
    its grid's x a multiple of `ranks`, at its start."""
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.io import builders
    system, lattice = builders.build_water_box(
        spec["mol"], cutoff=spec["cutoff"], shape=spec["shape"])
    integ = setups.bench_integrator()
    opts = {"grid_x_multiple": ranks}
    if spec["cap"] is not None:
        opts["capacity"] = spec["cap"]
    ctx = dt.Context(system, integ, precision=precision, device=device,
                     strategy="cellpair", nb_options=opts)
    if spec["start"] is not None:
        ctx.setPositions(spec["start"][0])
        ctx.setVelocities(spec["start"][1])
    elif spec["snapshot"] is None:
        ctx.setPositions(lattice)
        ctx.setVelocitiesToTemperature(300.0, seed=0)
    else:
        with np.load(spec["snapshot"]) as z:
            ctx.setPositions(np.asarray(z["positions"], np.float64))
            ctx.setVelocities(np.asarray(z["velocities"], np.float64))
    return ctx, integ


def exact_positions(ctx) -> np.ndarray:
    """The Context's positions in float64 with the float32 compensation."""
    st = ctx._state
    p = st.positions.double()
    if st.pos_err is not None:
        p = p + st.pos_err.double()
    return p.cpu().numpy()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _memory(device):
    if torch.device(device).type != "cuda":
        return None, None
    return torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()


def _kernel(args, kw, cells, time_it, bound_args):
    """B1 (sweep.pair_forces with kw) against its plain version, twice
    for the bits; on the card, on the rank with time_it while the others
    wait (every rank calls it), its ms, the plain ms, the bound
    (bound_args: fields, cfg, shifts of the function's work, the home
    cells `cells`) and the registers."""
    import torch.distributed as dist
    from openmm_drudenose_tpu_torch.ops import sweep
    from openmm_drudenose_tpu_torch.tools import bounds
    kw_plain = {k: v for k, v in kw.items() if k != "resident"}
    f_k = sweep.pair_forces(*args, **kw)
    f_k2 = sweep.pair_forces(*args, **kw)
    f_p = sweep.pair_forces_plain(*args, **kw_plain)
    scale = float(torch.max(torch.abs(f_p)))
    out = {"err": float(torch.max(torch.abs(f_k - f_p))) / scale,
           "max_abs": float(torch.max(torch.abs(f_k - f_p))),
           "bits": bool(torch.equal(f_k, f_k2))}
    del f_k, f_k2, f_p
    dist.barrier()
    if time_it and args[0]["x"].device.type == "cuda":
        out["ms"] = bounds.cuda_time_ms(
            lambda: sweep.pair_forces(*args, **kw), 20)
        out["plain_ms"] = bounds.cuda_time_ms(
            lambda: sweep.pair_forces_plain(*args, **kw_plain), 1)
        (out["bound_ms"], out["bound_by"], n_tests, n_cut,
         n_bytes) = bounds.sweep_bound(*bound_args, cells=cells)
        out["work"] = [n_tests, n_cut, n_bytes]
        out["regs"] = sweep.attributes()["regs"]
    dist.barrier()
    return out


def _run_engine(spec, engine, mesh) -> dict:
    """One rank's run of `engine` ("sharded" or "resident"): build, the
    B1 check, spec["steps"] steps counted; its figures (rank 0's
    gathered positions under "positions")."""
    import torch.distributed as dist
    from openmm_drudenose_tpu_torch.constraints.vsites import apply_vsites
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.ops import sweep
    from openmm_drudenose_tpu_torch.parallel import resident, sharded
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
    n, rank, dev = mesh.size("atom"), mesh.rank, mesh.device
    out = {"rank": rank, "engine": engine}
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.time()
    ctx, integ = build(spec, dev, spec["precision"], n)
    ctx._ensure_forces()
    _sync(dev)
    out["build_s"] = time.time() - t
    out["mem_context"] = _memory(dev)
    nb, cfg, st = ctx._nb, ctx._cp_cfg, ctx._state
    out.update(grid=list(cfg.grid), window=list(cfg.window),
               capacity=cfg.capacity, offsets=cfg.n_offsets,
               pme_grid=list(nb.pme.grid), route=nb.sweep_kernel)
    box_t = ctx._box_arg(st.box)
    # the function's work for the bound: the grid's half stencil over
    # the rank's home cells, on the single Context's fields
    fields = nb.fields(apply_vsites(ctx._spec, ctx._static, st.positions),
                       box_t, st.neighbors,
                       ctx._exact_positions(st.positions, st.pos_err))
    shifts = cellpair.offset_shifts(cfg, box_t)
    alpha = nb.alpha
    if engine == "resident":
        t = time.time()
        eng = resident.ResidentContext(ctx, mesh, Rc=spec["rc"],
                                       Ec=spec["ec"])
        eng._rebuild()
        out["setup_s"] = time.time() - t
        lay = eng._layout
        out["layout"] = {"Rc": lay.Rc, "Ec": lay.Ec, "loc_x": lay.loc_x,
                         "block": list(eng._bcfg.grid),
                         "block_offsets": eng._bcfg.n_offsets}
        rs = eng._state
        block, bcfg, bshifts, bkw = eng.block_inputs(
            rs.positions, rs.pos_err, torch.diagonal(rs.box))
        out["kernel"] = _kernel(
            (block, bcfg, bshifts, alpha, ONE_4PI_EPS0),
            dict(bkw, resident=True), (0, eng._halo.n_loc), rank == 0,
            (fields, cfg, shifts))
        owned0 = set(eng._mol_base[:int(eng.state["n_mol"])].tolist())
        # the set-up Context is freed: the rank holds its molecules alone
        del block, ctx, integ, fields, st, nb, box_t, shifts
        gc.collect()
        eng._loc = None
    else:
        eng = sharded.ShardedContext(ctx, mesh)
        cells = sharded._span(cfg.n_cells, n, rank)
        kw = dict(excl_skip=nb.excl_skip, cells=cells, **nb.coulomb)
        out["kernel"] = _kernel((fields, cfg, shifts, alpha, ONE_4PI_EPS0),
                                kw, cells, rank == 0, (fields, cfg, shifts))
        del fields
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    for k in sweep.launches:
        sweep.launches[k] = 0
    cellpair.plain_sweeps["cuda"] = 0
    _sync(dev)
    out["mem_before"] = _memory(dev)[0]
    comm.all_reduce_sum(mesh, "atom", torch.zeros(1))
    t = time.time()
    eng.step(spec["steps"])
    _sync(dev)
    out["ms_step"] = (time.time() - t) / spec["steps"] * 1e3
    out["mem_peak"] = _memory(dev)[1]
    out["launches"] = {k: v for k, v in sweep.launches.items() if v}
    out["plain"] = cellpair.plain_sweeps["cuda"]
    if engine == "resident":
        pos = eng.positions(compensated=True)      # a gather: every rank
        stt = eng.state
        n_mol = int(stt["n_mol"])
        owned = set(eng._mol_base[:n_mol].tolist())
        out.update(owned=n_mol, migrated_in=len(owned - owned0),
                   migrated_out=len(owned0 - owned),
                   latches=[k for k in ("mig_overflow", "cs_overflow",
                                        "stencil", "stray", "excl_span",
                                        "drift") if bool(stt[k])])
    else:
        pos = exact_positions(ctx)
        out.update(owned=spec["mol"], migrated_in=0, migrated_out=0,
                   latches=[k for k, v in measure_drift.latches(ctx).items()
                            if v])
    out["finite"] = bool(np.all(np.isfinite(pos)))
    out["positions"] = pos if rank == 0 else None
    del eng
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return out


def rank_run(spec) -> dict:
    """Each engine of spec["engines"] in turn on this rank (run by
    parallel/comm.py::launch); {engine: its figures}, and the host clock
    when the rank began ("started") and each engine's seconds."""
    started = time.time()
    mesh = comm.Mesh(("atom",))
    out = {"started": started}
    for e in spec["engines"]:
        t = time.time()
        out[e] = _run_engine(spec, e, mesh)
        out[e]["seconds"] = time.time() - t
    return out


def reference(spec, device) -> np.ndarray:
    """The single float64 Context of the spec stepped spec["steps"]
    steps: its compensated positions."""
    ctx, integ = build(spec, device, "double")
    integ.step(spec["steps"])
    pos = exact_positions(ctx)
    del ctx, integ
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return pos


def check(res, ref, spec, on_card=True) -> dict:
    """The checks of one engine's run over the ranks' results `res` and
    the reference positions `ref` (the launch counts only on the card,
    where the kernels launch)."""
    r0 = res[0]
    key = ("b1_sweep_res" if r0["engine"] == "resident"
           else "b1_sweep_slab")
    dx = float(np.max(np.abs(r0["positions"] - ref)))
    return {
        "kernel": all(r["kernel"]["err"] <= KERNEL_TOL
                      and r["kernel"]["bits"] for r in res),
        "launches": not on_card or all(
            r["launches"].get(key, 0) >= spec["steps"] and not r["plain"]
            for r in res),
        "finite": all(r["finite"] for r in res),
        "latches": not any(r["latches"] for r in res),
        "molecules": sum(r["owned"] for r in res) == spec["mol"]
        if r0["engine"] == "resident" else True,
        "reference": dx <= REF_TOL, "dx": dx}


def passed(ok: dict) -> bool:
    return all(v for k, v in ok.items() if k != "dx")


def _mib(b):
    return "n/a" if b is None else f"{b / 2 ** 20:.1f}"


def report(res, ok, spec, card="", log=print) -> None:
    """Each rank's line, rank 0's B1 line and the checks of one engine's
    run."""
    engine = res[0]["engine"]
    for r in res:
        held = r["mem_context"][0]
        log(f"rank {r['rank']} ({engine}): Context built in "
            f"{r['build_s']:.1f} s, {_mib(held)} MiB held after its force "
            f"pass, {_mib(r['mem_before'])} MiB before the steps, peak "
            f"{_mib(r['mem_peak'])} MiB in them; grid {tuple(r['grid'])}, "
            f"window {tuple(r['window'])}, capacity {r['capacity']}; "
            f"molecules owned {r['owned']}, migrated in "
            f"{r['migrated_in']} / out {r['migrated_out']}; "
            f"{r['ms_step']:.2f} ms/step (ranks time-sharing one card, not "
            f"a scaling figure); launches {r['launches']}; latches "
            f"{r['latches']}")
    k = res[0]["kernel"]
    what = ("resident block " + str(tuple(res[0]["layout"]["block"]))
            if engine == "resident" else "x-slab of cells")
    line = (f"{engine}: B1 on rank 0's {what} against its plain version: "
            f"{max(r['kernel']['err'] for r in res):.3e} of max|F| (max "
            f"|dF| {k['max_abs']:.3e}), two launches bit-identical "
            f"{all(r['kernel']['bits'] for r in res)}")
    if "ms" in k:
        line += (f"; {k['ms']:.4f} ms, plain {k['plain_ms']:.3f} ms, bound "
                 f"{k['bound_ms']:.4f} ms ({k['bound_by']}: {k['work'][0]} "
                 f"pair tests, {k['work'][1]} inside the cutoff, "
                 f"{k['work'][2]} bytes), {k['regs']} registers {card}")
    log(line)
    log(f"{engine}: after {spec['steps']} steps rank 0's gathered positions "
        f"against the single f64 Context: max |dx| {ok['dx']:.3e} nm "
        f"(limit {REF_TOL}); checks {ok}")


def refusal(n_mol, ranks, engine, cutoff=1.0, shape=(1, 1, 1),
            capacity=None):
    """Why `engine` ("sharded" or "resident") refuses build_water_box(
    n_mol) over `ranks` x-slabs at `cutoff`, from the plan alone (the
    checks the engines make: parallel/sharded.py::ShardedForcePass.check,
    parallel/resident.py::check_plan, B1's limits); None where it takes
    it."""
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.io import builders
    from openmm_drudenose_tpu_torch.ops import sweep
    from openmm_drudenose_tpu_torch.parallel import domain, resident
    _, _, box = builders.water_box_lattice(n_mol, shape=shape)
    try:
        # one molecule's exclusions span its 5 sites
        cfg = cellpair.make_config(cutoff, box, 5 * n_mol, [0], [4],
                                   capacity=capacity,
                                   grid_x_multiple=ranks)
        if engine == "sharded":
            if cfg.n_cells % ranks or cfg.grid[0] % ranks:
                return f"grid {cfg.grid} does not divide into {ranks} slabs"
            bcfg = cfg
        else:
            resident.check_plan(cfg, ranks)
            w = (cfg.window[0] + 2,) + tuple(cfg.window[1:])
            bcfg = domain.block_config(cfg, ranks, w,
                                       resident.resident_offsets(cfg))
    except ValueError as err:
        return str(err)
    if not sweep.b1_takes(bcfg):
        return f"B1 does not take the {engine} block {bcfg.grid}"
    return None


def refusals(atoms=(100_000, 200_000, 400_000, 800_000, 910_000,
                    1_000_000, 2_000_000, 8_000_000),
             ranks=(2, 3, 4, 8, 16), log=print) -> dict:
    out = {}
    for n_atoms in atoms:
        for r in ranks:
            for engine in ("sharded", "resident"):
                why = refusal(n_atoms // 5, r, engine)
                out[(n_atoms, r, engine)] = why
                if why is not None:
                    log(f"{n_atoms} atoms, {r} ranks: {engine} refuses: "
                        f"{why}")
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--resident", action="store_true")
    ap.add_argument("--mol", type=int, default=None,
                    help="molecules (default: the snapshot's); another "
                         "count starts from the lattice")
    ap.add_argument("--cap", type=int, default=None,
                    help="cell capacity (default: the snapshot's, or auto)")
    ap.add_argument("--rc", type=int, default=None,
                    help="resident molecule slots a rank (the JAX default)")
    ap.add_argument("--ec", type=int, default=None,
                    help="resident emigrants a direction (the JAX default)")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--snapshot", default=SNAPSHOT_1M)
    ap.add_argument("--json", default=None,
                    help="also write the summary and each rank's figures "
                         "there")
    ap.add_argument("--refusals", action="store_true",
                    help="print the (atoms, ranks) each engine refuses, "
                         "from the plans, and exit")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.refusals:
        found = refusals()
        print(json.dumps({"refused": {f"{a} atoms, {r} ranks, {e}": why
                                      for (a, r, e), why in found.items()
                                      if why is not None},
                          "taken": sum(why is None
                                       for why in found.values())}),
              flush=True)
        return 0
    if not torch.cuda.is_available():
        print("dryrun_1m: no CUDA device (the tool runs on the card)",
              file=sys.stderr)
        return 1
    card = measure_drift.card_line()
    print(card, flush=True)
    if args.backend == "nccl" and args.ranks > torch.cuda.device_count():
        print(f"dryrun_1m: nccl runs one rank a card: {args.ranks} ranks, "
              f"{torch.cuda.device_count()} cards", file=sys.stderr)
        return 1
    spec = spec_from_args(args)
    engine = spec["engines"][0]
    why = refusal(spec["mol"], args.ranks, engine, spec["cutoff"],
                  spec["shape"], spec["cap"])
    print(f"dryrun_1m: {spec['mol'] * 5} atoms over {args.ranks} "
          f"{args.backend} ranks, {engine}, {spec['steps']} steps, from "
          f"{spec['snapshot'] or 'the lattice'}; the plan's refusal: {why}",
          flush=True)
    t = time.time()
    device = "cuda:0" if args.backend == "gloo" else "cuda"
    res = [r[engine] for r in comm.launch(
        rank_run, args.ranks, args.backend, device, TIMEOUT_S,
        args=(spec,))]
    ranks_s = time.time() - t
    t = time.time()
    ref = reference(spec, "cuda")
    ref_s = time.time() - t
    ok = check(res, ref, spec)
    report(res, ok, spec, f"on {card}")
    summary = {"card": card, "atoms": spec["mol"] * 5, "ranks": args.ranks,
               "backend": args.backend, "engine": engine,
               "steps": spec["steps"], "ranks_s": ranks_s,
               "reference_s": ref_s, "ok": passed(ok), "checks": ok,
               "per_rank": [{k: v for k, v in r.items() if k != "positions"}
                            for r in res]}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "per_rank"}), flush=True)
    return 0 if passed(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
