#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

The benchmark configuration of the JAX package's bench.py: 100,000 atoms
of SWM4-NDP water (PME, cell-pair sweep, Drude springs, SETTLE, M sites,
CMMotionRemover) under DrudeTGNHIntegrator(300, 0.1, 1, 0.1, 0.001, 20, 1)
with a 0.02 nm hard wall, single precision, started from
data/bench_equil_100k.npz.  Phases (one flushed line each, with elapsed
seconds):

  0. device: the nvidia-smi name/power-limit line; exits non-zero without
     CUDA, before printing any result
  1. build: nvcc builds kernel B1 (ops/sweep.py, csrc/sweep.cu); prints
     the build seconds and ptxas' register/shared-memory lines
  2. kernel parity at full size: B1 against its plain version (f32, on
     the card, max|dF| / max|F| <= 2e-5) and against the plain version in
     f64 (the f32 floor: max|dF| / max|F| <= 1e-4 over the atoms of pairs
     both precisions put on the same side of the cutoff, rms|dF| / max|F|
     <= 5e-6 over all); B1, plain and the bound timed
  3. the slice: the Context's force pass in f32 against the same pass in
     f64 (the same f32 floor), then 100 steps with the launch counts reset
     just before and read just after; no latch may be set, the hard wall
     must hold, bath temperatures and the conserved energy must be
     finite and plausible; ms/step and ns/day, and the stream time of
     each part of the force pass beside the whole step
  4. the `kernels` JSON line, then the result line.

Imports nothing of JAX or of the JAX package.
"""

import json
import os
import subprocess
import sys
import time

T0 = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, 700 W): float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# B1 operation count: every pair test is a distance and a compare (~9
# float32 ops); every pair inside the cutoff adds the LJ + A&S-erfc force
# and its row/reaction accumulation (~50, counting rsqrt and exp as one)
OPS_PER_TEST = 9
OPS_PER_PAIR = 50


def log(msg):
    print(f"[chip_smoke {time.time() - T0:7.1f}s] {msg}", flush=True)


def fail(msg):
    log(f"FAILED: {msg}")
    sys.exit(1)


def cuda_time_ms(fn, reps):
    """Mean device time of fn() over `reps` calls, by CUDA events."""
    import torch
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


def pair_counts(fields, cfg, shifts):
    """(pair tests, pairs inside the cutoff) that this run's slot data
    gives the sweep: occupied-slot products over the half stencil."""
    import torch
    nc, C = cfg.n_cells, cfg.capacity
    dev = fields["x"].device
    count = fields["count"].long()
    nbr = torch.as_tensor(cfg.nbr_map, device=dev)
    occ = torch.arange(C, device=dev)[None, :] < count[:, None]
    xyz = [fields[k].reshape(nc, C) for k in "xyz"]
    n_tests = int(torch.sum(count * (count - 1)))
    n_cut = 0
    cut2 = cfg.cutoff * cfg.cutoff
    for o in range(cfg.n_offsets):
        b = nbr[:, o]
        r2 = 0
        for d in range(3):
            diff = xyz[d][:, :, None] - (xyz[d][b] + shifts[o, d])[:, None, :]
            r2 = r2 + diff * diff
        ok = (r2 < cut2) & occ[:, :, None] & occ[b][:, None, :]
        if o == 0:
            ok = ok & ~torch.eye(C, dtype=torch.bool, device=dev)
        else:
            n_tests += int(torch.sum(count * count[b]))
        n_cut += int(torch.sum(ok))
    return n_tests, n_cut


def cutoff_flips(fa, fb, cfg, sha, shb):
    """Slots of atoms in a pair that two precisions put on opposite sides
    of the cutoff (r^2 rounds differently within ~1e-7 of cutoff^2; the
    Ewald force there is ~1 kJ/mol/nm for a pair of SWM4 core charges, an
    input-rounding effect no float32 sweep avoids), and their count."""
    import torch
    nc, C = cfg.n_cells, cfg.capacity
    dev = fa["x"].device
    count = fa["count"].long()
    nbr = torch.as_tensor(cfg.nbr_map, device=dev)
    occ = torch.arange(C, device=dev)[None, :] < count[:, None]
    cut2 = cfg.cutoff * cfg.cutoff
    hits = torch.zeros((nc, C), dtype=torch.int64, device=dev)
    n_flip = 0

    def inside(f, sh, b, o):
        r2 = 0
        for d, k in enumerate("xyz"):
            v = f[k].reshape(nc, C)
            diff = v[:, :, None] - (v[b] + sh[o, d])[:, None, :]
            r2 = r2 + diff * diff
        return r2 < cut2

    for o in range(cfg.n_offsets):
        b = nbr[:, o]
        x = (inside(fa, sha, b, o) != inside(fb, shb, b, o)) \
            & occ[:, :, None] & occ[b][:, None, :]
        if o == 0:
            x = x & ~torch.eye(C, dtype=torch.bool, device=dev)
        n_flip += int(torch.sum(x))
        hits += torch.sum(x, dim=2)
        hits.index_add_(0, b, torch.sum(x, dim=1).long())
    return (hits > 0).reshape(-1), n_flip


def f32_floor(got, ref, skip=None):
    """(max, rms) of |got - ref| over max|ref|; the max leaves out the
    rows in `skip` (cutoff flips), the rms takes every row."""
    import torch
    d = got.double() - ref.double()
    scale = float(torch.max(torch.abs(ref)))
    keep = d if skip is None else d[~skip]
    return (float(torch.max(torch.abs(keep))) / scale,
            float(torch.sqrt(torch.mean(d * d))) / scale)


def main():
    # ---- 0. device --------------------------------------------------------
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi gave no answer"
    print(card, flush=True)
    log(f"0 device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np
    sys.path.insert(0, HERE)
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.constraints.vsites import apply_vsites
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.io import builders
    from openmm_drudenose_tpu_torch.ops import sweep
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0, ns_per_day
    if "jax" in sys.modules or "openmm_drudenose_tpu" in sys.modules:
        fail("the port pulled in JAX or the JAX package")

    # ---- 1. build ----------------------------------------------------------
    t = time.time()
    sweep.build()
    build_s = time.time() - t
    ptxas = [ln.strip() for ln in sweep.build_log.splitlines()
             if "registers" in ln or "smem" in ln or "spill" in ln]
    log(f"1 build: B1 built by nvcc in {build_s:.1f} s")
    for ln in ptxas:
        log(f"  {ln}")

    # ---- 2. kernel parity at full size -----------------------------------
    snap = np.load(os.path.join(HERE, "data", "bench_equil_100k.npz"))
    n_atoms = int(snap["n_atoms"])
    cap = int(snap["capacity"])
    pos = np.asarray(snap["positions"], np.float64)
    vel = np.asarray(snap["velocities"], np.float64)
    system, _ = builders.build_water_box(n_atoms // 5)

    def make_ctx(precision):
        integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        integ.setMaxDrudeDistance(0.02)
        ctx = dt.Context(system, integ, precision=precision,
                         nb_options={"capacity": cap}, device="cuda")
        ctx.setPositions(pos)
        ctx.setVelocities(vel)
        return ctx, integ

    ctx, integ = make_ctx("single")
    ctx._ensure_neighbors()
    nb, cfg, st = ctx._nb, ctx._cp_cfg, ctx._state
    box_diag = torch.diagonal(st.box)
    log(f"2 context: {n_atoms} atoms, cell grid {cfg.grid}, capacity "
        f"{cfg.capacity}, {cfg.n_offsets} offsets, PME grid "
        f"{nb.pme.grid}, alpha {nb.alpha:.6f}")
    fields = nb.fields(st.positions, box_diag, st.neighbors)
    shifts = cellpair.offset_shifts(cfg, box_diag)
    args = (fields, cfg, shifts, nb.alpha, ONE_4PI_EPS0)
    f_k = sweep.pair_forces(*args)
    torch.cuda.synchronize()
    f_p = sweep.pair_forces_plain(*args)
    scale = float(torch.max(torch.abs(f_p)))
    err_plain = float(torch.max(torch.abs(f_k - f_p))) / scale
    max_abs_err = float(torch.max(torch.abs(f_k - f_p)))
    f64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in fields.items()}
    f_p64 = sweep.pair_forces_plain(f64, cfg, shifts.double(), nb.alpha,
                                    ONE_4PI_EPS0)
    flips, n_flip = cutoff_flips(fields, f64, cfg, shifts, shifts.double())
    err64_all, _ = f32_floor(f_k, f_p64)
    err64, rms64 = f32_floor(f_k, f_p64, flips)
    log(f"2 B1 vs plain f32: max|dF|/max|F| = {err_plain:.3e} "
        f"(max|F| {scale:.1f}); vs plain f64: max {err64:.3e} "
        f"({err64_all:.3e} with the {int(flips.sum())} atoms of "
        f"{n_flip} cutoff-flipped pairs), rms {rms64:.3e}")
    if not (np.isfinite(err_plain) and err_plain <= 2e-5):
        fail(f"B1 disagrees with its plain version: {err_plain:.3e}")
    if not (err64 <= 1e-4 and rms64 <= 5e-6):
        fail(f"B1 misses the f32 floor against f64: max {err64:.3e}, "
             f"rms {rms64:.3e}")
    del f64, f_p64
    ms = cuda_time_ms(lambda: sweep.pair_forces(*args), 20)
    plain_ms = cuda_time_ms(lambda: sweep.pair_forces_plain(*args), 3)
    n_tests, n_cut = pair_counts(fields, cfg, shifts)
    n_slots = cfg.n_cells * cfg.capacity
    n_bytes = (n_slots * (8 * 4 + 3 * 4) + cfg.n_cells * 4
               + cfg.n_cells * cfg.n_offsets * 4 + cfg.n_offsets * 16)
    t_ops = (OPS_PER_TEST * n_tests + OPS_PER_PAIR * n_cut) \
        / PEAK_FP32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"2 B1 {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {n_tests} pair tests, {n_cut} inside the cutoff, "
        f"{n_bytes} bytes) on {card}")

    # ---- 3. the slice --------------------------------------------------------
    ctx._ensure_forces()
    f32_forces = ctx._state.forces
    ctx64, _ = make_ctx("double")
    ctx64._ensure_forces()
    f64_forces = ctx64._state.forces
    # cutoff flips between the two passes (each at its own virtual-site
    # positions), on the f32 context's slots
    fa = nb.fields(apply_vsites(ctx._spec, ctx._static, st.positions),
                   box_diag, st.neighbors)
    fb = nb.fields(apply_vsites(ctx64._spec, ctx64._static,
                                ctx64._state.positions),
                   torch.diagonal(ctx64._state.box), st.neighbors)
    slot_flips, n_flip = cutoff_flips(fa, fb, cfg, shifts, shifts.double())
    sa = st.neighbors.slot_atom
    atom_flips = torch.zeros(n_atoms, dtype=torch.bool, device=sa.device)
    atom_flips[sa[slot_flips & (sa < n_atoms)]] = True
    # a flipped virtual site's force lands on its parents
    sites = atom_flips[ctx._spec.vs_avg_idx]
    atom_flips[ctx._spec.vs_avg_p[sites].reshape(-1)] = True
    ferr_all, _ = f32_floor(f32_forces, f64_forces)
    ferr, frms = f32_floor(f32_forces, f64_forces, atom_flips)
    fs = float(torch.max(torch.abs(f64_forces)))
    del ctx64, f64_forces, fa, fb
    torch.cuda.empty_cache()
    log(f"3 force pass f32 vs f64: max {ferr:.3e} ({ferr_all:.3e} with "
        f"the atoms of {n_flip} cutoff-flipped pairs), rms {frms:.3e} "
        f"(max|F| {fs:.1f})")
    if not (ferr <= 1e-4 and frms <= 5e-6):
        fail("the f32 force pass misses the f32 floor against f64")

    n_steps = 100
    for k in sweep.launches:
        sweep.launches[k] = 0
    torch.cuda.synchronize()
    t = time.time()
    integ.step(n_steps)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = dict(sweep.launches)
    ms_step = wall / n_steps * 1e3
    nsd = ns_per_day(n_steps / wall, integ.getStepSize())
    log(f"3 {n_steps} steps in {wall:.2f} s: {ms_step:.2f} ms/step, "
        f"{nsd:.3f} ns/day on {card}; launches {launches}")
    if launches["b1_sweep"] < 1:
        fail("the main path never launched kernel B1")
    nbl = ctx._state.neighbors
    latches = {"overflow": bool(nbl.overflow),
               "drift": bool(nbl.drift_exceeded),
               "excl_span": bool(nbl.excl_span_exceeded)
               if nbl.excl_span_exceeded is not None else False,
               "hardwall_runaway": ctx.hardwallRunaway}
    if any(latches.values()):
        fail(f"a latch is set: {latches}")
    spec = ctx._spec
    p = (ctx._state.positions.double() + ctx._state.pos_err.double())
    drude = torch.nonzero(spec.is_pair & ~spec.is_parent)[:, 0]
    dist = torch.linalg.norm(p[drude] - p[spec.partner[drude]], dim=1)
    dmax = float(torch.max(dist))
    state = ctx.getState(positions=True, energy=True, groups=True)
    temps = state.getGroupTemperatures()
    e_cons = ctx.getConservedEnergy()
    pe = state.getPotentialEnergy()
    log(f"3 latches clear; max core-Drude distance {dmax:.6f} nm; bath "
        f"temperatures {np.round(temps, 3).tolist()} K; PE {pe:.1f}, "
        f"conserved {e_cons:.1f} kJ/mol")
    if dmax > 0.02 * 1.00001:
        fail(f"hard wall broken: {dmax}")
    if not np.all(np.isfinite(state.getPositions())):
        fail("non-finite positions")
    if not (np.all(np.isfinite(temps)) and np.isfinite(e_cons)
            and np.isfinite(pe)):
        fail("non-finite temperatures or energies")
    if not (250.0 < temps[0] < 350.0 and 150.0 < temps[1] < 450.0
            and 0.0 < temps[2] < 10.0):
        fail(f"implausible bath temperatures {temps}")

    # where one step's time goes: stream time of each part of the force
    # pass at the current state, against the whole step
    st = ctx._state
    box_diag = torch.diagonal(st.box)
    pos_comp = apply_vsites(ctx._spec, ctx._static, st.positions)
    fields = nb.fields(pos_comp, box_diag, st.neighbors)
    parts = {
        "sorted_fields": lambda: nb.fields(pos_comp, box_diag, st.neighbors),
        "b1_sweep": lambda: sweep.pair_forces(
            fields, cfg, cellpair.offset_shifts(cfg, box_diag), nb.alpha,
            ONE_4PI_EPS0),
        "pme_recip": lambda: nb.recip(pos_comp, box_diag),
        "pair_terms": lambda: nb.extras(pos_comp, box_diag),
        "force_pass": lambda: ctx._forces_only(st.positions, st.box,
                                               st.neighbors, st.pos_err),
        "cell_rebuild": lambda: ctx._neighbor_fn(st.positions, st.box),
    }
    times = {k: cuda_time_ms(fn, 5) for k, fn in parts.items()}
    log("3 breakdown (ms of stream time): " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items())
        + f"; whole step {ms_step:.3f} on {card}")

    # ---- 4. kernel summary --------------------------------------------------
    kernels = [{
        "name": "b1_sweep", "route": "cuda",
        "source": "openmm_drudenose_tpu_torch/csrc/sweep.cu",
        "replaces": "openmm_drudenose_tpu/ops/pallas_sweep.py:440",
        "launches": launches["b1_sweep"],
        "launches_per_step": launches["b1_sweep"] / n_steps,
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
