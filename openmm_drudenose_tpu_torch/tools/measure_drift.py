"""Per-bath temperature drift of the port on the CUDA card, resumable:
the counterpart of the JAX package's scripts/measure_drift.py.

The 100k bench configuration with --snapshot (tools/setups.py::
bench_context: SWM4-NDP water, PME at 1.0 nm on cell pairs through
kernel B1, DrudeTGNHIntegrator(300, 0.1, 1, 0.1, 0.001, 20, 1), 0.02 nm
wall, single precision), else build_water_box(--molecules, --cutoff) on
cell pairs, minimized (300 FIRE iterations), 300 K velocities (seed 7)
and --equil-ps of equilibration.  NVT.  Every 1,000 steps (1 ps) the
per-bath temperatures are read from the state's group KE at the last
Nose-Hoover half step and appended to a CSV; the fit reports each bath's
OLS drift, its mean and the AR(1) rho of the residuals
(tools/series.py).

With --snapshot the first call continues the JAX trajectory: it loads
the JAX run's checkpoint data/drift_100k_state.npz (convert.py::
load_jax_checkpoint; at 326 ps by data/drift_100k_state.npz.ps) and
numbers its samples from 327 in a CSV of its own (default
data/drift_100k_samples_torch.csv), whose header names the start state,
the commit and the card.  The state is checkpointed with the port's own
format (app/serialization.py::save_checkpoint, zip-deflated; default
data/drift_100k_state_torch.npz) every --ckpt-every samples and at the
end, written to a temporary file and moved into place, with the number
of the last sample it holds in a `.ps` marker beside it; a later call
resumes from it bit for bit, after dropping CSV rows past the marker (a
killed session can leave the CSV ahead of the state).  SIGTERM ends the
session at a sample boundary: inside a sample's steps at the last
checkpoint, else after the row and its checkpoint.  A CSV with samples
and no checkpoint is refused.

    python3 -m openmm_drudenose_tpu_torch.tools.measure_drift --snapshot \\
        [--max-new-ps N] [--budget-s S] [--ckpt-every K] [--csv PATH] \\
        [--state PATH] [--commit NAME]
    python3 -m openmm_drudenose_tpu_torch.tools.measure_drift --fit-only \\
        --csv data/drift_100k_samples_torch.csv

On the CUDA card (it exits non-zero without one); --fit-only reads the
CSV it is given (or, with --snapshot, the default one) on the host and
fits it alone and against the JAX run's 326 ps series
(data/drift_100k_samples.csv).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

from openmm_drudenose_tpu_torch.tools import series, setups

ROOT = setups.ROOT
JAX_STATE = os.path.join(ROOT, "data", "drift_100k_state.npz")
JAX_CSV = os.path.join(ROOT, "data", "drift_100k_samples.csv")
PORT_STATE = os.path.join(ROOT, "data", "drift_100k_state_torch.npz")
PORT_CSV = os.path.join(ROOT, "data", "drift_100k_samples_torch.csv")
BATHS = ("internal", "COM", "Drude")
SAMPLE_STEPS = 1000
COLUMNS = "# ps, T_internal, T_COM, T_Drude\n"


def read_csv(path: str, ncols: int = 4) -> np.ndarray:
    """(m, ncols) rows: the sample number and the values (here the bath
    temperatures; empty without a file)."""
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                s = line.strip()
                if s and not s.startswith("#"):
                    rows.append([float(v) for v in s.split(",")])
    return np.array(rows, np.float64).reshape(-1, ncols)


def truncate_csv(path: str, last: int, log=print) -> None:
    """Drop the rows numbered past `last` (the checkpoint's sample)."""
    kept, dropped = [], 0
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s and not s.startswith("#") and int(float(
                    s.split(",")[0])) > last:
                dropped += 1
            else:
                kept.append(line)
    if dropped:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.writelines(kept)
        os.replace(tmp, path)
        log(f"dropped {dropped} samples past the checkpoint's {last} from "
            f"{path}")


def temperatures(ctx) -> np.ndarray:
    """Per-bath temperatures (K) from the state's group KE (2 KE a bath
    at the last NH half step), as the JAX script reads group_ke."""
    two_ke = ctx._state.group_ke.double().cpu().numpy()
    nkbt = ctx._spec.nh_nkbt.double().cpu().numpy()
    targets = np.full_like(two_ke, ctx._integrator.getTemperature())
    targets[..., -1] = ctx._integrator.getDrudeTemperature()
    return two_ke / nkbt * targets


def latches(ctx) -> dict:
    """The Context's latches: cell overflow, a rebuild's drift past the
    skin (warned), an exclusion spanning two cells, the hard-wall
    runaway."""
    nbl = ctx._state.neighbors
    span = None if nbl is None else nbl.excl_span_exceeded
    return {"overflow": bool(nbl.overflow) if nbl is not None else False,
            "drift": bool(ctx._drift_warned),
            "excl_span": bool(span) if span is not None else False,
            "hardwall_runaway": ctx.hardwallRunaway}


def fits(rows: np.ndarray) -> list:
    """tools/series.py::fit of each bath over the rows (times in ns from
    the sample numbers, one sample a ps)."""
    t = rows[:, 0] / 1000.0
    return [series.fit(t, rows[:, 1 + g]) for g in range(len(BATHS))]


def report(rows: np.ndarray, label: str, ref: np.ndarray | None = None,
           log=print) -> dict:
    """Print each bath's mean, drift and rho over `rows`; with `ref` (the
    JAX series) the bands: the mean within 3 sqrt(SE^2 + SE_ref^2) of
    the reference's and the drift within 3 SE of zero (SE: the AR(1)
    inflated ones).  Returns the numbers as a dict."""
    out = {"label": label, "samples": int(len(rows))}
    if len(rows) < 3:
        log(f"[{label}] {len(rows)} samples: too few to fit")
        return out
    log(f"[{label}] {len(rows)} samples, {int(rows[0, 0])}-"
        f"{int(rows[-1, 0])} ps")
    mine = fits(rows)
    theirs = fits(ref) if ref is not None and len(ref) >= 3 else None
    out["baths"] = {}
    for g, name in enumerate(BATHS):
        f = mine[g]
        entry = dict(f)
        log(f"  {name:8s}: mean {f['mean']:.4f} +- {f['mean_se_ar1']:.4f} "
            f"K (sd {f['sd']:.4f}), drift {f['drift']:+.3f} +- "
            f"{f['drift_se']:.3f} K/ns (AR1-inflated +- "
            f"{f['drift_se_ar1']:.3f}), AR1 rho {f['rho']:+.3f}")
        held_d, half_d = series.within(f["drift"], 0.0, f["drift_se_ar1"])
        entry.update(drift_band=half_d, drift_held=held_d)
        if theirs is not None:
            r = theirs[g]
            held_m, half_m = series.within(f["mean"], r["mean"],
                                           f["mean_se_ar1"],
                                           r["mean_se_ar1"])
            entry.update(ref_mean=r["mean"], ref_mean_se=r["mean_se_ar1"],
                         mean_band=half_m, mean_held=held_m)
            log(f"            against the JAX {len(ref)} ps: mean "
                f"{r['mean']:.4f} +- {r['mean_se_ar1']:.4f} K, difference "
                f"{f['mean'] - r['mean']:+.4f} K, band +-{half_m:.4f}: "
                f"{'held' if held_m else 'MISSED'}; drift within 3 SE of "
                f"zero (+-{half_d:.3f}): {'held' if held_d else 'MISSED'}")
        out["baths"][name] = entry
    return out


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi gave no answer"


def source_digest() -> str:
    """sha256 (12 hex digits) of the package's Python and CUDA sources."""
    h = hashlib.sha256()
    pkg = os.path.join(ROOT, "openmm_drudenose_tpu_torch")
    for d, _, files in sorted(os.walk(pkg)):
        for name in sorted(files):
            if name.endswith((".py", ".cu", ".cuh", ".cpp", ".h")):
                p = os.path.join(d, name)
                h.update(os.path.relpath(p, pkg).encode())
                with open(p, "rb") as f:
                    h.update(f.read())
    return h.hexdigest()[:12]


def commit_name(given: str | None) -> str:
    if given:
        return given
    try:
        out = subprocess.run(["git", "-C", ROOT, "rev-parse", "--short",
                              "HEAD"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ns", type=float, default=1.0,
                    help="the series' target length (all sessions)")
    ap.add_argument("--molecules", type=int, default=500)
    ap.add_argument("--cutoff", type=float, default=1.0,
                    help="the PME cutoff (nm) of a --molecules box")
    ap.add_argument("--equil-ps", type=float, default=50.0)
    ap.add_argument("--snapshot", action="store_true",
                    help="the 100k bench configuration, continued from the "
                         "JAX run's checkpoint data/drift_100k_state.npz")
    ap.add_argument("--state", default=None,
                    help="the port's checkpoint (default with --snapshot: "
                         "data/drift_100k_state_torch.npz)")
    ap.add_argument("--csv", default=None,
                    help="the samples, appended across sessions (default "
                         "with --snapshot: data/drift_100k_samples_torch.csv)")
    ap.add_argument("--max-new-ps", type=int, default=None,
                    help="cap on new samples this session")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="wall budget: checkpoint and stop before it")
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="checkpoint interval (samples)")
    ap.add_argument("--sample-steps", type=int, default=SAMPLE_STEPS,
                    help="steps a sample (1,000: one ps)")
    ap.add_argument("--commit", default=None,
                    help="the commit named in a new CSV's header (default: "
                         "git's HEAD where there is a .git)")
    ap.add_argument("--fit-only", action="store_true",
                    help="fit the CSV and exit: no card, no state change")
    args = ap.parse_args(argv)
    if args.snapshot:
        args.state = args.state or PORT_STATE
        args.csv = args.csv or PORT_CSV
    else:
        scratch = os.path.join(ROOT, "build", "measure_drift")
        args.state = args.state or os.path.join(scratch, "state.npz")
        args.csv = args.csv or os.path.join(scratch, "samples.csv")
    return args


def fit_only(args, log=print) -> dict:
    if not os.path.exists(args.csv):
        raise SystemExit(f"no samples CSV at {args.csv}")
    rows = read_csv(args.csv)
    ref = read_csv(JAX_CSV) if os.path.exists(JAX_CSV) else None
    out = {"csv": report(rows, os.path.basename(args.csv), ref, log)}
    if ref is not None and len(ref) and len(rows) \
            and rows[0, 0] == ref[-1, 0] + 1:
        # the port's series continues the JAX one: the whole trajectory
        out["joined"] = report(np.concatenate([ref, rows]),
                               "the JAX series and this one joined",
                               log=log)
    return out


def build(args, device):
    """(Context, integrator) of the run, not yet at the series' end."""
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.io import builders
    if args.snapshot:
        return setups.bench_context(device)
    system, _ = builders.build_water_box(args.molecules, cutoff=args.cutoff)
    integ = setups.bench_integrator()
    ctx = dt.Context(system, integ, precision="single", strategy="cellpair",
                     device=device)
    return ctx, integ


def open_run(args, device, log=print):
    """Build the Context and bring it to the series' end: (ctx, integ,
    rows, first), `first` the number the series starts after (326 for
    the JAX start, 0 for a fresh one).  Resumes from the checkpoint
    where the CSV has samples and the checkpoint exists; refuses a CSV
    with samples and no checkpoint; else starts the series (the JAX
    checkpoint with --snapshot, a minimized lattice otherwise) and
    writes the CSV's header."""
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch import convert
    from openmm_drudenose_tpu_torch.io import builders
    t0 = time.time()
    rows = series_rows(args.csv, args.state, log=log)
    ctx, integ = build(args, device)
    first = 0
    if len(rows):
        with open(args.csv) as f:
            for line in f:
                if line.startswith("# first:"):
                    first = int(line.split(":")[1])
        dt.load_checkpoint(args.state, ctx)
        log(f"resumed from {args.state} at sample {int(rows[-1, 0])} (step "
            f"{ctx._state.step}, {time.time() - t0:.0f} s)")
        return ctx, integ, rows, first
    if args.snapshot:
        convert.load_jax_checkpoint(JAX_STATE, ctx)
        with open(JAX_STATE + ".ps") as f:
            first = int(f.read().strip())
        start = (f"{os.path.relpath(JAX_STATE, ROOT)} (the JAX run's state "
                 f"at {first} ps; step {ctx._state.step})")
        log(f"started from {start}")
    else:
        system_pos = builders.build_water_box(args.molecules,
                                              cutoff=args.cutoff)[1]
        ctx.setPositions(system_pos)
        ctx.minimizeEnergy(maxIterations=300)
        ctx.setVelocitiesToTemperature(300.0, seed=7)
        n_equil = int(args.equil_ps * 1000)
        if n_equil:
            integ.step(n_equil)
        start = (f"build_water_box({args.molecules}, cutoff "
                 f"{args.cutoff}), minimized, 300 K (seed 7), "
                 f"{args.equil_ps} ps equilibrated")
        log(f"equilibrated {args.equil_ps} ps ({time.time() - t0:.0f} s)")
    os.makedirs(os.path.dirname(os.path.abspath(args.csv)), exist_ok=True)
    with open(args.csv, "w") as f:
        f.write(f"# openmm_drudenose_tpu_torch tools/measure_drift: "
                f"per-bath temperatures (K) every {args.sample_steps} "
                "steps\n")
        f.write(f"# start: {start}\n")
        f.write(f"# first: {first}\n")
        f.write(f"# commit: {commit_name(args.commit)}; sources "
                f"{source_digest()}\n")
        f.write(f"# card: {card_line()}\n")
        f.write(COLUMNS)
    return ctx, integ, rows, first


def series_rows(csv_path: str, state_path: str, ncols: int = 4,
                log=print) -> np.ndarray:
    """The rows a series resumes from: the CSV's, less those numbered past
    the checkpoint's `.ps` marker (a killed session can leave the CSV
    ahead of the state).  Refuses rows without a checkpoint, and a
    marker that is not the last row's number."""
    marker = state_path + ".ps"
    if os.path.exists(marker) and os.path.exists(csv_path):
        with open(marker) as f:
            truncate_csv(csv_path, int(f.read().strip()), log)
    rows = read_csv(csv_path, ncols)
    if not len(rows):
        return rows
    if not (os.path.exists(state_path) and os.path.exists(marker)):
        raise SystemExit(
            f"{csv_path} has {len(rows)} samples but no checkpoint "
            f"{state_path}: refusing to append a fresh trajectory to a "
            f"series that cannot be resumed; archive the CSV first")
    with open(marker) as f:
        at = int(f.read().strip())
    if at != int(rows[-1, 0]):
        raise SystemExit(f"{state_path} holds sample {at}, the CSV ends at "
                         f"{int(rows[-1, 0])}")
    return rows


def checkpoint(ctx, state_path: str, last: int) -> None:
    """The state (zip-deflated) and its marker, each written beside and
    moved into place."""
    import openmm_drudenose_tpu_torch as dt
    os.makedirs(os.path.dirname(os.path.abspath(state_path)), exist_ok=True)
    tmp = state_path + ".tmp"
    dt.save_checkpoint(tmp, ctx, compressed=True)
    os.replace(tmp, state_path)
    with open(state_path + ".ps.tmp", "w") as f:
        f.write(str(last))
    os.replace(state_path + ".ps.tmp", state_path + ".ps")


def sample_loop(ctx, integ, rows, last, n_last, sample, args, steps,
                progress=None, log=print) -> np.ndarray:
    """Append rows [k, *sample(ctx)] to args.csv for k = last + 1 ..
    n_last, one every `steps` steps, until args.max_new_ps new rows (where
    the tool has the option) or args.budget_s seconds; checkpoint every
    args.ckpt_every rows and at the end, at a row boundary.  A SIGTERM
    inside the steps ends the session at once (the last checkpoint
    stands); one that comes while a row is written and counted waits for
    the row and its checkpoint, so a checkpoint's marker always names the
    last row it holds.  Each value is kept as written, so a resumed
    series reads the same numbers.  progress(rows, new, seconds) every 25
    new rows.  Returns all the rows."""
    out = [list(r) for r in rows]
    ncols = rows.shape[1]
    max_new = getattr(args, "max_new_ps", None)
    t_run = time.time()
    new = 0
    at_boundary = True
    flags = {"in_steps": False, "term": False}

    def _term(signum, frame):
        flags["term"] = True
        if flags["in_steps"]:
            raise KeyboardInterrupt

    old = signal.signal(signal.SIGTERM, _term)
    csv = open(args.csv, "a")
    try:
        while last < n_last and not flags["term"]:
            at_boundary = False
            flags["in_steps"] = True
            integ.step(steps)
            flags["in_steps"] = False
            text = [f"{v:.6f}" for v in sample(ctx)]
            out.append([float(last + 1)] + [float(v) for v in text])
            csv.write(f"{last + 1}, " + ", ".join(text) + "\n")
            csv.flush()
            last += 1
            new += 1
            at_boundary = True
            if new % args.ckpt_every == 0:
                checkpoint(ctx, args.state, last)
            if progress is not None and new % 25 == 0:
                progress(np.array(out), new, time.time() - t_run)
            if max_new is not None and new >= max_new:
                log(f"session cap {max_new} samples reached")
                break
            if args.budget_s is not None \
                    and time.time() - t_run > args.budget_s:
                log("wall budget reached")
                break
    finally:
        csv.close()
        if at_boundary:
            checkpoint(ctx, args.state, last)
            log(f"checkpointed at sample {last} ({new} new this session)")
        else:
            log(f"interrupted mid-sample; the last periodic checkpoint "
                f"stands ({new} new samples this session)")
        signal.signal(signal.SIGTERM, old)
    if flags["term"]:
        log("SIGTERM: the session ended at a row boundary")
    return np.array(out, np.float64).reshape(-1, ncols)


def session(ctx, integ, rows, first, args, log=print) -> np.ndarray:
    """The drift run's samples (sample_loop): the bath temperatures every
    --sample-steps steps until the series holds --ns of them."""
    def progress(out, new, seconds):
        log(f"{int(out[-1, 0])} ps  T = "
            f"{np.mean(out[-25:, 1:], axis=0).round(3)}  ({seconds:.0f} s, "
            f"{seconds / new / args.sample_steps * 1e3:.2f} ms/step host "
            f"clock; latches {latches(ctx)})")
    last = int(rows[-1, 0]) if len(rows) else first
    return sample_loop(ctx, integ, rows.reshape(-1, 4), last,
                       first + int(args.ns * 1000), temperatures, args,
                       args.sample_steps, progress, log)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.fit_only:
        print(json.dumps(fit_only(args)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("measure_drift: no CUDA device (the tool runs on the card)",
              file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    ctx, integ, rows, first = open_run(args, "cuda")
    rows = session(ctx, integ, rows, first, args)
    ref = read_csv(JAX_CSV) if args.snapshot else None
    print(json.dumps({"card": card_line(), "latches": latches(ctx),
                      "step": int(ctx._state.step), **report(
                          rows, os.path.basename(args.csv), ref)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
