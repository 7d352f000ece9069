"""Where the time of a Monte Carlo volume move goes at 100k atoms, on one
CUDA card.

    python3 -m openmm_drudenose_tpu_torch.tools.trace_barostat [out_dir]

The 100k-atom bench system and snapshot of chip_smoke.py (phases 3 and
6: data/bench_equil_100k.npz, DrudeTGNHIntegrator(300, 0.1, 1, 0.1,
0.001, 20, 1), 0.02 nm wall, single precision), once as NVT and once
with MonteCarloBarostat(1.01325, 300, 25).  Prints the card's
nvidia-smi name and power limit, then:

  1. windows: WINDOW steps of each Context in turn, ROUNDS times, host
     wall time synchronized at both ends; the NPT window's excess over
     the NVT one per attempt; in each window the cell rebuilds, grid
     replans, B1 force and energy launches and accepted moves;
  2. one attempt, split: `maybe_attempt_mc_move` called alone at an
     attempt step (draws fed, the Context's state left as it was), and
     each of its parts alone: the molecule scaling, `_potential` at the
     trial box and its parts (virtual sites and the float64 positions,
     sorted fields, B1's energy, the PME reciprocal energy, the pair-list
     extras, the other force terms) and the force pass an acceptance
     runs.  Each part: the host time until the call returns (`issue`),
     until the card is done (`total`, synchronized before and after), and
     the card's time between CUDA events (`device`), means over REPS;
  3. torch.profiler over one NPT window of 25 steps holding one attempt,
     and over one attempt alone: the operations with the most host and
     device time, and the card's busy time against the wall (its idle
     share).  The tables go to out_dir (default build/trace_barostat).

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

from .. import MonteCarloBarostat
from ..app.context import compensation
from ..constraints.vsites import apply_vsites
from ..forces import cellpair
from ..integrators import barostat
from ..ops import sweep
from ..units import ONE_4PI_EPS0
from . import setups

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BARO_FREQ = 25
WINDOW = 100
ROUNDS = 3
REPS = 5
# the attempts the steps made, those accepted, and the host seconds spent
# inside them (the attempt's own host reads wait for the work queued
# before them)
MOVES = {"attempts": 0, "accepted": 0, "host_s": 0.0}
_attempt = barostat.maybe_attempt_mc_move


def _counted_attempt(spec, static, state, *args, **kwargs):
    t = time.perf_counter()
    out = _attempt(spec, static, state, *args, **kwargs)
    if out is not state:
        MOVES["attempts"] += 1
        MOVES["accepted"] += int(out.box is not state.box)
        MOVES["host_s"] += time.perf_counter() - t
    return out


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi gave no answer"


def _context(npt: bool):
    ctx, integ = setups.bench_context(
        "cuda", barostat=(MonteCarloBarostat(1.01325, 300.0, BARO_FREQ)
                          if npt else None))
    counts = {"rebuilds": 0, "replans": 0}
    neighbor_fn, replan = ctx._neighbor_fn, ctx._replan_at_box

    def counted_neighbors(*a):
        counts["rebuilds"] += 1
        return neighbor_fn(*a)

    def counted_replan():
        counts["replans"] += 1
        return replan()

    ctx._neighbor_fn = counted_neighbors
    ctx._replan_at_box = counted_replan
    return ctx, integ, counts


def _window(ctx, integ, counts, steps):
    """Host wall seconds of `steps` steps and what they launched."""
    before = dict(sweep.launches)
    c0, m0 = dict(counts), dict(MOVES)
    torch.cuda.synchronize()
    t = time.perf_counter()
    integ.step(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = {k: sweep.launches[k] - before[k]
           for k in ("b1_sweep", "b1_energy")}
    got.update({k: counts[k] - c0[k] for k in counts})
    got.update({k: MOVES[k] - m0[k] for k in ("attempts", "accepted")})
    got["attempt_host_ms"] = round((MOVES["host_s"] - m0["host_s"]) * 1e3,
                                   3)
    return wall, got


def _timed(fn, reps=REPS):
    """(issue ms, total ms, device ms) of fn(), means over `reps`."""
    issue = total = device = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        fn()
        end.record()
        t_issue = time.perf_counter()
        torch.cuda.synchronize()
        t_done = time.perf_counter()
        issue += (t_issue - t) * 1e3
        total += (t_done - t) * 1e3
        device += start.elapsed_time(end)
    return issue / reps, total / reps, device / reps


def _split_attempt(ctx):
    """The parts of one attempt at the current state, timed alone."""
    spec, static, st = ctx._spec, ctx._static, ctx._state
    nb = ctx._nb
    att = st.replace(step=(st.step // BARO_FREQ + 1) * BARO_FREQ)
    new_pos, new_box = barostat.scale_molecules(spec, static, st.positions,
                                                st.box, 1.0005)
    box_diag = torch.diagonal(new_box)
    pos = apply_vsites(spec, static, new_pos)
    exact = ctx._exact_positions(new_pos, st.pos_err)
    fields = nb.fields(pos, box_diag, st.neighbors, exact)
    shifts = cellpair.offset_shifts(nb.cfg, box_diag)
    kernel = nb._kernel()

    def attempt(draws):
        return _attempt(spec, static, att, ctx._potential,
                        ctx._forces_only, draws=draws)

    parts = {
        "attempt (u_acc = 1)": lambda: attempt((0.9, 1.0)),
        "attempt, accepted (u_acc = 0)": lambda: attempt((0.1, 0.0)),
        "box read (host)": lambda: torch.diagonal(st.box).double().cpu(),
        "scale_molecules": lambda: barostat.scale_molecules(
            spec, static, st.positions, st.box, 1.0005),
        "_potential (one energy)": lambda: ctx._potential(
            new_pos, new_box, st.neighbors, st.pos_err),
        "  vsites + f64 positions": lambda: (
            apply_vsites(spec, static, new_pos),
            ctx._exact_positions(new_pos, st.pos_err)),
        "  sorted fields": lambda: nb.fields(pos, box_diag, st.neighbors,
                                             exact),
        "  B1 energy": lambda: kernel.pair_energy(
            fields, nb.cfg, shifts, nb.alpha, ONE_4PI_EPS0,
            excl_skip=nb.excl_skip),
        "  PME reciprocal energy": lambda: nb.recip_energy(pos, box_diag,
                                                          exact),
        "  pair-list extras": lambda: nb.extras(pos, box_diag, exact),
        "  other force terms": lambda: [
            term.energy_forces(pos, box_diag,
                               **compensation(term, st.pos_err, exact))
            for term in ctx._terms],
        "force pass (on acceptance)": lambda: ctx._forces_only(
            new_pos, new_box, st.neighbors, st.pos_err),
    }
    return {k: _timed(fn) for k, fn in parts.items()}


def _device_us(evt) -> float:
    return float(evt.self_device_time_total)


def _profile(fn, out_dir, tag):
    """torch.profiler over fn(): writes the tables, returns (wall ms,
    device busy ms, host ms in the top operations)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    avg = prof.key_averages()
    busy = sum(_device_us(e) for e in avg if e.device_type.name == "CUDA") \
        / 1e3
    with open(os.path.join(out_dir, f"{tag}.txt"), "w") as f:
        for key in ("self_cpu_time_total", "self_device_time_total"):
            f.write(avg.table(sort_by=key, row_limit=40) + "\n")
    rows = sorted(avg, key=lambda e: -e.self_cpu_time_total)[:12]
    top = ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.2f}/"
                    f"{_device_us(e) / 1e3:.2f} ({e.count})" for e in rows)
    return wall, busy, top


def main(argv):
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this tool needs a CUDA "
              "card", file=sys.stderr)
        return 1
    out_dir = argv[0] if argv else os.path.join(REPO, "build",
                                                "trace_barostat")
    os.makedirs(out_dir, exist_ok=True)
    card = _card()
    print(card, flush=True)
    sweep.build()
    barostat.maybe_attempt_mc_move = _counted_attempt
    nvt, nvt_integ, nvt_counts = _context(False)
    npt, npt_integ, npt_counts = _context(True)
    for integ in (nvt_integ, npt_integ):
        integ.step(BARO_FREQ)
    print(f"warm-up done at step {npt._state.step}", flush=True)

    # 1. windows, NVT and NPT in turn
    for r in range(ROUNDS):
        w_nvt, c_nvt = _window(nvt, nvt_integ, nvt_counts, WINDOW)
        w_npt, c_npt = _window(npt, npt_integ, npt_counts, WINDOW)
        attempts = WINDOW // BARO_FREQ
        print(f"round {r}: NVT {w_nvt / WINDOW * 1e3:.3f} ms/step {c_nvt}; "
              f"NPT {w_npt / WINDOW * 1e3:.3f} ms/step {c_npt}; excess "
              f"{(w_npt - w_nvt) / attempts * 1e3:.2f} ms an attempt "
              f"({attempts} attempts) on {card}", flush=True)

    # 2. one attempt, split
    for name, (issue, total, device) in _split_attempt(npt).items():
        print(f"split {name:32s} issue {issue:8.3f} ms, total {total:8.3f}"
              f" ms, device {device:8.3f} ms", flush=True)

    # 3. torch.profiler: a window with one attempt, and one attempt alone
    step = npt._state.step
    to_next = (-step) % BARO_FREQ
    if to_next:
        npt_integ.step(to_next)
    # the window starts one step past an attempt and ends on the next
    npt_integ.step(1)
    wall, busy, top = _profile(lambda: npt_integ.step(BARO_FREQ), out_dir,
                               "npt_window")
    print(f"profile NPT window of {BARO_FREQ} steps (one attempt): wall "
          f"{wall:.2f} ms, card busy {busy:.2f} ms, idle share "
          f"{1.0 - busy / wall:.4f}; top host ops (host/device ms, calls): "
          f"{top}", flush=True)
    wall, busy, top = _profile(lambda: nvt_integ.step(BARO_FREQ), out_dir,
                               "nvt_window")
    print(f"profile NVT window of {BARO_FREQ} steps: wall {wall:.2f} ms, "
          f"card busy {busy:.2f} ms, idle share {1.0 - busy / wall:.4f}; "
          f"top host ops: {top}", flush=True)
    st = npt._state
    att = st.replace(step=(st.step // BARO_FREQ + 1) * BARO_FREQ)
    wall, busy, top = _profile(
        lambda: _attempt(npt._spec, npt._static, att, npt._potential,
                         npt._forces_only, draws=(0.9, 1.0)),
        out_dir, "attempt")
    print(f"profile one rejected attempt: wall {wall:.2f} ms, card busy "
          f"{busy:.2f} ms; top host ops: {top}", flush=True)
    print(f"tables in {out_dir}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
