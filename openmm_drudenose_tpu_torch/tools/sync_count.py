#!/usr/bin/env python3
"""Count the synchronising calls of the 100k main path on one CUDA card,
from any tree of the repository, and time its steps.

    python3 openmm_drudenose_tpu_torch/tools/sync_count.py --root TREE \\
        [--steps 128] [--label NAME] [--json PATH]

TREE is a checkout of the repository (an unpacked `git archive` of
another commit, say): its own package is imported and its own kernels
are built.  The Context is `tools/setups.py::bench_context` of that tree
(data/bench_equil_100k.npz, DrudeTGNHIntegrator(300, 0.1, 1, 0.1, 0.001,
20, 1), 0.02 nm wall, single precision, cell pairs through B1).  After
one force pass and 16 warm-up steps it runs one call of --steps steps
(one chunk of 8 x 16-step blocks at 128) under
torch.cuda.set_sync_debug_mode("warn") and counts each warning by the
innermost line of the tree's package on the Python stack (file:line,
with the two package frames above it).  Then it times REPEATS calls of
--steps steps by the host clock, each closed by torch.cuda.synchronize()
(ms/step), and takes the card's busy share of one more call with
torch.profiler (utils/profiling.py::busy_share where the tree has it:
the device time of the kernels and copies over the call's wall time).
It prints one line per place and ends with one JSON line (the card's
name and power limit, the counts, ms/step, the busy share).
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time
import traceback
import warnings

REPEATS = 3


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi gave no answer"


# the warning torch.cuda's sync debug mode gives for each synchronising
# call (c10/cuda/CUDAFunctions.cpp::warn_or_error_on_sync)
SYNC_WARNING = "called a synchronizing CUDA operation"


def count_syncs(torch, pkg, fn):
    """fn() under sync debug mode "warn": {place: count}, each place the
    innermost frame in `pkg` with the two package frames above it."""
    places = collections.Counter()
    shown = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            return shown(message, category, filename, lineno, file, line)
        frames = [f for f in traceback.extract_stack()[:-1]
                  if f.filename.startswith(pkg)]
        chain = " < ".join(f"{os.path.relpath(f.filename, pkg)}:{f.lineno}"
                           for f in reversed(frames[-3:]))
        places[chain or f"{filename}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = shown
    return places


def busy_share(torch, fn):
    """The card's busy share of fn(): device time of kernels and copies
    over the wall time, from torch.profiler."""
    try:
        from openmm_drudenose_tpu_torch.utils.profiling import busy_share
        return busy_share(fn)
    except ImportError:
        pass
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = sum(getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
              for e in prof.key_averages())
    return {"busy": dev * 1e-6 / wall, "device_ms": dev * 1e-3,
            "wall_ms": wall * 1e3}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--label", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("sync_count: no CUDA card")
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.tools.setups import bench_context
    pkg = os.path.dirname(os.path.abspath(dt.__file__))
    if os.path.dirname(pkg) != root:
        sys.exit(f"sync_count: imported {pkg}, not the tree's own package")
    label = args.label or os.path.basename(root)
    ctx, integ = bench_context("cuda")
    ctx._ensure_forces()
    integ.step(16)
    torch.cuda.synchronize()
    n = args.steps
    places = count_syncs(torch, pkg + os.sep, lambda: integ.step(n))
    total = sum(places.values())
    for place, c in places.most_common():
        print(f"[sync_count {label}] {c:6d} ({c / n:.3f}/step)  {place}",
              flush=True)
    ms = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        integ.step(n)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / n * 1e3)
    busy = busy_share(torch, lambda: integ.step(n))
    result = {"label": label, "card": card_line(), "steps": n,
              "syncs": total, "syncs_per_step": total / n,
              "places": dict(places.most_common()), "ms_per_step": ms,
              "busy": busy}
    print(f"[sync_count {label}] {total} synchronising calls in {n} steps; "
          f"ms/step {', '.join(f'{v:.3f}' for v in ms)}; busy share "
          f"{busy['busy']:.4f} on {result['card']}", flush=True)
    print(json.dumps(result), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f)


if __name__ == "__main__":
    main()
