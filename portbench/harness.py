"""One run of one cell (portbench/run.py is its command line).

A cell is an entry of BENCHMARK.json's "workloads"; its configuration
is the file its "configs" entry names, whose "system" key names the
module of its system and reference, portbench/systems/<system>.py; its
traffic mix is portbench/traffic/<traffic>.json, whose "generator" key
names portbench/generators/<generator>.py; its limits are
portbench/workloads/<cell>.json and each per-layer metric is
portbench/metrics/<metric>.py.  All are found by name: a new cell,
configuration, system, mix, generator or metric is new files and
entries, no edit here.

A run: set-up (inputs from the seed, the program, its first
check_steps steps kept for the check, the rest of warm_steps), the
window (calls of chunk_steps steps until --seconds have passed, closed
by torch.cuda.synchronize()), with --trace 1 a call of trace_steps
profiled with the card's activity, one of label_steps profiled with the
host's ops too and one under the sync debug mode, then the peak memory,
the program freed, the comparison with the reference, and the result
line.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

from . import endtoend, guard

# where the program runs; the harness's CPU tests set "cpu"
DEVICE = "cuda"


def _dir(root: str, *parts) -> str:
    return os.path.join(root, "portbench", *parts)


def load_cell(root: str, name: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[cell["config"]]["file"])) as f:
        cfg = json.load(f)
    with open(_dir(root, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    generator = plugin(root, "generators", traffic["generator"])
    generator.validate(traffic)
    with open(_dir(root, "workloads", name + ".json")) as f:
        limits = json.load(f)["limits"]

    def mine(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return {"bench": bench, "cell": cell, "config": cfg,
            "system": plugin(root, "systems", cfg["system"]),
            "traffic": traffic, "generator": generator, "limits": limits,
            "end_to_end": [m["name"] for m in bench["end_to_end"]
                           if mine(m)],
            "per_layer": [m["name"] for m in bench["per_layer"]
                          if mine(m)]}


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi gave no answer"
    return out.splitlines()[0] if out else "nvidia-smi gave no answer"


def parse(argv):
    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def main(argv, root: str, t0: float) -> int:
    """Returns the exit code."""
    args = parse(argv)
    cell = load_cell(root, args.workload)
    cfg, traffic = cell["config"], cell["traffic"]
    sysmod, gen = cell["system"], cell["generator"]
    import torch
    need = int(cell["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"needs {need} CUDA card(s); torch.cuda.is_available() = "
            f"{torch.cuda.is_available()}, device_count() = "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from openmm_drudenose_tpu_torch.ops import sweep
    from . import program as program_mod
    phases = {"imports": time.perf_counter() - t0}
    sweep.build()
    phases["kernels"] = time.perf_counter() - t0
    inputs = program_mod.load_inputs(cfg, root)
    phases["inputs"] = time.perf_counter() - t0
    prog = program_mod.Program(cfg, inputs, sysmod, gen, traffic, DEVICE)
    phases["program"] = time.perf_counter() - t0
    R, asked = prog.r_int, prog.n_replicas
    x0 = inputs["positions"].astype("float64")[None].repeat(R, 0)
    v0 = gen.velocities(sysmod.topology(cfg), traffic, R, args.seed)
    prog.set_velocities(v0)
    k, warm = int(traffic["check_steps"]), int(traffic["warm_steps"])
    prog.step(k)
    start = prog.state()
    prog.step(warm - k)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    phases["warm"] = setup_s
    marks = list(phases.items())
    split = ", ".join(f"{name} {b - a:.3f}" for (name, b), a in
                      zip(marks, [0.0] + [v for _, v in marks[:-1]]))
    log(f"set-up {setup_s:.3f} s ({split}): {cell['cell']['name']}, "
        f"{R} replica(s) ({asked} asked for) of {prog.n0} sites, seed "
        f"{args.seed}, cell capacity {prog.capacity()}")

    chunk = int(traffic["chunk_steps"])
    steps = 0
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    ends = []
    while True:
        prog.step(chunk)
        steps += chunk
        ends.append(time.perf_counter() - w0)
        if ends[-1] >= args.seconds:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    calls = steps // chunk
    per_call = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    log(f"window {wall:.3f} s, {steps} steps in {calls} calls, "
        f"{wall / steps * 1e3:.3f} ms/step, cell capacity {prog.capacity()}; "
        f"calls' seconds {', '.join(f'{c:.3f}' for c in per_call)}")

    if args.trace:
        from . import trace as trace_mod
        ts, ls = int(traffic["trace_steps"]), int(traffic["label_steps"])
        ss = int(traffic["sync_steps"])
        p0 = time.perf_counter()
        dev_ev, _, twall, delta = trace_mod.profile_call(
            torch, prog.step, ts, prog.launches, host=False)
        lab_ev, host_ev, hwall, _ = trace_mod.profile_call(
            torch, prog.step, ls, prog.launches, host=True)
        syncs = trace_mod.count_syncs(torch, prog.step, ss)
        extra = ts + ls + ss
        log(f"traced calls: {ts} steps in {twall:.3f} s wall with "
            f"{len(dev_ev)} device events; {ls} steps in {hwall:.3f} s "
            f"wall with the host's {len(host_ev)} ops; read in "
            f"{time.perf_counter() - p0:.1f} s; {syncs} syncs in {ss} steps")
    else:
        extra = 0

    route_ok, route_msg = check_route(cfg, prog.launches())
    end, n0 = prog.state(), prog.n0
    peak = torch.cuda.max_memory_allocated()
    prog.free()
    del prog
    gc.collect()
    torch.cuda.empty_cache()

    from . import check
    c0 = time.perf_counter()
    numbers = check.program_numbers(sysmod, cfg, traffic, x0, v0, start,
                                    end, warm + steps + extra, DEVICE)
    rows = check.judge(numbers, cell["limits"])
    log(f"reference check {time.perf_counter() - c0:.1f} s")
    correct = route_ok and all(ok for _, _, _, ok in rows)

    result = {"correct": bool(correct), "attempted": calls, "failed": 0}
    if args.trace:
        t = trace_mod.Trace(
            steps=ts, wall_s=twall, device=dev_ev, labelled=lab_ev,
            host=host_ev,
            launches=delta, syncs=syncs, sync_steps=ss,
            pairs=_pairs_once(sysmod, cfg, x0[:asked]),
            sites=asked * n0)
        metrics = {}
        units = {m["name"]: m["unit"] for m in cell["bench"]["per_layer"]}
        for name in cell["per_layer"]:
            value = metric_reader(root, name)(t)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": units[name]}
        result["metrics"] = metrics
    else:
        e2e = endtoend.compute(endtoend.Window(
            steps=steps, wall_s=wall, step_ps=cfg["integrator"]["step_ps"],
            replicas=asked, setup_s=setup_s, peak_bytes=peak))
        result["metrics"] = {k: v for k, v in e2e.items()
                             if k in cell["end_to_end"]}
    result["device"] = device_info(torch, peak, cell)
    if args.trace:
        result["device"]["busy_s"] = t.busy_s()
        result["device"]["window_s"] = twall
        result["breakdown"] = {"device_ops": t.top_ops(),
                               "idle_gaps": t.idle_gaps()}
    bad = guard.loaded(sys.modules)
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 3
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim, _ in rows}
    result["checks"]["route"] = {"value": route_msg,
                                 "limit": cfg.get("route") or "none"}
    for name, v, lim, ok in rows:
        log(f"check {name} = {v!r} (limit {lim!r}){'' if ok else ' FAILED'}")
    log(f"check route = {route_msg} (limit {cfg.get('route') or 'none'})"
        f"{'' if route_ok else ' FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


def plugin(root: str, kind: str, name: str):
    """The module portbench/<kind>/<name>.py of the checkout, loaded by
    its file (a name may hold "." or "-")."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name}", _dir(root, kind, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: str, name: str):
    """read() of portbench/metrics/<name>.py in the checkout."""
    return plugin(root, "metrics", name).read


def _pairs_once(sysmod, cfg, x):
    """The pairs within the cutoff at the start positions of the replicas
    asked for, counted by the reference's cell list at first use."""
    memo = []

    def pairs():
        if not memo:
            import torch
            _, field, _ = sysmod.reference(cfg, DEVICE)
            memo.append(field.pair_count(torch.as_tensor(
                x, device=field.device)))
        return memo[0]
    return pairs


def check_route(cfg, launches: dict) -> tuple:
    """Whether the only force-sweep launches are of the configuration's
    route (a launch key of ops/sweep.py; none on a strategy without a
    sweep)."""
    used = sorted(k for k, v in launches.items()
                  if v and "_sweep" in k)
    want = cfg.get("route")
    ok = used == ([want] if want else [])
    return ok, ",".join(used) if used else "none"


def device_info(torch, peak: int, cell) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(cell["cell"]["chips"]),
            "memory_peak_bytes": int(peak), "card": card_line()}
