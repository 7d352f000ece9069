"""Tracing and profiling helpers: the JAX package's utils/profiling.py on
torch.profiler and CUDA events.

  * `trace(dir)`: a context manager around torch.profiler (the CPU and,
    where there is one, the card), written as a Chrome trace
    (dir/trace.json: chrome://tracing, Perfetto)
  * `Timer`: wall-clock phase timers that synchronise the card before
    reading the clock
  * `step_breakdown(ctx, n)`: the time of each part of a Context's step,
    by CUDA events on the card (the host clock on the CPU)
  * `busy_share(fn)`: the card's busy share of a call, from torch.profiler
  * `measure_steps_per_second`: best-of-N steps/s
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


def _sync(device=None) -> None:
    """Wait for the card (nothing on the CPU)."""
    if device is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (CPU activity, and CUDA where
    a card is present) and write log_dir/trace.json; yields the profile
    (its key_averages() give the time of each operator and kernel)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    def __init__(self):
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time the block; `sync` (a tensor or a device) names the card to
        wait for before the clock is read."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync.device if isinstance(sync, torch.Tensor)
                      else sync)
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.times.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<30s} {total * 1e3:9.2f} ms total "
                         f"({total / n * 1e3:8.2f} ms x {n})")
        return "\n".join(lines)


def _best_ms(fn, device, reps: int = 3, warmup: int = 1) -> float:
    """The best of `reps` calls of fn() in ms: CUDA events on a card, the
    host clock on the CPU."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def step_breakdown(ctx, n: int = 16) -> Dict[str, float]:
    """The time (ms) of each part of a Context's step at its current
    state, which it leaves as it was:

      step        a step of an n-step fused block, force pass included
      forces      the in-step force pass (Context._forces_only)
      energy      the potential energy pass (Context._potential)
      kinematics  a step of the same block with the force pass replaced
                  by the cached forces (thermostat, integration,
                  constraints, virtual sites, hard wall)
      rebuild     one neighbour rebuild (where the strategy has one)

    On a card each is timed by CUDA events around the work (the step's
    host reads included), on the CPU by the host clock."""
    from ..integrators import tgnh

    ctx._ensure_neighbors()
    ctx._ensure_forces()
    spec, static, st = ctx._spec, ctx._static, ctx._state
    dev = st.positions.device
    gen = st.baro_gen.get_state() if st.baro_gen is not None else None
    out: Dict[str, float] = {}
    try:
        out["step"] = _best_ms(
            lambda: ctx._stepper.multi_step(spec, st, n), dev) / n
        out["forces"] = _best_ms(lambda: ctx._forces_only(
            st.positions, st.box, st.neighbors, st.pos_err, st.rep_scale),
            dev)
        out["energy"] = _best_ms(lambda: ctx._potential(
            st.positions, st.box, st.neighbors, st.pos_err, st.rep_scale),
            dev)
        cached = tgnh.Stepper(static, lambda *a, **k: st.forces)
        out["kinematics"] = _best_ms(
            lambda: cached.multi_step(spec, st, n), dev) / n
        if ctx._cp_cfg is not None:
            out["rebuild"] = _best_ms(lambda: ctx._neighbor_fn(
                st.positions, st.box, st.rep_scale), dev)
    finally:
        if gen is not None:
            st.baro_gen.set_state(gen)
    return out


def busy_share(fn) -> Dict[str, float]:
    """The card's busy share of fn() (on the current card): the device
    time of every kernel and copy torch.profiler records over the call's
    wall time, the card waited for at both ends.  Kernels of one stream
    do not overlap, so their sum is the time the card was busy.  Only
    the card's activity is recorded (the host's ops would multiply the
    profile's size and its time to read).  Returns {"busy", "device_ms",
    "wall_ms"}; raises without a card."""
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise RuntimeError("busy_share needs a CUDA card")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
                    for e in prof.key_averages())
    return {"busy": device_us * 1e-6 / wall, "device_ms": device_us * 1e-3,
            "wall_ms": wall * 1e3}


def measure_steps_per_second(context, integrator, steps: int = 64,
                             repeats: int = 3, warmup: int = 8) -> float:
    """Best-of-N steps/s of `integrator.step(steps)` (the card waited
    for)."""
    dev = context._state.positions.device
    integrator.step(warmup)
    best = 0.0
    for _ in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        integrator.step(steps)
        _sync(dev)
        best = max(best, steps / (time.perf_counter() - t0))
    return best
