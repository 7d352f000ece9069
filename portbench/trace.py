"""What a --trace 1 run reads: one whole call of the window's entry (the
traffic's trace_steps, as many as a call of the window) profiled by
torch.profiler with the card's activity alone (the device metrics:
recording the host's ops too slows the host's issue by half at 1M and
would inflate the idle share), one shorter call (label_steps) with CPU
and CUDA activity (which host op each idle gap falls in: it only labels
the breakdown's gaps, and a whole call's host ops take minutes to read
at 1M), one more counted under torch.cuda's sync debug mode, and the
program's launch counters around the first call.  The per-layer metrics (portbench/metrics/) read a
`Trace` and nothing else.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

# the warning torch.cuda's sync debug mode gives for each synchronising
# call (c10/cuda/CUDAFunctions.cpp::warn_or_error_on_sync)
SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclasses.dataclass
class Trace:
    steps: int                 # steps of the profiled call
    wall_s: float              # its wall time, the card waited for at both ends
    device: list               # (name, start_ns, end_ns) of every kernel,
                               # copy and memset on the card
    labelled: list             # the same of the call profiled with the host
    host: list                 # (name, start_ns, end_ns) of that call's
                               # host ops
    launches: dict             # the program's counters over the call
    syncs: int                 # synchronising calls in the counted call
    sync_steps: int
    pairs: object              # () -> pairs within the cutoff (lazy)
    sites: int                 # sites the force pass serves (replicas
                               # asked for, pad replicas left out)

    def kernels(self):
        return [e for e in self.device if not _is_copy(e[0])]

    def busy_s(self) -> float:
        """Seconds in which something ran on the card (the union of the
        device intervals)."""
        total, end = 0, None
        for _, s, e in sorted(self.device, key=lambda t: t[1]):
            if end is None or s >= end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total * 1e-9

    def device_s(self, match) -> tuple:
        """(seconds, count) of the kernels whose name `match` takes."""
        sel = [e[2] - e[1] for e in self.kernels() if match(e[0])]
        return sum(sel) * 1e-9, len(sel)

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, s, e in self.device:
            key = short(name)
            by[key] = by.get(key, 0) + (e - s)
        return [[k, v * 1e-9] for k, v in sorted(by.items(),
                                                 key=lambda t: -t[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The card's idle time between device activities, summed by the
        innermost host op that spans each gap's middle (in the call
        profiled with the host's ops)."""
        dev = sorted(self.labelled, key=lambda t: t[1])
        host = sorted(self.host, key=lambda t: t[1])
        gaps, end = [], None
        for _, s, e in dev:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        by, active, p = {}, [], 0
        for a, b in gaps:
            mid = (a + b) // 2
            while p < len(host) and host[p][1] <= mid:
                active.append(host[p])
                p += 1
            active = [h for h in active if h[2] >= mid]
            label = (max(active, key=lambda h: h[1])[0] if active
                     else "host outside any profiled op")
            by[label] = by.get(label, 0) + (b - a)
        return [[k, v * 1e-9] for k, v in sorted(by.items(),
                                                 key=lambda t: -t[1])[:n]]


def _is_copy(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def short(name: str, width: int = 160) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def profile_call(torch, fn, steps: int, counters, host: bool) -> tuple:
    """(device events, host events, wall seconds, counter deltas) of
    fn(steps) under torch.profiler: the card's activity where the
    profiler supports it, the host's ops where `host` (or where it
    does not)."""
    from torch.profiler import ProfilerActivity, profile, \
        supported_activities
    cuda_t = torch.autograd.DeviceType.CUDA
    card = ProfilerActivity.CUDA in supported_activities()
    acts = (([ProfilerActivity.CPU] if host or not card else [])
            + ([ProfilerActivity.CUDA] if card else []))
    c0 = counters()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    c1 = counters()
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        rec = (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
        (device if ev.device_type() == cuda_t else host).append(rec)
    delta = {k: c1.get(k, 0) - c0.get(k, 0) for k in c1}
    return device, host, wall, delta


def count_syncs(torch, fn, steps: int) -> int:
    """Synchronising calls of fn(steps) under sync debug mode "warn"
    (a read the program makes with the mode off is not counted)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(steps)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum(SYNC_WARNING in str(w.message) for w in caught)
