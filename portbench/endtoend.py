"""The end-to-end metrics, all taken by the benchmark itself (host clock
and the allocator's peak), never read from the program:

  ns_per_day    simulated time of every step the window completed, summed
                over the replicas asked for, over the window's wall time
                (it starts with the card synchronised and ends with
                torch.cuda.synchronize()), in ns a day
  peak_mem_gib  torch.cuda.max_memory_allocated() over set-up and window
  setup_s       process start to the window's start: imports, the
                kernels' build (the first run in a checkout), inputs,
                the Context, the warm-up steps
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Window:
    steps: int
    wall_s: float
    step_ps: float
    replicas: int
    setup_s: float
    peak_bytes: int


def compute(w: Window) -> dict:
    ns = w.steps * w.step_ps * 1e-3 * w.replicas
    return {
        "ns_per_day": {"value": ns / w.wall_s * 86400.0, "unit": "ns/day"},
        "peak_mem_gib": {"value": w.peak_bytes / 2 ** 30, "unit": "GiB"},
        "setup_s": {"value": w.setup_s, "unit": "s"},
    }
