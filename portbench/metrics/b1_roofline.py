"""Kernel B1's share of its roofline in a force call on a grid of replica
bands, %: the least time of the call (portbench/roofline.py, from the
pairs the inputs need) over the device time of one call, the force
instantiations of sweep_kernel (template flag kEnergy false) and
gather_kernel summed over the profiled call and divided by its banded
B1 force launches (the program's counter b1_sweep_bands)."""

import re

from portbench import roofline

# "(anonymous namespace)::sweep_kernel<false, ...>", not chunk_sweep_kernel
B1 = re.compile(r"(^|[\s:])(sweep_kernel<false\b|gather_kernel<)")


def _b1(name):
    return B1.search(name) is not None


def read(trace):
    calls = trace.launches.get("b1_sweep_bands", 0)
    s, n = trace.device_s(_b1)
    if not calls or not n:
        return None
    return roofline.share_pct(trace.pairs(), trace.sites, s / calls)
