"""Kernel B2's share of its roofline in a force call, %: the least time
of the call (portbench/roofline.py, from the pairs the inputs need) over
the device time of one call, the force instantiations of
chunk_sweep_kernel (template flag kEnergy false) and overlap_add_kernel
summed over the profiled call and divided by its B2 force launches (the
program's counter b2_sweep)."""

import re

from portbench import roofline

B2 = re.compile(r"(^|[\s:])(chunk_sweep_kernel<false\b|overlap_add_kernel\b)")


def _b2(name):
    return B2.search(name) is not None


def read(trace):
    calls = trace.launches.get("b2_sweep", 0)
    s, n = trace.device_s(_b2)
    if not calls or not n:
        return None
    return roofline.share_pct(trace.pairs(), trace.sites, s / calls)
