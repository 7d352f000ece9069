"""Kernel launches a step: the kernel records on the card in the
profiled call over its steps (each launch leaves one record, whatever
library or runtime issued it; copies and memsets are not counted)."""


def read(trace):
    n = len(trace.kernels())
    return n / trace.steps if n else None
