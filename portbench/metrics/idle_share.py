"""The card's idle share of the profiled call, %: 1 - (the union of the
device intervals of its kernels, copies and memsets) / (the call's wall
time, the card waited for at both ends)."""


def read(trace):
    if trace.wall_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.wall_s)
