"""The least time a force call of the direct-space sweep could take on one
H100, from what the inputs need and not from what a kernel does.

  operations  OPS_PER_PAIR for each pair of sites of different molecules
              within the cutoff (counted by the reference's own cell
              list from the start positions, each replica in its own
              box): the Ewald erfc and LJ force of one pair
  bytes       each site's position, charge and LJ pair read once
              (BYTES_READ), its force written once (BYTES_WRITTEN)
  peaks       NVIDIA's data sheet for the H100 SXM, dense, without
              sparsity, at the 700 W limit

The constants are tools/bounds.py's (the port's sweep bound), counted
here from the inputs rather than from the kernel's pair tests.
"""

from __future__ import annotations

OPS_PER_PAIR = 50
BYTES_READ = 24          # x, y, z, q, sigma, epsilon in float32
BYTES_WRITTEN = 12       # the force in float32
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def least_time_s(pairs: int, sites: int) -> tuple:
    """(seconds, "operations" or "bytes": which bound it)."""
    t_ops = OPS_PER_PAIR * pairs / PEAK_FP32_FLOPS
    t_bytes = (BYTES_READ + BYTES_WRITTEN) * sites / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def share_pct(pairs: int, sites: int, seconds_per_call: float):
    """The roofline share of a call that took `seconds_per_call` of
    device time, in %; None without a time."""
    if not seconds_per_call or seconds_per_call <= 0:
        return None
    return 100.0 * least_time_s(pairs, sites)[0] / seconds_per_call
