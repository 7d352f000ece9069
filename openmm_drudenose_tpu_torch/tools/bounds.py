"""The card's timing and the kernels' bounds, shared by chip_smoke.py
and the tools that time a kernel (tools/dryrun_1m.py).

`sweep_bound` is the least time the card could take for a sweep on the
given fields: the larger of its float32 operations over the card's peak
and the bytes it must move over the memory rate, with the pair counts
that this run's slot data gives (`pair_counts`).  `nh_chain_bound` is
the NH chain kernel's (ops/nh_chain.py), from its shapes.  `cuda_time_ms`
times a call by CUDA events.
"""

from __future__ import annotations

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, 700 W): float32 and
# float64 outside the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12
PEAK_BYTES_PER_S = 3.35e12
# B1 operation count: every pair test is a distance and a compare (~9
# float32 ops); every pair inside the cutoff adds the LJ + A&S-erfc force
# and its row/reaction accumulation (~50, counting rsqrt and exp as one)
OPS_PER_TEST = 9
OPS_PER_PAIR = 50
# the energy instantiation: each pair inside the cutoff costs the LJ
# energy, erfcf (~25 operations: CUDA's rational approximation with its
# exp) and a float64 add (~45 in all)
OPS_PER_PAIR_ENERGY = 45
# the reaction field in place of the erfc: a kept pair's force costs the
# LJ and qq (krf - 1/(2 r^3)) terms and its row and reaction adds (~33);
# its energy, LJ and qq (1/r + krf r^2 - crf) and the float64 add (~25)
OPS_PER_PAIR_RF = 33
OPS_PER_PAIR_ENERGY_RF = 25
# the LJ switch on a pair inside the switching window (r_on < r < r_off):
# r, t, S and dS/dr^2 and the products (~20; ~12 for the energy's S)
OPS_SWITCH = 20
OPS_SWITCH_ENERGY = 12


def cuda_time_ms(fn, reps, warm=True):
    """Mean device time of fn() over `reps` calls, by CUDA events, after
    one call to warm it (warm=False: fn() has just run on these inputs,
    as a plain version has where it was held against its kernel)."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def offset_shift(shifts, cfg, o, d):
    """Offset o's shift along d, broadcastable to (n_cells, C): a number
    for an (n_off, 3) table, each home cell's replica's for a
    per-replica (R, n_off, 3) one (flat-ensemble NPT)."""
    import torch
    from openmm_drudenose_tpu_torch.forces import cellpair
    if shifts.dim() == 2:
        return shifts[o, d]
    rep = torch.as_tensor(cellpair.rep_of_cell(cfg), device=shifts.device)
    return shifts[rep, o, d][:, None]


def pair_counts(fields, cfg, shifts, r_on=None, cells=None):
    """(pair tests, pairs inside the cutoff, pairs inside the cutoff and
    beyond r_on (0 without r_on: the LJ switch's window)) that this
    run's slot data gives the sweep: occupied-slot products over the
    half stencil (of the home cells in `cells`, all by default)."""
    import torch
    nc, C = cfg.n_cells, cfg.capacity
    lo, hi = (0, nc) if cells is None else cells
    dev = fields["x"].device
    count = fields["count"].long()
    nbr = torch.as_tensor(cfg.nbr_map, device=dev)[lo:hi]
    occ = torch.arange(C, device=dev)[None, :] < count[:, None]
    xyz = [fields[k].reshape(nc, C) for k in "xyz"]
    n_tests = int(torch.sum(count[lo:hi] * (count[lo:hi] - 1)))
    n_cut = n_win = 0
    cut2 = cfg.cutoff * cfg.cutoff
    for o in range(cfg.n_offsets):
        b = nbr[:, o]
        r2 = 0
        for d in range(3):
            sh = offset_shift(shifts, cfg, o, d)
            if torch.is_tensor(sh) and sh.dim() == 2:
                sh = sh[lo:hi]
            diff = xyz[d][lo:hi, :, None] - (xyz[d][b] + sh)[:, None, :]
            r2 = r2 + diff * diff
        ok = (r2 < cut2) & occ[lo:hi, :, None] & occ[b][:, None, :]
        if o == 0:
            ok = ok & ~torch.eye(C, dtype=torch.bool, device=dev)
        else:
            n_tests += int(torch.sum(count[lo:hi] * count[b]))
        n_cut += int(torch.sum(ok))
        if r_on is not None:
            n_win += int(torch.sum(ok & (r2 > r_on * r_on)))
    return n_tests, n_cut, n_win


def sweep_bound(fields, cfg, shifts, energy=False, method="ewald",
                r_switch=None, cells=None):
    """(bound ms, "operations" or "bytes", pair tests, pairs inside the
    cutoff, bytes) of the direct-space sweep on these fields: the larger
    of its FP32 operations over the card's peak and the bytes it must
    move (each field read once, the forces, or the energy, written once)
    over the memory rate.  B1 and B2 compute the same function, so both
    are held to this one bound (one for each instantiation and Coulomb
    kind; with r_switch, the switch's operations on the pairs of its
    window added).  cells: a home-slab range (B1's), whose stencils are
    counted: the fields of the cells they reach are read, every slot's
    force written."""
    n_tests, n_cut, n_win = pair_counts(fields, cfg, shifts, r_switch,
                                        cells)
    lo, hi = (0, cfg.n_cells) if cells is None else cells
    n_read = int(np.unique(cfg.nbr_map[lo:hi]).size)
    n_slots = cfg.n_cells * cfg.capacity
    n_bytes = (n_read * cfg.capacity * 8 * 4 + n_read * 4
               + (hi - lo) * cfg.n_offsets * 4 + shifts.numel() * 4
               + cfg.n_offsets * 4
               + (8 * cfg.n_replicas if energy and shifts.dim() == 3
                  else 8 if energy else n_slots * 3 * 4))
    per_pair = {("ewald", False): OPS_PER_PAIR,
                ("ewald", True): OPS_PER_PAIR_ENERGY,
                ("rf", False): OPS_PER_PAIR_RF,
                ("rf", True): OPS_PER_PAIR_ENERGY_RF}[(method, energy)]
    t_ops = (OPS_PER_TEST * n_tests + per_pair * n_cut
             + (OPS_SWITCH_ENERGY if energy else OPS_SWITCH) * n_win) \
        / PEAK_FP32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), bound_by, n_tests, n_cut, n_bytes


def nh_chain_ops(M: int) -> int:
    """float64 operations of one substep of one bath's chain
    (csrc/nh_chain.cu::half_step, an exp counted as one): 2M + 1
    exponentials, 5M for the downward sweep, 4 for the damping, 2M for
    eta, 2 + 4 for link 0's refresh and kick, 9 (M - 1) for the upward
    sweep."""
    return (2 * M + 1) + 5 * M + 4 + 2 * M + 6 + 9 * (M - 1)


def nh_chain_bound(rows: int, B: int, M: int, steps: int, halves: int,
                   itemsize: int, cm: bool) -> tuple:
    """(bound ms, "bytes" or "operations") of one NH chain launch on
    `rows` bath rows of B baths and M links, `halves` half steps (1, or 2
    for the fused pair) of `steps` substeps, the chain in `itemsize`-byte
    floats, with the CM momenta where `cm`: the larger of its float64
    operations over the card's float64 peak and the bytes it must move
    (each input once: the KE, the chain, the constants and link mask, the
    momenta; each output once: the scale, ke_a, the chain, the shift)
    over the memory rate.  Both are far under a launch's few
    microseconds: the kernel is bound by launch latency."""
    R = rows // B
    ops = rows * halves * steps * nh_chain_ops(M)
    chain = rows * (3 * M + 1)
    inputs = (rows + chain + B * (M + 2)) * itemsize + B * M
    outputs = (2 * rows + chain) * itemsize
    if cm:
        inputs += 4 * R * itemsize
        outputs += 3 * R * itemsize if halves == 2 else 0
    t_ops = ops / PEAK_FP64_FLOPS
    t_bytes = (inputs + outputs) / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
