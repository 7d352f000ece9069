"""Dense all-pairs direct-space sum: the strategy of small systems.

For a few thousand atoms the cutoff sphere fills most of the box, so the
JAX package sends such systems (n <= 4096, or a non-periodic method) to
an all-pairs sweep over the full ordered pair matrix in row blocks
(forces/dense.py::pair_energy_forces there, outside Pallas): each
ordered pair (i, j) is evaluated in row i's block, so row forces are
complete after one row sum (no reactions, no neighbour structure) and the
energy is half the sum.  Exclusions are a static (N, N) mask.  The same
here, in plain PyTorch: a sum that the JAX package leaves to XLA has no
TPU kernel to port.

The pair function is the cell-pair sweep's (cellpair.make_pair_eg: LJ +
Ewald real space, with the A&S erfc in float32 and the exact erfc in
float64, as the JAX package's make_pair_eg chooses by type; or the
reaction field; or plain Coulomb; LJ switched where the force has a
switch), with the JAX dense sweep's two flags:
`periodic` (minimum image: per component for a (3,) diagonal box, the
sequential c -> b -> a rounding of forces/boxutils.py for a (3, 3)
triclinic one, as forces/dense.py:87 there) and `use_cutoff` (the
cutoff test), false for NoCutoff and CutoffNonPeriodic as there.
Float32 displacements are formed in float64 from the compensated
positions (`exact`) where given, and rounded once
(forces/cellpair.py::sorted_fields does the same).
"""

from __future__ import annotations

import torch

from . import boxutils, cellpair

# elements of one (R, rows, N) block: bounds each temporary (on the card a
# replica ensemble takes larger blocks, fewer launches a pass: one force
# pass of 64 x 4,000 atoms in 343 ms against 709 with BLOCK_ELEMS on an
# NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py phase 16)
BLOCK_ELEMS = 1 << 21
BLOCK_ELEMS_ENSEMBLE_CUDA = 1 << 25


def pair_energy_forces(params, positions, box, pair_mask, cutoff,
                       alpha, coulomb_scale, with_energy=True, exact=None,
                       periodic=True, use_cutoff=True, method="ewald",
                       krf=0.0, crf=0.0, r_switch=None, n_replicas=1,
                       row_range=None):
    """(energy, forces (N, 3)) of the direct-space sum over all ordered
    pairs not masked out; energy None without with_energy.  r_switch:
    the LJ switch's start (None: no switch), ending at the cutoff.
    n_replicas = R: R replica-major copies of one n0-atom system, each
    summed over its own (n0, n0) block (pair_mask is one replica's), all
    in one batched pass: the block-diagonal sum of a replica ensemble
    (the energy is the replicas' total).  row_range: (lo, hi), the rows
    of each replica's block summed (one rank's share, parallel/
    sharded.py): their forces, the other rows' zero, and half their
    pairs' energy; all rows by default."""
    N = positions.shape[0]
    R = int(n_replicas)
    n = N // R
    dtype = positions.dtype
    erfc = (cellpair.erfc_approx if dtype == torch.float32
            else torch.special.erfc)
    pair_eg = cellpair.make_pair_eg(method, alpha, krf, crf, erfc, r_switch,
                                    cutoff)
    q = params["charge"].reshape(R, n)
    sig = params["sigma"].reshape(R, n)
    seps = torch.sqrt(params["eps"]).reshape(R, n)
    qa = coulomb_scale * q
    src = (positions if exact is None else exact).reshape(R, n, 3)
    box = box.to(src.dtype)
    triclinic = box.dim() == 2
    cutoff2 = cutoff * cutoff
    elems = (BLOCK_ELEMS_ENSEMBLE_CUDA
             if R > 1 and positions.device.type == "cuda" else BLOCK_ELEMS)
    rows = max(1, min(n, elems // max(R * n, 1)))
    lo, hi = (0, n) if row_range is None else (int(v) for v in row_range)
    if not 0 <= lo <= hi <= n:
        raise ValueError(f"row range {row_range} outside [0, {n}]")
    energy = positions.new_zeros(()) if with_energy else None
    forces = torch.zeros((R, n, 3), dtype=dtype, device=positions.device)
    zero = torch.zeros((), dtype=dtype, device=positions.device)
    for o in range(lo, hi, rows):
        sl = slice(o, min(o + rows, hi))
        d = []
        for c in range(3):
            dc = src[:, sl, c][:, :, None] - src[:, :, c][:, None, :]
            if periodic and not triclinic:
                dc = dc - box[c] * torch.round(dc / box[c])
            d.append(dc)
        if periodic and triclinic:
            d = boxutils.min_image(torch.stack(d, dim=-1), box).unbind(-1)
        d = [dc.to(dtype) for dc in d]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        valid = pair_mask[sl][None] & (r2 < cutoff2) if use_cutoff \
            else pair_mask[sl][None]
        r2s = torch.where(valid, torch.clamp(r2, min=1e-6),
                          torch.ones_like(r2))
        inv_r = torch.rsqrt(r2s)
        inv_r2 = inv_r * inv_r
        qq = qa[:, sl, None] * q[:, None, :]
        sg = 0.5 * (sig[:, sl, None] + sig[:, None, :])
        ep = seps[:, sl, None] * seps[:, None, :]
        e, g = pair_eg(qq, sg, ep, r2s, inv_r, inv_r2)
        g2 = torch.where(valid, -2.0 * g, zero)
        if with_energy:
            energy = energy + 0.5 * torch.sum(torch.where(valid, e, zero))
        forces[:, sl] = torch.stack([torch.sum(g2 * dc, dim=2) for dc in d],
                                    dim=2)
    return energy, forces.reshape(N, 3)
