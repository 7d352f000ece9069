"""Spatial domain decomposition of the cell-pair sweep: each rank holds
only its x-slab of the sorted fields plus halo planes exchanged on a ring
(the JAX package's parallel/domain.py: stencil_window :41,
make_sharded_pair_sweep :47, sorted_blocks_from_cellsort :173).

The JAX function runs the full +/- stencil over extended coordinates
(:29-38 there): every pair is summed twice, once from each side, and no
reaction goes back.  Kernel B1 sums the half stencil with Newton
reactions, half the pair work, so the port's decomposition is the half
stencil's: the half stencil reaches only forward in x (every offset has
ox >= 0), so a rank's slab needs only the `window[0]` planes after it,
the right halo, which the next rank on the ring sends.  B1 runs on a
local block of (slab + halo) planes, open in x, with a home-slab range
of the slab's cells: its neighbour map never leaves the block from a
home cell, and the reverse map's entries that would (the reactions of
the previous rank's cells, which it sums itself) point at a halo cell,
outside the home range, so the gather reads nothing there.  The
reactions that fall in the halo are the next rank's: they go back on
the ring and are added to its first planes.  The result is the
whole-grid sweep's, each pair summed once, on the card's kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..forces import cellpair
from ..ops import sweep
from . import comm

_FLOAT_FIELDS = ("x", "y", "z", "q", "sig", "seps")


def stencil_window(cfg, box) -> tuple:
    """Cell-plane reach of the cutoff stencil per dimension at the
    (3,) box diagonal `box`."""
    cell = np.asarray(box, np.float64) / np.array(cfg.grid)
    return tuple(int(np.ceil(cfg.r_list / cell[d])) for d in range(3))


def block_config(cfg, n_ranks: int, window: tuple):
    """The local config of one rank: its slab of gx / n_ranks planes and
    the window[0] halo planes after it, (loc_x + w, gy, gz) cells, open
    in x (neighbour and reverse maps as the module docstring says)."""
    gx, gy, gz = cfg.grid
    if cfg.n_replicas > 1 or cfg.triclinic:
        raise ValueError("the halo-exchange sweep takes one orthorhombic "
                         "system")
    if gx % n_ranks:
        raise ValueError(f"grid x dim {gx} not divisible by {n_ranks} "
                         f"ranks")
    loc_x = gx // n_ranks
    w = int(window[0])
    if loc_x < w:
        raise ValueError(f"shard x-extent {loc_x} smaller than halo {w}")
    offs = np.asarray(cfg.offsets)
    if offs[:, 0].min() < 0 or offs[:, 0].max() > w:
        raise ValueError("the halo does not cover the half stencil in x")
    grid = (loc_x + w, gy, gz)
    c3 = cellpair.cell_coords(grid)
    plane = gy * gz
    n_block = int(np.prod(grid))

    def cells(sign):
        nb3 = c3[:, None, :] + sign * offs[None, :, :]
        flat = (nb3[..., 0] * plane + (nb3[..., 1] % gy) * gz
                + nb3[..., 2] % gz)
        inside = (nb3[..., 0] >= 0) & (nb3[..., 0] < grid[0])
        # outside the block: a halo cell (never a home cell)
        return np.where(inside, flat, n_block - 1)

    # the cells and their shifts are the grid's (offset_shifts(cfg, box))
    return dataclasses.replace(cfg, grid=grid, nbr_map=cells(1),
                               rev_map=cells(-1))


def _pack(fields, lo: int, hi: int, C: int):
    """The float fields and the int fields of cells [lo, hi) as two flat
    tensors."""
    fl = torch.stack([fields[k][lo * C:hi * C] for k in _FLOAT_FIELDS])
    it = torch.cat([fields["gid"][lo * C:hi * C],
                    fields["ew"][lo * C:hi * C].reshape(-1),
                    fields["count"][lo:hi]])
    return fl, it


def _block_fields(local, halo_fl, halo_it, n_halo: int, C: int, words: int):
    """The block's fields: the slab's, then the halo's."""
    out = {k: torch.cat([local[k], halo_fl[i]])
           for i, k in enumerate(_FLOAT_FIELDS)}
    s = n_halo * C
    out["gid"] = torch.cat([local["gid"], halo_it[:s]])
    out["ew"] = torch.cat([local["ew"],
                           halo_it[s:s + s * words].reshape(s, words)])
    out["count"] = torch.cat([local["count"], halo_it[s + s * words:]])
    return out


def make_sharded_pair_sweep(mesh, axis: str, cfg, window: tuple,
                            alpha: float, coulomb_scale: float,
                            excl_skip: bool = False, method: str = "ewald",
                            krf: float = 0.0, crf: float = 0.0,
                            r_switch=None):
    """f(local_fields, box) -> (energy, local slot forces (n_loc C, 3)):
    the direct-space sweep with the sorted fields held as x-slabs over
    `mesh[axis]` (this rank's: `slab_fields`), on B1 in float32 (its plain
    version on the CPU and in float64).  The energy is the whole sweep's
    (all-reduced); the forces are this rank's slab's slots.  window: from
    stencil_window; the Coulomb kind and the switch as ops/sweep.py::
    pair_forces.  Refuses what the JAX function refuses: a grid x that
    does not divide into the ranks, a slab narrower than the halo."""
    n = mesh.size(axis)
    bcfg = block_config(cfg, n, window)
    C, words = cfg.capacity, cfg.excl_words
    plane = cfg.grid[1] * cfg.grid[2]
    n_loc = cfg.grid[0] // n * plane
    n_halo = int(window[0]) * plane
    kw = dict(excl_skip=excl_skip, method=method, krf=krf, crf=crf,
              r_switch=r_switch, cells=(0, n_loc))

    def apply(local, box):
        # the next rank's first window planes are this rank's right halo
        fl, it = _pack(local, 0, n_halo, C)
        _, halo_fl = comm.ring_exchange(mesh, axis, send_left=fl)
        _, halo_it = comm.ring_exchange(mesh, axis, send_left=it)
        block = _block_fields(local, halo_fl, halo_it, n_halo, C, words)
        shifts = cellpair.offset_shifts(cfg, box)    # the grid's cells
        f = sweep.pair_forces(block, bcfg, shifts, alpha, coulomb_scale,
                              **kw)
        e = sweep.pair_energy(block, bcfg, shifts, alpha, coulomb_scale,
                              **kw)
        # the reactions on the halo are the next rank's first planes'
        back, _ = comm.ring_exchange(mesh, axis,
                                     send_right=f[n_loc * C:].contiguous())
        f = f[:n_loc * C].clone()
        f[:n_halo * C] += back
        return comm.all_reduce_sum(mesh, axis, e.double()), f

    return apply


def sorted_blocks_from_cellsort(params, positions, box, cellsort, cfg,
                                exact=None) -> dict:
    """The sorted fields of the whole grid (forces/cellpair.py::
    sorted_fields, the layout every sweep takes), x-major, so that a
    contiguous range of cells is an x-slab."""
    return cellpair.sorted_fields(params, positions, box, cellsort, cfg,
                                  exact)


def slab_fields(fields, cfg, mesh, axis: str) -> dict:
    """This rank's x-slab of the whole grid's sorted fields."""
    n = mesh.size(axis)
    C = cfg.capacity
    m = cfg.n_cells // n
    lo = mesh.index(axis) * m
    return {k: (v[lo:lo + m] if k == "count" else v[lo * C:(lo + m) * C])
            .contiguous() for k, v in fields.items()}
