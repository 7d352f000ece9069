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

The block's stencil and its x reach are the caller's: the grid's half
stencil and `window[0]` planes by default; the state-resident engine
(parallel/resident.py::resident_sweep) sweeps through this module too,
with the untrimmed half stencil of window (w + 2, w_y, w_z) and a halo
of w + 2 planes, the reach its clamped binning needs.
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


def block_config(cfg, n_ranks: int, window: tuple, offsets=None):
    """The local config of one rank: its slab of gx / n_ranks planes and
    the window[0] halo planes after it, (loc_x + w, gy, gz) cells, open
    in x (neighbour and reverse maps as the module docstring says).
    offsets: the block's half stencil, self first (None: the grid's);
    given, the block's window is `window` and nothing is trimmed.  The
    halo must reach as far in x as the stencil does."""
    gx, gy, gz = cfg.grid
    if cfg.n_replicas > 1 or cfg.triclinic:
        raise ValueError("the halo-exchange sweep takes one orthorhombic "
                         "system")
    if not cfg.regular:
        raise ValueError(
            f"the halo-exchange sweep takes a regular grid (>= 2w+1 cells "
            f"per dimension); got grid {cfg.grid}, window {cfg.window}")
    if gx % n_ranks:
        raise ValueError(f"grid x dim {gx} not divisible by {n_ranks} "
                         f"ranks")
    loc_x = gx // n_ranks
    w = int(window[0])
    if loc_x < w:
        raise ValueError(f"shard x-extent {loc_x} smaller than halo {w}")
    offs = np.asarray(cfg.offsets if offsets is None else offsets)
    if offs[:, 0].min() < 0 or offs[:, 0].max() > w:
        raise ValueError("the halo does not cover the half stencil in x")
    own = {} if offsets is None else {
        "offsets": offs, "window": tuple(int(v) for v in window),
        "trimmed": ()}
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
                               rev_map=cells(-1), **own)


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


def _block_shifts(cfg, bcfg, box):
    """(n_off, 3) image shifts of the block's offsets on the whole grid's
    cells: o * h with h = box / cfg.grid (forces/cellpair.py::
    offset_shifts)."""
    return cellpair.offset_shifts(
        dataclasses.replace(cfg, offsets=bcfg.offsets), box)


def _halo_block(mesh, axis: str, local, n_halo: int, C: int,
                words: int) -> dict:
    """The block's fields: this rank's slab `local` and, after it, the
    next rank's first n_halo cells (its right halo), received on the
    ring."""
    fl, it = _pack(local, 0, n_halo, C)
    _, halo_fl = comm.ring_exchange(mesh, axis, send_left=fl)
    _, halo_it = comm.ring_exchange(mesh, axis, send_left=it)
    return _block_fields(local, halo_fl, halo_it, n_halo, C, words)


def _return_reactions(mesh, axis: str, f, n_loc: int, n_halo: int,
                      C: int):
    """The slab's slot forces (n_loc C, 3) from the block's: the
    reactions on the halo go back on the ring to the next rank, and
    those the previous rank sends are added to the slab's first n_halo
    cells."""
    back, _ = comm.ring_exchange(mesh, axis,
                                 send_right=f[n_loc * C:].contiguous())
    f = f[:n_loc * C].clone()
    f[:n_halo * C] += back
    return f


class HaloSweep:
    """The halo-exchange sweep of one rank (make_sharded_pair_sweep):
    `forces`, this rank's `energy` share, or both at one exchange
    (calling it); `block` gives the block's inputs as B1 takes them."""

    def __init__(self, mesh, axis, cfg, window, alpha, coulomb_scale,
                 excl_skip, kw, offsets, resident, use_kernel):
        n = mesh.size(axis)
        self.mesh, self.axis, self.cfg = mesh, axis, cfg
        self.bcfg = block_config(cfg, n, window, offsets)
        plane = cfg.grid[1] * cfg.grid[2]
        self.n_loc = cfg.grid[0] // n * plane
        self.n_halo = int(window[0]) * plane
        self.alpha, self.coulomb_scale = alpha, coulomb_scale
        self.kw = dict(excl_skip=excl_skip, cells=(0, self.n_loc), **kw)
        self.resident, self.use_kernel = resident, use_kernel

    def block(self, local, box):
        """(block fields, block config, shifts, B1's keyword arguments)
        of this rank's slab fields `local`: a ring exchange, so every
        rank calls it."""
        cfg = self.cfg
        block = _halo_block(self.mesh, self.axis, local, self.n_halo,
                            cfg.capacity, cfg.excl_words)
        return (block, self.bcfg, _block_shifts(cfg, self.bcfg, box),
                dict(self.kw))

    def _sum(self, block, shifts, energy: bool):
        """The block's energy (float64) or slot forces: B1 (its plain
        version on the CPU), or with use_kernel off the plain sweep with
        the exact erfc (float64, forces/nonbonded.py::CellPairTerm)."""
        args = (block, self.bcfg, shifts, self.alpha, self.coulomb_scale)
        if self.use_kernel:
            fn = sweep.pair_energy if energy else sweep.pair_forces
            out = fn(*args, resident=self.resident, **self.kw)
            return out.double() if energy else out
        kw = {k: v for k, v in self.kw.items() if k != "excl_skip"}
        e, f = cellpair.sweep(*args, with_energy=energy, **kw)
        return e.double() if energy else f

    def _slab(self, f):
        return _return_reactions(self.mesh, self.axis, f, self.n_loc,
                                 self.n_halo, self.cfg.capacity)

    def forces(self, local, box):
        """This rank's slab slot forces (n_loc C, 3)."""
        block, _, shifts, _ = self.block(local, box)
        return self._slab(self._sum(block, shifts, False))

    def energy(self, local, box):
        """This rank's share of the energy (float64, 0-d): its home
        cells' stencils."""
        block, _, shifts, _ = self.block(local, box)
        return self._sum(block, shifts, True)

    def __call__(self, local, box):
        """(the whole sweep's energy, all-reduced; this rank's slab slot
        forces)."""
        block, _, shifts, _ = self.block(local, box)
        f = self._sum(block, shifts, False)
        e = self._sum(block, shifts, True)
        f = self._slab(f)
        return comm.all_reduce_sum(self.mesh, self.axis, e), f


def make_sharded_pair_sweep(mesh, axis: str, cfg, window: tuple,
                            alpha: float, coulomb_scale: float,
                            excl_skip: bool = False, method: str = "ewald",
                            krf: float = 0.0, crf: float = 0.0,
                            r_switch=None, offsets=None,
                            resident: bool = False,
                            use_kernel: bool = True) -> HaloSweep:
    """The direct-space sweep with the sorted fields held as x-slabs over
    `mesh[axis]` (this rank's: `slab_fields`), on B1 in float32 (its plain
    version on the CPU and in float64): f(local_fields, box) -> (the
    whole sweep's energy, all-reduced; this rank's slab slot forces
    (n_loc C, 3)), and f.forces / f.energy for one of the two.  window:
    from stencil_window, its x the halo's planes; offsets: the block's
    half stencil (block_config; None: the grid's); the Coulomb kind and
    the switch as ops/sweep.py::pair_forces; resident: B1's launches
    count under the resident block's keys (parallel/resident.py);
    use_kernel False: the plain sweep with the exact erfc.  Refuses what
    the JAX function refuses: a grid x that does not divide into the
    ranks, a slab narrower than the halo."""
    return HaloSweep(mesh, axis, cfg, window, alpha, coulomb_scale,
                     excl_skip, dict(method=method, krf=krf, crf=crf,
                                     r_switch=r_switch),
                     offsets, resident, use_kernel)


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
