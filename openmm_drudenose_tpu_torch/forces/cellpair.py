"""Cell-pair sweep: cell sort, sorted fields and the plain direct-space sum.

Atoms are sorted into fixed-capacity cells every `rebuild_interval` steps
and the direct-space sum runs over (C x C) blocks between each cell and a
static half stencil of neighbour cells (Newton's third law credits each
pair's reaction to the neighbour).  Coordinates are cell-local (box-frame
position minus cell centre), so for stencil offset o the pair displacement
is a_loc - (b_loc + o*h): periodic wraps vanish into the per-offset shift.
Exclusions are a bitmask over atom-index differences within a window W,
kept in 31-bit words.

The same plan and physics as the JAX package's forces/cellpair.py
(make_config :148, build_cellsort :432, _sorted_arrays :880,
_sweep_regular :667, make_pair_eg :606), for orthorhombic boxes and
triclinic ones in reduced form (forces/boxutils.py): there the cells are
cells of fractional space, the grid and the stencil are planned in the
plane-width metric (the max-gap trim), atoms are binned by their
fractional coordinates, the box frame is pos - image @ box, the centres
are ((c3 + 0.5) / g) @ box and offset o's shift is (o / g) @ box, so the
identity a_loc - (b_loc + shift) and the kernels are unchanged.

A flattened replica ensemble (parallel/flatrep.py; the JAX package's
make_ensemble_config :250) embeds R = rx * rz copies of one replica's
grid (px, py, pz) in one extended grid (rx px, py, rz pz): replica
r = bx rz + bz owns the x band bx and the z band bz.  Its atoms are
binned in the replicas' shared box frame and shifted into its bands, the
stencil wraps modulo the periods inside each band (`neighbor_map`), and
the centres and shifts are one replica's, so replicas never read each
other and the kernels see one grid.

Flat-ensemble NPT (the JAX package's SimState.rep_scale): replica r's box
is the template box times s_r, on the one template grid.  Atoms are
binned at p / s_r in the template frame (`stored`), formed in float64;
the stencil latch reads r_list / min(s) (the JAX :462-463).  The fields
stay physical: an atom's cell-local coordinate is p - s_r (image @ box +
centre), formed in float64 and rounded once, and offset o's shift in
replica r is s_r times the template's, an (R, n_off, 3) table
(`offset_shifts` with the scales).  r^2, the cutoff test and the forces
are then physical as they stand; the JAX package sweeps the stored
coordinates instead, with r^2 times s_r^2 and the forces times s_r
(:714-716, :874-877).
`pair_tiles` is the plain pair sum and `sweep` the energy+force sum over
it, with Ewald real-space or reaction-field Coulomb (`make_pair_eg`);
ops/sweep.py and ops/sweep_chunked.py hold the hand-written kernels.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import scatter
from ..utils import tables
from . import boxutils


@dataclasses.dataclass
class CellSort:
    slot_atom: torch.Tensor      # (S,) atom per cell slot (N = empty)
    inv_slot: torch.Tensor       # (N,) slot of each atom
    overflow: torch.Tensor       # () bool, latched across rebuilds
    ref_positions: torch.Tensor  # (N, 3) at the rebuild
    image: torch.Tensor          # (N, 3) floor(fractional pos) at the rebuild
    stencil_invalid: torch.Tensor
    drift_exceeded: torch.Tensor
    # an excluded pair was binned >= 2 cells apart: the kernel's skip of
    # the exclusion test at far offsets would then miss it (set only when
    # build_cellsort is given the excluded pairs)
    excl_span_exceeded: torch.Tensor = None


@dataclasses.dataclass(frozen=True, eq=False)
class CellPairConfig:
    cutoff: float
    skin: float
    grid: tuple                  # cells per dimension
    capacity: int                # atoms per cell (C)
    offsets: np.ndarray          # (n_off, 3) half stencil, self first
    nbr_map: np.ndarray          # (n_cells, n_off) neighbour cell per offset
    rebuild_interval: int
    excl_window: int             # W
    excl_words: int              # ceil((2W+1)/31)
    half_stencil: bool
    regular: bool
    window: tuple
    trimmed: tuple = ()
    triclinic: bool = False
    # a flattened replica ensemble: the replica count and one replica's
    # x and z periods (0: no embedding along that axis)
    n_replicas: int = 1
    x_period: int = 0
    z_period: int = 0
    # the reverse neighbour map (the cell whose neighbour at offset o is
    # the row's cell), where it is not the periodic one: a slab block
    # open in x (parallel/domain.py)
    rev_map: np.ndarray | None = None

    @property
    def r_list(self) -> float:
        return self.cutoff + self.skin

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.grid))

    @property
    def n_offsets(self) -> int:
        return len(self.offsets)

    @property
    def phys_grid(self) -> tuple:
        """One replica's grid: the periods of an embedded ensemble, the
        grid otherwise."""
        return (self.x_period or self.grid[0], self.grid[1],
                self.z_period or self.grid[2])

    @property
    def bands(self) -> tuple:
        """(rx, rz): the replica bands along x and z ((1, 1) without
        embedding)."""
        px, _, pz = self.phys_grid
        return self.grid[0] // px, self.grid[2] // pz


def _neighbor_offsets(grid, window) -> np.ndarray:
    def per_dim(n, w):
        if n >= 2 * w + 1:
            return range(-w, w + 1)
        return range(0, min(n, 2 * w + 1))
    return np.array([(a, b, c)
                     for a in per_dim(grid[0], window[0])
                     for b in per_dim(grid[1], window[1])
                     for c in per_dim(grid[2], window[2])], np.int64)


def cell_coords(grid) -> np.ndarray:
    """(n_cells, 3) index of every cell of `grid` (x-major)."""
    c = np.arange(int(np.prod(grid)))
    return np.stack([c // (grid[1] * grid[2]), (c // grid[2]) % grid[1],
                     c % grid[2]], axis=1)


def neighbor_map(grid, periods, offsets, sign: int = 1) -> np.ndarray:
    """(n_cells, n_off): the cell at offset sign * o of every cell, the
    offset wrapped modulo each dimension's period inside the band that
    holds the cell (period = grid: one band, the plain periodic wrap);
    sign -1 gives the reverse map (the cell whose neighbour at o is the
    row's cell)."""
    g, p = np.asarray(grid), np.asarray(periods)
    c3 = cell_coords(grid)
    band, loc = c3 // p, c3 % p
    nb3 = band[:, None, :] * p + (loc[:, None, :] + sign
                                  * np.asarray(offsets)[None, :, :]) % p
    return (nb3[..., 0] * g[1] + nb3[..., 1]) * g[2] + nb3[..., 2]


def _stencil(window, cell_size, r_list, triclinic):
    """The half stencil of window `window`, self offset first, with the
    offsets whose closest cell-to-cell approach exceeds r_list dropped:
    (offsets, the dropped offsets' gap counts).  Triclinic plane gaps
    are not orthogonal components, so their bound is the largest of
    them, not the norm.  On a grid of fewer than 2w + 1 cells in a
    dimension, offsets o and o - g there reach the same cell through
    different images (shifts o h and (o - g) h); each is kept, and the
    half stencil still holds every (cell pair, image) once."""
    wx, wy, wz = window
    sel = [(a, b, c) for a in range(-wx, wx + 1)
           for b in range(-wy, wy + 1) for c in range(-wz, wz + 1)
           if (a, b, c) > (0, 0, 0)]
    offsets = np.array([[0, 0, 0]] + sel, np.int64)
    gap = np.maximum(np.abs(offsets) - 1, 0) * cell_size[None, :]
    reach = (np.max(gap, axis=1) if triclinic
             else np.sqrt(np.sum(gap * gap, axis=1)))
    drop = reach > r_list
    trimmed = ()
    if np.any(drop):
        trimmed = tuple(map(tuple, np.maximum(
            np.abs(offsets[drop]) - 1, 0).tolist()))
        offsets = offsets[~drop]
    return offsets, trimmed


def _exclusion_window(exc_i, exc_j) -> tuple:
    """(W, words): the largest index difference of the excluded pairs and
    the 31-bit words of a (2W + 1)-bit mask."""
    exc_i = np.asarray(exc_i, np.int64)
    exc_j = np.asarray(exc_j, np.int64)
    W = int(np.abs(exc_i - exc_j).max()) if len(exc_i) else 0
    return W, max((2 * W + 1 + 30) // 31, 1)


def _auto_capacity(per_cell: float) -> int:
    """The capacity of cells holding `per_cell` atoms with the density
    margin: 2 more, rounded up to a multiple of 8."""
    return max(int(np.ceil((int(np.ceil(per_cell)) + 2) / 8)) * 8, 8)


def make_config(cutoff: float, box, n_atoms: int, exc_i, exc_j,
                skin: float = 0.1, rebuild_interval: int = 16,
                cells_per_cutoff: int = 2, density_margin: float = 1.35,
                capacity: int | None = None,
                grid_x_multiple: int = 1) -> CellPairConfig:
    """Plan the cell grid, capacity and half stencil for a box given as
    its (3,) diagonal (orthorhombic) or its (3, 3) reduced matrix
    (triclinic: planned in the plane-width metric, where the grid must be
    regular, >= 2w+1 cells per dimension, as the JAX make_config says).
    An orthorhombic grid of fewer cells (a 500-water box at a 1.0 nm
    cutoff plans 4^3 cells of window 2) keeps the JAX plan; where the
    JAX package sweeps it with a per-pair minimum image over every
    wrapped offset (its pair_energy_forces :1037-1073), the port sweeps
    the half stencil of explicit images (`_stencil`): at most one image
    of a pair lies inside the cutoff where every box width is at least
    twice the cutoff, which this asks of such a grid.  grid_x_multiple:
    the
    x cell count rounded down to a multiple of it (at least one
    multiple), so that x-slabs split it evenly over that many ranks
    (the JAX make_config's option, forces/cellpair.py:169-174 there);
    larger cells keep the window covering r_list."""
    box_in = np.asarray(box, np.float64)
    triclinic = box_in.ndim == 2
    if triclinic:
        widths = boxutils.plane_widths(torch.as_tensor(box_in)).numpy()
        volume = float(np.prod(np.diagonal(box_in)))
    else:
        widths = box_in
        volume = float(np.prod(box_in))
    r_list = cutoff + skin
    target = r_list / cells_per_cutoff
    grid = tuple(max(int(np.floor(L / target)), 1) for L in widths)
    m = int(grid_x_multiple)
    if m > 1:
        grid = (max(grid[0] // m * m, m), grid[1], grid[2])
    cell_size = widths / np.array(grid)
    window = tuple(int(np.ceil(r_list / cell_size[d])) for d in range(3))
    if capacity is None:
        density = n_atoms / volume
        capacity = _auto_capacity(density * volume / int(np.prod(grid))
                                  * density_margin)
    regular = all(g >= 2 * w + 1 for g, w in zip(grid, window))
    if (triclinic and not regular) or any(
            g <= w for g, w in zip(grid, window)):
        raise ValueError(
            f"the cell-pair sweep needs a regular grid (>= 2w+1 cells per "
            f"dimension) for a triclinic box and more than w cells per "
            f"dimension for any box; got grid {grid}, window {window} "
            "(box too small for the cutoff; use strategy='dense')")
    if not regular and np.min(widths) < 2.0 * cutoff:
        # two images of a pair inside the cutoff (a regular grid's box
        # is wider than 2 r_list by construction)
        raise ValueError(f"box widths {np.round(widths, 6).tolist()} under "
                         f"twice the cutoff {cutoff}")
    offsets, trimmed = _stencil(window, cell_size, r_list, triclinic)
    W, n_words = _exclusion_window(exc_i, exc_j)
    return CellPairConfig(
        cutoff=float(cutoff), skin=float(skin), grid=grid,
        capacity=int(capacity), offsets=offsets,
        nbr_map=neighbor_map(grid, grid, offsets),
        rebuild_interval=int(rebuild_interval), excl_window=W,
        excl_words=n_words, half_stencil=True, regular=regular,
        window=window, trimmed=trimmed, triclinic=triclinic)


def make_ensemble_config(cutoff: float, box0, n0: int, n_replicas: int,
                         exc_i, exc_j, rx: int, rz: int, skin: float = 0.1,
                         rebuild_interval: int = 16,
                         cells_per_cutoff: int = 2,
                         density_margin: float = 1.35,
                         capacity: int | None = None) -> CellPairConfig:
    """The plan of a flattened replica ensemble (the JAX package's
    make_ensemble_config, forces/cellpair.py:250 there): rx * rz
    replicas of an n0-atom system in one orthorhombic box `box0` (its
    (3,) diagonal), replica-major, embedded in the grid (rx px, py,
    rz pz) of one replica's grid (px, py, pz); the stencil is one
    replica's and wraps inside each replica's bands.  exc_i / exc_j: the
    template replica's excluded pairs."""
    if rx * rz != n_replicas:
        raise ValueError(f"rx*rz = {rx}*{rz} != n_replicas = {n_replicas}")
    box0 = np.asarray(box0, np.float64)
    if box0.shape != (3,):
        raise ValueError("flattened replica ensembles require an "
                         "orthorhombic replica box")
    r_list = cutoff + skin
    target = r_list / cells_per_cutoff
    pgrid = tuple(max(int(np.floor(L / target)), 1) for L in box0)
    cell_size = box0 / np.array(pgrid)
    window = tuple(int(np.ceil(r_list / cell_size[d])) for d in range(3))
    if not all(g >= 2 * w + 1 for g, w in zip(pgrid, window)):
        raise ValueError(
            f"flattened ensembles need a regular per-replica grid "
            f"(>= 2w+1 cells per dim); got grid {pgrid}, window {window} — "
            f"the replica box is too small for the cutoff")
    if capacity is None:
        density = n0 / float(np.prod(box0))
        capacity = _auto_capacity(density * np.prod(cell_size)
                                  * density_margin)
    offsets, trimmed = _stencil(window, cell_size, r_list, False)
    grid = (rx * pgrid[0], pgrid[1], rz * pgrid[2])
    W, n_words = _exclusion_window(exc_i, exc_j)
    return CellPairConfig(
        cutoff=float(cutoff), skin=float(skin), grid=grid,
        capacity=int(capacity), offsets=offsets,
        nbr_map=neighbor_map(grid, pgrid, offsets),
        rebuild_interval=int(rebuild_interval), excl_window=W,
        excl_words=n_words, half_stencil=True, regular=True, window=window,
        trimmed=trimmed, n_replicas=int(n_replicas), x_period=pgrid[0],
        z_period=pgrid[2])


def rep_of_cell(cfg: CellPairConfig) -> np.ndarray:
    """(n_cells,) the replica that owns each cell (all 0 without
    embedding): r = bx * rz + bz."""
    px, _, pz = cfg.phys_grid
    c3 = cell_coords(cfg.grid)
    return (c3[:, 0] // px) * cfg.bands[1] + c3[:, 2] // pz


def local_c3(cfg: CellPairConfig) -> np.ndarray:
    """(n_cells, 3) each cell's index in its replica's own grid (the JAX
    package's _local_c3)."""
    return cell_coords(cfg.grid) % np.asarray(cfg.phys_grid)


def build_exclusion_words(n_atoms: int, exc_i, exc_j, W: int,
                          n_words: int) -> np.ndarray:
    """(N, n_words) int32: bit (d + W) set when (i, i+d) is excluded."""
    words = np.zeros((n_atoms, n_words), np.int64)
    a = np.asarray(exc_i, np.int64)
    b = np.asarray(exc_j, np.int64)
    for i, j in ((a, b), (b, a)):
        bit = j - i + W
        np.bitwise_or.at(words, (i, bit // 31), np.left_shift(1, bit % 31))
    return words.astype(np.int32)


def atom_scales(rep_scale, n_atoms: int):
    """(N,) each atom's replica scale (replica-major atoms, float64)."""
    R = rep_scale.shape[0]
    return torch.repeat_interleave(rep_scale.double(), n_atoms // R)


def cell_scales(rep_scale, cfg: CellPairConfig):
    """(n_cells,) the scale of each cell's replica (float64)."""
    rep = tables.table(cfg, "rep_of_cell", lambda: rep_of_cell(cfg),
                       rep_scale.device)
    return rep_scale.double()[rep]


def grid_table(cfg: CellPairConfig, dev, dtype) -> torch.Tensor:
    """(3,) one replica's grid (cfg.phys_grid) on the device, made once
    per config (utils/tables.py)."""
    return tables.table(cfg, "phys_grid", lambda: cfg.phys_grid, dev, dtype)


def stored(positions, rep_scale):
    """Flat-ensemble NPT stored coordinates p / s_r in float64 (the
    frame of the shared template grid); `positions` unchanged (float64)
    without scales."""
    p = positions.double()
    if rep_scale is None:
        return p
    return p / atom_scales(rep_scale.to(p.device), p.shape[0])[:, None]


def build_cellsort(positions, box, cfg: CellPairConfig,
                   excl_ij=None, rep_scale=None) -> CellSort:
    """Bin atoms into cells and fill the slot tables.  `box`: the (3,)
    diagonal, or the (3, 3) matrix of a triclinic config (binned by
    fractional coordinates formed in float64, the stencil latch in
    plane widths).  `excl_ij` (the excluded pairs as index tensors)
    switches on the excl-span latch.  An embedded ensemble bins every
    atom in the replicas' shared box frame on one replica's grid and
    shifts it into the bands of its replica (atom // n0).  rep_scale
    ((R,) float64, flat-ensemble NPT): atoms are binned at their stored
    coordinates p / s_r (`stored`), the stencil latch reads the smallest
    replica box, and ref_positions (the drift reference) are stored
    coordinates."""
    n = positions.shape[0]
    dev = positions.device
    dtype = positions.dtype
    grid = grid_table(cfg, dev, torch.int64)
    C = cfg.capacity
    n_cells = cfg.n_cells
    gridf = grid_table(cfg, dev, dtype)
    if rep_scale is not None:
        positions = stored(positions, rep_scale)

    # the static stencil covers r_list only while window * width / grid
    # >= r_list (a shrinking box could break it); per-replica scales:
    # the smallest replica box, r_list / min(s) in the template frame
    widths = boxutils.plane_widths(box)
    if rep_scale is not None:
        widths = widths * torch.min(rep_scale).to(dev, widths.dtype)
    wcell = tables.table(cfg, "window", lambda: cfg.window, dev, dtype) \
        * widths / gridf
    stencil_invalid = torch.any(wcell < cfg.r_list)
    if cfg.trimmed:
        gap = tables.table(cfg, "trimmed", lambda: cfg.trimmed, dev,
                           dtype) * (widths / gridf)
        reach = (torch.amax(gap, dim=1) if cfg.triclinic
                 else torch.sqrt(torch.sum(gap * gap, dim=1)))
        stencil_invalid = stencil_invalid | torch.any(reach <= cfg.r_list)

    if cfg.triclinic:
        fr = boxutils.frac_coords(positions.double(), box.double())
        image = torch.floor(fr)
        frac = fr - image
    else:
        image = torch.floor(positions / box)
        frac = positions / box - image
    cell3 = torch.minimum(torch.clamp((frac * gridf.to(frac.dtype)).to(
        torch.int64), min=0), grid - 1)
    if cfg.n_replicas > 1:
        px, _, pz = cfg.phys_grid
        rep = torch.arange(n, device=dev) // (n // cfg.n_replicas)
        band = torch.stack([rep // cfg.bands[1] * px,
                            torch.zeros_like(rep),
                            rep % cfg.bands[1] * pz], dim=1)
        flat3 = cell3 + band
    else:
        flat3 = cell3
    flat = (flat3[:, 0] * cfg.grid[1] + flat3[:, 1]) * cfg.grid[2] \
        + flat3[:, 2]

    excl_span = None
    if excl_ij is not None and len(excl_ij[0]):
        d3 = cell3[excl_ij[0]] - cell3[excl_ij[1]]
        d3 = torch.remainder(d3 + grid // 2, grid) - grid // 2
        excl_span = torch.any(torch.amax(torch.abs(d3), dim=1) >= 2)

    order = torch.argsort(flat, stable=True)
    sorted_flat = flat[order]
    starts = torch.searchsorted(
        sorted_flat, torch.arange(n_cells, dtype=torch.int64, device=dev))
    rank = torch.arange(n, dtype=torch.int64, device=dev) \
        - starts[sorted_flat]
    overflow = torch.any(rank >= C)
    slot = sorted_flat * C + torch.clamp(rank, max=C - 1)
    slot_atom = torch.full((n_cells * C,), n, dtype=torch.int64, device=dev)
    slot_atom[slot] = order
    inv_slot = torch.empty((n,), dtype=torch.int64, device=dev)
    inv_slot[order] = slot
    return CellSort(slot_atom=slot_atom, inv_slot=inv_slot,
                    overflow=overflow, ref_positions=positions,
                    image=image.to(torch.int64),
                    stencil_invalid=stencil_invalid,
                    drift_exceeded=torch.zeros((), dtype=torch.bool,
                                               device=dev),
                    excl_span_exceeded=excl_span)


def sorted_fields(params, positions, box, cellsort: CellSort,
                  cfg: CellPairConfig, exact=None, rep_scale=None,
                  cells=None, gid=None) -> dict:
    """Per-slot fields in cell-major order, each (n_cells * C,): cell-local
    coordinates x/y/z (box-frame position minus cell centre), charge q,
    sigma `sig`, sqrt(epsilon) `seps`, atom index `gid` (negative and
    unique on empty slots), the exclusion words `ew` (n_cells * C,
    n_words), row-major: a slot's words side by side, and per-cell
    occupancy `count` (n_cells,).  Empty slots are inert: far-away
    sentinels with q = eps = 0 and no exclusion bit.

    The local coordinates are formed in float64 and rounded once: float32
    absolute coordinates carry ~5e-7 nm of rounding in an 8 nm box, which
    a float32 subtraction of rounded cell centres would pass on to every
    pair distance.  `exact` (float64 positions, the float32 ones plus the
    integrator's compensation) replaces positions there, so the sweep
    sees the positions the integrator carries, not their rounding.

    rep_scale ((R,) float64, flat-ensemble NPT): replica r's image and
    centres are s_r times the template's, so the fields are physical
    (p - s_r (image @ box + centre), in float64, rounded once).

    cells: the range (lo, hi) of the grid's x-major cells the sort's slots
    fill (None: every cell), an x-slab; gid: (n,) each atom's id in the
    `gid` field (None: its index), as parallel/resident.py sorts a rank's
    molecules into its slab's cells under their global ids."""
    n = positions.shape[0]
    sa = cellsort.slot_atom
    pad = sa >= n
    safe = torch.where(pad, torch.zeros_like(sa), sa)
    dtype = positions.dtype
    dev = positions.device
    box64 = box.double()
    wrap = boxutils.rows_combo(cellsort.image.double(), box64)
    if rep_scale is not None:
        wrap = wrap * atom_scales(rep_scale.to(dev), n)[:, None]
    pos = (positions.double() if exact is None else exact) - wrap
    lo, hi = (0, cfg.n_cells) if cells is None else cells
    c3 = tables.table(cfg, "local_c3", lambda: local_c3(cfg), dev,
                      torch.float64)[lo:hi] + 0.5
    if cfg.triclinic:
        centers = boxutils.rows_combo(c3 * _grid_inv(cfg, dev), box64)
    else:
        centers = c3 * (box64 / grid_table(cfg, dev, torch.float64))
    if rep_scale is not None:
        centers = centers * cell_scales(rep_scale.to(dev), cfg)[:, None]
    centers = centers.repeat_interleave(cfg.capacity, dim=0)    # (S, 3)
    out = {}
    for c, name in enumerate("xyz"):
        v = torch.where(pad, torch.full_like(pos[safe, c], 1e6 * (1 + c)),
                        pos[safe, c])
        out[name] = (v - centers[:, c]).to(dtype).contiguous()
    zero = torch.zeros((), dtype=dtype, device=dev)
    out["q"] = torch.where(pad, zero, params["charge"][safe]).contiguous()
    out["sig"] = torch.where(pad, zero + 1.0,
                             params["sigma"][safe]).contiguous()
    out["seps"] = torch.where(pad, zero,
                              torch.sqrt(params["eps"][safe])).contiguous()
    slots = torch.arange(sa.shape[0], device=dev)
    ids = sa if gid is None else gid[safe]
    out["gid"] = torch.where(pad, -1 - slots, ids).to(torch.int32).contiguous()
    words = params["excl_words"][safe]                      # (S, n_words)
    out["ew"] = torch.where(pad[:, None], torch.zeros_like(words),
                            words).to(torch.int32).contiguous()
    out["count"] = torch.sum((~pad).reshape(hi - lo, cfg.capacity),
                             dim=1).to(torch.int32).contiguous()
    return out


def _grid_inv(cfg: CellPairConfig, dev) -> torch.Tensor:
    """1 / grid per dimension (one replica's), float64 (the JAX
    package's g_inv), made once per config."""
    return tables.table(cfg, "grid_inv", lambda: 1.0 / np.asarray(
        cfg.phys_grid, np.float64), dev)


def offset_shifts(cfg: CellPairConfig, box, rep_scale=None) -> torch.Tensor:
    """(n_off, 3) per-offset image shift, o * h (h = box / grid, one
    replica's grid) for a diagonal and (o / g) @ box for a triclinic
    matrix, formed in float64 and rounded once.  With rep_scale ((R,),
    flat-ensemble NPT) an (R, n_off, 3) table: replica r's shifts are
    s_r times the template's."""
    box64 = box.double()
    offs = tables.table(cfg, "offsets", lambda: cfg.offsets, box.device,
                        torch.float64)
    if cfg.triclinic:
        return boxutils.rows_combo(offs * _grid_inv(cfg, box.device),
                                   box64).to(box.dtype)
    h = box64 / grid_table(cfg, box.device, torch.float64)
    if rep_scale is not None:
        s = rep_scale.to(box.device, torch.float64)
        return (s[:, None, None] * (offs * h)[None]).to(box.dtype)
    return (offs * h).to(box.dtype)


def replica_cells(cfg: CellPairConfig) -> np.ndarray:
    """(R, cells a replica): each replica's cells in ascending order
    (the per-replica energy sums run over them in this order)."""
    rep = rep_of_cell(cfg)
    order = np.argsort(rep, kind="stable")
    return order.reshape(cfg.n_replicas, -1)


def erfc_approx(x):
    """Abramowitz & Stegun 7.1.26 rational erfc (|err| < 1.5e-7, x >= 0),
    the form the sweep kernel uses."""
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return poly * torch.exp(-x * x)


def switch(r2, inv_r, r_on: float, r_off: float):
    """OpenMM's LJ switch, the JAX package's _switch (forces/cellpair.py:
    587-596 there): S(t) = 1 - 10 t^3 + 15 t^4 - 6 t^5 with t = (r - r_on)
    / (r_off - r_on) clamped to [0, 1], and dS/dr^2."""
    r = r2 * inv_r
    t = torch.clamp((r - r_on) / (r_off - r_on), 0.0, 1.0)
    s = 1.0 + t * t * t * (-10.0 + t * (15.0 - 6.0 * t))
    ds_dt = t * t * (-30.0 + t * (60.0 - 30.0 * t))
    return s, ds_dt / (r_off - r_on) * 0.5 * inv_r


def make_pair_eg(method: str, alpha: float = 0.0, krf: float = 0.0,
                 crf: float = 0.0, erfc_fn=None, r_switch=None,
                 cutoff: float = 0.0):
    """The JAX package's make_pair_eg (forces/cellpair.py:606-660 there)
    without the exclusion flag: f(qq, sig, eps, r2, inv_r, inv_r2) ->
    (e, dE/dr^2) of LJ plus one Coulomb kind: "ewald" (erfc(alpha r) / r,
    erfc_fn defaulting to the exact erfc), "rf" (the reaction field qq
    (1/r + krf r^2 - crf)) or "none" (plain qq / r).  r_switch (None: no
    switch): the LJ is switched from r_switch to `cutoff`, g = g_lj S +
    e_lj dS/dr^2, e = e_lj S, as the JAX function does."""
    if method not in ("ewald", "rf", "none"):
        raise ValueError(f"unknown Coulomb kind {method!r}")
    erfc = erfc_fn or torch.special.erfc
    two_over_sqrt_pi = 2.0 / math.sqrt(math.pi)

    def f(qq, sig, eps, r2, inv_r, inv_r2):
        x6 = (sig * sig * inv_r2) ** 3
        e_lj = 4.0 * eps * x6 * (x6 - 1.0)
        g_lj = -4.0 * eps * (6.0 * x6 * x6 - 3.0 * x6) * inv_r2
        if r_switch is not None:
            s, ds = switch(r2, inv_r, r_switch, cutoff)
            g_lj = g_lj * s + e_lj * ds
            e_lj = e_lj * s
        if method == "ewald":
            ar = alpha * r2 * inv_r
            erfc_ar = erfc(ar)
            e_c = qq * erfc_ar * inv_r
            g_c = -0.5 * qq * inv_r2 * (erfc_ar * inv_r + two_over_sqrt_pi
                                        * alpha * torch.exp(-ar * ar))
        elif method == "rf":
            e_c = qq * (inv_r + krf * r2 - crf)
            g_c = qq * (-0.5 * inv_r2 * inv_r + krf)
        else:
            e_c = qq * inv_r
            g_c = -0.5 * qq * inv_r2 * inv_r
        return e_lj + e_c, g_lj + g_c

    return f


# calls of the plain pair sum on CUDA tensors (the kernels' plain
# versions, compared with them on the card, and the float64 reference
# contexts); a float32 main path on the card makes none
plain_sweeps = {"cuda": 0}

# elements of one (n_cells, C, P*C) pair tile: bounds each temporary of
# the chunked sweep (one offset at a time at 100k atoms, ~31 MB in f32;
# small tiles also keep the CPU sweep in cache)
TILE_ELEMS = 1 << 19


def check_cells(cfg: CellPairConfig, cells) -> tuple:
    """(lo, hi) of a home-slab range of x-major cell indices, all the
    cells for None; raises unless 0 <= lo <= hi <= n_cells."""
    if cells is None:
        return 0, cfg.n_cells
    lo, hi = (int(c) for c in cells)
    if not 0 <= lo <= hi <= cfg.n_cells:
        raise ValueError(f"cell range {cells} outside [0, {cfg.n_cells}]")
    return lo, hi


def pair_tiles(fields, cfg: CellPairConfig, shifts, alpha: float,
               coulomb_scale: float, with_energy: bool = True,
               excl_skip: bool = False, erfc_fn=None, method: str = "ewald",
               krf: float = 0.0, crf: float = 0.0, cell_energy=False,
               r_switch=None, cells=None):
    """The half-stencil pair sum, one chunk of offsets at a time.

    Yields (ob, b, g2, d, e) per chunk: the offset indices `ob` (the self
    offset alone first), the neighbour cell of every home cell at each of
    them `b` (nh, P), the pair factor g2 = -2 dE/dr^2 with excluded and
    out-of-range pairs zeroed (nh, C, P*C), the displacements d = a - b
    per component and the chunk's energy (None without with_energy; with
    cell_energy each home cell's, (nh,)).  cells: the home-slab range
    (lo, hi) of x-major cell indices whose stencils are summed (an
    x-slab of the grid, parallel/sharded.py), all nc cells by default;
    nh = hi - lo, and the neighbours b may lie anywhere.  shifts:
    (n_off, 3), or (R, n_off, 3) per replica (flat-ensemble NPT), read at each home
    cell's replica.  A pair's force on the home slot is g2 * d, its
    reaction on the neighbour slot -g2 * d.  excl_skip drops the exclusion test at offsets
    with any |o| >= 2, as the kernels do (sound while the cell sort's
    excl-span latch stays clear).  method, krf, crf: the Coulomb kind
    (make_pair_eg); r_switch: the LJ switch's start (None: no switch),
    ending at the cutoff.  erfc_fn defaults to the exact erfc; the
    kernels' plain versions pass erfc_approx."""
    nc, C = cfg.n_cells, cfg.capacity
    lo, hi = check_cells(cfg, cells)
    nh = hi - lo
    x, y, z = (fields[k].reshape(nc, C) for k in "xyz")
    dtype = x.dtype
    dev = x.device
    if dev.type == "cuda":
        plain_sweeps["cuda"] += 1
    q = fields["q"].reshape(nc, C)
    sig = fields["sig"].reshape(nc, C)
    seps = fields["seps"].reshape(nc, C)
    gid = fields["gid"].reshape(nc, C).to(torch.int64)
    ew = fields["ew"][lo * C:hi * C].reshape(
        nh, C, fields["ew"].shape[-1]).to(torch.int64)
    W = cfg.excl_window
    cutoff2 = cfg.cutoff * cfg.cutoff
    pair_eg = make_pair_eg(method, alpha, krf, crf, erfc_fn, r_switch,
                           cfg.cutoff)
    nbr = tables.table(cfg, "nbr_map", lambda: cfg.nbr_map, dev)[lo:hi]
    # the home cells' rows (all of them for the full range)
    xh, yh, zh, qh, sigh, sepsh, gidh = (
        a[lo:hi] for a in (x, y, z, q, sig, seps, gid))
    qa = coulomb_scale * qh
    far = np.max(np.abs(cfg.offsets), axis=1) >= 2
    if shifts.dim() == 3:
        # each home cell's replica's table: (nh, n_off, 3)
        shifts = shifts[tables.table(cfg, "rep_of_cell",
                                     lambda: rep_of_cell(cfg), dev)[lo:hi]]

    P_max = max(1, TILE_ELEMS // (max(nh, 1) * C * C))
    chunks = [[0]]
    rest = list(range(1, cfg.n_offsets))
    chunks += [rest[i:i + P_max] for i in range(0, len(rest), P_max)]
    far_t = None
    for ob in chunks:
        self_block = ob == [0]
        P = len(ob)
        # a chunk is a run of consecutive offsets: sliced, not gathered
        # by a host-made index
        o0, o1 = ob[0], ob[-1] + 1
        b = nbr[:, o0:o1]                                     # (nh, P)
        # (1, P, 3), or (nh, P, 3) per home cell
        t = shifts[o0:o1][None] if shifts.dim() == 2 else shifts[:, o0:o1]
        d = []
        for comp, (src, home) in enumerate(((x, xh), (y, yh), (z, zh))):
            bv = (src[b] + t[:, :, comp:comp + 1]).reshape(nh, P * C)
            d.append(home[:, :, None] - bv[:, None, :])       # (nh, C, P*C)
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        valid = r2 < cutoff2
        if self_block:
            valid = valid & ~torch.eye(C, dtype=torch.bool, device=dev)
        check = [not (excl_skip and far[o]) for o in ob]
        if W > 0 and any(check):
            dg = gid[b].reshape(nh, P * C)[:, None, :] - gidh[:, :, None]
            in_win = torch.abs(dg) <= W
            bit = torch.where(in_win, dg + W, torch.zeros_like(dg))
            # bit dg + W of the home slot's mask: bit % 31 of word bit // 31
            if ew.shape[2] == 1:
                word = ew
            else:
                word = torch.gather(ew, 2, bit // 31)
            excl = in_win & (((word >> (bit % 31)) & 1) == 1)
            if not all(check):
                # some offsets skip the test (excl_skip at far offsets)
                if far_t is None:
                    far_t = tables.table(cfg, "far_offsets", lambda: far,
                                         dev)
                mask = ~far_t[o0:o1]
                excl = excl & mask.repeat_interleave(C)[None, None, :]
            keep = valid & ~excl
        else:
            keep = valid
        r2s = torch.where(valid, torch.clamp(r2, min=1e-6),
                          torch.ones_like(r2))
        inv_r = torch.rsqrt(r2s)
        inv_r2 = inv_r * inv_r
        qq = qa[:, :, None] * q[b].reshape(nh, P * C)[:, None, :]
        sg = 0.5 * (sigh[:, :, None] + sig[b].reshape(nh, P * C)[:, None, :])
        ep = sepsh[:, :, None] * seps[b].reshape(nh, P * C)[:, None, :]
        e, g = pair_eg(qq, sg, ep, r2s, inv_r, inv_r2)
        zero = torch.zeros((), dtype=dtype, device=dev)
        g2 = torch.where(keep, -2.0 * g, zero)
        e_chunk = None
        if with_energy:
            factor = 0.5 if self_block else 1.0
            kept = torch.where(keep, e, zero)
            e_chunk = factor * (torch.sum(kept, dim=(1, 2)) if cell_energy
                                else torch.sum(kept))
        yield ob, b, g2, d, e_chunk


def sweep(fields, cfg: CellPairConfig, shifts, alpha: float,
          coulomb_scale: float, with_energy: bool = True,
          excl_skip: bool = False, erfc_fn=None, method: str = "ewald",
          krf: float = 0.0, crf: float = 0.0, per_replica: bool = False,
          r_switch=None, cells=None):
    """Plain direct-space sum over the half stencil (pair_tiles), each
    reaction added straight onto its neighbour slot.

    Returns (energy, slot forces (n_cells * C, 3)); with per_replica the
    energy is (R,), each replica's cells summed in ascending order
    (`replica_cells`).  shifts: as pair_tiles.  cells: the home-slab
    range (lo, hi) (pair_tiles): only its cells' stencils are summed,
    and their reactions land wherever the stencil reaches; the slabs of
    a partition of the cells sum to the whole."""
    nc, C = cfg.n_cells, cfg.capacity
    lo, hi = check_cells(cfg, cells)
    dtype, dev = fields["x"].dtype, fields["x"].device
    fx, fy, fz = (torch.zeros((nc, C), dtype=dtype, device=dev)
                  for _ in range(3))
    energy = torch.zeros((nc,) if per_replica else (), dtype=dtype,
                         device=dev)
    for ob, b, g2, d, e in pair_tiles(fields, cfg, shifts, alpha,
                                      coulomb_scale, with_energy,
                                      excl_skip, erfc_fn, method, krf, crf,
                                      cell_energy=per_replica,
                                      r_switch=r_switch, cells=(lo, hi)):
        if e is not None:
            if per_replica:
                energy[lo:hi] += e
            else:
                energy = energy + e
        fa = [torch.sum(g2 * dc, dim=2) for dc in d]
        for fc, f in zip((fx, fy, fz), fa):
            fc[lo:hi] += f
        if ob != [0]:
            for comp, fc in enumerate((fx, fy, fz)):
                react = -torch.sum(g2 * d[comp], dim=1).reshape(
                    hi - lo, len(ob), C)
                for p in range(len(ob)):
                    scatter.index_add_(fc, b[:, p], react[:, p])
    f_slots = torch.stack([fx.reshape(-1), fy.reshape(-1), fz.reshape(-1)],
                          dim=1)
    if per_replica:
        rows = tables.table(cfg, "replica_cells",
                            lambda: replica_cells(cfg), dev)
        energy = torch.sum(energy[rows], dim=1)
    return energy, f_slots
