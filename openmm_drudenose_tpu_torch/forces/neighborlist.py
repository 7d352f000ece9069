"""Fixed-capacity cell-list neighbour lists: the "cell" strategy.

The JAX package's forces/neighborlist.py, in plain PyTorch on the given
device (the JAX package builds them in XLA, outside Pallas, so there is
no TPU kernel to port):

  1. bin atoms into cells of side >= cutoff + skin (the grid fixed from
     the reference box)
  2. sort by cell -> each atom's rank in its cell -> a (n_cells,
     cell_capacity) table, atoms past the capacity dropped and the
     overflow flag set
  3. per atom, the occupants of its 27 neighbouring cells (fewer on
     small grids), masked by distance <= (cutoff + skin)^2 and by the
     exclusion table, compacted to the first K hits
  4. padded with N

Where the neighbouring cells cover the box (n_offsets x capacity >= N)
every atom is a candidate instead.  The lists are rebuilt every
`rebuild_interval` steps by the Context (app/context.py), with the skin
absorbing the motion between; an overflow (cell or neighbour capacity)
sets the sticky flag, and the Context grows the capacities (`grow`) and
builds again.

`n_replicas` = R builds the lists of a replica ensemble (parallel/
ensemble.py) in one pass: R replica-major copies of one system in one
box, each atom's candidates from its own replica only, so replicas never
meet; indices stay global.  Orthorhombic boxes only (the JAX refusal of
triclinic boxes, forces/nonbonded.py:191 there, stays).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Neighbors:
    idx: torch.Tensor             # (N, K) int64 neighbour indices, padded N
    overflow: torch.Tensor        # () bool, capacity exceeded somewhere
    ref_positions: torch.Tensor   # (N, 3) positions at the build
    # the latches the Context reads of every neighbour structure: a cell
    # list has no stencil to fall short and skips no exclusion test
    stencil_invalid: torch.Tensor = None
    drift_exceeded: torch.Tensor = None
    excl_span_exceeded: torch.Tensor = None


@dataclasses.dataclass(frozen=True)
class NeighborConfig:
    cutoff: float
    skin: float
    grid: tuple            # (nx, ny, nz) cells
    cell_capacity: int
    max_neighbors: int     # K
    rebuild_interval: int
    chunk: int = 2048

    @property
    def r_list(self) -> float:
        return self.cutoff + self.skin


def make_config(cutoff: float, box_diag, n_atoms: int, skin: float = 0.1,
                rebuild_interval: int = 16, density_margin: float = 2.0,
                max_neighbors: int | None = None) -> NeighborConfig:
    """Capacities sized from the mean density times `density_margin`; the
    overflow flag and `grow` handle inhomogeneous systems."""
    box_diag = np.asarray(box_diag, np.float64)
    r_list = cutoff + skin
    grid = tuple(max(int(np.floor(L / r_list)), 1) for L in box_diag)
    n_cells = int(np.prod(grid))
    density = n_atoms / float(np.prod(box_diag))
    cell_vol = float(np.prod(box_diag)) / n_cells
    cell_capacity = min(int(np.ceil(density * cell_vol * density_margin))
                        + 8, n_atoms)
    if max_neighbors is None:
        sphere = 4.0 / 3.0 * np.pi * r_list ** 3
        max_neighbors = int(np.ceil(density * sphere * density_margin)) + 16
        max_neighbors = min(max_neighbors, n_atoms)
    return NeighborConfig(cutoff=float(cutoff), skin=float(skin), grid=grid,
                          cell_capacity=cell_capacity,
                          max_neighbors=int(max_neighbors),
                          rebuild_interval=int(rebuild_interval))


def grow(cfg: NeighborConfig, n_atoms: int, factor: float = 1.5
         ) -> NeighborConfig:
    return dataclasses.replace(
        cfg,
        cell_capacity=min(int(cfg.cell_capacity * factor) + 1, n_atoms),
        max_neighbors=min(int(cfg.max_neighbors * factor) + 1, n_atoms))


def build_exclusion_table(n_atoms: int, exc_i, exc_j,
                          max_exclusions: int | None = None,
                          device="cpu") -> torch.Tensor:
    """(N, E) per-atom exclusion table padded with -1 (symmetric)."""
    lists: list[list[int]] = [[] for _ in range(n_atoms)]
    for a, b in zip(np.asarray(exc_i).tolist(), np.asarray(exc_j).tolist()):
        lists[int(a)].append(int(b))
        lists[int(b)].append(int(a))
    E = max_exclusions or max((len(x) for x in lists), default=0)
    E = max(E, 1)
    table = np.full((n_atoms, E), -1, np.int64)
    for i, x in enumerate(lists):
        if len(x) > E:
            raise ValueError(f"atom {i} has {len(x)} exclusions > "
                             f"capacity {E}")
        table[i, :len(x)] = x
    return torch.as_tensor(table, device=device)


def _offsets_for_grid(grid) -> np.ndarray:
    """Neighbour-cell offsets, without repeats on small grids (with fewer
    than 3 cells in a dimension, -1 and +1 wrap to the same cell)."""
    def per_dim(n):
        if n >= 3:
            return (-1, 0, 1)
        if n == 2:
            return (0, 1)
        return (0,)
    return np.array([(dx, dy, dz)
                     for dx in per_dim(grid[0])
                     for dy in per_dim(grid[1])
                     for dz in per_dim(grid[2])], np.int64)


def build_neighbors(positions, box_diag, cfg: NeighborConfig,
                    exclusion_table=None, n_replicas: int = 1) -> Neighbors:
    """The (N, K) lists at `positions` in the orthorhombic box
    `box_diag` ((3,)); with n_replicas = R, R replica-major systems in
    one box, each atom's candidates from its own replica."""
    N = positions.shape[0]
    R = int(n_replicas)
    n = N // R
    dev = positions.device
    dtype = positions.dtype
    box_diag = box_diag.to(dtype)
    g = cfg.grid
    n_cells = int(np.prod(g))
    grid = torch.as_tensor(g, device=dev)
    frac = positions / box_diag
    frac = frac - torch.floor(frac)
    cell3 = torch.minimum(torch.clamp((frac * grid).long(), min=0),
                          grid - 1)
    flat = (cell3[:, 0] * g[1] + cell3[:, 1]) * g[2] + cell3[:, 2]
    rep = torch.arange(N, device=dev) // n
    offsets = torch.as_tensor(_offsets_for_grid(g), device=dev)
    cap = cfg.cell_capacity
    all_candidates = offsets.shape[0] * cap >= n

    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    if not all_candidates:
        key = rep * n_cells + flat
        order = torch.argsort(key, stable=True)
        sorted_key = key[order]
        starts = torch.searchsorted(
            sorted_key, torch.arange(R * n_cells, device=dev))
        rank = torch.arange(N, device=dev) - starts[sorted_key]
        overflow = overflow | torch.any(rank >= cap)
        dump = R * n_cells * cap
        table = torch.full((dump + 1,), N, dtype=torch.int64, device=dev)
        table[torch.where(rank < cap, sorted_key * cap + rank,
                          torch.full_like(rank, dump))] = order
        table = table[:dump].reshape(R * n_cells, cap)

    r_list2 = cfg.r_list ** 2
    K = cfg.max_neighbors
    idx = torch.empty((N, K), dtype=torch.int64, device=dev)
    counts = torch.empty((N,), dtype=torch.int64, device=dev)
    chunk = min(cfg.chunk, N)
    for o in range(0, N, chunk):
        rows = torch.arange(o, min(o + chunk, N), device=dev)
        m = rows.shape[0]
        if all_candidates:
            cand = rep[rows][:, None] * n + torch.arange(n, device=dev)[
                None, :]
        else:
            nc3 = (cell3[rows][:, None, :] + offsets[None, :, :]) % grid
            nflat = (nc3[..., 0] * g[1] + nc3[..., 1]) * g[2] + nc3[..., 2]
            cand = table[rep[rows][:, None] * n_cells + nflat].reshape(m, -1)
        safe = torch.clamp(cand, max=N - 1)
        r2 = 0
        for c in range(3):
            d = positions[rows, c][:, None] - positions[safe, c]
            d = d - box_diag[c] * torch.round(d / box_diag[c])
            r2 = r2 + d * d
        mask = (r2 <= r_list2) & (cand != rows[:, None]) & (cand < N)
        if exclusion_table is not None:
            excl = exclusion_table[rows]
            for e in range(excl.shape[1]):
                mask = mask & (cand != excl[:, e:e + 1])
        counts[rows] = torch.sum(mask, dim=1)
        # compact: hit m of a row goes to column cumsum(mask) - 1
        dest = torch.cumsum(mask.long(), dim=1) - 1
        writable = mask & (dest < K)
        row_ix = torch.arange(m, device=dev)[:, None].expand_as(dest)
        flat_dest = torch.where(writable, row_ix * K + dest,
                                torch.full_like(dest, m * K))
        taken = torch.full((m * K + 1,), N, dtype=torch.int64, device=dev)
        taken[flat_dest[writable]] = cand[writable]
        idx[rows] = taken[:m * K].reshape(m, K)
    overflow = overflow | torch.any(counts > K)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    return Neighbors(idx=idx, overflow=overflow, ref_positions=positions,
                     stencil_invalid=false, drift_exceeded=false)


def needs_rebuild(neighbors: Neighbors, positions, box_diag,
                  cfg: NeighborConfig):
    """True when some atom moved more than skin / 2 since the build."""
    d = positions - neighbors.ref_positions
    d = d - box_diag * torch.round(d / box_diag)
    max_d2 = torch.max(torch.sum(d * d, dim=-1))
    return max_d2 > (0.5 * cfg.skin) ** 2


# elements of one (rows, K) block of the list sum: bounds each temporary
BLOCK_ELEMS = 1 << 21


def pair_energy_forces(params, positions, box_diag, idx, cutoff, alpha,
                       coulomb_scale, with_energy=True, exact=None,
                       method="ewald", krf=0.0, crf=0.0, r_switch=None):
    """(energy, forces (N, 3)) of the direct-space sum over the lists
    (the JAX package's cell-list energy, forces/nonbonded.py:936-975
    there, with analytic forces): each pair sits in both atoms' rows, so
    a row's forces are complete after its row sum and the energy is half
    the sum; the pair function is make_pair_eg's with the exact erfc and
    the LJ switch where r_switch is given; minimum image against the
    diagonal; pairs at or past the cutoff give nothing.  Float32
    displacements are formed in float64 from `exact` where given and
    rounded once, as the other strategies do."""
    from .cellpair import make_pair_eg
    N, K = idx.shape
    dtype = positions.dtype
    pair_eg = make_pair_eg(method, alpha, krf, crf, torch.special.erfc,
                           r_switch, cutoff)
    q = params["charge"]
    sig = params["sigma"]
    seps = torch.sqrt(params["eps"])
    qa = coulomb_scale * q
    src = positions if exact is None else exact
    box = box_diag.to(src.dtype)
    cutoff2 = cutoff * cutoff
    rows = max(1, min(N, BLOCK_ELEMS // max(K, 1)))
    energy = positions.new_zeros(()) if with_energy else None
    forces = []
    zero = torch.zeros((), dtype=dtype, device=positions.device)
    for o in range(0, N, rows):
        sl = slice(o, min(o + rows, N))
        nb = idx[sl]
        real = nb < N
        j = torch.where(real, nb, torch.zeros_like(nb))
        d = []
        for c in range(3):
            dc = src[sl, c][:, None] - src[j, c]
            d.append((dc - box[c] * torch.round(dc / box[c])).to(dtype))
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        valid = real & (r2 < cutoff2)
        r2s = torch.where(valid, torch.clamp(r2, min=1e-6),
                          torch.ones_like(r2))
        inv_r = torch.rsqrt(r2s)
        e, g = pair_eg(qa[sl, None] * q[j], 0.5 * (sig[sl, None] + sig[j]),
                       seps[sl, None] * seps[j], r2s, inv_r, inv_r * inv_r)
        g2 = torch.where(valid, -2.0 * g, zero)
        if with_energy:
            energy = energy + 0.5 * torch.sum(torch.where(valid, e, zero))
        forces.append(torch.stack([torch.sum(g2 * dc, dim=1) for dc in d],
                                  dim=1))
    return energy, torch.cat(forces, dim=0)
