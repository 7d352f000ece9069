"""Kernel B2: the chunked cell-pair sweep with deterministic reactions,
hand-written in CUDA for Hopper (csrc/sweep_chunked.cu, with the
warp-tile pair loop of csrc/pair_tile.cuh), with its plain PyTorch
version beside it.

Replaces the JAX package's TPU kernel ops/pallas_sweep.py::
pair_forces_pallas_chunked (pallas_call at :851).  It computes the same
function as kernel B1 (ops/sweep.py): forces only, LJ + Ewald real space
with the A&S erfc or the reaction field (the `method` argument), self
cell plus the half stencil with reactions.  Like
the TPU kernel, each chunk of home cells writes its reactions into a
frame of its own, and a second pass overlap-adds the frames in a fixed
order, so no chunk scatters into another's output and the result does
not depend on the order in which chunks run.

The chunk is the card's own choice, not the TPU's y-chunk: a brick of
1 x 2 x 2 home cells, one warp each (`BRICK`); `b2_takes` says whether
its CTA launches within the card's limits as read from the card
(`card_limits`).  Its frame is the brick grown by the
stencil's span, a block of device memory of its own.  A `ChunkPlan`
holds the layout: per dimension, chunk count, lowest offset, frame
width, and the table of (chunk, frame-local index) pairs that cover each
cell, which the overlap-add pass reads.

Replica bands (the TPU kernel's pz and px, pallas_sweep.py:610-611):
on a grid of embedded replicas (forces/cellpair.py::
make_ensemble_config) the stencil wraps modulo one replica's period
inside each band.  Chunks never straddle a band edge: each band is cut
into its own ceil(period / brick) chunks, the last one cut short where
the brick does not divide the period (its home cells past the band edge
have no warp's work), so every frame cell of a chunk is one cell of one
band and the cover tables wrap modulo the period inside that band.  A
grid without bands is one band per dimension (period = grid), the plan
it always had.

`pair_energy` launches the energy instantiation (one partial a home
cell, summed in a fixed order; plain version sweep.pair_energy_plain,
since the sum order is the only difference between B1 and B2), with
sweep.pair_energy's signature; each launch adds one to
sweep.launches["b2_energy"].

Per-replica box scales (flat-ensemble NPT): as in B1 (ops/sweep.py), an
(R, n_off, 3) shift table launches the scaled instantiations; a chunk
lies in one band, so the kernel reads its replica's shifts once per CTA,
and the scaled energy comes back per replica, each replica's partials
(one a home cell of its chunks) summed in a fixed order.

`pair_forces` is the entry point, with sweep.pair_forces' signature.  For
a CPU tensor it runs the plain version (`pair_forces_plain`), which sums
the chunked way on the same plan: per-chunk frames filled offset by
offset, each chunk's own forces added last, then the overlap-add in the
tables' order.  For a CUDA tensor it launches the kernel (float32 only)
or raises; each launch adds one to sweep.launches["b2_sweep"].
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..forces import cellpair
from . import scatter, sweep

# home cells per chunk, one warp each: of the bricks of 4 to 8 cells
# (csrc/sweep_chunked.cu's launch bound is 8 warps), the one that ran
# fastest on the H100 at 800k atoms (chip_smoke.py times its rivals;
# PERF.md); its CTA fits the H100 up to a capacity of 4429
BRICK = (1, 2, 2)
INT32_MAX = sweep.INT32_MAX
# bytes of one warp's staged tile (pair_tile::Tile: 32 float4 positions
# and charges, 32 float2 sigma / sqrt(eps), 32 atom indices) and of its
# broadcast walk's partial sums (pair_tile::Partials: 3 x 8 x 33 floats)
TILE_BYTES = 32 * (16 + 8 + 4)
PARTIAL_BYTES = 4 * 3 * 8 * 33


@dataclasses.dataclass(frozen=True)
class CardLimits:
    """What kernel B2 and the card allow a CTA and an SM: the kernel's
    registers a thread and static shared memory (cudaFuncGetAttributes),
    the card's shared memory a CTA may opt in to, an SM's shared memory,
    the shared memory reserved per CTA, an SM's registers and threads
    (cudaDeviceGetAttribute)."""
    regs: int | None
    static_smem: int
    max_threads: int
    smem_block: int
    smem_sm: int
    smem_reserved: int
    regs_sm: int
    threads_sm: int


# the H100's published figures and B2's launch bound (8 warps a CTA),
# for the plain version on the CPU (where the brick sets only the order of
# the sums): registers unknown there
H100 = CardLimits(regs=None, static_smem=0, max_threads=256,
                  smem_block=232448, smem_sm=233472, smem_reserved=1024,
                  regs_sm=65536, threads_sm=2048)

_card_limits = {}


def attributes(energy: bool = False, method: str = "ewald",
               scaled: bool = False, switched: bool = False) -> dict:
    """B2's registers, static shared memory, most threads a CTA and
    local bytes a thread (of its force or energy instantiation of a
    Coulomb kind, scaled or not, switched or not), read from the card
    (sweep.kernel_attributes)."""
    return sweep.kernel_attributes(sweep.load("sweep_chunked", _declare),
                                   "chunk_sweep_attributes", energy, method,
                                   scaled, switched)


def card_limits(device):
    """CardLimits read from the card; None for a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    hit = _card_limits.get(str(device))
    if hit is None:
        lib = sweep.load("sweep_chunked", _declare)
        dev = (ctypes.c_int * 6)()
        err = lib.chunk_sweep_device(ctypes.cast(dev, ctypes.c_void_p))
        if err != 0:
            raise RuntimeError(f"chunk_sweep_device failed: CUDA error "
                               f"{err}")
        a = attributes()
        hit = _card_limits[str(device)] = CardLimits(
            regs=a["regs"], static_smem=a["static_smem"],
            max_threads=a["max_threads"], smem_block=dev[0],
            smem_sm=dev[1], smem_reserved=dev[2], regs_sm=dev[3],
            threads_sm=dev[4])
    return hit


@dataclasses.dataclass(frozen=True, eq=False)
class ChunkPlan:
    grid: tuple          # cells per dimension
    brick: tuple         # home cells per chunk per dimension
    n_chunks: tuple      # chunks per dimension: bands x per_band
    lo: tuple            # lowest stencil offset per dimension
    frame: tuple         # frame cells per dimension: brick + stencil span
    tables: tuple        # per dimension (grid_d, width_d, 2) int32:
    #                      (chunk, frame-local index) pairs covering each
    #                      cell, ascending, padded with -1
    offsets: tuple       # the stencil offsets, self first
    periods: tuple       # one replica's cells per dimension (the wrap)
    per_band: tuple      # chunks per band per dimension,
    #                      ceil(period / brick)

    @property
    def n_frame_cells(self) -> int:
        return int(np.prod(self.frame))

    @property
    def total_chunks(self) -> int:
        return int(np.prod(self.n_chunks))

    def frame_floats(self, capacity: int) -> int:
        """Floats of all frames: one (frame cells, 3, C) block a chunk."""
        return self.total_chunks * self.n_frame_cells * 3 * capacity

    def as_ints(self) -> list:
        """The kernel's Plan (csrc/sweep_chunked.cu), 21 ints."""
        return [*self.grid, *self.brick, *self.n_chunks, *self.lo,
                *self.frame, *self.periods, *self.per_band]

    @functools.cached_property
    def frame_rows(self) -> np.ndarray:
        """(n_cells, n_off): the frame row (chunk * frame cells + frame
        cell) that receives the reactions on cell c's neighbour at offset
        o; at the self offset, c's own row in its chunk's frame."""
        c3 = cellpair.cell_coords(self.grid)
        p = np.array(self.periods)
        band, loc3 = c3 // p, c3 % p
        chunk3 = band * np.array(self.per_band) + loc3 // np.array(self.brick)
        home3 = loc3 % np.array(self.brick)
        nb = self.n_chunks
        chunk = (chunk3[:, 0] * nb[1] + chunk3[:, 1]) * nb[2] + chunk3[:, 2]
        loc = (home3[:, None, :] + np.array(self.offsets)[None, :, :]
               - np.array(self.lo))                          # (nc, n_off, 3)
        f = self.frame
        fcell = (loc[..., 0] * f[1] + loc[..., 1]) * f[2] + loc[..., 2]
        return chunk[:, None] * self.n_frame_cells + fcell

    @functools.cached_property
    def cover_rows(self) -> np.ndarray:
        """(n_cells, K) frame rows covering each cell, in the order the
        overlap-add kernel sums them (x table outer, z inner); entries
        padded in the tables point at the row count (a zero row)."""
        nb, f, nf = self.n_chunks, self.frame, self.n_frame_cells
        # a row splits into one term per dimension:
        # chunk * nf + fcell = (cx-term) + (cy-term) + (cz-term)
        scale = ((nb[1] * nb[2] * nf, f[1] * f[2]), (nb[2] * nf, f[2]),
                 (nf, 1))
        terms, valid = [], []
        for tab, (sc, sl) in zip(self.tables, scale):
            terms.append(tab[..., 0].astype(np.int64) * sc
                         + tab[..., 1] * sl)
            valid.append(tab[..., 0] >= 0)
        gx, gy, gz = self.grid
        lx, ly, lz = (t.shape[1] for t in terms)
        row = (terms[0][:, None, None, :, None, None]
               + terms[1][None, :, None, None, :, None]
               + terms[2][None, None, :, None, None, :])
        ok = (valid[0][:, None, None, :, None, None]
              & valid[1][None, :, None, None, :, None]
              & valid[2][None, None, :, None, None, :])
        row = np.where(ok, row, self.total_chunks * nf)
        return row.reshape(gx * gy * gz, lx * ly * lz)


def smem_bytes(brick, capacity: int) -> int:
    """Dynamic shared memory of one CTA (chunk_sweep_smem_bytes): two
    staged tiles (the neighbour's and the home part), the partial sums
    and one (3, C) row-force buffer a warp (the frame lives in device
    memory)."""
    return int(np.prod(brick)) * (2 * TILE_BYTES + PARTIAL_BYTES
                                  + 12 * capacity)


def resident_ctas(brick, capacity: int, limits=None) -> int:
    """CTAs of this brick an SM holds at once (0: it does not launch):
    the fewest that its shared memory, threads and (where known)
    registers allow."""
    lim = limits or H100
    threads = 32 * int(np.prod(brick))
    smem = smem_bytes(brick, capacity) + lim.static_smem
    if threads > lim.max_threads or smem > lim.smem_block:
        return 0
    ctas = min(lim.smem_sm // (smem + lim.smem_reserved),
               lim.threads_sm // threads, 32)
    if lim.regs is not None:
        # registers go to a warp in units of 256
        per_warp = -(-lim.regs * 32 // 256) * 256
        ctas = min(ctas, lim.regs_sm // per_warp // (threads // 32))
    return ctas


def make_plan(cfg, brick) -> ChunkPlan:
    """The chunk layout of `cfg` with home bricks of `brick` cells (cut
    to one replica's period).  Pure index space (the grid, the periods,
    the brick, the offsets), so one plan serves orthorhombic and
    triclinic cells; each replica band has chunks of its own."""
    grid = tuple(int(g) for g in cfg.grid)
    periods = tuple(int(p) for p in cfg.phys_grid)
    brick = tuple(min(int(b), p) for b, p in zip(brick, periods))
    offs = np.asarray(cfg.offsets, np.int64)
    lo = tuple(int(v) for v in offs.min(axis=0))
    hi = tuple(int(v) for v in offs.max(axis=0))
    frame = tuple(b + h - l for b, h, l in zip(brick, hi, lo))
    per_band = tuple(-(-p // b) for p, b in zip(periods, brick))
    n_chunks = tuple(g // p * k for g, p, k in zip(grid, periods, per_band))
    tables = []
    for g, p, b, k, l0, f in zip(grid, periods, brick, per_band, lo,
                                 frame):
        cover = [[] for _ in range(g)]
        for chunk in range(g // p * k):
            band, kk = divmod(chunk, k)
            for loc in range(f):
                cover[band * p + (kk * b + l0 + loc) % p].append(
                    (chunk, loc))
        width = max(len(c) for c in cover)
        tab = np.full((g, width, 2), -1, np.int32)
        for c, pairs in enumerate(cover):
            tab[c, :len(pairs)] = pairs
        tables.append(tab)
    return ChunkPlan(grid=grid, brick=brick, n_chunks=n_chunks, lo=lo,
                     frame=frame, tables=tuple(tables),
                     offsets=tuple(map(tuple, offs.tolist())),
                     periods=periods, per_band=per_band)


def choose_brick(cfg, limits=None):
    """BRICK cut to one replica's period (the grid without bands), or
    None where its CTA does not launch under `limits` (the card's, or
    the H100's published figures without registers)."""
    brick = tuple(min(b, g) for b, g in zip(BRICK, cfg.phys_grid))
    return brick if resident_ctas(brick, cfg.capacity, limits) > 0 else None


def b2_takes(cfg, limits=None) -> bool:
    """Whether kernel B2 takes the config: its brick's CTA launches
    (choose_brick) and its frames and slot and word indices stay in
    int32 (csrc/sweep_chunked.cu::chunk_sweep_forces refuses the
    rest)."""
    brick = choose_brick(cfg, limits)
    if brick is None or not sweep.b1_takes(cfg):
        return False
    return make_plan(cfg, brick).frame_floats(cfg.capacity) <= INT32_MAX


_plans = {}


def plan_for(cfg, brick=None, limits=None) -> ChunkPlan:
    """The plan of `cfg` (cached per config; the config is held so its id
    stays valid); brick None takes choose_brick(cfg, limits)."""
    brick = tuple(brick) if brick is not None \
        else choose_brick(cfg, limits)
    if brick is None:
        raise ValueError(f"cell capacity {cfg.capacity} leaves no brick "
                         "whose CTA fits the card")
    key = (id(cfg), brick)
    hit = _plans.get(key)
    if hit is None:
        hit = _plans[key] = (cfg, make_plan(cfg, brick))
    return hit[1]


def pair_forces_plain(fields, cfg, shifts, alpha, coulomb_scale,
                      excl_skip=True, brick=None, method="ewald", krf=0.0,
                      crf=0.0, r_switch=None):
    """The plain PyTorch version: slot forces (n_cells * C, 3), summed
    through per-chunk frames and the fixed-order overlap-add of the
    kernel's plan."""
    plan = plan_for(cfg, brick)
    nc, C = cfg.n_cells, cfg.capacity
    dtype, dev = fields["x"].dtype, fields["x"].device
    rows = torch.as_tensor(plan.frame_rows, device=dev)
    n_rows = plan.total_chunks * plan.n_frame_cells
    # one more row, left zero: it pads the cover table
    frames = torch.zeros((n_rows + 1, C, 3), dtype=dtype, device=dev)
    own = torch.zeros((nc, C, 3), dtype=dtype, device=dev)
    for ob, b, g2, d, _ in cellpair.pair_tiles(
            fields, cfg, shifts, alpha, coulomb_scale, with_energy=False,
            excl_skip=excl_skip, erfc_fn=cellpair.erfc_approx,
            method=method, krf=krf, crf=crf, r_switch=r_switch):
        own += torch.stack([torch.sum(g2 * dc, dim=2) for dc in d], dim=2)
        if ob != [0]:
            react = -torch.stack([torch.sum(g2 * dc, dim=1) for dc in d],
                                 dim=2).reshape(nc, len(ob), C, 3)
            for p, o in enumerate(ob):
                scatter.index_add_(frames, rows[:, o], react[:, p])
    scatter.index_add_(frames, rows[:, 0], own)
    cover = torch.as_tensor(plan.cover_rows, device=dev)
    f = torch.zeros((nc, C, 3), dtype=dtype, device=dev)
    for k in range(cover.shape[1]):
        f += frames[cover[:, k]]
    return f.reshape(nc * C, 3)


def _declare(lib):
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.chunk_sweep_forces.argtypes = [vp] * 18 + [ci] * 5 + [cf] * 3 \
        + [ci, ci, ci, cf, cf, ci, cf, cf, ci, vp]
    lib.chunk_sweep_forces.restype = ci
    lib.chunk_sweep_energy.argtypes = [vp] * 16 + [ci] * 2 + [cf] * 3 \
        + [ci, ci, ci, cf, cf, ci, cf, cf, ci, ci, ci, vp]
    lib.chunk_sweep_energy.restype = ci
    lib.chunk_sweep_attributes.argtypes = [vp, ci, ci, ci, ci]
    lib.chunk_sweep_attributes.restype = ci
    lib.chunk_sweep_device.argtypes = [vp]
    lib.chunk_sweep_device.restype = ci
    lib.chunk_sweep_smem_bytes.argtypes = [vp, ci]
    lib.chunk_sweep_smem_bytes.restype = ci


_tables = {}


def _device_tables(cfg, plan, excl_skip, dev):
    """Offsets, exclusion-test flags and the plan's cover tables on the
    device, cached per config and plan."""
    key = (id(cfg), id(plan), bool(excl_skip), str(dev))
    hit = _tables.get(key)
    if hit is None:
        i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                        device=dev)
        hit = _tables[key] = (cfg, plan, (
            i32(cfg.offsets), i32(sweep.check_excl_flags(cfg, excl_skip)),
            *(i32(t) for t in plan.tables)))
    return hit[2]


def energy_rows(cfg, plan) -> np.ndarray:
    """(R, partials a replica): the energy partials (chunk * home cells
    + home cell) of each replica's chunks, in chunk order: the order of
    the per-replica energy sums.  A chunk's replica is its band's, (bx
    * y bands + by) * z bands + bz, r = bx * rz + bz of
    cellpair.rep_of_cell."""
    nb = plan.n_chunks
    c3 = cellpair.cell_coords(nb)                   # every chunk, x-major
    bands = np.array(plan.grid) // np.array(plan.periods)
    band3 = c3 // np.array(plan.per_band)
    rep = (band3[:, 0] * bands[1] + band3[:, 1]) * bands[2] + band3[:, 2]
    order = np.argsort(rep, kind="stable").reshape(cfg.n_replicas, -1)
    nh = int(np.prod(plan.brick))
    return (order[:, :, None] * nh
            + np.arange(nh)[None, None, :]).reshape(cfg.n_replicas, -1)


_rows = {}


def _energy_rows_device(cfg, plan, dev):
    key = (id(cfg), id(plan), str(dev))
    hit = _rows.get(key)
    if hit is None:
        hit = _rows[key] = (cfg, plan, torch.as_tensor(
            np.ascontiguousarray(energy_rows(cfg, plan), np.int32),
            device=dev))
    return hit[2]


def _launch_plan(lib, fields, cfg, brick):
    """Check the sorted fields and the config against the card and return
    (plan, the plan's ints for the kernel) of a launch, or raise where
    the kernel does not take them."""
    sweep.check_fields(fields, cfg)
    C = cfg.capacity
    limits = card_limits(fields["x"].device)
    plan = plan_for(cfg, brick, limits)
    plan_c = (ctypes.c_int * 21)(*plan.as_ints())
    smem = lib.chunk_sweep_smem_bytes(ctypes.cast(plan_c, ctypes.c_void_p),
                                      C)
    if smem + limits.static_smem > limits.smem_block \
            or 32 * int(np.prod(plan.brick)) > limits.max_threads:
        raise ValueError(f"brick {plan.brick} needs {smem} bytes of shared "
                         f"memory, more than the card's "
                         f"{limits.smem_block}, or too many threads")
    n_frame = plan.frame_floats(C)
    if n_frame > INT32_MAX or not sweep.b1_takes(cfg):
        raise ValueError(f"{n_frame} frame floats or {cfg.n_cells} cells "
                         f"of capacity {C} overflow the kernel's int32 "
                         "indices")
    return plan, plan_c


def pair_forces(fields, cfg, shifts, alpha, coulomb_scale,
                excl_skip=True, brick=None, method="ewald", krf=0.0,
                crf=0.0, r_switch=None):
    """Slot forces (n_cells * C, 3) of the direct-space sum, as
    sweep.pair_forces; brick None takes choose_brick from the card's
    limits.  CPU tensors run the plain version; CUDA tensors launch the
    kernel (float32 only) or raise."""
    sweep.check_config(cfg)
    kind = sweep.coulomb_kind(method, alpha, krf, crf)
    scaled = sweep.check_shifts(shifts, cfg)
    sw = sweep.switch_args(cfg, r_switch)
    x = fields["x"]
    if x.device.type == "cpu":
        return pair_forces_plain(fields, cfg, shifts, alpha, coulomb_scale,
                                 excl_skip, brick, method, krf, crf,
                                 r_switch)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = sweep.load("sweep_chunked", _declare)
    plan, plan_c = _launch_plan(lib, fields, cfg, brick)
    C = cfg.capacity
    dev = x.device
    offs, chk, tx, ty, tz = _device_tables(cfg, plan, excl_skip, dev)
    sh = shifts.to(device=dev, dtype=torch.float32).contiguous()
    frames = torch.empty(plan.frame_floats(C), dtype=torch.float32,
                         device=dev)
    f = torch.empty((cfg.n_cells * C, 3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.chunk_sweep_forces(
        *sweep.field_ptrs(fields), p(offs), p(sh), p(chk), p(tx), p(ty),
        p(tz), p(frames), p(f), ctypes.cast(plan_c, ctypes.c_void_p),
        tx.shape[1], ty.shape[1], tz.shape[1], C, cfg.n_offsets,
        float(cfg.cutoff * cfg.cutoff), float(alpha), float(coulomb_scale),
        cfg.excl_window, cfg.excl_words, kind, float(krf), float(crf),
        *sw, int(scaled), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"chunked sweep kernel launch failed: CUDA "
                           f"error {err}")
    sweep.launches[sweep.launch_key("b2", False, method, cfg, scaled,
                                    sw[0])] += 1
    return f


def pair_energy(fields, cfg, shifts, alpha, coulomb_scale, excl_skip=True,
                brick=None, method="ewald", krf=0.0, crf=0.0, r_switch=None):
    """The direct-space energy (0-d) by B2's energy instantiation, as
    sweep.pair_energy: float64 on the card, one partial a home cell,
    summed in a fixed order; with per-replica shifts (R, n_off, 3) the
    scaled instantiation's (R,) per-replica energies.  CPU tensors run
    the plain version; CUDA tensors launch the kernel (float32 fields
    only) or raise."""
    sweep.check_config(cfg)
    kind = sweep.coulomb_kind(method, alpha, krf, crf)
    scaled = sweep.check_shifts(shifts, cfg)
    sw = sweep.switch_args(cfg, r_switch)
    x = fields["x"]
    if x.device.type == "cpu":
        return sweep.pair_energy_plain(fields, cfg, shifts, alpha,
                                       coulomb_scale, excl_skip, method, krf,
                                       crf, r_switch)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = sweep.load("sweep_chunked", _declare)
    plan, plan_c = _launch_plan(lib, fields, cfg, brick)
    dev = x.device
    offs, chk, _, _, _ = _device_tables(cfg, plan, excl_skip, dev)
    sh = shifts.to(device=dev, dtype=torch.float32).contiguous()
    part = torch.empty(plan.total_chunks * int(np.prod(plan.brick)),
                       dtype=torch.float64, device=dev)
    rows = _energy_rows_device(cfg, plan, dev) if scaled else None
    e = torch.empty((cfg.n_replicas,) if scaled else (),
                    dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.chunk_sweep_energy(
        *sweep.field_ptrs(fields), p(offs), p(sh), p(chk), p(part), p(e),
        None if rows is None else p(rows),
        ctypes.cast(plan_c, ctypes.c_void_p), cfg.capacity, cfg.n_offsets,
        float(cfg.cutoff * cfg.cutoff),
        float(alpha), float(coulomb_scale), cfg.excl_window,
        cfg.excl_words, kind, float(krf), float(crf), *sw, int(scaled),
        rows.shape[0] if scaled else 0, rows.shape[1] if scaled else 0,
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"chunked sweep energy launch failed: CUDA "
                           f"error {err}")
    sweep.launches[sweep.launch_key("b2", True, method, cfg, scaled,
                                    sw[0])] += 1
    return e
