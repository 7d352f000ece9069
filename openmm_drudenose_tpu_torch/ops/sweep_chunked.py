"""Kernel B2: the chunked cell-pair sweep with deterministic reactions,
hand-written in CUDA for Hopper (csrc/sweep_chunked.cu), with its plain
PyTorch version beside it.

Replaces the JAX package's TPU kernel ops/pallas_sweep.py::
pair_forces_pallas_chunked (pallas_call at :851).  It computes the same
function as kernel B1 (ops/sweep.py): forces only, LJ + Ewald real space
with the A&S erfc, self cell plus the half stencil with reactions.  Like
the TPU kernel, each chunk of home cells writes its reactions into a
frame of its own, and a second pass overlap-adds the frames in a fixed
order, so no chunk scatters into another's output and the result does
not depend on the order in which chunks run.

The chunk is the card's own choice, not the TPU's y-chunk: a brick of
home cells (`choose_brick`: the most warps resident on an SM within
227 KB of shared memory and 1024 threads a CTA).  Its frame is the
brick grown by the stencil's span.  A `ChunkPlan` holds the layout: per
dimension, chunk count, lowest offset, frame width, and the table of
(chunk, frame-local index) pairs that cover each cell, which the
overlap-add pass reads.

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
from . import sweep

# candidate bricks (home cells per chunk); choose_brick takes the one
# that keeps the most warps resident on an SM
BRICKS = ((2, 2, 2), (2, 2, 4), (2, 2, 3), (1, 2, 4), (1, 2, 2), (1, 1, 2),
          (1, 1, 1))
# dynamic shared memory a CTA may opt in to on Hopper (227 KB), and what
# an SM holds for all its CTAs (228 KB, 1 KB of it reserved per CTA)
SMEM_LIMIT = 232448
SM_SMEM = 233472
MAX_THREADS = 1024
# resident threads an SM's 65,536 registers allow at up to 64 registers
# a thread (ptxas gives the kernel 56)
SM_THREADS = 1024
INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True, eq=False)
class ChunkPlan:
    grid: tuple          # cells per dimension
    brick: tuple         # home cells per chunk per dimension
    n_chunks: tuple      # chunks per dimension, ceil(grid / brick)
    lo: tuple            # lowest stencil offset per dimension
    frame: tuple         # frame cells per dimension: brick + stencil span
    tables: tuple        # per dimension (grid_d, width_d, 2) int32:
    #                      (chunk, frame-local index) pairs covering each
    #                      cell, ascending, padded with -1
    offsets: tuple       # the stencil offsets, self first

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
        return [*self.grid, *self.brick, *self.n_chunks, *self.lo,
                *self.frame]

    @functools.cached_property
    def frame_rows(self) -> np.ndarray:
        """(n_cells, n_off): the frame row (chunk * frame cells + frame
        cell) that receives the reactions on cell c's neighbour at offset
        o; at the self offset, c's own row in its chunk's frame."""
        g = np.array(self.grid)
        c = np.arange(int(np.prod(g)))
        c3 = np.stack([c // (g[1] * g[2]), (c // g[2]) % g[1], c % g[2]], 1)
        chunk3 = c3 // np.array(self.brick)
        home3 = c3 % np.array(self.brick)
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


def smem_bytes(brick, frame, capacity: int) -> int:
    """Dynamic shared memory of one CTA (chunk_sweep_smem_bytes): the
    frame, the per-warp reaction parts, seven staged fields per home
    cell's neighbour slots and two counts per home cell."""
    nh, nf = int(np.prod(brick)), int(np.prod(frame))
    parts = -(-capacity // 32)
    return 4 * (nf * 3 * capacity + parts * nh * 3 * capacity
                + 7 * nh * capacity + 2 * nh)


def make_plan(cfg, brick) -> ChunkPlan:
    """The chunk layout of `cfg` with home bricks of `brick` cells (cut
    to the grid)."""
    grid = tuple(int(g) for g in cfg.grid)
    brick = tuple(min(int(b), g) for b, g in zip(brick, grid))
    offs = np.asarray(cfg.offsets, np.int64)
    lo = tuple(int(v) for v in offs.min(axis=0))
    hi = tuple(int(v) for v in offs.max(axis=0))
    frame = tuple(b + h - l for b, h, l in zip(brick, hi, lo))
    n_chunks = tuple(-(-g // b) for g, b in zip(grid, brick))
    tables = []
    for g, b, n, l0, f in zip(grid, brick, n_chunks, lo, frame):
        cover = [[] for _ in range(g)]
        for chunk in range(n):
            for loc in range(f):
                cover[(chunk * b + l0 + loc) % g].append((chunk, loc))
        width = max(len(c) for c in cover)
        tab = np.full((g, width, 2), -1, np.int32)
        for c, pairs in enumerate(cover):
            tab[c, :len(pairs)] = pairs
        tables.append(tab)
    return ChunkPlan(grid=grid, brick=brick, n_chunks=n_chunks, lo=lo,
                     frame=frame, tables=tuple(tables),
                     offsets=tuple(map(tuple, offs.tolist())))


def choose_brick(cfg) -> tuple:
    """The brick of BRICKS (cut to the grid) whose CTAs keep the most
    warps resident on an SM, from their threads (one warp per 32 home
    slots of each home cell, at most MAX_THREADS), their shared memory
    (at most SMEM_LIMIT) and the SM's registers; among equals, the one
    with two CTAs an SM or more (one runs on while another waits at a
    barrier), then the one with the fewest frame cells per home cell.
    On the H100 at 800k atoms this picks 2x2x2 at C = 48 (two CTAs of 16
    warps an SM) and 2x2x4 at C = 56, where a 2x2x2 CTA needs 120 KB and
    fits once an SM (the two are timed side by side by chip_smoke.py
    phase 4)."""
    C = cfg.capacity
    offs = np.asarray(cfg.offsets, np.int64)
    span = offs.max(axis=0) - offs.min(axis=0)
    best = None
    for brick in BRICKS:
        brick = tuple(min(b, g) for b, g in zip(brick, cfg.grid))
        frame = tuple(int(b + s) for b, s in zip(brick, span))
        home = int(np.prod(brick))
        threads = home * -(-C // 32) * 32
        smem = smem_bytes(brick, frame, C)
        if threads > MAX_THREADS or smem > SMEM_LIMIT:
            continue
        ctas = min(SM_SMEM // (smem + 1024), SM_THREADS // threads)
        key = (ctas * threads, min(ctas, 2), -np.prod(frame) / home)
        if best is None or key > best[0]:
            best = (key, brick)
    if best is None:
        raise ValueError(f"cell capacity {C} leaves no brick whose frame "
                         f"fits {SMEM_LIMIT} bytes of shared memory")
    return best[1]


_plans = {}


def plan_for(cfg, brick=None) -> ChunkPlan:
    """The plan of `cfg` (cached per config; the config is held so its id
    stays valid); brick None takes choose_brick(cfg)."""
    brick = tuple(brick) if brick is not None else choose_brick(cfg)
    key = (id(cfg), brick)
    hit = _plans.get(key)
    if hit is None:
        hit = _plans[key] = (cfg, make_plan(cfg, brick))
    return hit[1]


def pair_forces_plain(fields, cfg, shifts, alpha, coulomb_scale,
                      excl_skip=True, brick=None):
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
            excl_skip=excl_skip, erfc_fn=cellpair.erfc_approx):
        own += torch.stack([torch.sum(g2 * dc, dim=2) for dc in d], dim=2)
        if ob != [0]:
            react = -torch.stack([torch.sum(g2 * dc, dim=1) for dc in d],
                                 dim=2).reshape(nc, len(ob), C, 3)
            for p, o in enumerate(ob):
                frames.index_add_(0, rows[:, o], react[:, p])
    frames.index_add_(0, rows[:, 0], own)
    cover = torch.as_tensor(plan.cover_rows, device=dev)
    f = torch.zeros((nc, C, 3), dtype=dtype, device=dev)
    for k in range(cover.shape[1]):
        f += frames[cover[:, k]]
    return f.reshape(nc * C, 3)


def _declare(lib):
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.chunk_sweep_forces.argtypes = [vp] * 18 + [ci] * 5 + [cf] * 3 \
        + [ci, vp]
    lib.chunk_sweep_forces.restype = ci
    lib.chunk_sweep_max_capacity.restype = ci
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


def pair_forces(fields, cfg, shifts, alpha, coulomb_scale,
                excl_skip=True, brick=None):
    """Slot forces (n_cells * C, 3) of the direct-space sum, as
    sweep.pair_forces.  CPU tensors run the plain version; CUDA tensors
    launch the kernel (float32 only) or raise."""
    sweep.check_config(cfg)
    x = fields["x"]
    if x.device.type == "cpu":
        return pair_forces_plain(fields, cfg, shifts, alpha, coulomb_scale,
                                 excl_skip, brick)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    sweep.check_fields(fields, cfg)
    lib = sweep.load("sweep_chunked", _declare)
    C = cfg.capacity
    if C > lib.chunk_sweep_max_capacity():
        raise ValueError(f"cell capacity {C} exceeds the kernel's "
                         f"{lib.chunk_sweep_max_capacity()}")
    plan = plan_for(cfg, brick)
    plan_c = (ctypes.c_int * 15)(*plan.as_ints())
    plan_p = ctypes.cast(plan_c, ctypes.c_void_p)
    smem = lib.chunk_sweep_smem_bytes(plan_p, C)
    if smem > SMEM_LIMIT:
        raise ValueError(f"brick {plan.brick} needs {smem} bytes of shared "
                         f"memory, more than {SMEM_LIMIT}")
    n_frame = plan.frame_floats(C)
    if n_frame > INT32_MAX or cfg.n_cells * C * 3 > INT32_MAX:
        raise ValueError(f"{n_frame} frame floats overflow the kernel's "
                         "int32 indices")
    dev = x.device
    offs, chk, tx, ty, tz = _device_tables(cfg, plan, excl_skip, dev)
    sh = shifts.to(device=dev, dtype=torch.float32).contiguous()
    frames = torch.empty(n_frame, dtype=torch.float32, device=dev)
    f = torch.empty((cfg.n_cells * C, 3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.chunk_sweep_forces(
        p(fields["x"]), p(fields["y"]), p(fields["z"]), p(fields["q"]),
        p(fields["sig"]), p(fields["seps"]), p(fields["gid"]),
        p(fields["ew"]), p(fields["count"]), p(offs), p(sh), p(chk), p(tx),
        p(ty), p(tz), p(frames), p(f), plan_p,
        tx.shape[1], ty.shape[1], tz.shape[1], C, cfg.n_offsets,
        float(cfg.cutoff * cfg.cutoff), float(alpha), float(coulomb_scale),
        cfg.excl_window, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"chunked sweep kernel launch failed: CUDA "
                           f"error {err}")
    sweep.launches["b2_sweep"] += 1
    return f
