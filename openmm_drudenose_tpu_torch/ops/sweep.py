"""Kernel B1: the cell-pair sweep's direct-space forces, hand-written in
CUDA for Hopper (csrc/sweep.cu, with the warp-tile pair loop of
csrc/pair_tile.cuh), with its plain PyTorch version beside it; and the
kernel's energy instantiation (`pair_energy`, plain version
`pair_energy_plain`: the direct-space energy with the exact erfc or the
reaction field, summed in double in an order fixed by the data).

Replaces the JAX package's TPU kernel ops/pallas_sweep.py::
pair_forces_pallas (pallas_call at :440).  It computes the same function
(forces only; LJ + Ewald real space with the A&S erfc, or the reaction
field, the TPU kernel's `method` "ewald" or "rf" (_make_pair_g :111-135);
self cell plus the half stencil with reactions; exclusion bitmask, any
number of words, skipped at offsets with any |o| >= 2), not the TPU
layout: no doubled layers, lane padding or one-hot reaction sums.  Any
cell capacity.  Orthorhombic and triclinic cells alike: the geometry
reaches the kernel only as the per-offset shift table and the cell-local
fields (forces/cellpair.py), as it reaches the TPU kernel through
_centers_and_hvec (:83-108).  Replica bands too (the TPU kernel's
cfg.x_period / cfg.z_period path, :53-57 and :184-224, the layer index
lay_idx wrapped inside each x band): the kernel reads an explicit
neighbour map and its reverse, both wrapped inside each replica's bands
(forces/cellpair.py::neighbor_map), and the fields' centres and the
shifts are one replica's, so its body is the same for a banded grid.
Its forces are the same bits at every launch: the
reactions go through frames with one writer an entry and a fixed-order
gather (csrc/sweep.cu), not atomics.

Per-replica box scales (flat-ensemble NPT; the JAX package takes its
XLA sweep there, forces/nonbonded.py:905-915, so no TPU kernel has this
path): the fields are physical and `shifts` is an (R, n_off, 3) table,
s_r times the template's (forces/cellpair.py); the kernel's scaled
instantiations (a compile-time flag, kScaled) read the table at the
home cell's replica, and the energy comes back per replica, (R,) in
float64, each replica's work-unit partials summed in a fixed order.
Launches count under the "_scaled" keys.

Switched LJ (createSystem(switchDistance=...), the JAX package's XLA
route): instantiations of their own (a compile-time flag, kSwitch:
csrc/pair_tile.cuh), so the unswitched ones compile to the code they
were; launches of them count under the "_sw" keys.

`pair_forces` is the entry point.  For a CPU tensor it runs the plain
version (`pair_forces_plain`); for a CUDA tensor it launches the kernel or
raises.  The kernels of csrc/ build at first use, one nvcc per source, all
started together, into build/torch_kernels/<hash of every source and
header>/, and are loaded with ctypes.

`supports` and `choose_chunk` are the JAX package's two gates
(ops/pallas_sweep.py:52, :498), kept as plain arithmetic on the config;
`route` sends a config to B1 or to the chunked kernel B2
(ops/sweep_chunked.py) as forces/nonbonded.py:823-876 there does, and
raises where the kernel it chose does not take the config.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..forces import cellpair
from ..utils import tables

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"sweep": CSRC / "sweep.cu",
           "sweep_chunked": CSRC / "sweep_chunked.cu",
           "nh_chain": CSRC / "nh_chain.cu"}
HEADERS = (CSRC / "pair_tile.cuh",)
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# flags of one source only: the NH chain rounds each product and sum on
# its own, as its plain version's separate PyTorch ops do (ops/nh_chain.py)
SOURCE_FLAGS = {"nh_chain": ["-fmad=false"]}

# launches of each kernel, counted where it is launched and nowhere else
# (the force and the energy instantiations apart, each Coulomb kind apart:
# "_rf" for the reaction field; launches on a grid of replica bands
# apart: "_bands", and those with per-replica scales: "_scaled"; switched
# LJ apart: "_sw"; B1's launches on a home-slab range of the cells apart:
# "_slab", parallel/sharded.py and parallel/domain.py, and on a resident
# block, a rank's molecule-owned slab and its halo: "_res",
# parallel/resident.py)
launches = {f"{k}_{i}{c}{b}{w}{h}": 0 for k in ("b1", "b2")
            for i in ("sweep", "energy") for c in ("", "_rf")
            for b in ("", "_bands", "_scaled") for w in ("", "_sw")
            for h in (("", "_slab", "_res") if k == "b1" else ("",))}
INT32_MAX = 2 ** 31 - 1

# the kernels' Coulomb kinds (csrc/pair_tile.cuh::Coulomb)
COULOMB = {"ewald": 0, "rf": 1}


def coulomb_kind(method: str, alpha: float, krf: float, crf: float) -> int:
    """The kernels' code of a Coulomb kind, raising on one they do not
    take: "ewald" with alpha > 0, or "rf" with finite krf and crf."""
    if method not in COULOMB:
        raise ValueError(f"the sweep kernels take the Coulomb kinds "
                         f"{sorted(COULOMB)}, not {method!r}")
    if method == "ewald" and not (np.isfinite(alpha) and alpha > 0):
        raise ValueError(f"Ewald needs alpha > 0, got {alpha}")
    if method == "rf" and not (np.isfinite(krf) and np.isfinite(crf)):
        raise ValueError(f"the reaction field needs finite krf and crf, "
                         f"got {krf}, {crf}")
    return COULOMB[method]


def launch_key(kernel: str, energy: bool, method: str, cfg=None,
               scaled: bool = False, switched: bool = False,
               slab: bool = False, resident: bool = False) -> str:
    """The `launches` key of a kernel's instantiation (on `cfg`'s grid:
    "_bands" where it embeds replica bands; "_scaled" with per-replica
    scales; "_sw" with the LJ switch; "_slab" on a home-slab range of
    the cells, not all of them; "_res" on a resident block)."""
    geometry = ("_scaled" if scaled else "_bands"
                if cfg is not None and cfg.n_replicas > 1 else "")
    home = "_res" if resident else "_slab" if slab else ""
    return (f"{kernel}_{'energy' if energy else 'sweep'}"
            + ("_rf" if method == "rf" else "") + geometry
            + ("_sw" if switched else "") + home)


def switch_args(cfg, r_switch) -> tuple:
    """(use_switch, r_on, sw_width) of a launch: the LJ switch from
    r_switch to the cutoff (csrc/pair_tile.cuh::lj_switch), or none for
    r_switch None; raises unless 0 <= r_switch < cutoff."""
    if r_switch is None:
        return 0, 0.0, 1.0
    r_on = float(r_switch)
    if not (np.isfinite(r_on) and 0.0 <= r_on < cfg.cutoff):
        raise ValueError(f"the LJ switch needs 0 <= r_switch < cutoff "
                         f"{cfg.cutoff}, got {r_switch}")
    return 1, r_on, float(cfg.cutoff - r_on)

_libs = {}
build_log = ""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the sweep kernel is built on the "
                       "machine with the GPU (CUDA toolkit required)")


def build() -> dict:
    """Compile every source of csrc/ into its own shared library, one nvcc
    process per source, all started together.  The directory is keyed by
    the hash of all sources and the flags; each library is written under
    a temporary name and renamed, so no lock exists.  Returns
    {name: library path}."""
    global build_log
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, src in sorted(SOURCES.items()):
        key.update(name.encode() + src.read_bytes()
                   + " ".join(SOURCE_FLAGS.get(name, ())).encode())
    for hdr in HEADERS:
        key.update(hdr.name.encode() + hdr.read_bytes())
    out_dir = BUILD_ROOT / key.hexdigest()[:16]
    libs = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    todo = [name for name, lib in libs.items() if not lib.exists()]
    if not todo:
        return libs
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-o", tmp,
                 str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp)
        logs, failed = [], []
        for name, (proc, tmp) in jobs.items():
            out, _ = proc.communicate()
            logs.append(f"== {SOURCES[name].name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
            else:
                os.replace(tmp, libs[name])
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    finally:
        for proc, tmp in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return libs


def load(name: str, declare):
    """The ctypes handle of one built library, built at first use;
    `declare(lib)` sets its functions' argument and result types."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build()[name]))
        declare(lib)
        _libs[name] = lib
    return lib


def _declare(lib):
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sweep_forces.argtypes = [vp] * 18 + [ci] * 5 + [
        cf, cf, cf, ci, ci, ci, cf, cf, ci, cf, cf, ci, vp]
    lib.sweep_forces.restype = ci
    lib.sweep_energy.argtypes = [vp] * 17 + [ci] * 5 + [
        cf, cf, cf, ci, ci, ci, cf, cf, ci, cf, cf, ci, ci, ci, vp]
    lib.sweep_energy.restype = ci
    lib.sweep_attributes.argtypes = [vp, ci, ci, ci, ci]
    lib.sweep_attributes.restype = ci
    lib.sweep_occupancy.argtypes = [vp, ci, ci, ci, ci]
    lib.sweep_occupancy.restype = ci
    lib.sweep_units.argtypes = [ci, ci, ci]
    lib.sweep_units.restype = ci
    lib.sweep_warps_per_cta.restype = ci


def kernel_attributes(lib, fn: str, energy: bool = False,
                      method: str = "ewald", scaled: bool = False,
                      switched: bool = False) -> dict:
    """Registers a thread, static shared memory, the most threads a CTA
    may have and local (spill) bytes a thread of a kernel's force (or
    energy) instantiation of one Coulomb kind (with per-replica scales
    where `scaled`, with the LJ switch where `switched`), read from the
    card with cudaFuncGetAttributes by the library's function `fn`."""
    out = (ctypes.c_int * 4)()
    err = getattr(lib, fn)(ctypes.cast(out, ctypes.c_void_p), int(energy),
                           COULOMB[method], int(scaled), int(switched))
    if err != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {err}")
    return {"regs": out[0], "static_smem": out[1], "max_threads": out[2],
            "local_bytes": out[3]}


def attributes(energy: bool = False, method: str = "ewald",
               scaled: bool = False, switched: bool = False) -> dict:
    """B1's kernel_attributes."""
    return kernel_attributes(load("sweep", _declare), "sweep_attributes",
                             energy, method, scaled, switched)


_occupancy = {}


def occupancy(device, energy: bool = False, method: str = "ewald",
              scaled: bool = False, switched: bool = False) -> tuple:
    """(SMs, CTAs of B1's force or energy instantiation of a Coulomb kind
    (scaled or not, switched or not) resident an SM) of a card, read
    once from it
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); B1 launches as many
    CTAs as the card holds at once."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device.index, bool(energy), method, bool(scaled), bool(switched))
    hit = _occupancy.get(key)
    if hit is None:
        lib = load("sweep", _declare)
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(device):
            err = lib.sweep_occupancy(ctypes.cast(out, ctypes.c_void_p),
                                      int(energy), COULOMB[method],
                                      int(scaled), int(switched))
        if err != 0:
            raise RuntimeError(f"sweep_occupancy failed: CUDA error {err}")
        hit = _occupancy[key] = (out[0], max(out[1], 1))
    return hit


# the JAX gates' VMEM budget (the ~16 MB scoped-VMEM limit of a TPU core,
# less headroom); it decides the route only, no kernel of the port uses it
_TPU_VMEM_BUDGET = 12 * 1024 * 1024


def _kernel_takes(cfg) -> bool:
    """The conditions both JAX gates start from: a regular half-stencil
    grid and a full stencil along x inside one replica's x band
    (pallas_sweep.py:57, :72).  The JAX gates also ask for one exclusion
    word; the port's kernels take any number."""
    return (cfg.regular and cfg.half_stencil
            and cfg.phys_grid[0] >= 2 * cfg.window[0] + 1)


def supports(cfg) -> bool:
    """The JAX full-layer kernel's gate (pallas_sweep.py::supports, for a
    float32 config): the (y, z) plane fits its VMEM budget and fills at
    least one 128-lane tile."""
    n_yz = cfg.grid[1] * cfg.grid[2]
    n_lay = 2 * cfg.window[0] + 1
    lay_stride = -(-2 * n_yz // 128) * 128
    fr_stride = -(-n_yz // 128) * 128
    vmem = 4 * cfg.capacity * n_lay * (8 * lay_stride + 2 * 3 * fr_stride)
    return _kernel_takes(cfg) and vmem <= _TPU_VMEM_BUDGET and n_yz >= 128


def choose_chunk(cfg, force: bool = False):
    """The JAX chunked kernel's y-chunk height (pallas_sweep.py::
    choose_chunk, for a float32 config), or None: only where supports()
    fails unless `force`; the largest divisor cy of gy reaching the y
    stencil, filling >= 128 lanes and fitting the VMEM budget, preferring
    the least lane padding and pair tiles <= 512 lanes."""
    if not _kernel_takes(cfg):
        return None
    if supports(cfg) and not force:
        return None
    gx, gy, gz = cfg.grid
    C = cfg.capacity
    offs = np.array(cfg.offsets, np.int64)
    wx = int(np.max(np.abs(offs[:, 0])))
    wy = int(np.max(np.abs(offs[:, 1])))
    n_lay = 2 * wx + 1
    best = None
    for cy in range(1, gy + 1):
        if gy % cy:
            continue
        if cy < max(wy, 1) or cy + 2 * wy + 2 > 2 * gy:
            continue
        lanes = cy * gz
        if lanes < 128:
            continue
        ch_stride = -(-(cy + 2 * wy + 2) * gz // 128) * 128
        fr_stride = -(-(cy + 2 * wy) * gz // 128) * 128
        vmem = 4 * C * (n_lay * 8 * ch_stride + ch_stride
                        + 2 * 3 * (-(-lanes // 128) * 128
                                   + n_lay * fr_stride))
        if vmem > _TPU_VMEM_BUDGET:
            continue
        pad = (-(-lanes // 128) * 128) / lanes
        key = (pad, lanes > 512, -cy)
        if best is None or key < best[0]:
            best = (key, cy)
    return None if best is None else best[1]


def b1_takes(cfg) -> bool:
    """Whether kernel B1 takes the config: any capacity and any number of
    exclusion words; its slot, word, neighbour-map and work-unit indices
    in int32 (csrc/sweep.cu::sweep_forces refuses the rest; its frames
    are indexed in 64 bits)."""
    n_slots = cfg.n_cells * cfg.capacity
    units = cfg.n_cells * -(-cfg.capacity // 32) * -(-cfg.n_offsets // 8)
    return (3 * n_slots <= INT32_MAX
            and n_slots * cfg.excl_words <= INT32_MAX
            and cfg.n_cells * cfg.n_offsets <= INT32_MAX
            and units <= INT32_MAX)


def route(cfg, use_pallas=None, limits=None):
    """(kernel, chunk) of a float32 sweep: the JAX package's choice on the
    layout, ("b2", cy) where it takes its chunked kernel (supports()
    fails and choose_chunk() finds a chunk, or use_pallas == 3 forces it,
    the JAX option of the same name), else ("b1", None).  B1 also keeps
    the configs where neither JAX gate engages: those gates are Mosaic's
    lane rules, and B1 has no such limit.  The chunk height is the JAX
    gate's record; B2's own tiling is its fixed brick
    (sweep_chunked.choose_brick).

    Raises where the chosen kernel does not take the config (int32
    indices; for B2 also a CTA that fits `limits`, the card's:
    sweep_chunked.card_limits)."""
    from . import sweep_chunked
    cy = None
    if use_pallas == 3:
        kernel, cy = "b2", choose_chunk(cfg, force=True)
    elif not supports(cfg):
        cy = choose_chunk(cfg)
        kernel = "b2" if cy is not None else "b1"
    else:
        kernel = "b1"
    takes = (sweep_chunked.b2_takes(cfg, limits) if kernel == "b2"
             else b1_takes(cfg))
    if not takes:
        raise ValueError(f"kernel {kernel.upper()} does not take the config"
                         f" (grid {cfg.grid}, capacity {cfg.capacity}, "
                         f"{cfg.excl_words} exclusion words)")
    return kernel, cy


def check_excl_flags(cfg, excl_skip: bool) -> np.ndarray:
    """Per-offset flag: test the exclusion bitmask there.  With excl_skip
    only offsets with every |o| <= 1 are tested."""
    if not excl_skip:
        return np.ones(cfg.n_offsets, np.int32)
    return (np.max(np.abs(cfg.offsets), axis=1) <= 1).astype(np.int32)


def reverse_neighbors(cfg) -> np.ndarray:
    """(n_cells, n_off): the cell whose neighbour at offset o is the row's
    cell (cell - o, wrapped inside the cell's replica bands), as the
    fixed-order gather reads it; a config's own rev_map where it has
    one)."""
    if cfg.rev_map is not None:
        return cfg.rev_map
    return cellpair.neighbor_map(cfg.grid, cfg.phys_grid, cfg.offsets, -1)


def _i32_table(cfg, name, build, dev):
    """An int32 table of the config on the device, made once
    (utils/tables.py)."""
    return tables.table(cfg, name + "_i32", lambda: np.ascontiguousarray(
        build(), np.int32), dev)


def _device_tables(cfg, excl_skip, dev):
    """Neighbour map, reverse neighbour map and exclusion-test flags on
    the device, made once per config."""
    return (_i32_table(cfg, "nbr_map", lambda: cfg.nbr_map, dev),
            _i32_table(cfg, "rev_map", lambda: reverse_neighbors(cfg), dev),
            _i32_table(cfg, f"check_excl_{bool(excl_skip)}",
                       lambda: check_excl_flags(cfg, excl_skip), dev))


def unit_rows(cfg) -> np.ndarray:
    """(R, units a replica): the work units of each replica's cells
    (csrc/sweep.cu: unit = (cell * parts + part) * groups + group), in
    cell, part and group order: the order of the per-replica energy
    sums."""
    parts = -(-cfg.capacity // 32)
    groups = -(-cfg.n_offsets // 8)
    cells = cellpair.replica_cells(cfg)                    # (R, m)
    sub = np.arange(parts * groups)
    return (cells[:, :, None] * (parts * groups)
            + sub[None, None, :]).reshape(cfg.n_replicas, -1)


def _scaled_device_tables(cfg, dev):
    """Each cell's replica and the per-replica rows of the energy
    partials on the device, made once per config."""
    return (_i32_table(cfg, "rep_of_cell", lambda: cellpair.rep_of_cell(
        cfg), dev), _i32_table(cfg, "unit_rows", lambda: unit_rows(cfg), dev))


def check_shifts(shifts, cfg) -> bool:
    """Whether `shifts` is the per-replica (R, n_off, 3) table of a
    flattened ensemble (True) or the (n_off, 3) one (False); raise on
    anything else."""
    if tuple(shifts.shape) == (cfg.n_offsets, 3):
        return False
    if cfg.n_replicas > 1 and tuple(shifts.shape) == (
            cfg.n_replicas, cfg.n_offsets, 3):
        return True
    raise ValueError(f"shifts of shape {tuple(shifts.shape)}: need "
                     f"({cfg.n_offsets}, 3) or, per replica, "
                     f"({cfg.n_replicas}, {cfg.n_offsets}, 3)")


def check_config(cfg):
    """Raise unless the kernels take the config's layout."""
    if not cfg.half_stencil:
        raise ValueError("the sweep kernel takes half-stencil grids only")
    if tuple(cfg.offsets[0]) != (0, 0, 0):
        raise ValueError("the sweep kernel needs the self offset first")


def check_fields(fields, cfg):
    """Raise unless the sorted fields are what the kernels take:
    contiguous float32 and int32 slot arrays on one CUDA device."""
    dev = fields["x"].device
    n_slots = cfg.n_cells * cfg.capacity
    for k in ("x", "y", "z", "q", "sig", "seps"):
        t = fields[k]
        if t.dtype != torch.float32 or t.shape != (n_slots,) \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"field {k}: need contiguous float32 "
                             f"({n_slots},) on {dev}")
    for k, shape in (("gid", (n_slots,)),
                     ("ew", (n_slots, cfg.excl_words)),
                     ("count", (cfg.n_cells,))):
        t = fields[k]
        if t.dtype != torch.int32 or t.shape != shape \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"field {k}: need contiguous int32 {shape} "
                             f"on {dev}")


def pair_forces_plain(fields, cfg, shifts, alpha, coulomb_scale,
                      excl_skip=True, method="ewald", krf=0.0, crf=0.0,
                      r_switch=None, cells=None):
    """The plain PyTorch version: slot forces (n_cells * C, 3); cells: the
    home-slab range, as pair_forces."""
    _, f = cellpair.sweep(fields, cfg, shifts, alpha, coulomb_scale,
                          with_energy=False, excl_skip=excl_skip,
                          erfc_fn=cellpair.erfc_approx, method=method,
                          krf=krf, crf=crf, r_switch=r_switch, cells=cells)
    return f


def _card_args(fields, cfg):
    """Check a launch on the card (config, fields, int32 indices); the
    fields' device."""
    x = fields["x"]
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    check_fields(fields, cfg)
    if not b1_takes(cfg):
        raise ValueError(f"{cfg.n_cells} cells of capacity {cfg.capacity} "
                         "overflow the kernel's int32 indices")
    return x.device


def pair_forces(fields, cfg, shifts, alpha, coulomb_scale,
                excl_skip=True, method="ewald", krf=0.0, crf=0.0,
                r_switch=None, cells=None, resident=False):
    """Slot forces (n_cells * C, 3) of the direct-space sum, the same bits
    at every launch.

    fields: cellpair.sorted_fields output; shifts: (n_off, 3) per-offset
    image shift, or (R, n_off, 3) per replica (flat-ensemble NPT: the
    scaled instantiation); method: the Coulomb kind, "ewald" (alpha) or
    "rf" (krf, crf); r_switch: the LJ switch's start (None: no switch),
    ending at the cutoff; cells: the home-slab range (lo, hi) of x-major
    cell indices (None: every cell), whose stencils alone are summed,
    their reactions landing wherever the stencil reaches (the slabs of a
    partition sum to the whole; the full range gives the bits of a
    launch without one); resident: the launch is a resident block's
    (parallel/resident.py), counted under the "_res" keys.  CPU tensors
    run the plain version; CUDA tensors launch the kernel (float32 only)
    or raise."""
    check_config(cfg)
    kind = coulomb_kind(method, alpha, krf, crf)
    scaled = check_shifts(shifts, cfg)
    sw = switch_args(cfg, r_switch)
    lo, hi = cellpair.check_cells(cfg, cells)
    if fields["x"].device.type == "cpu":
        return pair_forces_plain(fields, cfg, shifts, alpha, coulomb_scale,
                                 excl_skip, method, krf, crf, r_switch,
                                 (lo, hi))
    dev = _card_args(fields, cfg)
    lib = load("sweep", _declare)
    nbr, rnbr, chk = _device_tables(cfg, excl_skip, dev)
    rep_cell = _scaled_device_tables(cfg, dev)[0] if scaled else None
    sh = shifts.to(device=dev, dtype=torch.float32).contiguous()
    nc, C, n_off = cfg.n_cells, cfg.capacity, cfg.n_offsets
    f = torch.empty((nc * C, 3), dtype=torch.float32, device=dev)
    # the frames: reactions a (cell, part, offset >= 1), home rows a work
    # unit; every entry the gather reads is written by the sweep first
    parts = -(-C // 32)
    rframe = torch.empty(max(nc * parts * (n_off - 1) * 3 * C, 1),
                         dtype=torch.float32, device=dev)
    hframe = torch.empty(lib.sweep_units(nc, C, n_off) * 96,
                         dtype=torch.float32, device=dev)
    # the work-unit counter of the launch (sweep_forces sets it to 0)
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    sms, per_sm = occupancy(dev, False, method, scaled, bool(sw[0]))
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.sweep_forces(
        *field_ptrs(fields), p(nbr), p(rnbr), p(sh),
        None if rep_cell is None else p(rep_cell), p(chk), p(rframe),
        p(hframe), p(f), p(counter), nc, lo, hi, C, n_off,
        float(cfg.cutoff * cfg.cutoff), float(alpha), float(coulomb_scale),
        cfg.excl_window, cfg.excl_words, kind, float(krf), float(crf),
        *sw, sms * per_sm, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sweep kernel launch failed: CUDA error {err}")
    launches[launch_key("b1", False, method, cfg, scaled, sw[0],
                        (lo, hi) != (0, nc), resident)] += 1
    return f


def pair_energy_plain(fields, cfg, shifts, alpha, coulomb_scale,
                      excl_skip=True, method="ewald", krf=0.0, crf=0.0,
                      r_switch=None, cells=None):
    """The energy instantiation's plain PyTorch version: the direct-space
    energy with the exact erfc or the reaction field (forces/cellpair.py::
    sweep), a 0-d tensor in the fields' type; with per-replica shifts
    (R, n_off, 3) the (R,) per-replica energies; cells: the home-slab
    range, as pair_forces."""
    e, _ = cellpair.sweep(fields, cfg, shifts, alpha, coulomb_scale,
                          with_energy=True, excl_skip=excl_skip,
                          method=method, krf=krf, crf=crf,
                          per_replica=check_shifts(shifts, cfg),
                          r_switch=r_switch, cells=cells)
    return e


def field_ptrs(fields):
    """The ctypes pointers of the sorted fields, in the kernels' order."""
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    return [p(fields[k]) for k in ("x", "y", "z", "q", "sig", "seps", "gid",
                                   "ew", "count")]


def pair_energy(fields, cfg, shifts, alpha, coulomb_scale, excl_skip=True,
                method="ewald", krf=0.0, crf=0.0, r_switch=None,
                cells=None, resident=False):
    """The direct-space energy (0-d) by B1's energy instantiation: float64
    on the card, summed in an order fixed by the data (the same bits at
    every launch); with per-replica shifts (R, n_off, 3) the scaled
    instantiation's (R,) per-replica energies; cells: the home-slab range
    (lo, hi), as pair_forces (the energy of its cells' stencils);
    resident: as pair_forces.  CPU
    tensors run the plain version; CUDA tensors launch the kernel
    (float32 fields only) or raise."""
    check_config(cfg)
    kind = coulomb_kind(method, alpha, krf, crf)
    scaled = check_shifts(shifts, cfg)
    sw = switch_args(cfg, r_switch)
    lo, hi = cellpair.check_cells(cfg, cells)
    if fields["x"].device.type == "cpu":
        return pair_energy_plain(fields, cfg, shifts, alpha, coulomb_scale,
                                 excl_skip, method, krf, crf, r_switch,
                                 (lo, hi))
    dev = _card_args(fields, cfg)
    lib = load("sweep", _declare)
    nbr, _, chk = _device_tables(cfg, excl_skip, dev)
    rep_cell, rows = (_scaled_device_tables(cfg, dev) if scaled
                      else (None, None))
    sh = shifts.to(device=dev, dtype=torch.float32).contiguous()
    units = lib.sweep_units(cfg.n_cells, cfg.capacity, cfg.n_offsets)
    part = torch.empty(units, dtype=torch.float64, device=dev)
    e = torch.empty((cfg.n_replicas,) if scaled else (),
                    dtype=torch.float64, device=dev)
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    sms, per_sm = occupancy(dev, True, method, scaled, bool(sw[0]))
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    opt = lambda t: None if t is None else p(t)
    err = lib.sweep_energy(
        *field_ptrs(fields), p(nbr), p(sh), opt(rep_cell), p(chk), p(part),
        p(e), p(counter), opt(rows), cfg.n_cells, lo, hi, cfg.capacity,
        cfg.n_offsets, float(cfg.cutoff * cfg.cutoff), float(alpha),
        float(coulomb_scale), cfg.excl_window, cfg.excl_words, kind,
        float(krf), float(crf), *sw, sms * per_sm,
        rows.shape[0] if scaled else 0, rows.shape[1] if scaled else 0,
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sweep energy launch failed: CUDA error {err}")
    launches[launch_key("b1", True, method, cfg, scaled, sw[0],
                        (lo, hi) != (0, cfg.n_cells), resident)] += 1
    return e
