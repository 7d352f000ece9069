"""Kernel B1: the cell-pair sweep's direct-space forces, hand-written in
CUDA for Hopper (csrc/sweep.cu), with its plain PyTorch version beside it.

Replaces the JAX package's TPU kernel ops/pallas_sweep.py::
pair_forces_pallas (pallas_call at :440).  It computes the same function
(forces only; LJ + Ewald real space with the A&S erfc; self cell plus the
half stencil with reactions; exclusion bitmask skipped at offsets with
any |o| >= 2), not the TPU layout: no doubled layers, lane padding or
one-hot reaction sums.

`pair_forces` is the entry point.  For a CPU tensor it runs the plain
version (`pair_forces_plain`); for a CUDA tensor it launches the kernel or
raises.  The kernel builds at first use with nvcc into
build/torch_kernels/<source hash>/ and is loaded with ctypes.
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

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "sweep.cu"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launches of the kernel, counted where it is launched and nowhere else
launches = {"b1_sweep": 0}

_lib = None
build_log = ""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the sweep kernel is built on the "
                       "machine with the GPU (CUDA toolkit required)")


def build() -> Path:
    """Compile csrc/sweep.cu into a shared library keyed by the source
    hash; written under a temporary name and renamed, so no lock exists."""
    global build_log
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out_dir = BUILD_ROOT / key[:16]
    lib = out_dir / "libsweep.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{build_log}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sweep_forces.argtypes = [vp] * 13 + [ci, ci, ci, cf, cf, cf,
                                                 ci, vp]
        lib.sweep_forces.restype = ci
        lib.sweep_max_capacity.restype = ci
        _lib = lib
    return _lib


def check_excl_flags(cfg, excl_skip: bool) -> np.ndarray:
    """Per-offset flag: test the exclusion bitmask there.  With excl_skip
    only offsets with every |o| <= 1 are tested."""
    if not excl_skip:
        return np.ones(cfg.n_offsets, np.int32)
    return (np.max(np.abs(cfg.offsets), axis=1) <= 1).astype(np.int32)


_tables = {}


def _device_tables(cfg, excl_skip, dev):
    """Neighbour map and exclusion-test flags on the device, cached per
    config (the config is held so its id stays valid)."""
    key = (id(cfg), bool(excl_skip), str(dev))
    hit = _tables.get(key)
    if hit is None:
        nbr = torch.as_tensor(cfg.nbr_map, dtype=torch.int32,
                              device=dev).contiguous()
        chk = torch.as_tensor(check_excl_flags(cfg, excl_skip),
                              device=dev).contiguous()
        hit = _tables[key] = (cfg, nbr, chk)
    return hit[1], hit[2]


def _check_config(cfg):
    if not (cfg.half_stencil and cfg.regular):
        raise ValueError("the sweep kernel takes regular half-stencil "
                         "grids only")
    if tuple(cfg.offsets[0]) != (0, 0, 0):
        raise ValueError("the sweep kernel needs the self offset first")
    if cfg.excl_words != 1 or 2 * cfg.excl_window + 1 > 31:
        raise ValueError("the sweep kernel takes one-word exclusion masks "
                         "only (2W+1 <= 31)")


def pair_forces_plain(fields, cfg, shifts, alpha, coulomb_scale,
                      excl_skip=True):
    """The plain PyTorch version: slot forces (n_cells * C, 3)."""
    _, f = cellpair.sweep(fields, cfg, shifts, alpha, coulomb_scale,
                          with_energy=False, excl_skip=excl_skip,
                          erfc_fn=cellpair.erfc_approx)
    return f


def pair_forces(fields, cfg, shifts, alpha, coulomb_scale,
                excl_skip=True):
    """Slot forces (n_cells * C, 3) of the direct-space sum.

    fields: cellpair.sorted_fields output; shifts: (n_off, 3) per-offset
    image shift.  CPU tensors run the plain version; CUDA tensors launch
    the kernel (float32 only) or raise."""
    _check_config(cfg)
    x = fields["x"]
    if x.device.type == "cpu":
        return pair_forces_plain(fields, cfg, shifts, alpha, coulomb_scale,
                                 excl_skip)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n_slots = cfg.n_cells * cfg.capacity
    for k in ("x", "y", "z", "q", "sig", "seps"):
        t = fields[k]
        if t.dtype != torch.float32 or t.shape != (n_slots,) \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"field {k}: need contiguous float32 "
                             f"({n_slots},) on {x.device}")
    for k, shape in (("gid", (n_slots,)), ("ew", (n_slots,)),
                     ("count", (cfg.n_cells,))):
        t = fields[k]
        if t.dtype != torch.int32 or t.shape != shape \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"field {k}: need contiguous int32 {shape} "
                             f"on {x.device}")
    lib = _load()
    if cfg.capacity > lib.sweep_max_capacity():
        raise ValueError(f"cell capacity {cfg.capacity} exceeds the "
                         f"kernel's {lib.sweep_max_capacity()}")
    dev = x.device
    nbr, chk = _device_tables(cfg, excl_skip, dev)
    sh = shifts.to(device=dev, dtype=torch.float32).contiguous()
    f = torch.zeros((n_slots, 3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.sweep_forces(
        p(fields["x"]), p(fields["y"]), p(fields["z"]), p(fields["q"]),
        p(fields["sig"]), p(fields["seps"]), p(fields["gid"]),
        p(fields["ew"]), p(fields["count"]), p(nbr), p(sh), p(chk), p(f),
        cfg.n_cells, cfg.capacity, cfg.n_offsets,
        float(cfg.cutoff * cfg.cutoff), float(alpha), float(coulomb_scale),
        cfg.excl_window, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sweep kernel launch failed: CUDA error {err}")
    launches["b1_sweep"] += 1
    return f
