"""ctypes bindings to the native host runtime (csrc/host/
drudenose_native.cpp, this package's copy of the JAX package's native/
source): the JAX package's utils/native.py.

The shared library is compiled with g++ at first use into
build/torch_native/<hash of the source and flags>/ at the root of the
checkout (never beside the JAX package's library or its hash sidecar),
written under a temporary name and renamed, so a library is never loaded
half written and a changed source builds anew.  Every entry point
returns None where the library is missing (no g++, or the build
failed), for the caller's pure-Python path.  The port's own system
builds keep their vectorised NumPy paths (core/topology.molecule_ids:
the union-find's gain there is a few ms of a build of seconds, which
chip_smoke.py phase 17 times beside it), so no Context waits on a g++
build.  `build_error` keeps why the build failed, for a caller that
must have the library (chip_smoke.py asserts it loaded on the card's
host).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = (Path(__file__).resolve().parent.parent / "csrc" / "host"
          / "drudenose_native.cpp")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_native"
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_tried = False
build_error = None


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    key = hashlib.sha256(" ".join(GXX_FLAGS).encode()
                         + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / key / "libdrudenose_native.so"


def _build(so: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise OSError("g++ not found")
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded library, or None (the fallbacks are used)."""
    global _lib, _tried, build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
        except subprocess.CalledProcessError as err:
            build_error = f"g++ failed: {err.stderr}"
            return None
        except OSError as err:
            build_error = str(err)
            return None
        lib.dn_molecule_ids.restype = ctypes.c_int64
        lib.dn_molecule_ids.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32)]
        lib.dn_parse_pdb.restype = ctypes.c_int64
        lib.dn_parse_pdb.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double)]
        lib.dn_residue_masses.restype = None
        lib.dn_residue_masses.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def molecule_ids_native(n: int, edges: np.ndarray):
    """edges: (m, 2) int64.  (labels int32 numbered by first appearance,
    n_molecules), or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    edges = np.ascontiguousarray(edges, np.int64)
    labels = np.empty(n, np.int32)
    n_mol = lib.dn_molecule_ids(n, _ptr(edges, ctypes.c_int64),
                                len(edges), _ptr(labels, ctypes.c_int32))
    return labels, int(n_mol)


def parse_pdb_native(path: str, max_atoms: int = 8_000_000):
    """(coords (n, 3) nm, res_seq, names, res_names, box or None) of a
    PDB file's ATOM/HETATM and CRYST1 records, or None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    coords = np.empty((max_atoms, 3), np.float64)
    res_seq = np.empty(max_atoms, np.int32)
    names = np.zeros(max_atoms * 8, np.uint8)
    res_names = np.zeros(max_atoms * 8, np.uint8)
    box = np.zeros(3, np.float64)
    count = lib.dn_parse_pdb(
        path.encode(), max_atoms, _ptr(coords, ctypes.c_double),
        _ptr(res_seq, ctypes.c_int32),
        names.ctypes.data_as(ctypes.c_char_p),
        res_names.ctypes.data_as(ctypes.c_char_p),
        _ptr(box, ctypes.c_double))
    if count < 0:
        raise IOError(f"dn_parse_pdb failed for {path!r} (code {count})")
    names = names.reshape(max_atoms, 8)[:count]
    res_names = res_names.reshape(max_atoms, 8)[:count]
    to_str = lambda arr: [bytes(r).rstrip(b"\0").decode() for r in arr]
    return (coords[:count].copy(), res_seq[:count].copy(),
            to_str(names), to_str(res_names),
            box if box.any() else None)


def residue_masses_native(resid: np.ndarray, masses: np.ndarray,
                          n_res: int):
    """(n_res,) the mass of each residue, or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    resid = np.ascontiguousarray(resid, np.int32)
    masses = np.ascontiguousarray(masses, np.float64)
    out = np.empty(n_res, np.float64)
    lib.dn_residue_masses(len(resid), _ptr(resid, ctypes.c_int32),
                          _ptr(masses, ctypes.c_double), n_res,
                          _ptr(out, ctypes.c_double))
    return out
