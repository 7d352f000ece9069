"""Minimal CHARMM/X-PLOR DCD trajectory writer (the format the reference
example records through OpenMM's DCDReporter, example/nacl_tg.py:87):
the JAX package's io/dcd.py, the same bytes for the same frames but the
title, which names this package.  The header carries the AKMA time step
and the unit-cell flag, every frame its unit cell, and the frame count
is patched into the header on close."""

from __future__ import annotations

import struct

import numpy as np

# the title record: 80 bytes
TITLE = b"Created by openmm_drudenose_tpu_torch"


class DCDWriter:
    def __init__(self, path: str, dt_ps: float = 0.001,
                 interval: int = 1):
        self._f = open(path, "wb")
        self._n_atoms = None
        self._n_frames = 0
        self._dt = dt_ps
        self._interval = interval

    def _block(self, payload: bytes) -> None:
        self._f.write(struct.pack("<i", len(payload)))
        self._f.write(payload)
        self._f.write(struct.pack("<i", len(payload)))

    def _write_header(self, n_atoms: int) -> None:
        # AKMA time unit: 1 AKMA = 0.04888821 ps
        delta = self._dt * self._interval / 0.04888821
        head = struct.pack(
            "<4s9if10i", b"CORD",
            0,               # frames so far (patched on close)
            0,               # first step
            self._interval,  # steps between frames
            0, 0, 0, 0, 0, 0,
            delta,
            1,               # unit cell present
            0, 0, 0, 0, 0, 0, 0, 0,
            24)              # CHARMM version
        self._block(head)
        self._block(struct.pack("<i", 1) + TITLE.ljust(80)[:80])
        self._block(struct.pack("<i", n_atoms))
        self._f.flush()

    def write_frame(self, positions_nm: np.ndarray, box_nm) -> None:
        """Write one frame.  `box_nm`: the (3,) diagonal of an
        orthorhombic box or the (3, 3) row-vector box matrix; a triclinic
        cell is recorded as (a, b, c, alpha, beta, gamma) of its
        vectors."""
        pos = np.asarray(positions_nm, np.float64) * 10.0  # nm -> angstrom
        if self._n_atoms is None:
            self._n_atoms = pos.shape[0]
            self._write_header(self._n_atoms)
        box = np.asarray(box_nm, np.float64) * 10.0
        if box.ndim == 1:
            a, b, c = box
            cos_a = cos_b = cos_g = 0.0
        else:
            v1, v2, v3 = box
            a = float(np.linalg.norm(v1))
            b = float(np.linalg.norm(v2))
            c = float(np.linalg.norm(v3))
            cos_a = float(np.dot(v2, v3) / (b * c))   # alpha: angle(b, c)
            cos_b = float(np.dot(v1, v3) / (a * c))   # beta:  angle(a, c)
            cos_g = float(np.dot(v1, v2) / (a * b))   # gamma: angle(a, b)
        # CHARMM unit-cell record: a, cos(gamma), b, cos(beta), cos(alpha), c
        self._block(struct.pack("<6d", a, cos_g, b, cos_b, cos_a, c))
        for c in range(3):
            self._block(pos[:, c].astype("<f4").tobytes())
        self._n_frames += 1
        self._f.flush()

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.seek(8)                  # the frame count
        self._f.write(struct.pack("<i", self._n_frames))
        self._f.close()

    def __del__(self):  # best-effort frame-count patch on collection
        try:
            self.close()
        except Exception:
            pass


def read_dcd(path: str):
    """(positions (F, N, 3) nm, cells (F, 6): a, b, c in nm and the
    cosines of gamma, beta, alpha, header dict) of a file DCDWriter
    wrote."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0

    def block():
        nonlocal off
        (n,) = struct.unpack_from("<i", data, off)
        payload = data[off + 4:off + 4 + n]
        off += n + 8
        return payload

    head = struct.unpack("<4s9if10i", block())
    title = block()
    (n_atoms,) = struct.unpack("<i", block())
    frames, cells = [], []
    while off < len(data):
        a, cg, b, cb, ca, c = struct.unpack("<6d", block())
        cells.append((a / 10.0, b / 10.0, c / 10.0, cg, cb, ca))
        xyz = [np.frombuffer(block(), "<f4") for _ in range(3)]
        frames.append(np.stack(xyz, axis=1).astype(np.float64) / 10.0)
    info = {"n_frames": head[1], "interval": head[3], "delta": head[10],
            "unit_cell": head[11], "title": title[4:], "n_atoms": n_atoms}
    return (np.array(frames).reshape(-1, n_atoms, 3),
            np.array(cells).reshape(-1, 6), info)
