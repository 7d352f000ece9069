"""Periodic boxes: orthorhombic and triclinic (reduced-form) geometry.

The JAX package's forces/boxutils.py (:29-163 there), in PyTorch.
Conventions are OpenMM's reduced form: box row vectors a = (ax, 0, 0),
b = (bx, by, 0), c = (cx, cy, cz) with ax, by, cz > 0 and |bx| <= ax/2,
|cx| <= ax/2, |cy| <= by/2.  The diagonal entries are then the
perpendicular widths between the faces spanned by the other two
vectors, so OpenMM's rule cutoff <= min(ax, by, cz) / 2 makes the
sequential c -> b -> a rounding of `min_image` exact.

A `box` argument of the force code is either a (3,) diagonal
(orthorhombic: every formula is the historical per-component one, bit
for bit) or the (3, 3) reduced row-vector matrix (triclinic); `mi_box`
chooses which a Context passes down.  Fractional coordinates and
lattice combinations are formed elementwise from the closed-form
lower-triangular inverse, never by a matrix product: on the card a
float32 matmul could run in TF32 and misbin atoms near cell faces.
"""

from __future__ import annotations

import numpy as np
import torch


def reduce_box(box) -> np.ndarray:
    """OpenMM's reduction of (3, 3) row vectors into the reduced form
    above (host side, float64).  Requires a along x and b in the xy
    plane."""
    box = np.array(box, np.float64)
    if abs(box[0][1]) > 1e-12 or abs(box[0][2]) > 1e-12 \
            or abs(box[1][2]) > 1e-12:
        raise ValueError(
            "periodic box vectors must have a along x and b in the xy "
            f"plane (OpenMM convention); got {box.tolist()}")
    if min(box[0][0], box[1][1], box[2][2]) <= 0:
        raise ValueError("periodic box edge lengths must be positive")
    box[2] -= box[1] * round(box[2][1] / box[1][1])
    box[2] -= box[0] * round(box[2][0] / box[0][0])
    box[1] -= box[0] * round(box[1][0] / box[0][0])
    return box


def is_triclinic(box) -> bool:
    """Whether a (3, 3) box has off-diagonal entries (a (3,) diagonal or
    a diagonal matrix is orthorhombic)."""
    box = np.asarray(box.detach().cpu() if torch.is_tensor(box) else box,
                     np.float64)
    if box.ndim == 1:
        return False
    return bool(np.abs(box - np.diag(np.diagonal(box))).max() > 1e-12)


def mi_box(box, triclinic: bool):
    """The box a force term takes: the full (3, 3) matrix when the
    system is triclinic, else its (3,) diagonal."""
    return box if triclinic else torch.diagonal(box)


def volume(box):
    """The cell volume: the product of the diagonal, which for reduced
    row vectors (lower triangular) is the determinant."""
    if box.dim() == 1:
        return box[0] * box[1] * box[2]
    return box[0, 0] * box[1, 1] * box[2, 2]


def min_image(delta, box):
    """delta (..., 3) -> its minimum image under `box` ((3,) or (3, 3)):
    per component for a diagonal, else the sequential c -> b -> a
    rounding."""
    if box.dim() == 1:
        return delta - box * torch.round(delta / box)
    d = delta
    for k in (2, 1, 0):
        d = d - box[k] * torch.round(d[..., k:k + 1] / box[k, k])
    return d


def inv_box(box):
    """Inverse of the reduced (lower-triangular) row-vector box (3, 3),
    in closed form; lower triangular too."""
    ax = box[0, 0]
    bx, by = box[1, 0], box[1, 1]
    cx, cy, cz = box[2, 0], box[2, 1], box[2, 2]
    zero = torch.zeros((), dtype=box.dtype, device=box.device)
    return torch.stack([
        torch.stack([1.0 / ax, zero, zero]),
        torch.stack([-bx / (ax * by), 1.0 / by, zero]),
        torch.stack([(bx * cy - by * cx) / (ax * by * cz), -cy / (by * cz),
                     1.0 / cz])])


def frac_coords(positions, box):
    """positions (..., 3) -> fractional coordinates (positions = frac @
    box for row-vector boxes), elementwise; positions / box for a
    diagonal."""
    if box.dim() == 1:
        return positions / box
    inv = inv_box(box)
    x, y, z = positions[..., 0], positions[..., 1], positions[..., 2]
    return torch.stack([x * inv[0, 0] + y * inv[1, 0] + z * inv[2, 0],
                        y * inv[1, 1] + z * inv[2, 1],
                        z * inv[2, 2]], dim=-1)


def rows_combo(coeff, box):
    """coeff (..., 3) of the rows -> sum_k coeff_k box[k] (..., 3),
    elementwise (the Cartesian point of fractional or integer lattice
    coordinates); coeff * box for a diagonal."""
    if box.dim() == 1:
        return coeff * box
    u, v, w = coeff[..., 0], coeff[..., 1], coeff[..., 2]
    return torch.stack([u * box[0, 0] + v * box[1, 0] + w * box[2, 0],
                        v * box[1, 1] + w * box[2, 1],
                        w * box[2, 2]], dim=-1)


def plane_widths(box):
    """(3,) perpendicular distances between opposite faces along each
    fractional axis, w_d = 1 / |column d of the inverse| (two atoms
    whose cells differ by k along d are at least (k - 1) w_d / g_d
    apart); the diagonal itself for an orthorhombic box."""
    if box.dim() == 1:
        return box
    inv = inv_box(box)
    return 1.0 / torch.sqrt(torch.sum(inv * inv, dim=0))
