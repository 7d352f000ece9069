"""SWM4-NDP water as the reference sees it, from a configuration file's
"water" group alone: per-site charges, LJ parameters, masses, the M
site's weights from the published geometry, the Drude spring, the rigid
triangle, and the baths' degrees of freedom."""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Water:
    n_mol: int               # molecules in one replica
    order: tuple             # site names in a molecule, e.g. O D H1 H2 M
    charge: np.ndarray       # (5,) e
    sigma: np.ndarray        # (5,) nm
    epsilon: np.ndarray      # (5,) kJ/mol
    mass: np.ndarray         # (5,) dalton
    k_drude: float           # kJ/mol/nm^2, E = k d^2 / 2
    r_oh: float
    r_hh: float
    w_m: tuple               # (w_O, w_H1, w_H2) of the M site
    box: float               # cubic edge, nm

    @property
    def n0(self) -> int:
        return 5 * self.n_mol

    def site(self, name: str) -> int:
        return self.order.index(name)

    def per_atom(self, x: np.ndarray) -> np.ndarray:
        return np.tile(x, self.n_mol)

    # -- what the harness reads of any topology (portbench/systems/) --
    @property
    def site_mass(self) -> np.ndarray:
        """(n0,) mass of every site of one replica, 0 for a virtual site."""
        return self.per_atom(self.mass)

    @property
    def massive(self) -> np.ndarray:
        return self.site_mass > 0

    @property
    def drude_pairs(self) -> tuple:
        """(cores, Drudes): (n_mol,) site indices of each pair."""
        first = 5 * np.arange(self.n_mol)
        return first + self.site("O"), first + self.site("D")

    def dof(self, cm_remover: bool) -> tuple:
        """(internal, COM, Drude) degrees of freedom of one replica: each
        massive site 3, less 3 a Drude pair (its relative motion is the
        Drude bath's), 1 a constraint and 3 a molecule (its COM is the COM
        bath's); the COM bath 3 a molecule, less 3 with a CM remover."""
        massive = int(np.count_nonzero(self.mass > 0))
        internal = self.n_mol * (3 * massive - 3 - 3 - 3)
        com = 3 * self.n_mol - (3 if cm_remover else 0)
        return internal, com, 3 * self.n_mol


def from_config(cfg: dict) -> Water:
    w = cfg["water"]
    order = tuple(w["site_order"])
    kind = [s.rstrip("12") for s in order]
    q = np.array([w["charge"][k] for k in kind], np.float64)
    lj = w["lennard_jones"]
    sig = np.array([lj[k][0] if k in lj else 1.0 for k in kind], np.float64)
    eps = np.array([lj[k][1] if k in lj else 0.0 for k in kind], np.float64)
    m = np.array([w["mass"][k] for k in kind], np.float64)
    r_oh, r_hh, r_om = w["r_OH_nm"], w["r_HH_nm"], w["r_OM_nm"]
    w23 = r_om / (2.0 * math.sqrt(r_oh ** 2 - (r_hh / 2.0) ** 2))
    n_mol = int(cfg["n_molecules"])
    box = (n_mol / float(cfg["number_density_per_nm3"])) ** (1.0 / 3.0)
    return Water(n_mol=n_mol, order=order, charge=q, sigma=sig,
                 epsilon=eps, mass=m, k_drude=float(w["drude_k_kj_per_nm2"]),
                 r_oh=r_oh, r_hh=r_hh, w_m=(1.0 - 2.0 * w23, w23, w23),
                 box=box)
