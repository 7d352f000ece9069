"""The Custom*Force classes, on the expression compiler of
utils/expr.py: CustomBondForce, CustomAngleForce, CustomTorsionForce,
CustomExternalForce and CustomNonbondedForce, with the JAX package's
builders and conventions (forces/custom.py there):

  * CustomBondForce      - variable `r` (nm), no periodic imaging
  * CustomAngleForce     - variable `theta` in [0, pi]
  * CustomTorsionForce   - variable `theta` in (-pi, pi] (the atan2
    dihedral of forces/bonded.py); expressions carry their own periodicity
  * CustomExternalForce  - variables x, y, z (nm) of the particle, and
    periodicdistance(x1, y1, z1, x2, y2, z2) minimum-imaged in the
    current box, orthorhombic or triclinic
  * CustomNonbondedForce - variable `r` plus per-particle parameters
    suffixed 1 and 2; exclusions, the cutoff methods, and the switch
    S = 1 - 10x^3 + 15x^4 - 6x^5

A compiled term evaluates the energy in torch and takes its forces from
torch.autograd.grad of it.  In float32 the Context hands the terms the
compensated float64 positions (`exact`, as forces/bonded.py takes them):
each term then runs in float64 and rounds its energy and forces once.
Global parameters live in the compiled term (`CustomTerm.globals`), so
Context.setParameter changes a value without compiling again.

CustomNonbondedForce sums the ordered pair matrix in blocks of rows (the
JAX package's dense pattern, :505-600 there): each unordered pair counts
twice and the energy is halved.  A masked slot evaluates the expression
at r = 1 (the inner where), so an infinity there (r^-12 on the diagonal)
cannot reach the gradient through the outer where.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..utils.expr import compile_expression, expression_functions
from . import boxutils
from .bonded import _dihedral


class CustomTerm:
    """A compiled custom force: energy_forces(positions, box=None,
    pos_err=None, with_forces=True, exact=None) -> (energy, forces (N, 3);
    None without with_forces), in the positions' type.  `energy(p, box,
    globals)` is the term's energy at positions p; `globals` maps each
    global parameter to its value."""

    takes_exact = True

    def __init__(self, energy, globals_):
        self._energy = energy
        self.globals = dict(globals_)

    def energy_forces(self, positions, box=None, pos_err=None,
                      with_forces=True, exact=None):
        src = positions if exact is None else exact
        if box is not None:
            box = box.to(src.dtype)
        with torch.enable_grad():
            p = src.detach().requires_grad_(with_forces)
            e = self._energy(p, box, self.globals)
            if with_forces:
                (g,) = torch.autograd.grad(e, p)
        e = e.detach().to(positions.dtype)
        if not with_forces:
            return e, None
        return e, (-g).to(positions.dtype)


def _as_index(rows, device):
    return torch.as_tensor(np.asarray(rows, np.int64).reshape(-1),
                           device=device)


class _CustomBondedBase:
    """Shared per-term/global parameter bookkeeping."""

    _VAR: str = ""
    _N_PARTICLES: int = 0

    def __init__(self, energy: str):
        self._energy_expr = str(energy)
        self._per_names: List[str] = []
        self._globals: List[Tuple[str, float]] = []
        self._terms: List[tuple] = []

    # -- expression ------------------------------------------------------
    def getEnergyFunction(self) -> str:
        return self._energy_expr

    def setEnergyFunction(self, energy: str) -> None:
        self._energy_expr = str(energy)

    # -- parameters ------------------------------------------------------
    def addGlobalParameter(self, name: str, defaultValue: float) -> int:
        self._globals.append((str(name), float(defaultValue)))
        return len(self._globals) - 1

    def getNumGlobalParameters(self) -> int:
        return len(self._globals)

    def getGlobalParameterName(self, index: int) -> str:
        return self._globals[index][0]

    def getGlobalParameterDefaultValue(self, index: int) -> float:
        return self._globals[index][1]

    def setGlobalParameterDefaultValue(self, index: int, value: float):
        name, _ = self._globals[index]
        self._globals[index] = (name, float(value))

    def _add_per(self, name: str) -> int:
        self._per_names.append(str(name))
        return len(self._per_names) - 1

    def usesPeriodicBoundaryConditions(self) -> bool:
        return False

    # -- compile ---------------------------------------------------------
    def _compiled_expr(self):
        names = ([self._VAR] + list(self._per_names)
                 + [g[0] for g in self._globals])
        return compile_expression(self._energy_expr, names)

    def compile(self, system, dtype, device):
        if not self._terms:
            return None
        fn = self._compiled_expr()
        k = self._N_PARTICLES
        idx = [_as_index([t[c] for t in self._terms], device)
               for c in range(k)]
        per = np.array([t[k] for t in self._terms], np.float64).reshape(
            len(self._terms), len(self._per_names))
        per_t = {name: torch.as_tensor(per[:, c], device=device)
                 for c, name in enumerate(self._per_names)}
        variable = self._variable

        def energy(p, box, glb):
            env = {name: v.to(p.dtype) for name, v in per_t.items()}
            env.update(glb)
            env.update(variable(p, idx, box))
            return torch.sum(fn(env))

        return CustomTerm(energy, self._globals)

    def _check_term_params(self, params: Sequence[float]):
        if len(params) != len(self._per_names):
            raise ValueError(
                f"expected {len(self._per_names)} per-term parameter(s) "
                f"({self._per_names}), got {len(params)}")
        return tuple(float(p) for p in params)


class CustomBondForce(_CustomBondedBase):
    """OpenMM-compatible CustomBondForce: E = f(r) per bond."""

    _VAR = "r"
    _N_PARTICLES = 2

    @staticmethod
    def _variable(p, idx, box):
        delta = p[idx[0]] - p[idx[1]]
        return {"r": torch.sqrt(torch.sum(delta * delta, dim=-1))}

    def addPerBondParameter(self, name: str) -> int:
        return self._add_per(name)

    def getNumPerBondParameters(self) -> int:
        return len(self._per_names)

    def getPerBondParameterName(self, index: int) -> str:
        return self._per_names[index]

    def addBond(self, particle1: int, particle2: int,
                parameters: Sequence[float] = ()) -> int:
        self._terms.append((int(particle1), int(particle2),
                            self._check_term_params(parameters)))
        return len(self._terms) - 1

    def getNumBonds(self) -> int:
        return len(self._terms)

    def getBondParameters(self, index: int):
        return self._terms[index]

    def setBondParameters(self, index, particle1, particle2,
                          parameters: Sequence[float] = ()):
        self._terms[index] = (int(particle1), int(particle2),
                              self._check_term_params(parameters))

    def bonded_pairs(self):
        return [(t[0], t[1]) for t in self._terms]

class CustomAngleForce(_CustomBondedBase):
    """OpenMM-compatible CustomAngleForce: E = f(theta) per angle."""

    _VAR = "theta"
    _N_PARTICLES = 3

    @staticmethod
    def _variable(p, idx, box):
        v1 = p[idx[0]] - p[idx[1]]
        v2 = p[idx[2]] - p[idx[1]]
        dot = torch.sum(v1 * v2, dim=-1)
        n1 = torch.linalg.norm(v1, dim=-1)
        n2 = torch.linalg.norm(v2, dim=-1)
        return {"theta": torch.acos(torch.clamp(dot / (n1 * n2), -1.0,
                                                1.0))}

    def addPerAngleParameter(self, name: str) -> int:
        return self._add_per(name)

    def getNumPerAngleParameters(self) -> int:
        return len(self._per_names)

    def getPerAngleParameterName(self, index: int) -> str:
        return self._per_names[index]

    def addAngle(self, particle1: int, particle2: int, particle3: int,
                 parameters: Sequence[float] = ()) -> int:
        self._terms.append((int(particle1), int(particle2), int(particle3),
                            self._check_term_params(parameters)))
        return len(self._terms) - 1

    def getNumAngles(self) -> int:
        return len(self._terms)

    def getAngleParameters(self, index: int):
        return self._terms[index]

    def setAngleParameters(self, index, p1, p2, p3,
                           parameters: Sequence[float] = ()):
        self._terms[index] = (int(p1), int(p2), int(p3),
                              self._check_term_params(parameters))

    def bonded_pairs(self):
        out = []
        for t in self._terms:
            out.append((t[0], t[1]))
            out.append((t[1], t[2]))
        return out

class CustomTorsionForce(_CustomBondedBase):
    """OpenMM-compatible CustomTorsionForce: E = f(theta) per torsion,
    theta the atan2 dihedral in (-pi, pi]."""

    _VAR = "theta"
    _N_PARTICLES = 4

    @staticmethod
    def _variable(p, idx, box):
        return {"theta": _dihedral([p[i] for i in idx])[0]}

    def addPerTorsionParameter(self, name: str) -> int:
        return self._add_per(name)

    def getNumPerTorsionParameters(self) -> int:
        return len(self._per_names)

    def getPerTorsionParameterName(self, index: int) -> str:
        return self._per_names[index]

    def addTorsion(self, p1: int, p2: int, p3: int, p4: int,
                   parameters: Sequence[float] = ()) -> int:
        self._terms.append((int(p1), int(p2), int(p3), int(p4),
                            self._check_term_params(parameters)))
        return len(self._terms) - 1

    def getNumTorsions(self) -> int:
        return len(self._terms)

    def getTorsionParameters(self, index: int):
        return self._terms[index]

    def setTorsionParameters(self, index, p1, p2, p3, p4,
                             parameters: Sequence[float] = ()):
        self._terms[index] = (int(p1), int(p2), int(p3), int(p4),
                              self._check_term_params(parameters))

    def bonded_pairs(self):
        out = []
        for t in self._terms:
            out.append((t[0], t[1]))
            out.append((t[1], t[2]))
            out.append((t[2], t[3]))
        return out

class CustomExternalForce(_CustomBondedBase):
    """OpenMM-compatible CustomExternalForce: E = f(x, y, z) per tagged
    particle — the standard OpenMM vehicle for positional restraints,
    umbrella-sampling biases, and external fields (the reference workflow
    inherits it from the host toolkit; `CustomExternalForce.h` in OpenMM).

    Variables are the particle's Cartesian coordinates x, y, z (nm) plus
    per-particle and global parameters.  The OpenMM builtin
    ``periodicdistance(x1, y1, z1, x2, y2, z2)`` is available and applies
    minimum-image convention under the CURRENT box (orthorhombic or
    triclinic), so restraints stay correct under NPT box moves.
    Matching OpenMM, a particle may be tagged multiple times.
    """

    _VAR = None  # variables are x, y, z (handled directly)
    _N_PARTICLES = 1

    @staticmethod
    def _variable(p, idx, box):
        pos = p[idx[0]]

        def periodicdistance(x1, y1, z1, x2, y2, z2):
            delta = torch.stack(torch.broadcast_tensors(
                *(torch.as_tensor(a - b, dtype=p.dtype, device=p.device)
                  for a, b in ((x1, x2), (y1, y2), (z1, z2)))), dim=-1)
            d = boxutils.min_image(delta, box)
            return torch.sqrt(torch.sum(d * d, dim=-1))

        return {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
                "periodicdistance": periodicdistance}

    def addPerParticleParameter(self, name: str) -> int:
        return self._add_per(name)

    def getNumPerParticleParameters(self) -> int:
        return len(self._per_names)

    def getPerParticleParameterName(self, index: int) -> str:
        return self._per_names[index]

    def addParticle(self, particle: int,
                    parameters: Sequence[float] = ()) -> int:
        self._terms.append((int(particle),
                            self._check_term_params(parameters)))
        return len(self._terms) - 1

    def getNumParticles(self) -> int:
        return len(self._terms)

    def getParticleParameters(self, index: int):
        return self._terms[index]

    def setParticleParameters(self, index, particle: int,
                              parameters: Sequence[float] = ()):
        self._terms[index] = (int(particle),
                              self._check_term_params(parameters))

    def bonded_pairs(self):
        return []  # single-particle terms add no connectivity

    def usesPeriodicBoundaryConditions(self) -> bool:
        return "periodicdistance" in expression_functions(self._energy_expr)

    def _compiled_expr(self):
        names = (["x", "y", "z"] + list(self._per_names)
                 + [g[0] for g in self._globals])
        return compile_expression(self._energy_expr, names,
                                  extra_fns={"periodicdistance": 6})

class CustomNonbondedForce:
    """OpenMM-compatible CustomNonbondedForce: E = f(r, per-particle
    params suffixed 1/2) summed over non-excluded pairs.

    Evaluated over the full ordered pair matrix in row blocks (energy
    halved): a general path for small systems, not the cell-pair sweep.
    """

    NoCutoff = 0
    CutoffNonPeriodic = 1
    CutoffPeriodic = 2

    def __init__(self, energy: str):
        self._energy_expr = str(energy)
        self._per_names: List[str] = []
        self._globals: List[Tuple[str, float]] = []
        self._particles: List[tuple] = []
        self._exclusions: List[Tuple[int, int]] = []
        self._method = self.NoCutoff
        self._cutoff = 1.0
        self._use_switch = False
        self._switch_dist = -1.0

    # -- expression / parameters ----------------------------------------
    getEnergyFunction = _CustomBondedBase.getEnergyFunction
    setEnergyFunction = _CustomBondedBase.setEnergyFunction
    addGlobalParameter = _CustomBondedBase.addGlobalParameter
    getNumGlobalParameters = _CustomBondedBase.getNumGlobalParameters
    getGlobalParameterName = _CustomBondedBase.getGlobalParameterName
    getGlobalParameterDefaultValue = \
        _CustomBondedBase.getGlobalParameterDefaultValue
    setGlobalParameterDefaultValue = \
        _CustomBondedBase.setGlobalParameterDefaultValue

    def addPerParticleParameter(self, name: str) -> int:
        self._per_names.append(str(name))
        return len(self._per_names) - 1

    def getNumPerParticleParameters(self) -> int:
        return len(self._per_names)

    def getPerParticleParameterName(self, index: int) -> str:
        return self._per_names[index]

    def addParticle(self, parameters: Sequence[float] = ()) -> int:
        if len(parameters) != len(self._per_names):
            raise ValueError(
                f"expected {len(self._per_names)} per-particle "
                f"parameter(s) ({self._per_names}), got {len(parameters)}")
        self._particles.append(tuple(float(p) for p in parameters))
        return len(self._particles) - 1

    def getNumParticles(self) -> int:
        return len(self._particles)

    def getParticleParameters(self, index: int):
        return self._particles[index]

    def setParticleParameters(self, index, parameters: Sequence[float]):
        if len(parameters) != len(self._per_names):
            raise ValueError(
                f"expected {len(self._per_names)} per-particle "
                f"parameter(s), got {len(parameters)}")
        self._particles[index] = tuple(float(p) for p in parameters)

    def addExclusion(self, particle1: int, particle2: int) -> int:
        self._exclusions.append((int(particle1), int(particle2)))
        return len(self._exclusions) - 1

    def getNumExclusions(self) -> int:
        return len(self._exclusions)

    def getExclusionParticles(self, index: int):
        return self._exclusions[index]

    # -- method / cutoff -------------------------------------------------
    def setNonbondedMethod(self, method: int) -> None:
        if method not in (self.NoCutoff, self.CutoffNonPeriodic,
                          self.CutoffPeriodic):
            raise ValueError(f"unsupported nonbonded method {method}")
        self._method = int(method)

    def getNonbondedMethod(self) -> int:
        return self._method

    def setCutoffDistance(self, cutoff: float) -> None:
        self._cutoff = float(cutoff)

    def getCutoffDistance(self) -> float:
        return self._cutoff

    def setUseSwitchingFunction(self, use: bool) -> None:
        self._use_switch = bool(use)

    def getUseSwitchingFunction(self) -> bool:
        return self._use_switch

    def setSwitchingDistance(self, distance: float) -> None:
        self._switch_dist = float(distance)

    def getSwitchingDistance(self) -> float:
        return self._switch_dist

    def usesPeriodicBoundaryConditions(self) -> bool:
        return self._method == self.CutoffPeriodic

    # -- compile ---------------------------------------------------------

    def compile(self, system, dtype, device, block_rows: int = 256):
        n = len(self._particles)
        if n == 0:
            return None
        if n != system.getNumParticles():
            raise ValueError(
                f"CustomNonbondedForce has {n} particles but the System "
                f"has {system.getNumParticles()}")
        names = (["r"] + [p + "1" for p in self._per_names]
                 + [p + "2" for p in self._per_names]
                 + [g[0] for g in self._globals])
        fn = compile_expression(self._energy_expr, names)
        per = torch.as_tensor(np.array(self._particles, np.float64).reshape(
            n, len(self._per_names)), device=device)
        # (n, E) exclusion table padded with the row's own index (the
        # diagonal is excluded anyway)
        excl: List[List[int]] = [[] for _ in range(n)]
        for a, b in self._exclusions:
            excl[a].append(b)
            excl[b].append(a)
        E = max((len(e) for e in excl), default=0)
        excl_tab = np.tile(np.arange(n, dtype=np.int64)[:, None],
                           (1, max(E, 1)))
        for i, es in enumerate(excl):
            excl_tab[i, :len(es)] = es
        excl_tab = torch.as_tensor(excl_tab, device=device)
        periodic = self._method == self.CutoffPeriodic
        use_cut = self._method != self.NoCutoff
        cutoff = self._cutoff
        use_switch = self._use_switch and use_cut and self._switch_dist >= 0
        r_switch = self._switch_dist
        per_names = list(self._per_names)
        B = max(1, min(block_rows, n))
        cols = torch.arange(n, device=device)

        def energy(p, box, glb):
            pos = p[:n]
            perp = per.to(p.dtype)
            e = torch.zeros((), dtype=p.dtype, device=p.device)
            for r0 in range(0, n, B):
                rows = cols[r0:r0 + B]
                delta = pos[r0:r0 + B, None, :] - pos[None, :, :]
                if periodic:
                    delta = boxutils.min_image(delta, box)
                r2 = torch.sum(delta * delta, dim=-1)
                mask = rows[:, None] != cols[None, :]
                for k in range(excl_tab.shape[1]):
                    mask = mask & (excl_tab[r0:r0 + B, k][:, None]
                                   != cols[None, :])
                if use_cut:
                    mask = mask & (r2 < cutoff * cutoff)
                r = torch.sqrt(torch.where(mask, torch.clamp(r2, min=1e-12),
                                           torch.ones_like(r2)))
                env = {"r": r}
                for c, name in enumerate(per_names):
                    env[name + "1"] = perp[r0:r0 + B, c][:, None]
                    env[name + "2"] = perp[:, c][None, :]
                env.update(glb)
                eb = fn(env)
                if use_switch:
                    x = torch.clamp((r - r_switch) / (cutoff - r_switch),
                                    0.0, 1.0)
                    eb = eb * (1.0 + x * x * x
                               * (-10.0 + x * (15.0 - 6.0 * x)))
                e = e + 0.5 * torch.sum(torch.where(
                    mask, eb, torch.zeros_like(r)))
            return e

        return CustomTerm(energy, self._globals)

