"""User-facing DrudeTGNHIntegrator.

The reference's public class (openmmapi/include/openmm/
DrudeTGNHIntegrator.h:56-315): the same constructor and defaults
(drudeStepsPerRealStep=20, numNHChains=1, useDrudeNHChains=False,
useCOMTempGroup=True), the temperature-group API, the hard wall
(get/setMaxDrudeDistance) and constraintTolerance 1e-5.  A copy of the
JAX package's app/integrator.py, which the port may not import.
"""

from __future__ import annotations

from typing import List


class DrudeTGNHIntegrator:
    def __init__(self, temperature: float, couplingTime: float,
                 drudeTemperature: float, drudeCouplingTime: float,
                 stepSize: float, drudeStepsPerRealStep: int = 20,
                 numNHChains: int = 1, useDrudeNHChains: bool = False,
                 useCOMTempGroup: bool = True):
        self._temperature = float(temperature)
        self._coupling_time = float(couplingTime)
        self._drude_temperature = float(drudeTemperature)
        self._drude_coupling_time = float(drudeCouplingTime)
        self._step_size = float(stepSize)
        self._drude_steps = int(drudeStepsPerRealStep)
        self._num_nh_chains = int(numNHChains)
        self._use_drude_nh_chains = bool(useDrudeNHChains)
        self._use_com_temp_group = bool(useCOMTempGroup)
        self._max_drude_distance = 0.0
        self._constraint_tolerance = 1e-5
        self._temp_groups: List[int] = []
        self._particle_temp_group: List[int] = []
        self._context = None  # bound by Context construction

    # -- scalar params -------------------------------------------------------
    def getTemperature(self) -> float:
        return self._temperature

    def setTemperature(self, temp: float) -> None:
        self._temperature = float(temp)

    def getCouplingTime(self) -> float:
        return self._coupling_time

    def setCouplingTime(self, tau: float) -> None:
        self._coupling_time = float(tau)

    def getDrudeTemperature(self) -> float:
        return self._drude_temperature

    def setDrudeTemperature(self, temp: float) -> None:
        self._drude_temperature = float(temp)

    def getDrudeCouplingTime(self) -> float:
        return self._drude_coupling_time

    def setDrudeCouplingTime(self, tau: float) -> None:
        self._drude_coupling_time = float(tau)

    def getStepSize(self) -> float:
        return self._step_size

    def setStepSize(self, size: float) -> None:
        self._step_size = float(size)
        if self._context is not None:
            self._context._on_step_size_changed()

    def getMaxDrudeDistance(self) -> float:
        return self._max_drude_distance

    def setMaxDrudeDistance(self, distance: float) -> None:
        if distance < 0:
            raise ValueError("Max Drude distance cannot be negative")
        self._max_drude_distance = float(distance)

    def getDrudeStepsPerRealStep(self) -> int:
        return self._drude_steps

    def setDrudeStepsPerRealStep(self, n: int) -> None:
        self._drude_steps = int(n)

    def getNumNHChains(self) -> int:
        return self._num_nh_chains

    def setNumNHChains(self, n: int) -> None:
        self._num_nh_chains = int(n)

    def getUseDrudeNHChains(self) -> bool:
        return self._use_drude_nh_chains

    def setUseDrudeNHChains(self, use: bool) -> None:
        self._use_drude_nh_chains = bool(use)

    def getUseCOMTempGroup(self) -> bool:
        return self._use_com_temp_group

    def setUseCOMTempGroup(self, use: bool) -> None:
        self._use_com_temp_group = bool(use)

    def getConstraintTolerance(self) -> float:
        return self._constraint_tolerance

    def setConstraintTolerance(self, tol: float) -> None:
        self._constraint_tolerance = float(tol)

    # -- temperature groups ---------------------------------------------------
    def getNumTempGroups(self) -> int:
        return len(self._temp_groups)

    def addTempGroup(self) -> int:
        self._temp_groups.append(len(self._temp_groups))
        return len(self._temp_groups) - 1

    def addParticleTempGroup(self, tempGroup: int) -> int:
        tempGroup = int(tempGroup)
        if not 0 <= tempGroup < max(len(self._temp_groups), 1):
            raise ValueError("Temperature group index out of range")
        self._particle_temp_group.append(tempGroup)
        return len(self._particle_temp_group) - 1

    def setParticleTempGroup(self, particle: int, tempGroup: int) -> None:
        particle = int(particle)
        tempGroup = int(tempGroup)
        if not 0 <= tempGroup < max(len(self._temp_groups), 1):
            raise ValueError("Temperature group index out of range")
        while len(self._particle_temp_group) <= particle:
            self._particle_temp_group.append(0)
        self._particle_temp_group[particle] = tempGroup

    def getParticleTempGroup(self, particle: int) -> int:
        if not self._particle_temp_group:
            return 0
        return self._particle_temp_group[int(particle)]

    # -- residues (populated by Context; reference exposes the same queries,
    #    DrudeTGNHIntegrator.h:260-276) ---------------------------------------
    def getNumResidues(self) -> int:
        self._require_context()
        return self._context._static.n_residues

    def getResInvMass(self, resid: int) -> float:
        self._require_context()
        return float(self._context._spec.res_inv_mass[resid])

    def getParticleResId(self, particle: int) -> int:
        self._require_context()
        return int(self._context._spec.resid[particle])

    # -- stepping --------------------------------------------------------------
    def step(self, steps: int) -> None:
        self._require_context()
        self._context.step(steps)

    def _require_context(self):
        if self._context is None:
            raise RuntimeError(
                "This Integrator is not bound to a Context; create a "
                "Context(system, integrator) first")
