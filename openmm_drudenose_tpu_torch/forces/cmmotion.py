"""CMMotionRemover and MonteCarloBarostat: neither has a potential
energy; both act through the step (integrators/tgnh.py).

  - CMMotionRemover subtracts the centre-of-mass velocity every
    `frequency` steps; its presence also takes 3 DOF from the COM
    temperature bath (core/spec.py).
  - MonteCarloBarostat proposes an isotropic volume move every
    `frequency` steps, scaling molecule centres of mass, with the NPT
    Metropolis test and OpenMM's adaptive move size
    (integrators/barostat.py), as the JAX package's forces/cmmotion.py.
"""

from __future__ import annotations


class CMMotionRemover:
    def __init__(self, frequency: int = 1):
        self._frequency = int(frequency)

    def getFrequency(self) -> int:
        return self._frequency

    def setFrequency(self, freq: int) -> None:
        self._frequency = int(freq)

    def usesPeriodicBoundaryConditions(self) -> bool:
        return False

    def bonded_pairs(self):
        return []

    def compile(self, system, dtype, device):
        return None


class MonteCarloBarostat:
    def __init__(self, defaultPressure: float, defaultTemperature: float,
                 frequency: int = 25):
        """defaultPressure in bar, defaultTemperature in K."""
        self._pressure = float(defaultPressure)
        self._temperature = float(defaultTemperature)
        self._frequency = int(frequency)

    def getDefaultPressure(self) -> float:
        return self._pressure

    def setDefaultPressure(self, p: float) -> None:
        self._pressure = float(p)

    def getDefaultTemperature(self) -> float:
        return self._temperature

    def setDefaultTemperature(self, t: float) -> None:
        self._temperature = float(t)

    def getFrequency(self) -> int:
        return self._frequency

    def setFrequency(self, f: int) -> None:
        self._frequency = int(f)

    def usesPeriodicBoundaryConditions(self) -> bool:
        return True

    def bonded_pairs(self):
        return []

    def compile(self, system, dtype, device):
        return None
