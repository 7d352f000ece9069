"""CMMotionRemover: subtracts the centre-of-mass velocity every
`frequency` steps (integrators/tgnh.py).  It has no potential energy; its
presence also takes 3 DOF from the COM temperature bath (core/spec.py)."""

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
