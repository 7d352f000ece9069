"""Simulation: the OpenMM app-layer workflow the reference example runs
(example/nacl_tg.py: Simulation, minimizeEnergy, StateDataReporter,
CheckpointReporter, DCDReporter, PDBReporter), as the JAX package's
app/simulation.py has it."""

from __future__ import annotations

import time
from typing import List

import numpy as np

from ..units import BOLTZ
from . import serialization
from .context import Context

# grams per dalton
DALTON_G = 1.66053906660e-24


class Simulation:
    def __init__(self, topology, system, integrator, precision="single",
                 strategy: str = "auto", seed: int = 0, device=None):
        """topology may be None (only the reporters that write atom
        names need it).  The Context runs on CUDA unless `device` says
        otherwise."""
        self.topology = topology
        self.system = system
        self.integrator = integrator
        self.context = Context(system, integrator, precision=precision,
                               strategy=strategy, seed=seed, device=device)
        self.reporters: List[object] = []
        self.currentStep = 0

    def minimizeEnergy(self, tolerance: float = 10.0,
                       maxIterations: int = 500) -> None:
        self.context.minimizeEnergy(tolerance, maxIterations)

    def step(self, steps: int) -> None:
        """Advance `steps` steps in chunks that end where a reporter is
        due, and call each reporter due there."""
        remaining = int(steps)
        while remaining > 0:
            next_report = min(
                (r.describeNextReport(self) for r in self.reporters),
                default=remaining)
            chunk = max(1, min(remaining, next_report))
            self.integrator.step(chunk)
            self.currentStep += chunk
            remaining -= chunk
            for r in self.reporters:
                if self.currentStep % r._interval == 0:
                    r.report(self, None)

    def saveCheckpoint(self, path: str) -> None:
        serialization.save_checkpoint(path, self.context)

    def loadCheckpoint(self, path: str) -> None:
        serialization.load_checkpoint(path, self.context)
        self.currentStep = int(self.context._state.step)


class _IntervalReporter:
    def __init__(self, reportInterval: int):
        self._interval = int(reportInterval)

    def describeNextReport(self, simulation) -> int:
        return self._interval - simulation.currentStep % self._interval


class StateDataReporter(_IntervalReporter):
    """CSV reporter with OpenMM's columns and the per-bath temperatures
    (the quantity the TGNH thermostat controls)."""

    def __init__(self, file, reportInterval: int, step: bool = True,
                 time: bool = True, potentialEnergy: bool = True,
                 kineticEnergy: bool = True, totalEnergy: bool = False,
                 temperature: bool = True, density: bool = False,
                 groupTemperatures: bool = False, speed: bool = False,
                 separator: str = ","):
        super().__init__(reportInterval)
        self._out = open(file, "w") if isinstance(file, str) else file
        self._opts = dict(step=step, time=time, pe=potentialEnergy,
                          ke=kineticEnergy, te=totalEnergy, temp=temperature,
                          dens=density, gt=groupTemperatures, speed=speed)
        self._sep = separator
        self._header_done = False
        self._t0 = None
        self._step0 = 0

    def report(self, simulation, _state) -> None:
        ctx = simulation.context
        st = ctx.getState(energy=True, groups=self._opts["gt"])
        spec = ctx._spec
        cols, vals = [], []
        o = self._opts
        if o["step"]:
            cols.append("Step")
            vals.append(str(simulation.currentStep))
        if o["time"]:
            cols.append("Time (ps)")
            vals.append(f"{st.getTime():.4f}")
        if o["pe"]:
            cols.append("PE (kJ/mol)")
            vals.append(f"{st.getPotentialEnergy():.4f}")
        if o["ke"]:
            cols.append("KE (kJ/mol)")
            vals.append(f"{st.getKineticEnergy():.4f}")
        if o["te"]:
            cols.append("Total (kJ/mol)")
            vals.append(f"{st.getPotentialEnergy() + st.getKineticEnergy():.4f}")
        if o["temp"]:
            ndof = total_dof(spec, simulation.integrator)
            cols.append("T (K)")
            vals.append(f"{2.0 * st.getKineticEnergy() / (ndof * BOLTZ):.2f}"
                        if ndof else "nan")
        if o["dens"]:
            vol = float(np.prod(np.diagonal(st.getPeriodicBoxVectors())))
            mass_g = float(spec.mass.double().sum()) * DALTON_G
            cols.append("Density (g/mL)")
            vals.append(f"{mass_g / (vol * 1e-21):.4f}")
        if o["gt"]:
            temps = st.getGroupTemperatures()
            for i, t in enumerate(temps[:-2]):
                cols.append(f"T_group{i} (K)")
                vals.append(f"{t:.2f}")
            cols.append("T_COM (K)")
            vals.append(f"{temps[-2]:.2f}")
            cols.append("T_Drude (K)")
            vals.append(f"{temps[-1]:.2f}")
        if o["speed"]:
            now = time.time()
            speed = 0.0
            if self._t0 is not None and now > self._t0:
                steps = simulation.currentStep - self._step0
                speed = (steps * simulation.integrator.getStepSize()
                         * 1e-3 * 86400.0 / (now - self._t0))
            self._t0, self._step0 = now, simulation.currentStep
            cols.append("Speed (ns/day)")
            vals.append(f"{speed:.2f}")
        if not self._header_done:
            self._out.write("#" + self._sep.join(cols) + "\n")
            self._header_done = True
        self._out.write(self._sep.join(vals) + "\n")
        self._out.flush()


def total_dof(spec, integ) -> float:
    """Total DOF = the sum over baths of NkbT_g / (kB T_g target)."""
    nkbt = spec.nh_nkbt.double().cpu().numpy()
    t_real = integ.getTemperature()
    t_drude = integ.getDrudeTemperature()
    dof = nkbt[:-1].sum() / (BOLTZ * t_real) if t_real > 0 else 0.0
    if t_drude > 0:
        dof += nkbt[-1] / (BOLTZ * t_drude)
    return dof


class CheckpointReporter(_IntervalReporter):
    def __init__(self, file: str, reportInterval: int):
        super().__init__(reportInterval)
        self._path = file

    def report(self, simulation, _state) -> None:
        serialization.save_checkpoint(self._path, simulation.context)


class DCDReporter(_IntervalReporter):
    """Positions and box every `reportInterval` steps into a DCD file
    (io/dcd.py); the frame count is patched in on `close`."""

    def __init__(self, file: str, reportInterval: int):
        super().__init__(reportInterval)
        from ..io.dcd import DCDWriter
        self._writer = DCDWriter(file)

    def report(self, simulation, _state) -> None:
        st = simulation.context.getState(positions=True)
        self._writer.write_frame(st.getPositions(),
                                 st.getPeriodicBoxVectors())

    def close(self) -> None:
        self._writer.close()


class PDBReporter(_IntervalReporter):
    """Positions every `reportInterval` steps as MODEL records of one PDB
    file (io/pdbfile.write_model, with the Simulation's topology)."""

    def __init__(self, file: str, reportInterval: int):
        super().__init__(reportInterval)
        self._path = file
        self._frame = 0

    def report(self, simulation, _state) -> None:
        from ..io import pdbfile
        st = simulation.context.getState(positions=True)
        mode = "w" if self._frame == 0 else "a"
        with open(self._path, mode) as f:
            pdbfile.write_model(f, st.getPositions(), simulation.topology,
                                model=self._frame + 1)
        self._frame += 1
