"""SimState: the dynamic state of a simulation, as a dataclass of tensors.

Per-atom arrays live on the simulation device.  The Nose-Hoover chain
state (a few numbers per bath) lives on the host in the accumulation
dtype: the chain is integrated there (integrators/tgnh.py), as the
reference plugin's host loop does.  So does the barostat's state (its
move size and counters, Python numbers) and the torch.Generator its
proposals and Metropolis tests draw from: the host chooses the attempt
steps and reads one accept flag per attempt (integrators/barostat.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass
class SimState:
    positions: torch.Tensor       # (N, 3) nm
    velocities: torch.Tensor      # (N, 3) nm/ps
    forces: torch.Tensor          # (N, 3) kJ/mol/nm, from the last pass
    potential_energy: torch.Tensor  # () kJ/mol, from the last energy pass
    box: torch.Tensor             # (3, 3) nm, rows are box vectors
    # the chain arrays, ke_sum and group_ke carry a leading replica axis
    # (R,) in a flattened replica ensemble (the JAX core/state.py:57-60)
    eta: torch.Tensor             # (G+2, M) host
    eta_dot: torch.Tensor         # (G+2, M+1) host; last column stays 0
    eta_dot_dot: torch.Tensor     # (G+2, M) host
    ke_sum: torch.Tensor          # () host: KE at the last NH half step
    group_ke: torch.Tensor        # (G+2,) host: per-bath 2*KE
    step: int = 0
    time: float = 0.0
    # sticky: a Drude moved > 2x past the hard wall since the last reset
    hardwall_runaway: Optional[torch.Tensor] = None
    neighbors: Any = None         # forces.cellpair.CellSort
    # two-float compensated positions (f32 with Drude pairs): the true
    # position is positions + pos_err, keeping the low bits of the tiny
    # Drude-parent displacement that f32 absolute coordinates drop
    pos_err: Optional[torch.Tensor] = None
    # MonteCarloBarostat: adaptive volume move size (nm^3, 0 = not yet
    # set), accepted and attempted moves since the last adaptation, and
    # the host generator of its draws
    baro_scale: float = 0.0
    baro_naccept: int = 0
    baro_nattempt: int = 0
    baro_gen: Optional[torch.Generator] = None

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)


def zeros_state(n_atoms: int, n_baths: int, n_chains: int, box, real_dtype,
                accum_dtype, device, seed: int = 0,
                ensemble_r: int = 1) -> SimState:
    kw = dict(dtype=real_dtype, device=device)
    host = dict(dtype=accum_dtype, device="cpu")
    lead = (ensemble_r,) if ensemble_r > 1 else ()
    return SimState(
        positions=torch.zeros((n_atoms, 3), **kw),
        velocities=torch.zeros((n_atoms, 3), **kw),
        forces=torch.zeros((n_atoms, 3), **kw),
        potential_energy=torch.zeros((), dtype=accum_dtype, device=device),
        box=torch.as_tensor(box, **kw),
        eta=torch.zeros(lead + (n_baths, n_chains), **host),
        eta_dot=torch.zeros(lead + (n_baths, n_chains + 1), **host),
        eta_dot_dot=torch.zeros(lead + (n_baths, n_chains), **host),
        ke_sum=torch.zeros(lead, **host),
        group_ke=torch.zeros(lead + (n_baths,), **host),
        hardwall_runaway=torch.zeros((), dtype=torch.bool, device=device),
        baro_gen=torch.Generator(device="cpu").manual_seed(int(seed)),
    )
