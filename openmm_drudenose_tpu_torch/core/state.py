"""SimState: the dynamic state of a simulation, as a dataclass of tensors.

Per-atom arrays live on the simulation device, and so does the
Nose-Hoover chain state (a few numbers per bath, in the accumulation
dtype): the chain is integrated there (ops/nh_chain.py), so a step reads
nothing back.  The barostat's state lives on the host: its move size
and counters (Python numbers) and the torch.Generator its
proposals and Metropolis tests draw from: the host chooses the attempt
steps and reads one accept flag per attempt (integrators/barostat.py).
A flat-ensemble NPT run keeps its per-replica box scales there too
(`rep_scale`); the Context holds their device copy.
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
    eta: torch.Tensor             # (G+2, M)
    eta_dot: torch.Tensor         # (G+2, M+1); last column stays 0
    eta_dot_dot: torch.Tensor     # (G+2, M)
    ke_sum: torch.Tensor          # (): KE at the last NH half step
    group_ke: torch.Tensor        # (G+2,): per-bath 2*KE
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
    # the host generator of its draws; in flat-ensemble NPT the first
    # three are (R,) host tensors (float64, int64), one a replica
    baro_scale: Any = 0.0
    baro_naccept: Any = 0
    baro_nattempt: Any = 0
    baro_gen: Optional[torch.Generator] = None
    # flat-ensemble NPT (the JAX core/state.py rep_scale): (R,) float64 on
    # the host, replica r's box is `box` (the template box) times s_r;
    # None everywhere else
    rep_scale: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)


def zeros_state(n_atoms: int, n_baths: int, n_chains: int, box, real_dtype,
                accum_dtype, device, seed: int = 0,
                ensemble_r: int = 1) -> SimState:
    kw = dict(dtype=real_dtype, device=device)
    acc = dict(dtype=accum_dtype, device=device)
    lead = (ensemble_r,) if ensemble_r > 1 else ()
    return SimState(
        positions=torch.zeros((n_atoms, 3), **kw),
        velocities=torch.zeros((n_atoms, 3), **kw),
        forces=torch.zeros((n_atoms, 3), **kw),
        potential_energy=torch.zeros((), dtype=accum_dtype, device=device),
        box=torch.as_tensor(box, **kw),
        eta=torch.zeros(lead + (n_baths, n_chains), **acc),
        eta_dot=torch.zeros(lead + (n_baths, n_chains + 1), **acc),
        eta_dot_dot=torch.zeros(lead + (n_baths, n_chains), **acc),
        ke_sum=torch.zeros(lead, **acc),
        group_ke=torch.zeros(lead + (n_baths,), **acc),
        hardwall_runaway=torch.zeros((), dtype=torch.bool, device=device),
        baro_gen=torch.Generator(device="cpu").manual_seed(int(seed)),
    )
