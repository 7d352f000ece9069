"""Replica ensembles: N independent copies of a Context's system advanced
together (the JAX package's parallel/ensemble.py, BASELINE.md config 5).

The JAX package batches the whole step with `jax.vmap` over a leading
replica axis of the state.  PyTorch cannot vmap a ctypes kernel launch,
and a host loop over the replicas would multiply the launches of a step
that is already host-bound.  So the port holds the R replicas as ONE
Context of R replica-major copies of the system in one box: a
parallel/flatrep.py::FlatReplicaEnsemble on the template's strategy
(`replicate_system`, `Context(ensemble_r=R)`): (R, G+2) baths,
per-replica KE and CM reductions, one force pass a step for all R.
Replicas never interact, whatever the template Context's strategy:

  * "cellpair": the replica-band path of kernels B1 and B2 (each
    replica's cells in bands of their own, the stencil wrapped inside
    them: forces/cellpair.py::make_ensemble_config), in an rx x rz
    layout with rx * rz = R (no pad replicas);
  * "dense": the block-diagonal all-pairs sum, each replica's (n0, n0)
    block in one batched pass (forces/dense.py, n_replicas);
  * "cell": neighbour lists built per replica in one pass (forces/
    neighborlist.py, n_replicas);

and the PME sum runs per replica, R grids in one batched pass.  Each
replica's trajectory equals a standalone Context's of the same strategy
(to the order of the sums).

The multi-chip half of the JAX module (`mesh`, `state_sharding`,
`shard_ensemble`) is ROADMAP.md A19; `mesh` raises here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..units import BOLTZ
from .flatrep import FlatReplicaEnsemble

# the state fields with one row an atom (tiled replica-major) and the
# thermostat fields with one leading replica axis (stacked)
_PER_ATOM = ("positions", "velocities", "forces", "pos_err")
_PER_REPLICA = ("eta", "eta_dot", "eta_dot_dot", "ke_sum", "group_ke")


def stack_states(states):
    """One ensemble state of per-replica SimStates (the port's layout:
    per-atom arrays concatenated replica-major, the thermostat arrays
    stacked on a leading (R,) axis).  They share one box."""
    s0 = states[0]
    for s in states[1:]:
        if not torch.equal(s.box, s0.box):
            raise ValueError("the replicas of an ensemble share one box")
    kw = {}
    for f in _PER_ATOM:
        vals = [getattr(s, f) for s in states]
        kw[f] = None if vals[0] is None else torch.cat(vals, dim=0)
    for f in _PER_REPLICA:
        kw[f] = torch.stack([getattr(s, f) for s in states])
    kw["potential_energy"] = torch.sum(torch.stack(
        [s.potential_energy for s in states]))
    return s0.replace(neighbors=None, **kw)


def replicate_state(state, n_replicas: int, seed: int = 0):
    """Broadcast one state to an ensemble of `n_replicas` (the port's
    layout, as stack_states), with a fresh barostat generator seeded
    with `seed` (the JAX function splits one PRNG key per replica)."""
    if state.ke_sum.dim() != 0:
        raise ValueError("the state is an ensemble's already")
    R = int(n_replicas)
    kw = {f: (None if getattr(state, f) is None
              else getattr(state, f).repeat(R, 1)) for f in _PER_ATOM}
    for f in _PER_REPLICA:
        t = getattr(state, f)
        kw[f] = t.unsqueeze(0).expand((R,) + tuple(t.shape)).clone()
    return state.replace(
        neighbors=None, potential_energy=state.potential_energy * R,
        baro_gen=torch.Generator(device="cpu").manual_seed(int(seed)),
        **kw)


def replica_layout(R: int) -> tuple:
    """(rx, rz) of R replica bands on the cell-pair strategy: rz the
    largest divisor of R at most sqrt(R), rx = R / rz (no pad
    replicas)."""
    rz = max(d for d in range(1, int(np.sqrt(R)) + 1) if R % d == 0)
    return R // rz, rz


class ReplicaEnsemble(FlatReplicaEnsemble):
    """R independent copies of `context`'s system advanced together.

        ens = ReplicaEnsemble(ctx, n_replicas=64)
        ens.setVelocitiesToTemperature(300.0)
        ens.step(1000)
        ke = ens.kinetic_energies()        # (64,)

    A FlatReplicaEnsemble on the template Context's strategy, with the
    JAX ReplicaEnsemble's start and draw: every replica starts from the
    template's whole state (positions, velocities, box and thermostat
    chain; `replicate_state`), and the cell-pair strategy lays the
    replicas out in rx x rz = R bands (`replica_layout`, no pad
    replicas).  `seed` seeds the ensemble's barostat generator.
    Context.step surfaces the guard flags of every replica (a hard-wall
    runaway, a skin-sized drift, an excluded pair spanning >= 2 cells),
    as the JAX ensemble's _check_flags does."""

    def __init__(self, context, n_replicas: int, mesh=None, seed: int = 0):
        if mesh is not None:
            raise NotImplementedError(
                "a replica ensemble sharded over a device mesh is ROADMAP.md "
                "A19 (the multi-chip modules on torch.distributed); pass "
                "mesh=None")
        context._ensure_forces()
        R = int(n_replicas)
        if R < 1:
            raise ValueError("n_replicas must be >= 1")
        strategy = (context._nb.strategy if context._nb is not None
                    else "dense")
        rx, rz = replica_layout(R)
        super().__init__(context, R, rx, rz, seed=seed, strategy=strategy)
        ctx = self.context
        npt = ctx._state.rep_scale is not None
        st = replicate_state(context._state, R, seed)
        if npt:
            st = st.replace(**{f: getattr(ctx._state, f) for f in (
                "rep_scale", "baro_scale", "baro_naccept", "baro_nattempt")})
        ctx._state = st
        ctx._ke_valid = bool(context._ke_valid)

    @property
    def state(self):
        """The ensemble's SimState (the port's layout: per-atom arrays
        (R n0, 3) replica-major, thermostat arrays (R, ...))."""
        return self.context._state

    def setVelocitiesToTemperature(self, temperature: float,
                                   seed: int = 0) -> None:
        """Maxwell-Boltzmann velocities, each replica its own draw, from a
        torch.Generator seeded with `seed` (other numbers than the JAX
        package's jax.random keys)."""
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        sigma = np.sqrt(BOLTZ * float(temperature) * self._template._spec
                        .inv_mass.double().cpu().numpy())
        v = torch.randn((self._n_replicas, self._n0, 3), generator=gen,
                        dtype=torch.float64) * torch.as_tensor(
                            sigma)[None, :, None]
        self.setVelocities(v.numpy())


def check_isolated(ens: FlatReplicaEnsemble, replica: int = 0,
                   shift: float = 0.05) -> float:
    """max |dF| on every other replica when every atom of `replica`
    moves by `shift` nm along x (zero where replicas are isolated): a
    probe of the ensemble's force pass.  The forces at the moved
    positions come first, so that a cell capacity grown there serves
    both passes (the order of the sums depends on it)."""
    ctx = ens.context
    st = ctx._state
    n0 = ens._n0
    pos = st.positions.clone()
    pos[replica * n0:(replica + 1) * n0, 0] += shift
    try:
        ctx._state = st.replace(positions=pos, neighbors=None)
        ctx._forces_valid = False
        ctx._ensure_forces()
        f1 = ctx._state.forces
        ctx._state = st.replace(neighbors=None)
        ctx._forces_valid = False
        ctx._ensure_forces()
        f0 = ctx._state.forces
    finally:
        ctx._state = st.replace(neighbors=None)
        ctx._forces_valid = False
    keep = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    keep[replica * n0:(replica + 1) * n0] = False
    return float(torch.max(torch.abs(f1[keep] - f0[keep])))
