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

Over torch.distributed ranks (the mesh half of the JAX module:
state_sharding :50, shard_ensemble :75, ReplicaEnsemble(mesh=...) :92),
`ReplicaEnsemble(context, R, mesh=...)` with a parallel/comm.py Mesh
gives each coordinate of the mesh's "replica" axis R / D of the replicas
as an ensemble of its own, with no traffic between them; positions(),
velocities(), kinetic_energies() and potential_energies() gather over
that axis in global replica order.  A template that is itself a flat
ensemble (a FlatReplicaEnsemble's context, R0 replicas) runs whole
copies of it, each rank its own: D x R0 replicas, as the JAX package's
flat sub-ensembles over a replica mesh.  On a ("replica", "atom") mesh
each replica group's force pass is also split over its "atom" ranks
(parallel/sharded.py: the slab sweep on cell pairs, the rows of each
replica's pair block on the dense strategy, the PME spread by atoms);
its state stays whole on each of them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..units import BOLTZ
from . import comm
from .flatrep import FlatReplicaEnsemble, _clone_integrator

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
    as the JAX ensemble's _check_flags does.  With a parallel/comm.py
    Mesh the call returns a MeshReplicaEnsemble instead (spread over the
    ranks, the module docstring), a class of its own."""

    def __new__(cls, context=None, n_replicas: int = 1, mesh=None,
                seed: int = 0):
        if mesh is not None:
            return MeshReplicaEnsemble(context, n_replicas, mesh, seed)
        return super().__new__(cls)

    def __init__(self, context, n_replicas: int, mesh=None, seed: int = 0):
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
        st = (replicate_state(context._state, R, seed) if R > 1 else
              context._state.replace(neighbors=None, baro_gen=torch.Generator(
                  device="cpu").manual_seed(int(seed))))
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


def state_sharding(mesh, state, replica_axis: str = "replica",
                   atom_axis: str = "atom") -> dict:
    """For each field of an ensemble state (the port's layout), the mesh
    axis each of its dimensions is split over, None where every rank
    holds it whole: the per-atom rows (R n0, 3) and the thermostat rows
    (R, ...) over `replica_axis`, nothing over `atom_axis` (the atom
    ranks of a replica group share its state and split its force pass,
    parallel/sharded.py), the box and the scalars whole.  A field that
    is None maps to None."""
    rep = replica_axis if replica_axis in mesh.axis_names else None
    out = {}
    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        if not isinstance(t, torch.Tensor):
            out[f.name] = None
        elif f.name in _PER_ATOM or f.name in _PER_REPLICA:
            out[f.name] = (rep,) + (None,) * (t.dim() - 1)
        else:
            out[f.name] = (None,) * t.dim()
    return out


def shard_ensemble(mesh, state, replica_axis: str = "replica",
                   atom_axis: str = "atom"):
    """This rank's piece of an ensemble state: the rows of its replicas
    (the block of R / D at its replica coordinate) of every field that
    state_sharding splits."""
    spec = state_sharding(mesh, state, replica_axis, atom_axis)
    if replica_axis not in mesh.axis_names:
        return state
    D = mesh.size(replica_axis)
    d = mesh.index(replica_axis)
    kw = {}
    for name, axes in spec.items():
        if axes and axes[0] == replica_axis:
            t = getattr(state, name)
            if t.shape[0] % D:
                raise ValueError(f"{name}: {t.shape[0]} rows do not divide "
                                 f"into {D} replica ranks")
            m = t.shape[0] // D
            kw[name] = t[d * m:(d + 1) * m]
    return state.replace(**kw)


def _clone_context(context, seed: int):
    """A Context of the same system, integrator settings, options and
    state, with a barostat generator of its own seeded with `seed`."""
    from ..app.context import Context
    c = Context(context._system, _clone_integrator(context._integrator, 1),
                precision=context._prec, strategy=context._strategy,
                seed=context._seed, hardwall_strict=context._hardwall_strict,
                nb_options=dict(context._nb_options),
                device=context._device, ensemble_r=context._ensemble_r)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    c._state = context._state.replace(neighbors=None, baro_gen=gen)
    c._ke_valid = bool(context._ke_valid)
    return c


class _Copy:
    """A whole copy of a flat-ensemble template (its Context, R0
    replicas): one member of a mesh ensemble of flat sub-ensembles, with
    the accessors of a one-member ensemble (leading axis 1)."""

    def __init__(self, template, seed: int):
        self.context = _clone_context(template, seed)

    def positions(self):
        return self.context._state.positions.double().cpu().numpy()[None]

    def velocities(self):
        return self.context._state.velocities.double().cpu().numpy()[None]

    def setPositions(self, p):
        self.context.setPositions(np.asarray(p)[0])

    def setVelocities(self, v):
        self.context.setVelocities(np.asarray(v)[0])

    def kinetic_energies(self):
        """(1, R0)."""
        ctx = self.context
        if ctx._ke_valid:
            return ctx._state.ke_sum.double().cpu().numpy()[None].copy()
        m = ctx._spec.mass.double().cpu().numpy()
        v = ctx._state.velocities.double().cpu().numpy()
        ke = 0.5 * m * np.sum(v * v, axis=-1)
        return ke.reshape(1, ctx._ensemble_r, -1).sum(axis=2)

    def potential_energies(self):
        """(1,): the sub-ensemble's total."""
        return np.array([self.context.getState(
            energy=True).getPotentialEnergy()])

    def boxes(self):
        """(1, R0, 3, 3): the template box times each replica's scale in
        NPT, copies of the one box otherwise."""
        st = self.context._state
        box = st.box.double().cpu().numpy()
        s = (np.ones(self.context._ensemble_r) if st.rep_scale is None
             else st.rep_scale.double().numpy())
        return (box[None, :, :] * s[:, None, None])[None]

    def step(self, n: int) -> None:
        self.context._integrator.step(n)


class MeshReplicaEnsemble:
    """R replicas of `context`'s system over the ranks of a parallel/
    comm.py Mesh with a "replica" axis of D ranks (what
    ReplicaEnsemble(context, R, mesh=mesh) returns): each replica
    coordinate runs k = R / D of them as `members`, one ReplicaEnsemble of
    k replicas of a plain template, or k whole copies (`_Copy`) of a
    flat-ensemble template (flat sub-ensembles, D k x R0 replicas), and
    the accessors gather over the replica axis in global replica order.
    On a ("replica", "atom") mesh each member's pair and reciprocal sums
    are split over the replica group's atom ranks (parallel/sharded.py::
    shard_context; cell pairs or the dense strategy).  Built on every rank
    with the same arguments.  The members' barostat generators are seeded
    with `seed` plus their first global replica.  What a mesh ensemble
    cannot gather (the per-bath temperatures) raises."""

    def __init__(self, context, n_replicas: int, mesh, seed: int = 0):
        from .sharded import shard_context
        if not isinstance(mesh, comm.Mesh):
            raise TypeError(f"mesh: a parallel.comm.Mesh, not "
                            f"{type(mesh).__name__}")
        if "replica" not in mesh.axis_names:
            raise ValueError("a replica ensemble's mesh needs a 'replica' "
                             "axis")
        R = int(n_replicas)
        D = mesh.size("replica")
        if R < 1 or R % D:
            raise ValueError(f"{R} replicas do not divide over {D} replica "
                             f"ranks")
        context._ensure_forces()
        self._mesh = mesh
        self._n_replicas = R
        self._k = R // D
        self._first = mesh.index("replica") * self._k
        self._template = context
        if context._ensemble_r > 1:
            self.members = [_Copy(context, seed + self._first + i)
                            for i in range(self._k)]
        else:
            self.members = [ReplicaEnsemble(context, self._k,
                                            seed=seed + self._first)]
        if "atom" in mesh.axis_names and mesh.size("atom") > 1:
            for m in self.members:
                shard_context(m.context, mesh, "atom",
                              strategies=("cellpair", "dense"))

    @property
    def context(self):
        """The first member's Context (this rank's)."""
        return self.members[0].context

    @property
    def state(self):
        """This rank's piece: the first member's SimState."""
        return self.members[0].context._state

    @property
    def n_replicas(self) -> int:
        return self._n_replicas

    def _gather(self, name: str) -> np.ndarray:
        """(R, ...) from this rank's members' (k, ...) rows of `name`, in
        global replica order."""
        local = np.concatenate([getattr(m, name)() for m in self.members])
        t = torch.as_tensor(np.ascontiguousarray(local))
        return comm.all_gather(self._mesh, "replica", t).reshape(
            (self._n_replicas,) + tuple(t.shape[1:])).numpy()

    def _scatter(self, name: str, rows) -> None:
        """Each member's `name` setter on its rows of the (R, ...) array
        (an (n, 3) array: every replica the same)."""
        x = np.asarray(rows, np.float64)
        if x.ndim == 2:
            x = np.broadcast_to(x, (self._n_replicas,) + x.shape)
        if x.shape[0] != self._n_replicas:
            raise ValueError(f"rows for {x.shape[0]} replicas, not "
                             f"{self._n_replicas}")
        mine = x[self._first:self._first + self._k]
        i = 0
        for m in self.members:
            n = 1 if isinstance(m, _Copy) else self._k
            getattr(m, name)(mine[i:i + n])
            i += n

    def positions(self) -> np.ndarray:
        """(R, n, 3): each replica's positions (n: the template's atoms)."""
        return self._gather("positions")

    def velocities(self) -> np.ndarray:
        return self._gather("velocities")

    def setPositions(self, positions) -> None:
        """(R, n, 3) (or (n, 3), every replica the same): each rank takes
        its replicas' rows."""
        self._scatter("setPositions", positions)

    def setVelocities(self, velocities) -> None:
        """(R, n, 3) (or (n, 3)), as setPositions."""
        self._scatter("setVelocities", velocities)

    def setVelocitiesToTemperature(self, temperature: float,
                                   seed: int = 0) -> None:
        """Maxwell-Boltzmann velocities of all R replicas from one
        torch.Generator seeded with `seed` (the same numbers whatever the
        mesh), each rank keeping its rows."""
        tpl = self._template
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        sigma = np.sqrt(BOLTZ * float(temperature)
                        * tpl._spec.inv_mass.double().cpu().numpy())
        n = tpl._static.n_atoms
        v = torch.randn((self._n_replicas, n, 3), generator=gen,
                        dtype=torch.float64) * torch.as_tensor(
                            sigma)[None, :, None]
        self.setVelocities(v.numpy())

    def kinetic_energies(self) -> np.ndarray:
        """(R,), or (R, R0) for flat sub-ensembles of R0 replicas."""
        return self._gather("kinetic_energies")

    def potential_energies(self) -> np.ndarray:
        """(R,): each replica's potential energy (a flat sub-ensemble's
        total)."""
        return self._gather("potential_energies")

    def total_potential_energy(self) -> float:
        return float(np.sum(self.potential_energies()))

    def boxes(self) -> np.ndarray:
        """(R, 3, 3) per-replica box vectors, or (R, R0, 3, 3) for flat
        sub-ensembles."""
        return self._gather("boxes")

    def group_temperatures(self):
        raise NotImplementedError("a mesh ensemble's bath temperatures: "
                                  "read each member's context")

    def step(self, steps: int) -> None:
        for m in self.members:
            m.step(steps)


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
