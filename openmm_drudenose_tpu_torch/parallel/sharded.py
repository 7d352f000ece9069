"""Work-sharded force pass and step over torch.distributed ranks (the JAX
package's parallel/sharded.py: make_slab_sweep :64,
make_sharded_energy_and_forces :145, ShardedContext :270).

Every rank holds the whole state (positions, velocities, the NH chains on
the host); the force pass's expensive work is split over the ranks of
one mesh axis and merged by all-reduce:

  * the direct-space sweep: each rank sums the stencils of its x-slab of
    cells, a contiguous range of the x-major cell indices (the grid's x
    must divide by the ranks: nb_options {"grid_x_multiple": ranks}), on
    kernel B1 with a home-slab range in float32 (ops/sweep.py; its plain
    version on the CPU and in float64).
    Reactions land in any cell and the slot forces are all-reduced.  The
    JAX engine runs XLA block math here and neither Pallas kernel
    (:64-142 there); the port launches B1 on every config b1_takes
    accepts, never the chunked B2, which has no slab form.  On the dense
    strategy (a replica ensemble's atom sub-group, parallel/ensemble.py)
    each rank sums its rows of each replica's pair block;
  * PME: each rank spreads a chunk of the atoms (by index) into the int64
    fixed-point grid (forces/pme.py::spread_fixed); the int64 grids are
    all-reduced before conversion, so the grid is the one-rank grid bit
    for bit whatever the rank count.  The FFT and the potential grid are
    computed on every rank (or over the ranks: distributed_fft,
    parallel/distfft.py), and each rank interpolates its chunk's forces
    analytically, which join the sweep's in the all-reduce;
  * everything else (exceptions, exclusion corrections, NBFIX, the
    self term and the dispersion tail, Drude springs and Thole pairs,
    bonded, CMAP and custom terms, the virtual-site spread) is O(N) and
    computed whole on every rank after the reduction, by the Context's
    own force pass: the sharded sums take the place of its `_pair_sum`
    (app/context.py::PairSum) and nothing else.  The JAX engine
    divides these by the device count so that its psum is exact
    (sharded.py:218 there); here they are simply not reduced.

The all-reduce gives every rank the same bits (each reduced block is
summed once and sent to all), so the ranks' host chains and states stay
bit-identical: tests/test_torch_sharded.py checks it.  Trajectories match
the one-rank Context's to the order of the force sums.
"""

from __future__ import annotations

import torch

from ..forces import cellpair, pme
from ..ops import scatter
from . import comm, distfft


def _span(n_items: int, n: int, d: int) -> tuple:
    """Rank d's contiguous share [lo, hi) of n_items over n ranks."""
    m = -(-n_items // n)
    return min(d * m, n_items), min((d + 1) * m, n_items)


def make_slab_sweep(mesh, axis: str = "atom"):
    """sweep(term, positions, box, neighbors, exact=None, rep_scale=None,
    with_energy=False) -> this rank's share of the direct-space sum of a
    compiled NonbondedForce `term`, before the all-reduce: its forces
    (N, 3) or its energy.  The share is the rank's x-slab of the x-major
    cells (n_cells / ranks), summed by B1 with a home-slab range in
    float32, or on the
    dense strategy its rows of each replica's pair block (the JAX
    make_slab_sweep, :64 there, sums its slab in XLA)."""
    n = mesh.size(axis)
    d = mesh.index(axis)

    def sweep(term, positions, box, neighbors, exact=None, rep_scale=None,
              with_energy=False):
        if term.strategy == "cellpair":
            share = {"cells": _span(term.cfg.n_cells, n, d)}
        else:
            share = {"row_range": _span(term.n_atoms // term.n_replicas,
                                        n, d)}
        fn = term.sweep_energy if with_energy else term.sweep_forces
        return fn(positions, box, neighbors, exact, rep_scale=rep_scale,
                  **share)

    return sweep


def reduced_reciprocal(mesh, axis: str, setup, q, p, ex, box_t,
                       charge_bound: float, with_forces: bool,
                       dfft: bool = False, n_replicas: int = 1, rep=None,
                       s=None, eterm=None, inv_s=None):
    """(energy, forces on these atoms (n, 3) or None) of the PME
    reciprocal sum over the atoms of every rank along `mesh[axis]`: each
    rank spreads its atoms (charges q, stored positions p, their float64
    form ex or None) into the int64 fixed-point grid of `charge_bound`
    (forces/pme.py::spread_fixed); the grids are all-reduced before
    conversion, so the grid is the one-rank grid bit for bit whatever
    the rank count (with dfft reduce-scattered into x-slabs for the
    distributed FFT, parallel/distfft.py).  Every rank gets the energy;
    the forces are interpolated at this rank's atoms.  n_replicas, rep,
    s, eterm, inv_s: a flattened ensemble's replicas, each atom's
    replica, the per-replica scales, their eterm and each atom's
    inverse scale (None for one system)."""
    R = n_replicas
    idx, wts, dwts = pme._taps(setup, p, box_t, ex, derivs=with_forces)
    acc, shift = pme.spread_fixed(setup, q, idx, wts, charge_bound, R, rep)
    if dfft:
        K1 = setup.grid[0]
        n = mesh.size(axis)
        acc = comm.reduce_scatter(mesh, axis, acc.reshape(K1, -1))
        Q = scatter.from_fixed_point(acc, shift, p.dtype).reshape(
            (K1 // n,) + tuple(setup.grid[1:]))
        e, phi = distfft.energy_and_potential(setup, Q, box_t, mesh, axis,
                                              with_forces)
        if with_forces:
            phi = comm.all_gather(mesh, axis, phi)
    else:
        acc = comm.all_reduce_sum(mesh, axis, acc)
        Q = scatter.from_fixed_point(acc, shift, p.dtype).reshape(
            pme._grid_shape(setup, R))
        if with_forces:
            e, phi = pme.grid_energy_and_potential(setup, Q, box_t, eterm,
                                                   s)
        else:
            if eterm is None:
                eterm = pme._eterm(setup, box_t, Q.dtype, Q.device)
            e = pme._grid_energy(setup, torch.fft.rfftn(
                Q, dim=pme._FFT_DIMS), eterm, box_t, s)[0]
        e = e if R == 1 else torch.sum(e)
    if not with_forces:
        return e, None
    return e, pme.interpolate_forces(setup, q, p, box_t, idx, wts, dwts,
                                     phi, R, inv_s, rep)


class ShardedForcePass:
    """A Context's nonbonded pair and reciprocal sums split over the ranks
    of `mesh[axis]`: the counterpart of app/context.py::PairSum that
    shard_context installs as the Context's `_pair_sum` (every other term
    of the force pass is the Context's own, computed whole on each rank).
    It reads the Context's compiled term at every call, so that a
    recompile (capacity growth, a replan) is followed; `check` refuses a
    config the ranks cannot split.  forces / potential / energy_and_forces
    give the Context's whole pass with these sums without installing
    them.  strategies: the pair strategies taken ("cellpair", and "dense"
    for a replica ensemble's rows)."""

    def __init__(self, context, mesh, axis: str = "atom",
                 distributed_fft: bool = False,
                 strategies=("cellpair",)):
        self.ctx = context
        self.mesh = mesh
        self.axis = axis
        self.dfft = bool(distributed_fft)
        self.strategies = tuple(strategies)
        self._slab = make_slab_sweep(mesh, axis)
        self._checked = None
        self.check()

    @property
    def ranks(self) -> int:
        return self.mesh.size(self.axis)

    def check(self) -> None:
        """The JAX module's refusals, on the Context's current compile:
        the strategy, a cell grid whose x and cell count divide into the
        ranks (x-slabs), and for the distributed FFT a PME grid whose x
        and y divide."""
        nb = self.ctx._nb
        if nb is self._checked:
            return
        n = self.ranks
        if nb is None or nb.strategy not in self.strategies:
            raise ValueError(
                "the sharded step requires the cellpair strategy "
                "(Context(..., strategy='cellpair'))"
                if self.strategies == ("cellpair",) else
                f"the sharded force pass takes the strategies "
                f"{self.strategies}")
        if nb.strategy == "cellpair" and (nb.cfg.n_cells % n
                                          or nb.cfg.grid[0] % n):
            raise ValueError(
                f"cell grid {nb.cfg.grid}: its x and its {nb.cfg.n_cells} "
                f"cells do not divide into {n} ranks "
                f"(nb_options={{'grid_x_multiple': {n}}} rounds the grid's "
                f"x to a multiple)")
        if self.dfft:
            if nb.pme is None:
                raise ValueError("distributed_fft requires PME")
            if not distfft.shardable(nb.pme.grid, n):
                raise ValueError(
                    f"PME grid {nb.pme.grid} not divisible by {n} ranks in "
                    f"x and y")
            if nb.n_replicas > 1 or self.ctx._triclinic:
                raise ValueError("distributed_fft takes one orthorhombic "
                                 "system")
        self._checked = nb

    def _reduce(self, t):
        return comm.all_reduce_sum(self.mesh, self.axis, t)

    def _pme(self, nb, pos, box_t, exact, s, with_forces):
        """(energy, this rank's chunk's forces (hi - lo, 3) or None, (lo,
        hi)) of the reciprocal sum from the reduced int64 grid."""
        N = pos.shape[0]
        R = nb.n_replicas
        lo, hi = _span(N, self.ranks, self.mesh.index(self.axis))
        p_all, e_all = pme._stored(pos, exact, s)
        rep = (None if R == 1 else
               torch.arange(lo, hi, device=pos.device) // (N // R))
        inv_s = (None if s is None else 1.0 / cellpair.atom_scales(
            s.to(pos.device), N)[lo:hi])
        eterm = None if s is None else nb._eterm(box_t, s, pos.dtype)
        e, f = reduced_reciprocal(
            self.mesh, self.axis, nb.pme, nb.params["charge"][lo:hi],
            p_all[lo:hi], None if e_all is None else e_all[lo:hi], box_t,
            nb.charge_bound, with_forces, self.dfft, R, rep, s, eterm,
            inv_s)
        return e, f, (lo, hi)

    def pair_forces(self, nb, pos, box_t, neighbors, exact, s):
        """The sweep's and the reciprocal sum's forces (N, 3), the same
        bits on every rank: this rank's slab of the sweep and its chunk's
        PME forces, all-reduced (app/context.py::PairSum's sharded
        counterpart)."""
        self.check()
        f = self._slab(nb, pos, box_t, neighbors, exact, s)
        if nb.pme is not None:
            _, f_pme, (lo, hi) = self._pme(nb, pos, box_t, exact, s, True)
            f[lo:hi] += f_pme
        return self._reduce(f)

    def pair_energy(self, nb, pos, box_t, neighbors, exact, s):
        """Their energy (float64): the slabs' sweep energies all-reduced,
        plus the PME energy of the reduced grid."""
        self.check()
        e = self._reduce(self._slab(nb, pos, box_t, neighbors, exact, s,
                                    with_energy=True).double())
        if nb.pme is not None:
            e = e + self._pme(nb, pos, box_t, exact, s, False)[0].double()
        return e

    def forces(self, positions, box, neighbors, pos_err, rep_scale=None):
        """The total force (N, 3): the Context's force pass with these
        pair sums, whatever its own `_pair_sum`."""
        return self.ctx._forces_only(positions, box, neighbors, pos_err,
                                     rep_scale, pair_sum=self)

    def potential(self, positions, box, neighbors, pos_err, rep_scale=None):
        """The total potential energy (float64, 0-d), as forces."""
        return self.ctx._potential(positions, box, neighbors, pos_err,
                                   rep_scale, pair_sum=self)

    def energy_and_forces(self, positions, box, neighbors=None,
                          pos_err=None, rep_scale=None):
        return (self.potential(positions, box, neighbors, pos_err,
                               rep_scale),
                self.forces(positions, box, neighbors, pos_err, rep_scale))


def make_sharded_energy_and_forces(context, mesh, axis: str = "atom",
                                   distributed_fft: bool = False):
    """energy_and_forces(positions, box, neighbors, pos_err=None) -> (pe,
    forces) with the pair sum and the PME spread split over `mesh[axis]`
    and merged by all-reduce (the JAX function of the same name)."""
    return ShardedForcePass(context, mesh, axis,
                            distributed_fft).energy_and_forces


def shard_context(context, mesh, axis: str = "atom",
                  distributed_fft: bool = False,
                  strategies=("cellpair",)) -> ShardedForcePass:
    """Make `context`'s pair and reciprocal sums the sharded ones over
    `mesh[axis]` (its `_pair_sum`, which its force pass, its potential
    and the Stepper of a later recompile all read); its forces are
    recomputed."""
    fp = ShardedForcePass(context, mesh, axis, distributed_fft, strategies)
    context._pair_sum = fp
    context._forces_valid = False
    context._pe_valid = False
    context._ensure_forces()
    return fp


class ShardedContext:
    """Run a Context's simulation with its force pass work-sharded over
    the ranks of `mesh[axis]`; the state stays whole on every rank, and
    stepping is Context.step's (rebuild cadence, latches, capacity
    growth, the barostat).

        mesh = comm.Mesh(("atom",), device="cuda:0")   # on every rank
        sctx = ShardedContext(ctx, mesh)
        sctx.step(1000)

    From here on the Context's pair and reciprocal sums are the sharded
    ones (its `_pair_sum`), in every force pass and potential it makes."""

    def __init__(self, context, mesh, axis: str = "atom",
                 distributed_fft: bool = False):
        self._ctx = context
        self._mesh = mesh
        self._axis = axis
        self._pass = shard_context(context, mesh, axis, distributed_fft)

    def _ensure_fresh(self) -> None:
        """Refuse a recompile the ranks cannot split (a replan at a new
        box plans a new cell grid); the force pass reads the new terms
        itself."""
        self._pass.check()

    def step(self, steps: int) -> None:
        self._ensure_fresh()
        self._ctx.step(steps)

    @property
    def state(self):
        return self._ctx._state
