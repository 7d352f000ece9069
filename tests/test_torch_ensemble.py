"""ReplicaEnsemble of the PyTorch port (parallel/ensemble.py): the ports
of tests/test_parallel.py::test_replica_ensemble_api,
::test_replica_ensemble_dense and ::test_replica_ensemble_cellpair, in
f64 on the CPU.  Replica 2 of the ensemble against the port's own
template Context driven by the same velocities (positions to atol
1e-10, energy 1e-10); the dense ensemble against the JAX package's
ReplicaEnsemble given the same velocities (numpy inputs: the two
packages draw other random numbers), and the cell-pair and
neighbour-list ensembles' replica 2 against a standalone JAX Context of
the same strategy (its XLA route) stepped from that replica's
velocities.  The JAX package's swm4_water_box(grid_size=2) (1.8 nm,
cutoff 1.0) has no regular cell grid, which the port's cell-pair sweep
needs, so the cell-pair case runs at grid_size=4 (3.0 nm).  Also: the
replicas' isolation, stack_states / replicate_state, and a mesh that is
not a parallel/comm.py Mesh refused."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
import util
from openmm_drudenose_tpu.app import serialization as jser
from openmm_drudenose_tpu.parallel.ensemble import \
    ReplicaEnsemble as JaxEnsemble
from openmm_drudenose_tpu_torch.app import serialization as tser
from openmm_drudenose_tpu_torch.parallel import ensemble
from torch_threads import _one_thread  # noqa: F401


def _context(pkg, strategy="auto", grid_size=2):
    js, positions = util.swm4_water_box(grid_size=grid_size,
                                        add_cm_motion=False)
    system = js if pkg is dn else tser.deserialize_system(
        jser.serialize_system(js))
    integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005, 0.0005, 20, 2)
    integ.setMaxDrudeDistance(0.05)
    kw = {"device": "cpu"} if pkg is dt else {}
    ctx = pkg.Context(system, integ, precision="double", strategy=strategy,
                      **kw)
    ctx.setPositions(positions)
    ctx.applyConstraints(1e-6)
    if pkg is dt:
        ctx.setVelocitiesToTemperature(200.0, seed=0)
    else:
        ctx.setVelocities(np.asarray(_tpl_velocities(ctx)))
    ctx._ensure_forces()
    return ctx, integ


def _tpl_velocities(jctx):
    """The JAX template's velocities: the port template's draw, so both
    templates start alike."""
    n = jctx._static.n_atoms
    sigma = np.sqrt(8.314462618e-3 * 200.0
                    * np.asarray(jctx._spec.inv_mass))[:, None]
    return np.random.default_rng(0).normal(size=(n, 3)) * sigma


def _against_template(strategy, n_steps, grid_size=2):
    ctx, integ = _context(dt, strategy, grid_size)
    ens = dt.ReplicaEnsemble(ctx, n_replicas=3, seed=5)
    ens.setVelocitiesToTemperature(200.0, seed=9)
    v = ens.velocities()
    ens.step(n_steps)
    ke = ens.kinetic_energies()
    pe = ens.potential_energies()
    assert ke.shape == (3,) and pe.shape == (3,)
    assert np.all(np.isfinite(ke)) and np.all(np.isfinite(pe))
    assert not np.allclose(ens.positions()[0], ens.positions()[1])
    ctx.setVelocities(v[2])
    integ.step(n_steps)
    np.testing.assert_allclose(ens.positions()[2], ctx.getPositions(),
                               atol=1e-10)
    np.testing.assert_allclose(pe[2], ctx.getState(
        energy=True).getPotentialEnergy(), rtol=1e-10)
    return ens, v


def _against_jax_context(ens, v, strategy, n_steps, grid_size):
    """Replica 2 against a standalone JAX Context of `strategy` stepped
    from its velocities (positions to atol 1e-10)."""
    jctx, jinteg = _context(dn, strategy, grid_size)
    jctx.setVelocities(v[2])
    jinteg.step(n_steps)
    np.testing.assert_allclose(ens.positions()[2],
                               np.asarray(jctx.getPositions()), atol=1e-10)


def test_replica_ensemble_api():
    ctx, _ = _context(dt)
    ens = ensemble.ReplicaEnsemble(ctx, n_replicas=3, seed=5)
    assert ens.context._nb.strategy == "dense"
    ens.setVelocitiesToTemperature(200.0, seed=9)
    ens.step(5)
    ke = ens.kinetic_energies()
    assert ke.shape == (3,)
    assert np.all(np.isfinite(ke))
    assert not np.allclose(ens.positions()[0], ens.positions()[1])
    assert ens.group_temperatures().shape == (3, ctx._static.n_baths)
    # a mesh is a parallel/comm.py Mesh of torch.distributed ranks
    # (tests/test_torch_mesh_ensemble.py runs them)
    with pytest.raises(TypeError, match="Mesh"):
        ensemble.ReplicaEnsemble(ctx, 2, mesh=object())


def test_replica_ensemble_dense():
    """The dense ensemble (each replica's block in one batched pass):
    replica 2 against the template Context, stale energies recomputed,
    and the whole ensemble against the JAX ReplicaEnsemble from the same
    velocities."""
    ens, v = _against_template("dense", 12)
    jctx, _ = _context(dn, "dense")
    jens = JaxEnsemble(jctx, n_replicas=3, seed=5)
    jens.state = jens.state._replace(velocities=jnp.asarray(v))
    jens.step(12)
    np.testing.assert_allclose(ens.positions(), jens.positions(),
                               atol=1e-10)
    np.testing.assert_allclose(ens.potential_energies(),
                               jens.potential_energies(), rtol=1e-10)


def test_replica_ensemble_cellpair():
    """The cell-pair ensemble (the replica-band path of B1 and B2; their
    plain sweep in f64): replica 2 against the template Context and
    against a JAX cell-pair Context."""
    ens, v = _against_template("cellpair", 20, grid_size=4)
    cfg = ens.context._nb.cfg
    assert cfg.n_replicas == 3 and cfg.bands == (3, 1)
    _against_jax_context(ens, v, "cellpair", 20, 4)


def test_replica_ensemble_cell_lists():
    """The neighbour-list ensemble (lists per replica in one build):
    replica 2 against the template Context and against a JAX
    neighbour-list Context."""
    ens, v = _against_template("cell", 20)
    assert ens.context._nb.n_replicas == 3
    _against_jax_context(ens, v, "cell", 20, 2)


@pytest.mark.parametrize("strategy", ["dense", "cellpair", "cell"])
def test_replicas_isolated(strategy):
    """Moving every atom of replica 0 leaves the other replicas' forces
    unchanged, bit for bit."""
    ctx, _ = _context(dt, strategy, 4 if strategy == "cellpair" else 2)
    ens = ensemble.ReplicaEnsemble(ctx, 3)
    assert ensemble.check_isolated(ens, 0) == 0.0


def test_stack_and_replicate_states():
    ctx, _ = _context(dt)
    st = ctx._state
    rep = ensemble.replicate_state(st, 3, seed=1)
    n = st.positions.shape[0]
    assert rep.positions.shape == (3 * n, 3)
    assert torch.equal(rep.positions[n:2 * n], st.positions)
    assert rep.eta.shape == (3,) + tuple(st.eta.shape)
    assert rep.ke_sum.shape == (3,)
    stacked = ensemble.stack_states([st, st, st])
    assert torch.equal(stacked.positions, rep.positions)
    assert torch.equal(stacked.eta_dot, rep.eta_dot)
    with pytest.raises(ValueError):
        ensemble.replicate_state(rep, 2)
