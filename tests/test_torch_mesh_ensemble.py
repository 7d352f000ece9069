"""ReplicaEnsemble over a mesh of CPU gloo ranks (the PyTorch port's
parallel/ensemble.py, the mesh half of the JAX module), in f64 against
the JAX package: the counterparts of tests/test_parallel.py::
test_flat_ensembles_sharded_over_mesh and the replica x atom case of
::test_sharded_ensemble_runs_on_mesh.

Flat sub-ensembles (FlatReplicaEnsemble of two replicas of the 200-water
PME box at cutoff 0.55, skin 0.1; capacity 48 in the JAX package, as its
test, and 32 in the port, which the 5^3 grid's cells need: its plain
sweep's pair tiles are C^2) over a ("replica",) mesh of 2 ranks, one
sub-ensemble a rank (the JAX test runs 8 over 8 devices), FLAT_STEPS
steps:
each member against a standalone flat ensemble run from the same
velocities, the port's bit for bit and the JAX package's to 1e-10 nm
(kinetic energies 1e-10 relative).  A ("replica", "atom") mesh of 2 x 2
on the JAX test's dense swm4_water_box(grid_size=2): every replica starts
from the template's state, its force pass split over its two atom ranks
from torch_threads import _one_thread  # noqa: F401
(each replica block's rows), positions after the steps against the JAX
Context's (1e-10 nm) and the atom ranks of a group bit-identical; on
both meshes setPositions read back through positions() and boxes()
gathered.  Also state_sharding and shard_ensemble on a stand-in mesh."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import torch_ranks
import util
from openmm_drudenose_tpu.app import serialization as jser
from openmm_drudenose_tpu.io import builders
from openmm_drudenose_tpu.parallel.flatrep import FlatReplicaEnsemble
from openmm_drudenose_tpu_torch.core.state import zeros_state
from openmm_drudenose_tpu_torch.parallel import ensemble

STEPS = 4
# the flat sub-ensembles' steps: the port's plain f64 sweep takes ~2 s a
# force pass of 2 x 1,000 atoms on one CPU thread
FLAT_STEPS = 2


@pytest.fixture(scope="module")
def flat_run():
    """The 200-water PME box, each sub-ensemble's velocities, and the
    port's ranks on a ("replica",) mesh of 2 started on them (a
    future)."""
    system, positions = builders.build_water_box(
        200, method=dn.NonbondedForce.PME, cutoff=0.55)
    n = 2 * system.getNumParticles()
    rng = np.random.default_rng(9)
    inv_m = np.array([1.0 / system.getParticleMass(i) if
                      system.getParticleMass(i) > 0 else 0.0
                      for i in range(system.getNumParticles())] * 2)
    v = rng.normal(size=(2, n, 3)) * np.sqrt(8.314462618e-3 * 300.0
                                            * inv_m)[None, :, None]
    fut = torch_ranks.launch_beside(torch_ranks.flat_mesh, 2,
                                    jser.serialize_system(system),
                                    positions, v, FLAT_STEPS, 32)
    return system, positions, v, fut


def test_flat_ensembles_sharded_over_mesh(flat_run):
    system, positions, v, fut = flat_run
    n = 2 * system.getNumParticles()
    integ = dn.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005, 0.001, 20, 2,
                                   False)
    integ.setMaxDrudeDistance(0.02)
    tctx = dn.Context(system, integ, precision="double",
                      strategy="cellpair",
                      nb_options={"capacity": 48, "skin": 0.1})
    tctx.setPositions(positions)
    flat = FlatReplicaEnsemble(tctx, 2)
    flat.context.setVelocities(v[0])
    flat.step(FLAT_STEPS)
    ref_pos = np.asarray(flat.context._state.positions)
    ref_ke = np.asarray(flat.kinetic_energies())
    got = fut.result()
    for out in got:
        assert out["positions"].shape == (2, n, 3)
        assert out["ke"].shape == (2, 2)
        assert np.all(np.isfinite(out["ke"]))
        np.testing.assert_allclose(out["positions"][0], ref_pos,
                                   atol=1e-10)
        np.testing.assert_allclose(out["ke"][0], ref_ke, rtol=1e-10)
        assert not np.allclose(out["positions"][0], out["positions"][1])
        assert out["positions"].tobytes() == got[0]["positions"].tobytes()
    # the member on rank 1 against rank 0's standalone run: the same bits
    assert got[0]["standalone_last"].tobytes() == \
        got[0]["positions"][1].tobytes()


@pytest.fixture(scope="module")
def replica_atom_run():
    """The JAX test's dense system and velocities, and the port's ranks on
    a 2 x 2 ("replica", "atom") mesh started on them (a future)."""
    js, positions = util.swm4_water_box(grid_size=2, add_cm_motion=False)
    n = js.getNumParticles()
    v = np.random.default_rng(3).normal(size=(n, 3)) * 0.3
    v[4::5] = 0.0                          # the M sites (virtual)
    fut = torch_ranks.launch_beside(torch_ranks.replica_atom, 4,
                                    jser.serialize_system(js), positions, v,
                                    (2, 2), STEPS)
    return js, positions, v, fut


def test_replica_atom_mesh(replica_atom_run):
    js, positions, v, fut = replica_atom_run
    integ = dn.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005, 0.0005, 20, 2)
    integ.setMaxDrudeDistance(0.05)
    jctx = dn.Context(js, integ, precision="double")
    jctx.setPositions(positions)
    jctx.applyConstraints(1e-6)
    n = js.getNumParticles()
    jctx.setVelocities(v)
    integ.step(STEPS)
    ref = np.asarray(jctx.getPositions())
    got = fut.result()
    for rank, out in enumerate(got):
        assert out["strategy"] == "dense"
        assert out["positions"].shape == (2, n, 3)
        for r in range(2):
            np.testing.assert_allclose(out["positions"][r], ref, atol=1e-10)
        # the atom ranks of a replica group hold the same bits
        assert out["local"].tobytes() == got[rank ^ 1]["local"].tobytes()


def test_mesh_ensemble_set_positions_and_boxes(replica_atom_run, flat_run):
    """setPositions scatters each replica's rows to its ranks and
    positions() gathers them back; boxes() gathers each replica's box:
    on the replica x atom mesh (one replica a group) and on the flat
    sub-ensembles' replica mesh."""
    got = replica_atom_run[3].result()
    for out in got:
        # (the M sites are recomputed from their moved parents: equal to
        # rounding; so on both meshes)
        np.testing.assert_allclose(out["set"], out["moved"], rtol=0,
                                   atol=1e-12)
        assert out["boxes"].shape == (2, 3, 3)
        for r in range(2):
            np.testing.assert_array_equal(out["boxes"][r], out["box"])
    for out in flat_run[3].result():
        np.testing.assert_allclose(out["set"], out["moved"], rtol=0,
                                   atol=1e-12)
        assert out["boxes"].shape == (2, 2, 3, 3)
        np.testing.assert_array_equal(
            out["boxes"], np.broadcast_to(out["box"], (2, 2, 3, 3)))


class _Mesh:
    """A stand-in for a parallel/comm.py Mesh: what state_sharding and
    shard_ensemble read."""

    axis_names = ("replica", "atom")

    def size(self, axis):
        return {"replica": 2, "atom": 3}[axis]

    def index(self, axis):
        return {"replica": 1, "atom": 0}[axis]


def test_state_sharding_and_shard_ensemble():
    st = zeros_state(10, 3, 2, np.eye(3), torch.float64, torch.float64,
                     torch.device("cpu"))
    st = st.replace(positions=torch.arange(60.0).reshape(20, 3))
    ens = ensemble.replicate_state(st.replace(
        positions=torch.arange(30.0).reshape(10, 3)), 4)
    spec = ensemble.state_sharding(_Mesh(), ens)
    assert spec["positions"] == ("replica", None)
    assert spec["eta"] == ("replica",) + (None,) * (ens.eta.dim() - 1)
    assert spec["box"] == (None, None)
    piece = ensemble.shard_ensemble(_Mesh(), ens)
    np.testing.assert_array_equal(piece.positions.numpy(),
                                  ens.positions[20:].numpy())
    assert piece.eta.shape[0] == 2
    assert torch.equal(piece.box, ens.box)
    with pytest.raises(TypeError, match="Mesh"):
        ensemble.ReplicaEnsemble(None, 2, mesh=_Mesh())
