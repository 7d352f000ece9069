"""The neighbour-list strategy ("cell") of the PyTorch port: the four
cases of tests/test_neighborlist.py (energy and forces against the dense
strategy and the JAX package's "cell" Context in f64, 1e-10 / 1e-8; a
short trajectory against the dense one; the lists against a brute-force
search; the overflow flag), and what the port adds: capacity growth in
the Context after an overflow, per-replica lists that never cross
replicas, and the refusal of triclinic boxes."""

import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
import util
from openmm_drudenose_tpu.app import serialization as jser
from openmm_drudenose_tpu_torch.app import serialization as tser
from openmm_drudenose_tpu_torch.forces import neighborlist
from torch_threads import _one_thread  # noqa: F401


def _systems(grid_size=3):
    js, pos = util.swm4_water_box(grid_size=grid_size)
    return js, tser.deserialize_system(jser.serialize_system(js)), pos


def _pe_forces(pkg, system, positions, strategy, nb_options=None):
    integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005, 0.0005, 20, 2)
    kw = {"device": "cpu", "nb_options": nb_options} if pkg is dt else {}
    ctx = pkg.Context(system, integ, precision="double", strategy=strategy,
                      **kw)
    ctx.setPositions(positions)
    st = ctx.getState(forces=True, energy=True)
    return st.getPotentialEnergy(), np.asarray(st.getForces()), ctx, integ


def test_cell_matches_dense_and_jax_energy_forces():
    js, ts, positions = _systems()
    positions = positions + np.random.default_rng(5).normal(
        0, 0.005, positions.shape)
    pe_d, f_d, _, _ = _pe_forces(dt, ts, positions, "dense")
    pe_c, f_c, ctx, _ = _pe_forces(dt, ts, positions, "cell")
    assert ctx._nb.strategy == "cell"
    assert isinstance(ctx._state.neighbors, neighborlist.Neighbors)
    np.testing.assert_allclose(pe_c, pe_d, rtol=1e-10)
    np.testing.assert_allclose(f_c, f_d, rtol=1e-8, atol=1e-8)
    pe_j, f_j, _, _ = _pe_forces(dn, js, positions, "cell")
    np.testing.assert_allclose(pe_c, pe_j, rtol=1e-10)
    np.testing.assert_allclose(f_c, f_j, rtol=0,
                               atol=1e-8 * np.abs(f_j).max())


def test_cell_dynamics_match_dense():
    """50 steps from the same start on both strategies: the skin covers
    the motion between rebuilds."""
    _, ts, positions = _systems()
    results = []
    for strategy in ("dense", "cell"):
        integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005, 0.0005, 20, 2)
        integ.setMaxDrudeDistance(0.05)
        ctx = dt.Context(ts, integ, precision="double", strategy=strategy,
                         device="cpu")
        ctx.setPositions(positions)
        ctx.applyConstraints(1e-5)
        ctx.setVelocitiesToTemperature(100.0, seed=11)
        integ.step(50)
        st = ctx.getState(positions=True, energy=True)
        results.append((st.getPositions(), st.getKineticEnergy()))
        if strategy == "cell":
            assert not ctx.neighborListOverflowed
    np.testing.assert_allclose(results[1][0], results[0][0], atol=1e-8)
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=1e-7)


@pytest.mark.parametrize("n, L, cutoff", [(300, 3.0, 1.0), (900, 4.0, 0.6)],
                         ids=["all_candidates", "cell_table"])
def test_build_neighbors_bruteforce_parity(n, L, cutoff):
    rng = np.random.default_rng(2)
    pos = torch.as_tensor(rng.uniform(0, L, (n, 3)))
    box = torch.tensor([L, L, L], dtype=torch.float64)
    cfg = neighborlist.make_config(cutoff, [L, L, L], n, skin=0.1)
    nbl = neighborlist.build_neighbors(pos, box, cfg)
    assert not bool(nbl.overflow)
    idx = nbl.idx.numpy()
    p = pos.numpy()
    d = p[:, None, :] - p[None, :, :]
    d -= L * np.round(d / L)
    r2 = np.sum(d * d, axis=-1)
    want = (r2 <= cfg.r_list ** 2) & ~np.eye(n, dtype=bool)
    for i in range(n):
        got = set(idx[i][idx[i] < n].tolist())
        expect = set(np.nonzero(want[i])[0].tolist())
        assert got == expect, (i, got ^ expect)


def test_overflow_flag():
    rng = np.random.default_rng(3)
    n, L = 400, 2.0
    pos = torch.as_tensor(rng.uniform(0, L, (n, 3)))
    cfg = neighborlist.NeighborConfig(
        cutoff=0.9, skin=0.1, grid=(2, 2, 2), cell_capacity=8,
        max_neighbors=16, rebuild_interval=16)
    nbl = neighborlist.build_neighbors(pos, torch.tensor([L, L, L]), cfg)
    assert bool(nbl.overflow)


def test_context_grows_lists_after_an_overflow():
    """Lists too short for the system overflow at the first build; the
    Context grows them until they hold, and the energy is the dense
    strategy's."""
    _, ts, positions = _systems()
    pe_d, f_d, _, _ = _pe_forces(dt, ts, positions, "dense")
    pe_c, f_c, ctx, _ = _pe_forces(dt, ts, positions, "cell",
                                   {"max_neighbors": 8})
    assert ctx._nb.cfg.max_neighbors > 8
    assert not ctx.neighborListOverflowed
    np.testing.assert_allclose(pe_c, pe_d, rtol=1e-10)


def test_replica_lists_stay_inside_their_replica():
    """n_replicas = R builds each replica's lists from its own atoms: the
    lists of R copies at the same positions are replica 0's, shifted."""
    rng = np.random.default_rng(4)
    n, L, R = 200, 2.5, 3
    p0 = rng.uniform(0, L, (n, 3))
    pos = torch.as_tensor(np.concatenate([p0] * R))
    box = torch.tensor([L, L, L], dtype=torch.float64)
    cfg = neighborlist.make_config(0.7, [L, L, L], n)
    one = neighborlist.build_neighbors(pos[:n], box, cfg).idx
    ens = neighborlist.build_neighbors(pos, box, cfg, n_replicas=R).idx
    for r in range(R):
        got = ens[r * n:(r + 1) * n]
        want = torch.where(one < n, one + r * n, torch.full_like(one, R * n))
        assert torch.equal(got, want)


def test_cell_strategy_refuses_triclinic_boxes():
    _, ts, _ = _systems()
    L = np.array(ts.getDefaultPeriodicBoxVectors())[0, 0]
    ts.setDefaultPeriodicBoxVectors((L, 0, 0), (0.2 * L, L, 0),
                                    (0.1 * L, 0.15 * L, L))
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005, 0.0005, 20, 2)
    with pytest.raises(ValueError, match="triclinic"):
        dt.Context(ts, integ, precision="double", strategy="cell",
                   device="cpu")


def test_needs_rebuild_past_half_the_skin():
    rng = np.random.default_rng(6)
    L = 3.0
    pos = torch.as_tensor(rng.uniform(0, L, (200, 3)))
    box = torch.tensor([L, L, L], dtype=torch.float64)
    cfg = neighborlist.make_config(1.0, [L, L, L], 200, skin=0.1)
    nbl = neighborlist.build_neighbors(pos, box, cfg)
    moved = pos.clone()
    moved[7, 1] += 0.049
    assert not bool(neighborlist.needs_rebuild(nbl, moved, box, cfg))
    moved[7, 1] += 0.002
    assert bool(neighborlist.needs_rebuild(nbl, moved, box, cfg))
    # a wrap across the box is no motion
    wrapped = pos.clone()
    wrapped[3, 0] += L
    assert not bool(neighborlist.needs_rebuild(nbl, wrapped, box, cfg))
