"""The halo-exchange sweep of the PyTorch port (parallel/domain.py: each
rank holds its x-slab of the sorted fields, receives the next rank's
first window planes on the ring, runs the half-stencil sweep on the
block with a home-slab range and sends the halo's reactions back) on
CPU gloo ranks, in f64: tests/test_domain.py::
test_sharded_sweep_matches_local's case, the 600-water reaction-field
box at cutoff 0.55 with 0.01 nm of noise, capacity 32, on 4 ranks (the
8^3 grid in slabs of 2 planes, the window's width).  Energy and forces
against the JAX package's cell-pair sweep (cellpair.pair_energy_forces)
at 1e-10 relative and 1e-8 of max|F|, and against the port's whole-grid
sweep on the same fields; the refusals of the JAX function."""

import jax.numpy as jnp
import numpy as np
import pytest

import openmm_drudenose_tpu as dn
import torch_ranks
from openmm_drudenose_tpu.app import serialization as jser
from openmm_drudenose_tpu.forces import cellpair as jcp
from openmm_drudenose_tpu.io import builders
from openmm_drudenose_tpu.units import ONE_4PI_EPS0
from openmm_drudenose_tpu_torch.app import serialization as tser
from openmm_drudenose_tpu_torch.forces import cellpair as tcp
from openmm_drudenose_tpu_torch.parallel import domain
from torch_threads import _one_thread  # noqa: F401

RANKS = 4


def _setup():
    """tests/test_domain.py's _setup."""
    system, positions = builders.build_water_box(
        600, method=dn.NonbondedForce.CutoffPeriodic, cutoff=0.55)
    rng = np.random.default_rng(0)
    positions = positions + rng.normal(0, 0.01, positions.shape)
    nb = [f for f in system.getForces()
          if isinstance(f, dn.NonbondedForce)][0]
    fn, params = nb.compile(system, jnp.float64, strategy="cellpair",
                            nb_kwargs={"capacity": 32})
    cfg = fn.cellpair_cfg
    box = np.array(system.getDefaultPeriodicBoxVectors())
    box_diag = jnp.asarray(np.diagonal(box))
    cs = jcp.build_cellsort(jnp.asarray(positions), box_diag, cfg)
    assert not bool(cs.overflow)
    peg = jcp.make_pair_eg("rf", cfg.cutoff,
                           krf=(1 / cfg.cutoff**3) * (78.3 - 1)
                           / (2 * 78.3 + 1),
                           crf=(1 / cfg.cutoff) * 3 * 78.3 / (2 * 78.3 + 1))
    return system, positions, params, cfg, box_diag, cs, peg


def test_sharded_sweep_matches_local():
    system, positions, params, cfg, box_diag, cs, peg = _setup()
    fut = torch_ranks.launch_beside(torch_ranks.domain_sweep, RANKS,
                                    jser.serialize_system(system),
                                    positions, 32)
    e_ref, f_ref = jcp.pair_energy_forces(
        params, jnp.asarray(positions), box_diag, cs, cfg, peg, ONE_4PI_EPS0)
    e_ref, f_ref = float(e_ref), np.asarray(f_ref)
    scale = np.abs(f_ref).max()
    for out in fut.result():
        assert out["grid"][0] % RANKS == 0
        np.testing.assert_allclose(out["e"], e_ref, rtol=1e-10)
        np.testing.assert_allclose(out["f"], f_ref, atol=1e-8 * scale)
        np.testing.assert_allclose(out["e"], out["e_whole"], rtol=1e-12)
        np.testing.assert_allclose(out["f"], out["f_whole"],
                                   atol=1e-12 * scale)


def test_sharded_sweep_with_the_resident_stencil():
    """The resident engine's own sweep over 2 ranks (slabs of 4 planes;
    parallel/resident.py::resident_sweep: the untrimmed half stencil of
    window (w + 2, w_y, w_z), 113 offsets, a 4-plane halo): the
    whole-grid sweep's energy and forces to summation order.  The 8-plane
    grid reaches some cell pairs from both sides across x; the second
    image lies a box length (2.6 nm) away, past the cutoff."""
    system, positions, *_ = _setup()
    got = torch_ranks.launch(torch_ranks.domain_sweep, 2,
                             jser.serialize_system(system), positions, 32,
                             True)
    for out in got:
        scale = np.abs(out["f_whole"]).max()
        np.testing.assert_allclose(out["e"], out["e_whole"], rtol=1e-12)
        np.testing.assert_allclose(out["f"], out["f_whole"],
                                   atol=1e-12 * scale)


def test_block_config_refusals():
    """A grid x that does not divide into the ranks, a slab narrower than
    the halo; and the block's maps: home cells never leave the block,
    reverse entries that would point at a halo cell."""
    js, _ = builders.build_water_box(
        600, method=dn.NonbondedForce.CutoffPeriodic, cutoff=0.55)
    system = tser.deserialize_system(jser.serialize_system(js))
    box = np.diagonal(np.array(system.getDefaultPeriodicBoxVectors()))
    cfg = tcp.make_config(0.55, box, system.getNumParticles(), [0], [1],
                          capacity=32)                    # 8^3, window 2
    with pytest.raises(ValueError, match="not divisible by 3"):
        domain.block_config(cfg, 3, cfg.window)
    with pytest.raises(ValueError, match="smaller than halo"):
        domain.block_config(cfg, 8, cfg.window)
    b = domain.block_config(cfg, 4, cfg.window)
    n_loc = 2 * 64
    assert b.grid == (4, 8, 8)
    assert b.nbr_map[:n_loc].max() < b.n_cells
    outside = (tcp.cell_coords(b.grid)[:n_loc, 0][:, None]
               - cfg.offsets[None, :, 0]) < 0
    assert np.all(b.rev_map[:n_loc][outside] >= n_loc)
    assert np.all(b.rev_map[:n_loc][~outside] < n_loc)
