"""Exclusion masks of several words and large cell capacities in the
PyTorch port's sweep, on the CPU: the whole force pass and potential
energy against the JAX package in f64 with an exclusion over 40 atom
indices (W = 40, three 31-bit words; energy 1e-10 relative, forces 1e-8
x max|f|), kernel B1's and B2's plain versions against the JAX sweep with
the same A&S erfc (f64, 1e-8 x max|f|), the word and bit that the plain
sweep reads at the word boundaries, the routing of configs and what each
kernel takes (capacity, words; B2's shared memory and int32 indices
refused), and B2's brick from a given register count and capacity."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.forces import cellpair as jcp
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu_torch.forces import cellpair as tcp
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
from torch_threads import _one_thread  # noqa: F401

N_MOL, CUTOFF = 216, 0.6


def _contexts(precision, exception=(0, 40)):
    """The JAX and the port's Context on the 216-molecule box with one
    more exclusion, between atoms `exception`."""
    out = []
    for pkg, build, kw in ((dn, jbuilders, {"strategy": "cellpair"}),
                           (dt, tbuilders, {"device": "cpu",
                                              "strategy": "cellpair"})):
        system, pos = build.build_water_box(N_MOL, cutoff=CUTOFF)
        nonbonded = next(f for f in system.getForces()
                         if type(f).__name__ == "NonbondedForce")
        nonbonded.addException(*exception, 0.0, 1.0, 0.0)
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        ctx = pkg.Context(system, integ, precision=precision, **kw)
        ctx.setPositions(pos)
        ctx._ensure_neighbors()
        out.append(ctx)
    return out


@pytest.fixture(scope="module")
def wide64():
    return _contexts("double")


def test_context_matches_jax_f64_three_words(wide64):
    jctx, tctx = wide64
    assert tctx._cp_cfg.excl_window == jctx._cp_cfg.excl_window == 40
    assert tctx._cp_cfg.excl_words == 3
    js = jctx.getState(energy=True, forces=True)
    ts = tctx.getState(energy=True, forces=True)
    np.testing.assert_allclose(ts.getPotentialEnergy(),
                               js.getPotentialEnergy(), rtol=1e-10)
    f_ref = np.asarray(js.getForces())
    np.testing.assert_allclose(np.asarray(ts.getForces()), f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())


@pytest.mark.parametrize("version", ["b1", "b2"])
def test_plain_versions_match_jax_f64_three_words(wide64, version):
    """B1's and B2's plain versions (A&S erfc, exclusion test at every
    offset) against the JAX sweep given the same erfc, at drifted
    positions; the energy of the same sum beside them."""
    jctx, tctx = wide64
    nb_fn, nb_params = next(t for t in jctx._terms
                            if hasattr(t[0], "cellpair_cfg"))
    rng = np.random.default_rng(11)
    pos = np.asarray(tctx._state.positions, np.float64) \
        + rng.uniform(-0.03, 0.03, (tctx._state.positions.shape))
    pair_eg = jcp.make_pair_eg("ewald", CUTOFF, alpha=nb_fn.pme_setup.alpha,
                               erfc_fn=jcp.erfc_approx, excl_in_sweep=False)
    e_ref, f_ref = jcp.pair_energy_forces(
        nb_params, jnp.asarray(pos), jnp.diagonal(jctx._state.box),
        jctx._state.neighbors, jctx._cp_cfg, pair_eg, nb_fn.coulomb_scale,
        with_energy=True)
    f_ref = np.asarray(f_ref)
    nb = tctx._nb
    box = torch.diagonal(tctx._state.box)
    fields = nb.fields(torch.as_tensor(pos), box, tctx._state.neighbors)
    assert fields["ew"].shape == (nb.cfg.n_cells * nb.cfg.capacity, 3)
    args = (fields, nb.cfg, tcp.offset_shifts(nb.cfg, box), nb.alpha,
            ONE_4PI_EPS0)
    kernel = sweep if version == "b1" else sweep_chunked
    f_slots = kernel.pair_forces(*args, excl_skip=False)
    f = f_slots[tctx._state.neighbors.inv_slot].numpy()
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())
    e, _ = tcp.sweep(*args, with_energy=True, erfc_fn=tcp.erfc_approx)
    np.testing.assert_allclose(float(e), float(e_ref), rtol=1e-10)


def _pair_fields(bit, set_bit):
    """Two atoms 0.2 nm apart in cell 0 of a 10^3-cell grid with W = 40
    (three words): home atom 40, partner 40 + bit - W; the home's mask has
    bit `set_bit` set and the partner's none, so only the home's row
    force depends on the bit the sweep reads."""
    cfg = tcp.make_config(0.5, [3.0] * 3, 128, [0], [40], capacity=8)
    assert cfg.excl_window == 40 and cfg.excl_words == 3
    n_slots = cfg.n_cells * cfg.capacity
    W = cfg.excl_window
    f64 = torch.float64
    fields = {
        "x": torch.full((n_slots,), 1e6, dtype=f64),
        "y": torch.full((n_slots,), 2e6, dtype=f64),
        "z": torch.full((n_slots,), 3e6, dtype=f64),
        "q": torch.zeros(n_slots, dtype=f64),
        "sig": torch.ones(n_slots, dtype=f64),
        "seps": torch.zeros(n_slots, dtype=f64),
        "gid": -1 - torch.arange(n_slots, dtype=torch.int32),
        "ew": torch.zeros((n_slots, cfg.excl_words), dtype=torch.int32),
        "count": torch.zeros(cfg.n_cells, dtype=torch.int32),
    }
    for s, (x, gid) in enumerate(((-0.1, 40), (0.1, 40 + bit - W))):
        fields["x"][s], fields["y"][s], fields["z"][s] = x, 0.0, 0.0
        fields["q"][s], fields["sig"][s], fields["seps"][s] = 0.5, 0.3, 0.6
        fields["gid"][s] = gid
    fields["ew"][0, set_bit // 31] = 1 << (set_bit % 31)
    fields["count"][0] = 2
    box = torch.tensor([3.0] * 3, dtype=f64)
    return fields, cfg, tcp.offset_shifts(cfg, box), 3.0, ONE_4PI_EPS0


@pytest.mark.parametrize("bit", [30, 31, 62])
@pytest.mark.parametrize("version", ["b1", "b2"])
def test_plain_sweep_reads_word_and_bit_at_boundaries(bit, version):
    """dg + W = 30 is the last bit of word 0, 31 the first of word 1, 62
    the first of word 2: the set bit excludes the pair from the home's
    row force, its neighbours in the mask do not."""
    kernel = sweep if version == "b1" else sweep_chunked
    f_home = {}
    for set_bit in (bit - 1, bit, bit + 1):
        f = kernel.pair_forces(*_pair_fields(bit, set_bit))
        f_home[set_bit] = f[0].abs().max().item()
        assert f[1].abs().max().item() > 1.0    # the partner's: no bit
    assert f_home[bit] == 0.0
    assert f_home[bit - 1] > 1.0 and f_home[bit + 1] > 1.0


def _cfg(grid, capacity, W=4):
    cfg = tcp.make_config(CUTOFF, [2.0] * 3, 1000, [0], [W],
                          capacity=capacity)
    return dataclasses.replace(cfg, grid=grid)


def test_route_takes_capacity_above_128():
    # the JAX gates keep 15^3 and 30^3 at C = 160 on the full-layer kernel
    for grid in ((15, 15, 15), (30, 30, 30)):
        cfg = _cfg(grid, 160)
        assert sweep.route(cfg) == ("b1", None)
        assert sweep_chunked.b2_takes(cfg)
        assert sweep.route(cfg, use_pallas=3)[0] == "b2"


def test_route_takes_several_exclusion_words():
    for grid, want in (((15, 15, 15), "b1"), ((30, 30, 30), "b2")):
        cfg = _cfg(grid, 48, W=40)
        assert cfg.excl_words == 3
        # the JAX gates send a three-word config to XLA; the port's
        # kernels take it, routed by the layout alone
        assert sweep.route(cfg)[0] == want
        assert sweep.route(cfg)[1] == (sweep.choose_chunk(
            dataclasses.replace(cfg, excl_window=4, excl_words=1))
            if want == "b2" else None)


def test_route_refuses_b2_beyond_its_shared_memory():
    small = dataclasses.replace(sweep_chunked.H100, smem_block=8192,
                                smem_sm=16384)
    cfg = _cfg((30, 30, 30), 600)
    assert sweep_chunked.choose_brick(cfg, small) is None
    assert not sweep_chunked.b2_takes(cfg, small)
    with pytest.raises(ValueError, match="B2"):
        sweep.route(cfg, use_pallas=3, limits=small)
    assert sweep.route(cfg, use_pallas=3)[0] == "b2"


def test_route_refuses_what_b1_does_not_take():
    cfg = _cfg((400, 400, 400), 48)       # 3.1e9 slots: past int32
    assert not sweep.b1_takes(cfg) and not sweep_chunked.b2_takes(cfg)
    with pytest.raises(ValueError, match="B1"):
        sweep.route(cfg)


@pytest.mark.parametrize("capacity, fits", [(4429, True), (4430, False)])
def test_choose_brick_at_the_shared_memory_limit(capacity, fits):
    """B2's CTA of 1 x 2 x 2 warps takes 19840 + 48 C bytes of shared
    memory, which fits the H100's 232448 a CTA up to C = 4429."""
    cfg = _cfg((6, 6, 6), capacity)
    assert (sweep_chunked.smem_bytes(sweep_chunked.BRICK, capacity)
            <= sweep_chunked.H100.smem_block) == fits
    assert sweep_chunked.choose_brick(cfg) == \
        (sweep_chunked.BRICK if fits else None)
    assert sweep_chunked.b2_takes(cfg) == fits


@pytest.mark.parametrize("regs, want, ctas", [
    (None, (1, 2, 2), 10), (40, (1, 2, 2), 10), (64, (1, 2, 2), 8),
    (128, (1, 2, 2), 4), (255, (1, 2, 2), 2)])
def test_choose_brick_from_register_count(regs, want, ctas):
    """At 30^3 cells and C = 48: the more registers a thread, the fewer
    warps and CTAs an SM holds (registers go to a warp in units of 256);
    without a count, or with few registers, shared memory decides."""
    cfg = _cfg((30, 30, 30), 48)
    lim = dataclasses.replace(sweep_chunked.H100, regs=regs)
    brick = sweep_chunked.choose_brick(cfg, lim)
    assert brick == want
    assert sweep_chunked.resident_ctas(brick, 48, lim) == ctas
    if regs is not None:
        per_warp = -(-regs * 32 // 256) * 256
        assert ctas * int(np.prod(brick)) <= 65536 // per_warp
