"""Card-only checks of the PyTorch port: kernels B1 and B2 against their
plain versions on CUDA tensors, also with exclusion masks of three words
and at capacity 160; B2's bit-identical repeat launches; the limits read from the card and the
routing by them; their refusals, and the Context stepping through each.  Marked `gpu`; each
test skips (through the `cuda` fixture) where no CUDA card is present.
On the card (tests/conftest.py imports JAX, which the machine with the
card lacks): python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu_torch.forces import cellpair
from openmm_drudenose_tpu_torch.io import builders
from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ctx(device, precision="single", nb_options=None, exception=None):
    system, pos = builders.build_water_box(216, cutoff=0.6)
    if exception is not None:
        nonbonded = next(f for f in system.getForces()
                         if type(f).__name__ == "NonbondedForce")
        nonbonded.addException(*exception, 0.0, 1.0, 0.0)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision=precision, device=device,
                     nb_options=nb_options)
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, seed=1)
    ctx._ensure_neighbors()
    return ctx, integ


def _fields(ctx):
    st, nb = ctx._state, ctx._nb
    box = torch.diagonal(st.box)
    return (nb.fields(st.positions, box, st.neighbors), nb.cfg,
            cellpair.offset_shifts(nb.cfg, box), nb.alpha, ONE_4PI_EPS0)


def test_kernel_matches_plain_on_card(cuda):
    ctx, _ = _ctx(cuda)
    args = _fields(ctx)
    f_k = sweep.pair_forces(*args)
    torch.cuda.synchronize()
    f_p = sweep.pair_forces_plain(*args)
    scale = float(torch.max(torch.abs(f_p)))
    assert float(torch.max(torch.abs(f_k - f_p))) <= 2e-5 * scale


def test_kernel_refuses_float64(cuda):
    ctx, _ = _ctx(cuda)
    fields, cfg, shifts, alpha, scale = _fields(ctx)
    f64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in fields.items()}
    with pytest.raises(ValueError):
        sweep.pair_forces(f64, cfg, shifts.double(), alpha, scale)


def test_context_steps_through_kernel(cuda):
    ctx, integ = _ctx(cuda)
    before = sweep.launches["b1_sweep"]
    integ.step(20)
    torch.cuda.synchronize()
    assert sweep.launches["b1_sweep"] - before >= 20
    st = ctx.getState(positions=True, energy=True)
    assert np.all(np.isfinite(st.getPositions()))
    assert np.isfinite(st.getPotentialEnergy())


def test_b2_matches_plain_on_card(cuda):
    ctx, _ = _ctx(cuda)
    args = _fields(ctx)
    f_k = sweep_chunked.pair_forces(*args)
    torch.cuda.synchronize()
    f_p = sweep_chunked.pair_forces_plain(*args)
    scale = float(torch.max(torch.abs(f_p)))
    assert float(torch.max(torch.abs(f_k - f_p))) <= 2e-5 * scale
    f_b1 = sweep.pair_forces(*args)
    assert float(torch.max(torch.abs(f_k - f_b1))) <= 2e-5 * scale


def test_b2_launches_are_bit_identical(cuda):
    ctx, _ = _ctx(cuda)
    args = _fields(ctx)
    first = sweep_chunked.pair_forces(*args)
    for _ in range(3):
        assert torch.equal(sweep_chunked.pair_forces(*args), first)


def test_b2_refuses_float64(cuda):
    ctx, _ = _ctx(cuda)
    fields, cfg, shifts, alpha, scale = _fields(ctx)
    f64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in fields.items()}
    with pytest.raises(ValueError):
        sweep_chunked.pair_forces(f64, cfg, shifts.double(), alpha, scale)


def test_context_steps_through_b2(cuda):
    ctx, integ = _ctx(cuda, nb_options={"use_pallas": 3})
    assert ctx._nb.sweep_kernel == "b2"
    before = dict(sweep.launches)
    integ.step(20)
    torch.cuda.synchronize()
    assert sweep.launches["b2_sweep"] - before["b2_sweep"] >= 20
    assert sweep.launches["b1_sweep"] == before["b1_sweep"]
    st = ctx.getState(positions=True, energy=True)
    assert np.all(np.isfinite(st.getPositions()))
    assert np.isfinite(st.getPotentialEnergy())


def _held_to_plain(args):
    f_p = sweep.pair_forces_plain(*args)
    scale = float(torch.max(torch.abs(f_p)))
    for kernel in (sweep, sweep_chunked):
        f_k = kernel.pair_forces(*args)
        torch.cuda.synchronize()
        assert float(torch.max(torch.abs(f_k - f_p))) <= 2e-5 * scale


def test_kernels_take_three_exclusion_words(cuda):
    """An exclusion over 40 atom indices: W = 40, three mask words, every
    intramolecular exclusion in word 1."""
    ctx, _ = _ctx(cuda, exception=(0, 40))
    assert ctx._cp_cfg.excl_words == 3
    assert ctx._nb.sweep_kernel in ("b1", "b2")
    _held_to_plain(_fields(ctx))


def test_kernels_take_capacity_160(cuda):
    ctx, _ = _ctx(cuda, nb_options={"capacity": 160})
    assert ctx._cp_cfg.capacity == 160
    assert ctx._nb.sweep_kernel in ("b1", "b2")
    _held_to_plain(_fields(ctx))


def test_limits_read_from_the_card(cuda):
    for kernel in (sweep, sweep_chunked):
        a = kernel.attributes()
        assert 0 < a["regs"] <= 255 and a["local_bytes"] >= 0
    lim = sweep_chunked.card_limits(cuda)
    assert lim.max_threads >= 256 and lim.smem_block >= 48 * 1024
    assert lim.regs == sweep_chunked.attributes()["regs"]
    ctx, _ = _ctx(cuda)
    cfg = ctx._cp_cfg
    brick = sweep_chunked.choose_brick(cfg, lim)
    assert sweep_chunked.resident_ctas(brick, cfg.capacity, lim) >= 1


def test_route_on_card_limits(cuda):
    import dataclasses
    ctx, _ = _ctx(cuda)
    lim = sweep_chunked.card_limits(cuda)
    for C in (160, 512):
        cfg = dataclasses.replace(ctx._cp_cfg, capacity=C)
        assert sweep_chunked.b2_takes(cfg, lim)
        assert sweep.route(cfg, limits=lim)[0] == "b1"
        assert sweep.route(cfg, use_pallas=3, limits=lim)[0] == "b2"
