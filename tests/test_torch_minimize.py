"""Context.minimizeEnergy of the PyTorch port (FIRE, the JAX package's
app/context.py:740-826) against the JAX package on the CPU in f64: 20
iterations on a small NaCl solution (positions 1e-8 nm), with a hard
wall small enough that the Drude clamp to 0.99 of the wall acts, and the
constraints projected afterwards; and, on the cell-pair strategy, the
port's fresh cell sort each time an atom has moved more than half the
skin since the last one (the JAX loop keeps its first sort, ROADMAP.md
Queue C)."""

import numpy as np
import pytest

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from torch_threads import _one_thread  # noqa: F401

WALL = 0.002


@pytest.fixture(scope="module")
def minimized():
    out = []
    for pkg, b, kw in ((dn, jbuilders, {}), (dt, tbuilders,
                                            {"device": "cpu"})):
        system, pos = b.build_nacl_water_box(60, 2, 2, cutoff=0.6)
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        integ.setMaxDrudeDistance(WALL)
        ctx = pkg.Context(system, integ, precision="double", **kw)
        ctx.setPositions(pos)
        pe0 = ctx.getState(energy=True).getPotentialEnergy()
        ctx.minimizeEnergy(maxIterations=20)
        out.append((ctx, pe0, pos))
    return out


def test_fire_matches_jax(minimized):
    (jctx, _, _), (tctx, tpe0, pos) = minimized
    jp = np.asarray(jctx._state.positions)
    tp = tctx.getState(positions=True).getPositions()
    assert np.abs(tp - pos).max() > 1e-2          # it moved
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-8)
    assert tctx.getState(energy=True).getPotentialEnergy() < tpe0


def test_drude_clamp_and_constraints_after(minimized):
    """The Drudes that ended past 0.99 of the wall sit on it; the
    constraints hold to the integrator's tolerance (1e-5)."""
    _, (tctx, _, _) = minimized
    spec = tctx._spec
    p = tctx.getState(positions=True).getPositions()
    drude = np.nonzero((spec.is_pair & ~spec.is_parent).numpy())[0]
    d = np.linalg.norm(p[drude] - p[spec.partner.numpy()[drude]], axis=1)
    assert d.max() <= 0.99 * WALL * (1 + 1e-12)
    assert np.sum(np.abs(d - 0.99 * WALL) < 1e-12) >= 10
    system = tctx.getSystem()
    for c in range(system.getNumConstraints()):
        i, j, dist = system.getConstraintParameters(c)
        assert abs(np.linalg.norm(p[i] - p[j]) - dist) < 1e-5 * dist


def test_fire_sorts_again_past_half_skin():
    """Two overlapping waters on the cell-pair strategy push apart by more
    than half the 0.1 nm skin in 40 iterations: the port sorts the cells
    again on the way (the JAX loop keeps its first sort, which then no
    longer covers every pair inside the cutoff)."""
    # 64 waters, 5^3 cells: the smallest regular cell grid
    system, pos = tbuilders.build_water_box(64, cutoff=0.35)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision="double", strategy="cellpair",
                     device="cpu")
    p = pos.copy()
    p[0:5] += (p[5] - p[0]) * 0.55          # molecule 0 onto molecule 1
    ctx.setPositions(p)
    ctx.minimizeEnergy(maxIterations=40)
    start = np.linalg.norm(ctx._state.positions.numpy() - p, axis=1)
    assert start.max() > 0.5 * ctx._cp_cfg.skin
    assert ctx._minimize_sorts >= 2
    st = ctx.getState(energy=True)
    assert np.isfinite(st.getPotentialEnergy())
