"""PME of the PyTorch port against the JAX package's forces/pme.py in
f64: the same alpha and grid plan, the reciprocal energy to 1e-10 and the
analytic reciprocal forces to 1e-8 relative (JAX: autodiff of its
energy, with its analytic-JVP B-splines), including atoms exactly on grid
knots."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_drudenose_tpu.forces import pme as jpme
from openmm_drudenose_tpu_torch.forces import pme as tpme
from torch_threads import _one_thread  # noqa: F401


def test_setup_matches_jax():
    box = np.array([3.1, 3.1, 3.1])
    for cell_grid in (None, (5, 5, 5)):
        j = jpme.setup_pme(1.0, 5e-4, box, cell_grid=cell_grid)
        t = tpme.setup_pme(1.0, 5e-4, box, cell_grid=cell_grid)
        assert t.grid == j.grid and t.alpha == j.alpha
        for a in ("bm2x", "bm2y", "bm2z"):
            np.testing.assert_array_equal(getattr(t, a), getattr(j, a))


@pytest.mark.parametrize("on_knots", [False, True])
def test_recip_energy_forces_match_jax(on_knots):
    box = np.array([2.0, 2.2, 2.4])
    setup_j = jpme.setup_pme(0.9, 5e-4, box)
    setup_t = tpme.setup_pme(0.9, 5e-4, box)
    rng = np.random.default_rng(3)
    n = 60
    pos = rng.uniform(-0.5, 1.5, (n, 3)) * box
    if on_knots:
        K = np.array(setup_j.grid)
        pos[: n // 2] = (rng.integers(0, K, (n // 2, 3)) / K) * box
    q = rng.normal(size=n)
    q -= q.mean()
    E = lambda p: setup_j.reciprocal_energy(jnp.asarray(q), p,
                                            jnp.asarray(box))
    e_ref = float(E(jnp.asarray(pos)))
    f_ref = -np.asarray(jax.grad(E)(jnp.asarray(pos)))
    e, f = tpme.recip_energy_forces(setup_t, torch.as_tensor(q),
                                    torch.as_tensor(pos),
                                    torch.as_tensor(box))
    e_only = tpme.reciprocal_energy(setup_t, torch.as_tensor(q),
                                    torch.as_tensor(pos),
                                    torch.as_tensor(box))
    np.testing.assert_allclose(float(e), e_ref, rtol=1e-10)
    np.testing.assert_allclose(float(e_only), e_ref, rtol=1e-10)
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())


def test_recip_after_drift_matches_jax_generic():
    """Reciprocal forces after an atom drifted 1.5 grid points toward lower
    x since the cell sort: the port (generic spread) matches the JAX
    generic spread to 1e-8 x max|f|.  The JAX packed pencil spread, which
    keeps one grid point of margin on that side, misses the atom's outer
    taps here (ROADMAP.md, Queue C); the last assertion records that
    fault, so it fails once the JAX package no longer has it."""
    import openmm_drudenose_tpu as dn
    from openmm_drudenose_tpu.constraints.vsites import apply_vsites
    from openmm_drudenose_tpu.io import builders as jbuilders

    system, pos = jbuilders.build_water_box(216, cutoff=0.6)
    integ = dn.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    ctx = dn.Context(system, integ, precision="double", strategy="cellpair")
    ctx.setPositions(pos)
    ctx._ensure_neighbors()
    nb_fn, params = next(t for t in ctx._terms
                         if hasattr(t[0], "cellpair_cfg"))
    setup = nb_fn.pme_setup
    assert setup.cell_grid is not None           # the pencil spread is on
    box = np.diagonal(np.asarray(ctx._state.box))
    K = setup.grid[0]
    ppc = K // setup.cell_grid[0]
    # an H atom near the low-x face of its cell's first grid point column
    u = pos[:, 0] / box[0] * K
    h_atoms = np.nonzero(np.arange(len(pos)) % 5 == 2)[0]
    a = h_atoms[np.argmin((u[h_atoms] % ppc))]
    moved = pos.copy()
    moved[a, 0] -= 1.5 * box[0] / K
    pc = apply_vsites(ctx._spec, ctx._static, jnp.asarray(moved))
    bx = jnp.asarray(box)
    q = params["charge"]
    f_gen = -np.asarray(jax.grad(
        lambda p: setup.reciprocal_energy(q, p, bx))(pc))
    f_pen = np.asarray(nb_fn.recip_forces(params, pc, bx,
                                          ctx._state.neighbors))
    _, f_port = tpme.recip_energy_forces(
        tpme.setup_pme(0.6, 5e-4, box, cell_grid=setup.cell_grid),
        torch.as_tensor(np.asarray(q)), torch.as_tensor(np.asarray(pc)),
        torch.as_tensor(box))
    scale = np.abs(f_gen).max()
    np.testing.assert_allclose(f_port.numpy(), f_gen, rtol=0,
                               atol=1e-8 * scale)
    assert np.abs(f_pen - f_gen).max() > 1e-3 * scale
