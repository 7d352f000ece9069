"""A box of fewer than 2w + 1 cells in a dimension on the cell-pair
strategy: the JAX package plans such a grid (500 SWM4-NDP waters at a
1.0 nm cutoff: a 2.47 nm box, 4^3 cells of window 2, which its
scripts/validate_npt_tpu.py runs) and sweeps it with a per-pair minimum
image over every wrapped offset; the port refused the plan.  The port
now plans the same grid and capacity and sweeps the half stencil of
explicit images (offsets -w..w, o and o - g reaching one cell through
two images: forces/cellpair.py::_stencil), which kernel B1 takes as it
stands.  Held here in f64 on the CPU against the JAX package: the plan,
the energy (rtol 1e-10) and forces (1e-8 of max|F|) of the Context and
the plain versions of B1's force and energy instantiations on the plan;
the plans the port still refuses; and the halo-exchange sweep and the
resident decomposition refusing the plan (their stencils wrap offsets as
the JAX grid does).  B1 itself on this plan is held
against those plain versions on the card (chip_smoke.py phase 20 (c),
tests/test_torch_gpu.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu_torch.forces import cellpair
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from openmm_drudenose_tpu_torch.ops import sweep
from openmm_drudenose_tpu_torch.parallel import domain, resident
from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
from torch_threads import one_thread

N_MOL = 500


@pytest.fixture(scope="module")
def pair():
    jsys, pos = jbuilders.build_water_box(N_MOL)
    tsys, _ = tbuilders.build_water_box(N_MOL)
    vel = np.random.default_rng(5).normal(0.0, 0.3, pos.shape)
    out = []
    for pkg, system, kw in ((dn, jsys, {}), (dt, tsys, {"device": "cpu"})):
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        integ.setMaxDrudeDistance(0.02)
        ctx = pkg.Context(system, integ, precision="double",
                          strategy="cellpair", **kw)
        ctx.setPositions(pos)
        ctx.setVelocities(vel)
        out.append((ctx, integ))
    return out


def test_plan_matches_jax(pair):
    (jctx, _), (tctx, _) = pair
    jcfg, tcfg = jctx._cp_cfg, tctx._cp_cfg
    assert tcfg.grid == jcfg.grid == (4, 4, 4)
    assert tcfg.window == jcfg.window == (2, 2, 2)
    assert tcfg.capacity == jcfg.capacity
    assert not jcfg.regular and not tcfg.regular
    # the JAX full stencil of wrapped offsets (4^3, each ordered cell pair
    # once); the port's half stencil of images: (5^3 + 1) / 2
    assert jcfg.n_offsets == 64 and tcfg.n_offsets == 63
    offs = np.asarray(tcfg.offsets)
    assert tuple(offs[0]) == (0, 0, 0)
    assert {tuple(o) for o in offs[1:]} | {tuple(-o) for o in offs[1:]} \
        == {(a, b, c) for a in range(-2, 3) for b in range(-2, 3)
            for c in range(-2, 3)} - {(0, 0, 0)}
    # offsets 2 and -2 reach one cell: both images are in the stencil
    i = next(k for k, o in enumerate(offs) if tuple(o) == (0, 0, 2))
    j = next(k for k, o in enumerate(offs) if tuple(o) == (0, 1, -2))
    k = next(k for k, o in enumerate(offs) if tuple(o) == (0, 1, 2))
    assert np.array_equal(tcfg.nbr_map[:, j], tcfg.nbr_map[:, k])
    assert not np.array_equal(tcfg.nbr_map[:, i], tcfg.nbr_map[:, k])
    assert sweep.route(tcfg) == ("b1", None)


def test_force_pass_matches_jax(pair):
    (jctx, _), (tctx, _) = pair
    js = jctx.getState(forces=True, energy=True)
    ts = tctx.getState(forces=True, energy=True)
    np.testing.assert_allclose(ts.getPotentialEnergy(),
                               js.getPotentialEnergy(), rtol=1e-10)
    f = js.getForces()
    np.testing.assert_allclose(ts.getForces(), f, rtol=0,
                               atol=1e-8 * np.abs(f).max())


def test_kernel_plain_versions_on_the_plan(pair):
    """B1's plain force and energy versions (the A&S erfc, float32) on the
    plan's fields against the exact-erfc sweep in f64: 2e-5 of max|F| and
    1e-6 of |E|, as chip_smoke.py holds the kernel against them."""
    _, (tctx, _) = pair
    tctx._ensure_neighbors()
    nb, cfg, st = tctx._nb, tctx._cp_cfg, tctx._state
    box = torch.diagonal(st.box)
    fields = nb.fields(st.positions, box, st.neighbors)
    shifts = cellpair.offset_shifts(cfg, box)
    e64, f64 = cellpair.sweep(fields, cfg, shifts, nb.alpha, ONE_4PI_EPS0)
    f32 = {k: (v.float() if v.is_floating_point() else v)
           for k, v in fields.items()}
    args = (f32, cfg, shifts.float(), nb.alpha, ONE_4PI_EPS0)
    f = sweep.pair_forces(*args)
    e = sweep.pair_energy(*args)
    scale = float(torch.max(torch.abs(f64)))
    assert float(torch.max(torch.abs(f.double() - f64))) <= 2e-5 * scale
    assert abs(float(e) - float(e64)) <= 1e-6 * abs(float(e64))


@pytest.fixture(scope="module")
def plain_sweep(pair):
    """(plain(cfg) -> (f32 forces, f32 energy) on the plan's fields with
    the compiled term's keywords, the plan, plain(plan))."""
    _, (tctx, _) = pair
    tctx._ensure_neighbors()
    nb, cfg, st = tctx._nb, tctx._cp_cfg, tctx._state
    box = torch.diagonal(st.box)
    fields = nb.fields(st.positions, box, st.neighbors)
    kw = dict(nb.coulomb, excl_skip=nb.excl_skip)

    def plain(c):
        a = (fields, c, cellpair.offset_shifts(c, box), nb.alpha,
             ONE_4PI_EPS0)
        with one_thread():
            return (sweep.pair_forces_plain(*a, **kw),
                    float(sweep.pair_energy_plain(*a, **kw)))

    return plain, cfg, plain(cfg)


@pytest.mark.parametrize("offset", [(0, 1, -2), (0, 0, 2)])
@pytest.mark.parametrize("wrong", ["dropped", "doubled"])
def test_a_wrong_image_exceeds_the_kernel_limits(plain_sweep, offset,
                                                 wrong):
    """The limits chip_smoke.py phase 20 (c) holds B1 to against its plain
    version on this plan (2e-5 of max|F|, 1e-6 of |E|) catch a sweep that
    drops or doubles one image: an offset of 2 whose twin -2 reaches the
    same cell moves the plain forces and energy by over ten times them."""
    plain, cfg, (f0, e0) = plain_sweep
    offs = np.asarray(cfg.offsets)
    k = [tuple(o) for o in offs].index(offset)
    idx = np.delete(np.arange(len(offs)), k) if wrong == "dropped" \
        else np.append(np.arange(len(offs)), k)
    f, e = plain(dataclasses.replace(cfg, offsets=offs[idx],
                                     nbr_map=cfg.nbr_map[:, idx]))
    assert float(torch.max(torch.abs(f - f0))) \
        > 10 * 2e-5 * float(torch.max(torch.abs(f0)))
    assert abs(e - e0) > 10 * 1e-6 * abs(e0)


@pytest.mark.parametrize("box, refusal", [
    ([2.47, 2.47, 2.47], None),     # 4 cells of window 2
    ([2.2, 2.2, 2.2], None),        # 4 cells of 0.55 nm, window 2
    ([2.2, 2.2, 1.9], "under twice the cutoff"),   # two images inside
    ([1.3, 1.3, 1.3], "more than w cells"),        # 2 cells of window 2:
])                                  # an offset wraps onto its own cell
def test_plans_refused_where_images_double(box, refusal):
    if refusal is None:
        cfg = cellpair.make_config(1.0, np.array(box), 1000, [0], [1])
        assert all(g > w for g, w in zip(cfg.grid, cfg.window))
    else:
        with pytest.raises(ValueError, match=refusal):
            cellpair.make_config(1.0, np.array(box), 1000, [0], [1])


def test_triclinic_plan_still_needs_a_regular_grid():
    box = np.array([[2.47, 0, 0], [0.4, 2.47, 0], [0.2, 0.3, 2.47]])
    with pytest.raises(ValueError, match="regular grid"):
        cellpair.make_config(1.0, box, 1000, [0], [1])


class _OneRank:
    """What ResidentContext reads of a comm.Mesh before its first
    collective: its refusals come before it."""
    device, backend = torch.device("cpu"), "gloo"

    def size(self, axis):
        return 1

    def index(self, axis):
        return 0


def test_multirank_paths_refuse_the_plan(pair):
    """The halo-exchange sweep (domain.block_config) and the resident
    decomposition build their stencils by wrapping offsets onto a grid of
    fewer than 2w + 1 cells, where the sweep takes each offset as one
    explicit image (close pairs dropped, far images added): both refuse
    the plan rather than sum the wrong pairs."""
    _, (tctx, _) = pair
    cfg = tctx._cp_cfg
    with pytest.raises(ValueError, match="regular grid"):
        domain.block_config(cfg, 1, cfg.window)
    with pytest.raises(ValueError, match="regular grid"):
        resident.ResidentContext(tctx, _OneRank())
