"""Triclinic (reduced-form) periodic boxes through the PyTorch port,
against the JAX package on the CPU in f64 with seeded numpy inputs:
forces/boxutils.py (reduce, minimum image against brute force, inverse,
volume, plane widths, fractional coordinates: 1e-12); the cell-pair plan
of the sheared 100k-atom box and of a sheared 512-water box (grid,
window, offsets, trim, capacity, neighbour map: equal); the PME
reciprocal energy and forces (1e-10, 1e-8 of max|F|) and the full Ewald
sum against a brute-force triclinic Ewald sum; the plain versions of
kernels B1 and B2 on triclinic fields against the JAX TPU kernel in
interpret mode and the JAX XLA sweep (1e-8 of max|F|); the sheared
512-water Context on the cell-pair and dense strategies (PE 1e-10,
forces 1e-8 of max|F|) and 32 TGNH steps (1e-9, as
tests/test_torch_slice.py); a triclinic NPT move, then a shrink that
plans the triclinic grid again; the reaction field's analytic forces
against finite differences; the wrapped molecules of getState; and a
checkpoint of a triclinic NPT run replayed bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.forces import boxutils as jbox
from openmm_drudenose_tpu.forces import cellpair as jcp
from openmm_drudenose_tpu.forces import pme as jpme
from openmm_drudenose_tpu.integrators import barostat as jbaro
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu.ops import pallas_sweep as jps
from openmm_drudenose_tpu_torch import convert
from openmm_drudenose_tpu_torch.forces import boxutils as tbox
from openmm_drudenose_tpu_torch.forces import cellpair as tcp
from openmm_drudenose_tpu_torch.forces import pme as tpme
from openmm_drudenose_tpu_torch.integrators import barostat as tbaro
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
from torch_threads import _one_thread  # noqa: F401

# the JAX package's sheared test cell (tests/test_triclinic.py)
TRI_BOX = np.array([[2.0, 0.0, 0.0],
                    [0.7, 1.9, 0.0],
                    [-0.5, 0.6, 2.1]])
# the shear of scripts/check_triclinic_tpu.py: b = (0.2L, L, 0),
# c = (0.1L, 0.15L, L)
SHEAR = (0.2, 0.1, 0.15)


def sheared(L):
    return np.array([[L, 0, 0], [SHEAR[0] * L, L, 0],
                     [SHEAR[1] * L, SHEAR[2] * L, L]])


# -- boxutils ----------------------------------------------------------------

def test_reduce_box_matches_jax():
    skewed = TRI_BOX.copy()
    skewed[2] += 3 * skewed[1] - 2 * skewed[0]
    skewed[1] += 2 * skewed[0]
    red = tbox.reduce_box(skewed)
    np.testing.assert_allclose(red, jbox.reduce_box(skewed), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(red, TRI_BOX, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="xy plane"):
        tbox.reduce_box([[2, 0, 0], [0, 2, 0.3], [0, 0, 2]])
    assert tbox.is_triclinic(TRI_BOX) and not tbox.is_triclinic(np.eye(3))
    system = dt.System()
    system.setDefaultPeriodicBoxVectors(*skewed)
    jsys = dn.System()
    jsys.setDefaultPeriodicBoxVectors(*skewed)
    np.testing.assert_allclose(system.getDefaultPeriodicBoxVectors(),
                               jsys.getDefaultPeriodicBoxVectors(), rtol=0,
                               atol=1e-12)


def test_min_image_matches_brute_force_and_jax():
    rng = np.random.default_rng(0)
    d = rng.uniform(-6, 6, (200, 3))
    got = tbox.min_image(torch.as_tensor(d), torch.as_tensor(TRI_BOX))
    got = got.numpy()
    ref = np.asarray(jbox.min_image(jnp.asarray(d), jnp.asarray(TRI_BOX)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    shifts = np.array([(i, j, k) for i in range(-3, 4)
                       for j in range(-3, 4) for k in range(-3, 4)])
    images = d[:, None, :] + shifts[None, :, :] @ TRI_BOX
    brute = images[np.arange(len(d)),
                   np.argmin(np.linalg.norm(images, axis=2), axis=1)]
    # exact within the half-width sphere (the cutoff rule)
    near = np.linalg.norm(brute, axis=1) < min(np.diag(TRI_BOX)) / 2
    assert near.sum() > 20
    np.testing.assert_allclose(got[near], brute[near], rtol=0, atol=1e-12)
    # a diagonal box: the per-component formula
    diag = np.array([1.9, 2.1, 2.3])
    np.testing.assert_array_equal(
        tbox.min_image(torch.as_tensor(d), torch.as_tensor(diag)).numpy(),
        d - diag * np.round(d / diag))


@pytest.mark.parametrize("box", [TRI_BOX, sheared(8.4346)],
                         ids=["tri", "sheared100k"])
def test_inverse_volume_widths_frac_match_jax(box):
    t = torch.as_tensor(box)
    j = jnp.asarray(box)
    np.testing.assert_allclose(tbox.inv_box(t).numpy(), np.linalg.inv(box),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tbox.inv_box(t).numpy(),
                               np.asarray(jbox.inv_box(j)), rtol=0,
                               atol=1e-12)
    assert float(tbox.volume(t)) == pytest.approx(np.linalg.det(box),
                                                  rel=1e-12)
    np.testing.assert_allclose(tbox.plane_widths(t).numpy(),
                               np.asarray(jbox.plane_widths(j)), rtol=1e-12)
    # the plane width along d is the volume over the area of the other two
    area = [np.linalg.norm(np.cross(box[1], box[2])),
            np.linalg.norm(np.cross(box[0], box[2])),
            np.linalg.norm(np.cross(box[0], box[1]))]
    np.testing.assert_allclose(tbox.plane_widths(t).numpy(),
                               np.linalg.det(box) / np.array(area),
                               rtol=1e-12)
    p = np.random.default_rng(1).uniform(-5, 15, (50, 3))
    fr = tbox.frac_coords(torch.as_tensor(p), t).numpy()
    np.testing.assert_allclose(fr, np.asarray(jbox.frac_coords(
        jnp.asarray(p), j)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tbox.rows_combo(torch.as_tensor(fr), t).numpy(), p, rtol=0,
        atol=1e-12)


# -- the plan ----------------------------------------------------------------

def _water_system(pkg, build, n_mol, cutoff, **kw):
    system, pos = build.build_water_box(n_mol, method=pkg.NonbondedForce.PME,
                                        cutoff=cutoff, **kw)
    L = float(system.getDefaultPeriodicBoxVectors()[0][0])
    system.setDefaultPeriodicBoxVectors(*sheared(L))
    return system, pos


def test_plan_of_the_sheared_100k_box_matches_jax():
    """The plan of the JAX package's 100k-atom sheared box
    (scripts/check_triclinic_tpu.py): 15^3 cells, window 2, 63 offsets,
    no trim, C = 48, as JAX make_config gives it."""
    box = jbox.reduce_box(sheared(8.4346))
    none = np.zeros(0, np.int32)
    ref = jcp.make_config(1.0, box, 100_000, none, none)
    cfg = tcp.make_config(1.0, box, 100_000, none, none)
    assert cfg.triclinic and ref.triclinic
    assert cfg.grid == ref.grid == (15, 15, 15)
    assert cfg.window == ref.window == (2, 2, 2)
    assert cfg.n_offsets == 63 and cfg.trimmed == ref.trimmed == ()
    assert cfg.capacity == ref.capacity == 48
    np.testing.assert_array_equal(cfg.offsets, np.asarray(ref.offsets))
    nbr_flat, nbr_shape = ref.nbr_map
    np.testing.assert_array_equal(
        cfg.nbr_map, np.array(nbr_flat).reshape(nbr_shape))


@pytest.mark.parametrize("cutoff", [0.52, 0.6])
def test_plan_of_a_sheared_water_box_matches_jax(cutoff):
    out = []
    for pkg, b in ((dn, jbuilders), (dt, tbuilders)):
        system, _ = _water_system(pkg, b, 512, cutoff)
        nb = next(f for f in system.getForces()
                  if type(f).__name__ == "NonbondedForce")
        out.append((system, nb))
    (jsys, jnb), (tsys, tnb) = out
    jfn, _ = jnb.compile(jsys, jnp.float64, strategy="cellpair")
    ref = jfn.cellpair_cfg
    term = tnb.compile(tsys, torch.float64, "cpu", strategy="cellpair")
    cfg = term.cfg
    assert cfg.triclinic
    assert (cfg.grid, cfg.window, cfg.capacity, cfg.trimmed) == (
        ref.grid, ref.window, ref.capacity, ref.trimmed)
    np.testing.assert_array_equal(cfg.offsets, np.asarray(ref.offsets))
    # the PME grid keeps OpenMM's choice (no rounding to the cell grid)
    assert term.pme.grid == tuple(jfn.pme_setup.grid)


# -- PME ---------------------------------------------------------------------

def _charges(n, seed, box):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (n, 3)) @ box
    q = rng.normal(0, 0.5, n)
    return pos, q - q.mean()


def test_pme_reciprocal_matches_jax():
    """The port's analytic reciprocal forces (through the inverse box)
    against JAX autodiff of its generic triclinic spread."""
    box = 2.0 * TRI_BOX
    pos, q = _charges(60, 3, box)
    setup = tpme.setup_pme(0.9, 1e-5, np.diagonal(box))
    jset = jpme.setup_pme(0.9, 1e-5, np.diagonal(box))
    assert setup.grid == tuple(jset.grid)
    args = (tuple(jset.grid), jset.alpha, jnp.asarray(jset.bm2x),
            jnp.asarray(jset.bm2y), jnp.asarray(jset.bm2z), jnp.asarray(q))
    e_ref, g_ref = jax.value_and_grad(
        lambda p: jpme._reciprocal_energy(*args, p, jnp.asarray(box)))(
            jnp.asarray(pos))
    f_ref = -np.asarray(g_ref)
    e, f = tpme.recip_energy_forces(setup, torch.as_tensor(q),
                                    torch.as_tensor(pos),
                                    torch.as_tensor(box))
    np.testing.assert_allclose(float(e), float(e_ref), rtol=1e-10)
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())
    e_only = tpme.reciprocal_energy(setup, torch.as_tensor(q),
                                    torch.as_tensor(pos),
                                    torch.as_tensor(box))
    assert float(e_only) == float(e)


def brute_force_ewald(charges, pos, box, alpha, kmax=12):
    """The total Ewald energy of point charges in a general cell by
    direct sums: real space over the minimum image and its 26 neighbours,
    reciprocal space over |m_i| <= kmax (the oracle of
    tests/test_triclinic.py, in numpy)."""
    from scipy.special import erfc
    n = len(charges)
    inv = np.linalg.inv(box)
    images = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)], np.float64) @ box
    e_real = 0.0
    for i in range(n):
        for j in range(i + 1, n):
            d = pos[i] - pos[j]
            for k in (2, 1, 0):
                d = d - box[k] * np.round(d[k] / box[k, k])
            r = np.linalg.norm(d + images, axis=1)
            e_real += charges[i] * charges[j] * np.sum(erfc(alpha * r) / r)
    m = np.array([(a, b, c) for a in range(-kmax, kmax + 1)
                  for b in range(-kmax, kmax + 1)
                  for c in range(-kmax, kmax + 1)
                  if (a, b, c) != (0, 0, 0)], np.float64)
    mstar = m @ inv.T
    m2 = np.sum(mstar * mstar, axis=1)
    s = np.exp(2j * np.pi * (pos @ mstar.T)).T @ charges
    e_rec = np.sum(np.exp(-np.pi ** 2 * m2 / alpha ** 2) / m2
                   * np.abs(s) ** 2) / (2 * np.pi * np.linalg.det(box))
    e_self = -alpha / np.sqrt(np.pi) * np.sum(charges ** 2)
    return ONE_4PI_EPS0 * (e_real + e_rec + e_self)


def _charged_system(pkg, pos, q, box, method, cutoff, eps=0.0,
                    switch=None):
    system = pkg.System()
    nb = pkg.NonbondedForce()
    for c in q:
        system.addParticle(1.0)
        nb.addParticle(c, 0.3, eps)
    nb.setNonbondedMethod(method)
    nb.setCutoffDistance(cutoff)
    nb.setEwaldErrorTolerance(1e-6)
    if switch is not None:
        nb.setUseSwitchingFunction(True)
        nb.setSwitchingDistance(switch)
    system.addForce(nb)
    system.setDefaultPeriodicBoxVectors(*box)
    return system, nb


def _port_energy_forces(system, nb, pos, box, strategy="dense"):
    term = nb.compile(system, torch.float64, "cpu", strategy=strategy)
    p, b = torch.as_tensor(pos), torch.as_tensor(box)
    nbl = term.cellsort(p, b) if strategy == "cellpair" else None
    e = term.sweep_energy(p, b, nbl) + term.extras(p, b)[0]
    f = term.sweep_forces(p, b, nbl) + term.extras(p, b)[1]
    if term.pme is not None:
        er, fr = term.recip(p, b)
        e, f = e + er, f + fr
    return float(e), f.numpy()


def test_pme_energy_matches_brute_force_ewald():
    pos, q = _charges(12, 7, TRI_BOX)
    system, nb = _charged_system(dt, pos, q, TRI_BOX, dt.NonbondedForce.PME,
                                 0.9)
    e, _ = _port_energy_forces(system, nb, pos, TRI_BOX)
    alpha = tpme.choose_alpha(0.9, 1e-6)
    np.testing.assert_allclose(e, brute_force_ewald(q, pos, TRI_BOX, alpha),
                               rtol=2e-5, atol=2e-5)


def test_cutoff_beyond_half_width_raises():
    pos, q = _charges(12, 3, TRI_BOX)
    system, nb = _charged_system(dt, pos, q, TRI_BOX, dt.NonbondedForce.PME,
                                 1.2)
    with pytest.raises(ValueError, match="half the smallest"):
        nb.compile(system, torch.float64, "cpu")
    system, nb = _charged_system(dt, pos, q, TRI_BOX, dt.NonbondedForce.PME,
                                 0.9)
    with pytest.raises(ValueError, match="regular"):
        nb.compile(system, torch.float64, "cpu", strategy="cellpair")
    # the legacy neighbour-list strategy refuses triclinic boxes, as the
    # JAX package's does (forces/nonbonded.py:191 there)
    with pytest.raises(ValueError, match="triclinic periodic boxes are not"):
        nb.compile(system, torch.float64, "cpu", strategy="cell")


# -- the sweep kernels' plain versions ---------------------------------------

def _exception_system(pkg):
    """The sheared 220-charge system of tests/test_pallas_sweep.py::
    test_triclinic_forces_match_xla_sweep (LJ + PME, exceptions on a
    jittered lattice)."""
    rng = np.random.default_rng(23)
    box = 2.0 * TRI_BOX
    n = 220
    system = pkg.System()
    nb = pkg.NonbondedForce()
    charges = rng.normal(0, 0.4, n)
    charges -= charges.mean()
    for i in range(n):
        system.addParticle(1.0)
        nb.addParticle(charges[i], 0.25, 0.4)
    for i in range(0, 30, 3):
        nb.addException(i, i + 1, 0.1 * charges[i] * charges[i + 1],
                        0.25, 0.1)
        nb.addException(i, i + 2, 0.0, 1.0, 0.0)
    nb.setNonbondedMethod(pkg.NonbondedForce.PME)
    nb.setCutoffDistance(0.9)
    system.addForce(nb)
    system.setDefaultPeriodicBoxVectors(*box)
    m = 7
    f = (np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                  axis=-1).reshape(-1, 3) + 0.5) / m
    pos = (f[:n] + rng.normal(0, 0.04, (n, 3))) @ box
    for i in range(0, 30, 3):
        pos[i + 1] = pos[i] + np.array([0.12, 0.05, -0.04])
        pos[i + 2] = pos[i] + np.array([-0.06, 0.14, 0.08])
    return system, nb, pos, box


@pytest.fixture(scope="module")
def sweep_case():
    """The JAX and the port's cell-pair compile of the exception system
    in f64, the JAX XLA sweep's forces with the kernels' A&S erfc, and
    the port's fields."""
    jsys, jnb, pos, box = _exception_system(dn)
    fn, params = jnb.compile(jsys, jnp.float64, strategy="cellpair")
    cfg = fn.cellpair_cfg
    jpos, jbx = jnp.asarray(pos), jnp.asarray(box)
    nbl = jcp.build_cellsort(jpos, jbx, cfg)
    pair_eg = jcp.make_pair_eg("ewald", 0.9, alpha=fn.pme_setup.alpha,
                               erfc_fn=jcp.erfc_approx, excl_in_sweep=False)
    e_ref, f_ref = jcp.pair_energy_forces(params, jpos, jbx, nbl, cfg,
                                          pair_eg, fn.coulomb_scale,
                                          with_energy=True)
    tsys, tnb, _, _ = _exception_system(dt)
    term = tnb.compile(tsys, torch.float64, "cpu", strategy="cellpair")
    tpos, tbx = torch.as_tensor(pos), torch.as_tensor(box)
    tnbl = term.cellsort(tpos, tbx)
    np.testing.assert_array_equal(tnbl.slot_atom.numpy(),
                                  np.asarray(nbl.slot_atom))
    np.testing.assert_array_equal(tnbl.image.numpy(), np.asarray(nbl.image))
    assert not bool(tnbl.overflow) and not bool(tnbl.stencil_invalid)
    fields = term.fields(tpos, tbx, tnbl)
    args = (fields, term.cfg, tcp.offset_shifts(term.cfg, tbx), term.alpha,
            ONE_4PI_EPS0)
    return dict(fn=fn, params=params, cfg=cfg, nbl=nbl, jpos=jpos, jbx=jbx,
                e_ref=float(e_ref), f_ref=np.asarray(f_ref), args=args,
                inv=tnbl.inv_slot)


@pytest.mark.parametrize("version", ["b1", "b2"])
def test_plain_versions_match_jax_xla_sweep(sweep_case, version):
    c = sweep_case
    kernel = sweep if version == "b1" else sweep_chunked
    f = kernel.pair_forces(*c["args"], excl_skip=False)[c["inv"]].numpy()
    np.testing.assert_allclose(f, c["f_ref"], rtol=0,
                               atol=1e-8 * np.abs(c["f_ref"]).max())
    e, _ = tcp.sweep(*c["args"], with_energy=True, erfc_fn=tcp.erfc_approx)
    np.testing.assert_allclose(float(e), c["e_ref"], rtol=1e-10)


def test_b1_plain_matches_jax_pallas_interpret(sweep_case):
    """The TPU kernel B1 on triclinic fields (its per-offset shift pack
    from _centers_and_hvec) in interpret mode, in f64, against B1's and
    B2's plain versions."""
    c = sweep_case
    f_ref = np.asarray(jps.pair_forces_pallas(
        c["params"], c["jpos"], c["jbx"], c["nbl"], c["cfg"], "ewald",
        alpha=c["fn"].pme_setup.alpha, interpret=True))
    for kernel in (sweep, sweep_chunked):
        f = kernel.pair_forces(*c["args"])[c["inv"]].numpy()
        np.testing.assert_allclose(f, f_ref, rtol=0,
                                   atol=1e-8 * np.abs(f_ref).max())


# -- the sheared water Context -----------------------------------------------

def _water_pair(strategy, n_mol=512, cutoff=0.52, baro=None):
    jsys, pos = _water_system(dn, jbuilders, n_mol, cutoff)
    tsys, _ = _water_system(dt, tbuilders, n_mol, cutoff)
    vel = np.random.default_rng(9).normal(0.0, 0.3, pos.shape)
    out = []
    for pkg, system, kw in ((dn, jsys, {}), (dt, tsys, {"device": "cpu"})):
        if baro is not None:
            system.addForce(pkg.MonteCarloBarostat(1.01325, 300.0, baro))
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        integ.setMaxDrudeDistance(0.02)
        ctx = pkg.Context(system, integ, precision="double",
                          strategy=strategy, **kw)
        ctx.setPositions(pos)
        ctx.setVelocities(vel)
        out.append((ctx, integ))
    return out


@pytest.mark.parametrize("strategy", ["cellpair", "dense"])
def test_sheared_water_context_matches_jax(strategy):
    (jctx, _), (tctx, _) = _water_pair(strategy)
    if strategy == "cellpair":
        assert tctx._cp_cfg.triclinic and tctx._triclinic
    js = jctx.getState(forces=True, energy=True)
    ts = tctx.getState(forces=True, energy=True)
    np.testing.assert_allclose(ts.getPotentialEnergy(),
                               js.getPotentialEnergy(), rtol=1e-10)
    f_ref = np.asarray(js.getForces())
    np.testing.assert_allclose(ts.getForces(), f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())


def test_sheared_water_steps_match_jax():
    """32 steps (rebuild + 16, rebuild + 16 fused steps) from the JAX
    state, at tests/test_torch_slice.py's tolerances."""
    (jctx, jint), (tctx, tint) = _water_pair("cellpair")
    jctx._ensure_forces()
    tctx._state = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in jctx._state._asdict().items()
         if v is not None and k not in ("neighbors", "key")})
    tctx._forces_valid = True
    jint.step(32)
    tint.step(32)
    js, ts = jctx._state, tctx._state
    assert ts.step == int(js.step) == 32
    for name in ("positions", "velocities", "eta", "eta_dot", "group_ke"):
        ref = np.asarray(getattr(js, name))
        np.testing.assert_allclose(getattr(ts, name).numpy(), ref,
                                   rtol=1e-9, atol=1e-9 * np.abs(ref).max(),
                                   err_msg=name)
    assert not tctx.neighborListOverflowed
    assert not bool(ts.neighbors.drift_exceeded)
    np.testing.assert_allclose(tctx.getConservedEnergy(),
                               jctx.getConservedEnergy(), rtol=1e-9)
    np.testing.assert_allclose(
        tctx.getState(groups=True).getGroupTemperatures(),
        jctx.getState(groups=True).getGroupTemperatures(), rtol=1e-9)


def _jax_move(jctx, draws):
    """The JAX package's move with its two jax.random.uniform draws
    replaced by `draws` (as tests/test_torch_barostat.py feeds them)."""
    seq = iter([jnp.asarray(draws[0]), jnp.asarray(draws[1])])
    real = jax.random.uniform
    jax.random.uniform = lambda key, *a, dtype=None, **k: \
        next(seq).astype(dtype)
    try:
        return jbaro.maybe_attempt_mc_move(
            jctx._spec, jctx._static, jctx._state,
            jctx._energy_and_forces, recompute_current=True)
    finally:
        jax.random.uniform = real


def test_npt_move_then_shrink_replans_the_triclinic_grid():
    """One accepted volume move on the sheared box (positions and the
    whole (3, 3) box scaled) against the JAX package's, then the box
    shrunk by 4%: the next sort plans the triclinic cell grid and the
    PME grid again at the new box, as the JAX package does, and the
    energy there matches the JAX energy."""
    (jctx, _), (tctx, _) = _water_pair("cellpair", n_mol=216, cutoff=0.5,
                                       baro=4)
    jctx._ensure_neighbors()
    tctx._ensure_neighbors()
    draws = (0.9, 1e-12)
    js = _jax_move(jctx, draws)
    ts = tbaro.maybe_attempt_mc_move(tctx._spec, tctx._static, tctx._state,
                                     tctx._potential, tctx._forces_only,
                                     draws=draws)
    assert ts.baro_naccept == 1
    np.testing.assert_allclose(ts.positions.numpy(),
                               np.asarray(js.positions), rtol=0, atol=1e-10)
    np.testing.assert_allclose(ts.box.numpy(), np.asarray(js.box),
                               rtol=1e-10, atol=1e-12)
    assert ts.box[1, 0] != 0 and ts.box[2, 1] != 0
    s = 0.96
    grid0 = tctx._cp_cfg.grid
    jctx._state = js._replace(box=js.box * s, positions=js.positions * s,
                              neighbors=None)
    jctx._forces_valid = False
    tctx._state = ts.replace(box=ts.box * s, positions=ts.positions * s,
                             neighbors=None)
    tctx._forces_valid = False
    jctx._ensure_neighbors()
    tctx._ensure_neighbors()
    cfg = tctx._cp_cfg
    assert cfg.triclinic and cfg.grid != grid0
    assert cfg.grid == jctx._cp_cfg.grid
    assert not bool(tctx._state.neighbors.stencil_invalid)
    widths = tbox.plane_widths(tctx._state.box).numpy()
    assert np.all(np.asarray(cfg.window) * widths / np.asarray(cfg.grid)
                  >= cfg.r_list - 1e-9)
    je = jctx.getState(energy=True).getPotentialEnergy()
    te = tctx.getState(energy=True).getPotentialEnergy()
    np.testing.assert_allclose(te, je, rtol=1e-10)


def test_rf_forces_match_finite_differences_and_jax():
    """The reaction field with LJ on the dense strategy in TRI_BOX: the
    analytic forces against central differences of the energy (the twin
    of tests/test_triclinic.py::test_triclinic_lj_rf_forces_finite_diff,
    without its LJ switch, which tests/test_torch_switch.py holds in a
    triclinic box: no pair lies within the step of the cutoff), and
    energy and forces against JAX."""
    rng = np.random.default_rng(11)
    frac = np.stack(np.meshgrid(*[np.arange(3)] * 3),
                    axis=-1).reshape(-1, 3) / 3.0
    frac = frac + rng.uniform(-0.06, 0.06, frac.shape)
    pos = frac @ TRI_BOX
    q = rng.normal(0, 0.2, len(pos))
    method = dt.NonbondedForce.CutoffPeriodic
    system, nb = _charged_system(dt, pos, q, TRI_BOX, method, 0.9, eps=0.5)
    e0, f = _port_energy_forces(system, nb, pos, TRI_BOX)
    h = 1e-6
    for _ in range(6):
        i = int(rng.integers(len(pos)))
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        dp = np.zeros_like(pos)
        dp[i] = d * h
        num = (_port_energy_forces(system, nb, pos + dp, TRI_BOX)[0]
               - _port_energy_forces(system, nb, pos - dp, TRI_BOX)[0]) \
            / (2 * h)
        np.testing.assert_allclose(num, -np.dot(f[i], d), rtol=1e-5,
                                   atol=1e-7)
    jsys, jnb = _charged_system(dn, pos, q, TRI_BOX,
                                dn.NonbondedForce.CutoffPeriodic, 0.9,
                                eps=0.5)
    fn, params = jnb.compile(jsys, jnp.float64)
    e_ref, g_ref = jax.value_and_grad(
        lambda p: fn(params, p, jnp.asarray(TRI_BOX)))(jnp.asarray(pos))
    np.testing.assert_allclose(e0, float(e_ref), rtol=1e-10)
    np.testing.assert_allclose(f, -np.asarray(g_ref), rtol=0,
                               atol=1e-8 * np.abs(g_ref).max())


def test_enforce_periodic_box_matches_jax():
    """Whole molecules wrapped by the fractional image of their centres
    in the sheared box, against the JAX package."""
    (jctx, _), (tctx, _) = _water_pair("dense", n_mol=64, cutoff=0.5)
    pos = tctx.getState(positions=True).getPositions()
    box = tctx.getState().getPeriodicBoxVectors()
    shift = np.random.default_rng(2).integers(-2, 3, (pos.shape[0] // 5, 3))
    p = pos + np.repeat(shift, 5, axis=0) @ box
    for ctx in (jctx, tctx):
        ctx.setPositions(p)
    js = jctx.getState(positions=True, enforcePeriodicBox=True)
    ts = tctx.getState(positions=True, enforcePeriodicBox=True)
    np.testing.assert_allclose(ts.getPositions(), js.getPositions(),
                               rtol=0, atol=1e-12)
    centers = ts.getPositions().reshape(-1, 5, 3).mean(axis=1)
    fr = centers @ np.linalg.inv(box)
    assert np.all((fr >= -1e-12) & (fr < 1 + 1e-12))


def test_checkpoint_of_triclinic_npt_replays_bit_exact(tmp_path):
    """A sheared NPT run on the cell-pair strategy: save, 8 steps (two
    volume attempts), load into a fresh Context, 8 steps: positions,
    velocities and the (3, 3) box equal bit for bit; the plan box is the
    triclinic one."""
    def make():
        system, pos = _water_system(dt, tbuilders, 216, 0.5)
        system.addForce(dt.MonteCarloBarostat(1.01325, 300.0, 4))
        integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        integ.setMaxDrudeDistance(0.02)
        ctx = dt.Context(system, integ, precision="double",
                         strategy="cellpair", device="cpu")
        ctx.setPositions(pos)
        ctx.setVelocitiesToTemperature(300.0, seed=3)
        return ctx, integ

    ctx, integ = make()
    integ.step(8)
    path = str(tmp_path / "tri.npz")
    dt.save_checkpoint(path, ctx)
    assert tbox.is_triclinic(ctx._plan_box)
    integ.step(8)
    ref = ctx.getState(positions=True, velocities=True)
    assert ctx._state.baro_nattempt > 0
    ctx2, integ2 = make()
    dt.load_checkpoint(path, ctx2)
    integ2.step(8)
    res = ctx2.getState(positions=True, velocities=True)
    np.testing.assert_array_equal(res.getPositions(), ref.getPositions())
    np.testing.assert_array_equal(res.getVelocities(), ref.getVelocities())
    box = res.getPeriodicBoxVectors()
    np.testing.assert_array_equal(box, ref.getPeriodicBoxVectors())
    assert tbox.is_triclinic(box)
