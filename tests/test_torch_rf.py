"""The reaction-field, cutoff and no-cutoff methods of the PyTorch port
against the JAX package: the dense strategy (CutoffPeriodic,
CutoffNonPeriodic, NoCutoff) and the cell-pair plain sweep
(CutoffPeriodic) through each package's Context in f64 (energy 1e-10
relative, forces 1e-8 of max|F|); the reaction-field plain versions of
kernels B1 and B2 in f32 against the JAX TPU kernel with method "rf"
(_make_pair_g's formula), run in interpret mode (2e-5 of max|F|); the
wrappers' refusals; the switched LJ against the JAX XLA route; and the
JAX package's dropped LJ switch on its Pallas route (ROADMAP.md Queue
C14)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.forces import cellpair as jcp
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu.ops import pallas_sweep as jps
from openmm_drudenose_tpu_torch.forces import cellpair as tcp
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
from torch_threads import _one_thread  # noqa: F401

NB = dt.NonbondedForce
# the smallest water box with a regular cell grid at this cutoff (5^3)
N_MOL, CUTOFF = 125, 0.5


def _contexts(method, strategy, precision="double", n_mol=N_MOL,
              cutoff=CUTOFF, eps_rf=None, switch=None):
    """The JAX and the port's Context on the same water box (LJ switched
    from `switch` where given)."""
    out = []
    for pkg, build, kw in ((dn, jbuilders, {}),
                           (dt, tbuilders, {"device": "cpu"})):
        system, pos = build.build_water_box(n_mol, method=method,
                                            cutoff=cutoff)
        nbf = next(f for f in system.getForces()
                   if type(f).__name__ == "NonbondedForce")
        if eps_rf is not None:
            nbf.setReactionFieldDielectric(eps_rf)
        if switch is not None:
            nbf.setUseSwitchingFunction(True)
            nbf.setSwitchingDistance(switch)
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        ctx = pkg.Context(system, integ, precision=precision,
                          strategy=strategy, **kw)
        ctx.setPositions(pos)
        out.append(ctx)
    return out


def _energy_forces(ctx):
    st = ctx.getState(energy=True, forces=True)
    return st.getPotentialEnergy(), np.asarray(st.getForces())


def _assert_match(jctx, tctx):
    e_ref, f_ref = _energy_forces(jctx)
    e, f = _energy_forces(tctx)
    np.testing.assert_allclose(e, e_ref, rtol=1e-10)
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())


@pytest.mark.parametrize("method", [NB.CutoffPeriodic, NB.CutoffNonPeriodic,
                                   NB.NoCutoff])
def test_dense_matches_jax(method):
    jctx, tctx = _contexts(method, "auto")
    assert tctx._nb.strategy == "dense"
    assert tctx._nb.pme is None
    assert tctx._nb.coulomb["method"] == ("none" if method == NB.NoCutoff
                                          else "rf")
    _assert_match(jctx, tctx)


def test_cellpair_plain_sweep_matches_jax():
    """CutoffPeriodic on the cell-pair strategy in f64 (the plain sweep,
    the reaction field), with a dielectric other than the default."""
    jctx, tctx = _contexts(NB.CutoffPeriodic, "cellpair", eps_rf=20.0)
    assert tctx._nb.strategy == "cellpair" and tctx._nb.pme is None
    krf = (1 / CUTOFF ** 3) * 19.0 / 41.0
    assert tctx._nb.coulomb["krf"] == pytest.approx(krf, rel=1e-15)
    _assert_match(jctx, tctx)


def test_dispersion_correction_only_where_periodic():
    """The tail correction applies to the periodic cutoff methods only, as
    in the JAX package (forces/nonbonded.py:365-368 there)."""
    system, _ = tbuilders.build_water_box(27, method=NB.CutoffPeriodic,
                                          cutoff=0.4)
    nb = next(f for f in system.getForces()
              if type(f).__name__ == "NonbondedForce")
    assert nb.compile(system, torch.float64, "cpu").disp is not None
    nb.setNonbondedMethod(NB.CutoffNonPeriodic)
    assert nb.compile(system, torch.float64, "cpu").disp is None


def _jax_nb(jctx):
    return next(t for t in jctx._terms if hasattr(t[0], "cellpair_cfg"))


@pytest.fixture(scope="module")
def rf32():
    """The f32 contexts (the reaction field on the cell-pair strategy),
    drifted positions and the JAX TPU kernel's forces there with method
    "rf" (_make_pair_g's formula), run once in interpret mode."""
    jctx, tctx = _contexts(NB.CutoffPeriodic, "cellpair", "single")
    jctx._ensure_neighbors()
    tctx._ensure_neighbors()
    nb = tctx._nb
    _, nb_params = _jax_nb(jctx)
    rng = np.random.default_rng(3)
    pos = np.asarray(tctx._state.positions, np.float64)
    pos = (pos + rng.uniform(-0.03, 0.03, pos.shape)).astype(np.float32)
    f_pallas = np.asarray(jps.pair_forces_pallas(
        nb_params, jnp.asarray(pos), jnp.diagonal(jctx._state.box),
        jctx._state.neighbors, jctx._cp_cfg, "rf", krf=nb.coulomb["krf"],
        crf=nb.coulomb["crf"], interpret=True))
    return jctx, tctx, pos, f_pallas


@pytest.mark.parametrize("kernel", [sweep, sweep_chunked],
                         ids=["b1", "b2"])
def test_rf_plain_versions_match_jax_pallas(rf32, kernel):
    """B1's and B2's plain versions (the CPU's side of their wrappers)
    with method "rf" against the JAX TPU kernel's reaction-field pair
    function."""
    _, tctx, pos, f_ref = rf32
    nb = tctx._nb
    assert nb.coulomb["method"] == "rf" and nb.sweep_kernel == "b1"
    tbox = torch.diagonal(tctx._state.box)
    fields = nb.fields(torch.as_tensor(pos), tbox, tctx._state.neighbors)
    f = kernel.pair_forces(fields, nb.cfg, tcp.offset_shifts(nb.cfg, tbox),
                           nb.alpha, ONE_4PI_EPS0, excl_skip=True,
                           **nb.coulomb)
    f = f[tctx._state.neighbors.inv_slot].numpy()
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=2e-5 * np.abs(f_ref).max())


def test_wrappers_refuse_what_the_kernels_do_not_take(rf32):
    """An unknown Coulomb kind, Ewald without alpha and a non-finite
    reaction field raise in every wrapper, on any device."""
    _, tctx, _, _ = rf32
    nb = tctx._nb
    tbox = torch.diagonal(tctx._state.box)
    fields = nb.fields(tctx._state.positions, tbox, tctx._state.neighbors)
    args = (fields, nb.cfg, tcp.offset_shifts(nb.cfg, tbox))
    bad = [(0.0, {"method": "none"}), (0.0, {"method": "ewald"}),
           (0.0, {"method": "rf", "krf": float("nan"), "crf": 1.0})]
    for kernel in (sweep, sweep_chunked):
        for fn in (kernel.pair_forces, kernel.pair_energy):
            for alpha, kw in bad:
                with pytest.raises(ValueError):
                    fn(*args, alpha, ONE_4PI_EPS0, **kw)


def test_cellpair_refuses_non_periodic_methods():
    system, _ = tbuilders.build_water_box(27, method=NB.CutoffNonPeriodic,
                                          cutoff=0.4)
    nb = next(f for f in system.getForces()
              if type(f).__name__ == "NonbondedForce")
    with pytest.raises(ValueError):
        nb.compile(system, torch.float64, "cpu", strategy="cellpair")


@pytest.mark.parametrize("strategy", ["dense", "cellpair"])
def test_switched_lj_rf_matches_jax(strategy):
    """The reaction field with the LJ switched from 0.4 nm to the 0.5 nm
    cutoff compiles on both strategies and matches the JAX XLA route in
    f64 (the switched pair sum, the NBFIX-free tail with the switch's
    window)."""
    jctx, tctx = _contexts(NB.CutoffPeriodic, strategy, switch=0.4)
    assert tctx._nb.strategy == strategy
    assert tctx._nb.coulomb["r_switch"] == 0.4
    _assert_match(jctx, tctx)


def test_jax_pallas_route_drops_the_lj_switch(rf32):
    """Queue C14 of the JAX package: its Pallas kernels take no switch
    (`_make_pair_g`, both pallas_call wrappers), yet forces/nonbonded.py
    routes a switched system to them.  On the same f32 fields the Pallas
    route (interpret mode) gives the unswitched forces (2e-5 of max|F|)
    and misses the XLA sweep's switched ones by more than 1e-4 of max|F|
    (LJ switched from 0.4 nm to the 0.5 nm cutoff)."""
    jctx, tctx, pos, f_pallas = rf32
    nb_fn, nb_params = _jax_nb(jctx)
    nb = tctx._nb
    out = {}
    for switch in (False, True):
        pair_eg = jcp.make_pair_eg("rf", CUTOFF, krf=nb.coulomb["krf"],
                                   crf=nb.coulomb["crf"], use_switch=switch,
                                   r_switch=0.4)
        _, f = jcp.pair_energy_forces(
            nb_params, jnp.asarray(pos), jnp.diagonal(jctx._state.box),
            jctx._state.neighbors, jctx._cp_cfg, pair_eg,
            nb_fn.coulomb_scale, with_energy=False)
        out[switch] = np.asarray(f)
    scale = np.abs(out[False]).max()
    assert np.abs(f_pallas - out[False]).max() <= 2e-5 * scale
    assert np.abs(f_pallas - out[True]).max() > 1e-4 * scale
