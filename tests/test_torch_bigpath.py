"""What the port's large single-card path (800,000 atoms in a 16.9 nm
box) needed to meet the float32 floor, held on the CPU at a small size.

1. The Ewald exclusion correction's force in float32 at the core-Drude
   distances of a running SWM4-NDP system.  The closed form
   (-qq (2a/sqrt(pi) e^{-a^2 r^2} - erf(ar)/r) / r, as the JAX package
   computes it) cancels catastrophically as r -> 0; the port takes the
   series of N(x)/x^3 below x = a r = 0.5.  References: mpmath at 40
   digits (mpmath ships with sympy, which PyTorch requires), and the JAX
   package's float64 closed form where it is still accurate.
2. The nonbonded distances from the compensated positions (float32 plus
   the integrator's pos_err, formed in float64): float32 coordinates
   14-18 nm from the origin carry ~1e-6 nm of rounding, which the
   +-1.7 e core-Drude dipoles turn into ~1e-5 of max|F| (rms).  Checked
   on a box moved 14 nm out, with the virtual sites and the PME taps
   that go with it."""

import math

import jax.numpy as jnp
import mpmath
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.forces import pairterms as jpt
from openmm_drudenose_tpu_torch.constraints.vsites import (
    apply_vsites, apply_vsites_relative)
from openmm_drudenose_tpu_torch.forces import pairterms as tpt
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
from torch_threads import _one_thread  # noqa: F401

ALPHA = 2.628261                      # the bench configuration's alpha
QQ = ONE_4PI_EPS0 * 1.71636 * -1.71636   # SWM4-NDP core x Drude


def _port_forces(r, dtype):
    rr = torch.as_tensor(r, dtype=dtype)
    r2 = rr * rr
    eg = tpt.ewald_correction_eg(torch.as_tensor(QQ, dtype=dtype), ALPHA)
    _, g = eg(torch.clamp(r2, min=1e-10), r2)
    return (-2.0 * g * rr).double().numpy()          # radial force


def _exact_forces(r):
    mpmath.mp.dps = 40
    out = []
    for x in r:
        ar = ALPHA * mpmath.mpf(float(x))
        n = mpmath.erf(ar) - 2 * ar / mpmath.sqrt(mpmath.pi) * mpmath.exp(
            -ar * ar)
        out.append(float(-QQ * n / mpmath.mpf(float(x)) ** 2))
    return np.array(out)


@pytest.mark.parametrize("r_max", [0.02, 0.3])
def test_float32_correction_force_near_zero(r_max):
    """Float32 against 40 digits from 2e-5 nm to the 0.02 nm hard wall
    (core-Drude pairs) and on to 0.3 nm (every intramolecular exclusion
    of SWM4-NDP): within 1e-5 of the largest force of the range (the
    closed form misses by more than 1e-3 of it, as the test below
    shows)."""
    r = np.geomspace(2e-5, r_max, 200)
    ref = _exact_forces(r)
    got = _port_forces(r, torch.float32)
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(np.abs(ref))


def test_jax_closed_form_float32_misses_near_zero():
    """The fault the series repairs: the JAX package's closed form in
    float32 misses the 40-digit force by more than 1e-3 of the largest
    force between 2e-5 nm and the 0.02 nm wall (1e-2 at the time of
    writing)."""
    r = np.geomspace(2e-5, 0.02, 200)
    ref = _exact_forces(r)
    r32 = jnp.asarray(r, jnp.float32)
    r2 = r32 * r32
    jeg = jpt.ewald_correction_eg(jnp.asarray(QQ, jnp.float32), ALPHA)
    _, g = jeg(r2, r2)
    got = np.asarray(-2.0 * g * r32, np.float64)
    assert np.max(np.abs(got - ref)) > 1e-3 * np.max(np.abs(ref))


@pytest.mark.parametrize("r_max", [0.5 / ALPHA * 1.5, 0.6])
def test_float64_correction_force_is_exact(r_max):
    """Float64 on both sides of the series switch (x = 0.5 at r = 0.19
    nm): 1e-12 of each force."""
    r = np.geomspace(2e-5, r_max, 200)
    ref = _exact_forces(r)
    got = _port_forces(r, torch.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


def test_float64_correction_matches_jax_above_cancellation():
    """Where the closed form keeps its float64 digits (x = ar >= 0.05),
    the port's forces equal the JAX package's to 1e-12."""
    r = np.geomspace(0.05 / ALPHA, 0.4, 100)
    jeg = jpt.ewald_correction_eg(jnp.asarray(QQ), ALPHA)
    r2 = jnp.asarray(r * r)
    _, g = jeg(r2, r2)
    ref = -2.0 * np.asarray(g) * r
    np.testing.assert_allclose(_port_forces(r, torch.float64), ref,
                               rtol=1e-12, atol=0)


def test_series_coefficients():
    """c_n = (-1)^(n+1) 2n / ((2n+1) n!): 2/3, -2/5, 1/7, -1/27, ..."""
    want = [2 / 3, -2 / 5, 1 / 7, -1 / 27, 1 / 132]
    np.testing.assert_allclose(tpt._SERIES_C[:5], want, rtol=1e-15)
    # the first term left out is below 1e-17 of the sum at the switch
    n = len(tpt._SERIES_C) + 1
    c_next = 2 * n / ((2 * n + 1) * math.factorial(n))
    assert c_next * tpt.SERIES_X ** (2 * n - 2) < 1e-17 * (2 / 3)


SHIFT = 14.0     # nm: coordinates of the size a 16.9 nm box holds


def _shifted_contexts():
    """A float32 context 16 steps into a run from fresh 300 K velocities,
    every coordinate moved SHIFT nm from the origin, and a float64
    context at its compensated positions (positions + pos_err)."""
    system, pos = tbuilders.build_water_box(216, cutoff=0.6)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision="single", device="cpu",
                     strategy="cellpair")
    ctx.setPositions(pos + SHIFT)
    ctx.setVelocitiesToTemperature(300.0, seed=0)
    integ.step(16)
    st = ctx._state
    integ64 = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    ctx64 = dt.Context(system, integ64, precision="double", device="cpu",
                       strategy="cellpair",
                       nb_options={"capacity": ctx._cp_cfg.capacity})
    ctx64.setPositions((st.positions.double()
                        + st.pos_err.double()).numpy())
    ctx64._ensure_forces()
    return ctx, ctx64


def test_force_pass_takes_compensated_positions():
    """The float32 force pass at 14-18 nm from the origin against float64
    at the compensated positions: rms <= 2e-6 of max|F|.  Distances from
    the float32 positions alone (what the JAX package does) miss by
    ~1e-5 (rms) there."""
    ctx, ctx64 = _shifted_contexts()
    st = ctx._state
    ref = ctx64._state.forces
    scale = float(torch.max(torch.abs(ref)))

    def rms(f):
        return float(torch.sqrt(torch.mean((f.double() - ref) ** 2))) / scale

    got = ctx._forces_only(st.positions, st.box, st.neighbors, st.pos_err)
    assert rms(got) <= 2e-6
    # the same pass with the nonbonded distances from float32 positions
    uncompensated = ctx._exact_positions
    ctx._exact_positions = lambda positions, pos_err: None
    try:
        raw = ctx._forces_only(st.positions, st.box, st.neighbors,
                               st.pos_err)
    finally:
        ctx._exact_positions = uncompensated
    assert rms(raw) > 5e-6


def test_relative_vsites_match_float64():
    """Sites from float64 positions with the float32 spec's weights, in
    the relative form, land within 1e-8 nm of the float64 spec's sites;
    the absolute form is off by ~1e-6 nm at 14 nm from the origin."""
    system, pos = tbuilders.build_water_box(216, cutoff=0.6)
    ctxs = {}
    for precision in ("single", "double"):
        integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        ctxs[precision] = dt.Context(system, integ, precision=precision,
                                     device="cpu", strategy="cellpair")
    p64 = torch.as_tensor(pos + SHIFT)
    ref = apply_vsites(ctxs["double"]._spec, ctxs["double"]._static, p64)
    c32 = ctxs["single"]
    got = apply_vsites_relative(c32._spec, c32._static, p64)
    assert float(torch.max(torch.abs(got - ref))) <= 1e-8
    absolute = apply_vsites(c32._spec, c32._static, p64)
    assert float(torch.max(torch.abs(absolute - ref))) > 1e-7


def test_pme_taps_from_exact_positions():
    """Taps formed from float64 positions take the in-cell fraction
    rounded once to float32: their B-spline weights are those of the
    float64 fraction so rounded, where fractions formed from float32
    positions 14 nm out miss by ~1e-5 grid spacings."""
    from openmm_drudenose_tpu_torch.forces import pme
    setup = pme.setup_pme(cutoff=1.0, tol=5e-4, box_diag=[16.9] * 3)
    rng = np.random.default_rng(3)
    p64 = torch.as_tensor(rng.uniform(SHIFT, SHIFT + 2.9, (500, 3)))
    # the float32 context's box, as the float64 fractions see it
    box32 = torch.full((3,), 16.9, dtype=torch.float32)
    box64 = box32.double()
    u = p64 / box64
    u = (u - torch.floor(u)) * torch.as_tensor(setup.grid,
                                               dtype=torch.float64)
    frac = (u - torch.floor(u)).float()
    idx64, _, _ = pme._taps(setup, p64, box64)
    p32 = p64.float()
    idx, w, dw = pme._taps(setup, p32, box32, exact=p64)
    _, w_raw, _ = pme._taps(setup, p32, box32)
    miss = 0.0
    for d in range(3):
        assert torch.equal(idx[d], idx64[d])
        assert torch.equal(w[d], pme.bspline_weights(frac[:, d]))
        assert torch.equal(dw[d], pme.bspline_weights_d(frac[:, d]))
        miss = max(miss, float(torch.max(torch.abs(w_raw[d] - w[d]))))
    assert miss > 3e-6
