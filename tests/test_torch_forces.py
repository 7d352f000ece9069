"""Drude springs, Thole pairs and the pair-list terms (exceptions, Ewald
exclusion corrections) of the PyTorch port against the JAX package in
f64: energies to 1e-10 and forces to 1e-8 relative.  JAX forces come from
autodiff of its energies."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.forces import pairterms as jpt
from openmm_drudenose_tpu_torch.forces import pairterms as tpt
from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
from torch_threads import _one_thread  # noqa: F401


def _drude_systems(n_pairs, screened):
    """n_pairs core/shell pairs with random parameters; Thole screened
    pairs between consecutive pairs when `screened`."""
    rng = np.random.default_rng(11)
    out = []
    for pkg in (dn, dt):
        system = pkg.System()
        drude = pkg.DrudeForce()
        for i in range(n_pairs):
            system.addParticle(12.0)
            system.addParticle(0.4)
            drude.addParticle(2 * i + 1, 2 * i, -1, -1, -1,
                              -1.0 - 0.1 * (i % 3), 1e-3 * (1 + i % 4),
                              1, 1)
        if screened:
            for i in range(n_pairs - 1):
                drude.addScreenedPair(i, i + 1, 2.6)
        system.addForce(drude)
        out.append((system, drude))
    core = rng.uniform(0, 1.5, (n_pairs, 3))
    pos = np.repeat(core, 2, axis=0)
    pos[1::2] += rng.normal(0, 0.01, (n_pairs, 3))
    if screened:
        pos[::2] = np.arange(n_pairs)[:, None] * np.array([0.3, 0.0, 0.0])
        pos[1::2] = pos[::2] + rng.normal(0, 0.01, (n_pairs, 3))
    return out, pos


@pytest.mark.parametrize("screened", [False, True])
def test_drude_matches_jax(screened):
    ((jsys, jdr), (tsys, tdr)), pos = _drude_systems(12, screened)
    energy, params = jdr.compile(jsys, jnp.float64)
    e_ref = float(energy(params, jnp.asarray(pos), None))
    f_ref = -np.asarray(jax.grad(lambda p: energy(params, p, None))(
        jnp.asarray(pos)))
    term = tdr.compile(tsys, torch.float64, "cpu")
    e, f = term.energy_forces(torch.as_tensor(pos))
    np.testing.assert_allclose(float(e), e_ref, rtol=1e-10)
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())


def test_drude_pos_err_compensation():
    """The spring sees positions + pos_err (two-float compensation)."""
    ((jsys, jdr), (tsys, tdr)), pos = _drude_systems(6, False)
    err = np.random.default_rng(5).normal(0, 1e-7, pos.shape)
    energy, params = jdr.compile(jsys, jnp.float64)
    e_ref = float(energy(params, jnp.asarray(pos), None,
                         pos_err=jnp.asarray(err)))
    term = tdr.compile(tsys, torch.float64, "cpu")
    e, _ = term.energy_forces(torch.as_tensor(pos),
                              pos_err=torch.as_tensor(err))
    np.testing.assert_allclose(float(e), e_ref, rtol=1e-10)


def _pairs(n=40, P=60, seed=7):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 2.0, (n, 3))
    i = rng.integers(0, n, P)
    j = (i + rng.integers(1, n, P)) % n
    return pos, i, j, rng


@pytest.mark.parametrize("kind", ["exception", "ewald_correction"])
def test_pair_list_terms_match_jax(kind):
    pos, i, j, rng = _pairs()
    box = np.array([2.0, 2.1, 2.2])
    qq = ONE_4PI_EPS0 * rng.normal(0, 0.5, len(i))
    if kind == "exception":
        sig = rng.uniform(0.2, 0.35, len(i))
        eps = rng.uniform(0.0, 1.0, len(i))
        jeg = jpt.exception_eg(jnp.asarray(qq), jnp.asarray(sig),
                               jnp.asarray(eps))
        teg = tpt.exception_eg(torch.as_tensor(qq), torch.as_tensor(sig),
                               torch.as_tensor(eps))
    else:
        jeg = jpt.ewald_correction_eg(jnp.asarray(qq), 3.12)
        teg = tpt.ewald_correction_eg(torch.as_tensor(qq), 3.12)
        pos[j[0]] = pos[i[0]]          # the r -> 0 limit (shell on core)
    jterm = jpt.make_pair_list_term(len(pos), i, j, jeg)
    e_ref = float(jterm(jnp.asarray(pos), jnp.asarray(box)))
    f_ref = -np.asarray(jax.grad(jterm)(jnp.asarray(pos), jnp.asarray(box)))
    tterm = tpt.make_pair_list_term(i, j, teg, "cpu")
    e, f = tterm(torch.as_tensor(pos), torch.as_tensor(box))
    np.testing.assert_allclose(float(e), e_ref, rtol=1e-10)
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())
