"""NH chain and TGNH step of the PyTorch port against the JAX package.

The chain is held to the serial transcription of the reference host loop
(tests/test_nh_chain.py) and to the JAX propagate_nh_chain to 1e-12; the
fused multi-step to the unfused one to 1e-11 on positions (the twin of
tests/test_fused_nh.py); the kinematics kernels (group KE, velocity
scaling, half kick, hard wall) to the JAX ones in f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_drudenose_tpu.core.spec import StaticSpec as JStatic
from openmm_drudenose_tpu.integrators import tgnh as jtgnh
from openmm_drudenose_tpu_torch.core.spec import StaticSpec
from openmm_drudenose_tpu_torch.integrators import tgnh
from tests.test_nh_chain import _mini_spec, serial_reference_nh
from torch_threads import _one_thread  # noqa: F401


class _ChainSpec:
    def __init__(self, eta_mass, nkbt, kbt_chain, link):
        self.nh_eta_mass = torch.as_tensor(eta_mass)
        self.nh_nkbt = torch.as_tensor(nkbt)
        self.nh_kbt_chain = torch.as_tensor(kbt_chain)
        self.nh_link_active = torch.as_tensor(link)


def _static(G, M, steps, use_drude_chains):
    return StaticSpec(
        n_atoms=1, n_residues=1, n_temp_groups=G, n_chains=M,
        drude_steps=steps, use_drude_nh_chains=use_drude_chains,
        use_com_temp_group=True, has_pairs=True, has_hardwall=False,
        n_settle=0, n_vsites_avg=0, cm_freq=0)


@pytest.mark.parametrize("use_drude_chains", [False, True])
@pytest.mark.parametrize("G,M,steps", [(1, 1, 20), (1, 2, 20), (3, 4, 7)])
def test_chain_matches_serial_reference_and_jax(G, M, steps,
                                                use_drude_chains):
    rng = np.random.default_rng(42 + G * 10 + M)
    nb = G + 2
    real_kbt = 8.314e-3 * 300.0
    drude_kbt = 8.314e-3 * 1.0
    eta_mass = np.abs(rng.normal(5.0, 1.0, (nb, M)))
    nkbt = np.abs(rng.normal(100 * real_kbt, real_kbt, nb))
    ke = np.abs(rng.normal(100 * real_kbt, 10 * real_kbt, nb))
    eta = rng.normal(0, 0.1, (nb, M))
    eta_dot = rng.normal(0, 0.5, (nb, M + 1))
    eta_dot[:, M] = 0.0
    eta_dot_dot = rng.normal(0, 0.5, (nb, M))
    if not use_drude_chains:
        eta_dot[nb - 1, 1:] = 0.0
        eta_dot_dot[nb - 1, 1:] = 0.0
    dt = 0.001
    exp = serial_reference_nh(ke, eta, eta_dot, eta_dot_dot, eta_mass, nkbt,
                              real_kbt, drude_kbt, steps, M,
                              use_drude_chains, dt)
    link = np.ones((nb, M), bool)
    if not use_drude_chains:
        link[nb - 1, 1:] = False
    kbt_chain = np.full(nb, real_kbt)
    kbt_chain[nb - 1] = drude_kbt
    spec = _ChainSpec(eta_mass, nkbt, kbt_chain, link)
    got = tgnh.propagate_nh_chain(
        spec, _static(G, M, steps, use_drude_chains),
        torch.as_tensor(ke), torch.as_tensor(eta), torch.as_tensor(eta_dot),
        torch.as_tensor(eta_dot_dot), dt)
    jstatic = JStatic(
        n_atoms=1, n_residues=1, n_temp_groups=G, n_chains=M,
        drude_steps=steps, use_drude_nh_chains=use_drude_chains,
        use_com_temp_group=True, has_pairs=True, has_hardwall=False,
        n_settle=0, n_shake=0, n_vsites_avg=0, n_vsites_oop=0,
        n_vsites_lc=0, cm_freq=0, baro_freq=0, constraint_tol=1e-5)
    jax_out = jtgnh.propagate_nh_chain(
        _mini_spec(G, M, eta_mass, nkbt, real_kbt, drude_kbt,
                   use_drude_chains), jstatic,
        jnp.asarray(ke), jnp.asarray(eta), jnp.asarray(eta_dot),
        jnp.asarray(eta_dot_dot), jnp.asarray(dt))
    for g, e, j in zip(got, exp, jax_out):
        g = np.asarray(g)[..., :M] if g.ndim == 2 else np.asarray(g)
        e = np.asarray(e)[..., :M] if np.ndim(e) == 2 else np.asarray(e)
        j = np.asarray(j)[..., :M] if np.ndim(j) == 2 else np.asarray(j)
        np.testing.assert_allclose(g, e, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(g, j, rtol=1e-12, atol=1e-14)


def test_equilibrium_is_fixed_point():
    G, M = 2, 3
    nb = G + 2
    nkbt = np.full(nb, 2.0)
    spec = _ChainSpec(np.ones((nb, M)), nkbt, np.full(nb, 2.494),
                      np.ones((nb, M), bool))
    vscale, _, eta_dot, _ = tgnh.propagate_nh_chain(
        spec, _static(G, M, 20, True), nkbt.copy(), np.zeros((nb, M)),
        np.zeros((nb, M + 1)), np.zeros((nb, M)), 0.001)
    np.testing.assert_allclose(vscale, 1.0, atol=1e-13)
    np.testing.assert_allclose(eta_dot[:, 0], 0.0, atol=1e-13)
