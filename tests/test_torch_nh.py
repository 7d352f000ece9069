"""NH chain and TGNH step of the PyTorch port against the JAX package.

The chain's plain version (ops/nh_chain.py, the kernel's reference) is
held to the serial transcription of the reference host loop
(tests/test_nh_chain.py) and to the JAX propagate_nh_chain to 1e-12, on
(G+2,) baths and on the (R, G+2) baths of a flattened ensemble; one
fused NH section (the NH pair on one KE measurement, the CM correction
between its halves, the composed scaling and the CM shift) to the JAX
fused body to 1e-12, in one launch's form and in the two launches'
around a barostat move."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.core.spec import StaticSpec as JStatic
from openmm_drudenose_tpu.integrators import tgnh as jtgnh
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu_torch.core.spec import StaticSpec
from openmm_drudenose_tpu_torch.integrators import tgnh
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from openmm_drudenose_tpu_torch.ops import nh_chain
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


def _random_chain(rng, lead, G, M, use_drude_chains):
    """Bath constants and a chain state of (lead..., G+2) baths."""
    nb = G + 2
    real_kbt = 8.314e-3 * 300.0
    drude_kbt = 8.314e-3 * 1.0
    eta_mass = np.abs(rng.normal(5.0, 1.0, (nb, M)))
    nkbt = np.abs(rng.normal(100 * real_kbt, real_kbt, nb))
    ke = np.abs(rng.normal(100 * real_kbt, 10 * real_kbt, lead + (nb,)))
    eta = rng.normal(0, 0.1, lead + (nb, M))
    eta_dot = rng.normal(0, 0.5, lead + (nb, M + 1))
    eta_dot[..., M] = 0.0
    eta_dot_dot = rng.normal(0, 0.5, lead + (nb, M))
    if not use_drude_chains:
        eta_dot[..., nb - 1, 1:] = 0.0
        eta_dot_dot[..., nb - 1, 1:] = 0.0
    link = np.ones((nb, M), bool)
    if not use_drude_chains:
        link[nb - 1, 1:] = False
    kbt_chain = np.full(nb, real_kbt)
    kbt_chain[nb - 1] = drude_kbt
    consts = (eta_mass, nkbt, real_kbt, drude_kbt, kbt_chain, link)
    return consts, (ke, eta, eta_dot, eta_dot_dot)


@pytest.mark.parametrize("use_drude_chains", [False, True])
@pytest.mark.parametrize("R,G,M,steps", [(3, 1, 1, 20), (70, 1, 2, 20),
                                         (4, 2, 4, 7)])
def test_ensemble_chain_matches_jax(R, G, M, steps, use_drude_chains):
    """(R, G+2) baths (a flattened ensemble's): the plain chain against
    the JAX propagate_nh_chain on the same arrays, every output and the
    damped KE to 1e-12."""
    rng = np.random.default_rng(7 + R + 10 * G + 100 * M)
    consts, chain = _random_chain(rng, (R,), G, M, use_drude_chains)
    eta_mass, nkbt, real_kbt, drude_kbt, kbt_chain, link = consts
    dt_ps = 0.001
    got = tgnh.propagate_nh_chain(
        _ChainSpec(eta_mass, nkbt, kbt_chain, link),
        _static(G, M, steps, use_drude_chains),
        *(torch.as_tensor(a) for a in chain), dt_ps, return_final_ke=True)
    jstatic = JStatic(
        n_atoms=1, n_residues=1, n_temp_groups=G, n_chains=M,
        drude_steps=steps, use_drude_nh_chains=use_drude_chains,
        use_com_temp_group=True, has_pairs=True, has_hardwall=False,
        n_settle=0, n_shake=0, n_vsites_avg=0, n_vsites_oop=0,
        n_vsites_lc=0, cm_freq=0, baro_freq=0, constraint_tol=1e-5,
        ensemble_r=R)
    jax_out = jtgnh.propagate_nh_chain(
        _mini_spec(G, M, eta_mass, nkbt, real_kbt, drude_kbt,
                   use_drude_chains), jstatic,
        *(jnp.asarray(a) for a in chain), jnp.asarray(dt_ps),
        return_final_ke=True)
    assert len(got) == len(jax_out) == 5
    for g, j in zip(got, jax_out):
        assert tuple(g.shape) == tuple(np.shape(j))
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-14)


CM_FREQ = 10


def _section_pair(M):
    """JAX and port Contexts (f64, dense) of one 64-water box with a
    CMMotionRemover every CM_FREQ steps and an M-link chain (Drude chains
    on)."""
    jsys, pos = jbuilders.build_water_box(64, cutoff=0.5)
    tsys, _ = tbuilders.build_water_box(64, cutoff=0.5)
    out = []
    for pkg, system, kw in ((dn, jsys, {}), (dt, tsys, {"device": "cpu"})):
        for f in system.getForces():
            if type(f).__name__ == "CMMotionRemover":
                f.setFrequency(CM_FREQ)
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, M,
                                        True)
        ctx = pkg.Context(system, integ, precision="double",
                          strategy="dense", **kw)
        ctx.setPositions(pos)
        out.append(ctx)
    return out


@pytest.mark.parametrize("barostat", [False, True],
                         ids=["one_launch", "two_launches"])
@pytest.mark.parametrize("step", [0, 1], ids=["cm_step", "no_cm_step"])
@pytest.mark.parametrize("M", [1, 2])
def test_fused_nh_section_matches_jax(M, step, barostat):
    """One fused NH section from the same velocities and chain: the JAX
    fused body (its _make_multi_step_fused with a core, NH halves and
    barostat that change nothing, so that the body's NH section alone
    acts) against the port's fused_body with its core replaced alike
    (with a barostat, the chain kernel's two-launch form): velocities,
    chain, group KE and KE sum to 1e-12.  Step 0 removes the CM motion
    (m01 = 1), step 1 not."""
    jctx, tctx = _section_pair(M)
    assert tctx._static.cm_freq == jctx._static.cm_freq == CM_FREQ
    rng = np.random.default_rng(31 + M)
    n = tctx._static.n_atoms
    G = tctx._static.n_temp_groups
    v = rng.normal(0.0, 0.3, (n, 3)) + 0.05       # a net CM drift
    _, (_, eta, eta_dot, eta_dot_dot) = _random_chain(rng, (), G, M, True)
    jst = jctx._state._replace(
        velocities=jnp.asarray(v), eta=jnp.asarray(eta),
        eta_dot=jnp.asarray(eta_dot), eta_dot_dot=jnp.asarray(eta_dot_dot),
        step=jnp.asarray(step, jctx._state.step.dtype))
    ns = types.SimpleNamespace(
        update_context_state=lambda spec, s: s,
        nh_half=lambda spec, s, vt: (s, vt),
        core=lambda spec, s, vt: (s, vt.T),
        apply_barostat=lambda spec, s: s)
    multi = jtgnh._make_multi_step_fused(jctx._static, ns, 2, None, 16, 0.1)
    jout = multi(jctx._spec, jst)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    tst = tctx._state.replace(velocities=t(v), eta=t(eta),
                              eta_dot=t(eta_dot), eta_dot_dot=t(eta_dot_dot),
                              step=step)
    stepper = tgnh.Stepper(tctx._static, None,
                           (lambda spec, s: s) if barostat else None)
    stepper.core = lambda spec, state, vel: (state, vel)
    launches = nh_chain.launches["nh_chain"]
    tout = stepper.fused_body(tctx._spec, tst)
    assert nh_chain.launches["nh_chain"] == launches     # the plain version
    for name in ("velocities", "eta", "eta_dot", "eta_dot_dot", "group_ke",
                 "ke_sum"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-12, atol=1e-13, err_msg=name)
    # the section did something: the chain moved, and at step 0 the CM
    # drift left the velocities
    assert not np.allclose(tout.eta.numpy(), eta)
    mass = tctx._spec.mass.numpy()[:, None]
    p = np.sum(mass * tout.velocities.numpy(), axis=0)
    assert (np.max(np.abs(p)) < 1e-9) == (step == 0)
