"""The dense strategy of the PyTorch port (forces/dense.py: the all-pairs
direct-space sum over an (N, N) exclusion mask) against the JAX
package's forces/dense.py on the CPU: the Context's energy and forces in
f64 (energy 1e-10 relative, forces 1e-8 of max|f|) on a water box and on
the NaCl solution; the port in f32 (the A&S erfc) against the JAX
package in f64 to 2e-5 of max|f|; and the "auto" strategy rule against the JAX package's choice on the
reference example's 2,500-atom box and on a 5,000-atom box."""

import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu_torch.forces import nonbonded
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from torch_threads import _one_thread  # noqa: F401


BOXES = {
    "water": lambda b: b.build_water_box(64, cutoff=0.5),
    "nacl": lambda b: b.build_nacl_water_box(60, 2, 2, cutoff=0.6),
}


def _states(name, precision, pkgs=(dn, dt)):
    out = []
    for pkg in pkgs:
        b, kw = ((jbuilders, {}) if pkg is dn
                 else (tbuilders, {"device": "cpu"}))
        system, pos = BOXES[name](b)
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        ctx = pkg.Context(system, integ, precision=precision,
                          strategy="dense", **kw)
        # off the lattice: every pair at its own distance
        ctx.setPositions(pos + np.random.default_rng(3).uniform(
            -0.02, 0.02, pos.shape))
        out.append(ctx.getState(energy=True, forces=True))
    return out


@pytest.mark.parametrize("name", sorted(BOXES))
def test_dense_matches_jax_f64(name):
    js, ts = _states(name, "double")
    np.testing.assert_allclose(ts.getPotentialEnergy(),
                               js.getPotentialEnergy(), rtol=1e-10)
    f_ref = js.getForces()
    np.testing.assert_allclose(ts.getForces(), f_ref, rtol=0,
                               atol=1e-8 * np.abs(f_ref).max())


def test_dense_f32_matches_jax_f64():
    """The port in float32 (A&S erfc, displacements from the compensated
    float64 positions) against the JAX package in float64: float32
    rounding only."""
    js, = _states("nacl", "double", (dn,))
    ts, = _states("nacl", "single", (dt,))
    f_ref = js.getForces()
    np.testing.assert_allclose(ts.getForces(), f_ref, rtol=0,
                               atol=2e-5 * np.abs(f_ref).max())


def test_sweep_energy_is_the_dense_sum():
    """The dense term's energy and forces are one function: forces are
    minus the energy's gradient (float64, central differences)."""
    system, pos = tbuilders.build_water_box(64, cutoff=0.5)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    ctx = dt.Context(system, integ, precision="double", device="cpu")
    nb = ctx._nb
    p = torch.as_tensor(pos + 0.01)
    box = torch.diagonal(ctx._state.box)
    f = nb.sweep_forces(p, box)
    h = 1e-6
    for atom, c in ((0, 0), (7, 1), (33, 2)):
        dp = torch.zeros_like(p)
        dp[atom, c] = h
        num = -(nb.sweep_energy(p + dp, box) - nb.sweep_energy(p - dp, box)) \
            / (2 * h)
        assert float(num) == pytest.approx(float(f[atom, c]), rel=1e-6,
                                           abs=1e-6)


@pytest.mark.parametrize("n_atoms", [2500, 5000])
def test_auto_rule_matches_jax(n_atoms):
    def build(b):
        if n_atoms == 2500:
            return b.build_nacl_water_box(492, 10, 10)
        return b.build_water_box(1000)
    choices = []
    for pkg, b, kw in ((dn, jbuilders, {}), (dt, tbuilders,
                                            {"device": "cpu"})):
        system, _ = build(b)
        integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        ctx = pkg.Context(system, integ, precision="double", **kw)
        choices.append("dense" if ctx._cp_cfg is None else "cellpair")
        if pkg is dt:
            assert ctx._nb.strategy == choices[-1]
    assert choices[0] == choices[1]
    assert choices[1] == ("dense" if n_atoms <= 4096 else "cellpair")
    assert nonbonded.choose_strategy(n_atoms, dt.NonbondedForce.PME) \
        == choices[1]
    assert nonbonded.choose_strategy(10 ** 6,
                                     dt.NonbondedForce.NoCutoff) == "dense"
