"""The port's step reads nothing back: the NH chain's state and constants
on the Context's device, and a step loop that converts nothing between
the host and the device but the one latch read a chunk.

On the CPU there is no stream to wait for, so the step loop's host
round trips are counted instead: every numpy (or Python) to tensor
conversion (torch.as_tensor, torch.tensor, torch.from_numpy,
torch.asarray of anything but a tensor) and every .cpu(), .numpy(),
.item(), .tolist() and bool() / float() / int() of a tensor, each a
wait for the stream on a card.  A small cell-pair water box in single
precision (the main path's strategy and kernels' plain versions) is
stepped 2 x 16 steps after a warm-up: two chunks, so two latch reads
(one .tolist() each) and nothing else.  On the card, chip_smoke.py runs
a 128-step chunk of the 100k main path under
torch.cuda.set_sync_debug_mode("error").

Then the chain state on the Context's device through a checkpoint round
trip, getState's group temperatures and getConservedEnergy against the
JAX Context on the same state, and the committed 100k checkpoints (the
port's data/drift_100k_state_torch.npz and the JAX package's
data/drift_100k_state.npz) loaded into the bench Context."""

import collections
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu.io import builders as jbuilders
from openmm_drudenose_tpu_torch import convert
from openmm_drudenose_tpu_torch.app import serialization
from openmm_drudenose_tpu_torch.io import builders as tbuilders
from openmm_drudenose_tpu_torch.tools import measure_drift as md
from openmm_drudenose_tpu_torch.tools import setups
from torch_threads import _one_thread  # noqa: F401

CHAIN = ("eta", "eta_dot", "eta_dot_dot", "ke_sum", "group_ke")
SPEC_CHAIN = ("nh_nkbt", "nh_eta_mass", "nh_kbt_chain", "nh_link_active")
TORCH_STATE = os.path.join(setups.ROOT, "data", "drift_100k_state_torch.npz")
TORCH_CSV = os.path.join(setups.ROOT, "data", "drift_100k_samples_torch.csv")


def _integrator(pkg):
    integ = pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    return integ


def _host_conversions(monkeypatch):
    """Count the host round trips (module docstring) from now on."""
    calls = collections.Counter()

    def wrap(owner, name, only_host_data):
        fn = getattr(owner, name)

        def counted(*a, **k):
            if not (only_host_data and isinstance(a[0], torch.Tensor)):
                calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(owner, name, counted)

    for name in ("as_tensor", "tensor", "from_numpy", "asarray"):
        wrap(torch, name, True)
    for name in ("cpu", "numpy", "item", "tolist", "__bool__", "__float__",
                 "__int__"):
        wrap(torch.Tensor, name, False)
    return calls


def test_step_loop_reads_nothing_back(monkeypatch):
    system, pos = tbuilders.build_water_box(216, cutoff=0.6, ewald_tol=5e-3)
    integ = _integrator(dt)
    ctx = dt.Context(system, integ, precision="single", strategy="cellpair",
                     device="cpu")
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, seed=2)
    integ.step(16)                      # the first pass, sort and tables
    assert ctx._cp_cfg.rebuild_interval * 8 >= 16
    calls = _host_conversions(monkeypatch)
    integ.step(16)
    integ.step(16)
    monkeypatch.undo()
    assert dict(calls) == {"tolist": 2}, dict(calls)
    st = ctx._state
    assert st.step == 48
    assert np.all(np.isfinite(st.positions.numpy()))


def _water_pair():
    """JAX and port Contexts (f64, dense) of one 64-water box at the same
    positions and velocities."""
    jsys, pos = jbuilders.build_water_box(64, cutoff=0.5)
    tsys, _ = tbuilders.build_water_box(64, cutoff=0.5)
    vel = np.random.default_rng(4).normal(0.0, 0.3, pos.shape)
    out = []
    for pkg, system, kw in ((dn, jsys, {}), (dt, tsys, {"device": "cpu"})):
        integ = _integrator(pkg)
        ctx = pkg.Context(system, integ, precision="double",
                          strategy="dense", **kw)
        ctx.setPositions(pos)
        ctx.setVelocities(vel)
        out.append((ctx, integ))
    return out


def _on_device(ctx):
    dev = torch.device(ctx._device)
    for name in CHAIN:
        assert getattr(ctx._state, name).device == dev, name
    for name in SPEC_CHAIN:
        assert getattr(ctx._spec, name).device == dev, name


def test_chain_state_through_checkpoint_and_queries(tmp_path):
    """The chain on the Context's device after steps and after a
    checkpoint round trip (the same bits, and the next steps the same);
    getState's group temperatures and getConservedEnergy against the JAX
    Context's given the same state (f64)."""
    (jctx, _), (tctx, tint) = _water_pair()
    _on_device(tctx)
    tint.step(16)
    _on_device(tctx)
    path = os.path.join(tmp_path, "chk.npz")
    serialization.save_checkpoint(path, tctx)
    (_, _), (tctx2, tint2) = _water_pair()
    serialization.load_checkpoint(path, tctx2)
    _on_device(tctx2)
    for name in CHAIN:
        assert torch.equal(getattr(tctx2._state, name),
                           getattr(tctx._state, name)), name
    tint.step(8)
    tint2.step(8)
    assert torch.equal(tctx2._state.positions, tctx._state.positions)
    for name in CHAIN:
        assert torch.equal(getattr(tctx2._state, name),
                           getattr(tctx._state, name)), name

    st = tctx._state
    fields = {name: jnp.asarray(getattr(st, name).numpy())
              for name in ("positions", "velocities") + CHAIN}
    jctx._state = jctx._state._replace(
        step=jnp.asarray(st.step, jctx._state.step.dtype), **fields)
    jctx._ke_valid = True
    tg = tctx.getState(groups=True, energy=True)
    jg = jctx.getState(groups=True, energy=True)
    np.testing.assert_allclose(tg.getGroupTemperatures(),
                               np.asarray(jg.getGroupTemperatures()),
                               rtol=1e-12)
    np.testing.assert_allclose(tg.getKineticEnergy(),
                               float(jg.getKineticEnergy()), rtol=1e-12)
    np.testing.assert_allclose(tctx.getConservedEnergy(),
                               float(jctx.getConservedEnergy()),
                               rtol=1e-10)


def test_committed_checkpoints_load_onto_the_context_device():
    """The port's 100k drift checkpoint (load_checkpoint) and the JAX
    package's (convert.load_jax_checkpoint) put the chain on the bench
    Context's device, each the file's values; the port's reads the last
    temperatures of its committed series."""
    ctx, _ = setups.bench_context("cpu")
    serialization.load_checkpoint(TORCH_STATE, ctx)
    _on_device(ctx)
    raw = np.load(TORCH_STATE)
    for name in CHAIN:
        np.testing.assert_array_equal(getattr(ctx._state, name).numpy(),
                                      raw[f"state.{name}"], err_msg=name)
    last = md.read_csv(TORCH_CSV)[-1]
    with open(TORCH_STATE + ".ps") as f:
        assert int(f.read()) == int(last[0])
    np.testing.assert_allclose(md.temperatures(ctx), last[1:], rtol=0,
                               atol=1e-4)
    convert.load_jax_checkpoint(md.JAX_STATE, ctx)
    _on_device(ctx)
    d = convert.read_jax_checkpoint(md.JAX_STATE)
    for name in CHAIN:
        np.testing.assert_array_equal(getattr(ctx._state, name).numpy(),
                                      d[name], err_msg=name)
    assert ctx._state.step == 331000


@pytest.mark.parametrize("precision", ["single", "double"])
def test_chain_kernel_refuses_nothing_on_cpu(precision):
    """On the CPU the wrapper takes the plain version (no launch is
    counted) whatever the chain's type."""
    from openmm_drudenose_tpu_torch.ops import nh_chain
    system, pos = tbuilders.build_water_box(27, cutoff=0.4)
    integ = _integrator(dt)
    ctx = dt.Context(system, integ, precision=precision, strategy="dense",
                     device="cpu")
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, seed=1)
    before = nh_chain.launches["nh_chain"]
    integ.step(4)
    assert nh_chain.launches["nh_chain"] == before
    assert ctx._state.eta.dtype == ctx._prec.accum
    assert np.all(np.isfinite(ctx._state.group_ke.numpy()))
