"""The distributed PME reciprocal sum of the PyTorch port
(parallel/distfft.py: x-slab 2D FFTs, an all_to_all to y-pencils, the
1D FFT over x, and the inverse path back to the potential's x-slabs) on
CPU gloo ranks, in f64: the counterpart of tests/test_sharded.py::
test_sharded_distributed_fft_matches_plain.  The energy and the
potential grid of a random charge grid against the replicated sum
(forces/pme.py); the sharded force pass with distributed_fft=True
against the port's replicated pass and the JAX package's distfft route
(make_sharded_energy_and_forces(distributed_fft=True) on 2 of conftest's
virtual devices: 2 is the largest of its 8, 4, 2 that divides the 30^3
PME grid), on test_torch_sharded.py's box.  Tolerances: energies 1e-10
relative, forces and potentials 1e-8 of their max (ROADMAP.md)."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import openmm_drudenose_tpu as dn
import torch_ranks
from openmm_drudenose_tpu.parallel import sharded as jsharded
from test_torch_sharded import _inputs, _jax_context
from torch_threads import _one_thread  # noqa: F401

RANKS = 2


@pytest.mark.parametrize("ranks", [2, 3])
def test_pencil_fft_matches_replicated_sum(ranks):
    grid, box = (12, 6, 10), (2.1, 1.9, 2.3)
    got = torch_ranks.launch(torch_ranks.distfft_grid, ranks, grid, box, 7)
    for out in got:
        np.testing.assert_allclose(out["e"], out["e_ref"], rtol=1e-10)
        assert out["e_only"] == out["e"] and out["none"] is None
        scale = np.abs(out["phi_ref"]).max()
        np.testing.assert_allclose(out["phi"], out["phi_ref"],
                                   atol=1e-8 * scale)
        assert out["phi"].tobytes() == got[0]["phi"].tobytes()


def test_distributed_fft_force_pass():
    jctx, _, system = _jax_context(dn.NonbondedForce.PME)
    fut = torch_ranks.launch_beside(torch_ranks.sharded_pass, RANKS,
                                    *_inputs(jctx, system),
                                    {"grid_x_multiple": RANKS}, True, 0)
    st = jctx._state
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("atom",))
    with mesh:
        pe, f = jax.jit(jsharded.make_sharded_energy_and_forces(
            jctx, mesh, distributed_fft=True))(st.positions, st.box,
                                               st.neighbors)
    pe, f = float(pe), np.asarray(f)
    got = fut.result()
    scale = np.abs(f).max()
    for out in got:
        np.testing.assert_allclose(out["e"], pe, rtol=1e-10)
        np.testing.assert_allclose(out["f"], f, atol=1e-8 * scale)
        np.testing.assert_allclose(out["e"], out["e1"], rtol=1e-10)
        np.testing.assert_allclose(out["f"], out["f1"], atol=1e-8 * scale)
        assert out["f"].tobytes() == got[0]["f"].tobytes()
