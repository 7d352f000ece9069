"""The replica-band path of the two TPU kernels, in interpret mode on the
CPU, against the port's plain versions of kernels B1 and B2 in float32
(2e-5 of max|F|): pair_forces_pallas on a 2 x 2 ensemble of
tests/test_flatrep.py's random LJ replicas (its per-band layer index
lay_idx), and pair_forces_pallas_chunked on a 1 x 5 ensemble whose
(y, z) plane the chunked kernel takes (its per-band z wrap pz and x
wrap px).  A file of its own: each interpret run takes ~100 s beside
five other test workers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_drudenose_tpu.forces import cellpair as jcp
from openmm_drudenose_tpu.ops import pallas_sweep as jps
from openmm_drudenose_tpu_torch.forces import cellpair as tcp
from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0

from test_torch_flatrep import ALPHA, CUTOFF, L, N0, lj_ensemble
from torch_threads import _one_thread  # noqa: F401


@pytest.mark.parametrize("version", ["b1", "b2"])
def test_plain_versions_match_jax_pallas_interpret(version):
    if version == "b1":
        box, rx, rz = (L, L, L), 2, 2
    else:
        # gy = 6 and 25 z cells: the chunk height 6 fills 150 lanes
        box, rx, rz = (L, 1.9, L), 1, 5
    R = rx * rz
    pos, q, sig, eps, (ti, tj), (ei, ej) = lj_ensemble(R, seed=40, box=box)
    jc = jcp.make_ensemble_config(CUTOFF, list(box), N0, R, ti, tj, rx=rx,
                                  rz=rz, skin=0.1, capacity=16)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    params = {"charge": f32(q), "sigma": f32(sig), "eps": f32(eps),
              "excl_words": jnp.asarray(jcp.build_exclusion_words(
                  R * N0, ei, ej, jc.excl_window, jc.excl_words))}
    jpos, jbox = f32(pos), f32(box)
    nbl = jcp.build_cellsort(jpos, jbox, jc)
    assert not bool(nbl.overflow)
    kw = dict(alpha=ALPHA, coulomb_scale=ONE_4PI_EPS0, interpret=True)
    if version == "b1":
        # interpret mode needs none of supports()'s Mosaic lane rules
        # (the JAX package's own tests/test_flatrep.py calls it so)
        f_ref = jps.pair_forces_pallas(params, jpos, jbox, nbl, jc,
                                       "ewald", **kw)
    else:
        cy = jps.choose_chunk(jc, jnp.float32, force=True)
        assert cy == 6
        f_ref = jps.pair_forces_pallas_chunked(params, jpos, jbox, nbl, jc,
                                               "ewald", cy, **kw)
    f_ref = np.asarray(f_ref, np.float64)

    tc = tcp.make_ensemble_config(CUTOFF, list(box), N0, R, ti, tj, rx=rx,
                                  rz=rz, capacity=16)
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    tparams = {"charge": t32(q), "sigma": t32(sig), "eps": t32(eps),
               "excl_words": torch.as_tensor(tcp.build_exclusion_words(
                   R * N0, ei, ej, tc.excl_window, tc.excl_words))}
    tpos, tbox = t32(pos), t32(box)
    tnbl = tcp.build_cellsort(tpos, tbox, tc)
    np.testing.assert_array_equal(tnbl.slot_atom.numpy(),
                                  np.asarray(nbl.slot_atom))
    fields = tcp.sorted_fields(tparams, tpos, tbox, tnbl, tc)
    args = (fields, tc, tcp.offset_shifts(tc, tbox), ALPHA, ONE_4PI_EPS0)
    kernel = sweep if version == "b1" else sweep_chunked
    f = kernel.pair_forces(*args)[tnbl.inv_slot].double().numpy()
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=2e-5 * np.abs(f_ref).max())
