"""The port's CMAPTorsionForce (forces/cmap.py) against the JAX package
in float64 on the CPU: the bicubic patch coefficients, energies to
1e-10 and the analytic forces to 1e-8 against JAX autodiff (random
chains, both angles on grid knots, the +-pi seam, two maps of different
sizes), float32 from the compensated positions, the XML round trip and
the flat-ensemble replication."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_drudenose_tpu_torch as dt
import test_cmap as jcmap
from openmm_drudenose_tpu.forces import cmap as jcm
from openmm_drudenose_tpu_torch.forces import cmap as tcm
from torch_threads import _one_thread  # noqa: F401


def _pair(maps, torsions):
    out = []
    for mod in (jcm, tcm):
        f = mod.CMAPTorsionForce()
        for n, scale in maps:
            f.addMap(n, scale * jcmap._surface_map(n))
        for t in torsions:
            f.addTorsion(*t)
        out.append(f)
    return out


def _port(f, pos, dtype=torch.float64, exact=None):
    term = f.compile(None, dtype, "cpu")
    e, forces = term.energy_forces(torch.tensor(pos, dtype=dtype),
                                   exact=exact)
    return float(e), forces.double().numpy()


def test_map_coefficients_are_the_jax_ones():
    for n in (8, 12, 24):
        E = jcmap._surface_map(n).reshape(n, n, order="F")
        np.testing.assert_array_equal(tcm._map_coefficients(E),
                                      jcm._map_coefficients(E))


CHAINS = {"random": lambda: jcmap._chain_positions(
    np.random.default_rng(5)), "knots": lambda: jcmap._chain_positions(
        planar=True)}


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("maps", [((16, 1.0),), ((8, 1.0), (12, 2.0))],
                         ids=["one_map", "two_maps"])
def test_cmap_energy_and_forces_equal_jax(chain, maps):
    torsions = [(m, 0, 1, 2, 3, 1, 2, 3, 4) for m in range(len(maps))]
    fj, ft = _pair(maps, torsions)
    pos = CHAINS[chain]()
    e_j, f_j = jcmap._energy_of(fj, pos)
    e_t, f_t = _port(ft, pos)
    assert e_t == pytest.approx(e_j, rel=1e-10, abs=1e-12)
    np.testing.assert_allclose(f_t, f_j, rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(f_j)))


def test_cmap_seam_and_float32_from_exact():
    fj, ft = _pair(((12, 1.0),), [(0, 0, 1, 2, 3, 1, 2, 3, 4)])
    base = jcmap._chain_positions(planar=True)
    for dz in (-1e-7, 0.0, 1e-7):
        pos = base.copy()
        pos[4, 2] += dz
        e_j, f_j = jcmap._energy_of(fj, pos)
        e_t, f_t = _port(ft, pos)
        assert e_t == pytest.approx(e_j, rel=1e-10, abs=1e-12)
        np.testing.assert_allclose(f_t, f_j, rtol=1e-8, atol=1e-8)
    # float32: evaluated in float64 from the compensated positions
    pos = jcmap._chain_positions(np.random.default_rng(9)) + 7.3
    e_j, f_j = jcmap._energy_of(fj, pos)
    e_t, f_t = _port(ft, pos, torch.float32, exact=torch.tensor(pos))
    assert e_t == pytest.approx(e_j, rel=1e-6)
    np.testing.assert_allclose(f_t, f_j, rtol=0,
                               atol=1e-6 * np.max(np.abs(f_j)))


def test_cmap_xml_round_trip_and_replication():
    from openmm_drudenose_tpu.app import serialization as jser
    from openmm_drudenose_tpu.parallel.flatrep import \
        _replicate_force as jrep
    from openmm_drudenose_tpu_torch.app import serialization as tser
    from openmm_drudenose_tpu_torch.parallel.flatrep import \
        _replicate_force as trep
    import openmm_drudenose_tpu as dn
    fj, ft = _pair(((8, 1.0), (12, 2.0)), [(0, 0, 1, 2, 3, 1, 2, 3, 4),
                                           (1, 1, 2, 3, 4, 0, 1, 2, 3)])
    sj, st = dn.System(), dt.System()
    for s, f in ((sj, fj), (st, ft)):
        for _ in range(5):
            s.addParticle(12.0)
        s.addForce(f)
    xml = tser.serialize_system(st)
    assert xml == jser.serialize_system(sj)
    back = tser.deserialize_system(xml).getForces()[0]
    pos = jcmap._chain_positions(np.random.default_rng(2))
    assert _port(back, pos)[0] == _port(ft, pos)[0]
    gj, gt = jrep(fj, R=3, n0=5), trep(ft, R=3, n0=5)
    assert gt._torsions == gj._torsions
    assert [m[0] for m in gt._maps] == [m[0] for m in gj._maps]
