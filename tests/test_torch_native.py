"""The port's native host runtime (utils/native.py, built from its own
copy of the C++ source) against the pure-Python paths: the four cases of
tests/test_native.py.  They skip only where there is no g++; with g++ a
library that fails to build fails them."""

import shutil

import numpy as np
import pytest

import util
from openmm_drudenose_tpu.app import serialization as jser
from openmm_drudenose_tpu.core import topology as jtopology
from openmm_drudenose_tpu_torch.app import serialization as tser
from openmm_drudenose_tpu_torch.core import topology
from openmm_drudenose_tpu_torch.io import pdbfile
from openmm_drudenose_tpu_torch.utils import native
from torch_threads import _one_thread  # noqa: F401


@pytest.fixture
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built here")
    out = native.get_lib()
    assert out is not None, native.build_error
    return out


def test_union_find_matches_python(lib):
    rng = np.random.default_rng(0)
    n = 5000
    edges = rng.integers(0, n, (4000, 2)).astype(np.int64)
    labels, n_mol = native.molecule_ids_native(n, edges)
    uf = jtopology.UnionFind(n)
    for a, b in edges:
        uf.union(int(a), int(b))
    remap = {}
    expect = np.empty(n, np.int32)
    for i in range(n):
        r = uf.find(i)
        if r not in remap:
            remap[r] = len(remap)
        expect[i] = remap[r]
    np.testing.assert_array_equal(labels, expect)
    assert n_mol == expect.max() + 1
    # the port's vectorised fallback numbers them alike
    _, ids = np.unique(topology.component_labels(n, edges),
                       return_inverse=True)
    np.testing.assert_array_equal(ids, expect)


def test_molecule_ids_uses_water_topology(lib):
    js, _ = util.swm4_water_box(grid_size=2)
    system = tser.deserialize_system(jser.serialize_system(js))
    ids = topology.molecule_ids(system)
    np.testing.assert_array_equal(ids, np.repeat(np.arange(8), 5))
    np.testing.assert_array_equal(ids, jtopology.molecule_ids(js))


def test_residue_masses_native(lib):
    rng = np.random.default_rng(1)
    resid = rng.integers(0, 50, 1000).astype(np.int32)
    masses = rng.uniform(0, 20, 1000)
    out = native.residue_masses_native(resid, masses, 50)
    expect = np.zeros(50)
    np.add.at(expect, resid, masses)
    np.testing.assert_allclose(out, expect, rtol=1e-12)


def test_pdb_parse_native_roundtrip(lib, tmp_path):
    pos = np.array([[0.1, 0.2, 0.3], [1.0, -0.5, 2.25]])
    path = str(tmp_path / "t.pdb")
    pdbfile.write_pdb(path, pos, box_nm=[3.0, 3.0, 3.0])
    coords, res_seq, names, res_names, box = native.parse_pdb_native(path)
    np.testing.assert_allclose(coords, pos, atol=1e-4)
    np.testing.assert_allclose(box, [3.0, 3.0, 3.0], atol=1e-4)
    p = pdbfile.PDBFile(path)
    np.testing.assert_allclose(p.getPositions(), coords, atol=1e-9)
