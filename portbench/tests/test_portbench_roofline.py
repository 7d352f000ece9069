"""The roofline's arithmetic: the pair count of the reference's cell
list against a brute-force count, and the least time of the 1M cell."""

import numpy as np
import pytest
import torch

from conftest import small_config
from portbench import roofline
from portbench.reference import forces, water


def brute_pairs(x, L, rc, n_mol):
    mol = np.arange(x.shape[0]) // 5
    n = 0
    for i in range(x.shape[0]):
        d = x[i + 1:] - x[i]
        d -= L * np.round(d / L)
        r2 = np.sum(d * d, 1)
        n += int(np.count_nonzero((r2 < rc * rc) & (mol[i + 1:] != mol[i])))
    return n


@pytest.mark.parametrize("n_mol", [400, 1600])
def test_pair_count_matches_brute_force(n_mol):
    cfg = small_config()
    cfg["n_molecules"] = n_mol
    w = water.from_config(cfg)
    rng = np.random.default_rng(n_mol)
    x = rng.uniform(-0.5, 1.5, size=(w.n0, 3)) * w.box
    field = forces.Field(w, cfg, "cpu")
    got = field.pair_count(torch.as_tensor(x)[None])
    assert got == brute_pairs(x, w.box, cfg["cutoff_nm"], n_mol)


def test_replicas_count_each_in_its_own_box():
    cfg = small_config()
    w = water.from_config(cfg)
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, size=(2, w.n0, 3)) * w.box
    field = forces.Field(w, cfg, "cpu")
    both = field.pair_count(torch.as_tensor(x))
    each = sum(field.pair_count(torch.as_tensor(x[r:r + 1]))
               for r in range(2))
    assert both == each


def test_least_time_of_the_1m_cell():
    # 362,426,198 pairs within 1 nm at 1M sites (chip_smoke.py phase 4)
    t, bound = roofline.least_time_s(362_426_198, 1_000_000)
    assert bound == "operations"
    assert t == pytest.approx(50 * 362_426_198 / 67e12)
    assert 2.6e-4 < t < 2.8e-4
    assert roofline.least_time_s(0, 1_000_000)[1] == "bytes"
    assert roofline.share_pct(362_426_198, 1_000_000, 0.0) is None
    assert roofline.share_pct(362_426_198, 1_000_000, 2 * t) == \
        pytest.approx(50.0)
