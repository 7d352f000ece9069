"""tools/make_snapshot.py (the port's scripts/make_bench_snapshot.py) on
the CPU at 216 waters and a few steps: the JAX keys and dtypes, the
refusal to write the JAX package's snapshot, the T_eff refusals, a run
that extends its snapshot; and the committed data/bench_equil_1m.npz,
which the tool made on the card, read with numpy alone (no 1M Context
here): its size, the rigid SWM4-NDP geometry, the Drudes inside their
wall and a warm liquid."""

import hashlib
import os

import numpy as np
import pytest

from openmm_drudenose_tpu_torch.io import builders
from openmm_drudenose_tpu_torch.tools import make_snapshot as ms
from openmm_drudenose_tpu_torch.tools import setups
from torch_threads import _one_thread  # noqa: F401

N_MOL, CUTOFF = 216, 0.5
SNAP_1M = os.path.join(setups.ROOT, "data", "bench_equil_1m.npz")
# the keys and dtypes scripts/make_bench_snapshot.py writes
JAX_KEYS = {"positions": np.float32, "velocities": np.float32,
            "n_atoms": np.int64, "equil_steps": np.int64,
            "potential_energy": np.float64, "capacity": np.int64}


@pytest.fixture(autouse=True)
def small(monkeypatch):
    """The tool cut to the CPU: a 0.5 nm cutoff (216 waters plan 6^3
    cells), 5 FIRE iterations, 8 steps of the fresh Context, no timed
    runs."""
    for name, value in (("CUTOFF", CUTOFF), ("MIN_ITERATIONS", 5),
                        ("SETTLE_STEPS", 8), ("TIMED_STEPS", 0)):
        monkeypatch.setattr(ms, name, value)


def _args(out, *extra):
    """216 waters, 8 steps of equilibration."""
    return ms.parse_args(["--atoms", str(5 * N_MOL), "--out", str(out),
                          "--equil-steps", "8", *extra])


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _quiet(msg):
    pass


@pytest.mark.parametrize("path", [
    setups.BENCH_SNAPSHOT,
    os.path.join(setups.ROOT, "data", "..", "data", "bench_equil_100k.npz")])
def test_refuses_the_jax_snapshot(path):
    before = _digest(setups.BENCH_SNAPSHOT)
    with pytest.raises(SystemExit, match="JAX package's snapshot"):
        ms.parse_args(["--out", path])
    assert _digest(setups.BENCH_SNAPSHOT) == before


def test_writes_the_jax_keys_and_extends(tmp_path, monkeypatch):
    """The file's keys and dtypes are the JAX script's; a second call on
    the same --out extends it (no minimization, the steps of both).  The
    T_eff band is widened here: a 216-water box 8 steps from a 5-iteration
    FIRE start is not a 300 K liquid (the band's refusals are the next
    tests')."""
    monkeypatch.setattr(ms, "T_EFF_BAND", (0.0, 1e4))
    out = tmp_path / "snap.npz"
    first = ms.make(_args(out), "cpu", log=_quiet)
    assert first["minimize"]["iterations"] == 5
    assert first["equil_steps"] == 8
    with np.load(out) as z:
        assert set(z.files) == set(JAX_KEYS)
        for k, dtype in JAX_KEYS.items():
            assert z[k].dtype == dtype, k
        assert z["positions"].shape == z["velocities"].shape \
            == (5 * N_MOL, 3)
        assert int(z["n_atoms"]) == 5 * N_MOL
        assert int(z["equil_steps"]) == 8
        assert int(z["capacity"]) == first["capacity"] \
            >= first["capacity_auto"]
        assert float(z["potential_energy"]) == first["potential_energy"]
        assert np.all(np.isfinite(z["positions"]))
        pos1 = z["positions"].copy()
    second = ms.make(_args(out), "cpu", log=_quiet)
    assert second["extended"] == 8 and "minimize" not in second
    with np.load(out) as z:
        assert int(z["equil_steps"]) == 16
        assert not np.array_equal(z["positions"], pos1)


def test_a_hot_fresh_start_is_refused(tmp_path):
    """5 FIRE iterations leave the lattice's energy to heat the box past
    330 K within 8 steps: refused, nothing written."""
    out = tmp_path / "snap.npz"
    with pytest.raises(SystemExit, match="not equilibrated"):
        ms.make(_args(out), "cpu", log=_quiet)
    assert not out.exists()


def test_a_cold_start_is_refused(tmp_path):
    """A snapshot at rest extended by no steps reads T_eff ~ 0 K:
    refused, and the file is left as it was."""
    _, pos = builders.build_water_box(N_MOL, cutoff=CUTOFF)
    out = tmp_path / "snap.npz"
    np.savez_compressed(out, positions=pos.astype(np.float32),
                        velocities=np.zeros_like(pos, np.float32),
                        n_atoms=np.int64(5 * N_MOL), equil_steps=np.int64(0),
                        potential_energy=np.float64(0.0),
                        capacity=np.int64(16))
    before = _digest(out)
    with pytest.raises(SystemExit, match="not equilibrated: T_eff 0.0 K"):
        ms.make(_args(out, "--equil-steps", "0"), "cpu", log=_quiet)
    assert _digest(out) == before


def test_tile_fills_the_larger_box(tmp_path):
    """27 waters tiled 2 x 2 x 2 give 216 in build_water_box(216)'s box:
    copy (i, j, l) shifted by (i, j, l) times the small box, the
    velocities repeated; a count that is no cube is refused."""
    _, pos = builders.build_water_box(27)
    vel = np.random.default_rng(3).normal(size=pos.shape)
    small = tmp_path / "small.npz"
    np.savez_compressed(small, positions=pos.astype(np.float32),
                        velocities=vel.astype(np.float32),
                        n_atoms=np.int64(135), equil_steps=np.int64(0),
                        potential_energy=np.float64(0.0),
                        capacity=np.int64(16))
    p, v, k = ms.tile(str(small), 5 * N_MOL)
    box27 = np.array(builders.water_box_lattice(27)[2])
    box216 = np.array(builders.water_box_lattice(N_MOL)[2])
    assert k == 2 and p.shape == v.shape == (5 * N_MOL, 3)
    np.testing.assert_allclose(box216, 2 * box27, rtol=1e-12)
    p32 = pos.astype(np.float32).astype(np.float64)
    np.testing.assert_array_equal(p[:135], p32)
    np.testing.assert_allclose(p[-135:], p32 + box27, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(v[-135:], vel.astype(np.float32))
    with pytest.raises(SystemExit, match="no cube"):
        ms.tile(str(small), 5 * 100)


def test_tool_exits_without_cuda(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert ms.main(["--out", str(tmp_path / "s.npz")]) == 1


@pytest.fixture(scope="module")
def snap_1m():
    with np.load(SNAP_1M) as z:
        return {k: z[k] for k in z.files}


def test_committed_1m_snapshot_keys_and_size(snap_1m):
    """1,000,000 atoms, the JAX keys and dtypes, finite float32, at most
    22 MB on disk."""
    assert set(snap_1m) == set(JAX_KEYS)
    for k, dtype in JAX_KEYS.items():
        assert snap_1m[k].dtype == dtype, k
    assert int(snap_1m["n_atoms"]) == 1_000_000
    for k in ("positions", "velocities"):
        assert snap_1m[k].shape == (1_000_000, 3)
        assert np.all(np.isfinite(snap_1m[k]))
    assert np.isfinite(float(snap_1m["potential_energy"]))
    assert int(snap_1m["equil_steps"]) >= 4000
    assert os.path.getsize(SNAP_1M) <= 22e6


def test_committed_1m_snapshot_geometry(snap_1m):
    """Positions within 1 nm of build_water_box(200000)'s box (the
    snapshot is unwrapped), each molecule's O-H and H-H distances at
    SWM4-NDP's rigid geometry to 1e-4 nm, each Drude inside the 0.02 nm
    wall of its oxygen to a relative 1e-5."""
    _, _, box = builders.water_box_lattice(200_000)
    p = snap_1m["positions"].astype(np.float64).reshape(-1, 5, 3)
    assert np.all(p >= -1.0) and np.all(p <= np.array(box) + 1.0)
    oh1 = np.linalg.norm(p[:, 2] - p[:, 0], axis=1)
    oh2 = np.linalg.norm(p[:, 3] - p[:, 0], axis=1)
    hh = np.linalg.norm(p[:, 3] - p[:, 2], axis=1)
    assert np.max(np.abs(oh1 - builders.SWM4_D_OH)) <= 1e-4
    assert np.max(np.abs(oh2 - builders.SWM4_D_OH)) <= 1e-4
    assert np.max(np.abs(hh - builders.SWM4_D_HH)) <= 1e-4
    od = np.linalg.norm(p[:, 1] - p[:, 0], axis=1)
    assert np.max(od) <= 0.02 * (1 + 1e-5)


def test_committed_1m_snapshot_is_warm(snap_1m):
    """T_eff = 2 KE / (6 n_mol k_B) from the velocities and the SWM4-NDP
    masses (the M site massless) within the tool's 270-330 K."""
    m = np.array([builders.SWM4_O_MASS, builders.SWM4_D_MASS,
                  builders.SWM4_H_MASS, builders.SWM4_H_MASS, 0.0])
    v = snap_1m["velocities"].astype(np.float64).reshape(-1, 5, 3)
    ke = 0.5 * float(np.sum(m[None, :, None] * v * v))
    assert 270.0 < ms.t_eff(ke, 200_000) < 330.0
