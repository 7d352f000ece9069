"""The DCD and PDB reporters and the profiling helpers of the PyTorch
port, on the CPU: the ports of tests/test_reporters.py (the triclinic
and orthorhombic DCD round trips, the reporter's full box, the
step_breakdown keys), the DCD bytes against the JAX writer's for the
same frames (all but the title, which names the port), and the PDB
reporter's models against the JAX package's writer."""

import io
import os

import numpy as np
import pytest
import torch

import openmm_drudenose_tpu_torch as dt
import util
from openmm_drudenose_tpu.app import serialization as jser
from openmm_drudenose_tpu.io import dcd as jdcd
from openmm_drudenose_tpu.io import pdbfile as jpdb
from openmm_drudenose_tpu_torch.app import serialization as tser
from openmm_drudenose_tpu_torch.io import dcd as tdcd
from openmm_drudenose_tpu_torch.io import pdbfile as tpdb
from openmm_drudenose_tpu_torch.utils import profiling
from torch_threads import _one_thread  # noqa: F401

TRI_BOX = np.array([[3.0, 0.0, 0.0],
                    [0.9, 2.8, 0.0],
                    [-0.6, 0.7, 2.5]])


def _water():
    """tests/util.py's SWM4-NDP box (grid 2) as a port System."""
    js, pos = util.swm4_water_box(grid_size=2)
    return tser.deserialize_system(jser.serialize_system(js)), pos


def _write(writer_cls, path, frames, box):
    w = writer_cls(path, dt_ps=0.002, interval=5)
    for p in frames:
        w.write_frame(p, box)
    w.close()
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("box", [TRI_BOX, np.array([2.0, 3.0, 4.0])],
                         ids=["triclinic", "orthorhombic"])
def test_dcd_bytes_match_jax(tmp_path, box):
    """The same frames give the JAX writer's bytes, the title record's
    80 bytes apart (header, AKMA step, cells, coordinates, frame
    count)."""
    pos = np.random.default_rng(0).uniform(0, 2.5, (7, 3))
    frames = [pos, pos + 0.1, pos - 0.2]
    ref = _write(jdcd.DCDWriter, str(tmp_path / "j.dcd"), frames, box)
    got = _write(tdcd.DCDWriter, str(tmp_path / "t.dcd"), frames, box)
    assert len(got) == len(ref)
    # header block: 4 + 84 + 4 bytes; then the title block's length,
    # count and 80 title bytes
    title = slice(92 + 8, 92 + 8 + 80)
    assert got[title].startswith(b"Created by openmm_drudenose_tpu_torch")
    assert got[:title.start] == ref[:title.start]
    assert got[title.stop:] == ref[title.stop:]


def test_dcd_triclinic_cell_roundtrip(tmp_path):
    """A sheared box's (a, b, c) and angle cosines survive the round
    trip, the shear recorded."""
    path = str(tmp_path / "tri.dcd")
    pos = np.random.default_rng(0).uniform(0, 2.5, (7, 3))
    w = tdcd.DCDWriter(path)
    w.write_frame(pos, TRI_BOX)
    w.write_frame(pos + 0.1, TRI_BOX)
    w.close()
    frames, cells, info = tdcd.read_dcd(path)
    assert info["n_frames"] == 2 and info["unit_cell"] == 1
    assert info["delta"] == pytest.approx(0.001 / 0.04888821, rel=1e-6)
    n = np.linalg.norm(TRI_BOX, axis=1)
    a, b, c, cg, cb, ca = cells[0]
    np.testing.assert_allclose([a, b, c], n, rtol=1e-12)
    np.testing.assert_allclose(
        [ca, cb, cg], [TRI_BOX[1] @ TRI_BOX[2] / (n[1] * n[2]),
                       TRI_BOX[0] @ TRI_BOX[2] / (n[0] * n[2]),
                       TRI_BOX[0] @ TRI_BOX[1] / (n[0] * n[1])], rtol=1e-12)
    assert abs(cg) > 0.01
    np.testing.assert_allclose(frames[0], pos, atol=1e-5)
    np.testing.assert_allclose(frames[1], pos + 0.1, atol=1e-5)


def test_dcd_orthorhombic_diag(tmp_path):
    path = str(tmp_path / "ortho.dcd")
    w = tdcd.DCDWriter(path)
    w.write_frame(np.zeros((3, 3)), np.array([2.0, 3.0, 4.0]))
    w.close()
    _, cells, _ = tdcd.read_dcd(path)
    assert tuple(cells[0]) == (2.0, 3.0, 4.0, 0.0, 0.0, 0.0)


def _simulation():
    system, pos = _water()
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001)
    sim = dt.Simulation(None, system, integ, device="cpu")
    sim.context.setPositions(pos)
    sim.context.setVelocitiesToTemperature(300.0, seed=0)
    return sim, system


def test_dcd_reporter_passes_full_box(tmp_path):
    path = str(tmp_path / "sim.dcd")
    sim, system = _simulation()
    sim.reporters.append(dt.DCDReporter(path, 2))
    sim.step(4)
    sim.reporters[0].close()
    frames, cells, info = tdcd.read_dcd(path)
    assert frames.shape == (2, system.getNumParticles(), 3)
    assert info["n_frames"] == 2
    box = np.asarray(system.getDefaultPeriodicBoxVectors())
    np.testing.assert_allclose(cells[0, :3], np.diag(box), rtol=1e-6)
    np.testing.assert_allclose(
        frames[1], sim.context.getState(positions=True).getPositions(),
        atol=1e-5)


def test_pdb_reporter_models_match_jax_writer(tmp_path):
    """The PDB reporter writes one MODEL a report, each the JAX package's
    write_model text of the same positions, read back by PDBFile."""
    path = str(tmp_path / "sim.pdb")
    sim, system = _simulation()
    sim.reporters.append(dt.PDBReporter(path, 3))
    seen = []
    for _ in range(2):
        sim.step(3)
        seen.append(sim.context.getState(positions=True).getPositions())
    text = open(path).read()
    ref = io.StringIO()
    for k, p in enumerate(seen):
        jpdb.write_model(ref, p, None, model=k + 1)
    assert text == ref.getvalue()
    assert text.count("MODEL") == 2 and text.count("ENDMDL") == 2
    last = tpdb.PDBFile(path).getPositions()
    np.testing.assert_allclose(np.asarray(last)[:len(seen[0])], seen[0],
                               atol=1e-4)


def test_step_breakdown_keys_and_state_kept():
    """step_breakdown returns the time of each part, > 0, and leaves the
    Context's state as it was."""
    system, pos = _water()
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001)
    ctx = dt.Context(system, integ, precision="double", device="cpu")
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, seed=0)
    before = ctx._state.positions.clone()
    out = profiling.step_breakdown(ctx, n=2)
    for key in ("step", "forces", "energy", "kinematics"):
        assert key in out and out[key] > 0.0
    assert torch.equal(ctx._state.positions, before)
    assert profiling.measure_steps_per_second(ctx, integ, 2, 1, 1) > 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    system, pos = _water()
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001)
    ctx = dt.Context(system, integ, precision="double", device="cpu")
    ctx.setPositions(pos)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        integ.step(2)
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert len(prof.key_averages()) > 0
    timer = profiling.Timer()
    with timer.phase("steps", sync=ctx._state.positions):
        integ.step(1)
    assert "steps" in timer.report()
