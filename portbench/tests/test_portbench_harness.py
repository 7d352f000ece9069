"""The harness on the CPU (torch.cuda answering as a card, the fake_card
fixture): a cell, a traffic generator, an NPT mix and a system added as
files are found by name, the last line's keys, the import check, and
the refusal without a card."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

from conftest import ROOT, SMALL_TRAFFIC, add_cell, small_config
from portbench import guard, harness

ARGS = ["--workload", "small.nvt", "--seed", "3000000019",
        "--seconds", "0.1"]


def run_cpu(root, argv):
    """harness.main as run.py calls it (under the fake_card fixture):
    its exit code and its last line, parsed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.main(argv, root=root, t0=time.perf_counter())
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def test_cell_added_as_files_is_found_and_correct(small_root, fake_card):
    rc, res = run_cpu(small_root, ARGS + ["--trace", "0"])
    assert rc == 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert "breakdown" not in res
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"ns_per_day", "peak_mem_gib", "setup_s"}
    assert res["metrics"]["ns_per_day"]["value"] > 0
    for name, row in res["checks"].items():
        assert set(row) == {"value", "limit"}, name


def test_traced_line_has_breakdown_and_layer_metrics(small_root, fake_card):
    rc, res = run_cpu(small_root, ARGS + ["--trace", "1"])
    assert rc == 0 and res["correct"] is True, res["checks"]
    assert "breakdown" in res
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # no card: nothing on the device to read, so only the sync count
    assert set(res["metrics"]) == {"host_syncs_per_step"}
    assert "busy_s" in res["device"] and "window_s" in res["device"]


GENERATOR = '''"""A generator added as a file: md's traffic with the pairs'
relative motion at rest."""
from portbench.generators import md

validate = md.validate
prepare = md.prepare


def velocities(topology, traffic, n_replicas, seed):
    return md.velocities(topology, dict(traffic, relative_temperature_K=0.0),
                         n_replicas, seed)
'''


def test_generator_added_as_files_is_found(small_root, fake_card):
    with open(os.path.join(small_root, "portbench", "generators",
                           "md_still_pairs.py"), "w") as f:
        f.write(GENERATOR)
    add_cell(small_root, "small.still", small_config(),
             dict(SMALL_TRAFFIC, generator="md_still_pairs"))
    rc, res = run_cpu(small_root, ["--workload", "small.still", "--seed",
                                   "5", "--seconds", "0.1", "--trace", "0"])
    assert rc == 0 and res["correct"] is True, res["checks"]


def test_npt_mix_is_data_only(small_root, fake_card, monkeypatch):
    """An NPT mix is a traffic file: the barostat the generator adds
    moves the box within the run, and the end is checked in the
    program's own box."""
    from portbench import program
    boxes = []
    state = program.Program.state

    def spy(self):
        st = state(self)
        boxes.append(st["box"])
        return st
    monkeypatch.setattr(program.Program, "state", spy)
    npt = dict(SMALL_TRAFFIC, ensemble="NPT", chunk_steps=8,
               barostat={"pressure_bar": 1.01325, "temperature_K": 300.0,
                         "frequency": 3})
    add_cell(small_root, "small.npt", small_config(), npt)
    rc, res = run_cpu(small_root, ["--workload", "small.npt", "--seed",
                                   "4100000007", "--seconds", "0.1",
                                   "--trace", "0"])
    assert rc == 0 and res["correct"] is True, res["checks"]
    assert boxes[0][0, 0, 0] != boxes[-1][0, 0, 0]


def test_system_added_as_files_is_found(small_root, fake_card):
    """A configuration names its system module; a module added beside
    the others (here a copy) is found by that name."""
    shutil.copy(os.path.join(ROOT, "portbench", "systems",
                             "swm4ndp_water.py"),
                os.path.join(small_root, "portbench", "systems",
                             "water_copy.py"))
    cfg = dict(small_config(), name="swm4ndp_2k_copy", system="water_copy")
    add_cell(small_root, "small.copy", cfg, SMALL_TRAFFIC)
    rc, res = run_cpu(small_root, ["--workload", "small.copy", "--seed",
                                   "6", "--seconds", "0.1", "--trace", "0"])
    assert rc == 0 and res["correct"] is True, res["checks"]


def test_import_check_compares_whole_top_level_names():
    assert guard.loaded(["openmm_drudenose_tpu_torch",
                         "openmm_drudenose_tpu_torch.ops.sweep",
                         "jaxtyping", "numpy"]) == []
    assert guard.loaded(["openmm_drudenose_tpu.ops"]) == [
        "openmm_drudenose_tpu"]
    assert guard.loaded(["jax._src.core", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def test_forbidden_module_in_a_run_fails_it(small_root, fake_card,
                                            monkeypatch):
    monkeypatch.setitem(sys.modules, "openmm_drudenose_tpu",
                        type(sys)("openmm_drudenose_tpu"))
    rc, res = run_cpu(small_root, ARGS + ["--trace", "0"])
    assert rc != 0 and res is None


def test_without_a_card_the_command_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "water1m.nvt", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_only_benchmark_files_exit_nonzero(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ fails (no
    port to run), printing no result."""
    import shutil
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "data"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "flat128.nvt", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path,
                       env=dict(os.environ, PYTHONPATH=""),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
