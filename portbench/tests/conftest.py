"""Fixtures of the benchmark's own tests (CPU; a card where marked gpu).

    python -m pytest portbench/tests -q

The small cell: 400 SWM4-NDP waters (2,000 sites, a 2.29 nm box) from
portbench/data/test_template_2k.npz on one Context on the CPU (the dense
pair strategy at this size), under a traffic mix of a few steps.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL_TRAFFIC = {"generator": "md", "ensemble": "NVT",
                 "temperature_K": 300.0, "relative_temperature_K": 1.0,
                 "chunk_steps": 4, "check_steps": 2, "warm_steps": 4,
                 "trace_steps": 4, "label_steps": 2, "sync_steps": 2}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_config() -> dict:
    from portbench import program
    with open(os.path.join(ROOT, "portbench", "configs",
                           "swm4ndp_1m.json")) as f:
        cfg = json.load(f)
    path = "portbench/data/test_template_2k.npz"
    cfg.update(name="swm4ndp_2k_test", n_molecules=400, replicas=1,
               pme_grid=[20, 20, 20], cell_grid=None, route=None,
               inputs={"kind": "template", "path": path,
                       "sha256": program.sha256(os.path.join(ROOT, path))})
    return cfg


def add_cell(root, name, config, traffic, limits_of="water1m.nvt"):
    """Adds the cell `name` of configuration `config` (a dict, written as
    portbench/configs/<its name>.json) and traffic `traffic` (a dict,
    portbench/traffic/<name>.json) to the checkout at `root`, with the
    limits of `limits_of`: new files and entries, no file of the
    benchmark edited but BENCHMARK.json."""
    root = str(root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfile = f"portbench/configs/{config['name']}.json"
    if config["name"] not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({"name": config["name"], "source": "test",
                                 "file": cfile, "reduced": [],
                                 "why": "test"})
    bench["workloads"].append({"name": name, "config": config["name"],
                               "traffic": name, "chips": 1, "why": "test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(root, cfile), "w") as f:
        json.dump(config, f)
    with open(os.path.join(root, "portbench", "traffic", name + ".json"),
              "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(ROOT, "portbench", "workloads",
                           limits_of + ".json")) as f:
        limits = json.load(f)
    with open(os.path.join(root, "portbench", "workloads", name + ".json"),
              "w") as f:
        json.dump(limits, f)


@pytest.fixture
def small_root(tmp_path):
    """A checkout holding BENCHMARK.json with one small cell, the
    benchmark's files and the small template, where the small cell's
    files are added beside the others (no file edited)."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    add_cell(tmp_path, "small.nvt", small_config(), SMALL_TRAFFIC)
    return str(tmp_path)


@pytest.fixture
def fake_card(monkeypatch):
    """The harness run on the CPU: torch.cuda answers as one card that
    synchronises nothing and peaks at 0 bytes, the program runs on the
    CPU, and the port's kernel build is skipped."""
    import torch
    from openmm_drudenose_tpu_torch.ops import sweep
    from portbench import harness
    monkeypatch.setattr(harness, "DEVICE", "cpu")
    monkeypatch.setattr(harness, "card_line", lambda: "cpu")
    monkeypatch.setattr(sweep, "build", lambda *a, **kw: None)
    for name, fn in (("is_available", lambda: True),
                     ("device_count", lambda: 1),
                     ("synchronize", lambda *a, **kw: None),
                     ("max_memory_allocated", lambda *a, **kw: 0),
                     ("empty_cache", lambda: None),
                     ("get_device_name", lambda *a, **kw: "cpu"),
                     ("set_sync_debug_mode", lambda mode: None)):
        monkeypatch.setattr(torch.cuda, name, fn)


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
