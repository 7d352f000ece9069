"""The comparison fails what it must: the control (the reference in
float32 with TF32 products in the program's place) against the cells'
limits, and runs of the harness with the timed path broken underneath
(the look for a card skipped, on the CPU, at the small size)."""

import json
import os

import pytest
import torch

from conftest import ROOT, SMALL_TRAFFIC, small_config
from test_portbench_harness import ARGS, run_cpu
from portbench import check, program
from portbench.generators import md
from portbench.systems import swm4ndp_water



@pytest.mark.parametrize("cell", ["water1m.nvt", "flat128.nvt"])
def test_control_fails_the_cells_limits(cell):
    cfg = small_config()
    with open(os.path.join(ROOT, "portbench", "workloads",
                           cell + ".json")) as f:
        limits = json.load(f)["limits"]
    x0 = program.load_inputs(cfg, ROOT)["positions"][None]
    v0 = md.velocities(swm4ndp_water.topology(cfg), SMALL_TRAFFIC, 1, 7)
    nums = check.control_numbers(swm4ndp_water, cfg, SMALL_TRAFFIC, x0, v0,
                                 "cpu")
    rows = check.judge(nums, {k: limits[k] for k in check.CONTROLLED})
    assert any(not ok for *_, ok in rows), rows


def _state_unchanged(prog):
    prog.step = lambda n: None


def _half_the_batch(prog):
    """Each call advances the first half of the sites and leaves the
    rest as they were."""
    ctx = prog.context
    step = prog.step

    def half(n):
        before = ctx._state
        step(n)
        after = ctx._state
        h = after.positions.shape[0] // 2
        keep = lambda a, b: torch.cat([a[:h], b[h:]]) if a is not None \
            else None
        ctx._state = after.replace(
            positions=keep(after.positions, before.positions),
            velocities=keep(after.velocities, before.velocities),
            pos_err=keep(after.pos_err, before.pos_err))
    prog.step = half


def _answer_altered(prog):
    """The force pass doubles the force on one site."""
    ctx = prog.context
    inner = ctx._stepper.forces_fn

    def altered(*a, **kw):
        f = inner(*a, **kw).clone()
        f[0] = 2.0 * f[0]
        return f
    ctx._stepper.forces_fn = altered


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch,
                                   _answer_altered])
def test_a_broken_timed_path_is_not_correct(small_root, fake_card,
                                            monkeypatch, fault):
    class Broken(program.Program):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            fault(self)
    monkeypatch.setattr(program, "Program", Broken)
    rc, res = run_cpu(small_root, ARGS + ["--trace", "0"])
    assert rc == 0
    assert res["correct"] is False, res["checks"]


@pytest.mark.gpu
def test_control_at_a_cells_size_on_the_card(card):
    """The control on the card at the flat cell's size, one seed."""
    from portbench import control
    assert control.main(["--workload", "flat128.nvt", "--seeds", "5"]) == 0
