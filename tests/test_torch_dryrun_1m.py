"""tools/dryrun_1m.py (the port's scripts/dryrun_1m.py) on the CPU: its
rank function on 2 gloo ranks, both engines, in float64 against the
single float64 Context (the tool's REF_TOL, and 1e-9 nm), an x-slab the
resident engine refuses, the plan's refusals at the 1M configuration,
and the exit without CUDA."""

import pytest

import torch_ranks
from openmm_drudenose_tpu_torch.tools import dryrun_1m
from torch_threads import _one_thread  # noqa: F401

# 180 waters in an (8, 5, 5) box at a 0.5 nm cutoff: a (8, 5, 5) grid of
# window 2, two x-slabs of 4 planes (the w + 2 the resident slab needs)
SPEC = dryrun_1m.make_spec(180, (8, 5, 5), cutoff=0.5, steps=8,
                           engines=("sharded", "resident"),
                           precision="double")


def test_engines_match_the_single_context():
    res = torch_ranks.launch(dryrun_1m.rank_run, 2, SPEC)
    ref = dryrun_1m.reference(SPEC, "cpu")
    for engine in SPEC["engines"]:
        rows = [r[engine] for r in res]
        assert [r["grid"] for r in rows] == [[8, 5, 5]] * 2
        ok = dryrun_1m.check(rows, ref, SPEC, on_card=False)
        assert dryrun_1m.passed(ok), (engine, ok)
        assert ok["dx"] <= 1e-9, (engine, ok["dx"])
        assert all(r["kernel"]["bits"] for r in rows)
    assert sum(r["resident"]["owned"] for r in res) == SPEC["mol"]
    assert res[0]["resident"]["layout"]["loc_x"] == 4


def test_a_thin_slab_is_refused():
    """(6, 5, 5) cells over 2 ranks: slabs of 3 planes, under the
    resident slab's w + 2 = 4; the ranks raise with the plan's reason,
    and the work-sharded engine takes the grid."""
    spec = dict(SPEC, mol=135, shape=(6, 5, 5), engines=["resident"])
    why = dryrun_1m.refusal(135, 2, "resident", 0.5, (6, 5, 5))
    assert why.startswith("slab x-extent 3 planes < halo 4")
    assert dryrun_1m.refusal(135, 2, "sharded", 0.5, (6, 5, 5)) is None
    with pytest.raises(RuntimeError, match="slab x-extent 3 planes < halo 4"):
        torch_ranks.launch(dryrun_1m.rank_run, 2, spec)


def test_refusals_of_the_1m_plan():
    """1M atoms at 1.0 nm over 8 ranks: the grid (32, 33, 33), 4 planes a
    slab, taken by both engines; over 16 ranks the resident engine
    refuses 2-plane slabs; 800k over 8 ranks leaves 3 planes a slab."""
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.io import builders
    _, _, box = builders.water_box_lattice(200_000)
    cfg = cellpair.make_config(1.0, box, 1_000_000, [0], [4],
                               grid_x_multiple=8)
    assert cfg.grid == (32, 33, 33) and cfg.window == (2, 2, 2)
    for engine in ("sharded", "resident"):
        assert dryrun_1m.refusal(200_000, 8, engine) is None
        assert dryrun_1m.refusal(200_000, 16, "sharded") is None
    assert dryrun_1m.refusal(200_000, 16, "resident").startswith(
        "slab x-extent 2 planes < halo 4")
    assert dryrun_1m.refusal(160_000, 8, "resident").startswith(
        "slab x-extent 3 planes < halo 4")


def test_tool_exits_without_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert dryrun_1m.main(["--ranks", "2"]) == 1


def test_deferred_ranks_run_what_they_are_given():
    """parallel/comm.py::Deferred: ranks started before their function
    run it when given (rank_run with no engine: each rank's clock), and a
    cancelled set ends with no work and refuses a later go."""
    from openmm_drudenose_tpu_torch.parallel import comm
    early = comm.Deferred(2, "gloo", "cpu", torch_ranks.TIMEOUT_S,
                          threads=torch_ranks.THREADS)
    res = early.go(dryrun_1m.rank_run, dryrun_1m.make_spec(1, engines=()))
    assert len(res) == 2 and all(set(r) == {"started"} for r in res)
    cancelled = comm.Deferred(2, "gloo", "cpu", torch_ranks.TIMEOUT_S,
                              threads=torch_ranks.THREADS)
    cancelled.cancel()
    with pytest.raises(RuntimeError, match="already ran"):
        cancelled.go(dryrun_1m.rank_run, dryrun_1m.make_spec(1, engines=()))
