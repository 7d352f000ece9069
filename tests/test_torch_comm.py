"""The port's collectives and rank launcher (parallel/comm.py) on CPU
gloo ranks: each collective and the ring exchange against numpy, the
axes of a ("replica", "atom") mesh, a rank's exception reaching the
caller, the process group's timeout ending a hung collective, and the
launcher and the dryrun tool on the card unless asked for the CPU."""

import numpy as np
import pytest
import torch

import torch_ranks
from openmm_drudenose_tpu_torch.parallel import comm
from torch_threads import _one_thread  # noqa: F401


def test_collectives_match_numpy():
    n = 3
    got = torch_ranks.launch(torch_ranks.collectives, n)
    x = [np.arange(12.0).reshape(6, 2) + 10.0 * r for r in range(n)]
    ints = [np.arange(6) * (r + 1) for r in range(n)]
    total = sum(x)
    for r, out in enumerate(got):
        np.testing.assert_array_equal(out["all_reduce"].numpy(), total)
        np.testing.assert_array_equal(out["all_reduce_int"].numpy(),
                                      sum(ints))
        np.testing.assert_array_equal(out["all_gather"].numpy(),
                                      np.stack(x))
        np.testing.assert_array_equal(out["reduce_scatter"].numpy(),
                                      total[2 * r:2 * r + 2])
        # block j of rank r's result is rank j's block r
        np.testing.assert_array_equal(
            out["all_to_all"].numpy(),
            np.concatenate([x[j][2 * r:2 * r + 2] for j in range(n)]))
        np.testing.assert_array_equal(out["from_left"].numpy(),
                                      x[(r - 1) % n][2:4])
        np.testing.assert_array_equal(out["from_right"].numpy(),
                                      x[(r + 1) % n][:2])
    # every rank's sum is the same bits
    for out in got[1:]:
        assert out["all_reduce"].numpy().tobytes() == \
            got[0]["all_reduce"].numpy().tobytes()


def test_mesh_axes():
    got = torch_ranks.launch(torch_ranks.mesh_axes, 4)
    for rank, (coords, atom_sum, replica_sum) in enumerate(got):
        assert coords == {"replica": rank // 2, "atom": rank % 2}
        assert atom_sum == sum(range(2 * (rank // 2), 2 * (rank // 2) + 2))
        assert replica_sum == (rank % 2) + (rank % 2 + 2)


def test_rank_exception_reaches_caller():
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        torch_ranks.launch(torch_ranks.fails, 2)


def test_timeout_ends_a_hung_collective():
    with pytest.raises(Exception):
        comm.launch(torch_ranks.hangs, 2, "gloo", "cpu", timeout_s=3.0,
                    threads=1)


def test_launch_refuses_nccl_on_cpu():
    with pytest.raises(ValueError, match="cuda"):
        comm.launch(torch_ranks.fails, 1, "nccl", "cpu")


def test_launch_runs_on_the_card_by_default(monkeypatch):
    """Without a device the ranks go on the card, and without a card the
    launcher and the dryrun tool refuse rather than run on the CPU."""
    from openmm_drudenose_tpu_torch.tools import dryrun_multichip
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        comm.launch(torch_ranks.fails, 1)
    assert dryrun_multichip.main(["--ranks", "2"]) == 2
