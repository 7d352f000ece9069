"""ops/scatter.py: the port's one scatter-add.  On the CPU it is
index_add_ itself; no module of the port scatters by any other call, so
that on the card every sum runs through the fixed-order path (its
bit-identical repeats are checked in tests/test_torch_gpu.py)."""

import os
import re

import numpy as np
import pytest
import torch

from openmm_drudenose_tpu_torch.ops import scatter
from torch_threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "openmm_drudenose_tpu_torch")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("width", [None, 3])
def test_cpu_matches_index_add(dtype, width):
    rng = np.random.default_rng(11)
    idx = torch.as_tensor(rng.integers(0, 50, 4000))
    shape = (4000,) if width is None else (4000, width)
    src = torch.as_tensor(rng.normal(size=shape), dtype=dtype)
    out = torch.zeros((50,) + shape[1:], dtype=dtype)
    ref = out.clone().index_add_(0, idx, src)
    got = scatter.index_add_(out, idx, src)
    assert got is out
    assert torch.equal(got, ref)


def test_port_scatters_only_through_the_helper():
    pattern = re.compile(r"\.(index_add_?|scatter_add_?|scatter_reduce_?)\(|"
                         r"accumulate=True")
    hits = []
    for root, _, files in os.walk(PORT):
        for name in files:
            path = os.path.join(root, name)
            if not name.endswith(".py") or path.endswith(
                    os.path.join("ops", "scatter.py")):
                continue
            for n, line in enumerate(open(path), 1):
                if pattern.search(line) and "scatter.index_add_(" not in line:
                    hits.append(f"{os.path.relpath(path, REPO)}:{n}")
    assert hits == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fixed_point_sum_is_exact_and_order_free(dtype):
    """The int64 fixed-point sum: the float64 sum to within its
    resolution, and the same bits when the adds come in another order."""
    rng = np.random.default_rng(5)
    idx = torch.as_tensor(rng.integers(0, 64, 20000))
    src = torch.as_tensor(rng.uniform(-1.0, 1.0, 20000), dtype=dtype)
    bound = float(torch.sum(torch.abs(src)))
    shift = scatter.fixed_point_shift(bound)
    assert 2.0 ** (62 - shift) >= bound
    perm = torch.as_tensor(rng.permutation(20000))
    sums = []
    for order in (torch.arange(20000), perm):
        acc = torch.zeros(64, dtype=torch.int64)
        scatter.fixed_point_add_(acc, idx[order], src[order], shift)
        sums.append(scatter.from_fixed_point(acc, shift, torch.float64))
    assert torch.equal(sums[0], sums[1])
    ref = torch.zeros(64, dtype=torch.float64).index_add_(0, idx,
                                                          src.double())
    assert float(torch.max(torch.abs(sums[0] - ref))) <= 20000 * 2.0 ** -shift
