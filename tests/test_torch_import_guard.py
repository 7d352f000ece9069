"""The PyTorch port stands alone: importing it (and its chip smoke
script's modules) pulls in neither JAX nor the JAX package."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys
import openmm_drudenose_tpu_torch
from openmm_drudenose_tpu_torch import convert
from openmm_drudenose_tpu_torch.app import context, serialization, simulation
from openmm_drudenose_tpu_torch.constraints import shake
from openmm_drudenose_tpu_torch.examples import nacl_tg
from openmm_drudenose_tpu_torch.forces import bonded, boxutils, dense
from openmm_drudenose_tpu_torch.integrators import barostat
from openmm_drudenose_tpu_torch.io import (builders, ionic_liquid, nacl,
                                           pdbfile, polymer)
from openmm_drudenose_tpu_torch.ops import scatter, sweep, sweep_chunked
from openmm_drudenose_tpu_torch.parallel import flatrep
from openmm_drudenose_tpu_torch.tools import time_nvt, walk_model
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "openmm_drudenose_tpu"
             or m.startswith("openmm_drudenose_tpu."))
print(",".join(bad))
"""


def test_import_leaves_jax_out():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"imported: {out.stdout.strip()}"


@pytest.mark.parametrize("name", ["chip_smoke.py"])
def test_script_imports_no_jax(name):
    """The chip script names neither JAX nor the JAX package in an import."""
    src = open(os.path.join(REPO, name)).read()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            mod = s.split()[1]
            assert not (mod == "jax" or mod.startswith("jax.")
                        or mod == "openmm_drudenose_tpu"
                        or mod.startswith("openmm_drudenose_tpu.")), s


def test_context_without_cuda_raises():
    """A Context built with no device on a machine without CUDA raises
    instead of running on the CPU."""
    import torch

    from openmm_drudenose_tpu_torch.app.context import default_device
    if torch.cuda.is_available():
        assert default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            default_device()
    assert default_device("cpu").type == "cpu"
