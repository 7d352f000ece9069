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
from openmm_drudenose_tpu_torch.app import (context, forcefield,
                                            serialization, simulation)
from openmm_drudenose_tpu_torch.constraints import shake, vsites
from openmm_drudenose_tpu_torch.examples import nacl_tg, nacl_tg_ff
from openmm_drudenose_tpu_torch.forces import (bonded, boxutils, cmap,
                                              custom, dense, neighborlist)
from openmm_drudenose_tpu_torch.utils import expr, native, profiling
from openmm_drudenose_tpu_torch.integrators import barostat
from openmm_drudenose_tpu_torch.io import (builders, dcd, ionic_liquid,
                                           nacl, pdbfile, polymer)
from openmm_drudenose_tpu_torch.ops import scatter, sweep, sweep_chunked
from openmm_drudenose_tpu_torch.parallel import (comm, distfft, domain,
                                                 ensemble, flatrep, resident,
                                                 sharded)
native.get_lib()
from openmm_drudenose_tpu_torch.tools import (dryrun_multichip, nacl_wall,
                                             term_checks, time_nvt,
                                             walk_model)
from openmm_drudenose_tpu_torch.tools import (measure_drift, series, setups,
                                             validate_flatnpt, validate_npt)
sys.path.insert(0, "tests")
import torch_ranks
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


@pytest.mark.parametrize("name", [
    "chip_smoke.py", "openmm_drudenose_tpu_torch/utils/native.py",
    "openmm_drudenose_tpu_torch/utils/profiling.py",
    "openmm_drudenose_tpu_torch/parallel/ensemble.py",
    "openmm_drudenose_tpu_torch/forces/neighborlist.py",
    "openmm_drudenose_tpu_torch/io/dcd.py",
    "openmm_drudenose_tpu_torch/parallel/comm.py",
    "openmm_drudenose_tpu_torch/parallel/sharded.py",
    "openmm_drudenose_tpu_torch/parallel/distfft.py",
    "openmm_drudenose_tpu_torch/parallel/domain.py",
    "openmm_drudenose_tpu_torch/parallel/resident.py",
    "openmm_drudenose_tpu_torch/tools/dryrun_multichip.py",
    "openmm_drudenose_tpu_torch/convert.py",
    "openmm_drudenose_tpu_torch/tools/setups.py",
    "openmm_drudenose_tpu_torch/tools/series.py",
    "openmm_drudenose_tpu_torch/tools/measure_drift.py",
    "openmm_drudenose_tpu_torch/tools/validate_npt.py",
    "openmm_drudenose_tpu_torch/tools/validate_flatnpt.py",
    "tests/torch_ranks.py"])
def test_script_imports_no_jax(name):
    """The chip script, the modules of the port's tenth to thirteenth
    slices and the rank functions that spawned test ranks import name
    neither JAX nor the JAX package in an import."""
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


def test_native_loader_builds_its_own_copy():
    """The host runtime's loader builds the port's copy of the C++ source
    (inside the port's package) into build/torch_native/, apart from the
    JAX package's native/ library and its hash sidecar."""
    from openmm_drudenose_tpu_torch.utils import native
    pkg = os.path.join(REPO, "openmm_drudenose_tpu_torch")
    assert str(native.SOURCE).startswith(pkg + os.sep)
    lib = str(native.library_path())
    assert lib.startswith(os.path.join(REPO, "build", "torch_native")
                          + os.sep)
    assert not lib.startswith(os.path.join(REPO, "native"))
