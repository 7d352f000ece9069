#!/usr/bin/env python3
"""The benchmark of openmm_drudenose_tpu_torch on one CUDA card.

    python3 portbench/run.py --workload CELL --seed N --seconds S \\
        --trace 0|1

Runs one cell of BENCHMARK.json (its configuration, traffic mix and
limits are files under portbench/, found by name) in this process and
prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), `device`, and with --trace 1
`breakdown`.  Exits non-zero, printing no result, without a CUDA card.
The port builds its kernels into build/torch_kernels/ of this checkout;
Triton's, PyTorch's extension and CUDA's JIT caches are pointed at
build/portbench_cache/ (fixed paths), so only a checkout's first run
builds.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    cache = os.path.join(ROOT, "build", "portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    sys.path.insert(0, ROOT)
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], root=ROOT, t0=T0))
