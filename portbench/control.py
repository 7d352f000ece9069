#!/usr/bin/env python3
"""The control of a cell's comparison, on the card at the cell's size:
the plain reference in float32 with TF32 products in the program's
place (portbench/check.py::control_numbers), on each seed.

    python3 portbench/control.py --workload CELL --seeds 1,2,3 \\
        [--json PATH]

Prints each seed's numbers beside the cell's limits and judges them
by the harness's own comparison (check.judge: a number over its limit,
missing or not finite fails); exits 0 only where every seed fails at
least one limit, so that the comparison separates the control from
the program.  The benchmark's own runs do not run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from portbench import check, harness, program
    if not torch.cuda.is_available():
        sys.exit("control: no CUDA card")
    cell = harness.load_cell(ROOT, args.workload)
    cfg, tr, limits = cell["config"], cell["traffic"], cell["limits"]
    sysmod, gen = cell["system"], cell["generator"]
    inputs = program.load_inputs(cfg, ROOT)
    R = int(cfg["replicas"])
    x0 = inputs["positions"].astype("float64")[None].repeat(R, 0)
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        v0 = gen.velocities(sysmod.topology(cfg), tr, R, seed)
        nums = check.control_numbers(sysmod, cfg, tr, x0, v0,
                                     harness.DEVICE)
        rows = check.judge(nums, {k: limits[k] for k in check.CONTROLLED
                                  if k in limits})
        failed = [name for name, _, _, ok in rows if not ok]
        out.append({"seed": seed, "numbers": nums, "failed": failed})
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0,
                          "numbers": nums, "limits": limits,
                          "fails": failed}), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if all(o["failed"] for o in out) else 1


if __name__ == "__main__":
    sys.exit(main())
