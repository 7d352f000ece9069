#!/usr/bin/env python3
"""Make a settled SWM4-NDP template box, the fixed input of the flat
ensemble's configuration (and of the harness's CPU tests).

    python3 portbench/make_inputs.py --molecules 800 \\
        --out portbench/data/flat_template_4k.npz [--device cuda]

The protocol of chip_smoke.py phase 10: build_water_box(n) on the
default ("auto") strategy at single precision under
DrudeTGNHIntegrator(300, 0.1, 1, 0.1, 0.001, 20, 1) with a 0.02 nm wall,
300 K velocities (seed 0), 500 steps; the Context started again with a
fresh chain at the settled positions, 300 K velocities (seed 1), 500
steps more.  Writes the settled positions (float64, compensated), the
velocities, the box edge and the protocol, and prints the file's sha256,
which the configuration file pins.  Made once and committed: every run
loads it.
"""

import argparse
import os
import sys

import numpy as np

SETTLE_STEPS = 500


def settle(n_molecules: int, device: str):
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.io import builders
    system, pos = builders.build_water_box(n_molecules)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision="single", device=device)
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, seed=0)
    integ.step(SETTLE_STEPS)

    def exact():
        st = ctx._state
        return (st.positions.double() + st.pos_err.double()).cpu().numpy()

    settled = exact()
    ctx.reinitialize(preserveState=False)
    ctx.setPositions(settled)
    ctx.setVelocitiesToTemperature(300.0, seed=1)
    integ.step(SETTLE_STEPS)
    box = float(system.getDefaultPeriodicBoxVectors()[0][0])
    return exact(), ctx._state.velocities.double().cpu().numpy(), box


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--molecules", type=int, default=800)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from portbench.program import sha256
    pos, vel, box = settle(args.molecules, args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, positions=pos, velocities=vel,
                        box_nm=np.float64(box),
                        n_molecules=np.int64(args.molecules),
                        protocol=np.str_(
                            f"phase 10: 2 x {SETTLE_STEPS} steps, "
                            f"{args.device}"))
    print(args.out, sha256(args.out))


if __name__ == "__main__":
    main()
