"""Where the NaCl deck's Drudes sit against the hard wall: the 100k deck
of chip_smoke.py phase 12 (build_nacl_water_box(19680, 400, 400) read
back through the force-field XML path), minimized and stepped from 300 K
velocities, with each 64-step block's bath temperatures, the largest
core-Drude distance before the wall's bounce (all Drudes, and the ions'
alone), the steps in which it passed twice the wall, and the runaway
latch.

    python3 -m openmm_drudenose_tpu_torch.tools.nacl_wall \\
        [rigid|flexible] [blocks] [restart_block]

On the CUDA card.  rigidWater=True (phase 12) or False (phase 13's O-H
constraints); at `restart_block` the positions and box are kept and the
chain and velocities start afresh, as phase 12 does after its first
settling.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu_torch.examples import nacl_tg_ff
from openmm_drudenose_tpu_torch.integrators import tgnh
from openmm_drudenose_tpu_torch.io import builders


def main(rigid=True, blocks=40, restart_block=None, block=64):
    system, pos = builders.build_nacl_water_box(19680, 400, 400)
    bare = os.path.join(nacl_tg_ff.ROOT, "build", "nacl_wall", "bare.pdb")
    os.makedirs(os.path.dirname(bare), exist_ok=True)
    nacl_tg_ff.write_nacl_pdbs(system, pos, bare)
    system, modeller, _ = nacl_tg_ff.build(nacl_tg_ff.FFXML, bare,
                                           rigid_water=rigid)
    if rigid:
        system.addForce(dt.MonteCarloBarostat(1.0, 300.0, 25))
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision="single")
    ctx.setPositions(np.asarray(modeller.positions))
    ctx.minimizeEnergy(maxIterations=200)
    ctx.setVelocitiesToTemperature(300.0, seed=0)
    ion_drude = ctx._spec.mass[ctx._spec.partner] > 20.0
    before = []
    bounce = tgnh.apply_hardwall

    def measured(spec, static, positions, velocities, dt_, pos_err=None):
        d = positions - positions[spec.partner]
        if pos_err is not None:
            d = d + (pos_err - pos_err[spec.partner])
        r = torch.linalg.norm(d, dim=1)
        r = torch.where(spec.is_pair & ~spec.is_parent, r,
                        torch.zeros_like(r))
        before.append(torch.stack([r.max(), torch.where(
            ion_drude, r, torch.zeros_like(r)).max()]))
        return bounce(spec, static, positions, velocities, dt_,
                      pos_err=pos_err)

    tgnh.apply_hardwall = measured
    t0 = time.time()
    try:
        for b in range(blocks):
            if b == restart_block:
                st = ctx._state
                settled = (st.positions.double()
                           + st.pos_err.double()).cpu().numpy()
                box = st.box.double().cpu().numpy()
                system.setDefaultPeriodicBoxVectors(*map(tuple, box))
                ctx.reinitialize(preserveState=False)
                ctx.setPositions(settled)
                ctx.setVelocitiesToTemperature(300.0, seed=1)
                print("restart: a fresh chain and 300 K velocities")
            integ.step(block)
            m = torch.stack(before).cpu().numpy()
            before.clear()
            temps = ctx.getState(groups=True).getGroupTemperatures()
            print(f"{b} baths {np.round(temps, 2).tolist()} K; before the "
                  f"bounce max {m[:, 0].max():.4f} nm (ions "
                  f"{m[:, 1].max():.4f}); steps past twice the wall "
                  f"{int((m[:, 0] > 0.04).sum())}; runaway latch "
                  f"{ctx.hardwallRunaway}; {time.time() - t0:.1f} s",
                  flush=True)
            ctx.clearHardwallRunaway()
    finally:
        tgnh.apply_hardwall = bounce


if __name__ == "__main__":
    main(rigid=(sys.argv[1] if len(sys.argv) > 1 else "rigid") == "rigid",
         blocks=int(sys.argv[2]) if len(sys.argv) > 2 else 40,
         restart_block=int(sys.argv[3]) if len(sys.argv) > 3 else None)
