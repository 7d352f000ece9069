"""NaCl(aq) in SWM4-NDP Drude water under the TGNH thermostat and a
Monte Carlo barostat: the reference's example/nacl_tg.py workflow
(300 K / 0.1 ps real bath, 1 K / 0.1 ps Drude bath, 1 fs steps, 20 Drude
substeps, 0.02 nm hard wall, PME, MC barostat), line for line as the JAX
package's examples/nacl_tg.py runs it, through the PyTorch port.

    python3 -m openmm_drudenose_tpu_torch.examples.nacl_tg [n_steps] [pdb]

Runs on the CUDA card (main(device="cpu") runs it on the CPU).  The
reference's position file (example/nacl_1m_pos.pdb of the reference
plugin) is loaded where it is given and exists; otherwise an equivalent
box is generated (492 waters, 10 Na+, 10 Cl-: 2,500 atoms).
"""

import os
import sys
import time

import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu_torch.io import builders, nacl

def build(pdb=None):
    if pdb and os.path.exists(pdb):
        print(f"loading {pdb}")
        system, positions, topology = nacl.load_nacl_swm4(pdb)
    else:
        print("reference PDB not found; generating an equivalent box")
        system, positions = builders.build_nacl_water_box(
            n_water=492, n_na=10, n_cl=10)
        topology = None
    return system, positions, topology


def main(n_steps: int = 20000, report_every: int = 1000, device=None,
         checkpoint: str = "nacl_eq.chk", out=None, pdb=None):
    out = out or sys.stdout
    system, positions, topology = build(pdb)
    print(f"{system.getNumParticles()} atoms, "
          f"{system.getNumConstraints()} constraints")

    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20)
    integ.setMaxDrudeDistance(0.02)

    system.addForce(dt.MonteCarloBarostat(1.01325, 300.0, 100))

    sim = dt.Simulation(topology, system, integ, precision="single",
                        device=device)
    sim.context.setPositions(positions)

    print("minimizing...")
    sim.minimizeEnergy(maxIterations=200)
    st = sim.context.getState(energy=True)
    print(f"  PE after minimization: {st.getPotentialEnergy():.1f} kJ/mol")

    sim.context.setVelocitiesToTemperature(300.0)
    sim.reporters.append(dt.StateDataReporter(
        out, report_every, step=True, time=True, potentialEnergy=True,
        kineticEnergy=True, temperature=True, density=True,
        groupTemperatures=True, speed=True))
    sim.reporters.append(dt.CheckpointReporter(checkpoint, 10000))

    print("simulating...")
    t0 = time.time()
    sim.step(n_steps)
    elapsed = time.time() - t0
    print(f"{n_steps} steps in {elapsed:.1f}s -> "
          f"{n_steps / elapsed * integ.getStepSize() * 86.4:.2f} ns/day")
    return sim


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20000,
         pdb=sys.argv[2] if len(sys.argv) > 2 else None)
