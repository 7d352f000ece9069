"""NPT observables of the port on the CUDA card: the counterpart of the
JAX package's scripts/validate_npt_tpu.py.

500 SWM4-NDP waters (build_water_box(500): PME at 1.0 nm, a 2.47 nm box,
the cell-pair strategy on the 4^3 grid the JAX package plans, swept by
kernel B1 over the half stencil of explicit images: forces/cellpair.py::
make_config) with MonteCarloBarostat(1.01325, 300, 25),
DrudeTGNHIntegrator(300, 0.1, 1, 0.1, 0.001, 20, 1) and a 0.02 nm wall,
single precision; minimizeEnergy(maxIterations=300), 300 K velocities
(seed 11), --equil-ps of equilibration, then --sample-ps of sampling.
Every ps (1,000 steps) a CSV row: the density (g/mL, 18.0154 g/mol a
molecule over the box, as the JAX script), the potential energy per molecule (kJ/mol), the three
bath temperatures and the box edge.  The result: the density, U per
molecule and the Drude bath over the sampling rows, each with the
standard error of 5 ps block averages inflated for their AR(1)
correlation (tools/series.py::block_se), against the JAX run on its
chip (0.9955 +- 0.0007 g/mL, -41.41 +- 0.02 kJ/mol, Drude bath 0.999 K).

Resumable as tools/measure_drift.py: the state is checkpointed (the
port's format, with a `.ps` marker) every --ckpt-every ps and when
--budget-s is spent; a later call with the same --csv and --state goes
on where it stopped.

    python3 -m openmm_drudenose_tpu_torch.tools.validate_npt \\
        [--equil-ps 100] [--sample-ps 200] [--budget-s S] [--csv PATH] \\
        [--state PATH]

On the CUDA card; it exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from openmm_drudenose_tpu_torch.tools import measure_drift as md
from openmm_drudenose_tpu_torch.tools import series, setups

# the JAX run on its chip (COVERAGE.md:30, :72)
JAX_RHO, JAX_RHO_SE = 0.9955, 0.0007
JAX_U, JAX_U_SE = -41.41, 0.02
DRUDE_TARGET = 1.0
BLOCK_PS = 5
COLUMNS = "# ps, rho_g_ml, U_kj_mol_per_molecule, T_internal, T_COM, " \
          "T_Drude, box_nm\n"
NCOLS = 7
MASS_G_PER_AMU = 1.66053906660e-24
# the density's mass a molecule, as the JAX script takes it (H2O; the
# builder's SWM4-NDP masses sum to 18.0 amu, 0.09% less)
WATER_AMU = 18.0154


def build(molecules: int, device, seed: int = 0, cutoff: float = 1.0):
    """(Context, integrator, molecules, the density's mass in amu) of
    the run: the water box with the barostat, at the lattice
    positions."""
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.io import builders
    system, positions = builders.build_water_box(molecules, cutoff=cutoff)
    system.addForce(dt.MonteCarloBarostat(1.01325, 300.0, 25))
    integ = setups.bench_integrator()
    ctx = dt.Context(system, integ, precision="single", strategy="cellpair",
                     device=device, seed=seed)
    ctx.setPositions(positions)
    return ctx, integ, molecules, molecules * WATER_AMU


def start(ctx):
    """The JAX script's start: FIRE (300 iterations), 300 K velocities
    from seed 11."""
    ctx.minimizeEnergy(maxIterations=300)
    ctx.setVelocitiesToTemperature(300.0, seed=11)


def sample(ctx, molecules: int, mass_amu: float) -> list:
    """[rho (g/mL), U per molecule (kJ/mol), T_internal, T_COM, T_Drude,
    box edge (nm)] at the current state."""
    box = ctx._state.box.double().cpu().numpy()
    vol_ml = float(np.linalg.det(box)) * 1e-21
    rho = mass_amu * MASS_G_PER_AMU / vol_ml
    u = ctx.getState(energy=True).getPotentialEnergy() / molecules
    return [rho, u, *md.temperatures(ctx).tolist(), float(box[0, 0])]


def summary(rows: np.ndarray, equil_ps: float, log=print) -> dict:
    """The sampling rows' density, U per molecule and Drude bath, each
    with its 5 ps block SE, and the bands against the JAX run."""
    s = rows[rows[:, 0] > equil_ps]
    out = {"sample_ps": int(len(s))}
    if len(s) < 2 * BLOCK_PS:
        log(f"{len(s)} sampling ps: too few for 5 ps blocks")
        return out
    for key, col, ref, ref_se in (("rho", 1, JAX_RHO, JAX_RHO_SE),
                                  ("u", 2, JAX_U, JAX_U_SE),
                                  ("t_drude", 5, DRUDE_TARGET, 0.0)):
        mean = float(np.mean(s[:, col]))
        se, rho, plain = series.block_se(s[:, col], BLOCK_PS)
        held, half = series.within(mean, ref, se, ref_se)
        out[key] = {"mean": mean, "se": se, "se_plain": plain,
                    "block_rho": rho, "ref": ref, "band": half,
                    "held": held}
        log(f"  {key:8s} = {mean:.5f} +- {se:.5f} (5 ps blocks, AR1 rho "
            f"{rho:+.3f}; plain +- {plain:.5f}); reference {ref} "
            f"+- {ref_se}: band +-{half:.5f}, "
            f"{'held' if held else 'MISSED'}")
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--molecules", type=int, default=500)
    ap.add_argument("--cutoff", type=float, default=1.0)
    ap.add_argument("--equil-ps", type=float, default=100.0)
    ap.add_argument("--sample-ps", type=float, default=200.0)
    ap.add_argument("--budget-s", type=float, default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--commit", default=None)
    scratch = os.path.join(setups.ROOT, "build", "validate_npt")
    ap.add_argument("--csv", default=os.path.join(scratch, "samples.csv"))
    ap.add_argument("--state", default=os.path.join(scratch, "state.npz"))
    return ap.parse_args(argv)


def open_run(args, device, log=print):
    """(ctx, integ, molecules, mass, rows) at the series' end: resumed
    from the checkpoint where the CSV has rows, refused where it has rows
    and no checkpoint, else started (minimized, seeded velocities) with a
    new CSV."""
    import openmm_drudenose_tpu_torch as dt
    rows = md.series_rows(args.csv, args.state, NCOLS, log)
    ctx, integ, n_mol, mass = build(args.molecules, device,
                                    cutoff=args.cutoff)
    if len(rows):
        dt.load_checkpoint(args.state, ctx)
        log(f"resumed from {args.state} at {int(rows[-1, 0])} ps")
        return ctx, integ, n_mol, mass, rows
    start(ctx)
    os.makedirs(os.path.dirname(os.path.abspath(args.csv)), exist_ok=True)
    with open(args.csv, "w") as f:
        f.write(f"# openmm_drudenose_tpu_torch tools/validate_npt: "
                f"{n_mol} waters, MonteCarloBarostat(1.01325, 300, 25), "
                f"equilibration {args.equil_ps} ps\n")
        f.write(f"# commit: {md.commit_name(args.commit)}; sources "
                f"{md.source_digest()}\n")
        f.write(f"# card: {md.card_line()}\n")
        f.write(COLUMNS)
    return ctx, integ, n_mol, mass, rows


def session(ctx, integ, n_mol, mass, rows, args, steps=1000,
            log=print) -> np.ndarray:
    """A row every `steps` steps (tools/measure_drift.py::sample_loop)
    until equil + sample ps are done or the budget is spent."""
    def progress(out, new, seconds):
        recent = out[-25:]
        log(f"{int(out[-1, 0])} ps  rho {recent[:, 1].mean():.4f} g/mL  U "
            f"{recent[:, 2].mean():.3f} kJ/mol  T_D "
            f"{recent[:, 5].mean():.3f} K  ({seconds:.0f} s; latches "
            f"{md.latches(ctx)})")
    last = int(rows[-1, 0]) if len(rows) else 0
    return md.sample_loop(ctx, integ, rows.reshape(-1, NCOLS), last,
                          int(args.equil_ps + args.sample_ps),
                          lambda c: sample(c, n_mol, mass), args, steps,
                          progress, log)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("validate_npt: no CUDA device (the tool runs on the card)",
              file=sys.stderr)
        return 1
    card = md.card_line()
    print(card, flush=True)
    ctx, integ, n_mol, mass, rows = open_run(args, "cuda")
    cfg = ctx._cp_cfg
    print(f"cell grid {cfg.grid}, window {cfg.window}, {cfg.n_offsets} "
          f"offsets, capacity {cfg.capacity}", flush=True)
    rows = session(ctx, integ, n_mol, mass, rows, args)
    res = summary(rows, args.equil_ps)
    print(json.dumps({"card": card, "molecules": n_mol,
                      "latches": md.latches(ctx),
                      "grid": list(ctx._cp_cfg.grid),
                      "equil_ps": args.equil_ps, "rows": int(len(rows)),
                      **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
