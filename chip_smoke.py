#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

The benchmark configuration of the JAX package's bench.py: 100,000 atoms
of SWM4-NDP water (PME, cell-pair sweep, Drude springs, SETTLE, M sites,
CMMotionRemover) under DrudeTGNHIntegrator(300, 0.1, 1, 0.1, 0.001, 20, 1)
with a 0.02 nm hard wall, single precision, started from
data/bench_equil_100k.npz.  Phases (one flushed line each, with elapsed
seconds):

  0. device: the nvidia-smi name/power-limit line; exits non-zero without
     CUDA, before printing any result
  1. build: nvcc builds kernels B1 (ops/sweep.py, csrc/sweep.cu) and B2
     (ops/sweep_chunked.py, csrc/sweep_chunked.cu), both on the warp-tile
     pair loop of csrc/pair_tile.cuh; prints the build seconds and
     ptxas' register/shared-memory lines, then (c) each kernel's
     registers, static shared memory and local bytes as read from the
     card (cudaFuncGetAttributes), the card's limits, and the warps an SM
     holds of each
  2. kernel parity at full size: B1 against its plain version (f32, on
     the card, max|dF| / max|F| <= 2e-5), two launches bit-identical
     (B1's reactions go through frames with one writer an entry and a
     fixed-order gather), and against the plain version in
     f64 (the f32 floor: max|dF| / max|F| <= 1e-4 over the atoms of pairs
     both precisions put on the same side of the cutoff, rms|dF| / max|F|
     <= 5e-6 over all); B1, plain and the bound timed.  Then (a) the
     bench fields with one more exclusion, over 40 atom indices (W = 40,
     three mask words): B1 and B2 against the plain version (<= 2e-5)
     and the plain version in f64 (the f32 floor); (b) the bench
     snapshot sorted at capacity 160: B1 and B2 against the plain
     version (<= 2e-5)
  3. the slice: the Context's force pass in f32 against the same pass in
     f64 (the same f32 floor), then 100 steps with the launch counts reset
     just before and read just after (B1 launched); no latch may be set,
     the hard wall must hold, bath temperatures and the conserved energy must be
     finite and plausible (getState(energy=True) counted apart: B1's
     energy instantiation launched, no plain sweep on the card); ms/step
     and ns/day, and the stream time of each part of the force pass
     beside the whole step; then a checkpoint of the 100k NVT state
     saved, 32 steps through B1, loaded, 32 steps: positions bit for bit
     (max |dx| = 0)
  4. kernel B2 (ops/sweep_chunked.py, csrc/sweep_chunked.cu) and the
     large single-card path: B2 forced at 100k against B1 on the bench
     fields; then the system of the JAX package's 1M-atom single-device
     run (scripts/bench_1m_single.py: the same water, integrator and
     wall, single precision, setVelocitiesToTemperature(300, seed=0)),
     started from the bench snapshot tiled 2x2x2 (800,000 atoms, 30^3
     cells) because a lattice start latches the drift check in both
     packages; the gates route its sweep to B2.  64 settling steps; B2
     on its fields against its plain version (<= 2e-5), the plain
     version in f64 (the f32 floor) and B1 (<= 2e-5), two launches
     bit-identical, B2 (also by brick), B1 and plain timed with their
     bound; 64 timed steps with the launch counts reset just before and
     read just after (B2 launched, B1 never); B2's energy instantiation
     against the plain energy (f32, 1e-6 of |E|) and f64 (1e-5 of |E|),
     two launches bit-identical, timed with its bound; no latch, the wall
     held, everything finite (the state's energy by B2's energy, no plain
     sweep on the card), the f32 force pass against f64 (the f32 floor);
     ms/step, ns/day, bath temperatures and the breakdown (no temperature
     window: fresh velocities are not equilibrated)
  5. the reference example at its own size (its examples/nacl_tg.py
     workflow through the port's Simulation): the generated NaCl box
     (492 waters, 10 Na+, 10 Cl-: 2,500 atoms, the dense strategy),
     single precision; minimize(200) (the energy must fall), 300 K
     velocities, MonteCarloBarostat(1.01325, 300, 100),
     StateDataReporter every 500 steps, 2,000 steps: no latch, the wall
     held, finite energies, the bath temperatures averaged over the run
     (every 10 steps) in phase 3's bands and the last ones in wider
     bands, the box changed (a move was accepted); ms/step; a checkpoint
     saved, 100 steps, loaded, 100 steps: positions bit for bit in
     PyTorch's default mode (every scatter-add of the port sums in a
     fixed order: ops/scatter.py)
  6. NPT at full width through B1: the 100k system and snapshot of
     phase 3 with MonteCarloBarostat(1.01325, 300, 25); B1's energy
     against the plain energy (f32, 1e-6 of |E|) and f64 (1e-5 of |E|),
     two launches bit-identical, timed with its bound; 400 steps (16
     attempts) with the counts reset just before and read just after:
     b1_energy = 2 an attempt, no plain sweep; ms/step against phase 3's
     without the barostat, and the host time spent inside the attempts;
     latches, wall, finiteness; then a forced 0.9x
     linear shrink: the cell grid planned again, B1 (forces and energy)
     held against its plain version on the new grid
  7. the paper's ionic liquid at full width, the reaction field through
     B1: build_ionic_liquid(14286, CutoffPeriodic, cutoff 1.2) (100,002
     atoms, 14,286 ion pairs, 25^3 cells) with the cation, anion, COM
     and Drude baths (make_tgnh_integrator at 400 K / 1 K, 1 fs, 0.02 nm
     wall), single precision, the cell-pair strategy with the exclusion
     test at every offset (a cation's C1-C2 exclusion spans ~0.65 nm,
     about a cell); minimizeEnergy(300) (the energy must fall), 400 K
     velocities, IL_SETTLE settling steps (the baths swing for ~0.8 ps
     after the minimized lattice), IL_STEPS steps counted (B1's RF
     instantiation launched,
     its Ewald one never, no plain sweep); latches, wall, finiteness,
     four baths with the cation, anion and Drude bath temperatures (the
     run's mean, sampled every BLOCK steps, and the last) in bands written
     before the first card run; the f32 force pass against f64 (the f32
     floor); B1's RF forces and energy against their plain versions
     (2e-5 of max|F|, 1e-6 of |E|) and f64, two launches bit-identical,
     timed with the bound; B2's RF instantiation on the same fields
     against its plain version and B1, and a Context routed to it
     (nb_options use_pallas 3) stepped 16 steps counted; ms/step, ns/day
     and the breakdown
  8. the solvated polymer at full width, Ewald through B1 with bonds,
     angles and torsions on the force pass: build_solvated_polymer(100,
     30, 20000) (92,475 atoms, PME, cutoff 1.0) with the polymer and
     water baths (300 K / 1 K), single precision, io/polymer.py's
     complete Drude exclusions (ROADMAP.md C15); minimizeEnergy(300),
     300 K velocities, POLY_SETTLE settling steps, POLY_STEPS steps
     counted (B1 launched, no plain
     sweep); the checks of phase 7 but the reaction field's, with B1's
     Ewald forces against their plain version on its fields
  9. triclinic boxes through B1 and B2: the JAX package's sheared 100k
     box (scripts/check_triclinic_tpu.py: build_water_box(20000, PME,
     cutoff 1.0) with rows a = (L, 0, 0), b = (0.2 L, L, 0), c = (0.1 L,
     0.15 L, L), L = 8.4346 nm; 15^3 cells of fractional space, window 2,
     63 offsets, C = 48), the integrator of phase 3, single precision,
     from build_water_box's lattice: minimizeEnergy(300), 300 K velocities,
     TRI_SETTLE settling steps, a restart from the settled positions
     (reinitialize: a fresh chain; 300 K velocities) and TRI_SETTLE
     settling steps more (each stage's latches printed), TRI_STEPS steps
     counted
     (B1 launched, no plain sweep); the checks of phase 8 with the bath
     bands of phase 3 on the run's mean; B1 and B2 on its fields against
     their plain versions, f64 and each other, bit-identical, timed with
     the bound; B2's energy held; a Context routed to B2 stepped
     TRI_B2_STEPS steps; then NPT (MonteCarloBarostat(1.01325, 300,
     TRI_BARO), TRI_NPT_STEPS steps) with the checks of phase 6, the
     forced 0.9x shrink planning a triclinic grid again
 10. the flattened replica ensemble through the replica-band path of B1:
     the JAX package's scripts/bench_replicas.py --flat at full width, 64
     replicas of build_water_box(800) (4,000 atoms each) in the auto
     layout (7, 10) of 70 internal replicas (280,000 atoms; a (35, 5, 50)
     grid of 5^3 replica grids, C = 48, 63 offsets, PME 25^3 a replica,
     batched), the integrator of phase 3, single precision; the template
     settles FLAT_TPL_SETTLE steps on the dense strategy from the
     lattice, then FLAT_TPL_SETTLE more after a restart with a fresh
     chain, the ensemble takes fresh 300 K velocities, FLAT_SETTLE
     settling steps, then FLAT_REPEATS x FLAT_STEPS timed steps counted
     (B1's band instantiation launched, nothing else, no plain sweep):
     ms/step, ns/day a replica and over the 64; latches, the wall, finite
     per-replica temperatures, the water bath's mean over the replicas
     in the bands written before the first card run; B1 and B2 on its
     fields against their plain versions, f64 and each other,
     bit-identical, timed with the bound, both energies held; every atom
     of replica 0 moved, the other replicas' forces out of both kernels
     unchanged bit for bit; the breakdown; the f32 force pass against
     f64, and replicas at band edges (FLAT_EDGE_REPLICAS) against
     single-replica f64 Contexts of the template on the cell-pair
     strategy; a Context routed to B2 stepped FLAT_B2_STEPS steps
 11. flat NPT through the scaled instantiations of B1 (each replica at
     its own box, the template box times s_r; B1 and B2 read an (R,
     n_off, 3) shift table): phase 10's ensemble from its settled
     template (positions and velocities) with the barostat of the JAX
     package's scripts/validate_flatnpt_tpu.py, MonteCarloBarostat(
     1.01325, 300, FLAT_NPT_BARO); FLAT_NPT_SETTLE settling steps, then
     FLAT_NPT_REPEATS x FLAT_NPT_STEPS timed steps counted (B1's scaled
     force instantiation, two scaled energy launches an attempt, nothing
     else, no plain sweep): ms/step, ns/day a replica and over the 64,
     the host time inside the attempts; every replica attempted, the
     scales parted, each scale and density in FLAT_NPT_BANDS (written
     before the first card run), phase 10's bath bands, no latch, the
     wall; at the final state B1 and B2 scaled against their plain
     versions, f64 and each other, bit-identical, timed with the bound,
     both energy instantiations per replica against plain and f64; the
     breakdown (with a barostat attempt's mc_energies pass); replica 0's
     scale and positions changed, the other replicas' forces
     and energies out of both kernels the same bits; the f32 flat NPT
     force pass against f64, and the band-edge replicas against
     single-replica f64 Contexts at the box template * s_r (the flat
     template's PME plan): forces at the f32 floor, a proposed move's
     mc_energies difference against the two Contexts' full-PE
     difference within 1e-6 of |E_r| from the flat pass in f64 and
     within E_F64_REL (the float32 energy floor of phases 4, 6 and 10)
     from the f32 one; a Context routed to B2 stepped
     FLAT_NPT_B2_STEPS steps with a move every FLAT_NPT_B2_BARO; a
     checkpoint replayed bit for bit over FLAT_NPT_REPLAY steps with an
     attempt
 12. the reference's ForceField workflow at 100k, NPT through B1: the
     example's generated box times 40 (build_nacl_water_box(19680, 400,
     400): 100,000 atoms) written as a position PDB and a bare PDB
     (59,840 atoms, 20,480 residues; numbers wrap at 10,000) and read
     back through PDBFile -> ForceField(tests/data/swm4_nacl.xml) ->
     Modeller.addExtraParticles -> createSystem(PME, 1.0, HBonds,
     rigidWater) with the example's mass repartition
     (examples/nacl_tg_ff.py), the host seconds of each stage printed;
     (a) the FF System against io/nacl.load_nacl_swm4 of the position
     PDB term by term on the host; (b) each System's force pass on the
     card at the same positions (max|dF|/max|F| <= 2e-5, energies 1e-6
     of |E|, through B1); then MonteCarloBarostat(1.0, 300, FF_BARO),
     DrudeTGNHIntegrator(300, 0.1, 1, 0.1, 0.001, 20) with the 0.02 nm
     wall, single precision: minimize(FF_MIN), FF_SETTLE settling steps,
     a restart with a fresh chain, FF_SETTLE more, FF_STEPS steps counted
     (B1 alone, two energy launches an attempt, no plain sweep): ms/step,
     ns/day, the host ms inside the attempts; latches, wall, finiteness,
     the bath bands and the density band (FF_BANDS, FF_DENSITY); the
     hard-wall runaway latch (a Drude back from past twice the wall) is
     printed and cleared after each stage: the deck's Cl- Drudes reach
     0.034-0.046 nm before the bounce in the fields of their neighbours
 13. SHAKE clusters at 100k, NVT through B1: the same deck with
     rigidWater=False (39,360 O-H constraints in 19,680 three-atom
     clusters, no SETTLE), from phase 12's final state and box,
     SHAKE_STEPS steps counted: every constraint within 2 tol of its
     length at SHAKE's result in every step (and the worst after a
     block printed: the hard wall moves a bounced Drude's parent after
     SHAKE, in the reference's order), |r.v|/d^2 <= tol after a
     projection, the blocks in which a Drude came back from past twice
     the wall counted and printed (rare at 100k 1 M NaCl: the wall holds
     them), the
     bath bands, wall and latches, no plain sweep; ms/step against phase
     3's, the SHAKE and RATTLE sweeps a step (mean and max) and the host
     reads of the done flag a step, the stream ms of one SHAKE and one
     RATTLE call; one step of an f32 Context against an f64 one from the
     same state (positions to 1e-5 nm)
 14. the plain-PyTorch terms on the card (tools/term_checks.py): CMAP,
     the out-of-plane and local-coordinates sites, anisotropic Drudes,
     each Custom*Force, a setParameter scan and a System read back from
     its XML, in float64 on the card against the CPU (1e-10 of |E|,
     1e-8 of max|F|); 200 float32 steps of the custom-force system
 15. switched LJ at full width through the switched instantiations of
     B1 and B2 (kSwitch): the deck of phase 12 read through
     createSystem(PME, nonbondedCutoff=1.2, switchDistance=1.0, HBonds,
     rigidWater) (the cutoffs CHARMM-GUI writes for Drude decks), from
     phase 12's final state and box in NVT; the f32 force pass against
     f64 (phase 2's gates); B1 and B2 switched on its fields against
     their plain versions (2e-5 of max|F|), f64 and each other,
     bit-identical, the switch's own effect (switched minus unswitched
     on the fields with the charges zeroed) against the plain
     version's in f64 (SW_EFFECT_TOL of that effect's max), their
     energies (1e-6 of |E|), timed with the bound
     (the switch's window pairs counted), B1 unswitched on the same
     fields and on phase 3's fields in the same call (PERF.md: 0.8840
     ms), every instantiation's registers read from the card;
     SW_SETTLE settling and SW_STEPS counted steps (B1's switched
     instantiation alone, no plain sweep): ms/step, ns/day, latches,
     wall, the bath bands of phase 12; a Context routed to B2 stepped
     SW_B2_STEPS; the ionic liquid of phase 7 from its final state with
     the switch from 1.0 at its 1.2 cutoff: B1 switched RF against its
     plain version, the switch's own effect as above, its energy,
     SW_IL_STEPS steps counted
 16. ReplicaEnsemble at the width of the JAX package's
     scripts/bench_replicas.py without --flat: 64 replicas of
     build_water_box(800) from phase 10's settled template, each its own
     300 K velocities, on the dense strategy ("auto": the block-diagonal
     all-pairs sum) and on the cell-pair one (B1's band path, an 8 x 8
     layout): one replica against a standalone f64 Context over
     REP_CHECK_STEPS steps, replicas isolated (replica 0 moved, the
     others' forces the same bits), REP_SETTLE settling steps, the best
     of REP_REPEATS x REP_STEPS counted (the dense term, ~0.35 s a step:
     REP_DENSE_STEPS, no settling) (one force pass a step for all
     replicas, at most one more a step() call and a chunk's more a
     capacity growth, B1's band instantiation alone on the cell-pair
     strategy, no kernel on the dense one, no plain sweep): ms/step,
     ns/day a replica and aggregate beside phase 10's; temperatures, the
     wall; one dense force pass at each of forces/dense.py's two block
     sizes
 17. the rest of the single-card modules: strategy "cell" (neighbour
     lists) against the cell-pair sweep on the settled 4k box in f64
     (1e-10 of |E|, 1e-8 of max|F|) and REST_CELL_STEPS f32 steps on it;
     the DCD and PDB reporters through Simulation on phase 5's example
     box, read back (frames against the state and each other); the
     native host library built and loaded (utils/native.py) and its
     union-find's molecule ids of the 100k water equal to the Python
     labels' (core/topology.py), each timed on the same edges;
     utils/profiling.step_breakdown of the 100k Context
 18. the multi-rank paths (parallel/comm.py, sharded.py, distfft.py,
     domain.py, ensemble.py's mesh half) at phase 3's width, driven
     through parallel/comm.py::launch: MR_RANKS gloo ranks time-sharing
     cuda:0 (NCCL refuses two ranks on one device), then NCCL at world
     size 1.  (a) B1 with a home-slab range on phase 3's fields: each of
     the MR_RANKS x-slabs of the 15^3 grid against its plain version
     (2e-5 of max|F|) and bit-identical on a second launch, the full
     range the bits of a launch without one, the slabs summed against
     the whole (2e-5 of max|F|; their energies 1e-6 of |E|), one slab
     timed with its plain version and bound, the registers; (b) the
     100k Context's force pass through ShardedContext against the single
     f32 Context's (phase 2's floors), MR_STEPS steps with the counts
     reset just before and read just after (B1's slab launches on every
     rank, one a step and no more but for the reruns of a capacity
     growth, its whole-grid ones never, no plain sweep), the ranks'
     positions bit-identical, rank 0's after MR_REF_STEPS within
     MR_REF_TOL nm of a single-rank f64 Context; (c) distributed_fft
     (the 75^3 PME grid in x-slabs and y-pencils): the PME energy against
     the replicated FFT's (1e-5 of |E|) and the force pass (2e-5 of
     max|F|); (d) the halo-exchange sweep (parallel/domain.py) against
     B1's whole-grid sweep on the same fields (forces 2e-5 of max|F|,
     energy 1e-6); (e) NCCL at world size 1: MR_REF_STEPS steps of a
     ShardedContext against the single f32 Context (phase 2's floors on
     the force pass, MR_REF_TOL nm), whether the bits match logged; (f)
     ReplicaEnsemble on a (MR_RANKS,) replica mesh of flat sub-ensembles
     (MR_FLAT_R x phase 10's 4k box, cell pairs, one a rank),
     MR_FLAT_STEPS steps, each member bit for bit against a standalone
     flat ensemble run from the same velocities.  ms/step of (b) and (f)
     are of ranks time-sharing one card, not a scaling figure
 19. the state-resident decomposition (parallel/resident.py) on the
     100k box of phases 2-3: RES_RANKS gloo ranks time-sharing cuda:0,
     each owning an x-slab of molecules (15 planes, 5 a slab, the
     w + 2 = 4 plane halo), f32 with compensated positions: (a) the
     resident force pass against the single f32 Context's (phase 2's
     floors), the energies' difference logged; B1's resident-block
     instantiation against its plain version on the same block (<= 2e-5
     of max|F|), two launches bit-identical, timed on rank 0 while the
     others wait, its bound (the function's: the grid's stencil over
     the slab's home cells, as phase 18's slab row; the block's own
     stencil's pair tests logged beside it); (b) RES_STEPS steps (two rebuild blocks)
     against a single-rank f64 Context (MR_REF_TOL nm); (c) the ranks'
     eta and box bit-identical, the global molecule count conserved;
     (d) a forced migration (every position moved by box_x / 4, a
     rebuild) that relabels bit for bit; (e) the steps' resident-block
     launches on each rank (one a step), no other sweep launch and no
     plain sweep on the card; (f) NCCL at world size 1 against the
     single f32 Context (phase 2's floors), the two stepped on that rank
     (ms/step; `phase_resident(..., profile=True)` adds a torch.profiler
     table of each); (g) tools/dryrun_multichip.py's part 1b on the same
     ranks.  Each rank's peak memory and ms/step printed beside phase
     18's ShardedContext ranks' (not gated: the ranks time-share one
     card)
 20. the long-run tools at full width (tools/measure_drift.py,
     validate_npt.py, validate_flatnpt.py): (a) the JAX drift run's
     checkpoint (data/drift_100k_state.npz, read by convert.py::
     load_jax_checkpoint) in the bench Context (tools/setups.py::
     bench_context): its step and series position the recorded ones,
     the group KE reading the JAX CSV's last temperatures (1e-4 K), the
     f32 force pass there against f64 (phase 2's floors); (b) the drift
     tool's loop from that state, PHYS_SAMPLES samples of
     PHYS_SAMPLE_STEPS steps in one Context against half of them, the
     session's checkpoint, a fresh Context resumed from it in a process
     of its own (beside this one's second half) and the other half:
     positions, compensation, velocities, group KE and the CSV bit for
     bit, B1 launched at every step and no plain sweep, no latch, the
     wall held; (c) validate_npt's loop at 500 waters (the JAX 4^3
     grid of window 2, as a half stencil of explicit images) for
     PHYS_NPT_STEPS steps from its minimized start: density and U finite
     and plausible, barostat attempts (B1's energy launches), the routed
     kernel B1 launched at every step, no plain sweep; then B1's force
     and energy instantiations on that grid against their plain versions
     in f32 and f64 (phase 2's limits); (d)
     validate_flatnpt's loop, 8 x 500 waters at 0.7 nm, PHYS_FLAT_PS ps:
     the layout and pad replicas, finite densities, B1's scaled
     instantiations with barostat attempts, no plain sweep.  (c) and (d)
     run in child processes beside (a) and (b)
 21. the seconds of each phase, the `kernels` JSON line (each kernel's
     force and energy instantiations, Ewald and reaction field, the
     triclinic runs, the replica bands, the per-replica scales, the
     switched LJ, B1's home-slab range and its resident block), then the
     result line.

Imports nothing of JAX or of the JAX package.
"""

import dataclasses
import gc
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

T0 = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))
# the large single-card path: the bench snapshot tiled TILE^3 times
# (800,000 atoms at TILE = 2), settling and timed steps
TILE = 2
N_SETTLE_BIG = 64
N_TIMED_BIG = 64
# B2's bricks timed against the one it runs (sweep_chunked.BRICK)
RIVAL_BRICKS = ((2, 2, 2), (1, 2, 4), (1, 2, 2))

# H100 SXM published peaks (NVIDIA data sheet, 700 W): float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# B1 operation count: every pair test is a distance and a compare (~9
# float32 ops); every pair inside the cutoff adds the LJ + A&S-erfc force
# and its row/reaction accumulation (~50, counting rsqrt and exp as one)
OPS_PER_TEST = 9
OPS_PER_PAIR = 50
# the energy instantiation: each pair inside the cutoff costs the LJ
# energy, erfcf (~25 operations: CUDA's rational approximation with its
# exp) and a float64 add (~45 in all)
OPS_PER_PAIR_ENERGY = 45
# the reaction field in place of the erfc: a kept pair's force costs the
# LJ and qq (krf - 1/(2 r^3)) terms and its row and reaction adds (~33);
# its energy, LJ and qq (1/r + krf r^2 - crf) and the float64 add (~25)
OPS_PER_PAIR_RF = 33
OPS_PER_PAIR_ENERGY_RF = 25
# the LJ switch on a pair inside the switching window (r_on < r < r_off):
# r, t, S and dS/dr^2 and the products (~20; ~12 for the energy's S)
OPS_SWITCH = 20
OPS_SWITCH_ENERGY = 12
# the force kernels' times recorded while B1 still added its reactions
# with atomics (NVIDIA H100 80GB HBM3, 700 W): B1 at 100k, B2 at 800k
# (C = 56); each run prints its own beside them
RECORDED_MS = {"b1_sweep": 0.7332, "b2_sweep": 7.1033}
# relative limits of the energy instantiations: against the plain energy
# in f32 and in f64, of |E|
E_PLAIN_REL = 1e-6
E_F64_REL = 1e-5
# phase 5: the example's own steps, barostat and reporter intervals, and
# the checkpoint replay; phase 6: the NPT steps and barostat interval
EX_STEPS, EX_BARO, EX_REPORT, EX_REPLAY = 2000, 100, 500, 100
EX_SAMPLE = 10
NPT_STEPS, NPT_BARO = 200, 25
# phase 3: the checkpoint replay through B1
REPLAY_STEPS = 32
# phases 7 and 8: the timed steps (in blocks of BLOCK, the rebuild
# interval), the steps counted through B2's RF instantiation, FIRE
# iterations, and the bath bands (the run's mean, sampled every BLOCK
# steps; the last instantaneous values) for the user
# groups and the Drude bath, written before the first card run of the
# phases: the ionic liquid's baths target 400 / 400 K (cation, anion)
# and 1 K, the polymer's 300 / 300 K (polymer, water) and 1 K
IL_STEPS, IL_B2_STEPS, IL_MIN = 192, 16, 300
# steps between the minimized start and the banded window: the baths
# swing between 200 and 600 K for ~0.8 ps after the minimized lattice
# is given 400 K velocities, then hold near 400 K (PERF.md)
IL_SETTLE = 1024
POLY_STEPS, POLY_MIN = 96, 300
# the polymer's chains start overlapping one another (the builder places
# random walks), so its bath starts hot: settle as the ionic liquid
POLY_SETTLE = 1024
BLOCK = 16
IL_BANDS = {"mean": ((300.0, 500.0), (300.0, 500.0), (0.0, 10.0)),
            "last": ((200.0, 600.0), (200.0, 600.0), (0.0, 20.0))}
POLY_BANDS = {"mean": ((225.0, 375.0), (225.0, 375.0), (0.0, 10.0)),
              "last": ((150.0, 450.0), (150.0, 450.0), (0.0, 20.0))}
# phase 9: the JAX package's sheared 100k box (scripts/
# check_triclinic_tpu.py): b = (0.2 L, L, 0), c = (0.1 L, 0.15 L, L);
# FIRE iterations, settling, timed, B2-routed and NPT steps; the bath
# bands, written before the phase's first card run: the run's mean in
# phase 3's bands, the last in phase 5's.  The minimized lattice
# releases ~28 kJ/mol a molecule, and the single Nose-Hoover chain then
# rings between ~90 and ~840 K with a period of ~0.85 ps, decaying by
# ~0.6 a half period (PERF.md): the phase settles TRI_SETTLE steps, then
# starts again from the settled positions with a fresh chain and 300 K
# velocities (as a user starts production from equilibrated
# coordinates), and settles TRI_SETTLE steps more
TRI_SHEAR = (0.2, 0.1, 0.15)
TRI_MOL, TRI_MIN, TRI_SETTLE, TRI_STEPS = 20000, 300, 512, 96
TRI_B2_STEPS, TRI_NPT_STEPS, TRI_BARO = 16, 100, 25
TRI_BANDS = {"mean": ((250.0, 350.0), (150.0, 450.0), (0.0, 10.0)),
             "last": ((200.0, 420.0), (150.0, 450.0), (0.0, 10.0))}
# phase 10: the JAX package's scripts/bench_replicas.py --flat: 64
# replicas of build_water_box(800) (4,000 atoms), the template settled
# FLAT_TPL_SETTLE steps on the dense strategy as the script does, then
# (the lattice start rings the single NH chain: the ensemble's window
# read a water bath of 363 K after 500 template steps alone, 290 K with
# a restart; one replica on the card, PERF.md) restarted with a fresh
# chain and 300 K velocities for FLAT_TPL_SETTLE steps more; the
# ensemble FLAT_SETTLE settling steps, then FLAT_REPEATS x FLAT_STEPS
# timed; the steps of a
# Context routed to B2; the replicas held against single-replica f64
# Contexts (two at the edges of the x bands, two of the z bands); the
# bath bands over the 64 replicas, written before the phase's first card
# run: the water bath's mean over the replicas and the samples (one at
# the end of each timed run) in phase 3's bands, each replica's last
# water temperature in phase 5's wider band
FLAT_MOL, FLAT_REPLICAS, FLAT_LAYOUT = 800, 64, (7, 10)
FLAT_TPL_SETTLE, FLAT_SETTLE, FLAT_STEPS, FLAT_REPEATS = 500, 128, 64, 3
FLAT_B2_STEPS = 16
FLAT_EDGE_REPLICAS = (0, 9, 10, 69)
FLAT_BANDS = {"mean": ((250.0, 350.0), (150.0, 450.0), (0.0, 10.0)),
              "replica": (150.0, 450.0)}
# phase 11: flat NPT at phase 10's width from its settled template, the
# barostat of the JAX package's scripts/validate_flatnpt_tpu.py
# (MonteCarloBarostat(1.01325, 300, 25)): FLAT_NPT_SETTLE settling
# steps, FLAT_NPT_REPEATS x FLAT_NPT_STEPS timed (the best reported, as
# phase 10); a Context routed to B2 with a move every FLAT_NPT_B2_BARO
# steps; a checkpoint replay of FLAT_NPT_REPLAY steps (an attempt among
# them); the bands of each replica's scale and density, written before
# the phase's first card run (the bath bands are phase 10's)
FLAT_NPT_BARO, FLAT_NPT_SETTLE, FLAT_NPT_STEPS, FLAT_NPT_REPEATS = \
    25, 128, 64, 3
FLAT_NPT_B2_STEPS, FLAT_NPT_B2_BARO, FLAT_NPT_REPLAY = 16, 4, 32
FLAT_NPT_BANDS = {"scale": (0.97, 1.03), "density": (0.95, 1.05)}
# phase 12: the force-field XML path at 100k: the example's generated
# box (492 : 10 : 10) times 40, written as PDB files and read back
# through PDBFile -> ForceField(tests/data/swm4_nacl.xml) -> Modeller ->
# createSystem(PME, 1.0, HBonds, rigidWater); the NBFIX and NBTHOLE
# values of the deck (its NBFixPair and NBTholePair) for the hand-built
# System it is held against; FIRE iterations, settling steps (twice:
# the minimized lattice rings the single chain, see phase 9), the
# counted NPT steps and the barostat's frequency; the bands, written
# before the phase's first card run: the baths' run means in phase 3's
# bands, the last in phase 9's, and the density (1 M NaCl in SWM4-NDP is
# near 1.04 g/mL) in FF_DENSITY.  The Drude bath's band was (0, 10) K
# there; this deck's Drude bath holds at 16-17 K over 1,600 steps on an
# NVIDIA H100 (700 W) and the JAX package reads 13-23 K on the same deck
# at 2,500 atoms: the 400 ions' Drudes (Cl-: q_D = -3.46 e), which sit
# at the wall, not a fault of the port, so its band is (0, 25) K
# (PERF.md)
FF_WATER, FF_IONS = 19680, 400
FF_NBFIX_SIGMA, FF_NBFIX_EPS, FF_NBTHOLE = 0.31, 0.20, 2.6
FF_MIN, FF_SETTLE, FF_STEPS, FF_BARO = 200, 512, 400, 25
FF_BANDS = {"mean": ((250.0, 350.0), (150.0, 450.0), (0.0, 25.0)),
            "last": ((200.0, 420.0), (150.0, 450.0), (0.0, 25.0))}
FF_DENSITY = (0.98, 1.10)
# phase 13: SHAKE clusters at 100k (the deck with rigidWater=False: O-H
# constraints only), NVT from phase 12's final state, SHAKE_STEPS steps
# in blocks of BLOCK; bands as phase 12's
SHAKE_STEPS = 208
SHAKE_BANDS = FF_BANDS
# phase 15: switched LJ at full width, the cutoffs CHARMM-GUI writes for
# Drude decks (switchDistance 1.0 nm at a 1.2 nm cutoff): the deck of
# phase 12 from its final state in NVT, settling and counted steps
# (bands as phase 12's), the steps of the B2-routed Context and of the
# switched ionic liquid (phase 7's final state)
SW_CUTOFF, SW_ON = 1.2, 1.0
# the switch's own effect on a force kernel (switch_effect): its error
# against the plain version's in f64, as a fraction of the effect's max.
# The deck's float32 floor is ~2e-2 of it (the ions' contact LJ forces,
# ~7,700 kJ/mol/nm, round in the accumulators; 4e-4 on the ionic
# liquid; NVIDIA H100 80GB HBM3, 700 W); a dropped switch reads 1, a
# dropped dS/dr^2 term O(1)
SW_EFFECT_TOL = 5e-2
SW_SETTLE, SW_STEPS, SW_B2_STEPS, SW_IL_STEPS = 64, 208, 16, 16
# phase 16: ReplicaEnsemble, scripts/bench_replicas.py without --flat:
# 64 replicas of build_water_box(800) from phase 10's settled template;
# one replica held against a standalone f64 Context over
# REP_CHECK_STEPS steps (positions within REP_CHECK_TOL nm: float32
# forces against float64 over 20 fs), settling steps, then the best of
# REP_REPEATS x REP_STEPS
REP_REPLICAS, REP_CHECK_REPLICA, REP_CHECK_STEPS = 64, 37, 20
REP_CHECK_TOL = 1e-4
REP_SETTLE, REP_STEPS, REP_REPEATS = 64, 64, 3
# the dense block term takes ~0.35 s a step at 64 x 4k (NVIDIA H100
# 80GB HBM3, 700 W; PERF.md): its window is REP_REPEATS x
# REP_DENSE_STEPS after the check's steps, with no settling of its own
REP_DENSE_SETTLE, REP_DENSE_STEPS = 0, 8
# force passes timed at each of the dense term's two block sizes
REP_BLOCK_REPS = 2
# phase 17: float32 steps on the neighbour lists; the reporters' steps
# and intervals on the example box
REST_CELL_STEPS = 32
REST_REPORT_STEPS, REST_DCD_EVERY, REST_PDB_EVERY = 100, 25, 50


def log(msg):
    print(f"[chip_smoke {time.time() - T0:7.1f}s] {msg}", flush=True)


_mark = [T0]


def phase_mark():
    """Seconds since the previous mark (the start for the first)."""
    now = time.time()
    dt_s, _mark[0] = now - _mark[0], now
    return dt_s


def fail(msg):
    log(f"FAILED: {msg}")
    sys.exit(1)


def cuda_time_ms(fn, reps, warm=True):
    """Mean device time of fn() over `reps` calls, by CUDA events, after
    one call to warm it (warm=False: fn() has just run on these inputs,
    as a plain version has where it was held against its kernel)."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_split(fn, reps=10):
    """Device ms a call of each CUDA kernel that fn() launches, from
    torch.profiler over `reps` calls (B1's sweep and its fixed-order
    gather)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"(\w+_kernel)\b", e.key)
        if e.device_time_total > 0 and m:
            out[m.group(1)] = (out.get(m.group(1), 0.0)
                               + e.device_time_total / reps / 1e3)
    return out


def offset_shift(shifts, cfg, o, d):
    """Offset o's shift along d, broadcastable to (n_cells, C): a number
    for an (n_off, 3) table, each home cell's replica's for a
    per-replica (R, n_off, 3) one (flat-ensemble NPT)."""
    import torch
    from openmm_drudenose_tpu_torch.forces import cellpair
    if shifts.dim() == 2:
        return shifts[o, d]
    rep = torch.as_tensor(cellpair.rep_of_cell(cfg), device=shifts.device)
    return shifts[rep, o, d][:, None]


def pair_counts(fields, cfg, shifts, r_on=None, cells=None):
    """(pair tests, pairs inside the cutoff, pairs inside the cutoff and
    beyond r_on (0 without r_on: the LJ switch's window)) that this
    run's slot data gives the sweep: occupied-slot products over the
    half stencil (of the home cells in `cells`, all by default)."""
    import torch
    nc, C = cfg.n_cells, cfg.capacity
    lo, hi = (0, nc) if cells is None else cells
    dev = fields["x"].device
    count = fields["count"].long()
    nbr = torch.as_tensor(cfg.nbr_map, device=dev)[lo:hi]
    occ = torch.arange(C, device=dev)[None, :] < count[:, None]
    xyz = [fields[k].reshape(nc, C) for k in "xyz"]
    n_tests = int(torch.sum(count[lo:hi] * (count[lo:hi] - 1)))
    n_cut = n_win = 0
    cut2 = cfg.cutoff * cfg.cutoff
    for o in range(cfg.n_offsets):
        b = nbr[:, o]
        r2 = 0
        for d in range(3):
            sh = offset_shift(shifts, cfg, o, d)
            if torch.is_tensor(sh) and sh.dim() == 2:
                sh = sh[lo:hi]
            diff = xyz[d][lo:hi, :, None] - (xyz[d][b] + sh)[:, None, :]
            r2 = r2 + diff * diff
        ok = (r2 < cut2) & occ[lo:hi, :, None] & occ[b][:, None, :]
        if o == 0:
            ok = ok & ~torch.eye(C, dtype=torch.bool, device=dev)
        else:
            n_tests += int(torch.sum(count[lo:hi] * count[b]))
        n_cut += int(torch.sum(ok))
        if r_on is not None:
            n_win += int(torch.sum(ok & (r2 > r_on * r_on)))
    return n_tests, n_cut, n_win


def sweep_bound(fields, cfg, shifts, energy=False, method="ewald",
                r_switch=None, cells=None):
    """(bound ms, "operations" or "bytes", pair tests, pairs inside the
    cutoff, bytes) of the direct-space sweep on these fields: the larger
    of its FP32 operations over the card's peak and the bytes it must
    move (each field read once, the forces, or the energy, written once)
    over the memory rate.  B1 and B2 compute the same function, so both
    are held to this one bound (one for each instantiation and Coulomb
    kind; with r_switch, the switch's operations on the pairs of its
    window added).  cells: a home-slab range (B1's), whose stencils are
    counted: the fields of the cells they reach are read, every slot's
    force written."""
    n_tests, n_cut, n_win = pair_counts(fields, cfg, shifts, r_switch,
                                        cells)
    lo, hi = (0, cfg.n_cells) if cells is None else cells
    n_read = int(np.unique(cfg.nbr_map[lo:hi]).size)
    n_slots = cfg.n_cells * cfg.capacity
    n_bytes = (n_read * cfg.capacity * 8 * 4 + n_read * 4
               + (hi - lo) * cfg.n_offsets * 4 + shifts.numel() * 4
               + cfg.n_offsets * 4
               + (8 * cfg.n_replicas if energy and shifts.dim() == 3
                  else 8 if energy else n_slots * 3 * 4))
    per_pair = {("ewald", False): OPS_PER_PAIR,
                ("ewald", True): OPS_PER_PAIR_ENERGY,
                ("rf", False): OPS_PER_PAIR_RF,
                ("rf", True): OPS_PER_PAIR_ENERGY_RF}[(method, energy)]
    t_ops = (OPS_PER_TEST * n_tests + per_pair * n_cut
             + (OPS_SWITCH_ENERGY if energy else OPS_SWITCH) * n_win) \
        / PEAK_FP32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), bound_by, n_tests, n_cut, n_bytes


def cutoff_flips(fa, fb, cfg, sha, shb):
    """Slots of atoms in a pair that two precisions put on opposite sides
    of the cutoff (r^2 rounds differently within ~1e-7 of cutoff^2; the
    Ewald force there is ~1 kJ/mol/nm for a pair of SWM4 core charges, an
    input-rounding effect no float32 sweep avoids), and their count."""
    import torch
    nc, C = cfg.n_cells, cfg.capacity
    dev = fa["x"].device
    count = fa["count"].long()
    nbr = torch.as_tensor(cfg.nbr_map, device=dev)
    occ = torch.arange(C, device=dev)[None, :] < count[:, None]
    cut2 = cfg.cutoff * cfg.cutoff
    hits = torch.zeros((nc, C), dtype=torch.int64, device=dev)
    n_flip = 0

    def inside(f, sh, b, o):
        r2 = 0
        for d, k in enumerate("xyz"):
            v = f[k].reshape(nc, C)
            diff = v[:, :, None] - (v[b] + offset_shift(sh, cfg, o, d))[
                :, None, :]
            r2 = r2 + diff * diff
        return r2 < cut2

    for o in range(cfg.n_offsets):
        b = nbr[:, o]
        x = (inside(fa, sha, b, o) != inside(fb, shb, b, o)) \
            & occ[:, :, None] & occ[b][:, None, :]
        if o == 0:
            x = x & ~torch.eye(C, dtype=torch.bool, device=dev)
        n_flip += int(torch.sum(x))
        hits += torch.sum(x, dim=2)
        hits.index_add_(0, b, torch.sum(x, dim=1).long())
    return (hits > 0).reshape(-1), n_flip


def counted(fn):
    """(fn(), launches, plain sweeps on the card) with every count set to
    0 just before fn() and read just after."""
    import torch
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.ops import sweep
    for k in sweep.launches:
        sweep.launches[k] = 0
    cellpair.plain_sweeps["cuda"] = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(sweep.launches), cellpair.plain_sweeps["cuda"]


def energy_check(tag, kernel, fields, cfg, shifts, alpha, card,
                 coulomb=None, excl_skip=True):
    """A kernel's energy instantiation on these fields (of the Coulomb
    kind `coulomb`, the compiled term's keywords; Ewald by default)
    against its plain version in f32 (E_PLAIN_REL of |E|) and in f64
    (E_F64_REL of |E|), launched twice for the same bits, timed beside
    the plain version and the bound.  Returns the numbers of its
    `kernels` entry."""
    import torch
    from openmm_drudenose_tpu_torch.ops import sweep
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
    kw = dict(coulomb or {"method": "ewald"}, excl_skip=excl_skip)
    args = (fields, cfg, shifts, alpha, ONE_4PI_EPS0)
    e1 = kernel.pair_energy(*args, **kw)
    e2 = kernel.pair_energy(*args, **kw)
    torch.cuda.synchronize()
    identical = bool(torch.equal(e1, e2))
    ek = float(e1)
    ep = float(sweep.pair_energy_plain(*args, **kw))
    f64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in fields.items()}
    ep64 = float(sweep.pair_energy_plain(f64, cfg, shifts.double(), alpha,
                                         ONE_4PI_EPS0, **kw))
    del f64
    torch.cuda.empty_cache()
    rel, rel64 = abs(ek - ep) / abs(ep), abs(ek - ep64) / abs(ep64)
    ms = cuda_time_ms(lambda: kernel.pair_energy(*args, **kw), 20)
    plain_ms = cuda_time_ms(lambda: sweep.pair_energy_plain(*args, **kw), 1,
                            warm=False)
    bound_ms, bound_by, n_tests, n_cut, n_bytes = sweep_bound(
        fields, cfg, shifts, energy=True, method=kw["method"],
        r_switch=kw.get("r_switch"))
    log(f"{tag} energy {ek:.6f} kJ/mol; plain f32 {ep:.6f} (|dE|/|E| "
        f"{rel:.3e}), plain f64 {ep64:.6f} ({rel64:.3e}); two launches "
        f"bit-identical: {identical}; {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}: {n_tests} pair tests, "
        f"{n_cut} inside the cutoff, {n_bytes} bytes) on {card}")
    if not (np.isfinite(ek) and rel <= E_PLAIN_REL):
        fail(f"{tag} energy disagrees with its plain version: {rel:.3e}")
    if not rel64 <= E_F64_REL:
        fail(f"{tag} energy misses f64: {rel64:.3e}")
    if not identical:
        fail(f"{tag}: two energy launches gave different bits")
    return {"max_abs_err": abs(ek - ep), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "capacity": cfg.capacity}


def f32_floor(got, ref, skip=None, rms_skip=False):
    """(max, rms) of |got - ref| over max|ref|; the max leaves out the
    rows in `skip` (cutoff flips), the rms takes every row, or with
    rms_skip those the max takes: under the reaction field, whose force
    at the cutoff is qq 3 / ((2 eps_rf + 1) rc^2) (~19 kJ/mol/nm for two
    ionic-liquid cores, against ~1 for Ewald), one flipped pair alone can
    carry the rms past the floor."""
    import torch
    d = got.double() - ref.double()
    scale = float(torch.max(torch.abs(ref)))
    keep = d if skip is None else d[~skip]
    rms_rows = keep if rms_skip else d
    return (float(torch.max(torch.abs(keep))) / scale,
            float(torch.sqrt(torch.mean(rms_rows * rms_rows))) / scale)


def report_limits(cfgs):
    """(c) each kernel's registers, static shared memory and local bytes,
    read from the card, the card's limits, and the warps an SM holds of
    each (B2 at the brick it takes for each config of `cfgs`, {tag:
    config}).  Returns {kernel name: registers}."""
    import numpy as np
    from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
    b1_warps = sweep.load("sweep", sweep._declare).sweep_warps_per_cta()
    sms, b1_ctas = sweep.occupancy("cuda")
    lim = sweep_chunked.card_limits("cuda")
    a1 = sweep.attributes()
    a2 = sweep_chunked.attributes()
    e1 = sweep.attributes(energy=True)
    e2 = sweep_chunked.attributes(energy=True)
    b2 = []
    for tag, cfg in cfgs.items():
        brick = sweep_chunked.choose_brick(cfg, lim)
        warps = int(np.prod(brick))
        smem = sweep_chunked.smem_bytes(brick, cfg.capacity)
        b2.append(f"{tag} (C = {cfg.capacity}): brick {brick}, "
                  f"{sweep_chunked.resident_ctas(brick, cfg.capacity, lim)}"
                  f" CTAs of {warps} warps an SM, {smem} B dynamic shared "
                  "memory a CTA")
    log(f"1 (c) B1 {a1['regs']} registers, {a1['static_smem']} B static "
        f"shared memory, {a1['local_bytes']} B local, "
        f"{b1_ctas * b1_warps} warps an SM ({b1_warps} a CTA, "
        f"{b1_ctas} CTAs, cudaOccupancyMaxActiveBlocksPerMultiprocessor; "
        f"{sms} SMs); B2 {a2['regs']} registers, "
        f"{a2['static_smem']} B static, {a2['local_bytes']} B local; "
        + "; ".join(b2))
    log(f"1 (c) energy instantiations: B1 {e1['regs']} registers, "
        f"{e1['static_smem']} B static shared memory, {e1['local_bytes']} B "
        f"local, {sweep.occupancy('cuda', energy=True)[1]} CTAs an SM; B2 "
        f"{e2['regs']} registers, {e2['local_bytes']} B local")
    r1, r2 = sweep.attributes(False, "rf"), sweep_chunked.attributes(
        False, "rf")
    q1, q2 = sweep.attributes(True, "rf"), sweep_chunked.attributes(
        True, "rf")
    log(f"1 (c) reaction-field instantiations: B1 forces {r1['regs']} "
        f"registers, {r1['local_bytes']} B local, "
        f"{sweep.occupancy('cuda', False, 'rf')[1]} CTAs an SM; energy "
        f"{q1['regs']} registers, {q1['local_bytes']} B local; B2 forces "
        f"{r2['regs']} registers, {r2['local_bytes']} B local; energy "
        f"{q2['regs']} registers, {q2['local_bytes']} B local")
    log(f"1 (c) card: {lim.smem_block} B shared memory a CTA may opt in "
        f"to, {lim.smem_sm} B an SM ({lim.smem_reserved} B reserved a "
        f"CTA), {lim.regs_sm} registers and {lim.threads_sm} threads an SM")
    return {"b1_sweep": a1["regs"], "b2_sweep": a2["regs"],
            "b1_energy": e1["regs"], "b2_energy": e2["regs"]}


def held(tag, got, ref, limit):
    """max|got - ref| / max|ref|, failing the run above `limit`."""
    import numpy as np
    import torch
    err = float(torch.max(torch.abs(got - ref))) \
        / float(torch.max(torch.abs(ref)))
    if not (np.isfinite(err) and err <= limit):
        fail(f"{tag}: max|dF|/max|F| = {err:.3e} > {limit}")
    return err


def check_words(ctx, system):
    """(a) the bench fields with one more exclusion, between atoms 0 and
    40 (W = 40, three words; every intramolecular bit then lies in word
    1): B1 and B2 against the plain version (<= 2e-5) and the plain
    version in f64 (the f32 floor).  The exclusion test runs at every
    offset (the added pair may sit two cells apart)."""
    import numpy as np
    import torch
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
    nb, cfg, st = ctx._nb, ctx._cp_cfg, ctx._state
    nonbonded = next(f for f in system.getForces()
                     if type(f).__name__ == "NonbondedForce")
    exc = np.array([e[:2] for e in nonbonded._exceptions] + [(0, 40)])
    W = int(np.abs(exc[:, 0] - exc[:, 1]).max())
    n_words = (2 * W + 1 + 30) // 31
    cfg_w = dataclasses.replace(cfg, excl_window=W, excl_words=n_words)
    params = dict(nb.params, excl_words=torch.as_tensor(
        cellpair.build_exclusion_words(st.positions.shape[0], exc[:, 0],
                                       exc[:, 1], W, n_words),
        device=st.positions.device))
    box_diag = torch.diagonal(st.box)
    fields = cellpair.sorted_fields(params, st.positions, box_diag,
                                    st.neighbors, cfg_w)
    shifts = cellpair.offset_shifts(cfg_w, box_diag)
    args = (fields, cfg_w, shifts, nb.alpha, ONE_4PI_EPS0, False)
    route = sweep.route(cfg_w, limits=sweep_chunked.card_limits("cuda"))
    f_p = sweep.pair_forces_plain(*args)
    f64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in fields.items()}
    f_p64 = sweep.pair_forces_plain(f64, cfg_w, shifts.double(), nb.alpha,
                                    ONE_4PI_EPS0, False)
    flips, n_flip = cutoff_flips(fields, f64, cfg_w, shifts, shifts.double())
    msg = []
    for name, kernel in (("B1", sweep), ("B2", sweep_chunked)):
        f_k = kernel.pair_forces(*args)
        torch.cuda.synchronize()
        err = held(f"(a) {name} at W = {W}", f_k, f_p, 2e-5)
        err64, rms64 = f32_floor(f_k, f_p64, flips)
        if not (err64 <= 1e-4 and rms64 <= 5e-6):
            fail(f"(a) {name} at W = {W} misses the f32 floor against f64: "
                 f"max {err64:.3e}, rms {rms64:.3e}")
        msg.append(f"{name} vs plain {err:.3e}, vs plain f64 max {err64:.3e}"
                   f" rms {rms64:.3e}")
    log(f"2 (a) W = {W}, {n_words} exclusion words (route {route[0]}): "
        + "; ".join(msg) + f" ({n_flip} cutoff-flipped pairs left out of "
        "the max)")


def check_capacity(ctx, card, C=160):
    """(b) the bench snapshot sorted at capacity C: B1 and B2 against the
    plain version (<= 2e-5), both timed."""
    import torch
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
    nb, st = ctx._nb, ctx._state
    cfg_c = dataclasses.replace(ctx._cp_cfg, capacity=C)
    box_diag = torch.diagonal(st.box)
    cs = cellpair.build_cellsort(st.positions, box_diag, cfg_c)
    fields = cellpair.sorted_fields(nb.params, st.positions, box_diag, cs,
                                    cfg_c)
    args = (fields, cfg_c, cellpair.offset_shifts(cfg_c, box_diag),
            nb.alpha, ONE_4PI_EPS0)
    lim = sweep_chunked.card_limits("cuda")
    route = sweep.route(cfg_c, limits=lim)
    f_p = sweep.pair_forces_plain(*args)
    msg = []
    for name, kernel in (("B1", sweep), ("B2", sweep_chunked)):
        f_k = kernel.pair_forces(*args)
        torch.cuda.synchronize()
        err = held(f"(b) {name} at capacity {C}", f_k, f_p, 2e-5)
        ms = cuda_time_ms(lambda: kernel.pair_forces(*args), 5)
        msg.append(f"{name} vs plain {err:.3e}, {ms:.4f} ms")
    log(f"2 (b) capacity {C} (route {route[0]}; B2 brick "
        f"{sweep_chunked.choose_brick(cfg_c, lim)}): " + "; ".join(msg)
        + f" on {card}")
    del f_p, fields, cs
    torch.cuda.empty_cache()


def check_after_steps(ctx, phase):
    """Fail unless no latch is set (nor a drift warned in an earlier
    chunk), the hard wall held and positions, energies and bath
    temperatures are finite; returns the bath temperatures."""
    import numpy as np
    import torch
    nbl = ctx._state.neighbors
    if nbl is None:
        # the grid was planned again after the last chunk (a volume move
        # left the stencil short), its latches read there; sort afresh
        log(f"{phase} the cell grid was planned again after the last "
            f"chunk: {ctx._cp_cfg.grid}")
        ctx._ensure_neighbors()
        nbl = ctx._state.neighbors
    latches = {"overflow": bool(nbl.overflow),
               "drift": bool(nbl.drift_exceeded) or ctx._drift_warned,
               "excl_span": bool(nbl.excl_span_exceeded)
               if nbl.excl_span_exceeded is not None else False,
               "hardwall_runaway": ctx.hardwallRunaway}
    if any(latches.values()):
        fail(f"a latch is set: {latches}")
    spec = ctx._spec
    p = (ctx._state.positions.double() + ctx._state.pos_err.double())
    drude = torch.nonzero(spec.is_pair & ~spec.is_parent)[:, 0]
    dist = torch.linalg.norm(p[drude] - p[spec.partner[drude]], dim=1)
    dmax = float(torch.max(dist))
    state = ctx.getState(positions=True, energy=True, groups=True)
    temps = state.getGroupTemperatures()
    e_cons = ctx.getConservedEnergy()
    pe = state.getPotentialEnergy()
    log(f"{phase} latches clear; max core-Drude distance {dmax:.6f} nm; "
        f"bath temperatures {np.round(temps, 3).tolist()} K; PE {pe:.1f}, "
        f"conserved {e_cons:.1f} kJ/mol")
    if dmax > 0.02 * 1.00001:
        fail(f"hard wall broken: {dmax}")
    if not np.all(np.isfinite(state.getPositions())):
        fail("non-finite positions")
    if not (np.all(np.isfinite(temps)) and np.isfinite(e_cons)
            and np.isfinite(pe)):
        fail("non-finite temperatures or energies")
    return temps


def breakdown(ctx, kernel, name, ms_step, card, phase, reps=5):
    """Stream time of each part of the force pass at the current state
    (PME where the method has it, the bonded terms where the system has
    them; with per-replica scales, their scaled forms and the energies
    of a barostat attempt, mc_energies), against the whole step."""
    import torch
    from openmm_drudenose_tpu_torch.constraints.vsites import apply_vsites
    from openmm_drudenose_tpu_torch.forces import bonded, cellpair
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
    nb, cfg, st = ctx._nb, ctx._cp_cfg, ctx._state
    box_t = ctx._box_arg(st.box)
    rs = ctx._dev_scale(st.rep_scale)
    pos_comp = apply_vsites(ctx._spec, ctx._static, st.positions)
    fields = nb.fields(pos_comp, box_t, st.neighbors, rep_scale=rs)
    terms = [t for t in ctx._terms if isinstance(t, bonded._Term)]
    parts = {
        "sorted_fields": lambda: nb.fields(pos_comp, box_t, st.neighbors,
                                           rep_scale=rs),
        name: lambda: kernel(
            fields, cfg, cellpair.offset_shifts(cfg, box_t, rs), nb.alpha,
            ONE_4PI_EPS0, **nb.coulomb),
        "pme_recip": lambda: nb.recip(pos_comp, box_t, rep_scale=rs),
        "pair_terms": lambda: nb.extras(pos_comp, box_t, rep_scale=rs),
        "bonded": lambda: [t.energy_forces(pos_comp, box_t)
                           for t in terms],
        "force_pass": lambda: ctx._forces_only(st.positions, st.box,
                                               st.neighbors, st.pos_err,
                                               st.rep_scale),
        "cell_rebuild": lambda: ctx._neighbor_fn(st.positions, st.box,
                                                 st.rep_scale),
        "mc_energies": lambda: ctx._mc_energies(
            st.positions, st.box, st.neighbors, st.pos_err, st.rep_scale),
    }
    if nb.pme is None:
        del parts["pme_recip"]
    if not terms:
        del parts["bonded"]
    if rs is None:
        del parts["mc_energies"]
    times = {k: cuda_time_ms(fn, reps) for k, fn in parts.items()}
    log(f"{phase} breakdown (ms of stream time): " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items())
        + f"; whole step {ms_step:.3f} on {card}")
    return times


def force_pass_floor(ctx, ctx64, rms_skip=False, flips_out=None):
    """The f32 context's force pass against the f64 context's at the same
    state: (max, max over all atoms, rms, cutoff-flipped pairs, max|F|,
    rms over all atoms), the max leaving out the atoms of pairs the two
    passes (each at its own virtual-site positions) put on opposite sides
    of the cutoff, and the parents of flipped virtual sites, whose forces
    land there; the rms too with rms_skip (f32_floor).  `flips_out`, a
    list, receives the mask of those atoms."""
    import torch
    from openmm_drudenose_tpu_torch.constraints.vsites import apply_vsites
    from openmm_drudenose_tpu_torch.forces import cellpair
    ctx._ensure_forces()
    ctx64._ensure_forces()
    f32_forces = ctx._state.forces
    f64_forces = ctx64._state.forces
    nb, cfg, st = ctx._nb, ctx._cp_cfg, ctx._state
    box_t = ctx._box_arg(st.box)
    # per-replica box scales (flat-ensemble NPT; None elsewhere)
    rs = ctx._dev_scale(st.rep_scale)
    rs64 = ctx64._dev_scale(ctx64._state.rep_scale)
    shifts = cellpair.offset_shifts(cfg, box_t, rs)
    # the f32 pass takes its distances from the compensated positions
    fa = nb.fields(apply_vsites(ctx._spec, ctx._static, st.positions),
                   box_t, st.neighbors,
                   ctx._exact_positions(st.positions, st.pos_err), rs)
    box64 = ctx64._box_arg(ctx64._state.box)
    fb = nb.fields(apply_vsites(ctx64._spec, ctx64._static,
                                ctx64._state.positions), box64, st.neighbors,
                   rep_scale=rs64)
    # each pass with its own box's offset shifts
    slot_flips, n_flip = cutoff_flips(fa, fb, cfg, shifts,
                                      cellpair.offset_shifts(cfg, box64,
                                                             rs64))
    n_atoms = st.positions.shape[0]
    sa = st.neighbors.slot_atom
    atom_flips = torch.zeros(n_atoms, dtype=torch.bool, device=sa.device)
    atom_flips[sa[slot_flips & (sa < n_atoms)]] = True
    sites = atom_flips[ctx._spec.vs_avg_idx]
    atom_flips[ctx._spec.vs_avg_p[sites].reshape(-1)] = True
    ferr_all, frms_all = f32_floor(f32_forces, f64_forces)
    ferr, frms = f32_floor(f32_forces, f64_forces, atom_flips, rms_skip)
    fs = float(torch.max(torch.abs(f64_forces)))
    if flips_out is not None:
        flips_out.append(atom_flips)
    return ferr, ferr_all, frms, n_flip, fs, frms_all


def phase_big(card, bench_args, bench_system):
    """4. kernel B2 and the large single-card path: B2 forced at 100k
    against B1 on the bench fields; the bench snapshot tiled TILE^3
    times (800,000 atoms, 30^3 cells, where the gates route the sweep to
    B2), fresh 300 K velocities (seed 0), N_SETTLE_BIG settling steps;
    B2 on its fields against its plain version, the plain version in f64
    and B1, launched twice for bit-identical forces, timed beside B1 and
    plain; N_TIMED_BIG steps with the launch counts reset just before and
    read just after (B2 launched, B1 never); latches, wall, finiteness,
    the f32 force pass against f64, the breakdown.  Returns B2's kernel
    entry."""
    import numpy as np
    import torch
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.io import builders
    from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0, ns_per_day

    card_lim = sweep_chunked.card_limits("cuda")
    f2 = sweep_chunked.pair_forces(*bench_args)
    f1 = sweep.pair_forces(*bench_args)
    torch.cuda.synchronize()
    scale = float(torch.max(torch.abs(f1)))
    err = float(torch.max(torch.abs(f2 - f1))) / scale
    ms100 = cuda_time_ms(lambda: sweep_chunked.pair_forces(*bench_args), 20)
    plan = sweep_chunked.plan_for(bench_args[1], limits=card_lim)
    log(f"4 B2 forced at 100k vs B1: max|dF|/max|F| = {err:.3e}; B2 "
        f"{ms100:.4f} ms (brick {plan.brick}, {plan.total_chunks} "
        f"chunks) on {card}")
    if not err <= 2e-5:
        fail(f"B2 disagrees with B1 at 100k: {err:.3e}")
    del f1, f2

    # a lattice start latches the drift check within 64 steps in both
    # packages (violently unequilibrated), so the path starts from the
    # equilibrated 100k snapshot tiled TILE x TILE x TILE
    t = time.time()
    snap = np.load(os.path.join(HERE, "data", "bench_equil_100k.npz"))
    n0 = int(snap["n_atoms"])
    box0 = np.diagonal(np.array(bench_system.getDefaultPeriodicBoxVectors(),
                                np.float64))
    shifts3 = np.array([[i, j, k] for i in range(TILE) for j in range(TILE)
                        for k in range(TILE)], np.float64) * box0
    pos = (np.asarray(snap["positions"], np.float64)[None]
           + shifts3[:, None, :]).reshape(-1, 3)
    system, _ = builders.build_water_box(TILE ** 3 * n0 // 5)
    # a box float32 holds exactly: the f32 and f64 contexts then simulate
    # the same box, and the f32-vs-f64 check compares arithmetic only
    box = (TILE * box0).astype(np.float32).astype(np.float64)
    system.setDefaultPeriodicBoxVectors((box[0], 0, 0), (0, box[1], 0),
                                        (0, 0, box[2]))
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision="single", device="cuda")
    cap0 = ctx._cp_cfg.capacity
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, seed=0)
    ctx._ensure_neighbors()
    nb, cfg = ctx._nb, ctx._cp_cfg
    n_atoms = pos.shape[0]
    tag = f"{n_atoms // 1000}k"
    plan = sweep_chunked.plan_for(cfg, limits=card_lim)
    log(f"4 context in {time.time() - t:.1f} s: {n_atoms} atoms, the 100k "
        f"snapshot tiled {TILE}x{TILE}x{TILE}, cell grid {cfg.grid}, "
        f"capacity {cap0} (auto) -> {cfg.capacity}, {cfg.n_offsets} "
        f"offsets, PME grid {nb.pme.grid}; route {nb.sweep_kernel} (JAX "
        f"chunk height {nb.pallas_chunk}); B2 brick {plan.brick}, frame "
        f"{plan.frame}, {plan.total_chunks} chunks, frame buffer "
        f"{plan.frame_floats(cfg.capacity) * 4} bytes "
        f"({plan.frame_floats(cfg.capacity)} floats, int32 max "
        f"{2 ** 31 - 1})")
    if nb.sweep_kernel != "b2":
        fail(f"the {tag} config routes to {nb.sweep_kernel}, not B2")
    # the frame buffer of the JAX package's 1M-atom configuration (33^3
    # cells, auto capacity 40, 48 once grown) must index in int32 too
    for C in (40, 48):
        c1m = dataclasses.replace(cfg, grid=(33, 33, 33), capacity=C)
        p1m = sweep_chunked.plan_for(c1m, limits=card_lim)
        log(f"4 at 1M atoms (33^3 cells, C = {C}): brick {p1m.brick}, "
            f"{p1m.total_chunks} chunks, frame buffer "
            f"{p1m.frame_floats(C) * 4} bytes ({p1m.frame_floats(C)} "
            f"floats)")
        if p1m.frame_floats(C) > sweep_chunked.INT32_MAX:
            fail("the 1M frame buffer overflows int32 indices")
    t = time.time()
    integ.step(N_SETTLE_BIG)
    torch.cuda.synchronize()
    log(f"4 {N_SETTLE_BIG} settling steps in {time.time() - t:.2f} s; "
        f"capacity {ctx._cp_cfg.capacity}")
    # a window in which a cell overflowed reruns its steps at a grown
    # capacity (two launches a step): time such a window again
    for _ in range(2):
        cap_before = ctx._cp_cfg.capacity
        for k in sweep.launches:
            sweep.launches[k] = 0
        torch.cuda.synchronize()
        t = time.time()
        integ.step(N_TIMED_BIG)
        torch.cuda.synchronize()
        wall = time.time() - t
        launches = dict(sweep.launches)
        ms_step = wall / N_TIMED_BIG * 1e3
        nsd = ns_per_day(N_TIMED_BIG / wall, integ.getStepSize())
        log(f"4 {N_TIMED_BIG} steps at {tag} in {wall:.2f} s: {ms_step:.2f} "
            f"ms/step, {nsd:.4f} ns/day on {card}; launches {launches}; "
            f"capacity {cap_before} -> {ctx._cp_cfg.capacity}")
        if launches["b2_sweep"] < 1:
            fail("the large path never launched kernel B2")
        if launches["b1_sweep"] != 0:
            fail("the large path launched kernel B1")
        if ctx._cp_cfg.capacity == cap_before:
            break
    else:
        fail("the capacity grew in two timed windows running")
    # the kernels at the state and shapes the counted window ended with
    # (a grown capacity is a new config)
    nb, cfg, st = ctx._nb, ctx._cp_cfg, ctx._state
    if nb.sweep_kernel != "b2":
        fail(f"the {tag} config routes to {nb.sweep_kernel}, not B2")
    box_diag = torch.diagonal(st.box)
    fields = nb.fields(st.positions, box_diag, st.neighbors)
    shifts = cellpair.offset_shifts(cfg, box_diag)
    args = (fields, cfg, shifts, nb.alpha, ONE_4PI_EPS0)
    f_k = sweep_chunked.pair_forces(*args)
    f_k2 = sweep_chunked.pair_forces(*args)
    f_b1 = sweep.pair_forces(*args)
    torch.cuda.synchronize()
    identical = torch.equal(f_k, f_k2)
    f_p = sweep_chunked.pair_forces_plain(*args)
    scale = float(torch.max(torch.abs(f_p)))
    max_abs_err = float(torch.max(torch.abs(f_k - f_p)))
    err_plain = max_abs_err / scale
    err_b1 = float(torch.max(torch.abs(f_k - f_b1))) / scale
    del f_k2, f_b1, f_p
    f64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in fields.items()}
    f_p64 = sweep_chunked.pair_forces_plain(f64, cfg, shifts.double(),
                                            nb.alpha, ONE_4PI_EPS0)
    flips, n_flip = cutoff_flips(fields, f64, cfg, shifts, shifts.double())
    err64_all, _ = f32_floor(f_k, f_p64)
    err64, rms64 = f32_floor(f_k, f_p64, flips)
    del f64, f_p64, f_k
    torch.cuda.empty_cache()
    log(f"4 B2 at {tag} (capacity {cfg.capacity}) vs plain f32: "
        f"max|dF|/max|F| = {err_plain:.3e} (max|F| {scale:.1f}); vs plain "
        f"f64: max {err64:.3e} ({err64_all:.3e} with the "
        f"{int(flips.sum())} atoms of {n_flip} cutoff-flipped pairs), rms {rms64:.3e}; vs B1 {err_b1:.3e}; two "
        f"launches bit-identical: {identical}")
    if not (np.isfinite(err_plain) and err_plain <= 2e-5):
        fail(f"B2 disagrees with its plain version: {err_plain:.3e}")
    if not (err64 <= 1e-4 and rms64 <= 5e-6):
        fail(f"B2 misses the f32 floor against f64: max {err64:.3e}, "
             f"rms {rms64:.3e}")
    if not err_b1 <= 2e-5:
        fail(f"B2 disagrees with B1 at {tag}: {err_b1:.3e}")
    if not identical:
        fail("two B2 launches on the same fields gave different forces")
    ms = cuda_time_ms(lambda: sweep_chunked.pair_forces(*args), 10)
    ms_b1 = cuda_time_ms(lambda: sweep.pair_forces(*args), 10)
    plain_ms = cuda_time_ms(lambda: sweep_chunked.pair_forces_plain(*args),
                            1, warm=False)
    bound_ms, bound_by, n_tests, n_cut, n_bytes = sweep_bound(fields, cfg,
                                                              shifts)
    # B2's brick (sweep_chunked.BRICK) against its rivals
    lim = sweep_chunked.card_limits("cuda")
    chosen = sweep_chunked.choose_brick(cfg, lim)
    by_brick = {b: cuda_time_ms(
        lambda b=b: sweep_chunked.pair_forces(*args, brick=b), 10)
        for b in RIVAL_BRICKS
        if sweep_chunked.resident_ctas(b, cfg.capacity, lim) > 0}
    log(f"4 B2 by brick at C = {cfg.capacity}: " + ", ".join(
        f"{b} {t:.4f} ms" for b, t in by_brick.items())
        + f"; chosen {chosen} on {card}")
    e_entry = energy_check(f"4 B2 at {tag}", sweep_chunked, fields, cfg,
                           shifts, nb.alpha, card)
    del args, fields
    log(f"4 at {tag}: B2 {ms:.4f} ms (recorded before B1's fixed order: "
        f"{RECORDED_MS['b2_sweep']} ms on NVIDIA H100 80GB "
        f"HBM3, 700 W), B1 {ms_b1:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: {n_tests} "
        f"pair tests, {n_cut} inside the cutoff, {n_bytes} bytes) on {card}")

    _, e_launches, plain = counted(lambda: check_after_steps(ctx, "4"))
    log(f"4 the state's energy: launches {e_launches}, plain sweeps on the "
        f"card {plain}")
    if e_launches["b2_energy"] < 1 or plain:
        fail("the 800k state's energy did not come from B2's energy "
             "instantiation alone")

    st = ctx._state
    integ64 = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ64.setMaxDrudeDistance(0.02)
    ctx64 = dt.Context(system, integ64, precision="double",
                       nb_options={"capacity": ctx._cp_cfg.capacity},
                       device="cuda")
    ctx64.setPositions((st.positions.double() + st.pos_err.double())
                       .cpu().numpy())
    ferr, ferr_all, frms, n_flip, fs, _ = force_pass_floor(ctx, ctx64)
    del ctx64
    torch.cuda.empty_cache()
    log(f"4 force pass f32 vs f64 at {tag}: max {ferr:.3e} ({ferr_all:.3e} "
        f"with the atoms of {n_flip} cutoff-flipped pairs), rms "
        f"{frms:.3e} (max|F| {fs:.1f})")
    if not (ferr <= 1e-4 and frms <= 5e-6):
        fail(f"the f32 force pass at {tag} misses the f32 floor against "
             "f64")
    breakdown(ctx, sweep_chunked.pair_forces, "b2_sweep", ms_step, card,
              "4", reps=3)
    log(f"4 peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    src = "openmm_drudenose_tpu_torch/csrc/sweep_chunked.cu"
    tpu = "openmm_drudenose_tpu/ops/pallas_sweep.py:851"
    return [{
        "name": "b2_sweep", "instantiation": "forces", "route": "cuda",
        "source": src, "replaces": tpu,
        "launches": launches["b2_sweep"],
        "launches_per_step": launches["b2_sweep"] / N_TIMED_BIG,
        "capacity": cfg.capacity, "brick": list(chosen),
        "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "b2_energy", "instantiation": "energy", "route": "cuda",
        "source": src, "replaces": tpu,
        "launches": e_launches["b2_energy"], "brick": list(chosen),
        **e_entry, "library_ms": None,
    }]


def phase_example(card):
    """5. The reference example at its own size through the port's
    Simulation (examples/nacl_tg.py's workflow): the generated NaCl box,
    minimize(200), 300 K velocities, the barostat every EX_BARO steps,
    StateDataReporter every EX_REPORT, EX_STEPS steps; then the
    checkpoint replay.  Returns ms/step."""
    import torch
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.io import builders
    system, pos = builders.build_nacl_water_box(n_water=492, n_na=10,
                                                n_cl=10)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20)
    integ.setMaxDrudeDistance(0.02)
    system.addForce(dt.MonteCarloBarostat(1.01325, 300.0, EX_BARO))
    sim = dt.Simulation(None, system, integ, precision="single")
    ctx = sim.context
    if ctx._nb.strategy != "dense":
        fail(f"the example's box took the {ctx._nb.strategy} strategy")
    ctx.setPositions(pos)
    pe0 = ctx.getState(energy=True).getPotentialEnergy()
    t = time.time()
    sim.minimizeEnergy(maxIterations=200)
    torch.cuda.synchronize()
    t_min = time.time() - t
    pe1 = ctx.getState(energy=True).getPotentialEnergy()
    log(f"5 {system.getNumParticles()} atoms, {system.getNumConstraints()} "
        f"constraints, dense strategy; PE {pe0:.1f} -> {pe1:.1f} kJ/mol by "
        f"minimize(200) in {t_min:.2f} s")
    if not (np.isfinite(pe1) and pe1 < pe0):
        fail("minimization did not lower the energy")
    ctx.setVelocitiesToTemperature(300.0)
    out = io.StringIO()
    sim.reporters.append(dt.StateDataReporter(
        out, EX_REPORT, step=True, time=True, potentialEnergy=True,
        kineticEnergy=True, temperature=True, density=True,
        groupTemperatures=True, speed=True))
    box0 = ctx.getState().getPeriodicBoxVectors()
    nkbt = ctx._spec.nh_nkbt.double().numpy()
    targets = np.array([300.0, 300.0, 1.0])
    samples = []

    def drive():
        # the steps in blocks of EX_SAMPLE (the reporters fire where they
        # are due, as in one call), each block's last bath temperatures
        # read from the integrator's host-side chain state
        for _ in range(EX_STEPS // EX_SAMPLE):
            sim.step(EX_SAMPLE)
            samples.append(ctx._state.group_ke.double().numpy() / nkbt
                           * targets)

    t = time.time()
    _, launches, plain = counted(drive)
    wall = time.time() - t
    ms_step = wall / EX_STEPS * 1e3
    mean_temps = np.mean(samples, axis=0)
    for line in out.getvalue().strip().splitlines():
        log(f"5 | {line}")
    st = ctx.getState(positions=True, energy=True, groups=True)
    temps = st.getGroupTemperatures()
    box1 = st.getPeriodicBoxVectors()
    spec = ctx._spec
    p = ctx._state.positions.double() + ctx._state.pos_err.double()
    drude = torch.nonzero(spec.is_pair & ~spec.is_parent)[:, 0]
    dmax = float(torch.max(torch.linalg.norm(
        p[drude] - p[spec.partner[drude]], dim=1)))
    log(f"5 {EX_STEPS} steps in {wall:.2f} s: {ms_step:.3f} ms/step, "
        f"{EX_STEPS * 1e-6 / wall * 86400:.3f} ns/day on {card}; launches "
        f"{launches}; bath temperatures at the end "
        f"{np.round(temps, 3).tolist()} K, over the run (every "
        f"{EX_SAMPLE} steps) {np.round(mean_temps, 3).tolist()} K; "
        f"box {box0[0, 0]:.5f} -> {box1[0, 0]:.5f} nm; barostat move size "
        f"{ctx._state.baro_scale:.5f} nm^3; max core-Drude distance "
        f"{dmax:.6f} nm; runaway latch {ctx.hardwallRunaway}")
    if ctx.hardwallRunaway:
        fail("the hard-wall runaway latch is set")
    if dmax > 0.02 * 1.00001:
        fail(f"hard wall broken: {dmax}")
    if not (np.isfinite(st.getPotentialEnergy())
            and np.isfinite(st.getKineticEnergy())
            and np.all(np.isfinite(st.getPositions()))):
        fail("non-finite energies or positions")
    # the bands on the run's mean: after the minimized lattice releases
    # ~1e4 kJ/mol into ~1.5e3 internal DOF, the single NH chain swings
    # the instantaneous group-0 temperature over 210-350 K within 2 ps
    if not (250.0 < mean_temps[0] < 350.0 and 150.0 < mean_temps[1] < 450.0
            and 0.0 < mean_temps[2] < 10.0):
        fail(f"implausible bath temperatures {mean_temps}")
    # and the last instantaneous ones in a band wide enough for that swing
    # (runs have ended at 340-374 K), so that a thermostat fault near the
    # end still fails
    if not (200.0 < temps[0] < 420.0 and 150.0 < temps[1] < 450.0
            and 0.0 < temps[2] < 10.0):
        fail(f"implausible bath temperatures at the end {temps}")
    if np.array_equal(box1, box0):
        fail("no barostat move was accepted")

    # the checkpoint replay, in PyTorch's default (not deterministic)
    # mode, as a user runs it: every scatter-add of the port sums in a
    # fixed order (ops/scatter.py)
    path = os.path.join(HERE, "build", "chip_smoke", "nacl.chk")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if torch.are_deterministic_algorithms_enabled():
        fail("PyTorch's deterministic mode is on")
    sim.saveCheckpoint(path)
    sim.step(EX_REPLAY)
    first = ctx._state.positions.clone()
    sim.loadCheckpoint(path)
    sim.step(EX_REPLAY)
    second = ctx._state.positions.clone()
    same = bool(torch.equal(first, second))
    log(f"5 checkpoint saved at step {sim.currentStep - EX_REPLAY}, "
        f"{EX_REPLAY} steps, loaded, {EX_REPLAY} steps: positions bit for "
        f"bit {same} (max |dx| "
        f"{float(torch.max(torch.abs(first - second))):.3e} nm)")
    if not same:
        fail("the checkpoint replay did not give the same positions")
    return ms_step


def phase_npt(card, ms_step_nvt, pos, vel, cap):
    """6. NPT at full width through B1: the 100k system with
    MonteCarloBarostat(1.01325, 300, NPT_BARO) from the snapshot; B1's
    energy held and timed; NPT_STEPS steps counted; the state checked;
    then a forced 0.9x linear shrink: the grid planned again and B1 held
    against its plain version on it.  Returns B1's energy entry."""
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.io import builders
    system, _ = builders.build_water_box(pos.shape[0] // 5)
    system.addForce(dt.MonteCarloBarostat(1.01325, 300.0, NPT_BARO))
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision="single",
                     nb_options={"capacity": cap}, device="cuda")
    ctx.setPositions(pos)
    ctx.setVelocities(vel)
    return npt_checks("6", "100k", ctx, integ, card, ms_step_nvt, NPT_STEPS,
                      NPT_BARO)


def npt_checks(phase, tag, ctx, integ, card, ms_step_nvt, n_steps, freq):
    """A Context with a MonteCarloBarostat of frequency `freq`: B1's
    energy held and timed; n_steps steps counted (two B1 energy launches
    an attempt, no plain sweep); the state checked; then a forced 0.9x
    linear shrink: the grid planned again and B1 held against its plain
    version on it.  Returns B1's energy entry."""
    import torch
    from openmm_drudenose_tpu_torch.forces import boxutils, cellpair
    from openmm_drudenose_tpu_torch.integrators import barostat
    from openmm_drudenose_tpu_torch.ops import sweep
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
    ctx._ensure_forces()
    nb, cfg, st = ctx._nb, ctx._cp_cfg, ctx._state
    if nb.sweep_kernel != "b1":
        fail(f"the {tag} NPT config routes to {nb.sweep_kernel}, not B1")
    box_t = ctx._box_arg(st.box)
    entry = energy_check(f"{phase} B1 at {tag}", sweep,
                         nb.fields(st.positions, box_t, st.neighbors),
                         cfg, cellpair.offset_shifts(cfg, box_t),
                         nb.alpha, card)
    vol0 = float(boxutils.volume(st.box.double()))
    # the host time spent inside the attempts (their two host reads wait
    # for the work queued before them): the barostat's cost without the
    # host's drift between phases
    inside = []
    attempt = barostat.maybe_attempt_mc_move

    def timed_attempt(spec, static, state, *a, **kw):
        t0 = time.perf_counter()
        out = attempt(spec, static, state, *a, **kw)
        if out is not state:
            inside.append(time.perf_counter() - t0)
        return out

    barostat.maybe_attempt_mc_move = timed_attempt
    grid_start = cfg.grid
    t = time.time()
    try:
        _, launches, plain = counted(lambda: integ.step(n_steps))
    finally:
        barostat.maybe_attempt_mc_move = attempt
    wall = time.time() - t
    ms_step = wall / n_steps * 1e3
    attempts = len(range(0, n_steps, freq))
    st = ctx._state
    vol1 = float(boxutils.volume(st.box.double()))
    if len(inside) != attempts:
        fail(f"{len(inside)} attempts timed, {attempts} expected")
    log(f"{phase} {n_steps} NPT steps in {wall:.2f} s: {ms_step:.2f} "
        f"ms/step against {ms_step_nvt:.2f} without the barostat "
        f"({ms_step - ms_step_nvt:+.2f}) on {card}; {attempts} attempts, "
        f"{np.mean(inside) * 1e3:.2f} ms each inside the attempt (min "
        f"{np.min(inside) * 1e3:.2f}, max {np.max(inside) * 1e3:.2f}): "
        f"{np.sum(inside) * 1e3 / n_steps:.3f} ms/step; "
        f"launches {launches}; plain sweeps on the card {plain}; cell grid "
        f"{grid_start} -> {ctx._cp_cfg.grid} over the run; volume "
        f"{vol0:.3f} -> {vol1:.3f} nm^3, move size {st.baro_scale:.4f} "
        f"nm^3, {st.baro_naccept} of {st.baro_nattempt} accepted since the "
        f"last adaptation")
    if launches["b1_energy"] != 2 * attempts or plain:
        fail(f"expected {2 * attempts} B1 energy launches and no plain "
             "sweep in the NPT steps")
    if launches["b1_sweep"] < n_steps or launches["b2_sweep"]:
        fail("the NPT steps did not run their forces through B1")
    _, check_launches, plain = counted(lambda: check_after_steps(ctx,
                                                                 phase))
    if check_launches["b1_energy"] != 1 or plain:
        fail(f"the state's energy: {check_launches}, {plain} plain sweeps")
    entry["launches"] = launches["b1_energy"]
    entry["launches_per_step"] = launches["b1_energy"] / n_steps

    # a forced 0.9x linear shrink past the stencil
    grid0 = cfg.grid
    new_pos, new_box = barostat.scale_molecules(ctx._spec, ctx._static,
                                                st.positions, st.box, 0.9)
    ctx._state = st.replace(positions=new_pos, box=new_box, neighbors=None)
    ctx._forces_valid = False
    ctx._ensure_neighbors()
    nb, cfg, st = ctx._nb, ctx._cp_cfg, ctx._state
    if cfg.grid == grid0:
        fail("the shrunk box kept its cell grid")
    box_t = ctx._box_arg(st.box)
    fields = nb.fields(st.positions, box_t, st.neighbors)
    shifts = cellpair.offset_shifts(cfg, box_t)
    args = (fields, cfg, shifts, nb.alpha, ONE_4PI_EPS0)
    f_k = sweep.pair_forces(*args)
    e_k = float(sweep.pair_energy(*args))
    torch.cuda.synchronize()
    f_p = sweep.pair_forces_plain(*args)
    e_p = float(sweep.pair_energy_plain(*args))
    err = held(f"{phase} B1 forces on the replanned grid", f_k, f_p, 2e-5)
    rel = abs(e_k - e_p) / abs(e_p)
    box_w = float(st.box[0, 0])
    log(f"{phase} 0.9x shrink: box {box_w:.4f} nm, cell grid {grid0} -> "
        f"{cfg.grid}, capacity {cfg.capacity}, {cfg.n_offsets} offsets, PME "
        f"grid {nb.pme.grid}, route {nb.sweep_kernel}; B1 vs plain there: "
        f"forces {err:.3e} of max|F|, energy {rel:.3e} of |E|")
    if not rel <= E_PLAIN_REL:
        fail(f"B1's energy on the replanned grid: {rel:.3e}")
    return entry


def run_blocks(ctx, integ, n_steps, targets):
    """n_steps steps in blocks of BLOCK (the rebuild interval), counted,
    each block's last bath temperatures read from the integrator's
    host-side chain state.  Returns (ms/step, ns/day, launches, plain
    sweeps on the card, the run's mean bath temperatures)."""
    import torch
    from openmm_drudenose_tpu_torch.units import ns_per_day
    nkbt = ctx._spec.nh_nkbt.double().numpy()
    samples = []

    def drive():
        for _ in range(n_steps // BLOCK):
            integ.step(BLOCK)
            samples.append(ctx._state.group_ke.double().numpy() / nkbt
                           * targets)

    t = time.time()
    _, launches, plain = counted(drive)
    wall = time.time() - t
    return (wall / n_steps * 1e3, ns_per_day(n_steps / wall,
                                             integ.getStepSize()),
            launches, plain, np.mean(samples, axis=0))


def hold_bands(phase, names, mean, last, bands):
    """Fail unless the user groups' and the Drude bath's temperatures lie
    in their bands (the run's mean and the last); the COM bath is
    printed, not held."""
    log(f"{phase} bath temperatures ({', '.join(names)}): over the run "
        f"{np.round(mean, 3).tolist()} K, at the end "
        f"{np.round(last, 3).tolist()} K; bands {bands}")
    held_baths = (0, 1, len(mean) - 1)
    for key, temps in (("mean", mean), ("last", last)):
        for (lo, hi), b in zip(bands[key], held_baths):
            if not lo < temps[b] < hi:
                fail(f"{phase} bath {names[b]} ({key}) at {temps[b]:.3f} K "
                     f"outside ({lo}, {hi})")


def kernel_parity(phase, tag, kernel, args, kw, ref=None):
    """A force kernel on `args` with keywords `kw` against its plain
    version (2e-5 of max|F|), the plain version in f64 (the f32 floor)
    and `ref` (another kernel's forces, 2e-5), launched twice for the
    same bits; returns (forces, max |dF| against plain, ms, plain ms)."""
    import torch
    fields, cfg, shifts, alpha, scale = args
    f1 = kernel.pair_forces(*args, **kw)
    f2 = kernel.pair_forces(*args, **kw)
    torch.cuda.synchronize()
    identical = bool(torch.equal(f1, f2))
    f_p = kernel.pair_forces_plain(*args, **kw)
    max_abs_err = float(torch.max(torch.abs(f1 - f_p)))
    err = held(f"{phase} {tag} vs plain", f1, f_p, 2e-5)
    del f_p
    f64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in fields.items()}
    f_p64 = kernel.pair_forces_plain(f64, cfg, shifts.double(), alpha,
                                     scale, **kw)
    flips, n_flip = cutoff_flips(fields, f64, cfg, shifts, shifts.double())
    err64, rms64 = f32_floor(f1, f_p64, flips, kw["method"] == "rf")
    _, rms64_all = f32_floor(f1, f_p64)
    del f64, f_p64
    torch.cuda.empty_cache()
    msg = ""
    if ref is not None:
        msg = f"; vs B1 {held(f'{phase} {tag} vs B1', f1, ref, 2e-5):.3e}"
    ms = cuda_time_ms(lambda: kernel.pair_forces(*args, **kw), 20)
    plain_ms = cuda_time_ms(lambda: kernel.pair_forces_plain(*args, **kw),
                            1, warm=False)
    log(f"{phase} {tag} vs plain f32: max|dF|/max|F| = {err:.3e}; vs plain "
        f"f64: max {err64:.3e} (leaving out {n_flip} cutoff-flipped "
        f"pairs), rms {rms64:.3e} ({rms64_all:.3e} over all){msg}; two "
        f"launches bit-identical: "
        f"{identical}; {ms:.4f} ms, plain {plain_ms:.3f} ms")
    if not (err64 <= 1e-4 and rms64 <= 5e-6):
        fail(f"{phase} {tag} misses the f32 floor against f64: max "
             f"{err64:.3e}, rms {rms64:.3e}")
    if not identical:
        fail(f"{phase} {tag}: two launches gave different forces")
    return f1, max_abs_err, ms, plain_ms


def switch_effect(phase, tag, kernel, args, kw, ref=None):
    """The switch's own contribution to a force kernel: its switched minus
    its unswitched instantiation on `args`' fields with the charges
    zeroed (LJ alone: the f32 noise of the Coulomb sum, ~1e-6 of max|F|,
    would hide a window that moves the forces by ~1e-5 of it), against
    the plain version's difference in f64, relative to max|that
    difference| (<= SW_EFFECT_TOL).  The atoms of cutoff-flipped pairs
    are left out: the unswitched LJ force at the cutoff, ~0.01-0.1
    kJ/mol/nm a pair, is a step the two precisions take at different r.
    A kernel that dropped the switch misses by 1, one that dropped its
    dS/dr^2 term by O(1).  `ref`: the plain difference of an earlier call
    on the same fields.  Returns (error, ref)."""
    import numpy as np
    import torch
    fields, cfg, shifts, alpha, scale = args
    lj = dict(fields, q=torch.zeros_like(fields["q"]))
    kw_u = {k: v for k, v in kw.items() if k != "r_switch"}
    lj_args = (lj, cfg, shifts, alpha, scale)
    d_k = (kernel.pair_forces(*lj_args, **kw)
           - kernel.pair_forces(*lj_args, **kw_u)).double()
    if ref is None:
        lj64 = {k: (v.double() if v.is_floating_point() else v)
                for k, v in lj.items()}
        a64 = (lj64, cfg, shifts.double(), alpha, scale)
        f_sw = kernel.pair_forces_plain(*a64, **kw)
        d_p = f_sw - kernel.pair_forces_plain(*a64, **kw_u)
        flips, n_flip = cutoff_flips(lj, lj64, cfg, shifts, shifts.double())
        ref = (d_p, flips, n_flip, float(torch.max(torch.abs(d_p)))
               / float(torch.max(torch.abs(f_sw))))
        del lj64, f_sw
    d_p, flips, n_flip, rel = ref
    scale_d = float(torch.max(torch.abs(d_p)))
    diff = torch.abs(d_k - d_p)
    err = float(torch.max(diff[~flips])) / scale_d
    err_all = float(torch.max(diff)) / scale_d
    log(f"{phase} {tag}, the switch's own effect (switched minus "
        f"unswitched, LJ alone) against the plain version's in f64: "
        f"max|dF| {err:.3e} of its max {scale_d:.4e} kJ/mol/nm, leaving "
        f"out {n_flip} cutoff-flipped pairs ({err_all:.3e} with them); "
        f"the effect {rel:.3e} of the LJ's max|F|")
    if not (np.isfinite(err) and scale_d > 0 and err <= SW_EFFECT_TOL):
        fail(f"{phase} {tag}: the switch's effect misses the plain "
             f"version's by {err:.3e} of its max > {SW_EFFECT_TOL}")
    return err, ref


def state_checks(phase, ctx, make_ctx, energy_key, rms_skip=False):
    """After the counted steps: latches, wall, finiteness and the
    state's energy by `energy_key` alone (one launch, no plain sweep);
    then the f32 force pass against f64 at the state (the f32 floor; the
    rms without the flipped pairs' atoms with rms_skip, f32_floor).
    Returns the bath temperatures."""
    import torch
    temps, e_launches, plain = counted(lambda: check_after_steps(ctx,
                                                                 phase))
    log(f"{phase} the state's energy: launches {e_launches}, plain sweeps "
        f"on the card {plain}")
    if e_launches[energy_key] != 1 or plain:
        fail(f"{phase}: the state's energy did not come from "
             f"{energy_key} alone")
    st = ctx._state
    ctx64, _ = make_ctx("double", {"capacity": ctx._cp_cfg.capacity})
    ctx64.setPositions((st.positions.double() + st.pos_err.double())
                       .cpu().numpy())
    ferr, ferr_all, frms, n_flip, fs, frms_all = force_pass_floor(
        ctx, ctx64, rms_skip)
    del ctx64
    torch.cuda.empty_cache()
    log(f"{phase} force pass f32 vs f64: max {ferr:.3e} ({ferr_all:.3e} "
        f"with the atoms of {n_flip} cutoff-flipped pairs), rms "
        f"{frms:.3e} ({frms_all:.3e} with them) (max|F| {fs:.1f})")
    if not (ferr <= 1e-4 and frms <= 5e-6):
        fail(f"{phase}: the f32 force pass misses the f32 floor against "
             "f64")
    return temps


def minimized(phase, ctx, iterations):
    """minimizeEnergy(iterations) on the card, counted: the energy must
    fall and no plain sweep may run."""
    import torch
    pe0 = ctx.getState(energy=True).getPotentialEnergy()
    t = time.time()
    _, launches, plain = counted(
        lambda: ctx.minimizeEnergy(maxIterations=iterations))
    t_min = time.time() - t
    pe1 = ctx.getState(energy=True).getPotentialEnergy()
    log(f"{phase} PE {pe0:.1f} -> {pe1:.1f} kJ/mol by minimize({iterations})"
        f" in {t_min:.2f} s; launches {launches}, plain sweeps {plain}; "
        f"capacity {ctx._cp_cfg.capacity}")
    if not (np.isfinite(pe1) and pe1 < pe0) or plain:
        fail(f"{phase}: minimization did not lower the energy on the "
             "kernels")


def phase_ionic_liquid(card):
    """7. The paper's ionic liquid at full width through B1's
    reaction-field instantiation (see the module docstring).  Returns
    the `kernels` entries of the RF instantiations of B1 and B2, the
    breakdown and (the System, its Context factory, the final
    compensated positions and velocities)."""
    import torch
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.io import ionic_liquid
    from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
    t = time.time()
    system, pos, cations, anions = ionic_liquid.build_ionic_liquid(
        14286, method=dt.NonbondedForce.CutoffPeriodic, cutoff=1.2)
    n = system.getNumParticles()

    def make_ctx(precision, options):
        integ = ionic_liquid.make_tgnh_integrator(
            cations, anions, n, temperature=400.0, drude_temperature=1.0,
            step_size=0.001)
        integ.setMaxDrudeDistance(0.02)
        # a cation's C1-C2 exclusion (~0.65 nm) spans about a cell
        # (0.659 nm): the exclusion test runs at every offset
        ctx = dt.Context(system, integ, precision=precision,
                         strategy="cellpair", device="cuda",
                         nb_options=dict(options, excl_skip=False))
        return ctx, integ

    ctx, integ = make_ctx("single", {})
    ctx.setPositions(pos)
    ctx._ensure_neighbors()
    nb, cfg = ctx._nb, ctx._cp_cfg
    box_w = system.getDefaultPeriodicBoxVectors()[0][0]
    log(f"7 ionic liquid built and bound in {time.time() - t:.1f} s: {n} "
        f"atoms ({len(cations) // 4} cations, {len(anions) // 3} anions), "
        f"box {box_w:.4f} nm, "
        f"cell grid {cfg.grid}, capacity {cfg.capacity}, {cfg.n_offsets} "
        f"offsets, route {nb.sweep_kernel}, Coulomb {nb.coulomb}, "
        f"{ctx._static.n_baths} baths")
    if not (n == 100002 and nb.sweep_kernel == "b1" and nb.pme is None
            and nb.coulomb["method"] == "rf" and ctx._static.n_baths == 4):
        fail("7: the ionic liquid is not the 100,002-atom reaction-field "
             "system on B1 with four baths")
    minimized("7", ctx, IL_MIN)
    ctx.setVelocitiesToTemperature(400.0, seed=0)
    targets = np.array([400.0, 400.0, 400.0, 1.0])
    t = time.time()
    integ.step(IL_SETTLE)
    torch.cuda.synchronize()
    settled = ctx.getState(groups=True).getGroupTemperatures()
    log(f"7 {IL_SETTLE} settling steps in {time.time() - t:.2f} s; bath "
        f"temperatures {np.round(settled, 3).tolist()} K")
    ms_step, nsd, launches, plain, mean = run_blocks(ctx, integ, IL_STEPS,
                                                     targets)
    log(f"7 {IL_STEPS} steps: {ms_step:.2f} ms/step, {nsd:.4f} ns/day on "
        f"{card}; launches {launches}; plain sweeps on the card {plain}; "
        f"capacity {ctx._cp_cfg.capacity}")
    if launches["b1_sweep_rf"] < IL_STEPS or plain or any(
            launches[k] for k in ("b1_sweep", "b2_sweep", "b2_sweep_rf")):
        fail("7: the steps did not run their forces through B1's RF "
             "instantiation alone")
    temps = state_checks("7", ctx, make_ctx, "b1_energy_rf", rms_skip=True)
    hold_bands("7", ["cation", "anion", "COM", "Drude"], mean, temps,
               IL_BANDS)

    nb, cfg, st = ctx._nb, ctx._cp_cfg, ctx._state
    box_diag = torch.diagonal(st.box)
    fields = nb.fields(st.positions, box_diag, st.neighbors)
    shifts = cellpair.offset_shifts(cfg, box_diag)
    args = (fields, cfg, shifts, nb.alpha, ONE_4PI_EPS0)
    kw = dict(nb.coulomb, excl_skip=nb.excl_skip)
    f_b1, err_b1, ms_b1, plain_b1 = kernel_parity("7", "B1 RF", sweep,
                                                  args, kw)
    _, err_b2, ms_b2, plain_b2 = kernel_parity("7", "B2 RF", sweep_chunked,
                                               args, kw, ref=f_b1)
    del f_b1
    bound_ms, bound_by, n_tests, n_cut, n_bytes = sweep_bound(
        fields, cfg, shifts, method="rf")
    log(f"7 RF force bound {bound_ms:.4f} ms ({bound_by}: {n_tests} pair "
        f"tests, {n_cut} inside the cutoff, {n_bytes} bytes; "
        f"{n / cfg.n_cells:.2f} atoms a cell of capacity {cfg.capacity}): "
        f"B1 at "
        f"{bound_ms / ms_b1:.1%}, B2 at {bound_ms / ms_b2:.1%} on {card}")
    e1 = energy_check("7 B1 RF", sweep, fields, cfg, shifts, nb.alpha, card,
                      nb.coulomb, nb.excl_skip)
    e2 = energy_check("7 B2 RF", sweep_chunked, fields, cfg, shifts,
                      nb.alpha, card, nb.coulomb, nb.excl_skip)
    del fields, args
    times = breakdown(ctx, sweep.pair_forces, "b1_sweep_rf", ms_step, card,
                      "7", reps=3)

    # a Context routed to B2 (use_pallas 3) from the same state
    ctx2, integ2 = make_ctx("single", {"use_pallas": 3,
                                       "capacity": cfg.capacity})
    ctx2.setPositions((st.positions.double() + st.pos_err.double())
                      .cpu().numpy())
    ctx2.setVelocities(st.velocities.double().cpu().numpy())
    ctx2._ensure_forces()
    if ctx2._nb.sweep_kernel != "b2":
        fail(f"7: use_pallas 3 routed to {ctx2._nb.sweep_kernel}")
    _, b2_launches, plain = counted(lambda: integ2.step(IL_B2_STEPS))
    _, b2_e_launches, plain_e = counted(
        lambda: ctx2.getState(energy=True).getPotentialEnergy())
    log(f"7 a Context routed to B2: {IL_B2_STEPS} steps, launches "
        f"{b2_launches}, then its energy: {b2_e_launches}; plain sweeps "
        f"{plain + plain_e}")
    if (b2_launches["b2_sweep_rf"] < IL_B2_STEPS or b2_launches["b1_sweep_rf"]
            or b2_e_launches["b2_energy_rf"] != 1 or plain or plain_e):
        fail("7: the B2-routed Context did not run B2's RF instantiation")
    # the final state, for phase 15's switched reaction field
    il_state = (system, make_ctx,
                (st.positions.double() + st.pos_err.double()).cpu().numpy(),
                st.velocities.double().cpu().numpy())
    del ctx2, integ2, ctx, integ
    torch.cuda.empty_cache()
    src1 = "openmm_drudenose_tpu_torch/csrc/sweep.cu"
    src2 = "openmm_drudenose_tpu_torch/csrc/sweep_chunked.cu"
    tpu1 = "openmm_drudenose_tpu/ops/pallas_sweep.py:440"
    tpu2 = "openmm_drudenose_tpu/ops/pallas_sweep.py:851"
    common = {"route": "cuda", "coulomb": "rf", "capacity": cfg.capacity,
              "library_ms": None}
    return [dict(common, name="b1_sweep_rf", instantiation="forces",
                 source=src1, replaces=tpu1,
                 launches=launches["b1_sweep_rf"],
                 launches_per_step=launches["b1_sweep_rf"] / IL_STEPS,
                 max_abs_err=err_b1, ms=ms_b1, plain_ms=plain_b1,
                 bound_ms=bound_ms, bound_by=bound_by),
            dict(common, name="b1_energy_rf", instantiation="energy",
                 source=src1, replaces=tpu1, launches=1, **e1),
            dict(common, name="b2_sweep_rf", instantiation="forces",
                 source=src2, replaces=tpu2,
                 launches=b2_launches["b2_sweep_rf"],
                 launches_per_step=b2_launches["b2_sweep_rf"] / IL_B2_STEPS,
                 max_abs_err=err_b2, ms=ms_b2, plain_ms=plain_b2,
                 bound_ms=bound_ms, bound_by=bound_by),
            dict(common, name="b2_energy_rf", instantiation="energy",
                 source=src2, replaces=tpu2,
                 launches=b2_e_launches["b2_energy_rf"], **e2)], times, \
        il_state


def phase_polymer(card):
    """8. The solvated polymer at full width through B1's Ewald
    instantiation with the bonded terms (see the module docstring)."""
    import torch
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.io import polymer
    from openmm_drudenose_tpu_torch.ops import sweep
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
    t = time.time()
    system, pos, poly, water = polymer.build_solvated_polymer(
        100, 30, 20000, method=dt.NonbondedForce.PME, cutoff=1.0)
    n = system.getNumParticles()

    def make_ctx(precision, options):
        integ = polymer.make_tgnh_integrator(poly, water, n,
                                             temperature=300.0,
                                             drude_temperature=1.0)
        integ.setMaxDrudeDistance(0.02)
        # the chain's 1-3 exclusions (~0.65 nm) span more than a cell
        # (0.562 nm): the exclusion test runs at every offset
        ctx = dt.Context(system, integ, precision=precision,
                         strategy="cellpair", device="cuda",
                         nb_options=dict(options, excl_skip=False))
        return ctx, integ

    ctx, integ = make_ctx("single", {})
    ctx.setPositions(pos)
    ctx._ensure_neighbors()
    nb, cfg = ctx._nb, ctx._cp_cfg
    forces = sorted(type(f).__name__ for f in system.getForces())
    log(f"8 polymer built and bound in {time.time() - t:.1f} s: {n} atoms "
        f"({len(poly)} polymer, {len(water) // 5} waters), forces {forces}, "
        f"cell grid {cfg.grid}, capacity {cfg.capacity}, {cfg.n_offsets} "
        f"offsets, PME grid {nb.pme.grid}, route {nb.sweep_kernel}, "
        f"{ctx._static.n_baths} baths")
    if not (nb.sweep_kernel == "b1" and nb.coulomb["method"] == "ewald"
            and ctx._static.n_baths == 4 and len(poly) == 6000):
        fail("8: the polymer is not the Ewald system on B1 with four baths")
    minimized("8", ctx, POLY_MIN)
    ctx.setVelocitiesToTemperature(300.0, seed=0)
    targets = np.array([300.0, 300.0, 300.0, 1.0])
    t = time.time()
    integ.step(POLY_SETTLE)
    torch.cuda.synchronize()
    settled = ctx.getState(groups=True).getGroupTemperatures()
    log(f"8 {POLY_SETTLE} settling steps in {time.time() - t:.2f} s; bath "
        f"temperatures {np.round(settled, 3).tolist()} K")
    ms_step, nsd, launches, plain, mean = run_blocks(ctx, integ, POLY_STEPS,
                                                     targets)
    log(f"8 {POLY_STEPS} steps: {ms_step:.2f} ms/step, {nsd:.4f} ns/day on "
        f"{card}; launches {launches}; plain sweeps on the card {plain}; "
        f"capacity {ctx._cp_cfg.capacity}")
    if launches["b1_sweep"] < POLY_STEPS or plain or any(
            launches[k] for k in ("b2_sweep", "b1_sweep_rf")):
        fail("8: the steps did not run their forces through B1 alone")
    temps = state_checks("8", ctx, make_ctx, "b1_energy")
    hold_bands("8", ["polymer", "water", "COM", "Drude"], mean, temps,
               POLY_BANDS)
    nb, cfg, st = ctx._nb, ctx._cp_cfg, ctx._state
    box_diag = torch.diagonal(st.box)
    fields = nb.fields(st.positions, box_diag, st.neighbors)
    shifts = cellpair.offset_shifts(cfg, box_diag)
    args = (fields, cfg, shifts, nb.alpha, ONE_4PI_EPS0)
    _, _, ms_b1, _ = kernel_parity("8", "B1", sweep, args,
                                   dict(nb.coulomb, excl_skip=nb.excl_skip))
    bound_ms, bound_by, n_tests, n_cut, n_bytes = sweep_bound(fields, cfg,
                                                              shifts)
    log(f"8 B1 {ms_b1:.4f} ms against its bound {bound_ms:.4f} ms "
        f"({bound_by}: {n_tests} pair tests, {n_cut} inside the cutoff; "
        f"{bound_ms / ms_b1:.1%}) on {card}")
    del fields, args
    times = breakdown(ctx, sweep.pair_forces, "b1_sweep", ms_step, card,
                      "8", reps=3)
    del ctx, integ
    torch.cuda.empty_cache()
    return times


def phase_triclinic(card):
    """9. The JAX package's sheared 100k SWM4-NDP box through the port
    (see the module docstring).  Returns the `kernels` entries of the
    triclinic runs of B1 (forces; energy, from the NPT run) and B2
    (forces and energy)."""
    import torch
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.forces import boxutils, cellpair
    from openmm_drudenose_tpu_torch.io import builders
    from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
    t = time.time()
    system, pos = builders.build_water_box(
        TRI_MOL, method=dt.NonbondedForce.PME, cutoff=1.0)
    L = float(system.getDefaultPeriodicBoxVectors()[0][0])
    bx, cx, cy = TRI_SHEAR
    system.setDefaultPeriodicBoxVectors((L, 0, 0), (bx * L, L, 0),
                                        (cx * L, cy * L, L))
    n = system.getNumParticles()

    def make_ctx(precision, options, sys_=system):
        integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        integ.setMaxDrudeDistance(0.02)
        ctx = dt.Context(sys_, integ, precision=precision, device="cuda",
                         nb_options=options)
        return ctx, integ

    ctx, integ = make_ctx("single", {})
    ctx.setPositions(pos)
    ctx._ensure_neighbors()
    nb, cfg = ctx._nb, ctx._cp_cfg
    box = np.array(system.getDefaultPeriodicBoxVectors())
    widths = boxutils.plane_widths(torch.as_tensor(box)).numpy()
    log(f"9 sheared box built and bound in {time.time() - t:.1f} s: {n} "
        f"atoms, box rows {np.round(box, 5).tolist()} nm (volume "
        f"{np.linalg.det(box):.4f} nm^3, plane widths "
        f"{np.round(widths, 5).tolist()}), triclinic plan {cfg.triclinic}: "
        f"cell grid {cfg.grid}, window {cfg.window}, capacity "
        f"{cfg.capacity}, {cfg.n_offsets} offsets (trimmed {cfg.trimmed}), "
        f"PME grid {nb.pme.grid}, route {nb.sweep_kernel}")
    if not (n == 100000 and ctx._triclinic and cfg.triclinic
            and nb.sweep_kernel == "b1" and cfg.n_offsets == 63):
        fail("9: the sheared box is not the 100k triclinic plan on B1")
    minimized("9", ctx, TRI_MIN)
    ctx.setVelocitiesToTemperature(300.0, seed=0)
    targets = np.array([300.0, 300.0, 1.0])
    for stage in ("from the minimized lattice", "after the restart"):
        t = time.time()
        integ.step(TRI_SETTLE)
        torch.cuda.synchronize()
        nbl = ctx._state.neighbors
        settled = ctx.getState(groups=True).getGroupTemperatures()
        pe = ctx.getState(energy=True).getPotentialEnergy()
        log(f"9 {TRI_SETTLE} settling steps {stage} in "
            f"{time.time() - t:.2f} s; bath temperatures "
            f"{np.round(settled, 3).tolist()} K, PE {pe:.1f} kJ/mol; "
            f"drift latch {bool(nbl.drift_exceeded)}, overflow "
            f"{bool(nbl.overflow)}")
        if stage.startswith("from"):
            # a fresh chain (and a fresh sort) at the settled positions
            st = ctx._state
            settled_pos = (st.positions.double() + st.pos_err.double())
            ctx.reinitialize(preserveState=False)
            ctx.setPositions(settled_pos.cpu().numpy())
            ctx.setVelocitiesToTemperature(300.0, seed=1)
    ms_step, nsd, launches, plain, mean = run_blocks(ctx, integ, TRI_STEPS,
                                                     targets)
    log(f"9 {TRI_STEPS} steps: {ms_step:.2f} ms/step, {nsd:.4f} ns/day on "
        f"{card}; launches {launches}; plain sweeps on the card {plain}; "
        f"capacity {ctx._cp_cfg.capacity}")
    if launches["b1_sweep"] < TRI_STEPS or plain or any(
            launches[k] for k in ("b2_sweep", "b1_sweep_rf")):
        fail("9: the steps did not run their forces through B1 alone")
    temps = state_checks("9", ctx, make_ctx, "b1_energy")
    hold_bands("9", ["water", "COM", "Drude"], mean, temps, TRI_BANDS)

    nb, cfg, st = ctx._nb, ctx._cp_cfg, ctx._state
    box_t = ctx._box_arg(st.box)
    fields = nb.fields(st.positions, box_t, st.neighbors)
    shifts = cellpair.offset_shifts(cfg, box_t)
    args = (fields, cfg, shifts, nb.alpha, ONE_4PI_EPS0)
    kw = dict(nb.coulomb, excl_skip=nb.excl_skip)
    f_b1, err_b1, ms_b1, plain_b1 = kernel_parity("9", "B1", sweep, args,
                                                  kw)
    _, err_b2, ms_b2, plain_b2 = kernel_parity("9", "B2", sweep_chunked,
                                               args, kw, ref=f_b1)
    del f_b1
    bound_ms, bound_by, n_tests, n_cut, n_bytes = sweep_bound(fields, cfg,
                                                              shifts)
    log(f"9 force bound {bound_ms:.4f} ms ({bound_by}: {n_tests} pair "
        f"tests, {n_cut} inside the cutoff, {n_bytes} bytes): B1 "
        f"{ms_b1:.4f} ms at {bound_ms / ms_b1:.1%}, B2 {ms_b2:.4f} ms at "
        f"{bound_ms / ms_b2:.1%} on {card}")
    e2 = energy_check("9 B2", sweep_chunked, fields, cfg, shifts, nb.alpha,
                      card, nb.coulomb, nb.excl_skip)
    del fields, args
    breakdown(ctx, sweep.pair_forces, "b1_sweep", ms_step, card, "9",
              reps=3)

    # a Context routed to B2 (use_pallas 3) from the same state
    exact = (st.positions.double() + st.pos_err.double()).cpu().numpy()
    vel = st.velocities.double().cpu().numpy()
    ctx2, integ2 = make_ctx("single", {"use_pallas": 3,
                                       "capacity": cfg.capacity})
    ctx2.setPositions(exact)
    ctx2.setVelocities(vel)
    ctx2._ensure_forces()
    if ctx2._nb.sweep_kernel != "b2" or not ctx2._cp_cfg.triclinic:
        fail(f"9: use_pallas 3 routed to {ctx2._nb.sweep_kernel}")
    _, b2_launches, plain = counted(lambda: integ2.step(TRI_B2_STEPS))
    _, b2_e_launches, plain_e = counted(
        lambda: ctx2.getState(energy=True).getPotentialEnergy())
    log(f"9 a Context routed to B2: {TRI_B2_STEPS} steps, launches "
        f"{b2_launches}, then its energy: {b2_e_launches}; plain sweeps "
        f"{plain + plain_e}")
    if (b2_launches["b2_sweep"] < TRI_B2_STEPS or b2_launches["b1_sweep"]
            or b2_e_launches["b2_energy"] != 1 or plain or plain_e):
        fail("9: the B2-routed Context did not run B2")
    del ctx2, integ2, ctx, integ
    torch.cuda.empty_cache()

    # NPT from the same state: a system of its own with the barostat
    sys_npt, _ = builders.build_water_box(
        TRI_MOL, method=dt.NonbondedForce.PME, cutoff=1.0)
    sys_npt.setDefaultPeriodicBoxVectors(*box)
    sys_npt.addForce(dt.MonteCarloBarostat(1.01325, 300.0, TRI_BARO))
    ctx3, integ3 = make_ctx("single", {"capacity": cfg.capacity}, sys_npt)
    ctx3.setPositions(exact)
    ctx3.setVelocities(vel)
    grid0 = cfg.grid
    e_npt = npt_checks("9", "the sheared 100k box", ctx3, integ3, card,
                       ms_step, TRI_NPT_STEPS, TRI_BARO)
    cfg3 = ctx3._cp_cfg
    if not (cfg3.triclinic and cfg3.grid != grid0
            and boxutils.is_triclinic(ctx3._state.box)):
        fail("9: the shrink did not replan a triclinic grid")
    del ctx3, integ3
    torch.cuda.empty_cache()

    src1 = "openmm_drudenose_tpu_torch/csrc/sweep.cu"
    src2 = "openmm_drudenose_tpu_torch/csrc/sweep_chunked.cu"
    tpu1 = "openmm_drudenose_tpu/ops/pallas_sweep.py:440"
    tpu2 = "openmm_drudenose_tpu/ops/pallas_sweep.py:851"
    common = {"route": "cuda", "coulomb": "ewald", "geometry": "triclinic",
              "capacity": cfg.capacity, "library_ms": None}
    e_npt.pop("capacity", None)
    return [dict(common, name="b1_sweep_triclinic", instantiation="forces",
                 source=src1, replaces=tpu1, launches=launches["b1_sweep"],
                 launches_per_step=launches["b1_sweep"] / TRI_STEPS,
                 max_abs_err=err_b1, ms=ms_b1, plain_ms=plain_b1,
                 bound_ms=bound_ms, bound_by=bound_by),
            dict(common, name="b1_energy_triclinic", instantiation="energy",
                 source=src1, replaces=tpu1, **e_npt),
            dict(common, name="b2_sweep_triclinic", instantiation="forces",
                 source=src2, replaces=tpu2,
                 launches=b2_launches["b2_sweep"],
                 launches_per_step=b2_launches["b2_sweep"] / TRI_B2_STEPS,
                 max_abs_err=err_b2, ms=ms_b2, plain_ms=plain_b2,
                 bound_ms=bound_ms, bound_by=bound_by),
            dict(common, name="b2_energy_triclinic", instantiation="energy",
                 source=src2, replaces=tpu2,
                 launches=b2_e_launches["b2_energy"], **e2)]


def phase_flat(card):
    """10. The flattened replica ensemble at the full width of the JAX
    package's scripts/bench_replicas.py --flat, through the replica-band
    path of B1 (see the module docstring).  Returns the `kernels`
    entries of the band instantiations of B1 and B2, the breakdown, the
    settled template's (positions, velocities) and the ensemble's
    (ms/step, ns/day a replica)."""
    import torch
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.io import builders
    from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
    from openmm_drudenose_tpu_torch.parallel import flatrep
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0, ns_per_day
    t = time.time()
    system, pos = builders.build_water_box(FLAT_MOL)
    n0 = system.getNumParticles()

    def integrator():
        integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        integ.setMaxDrudeDistance(0.02)
        return integ

    integ = integrator()
    tpl = dt.Context(system, integ, precision="single", device="cuda")
    if tpl._nb.strategy != "dense":
        fail(f"10: the 4k template took the {tpl._nb.strategy} strategy")
    tpl.setPositions(pos)
    tpl.setVelocitiesToTemperature(300.0, seed=0)
    for stage in ("from the lattice", "after the restart"):
        integ.step(FLAT_TPL_SETTLE)
        torch.cuda.synchronize()
        settled = tpl.getState(groups=True).getGroupTemperatures()
        log(f"10 template ({n0} atoms, dense strategy): "
            f"{FLAT_TPL_SETTLE} settling steps {stage}, "
            f"{time.time() - t:.2f} s so far; bath temperatures "
            f"{np.round(settled, 3).tolist()} K")
        if stage.startswith("from"):
            # a fresh chain at the settled positions
            settled_pos = (tpl._state.positions.double()
                           + tpl._state.pos_err.double()).cpu().numpy()
            tpl.reinitialize(preserveState=False)
            tpl.setPositions(settled_pos)
            tpl.setVelocitiesToTemperature(300.0, seed=1)

    # the settled template (compensated positions, velocities): phase 11
    # starts from it
    settled = ((tpl._state.positions.double()
                + tpl._state.pos_err.double()).cpu().numpy(),
               tpl._state.velocities.double().cpu().numpy())
    t = time.time()
    ens = dt.FlatReplicaEnsemble(tpl, FLAT_REPLICAS, seed=7)
    ctx = ens.context
    ctx._ensure_neighbors()
    nb, cfg = ctx._nb, ctx._cp_cfg
    n_atoms = ctx._static.n_atoms
    log(f"10 ensemble built in {time.time() - t:.1f} s: {FLAT_REPLICAS} "
        f"replicas, layout {ens.layout} ({ens.n_replicas_padded} internal, "
        f"{n_atoms} atoms), cell grid {cfg.grid} of replica grids "
        f"{cfg.phys_grid}, capacity {cfg.capacity}, {cfg.n_offsets} "
        f"offsets, PME grid {nb.pme.grid} x {nb.n_replicas} (the JAX "
        f"pencil gate {nb.pme_pencil_gate}), route {nb.sweep_kernel}")
    rx, rz = FLAT_LAYOUT
    if not (ens.layout == FLAT_LAYOUT and n_atoms == rx * rz * n0
            and cfg.grid == (5 * rx, 5, 5 * rz) and nb.sweep_kernel == "b1"
            and nb.pme.grid == (25, 25, 25) and cfg.n_offsets == 63):
        fail(f"10: the ensemble is not the {FLAT_LAYOUT} layout of "
             f"{rx * rz * n0} atoms on B1 with 25^3 PME grids")
    ens.setVelocitiesToTemperature(300.0, seed=3)
    t = time.time()
    ens.step(FLAT_SETTLE)
    torch.cuda.synchronize()
    log(f"10 {FLAT_SETTLE} settling steps in {time.time() - t:.2f} s; "
        f"capacity {ctx._cp_cfg.capacity}")

    nkbt = ctx._spec.nh_nkbt.double().numpy()
    targets = np.array([300.0, 300.0, 1.0])
    samples, walls = [], []

    def drive():
        for _ in range(FLAT_REPEATS):
            t0 = time.time()
            ens.step(FLAT_STEPS)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            samples.append((ctx._state.group_ke.double().numpy() / nkbt
                            * targets)[:FLAT_REPLICAS])

    _, launches, plain = counted(drive)
    best = min(walls)
    ms_step = best / FLAT_STEPS * 1e3
    nsd = ns_per_day(FLAT_STEPS / best, integ.getStepSize())
    log(f"10 {FLAT_REPEATS} x {FLAT_STEPS} steps: "
        + ", ".join(f"{w / FLAT_STEPS * 1e3:.2f}" for w in walls)
        + f" ms/step (best {ms_step:.2f}); per replica {nsd:.4f} ns/day, "
        f"aggregate over {FLAT_REPLICAS} replicas {nsd * FLAT_REPLICAS:.3f}"
        f" ns/day on {card}; launches {launches}; plain sweeps on the card "
        f"{plain}; capacity {ctx._cp_cfg.capacity}")
    n_total = FLAT_REPEATS * FLAT_STEPS
    if launches["b1_sweep_bands"] < n_total or plain or any(
            v for k, v in launches.items()
            if k.startswith("b2") or not k.endswith("_bands")):
        fail("10: the steps did not run their forces through B1's band "
             "path alone")

    # latches, the wall, finite per-replica temperatures and the bands
    nbl = ctx._state.neighbors
    latches = {"overflow": bool(nbl.overflow),
               "drift": bool(nbl.drift_exceeded) or ctx._drift_warned,
               "excl_span": bool(nbl.excl_span_exceeded)
               if nbl.excl_span_exceeded is not None else False,
               "hardwall_runaway": ctx.hardwallRunaway}
    spec = ctx._spec
    p = ctx._state.positions.double() + ctx._state.pos_err.double()
    drude = torch.nonzero(spec.is_pair & ~spec.is_parent)[:, 0]
    dmax = float(torch.max(torch.linalg.norm(
        p[drude] - p[spec.partner[drude]], dim=1)))
    temps, e_launches, plain_e = counted(ens.group_temperatures)
    ke = ens.kinetic_energies()
    mean = np.mean(np.concatenate(samples), axis=0)
    log(f"10 latches {latches}; max core-Drude distance {dmax:.6f} nm; "
        f"the state's energy: launches {e_launches}, plain sweeps "
        f"{plain_e}; water bath over the {FLAT_REPLICAS} replicas at the "
        f"end: min {temps[:, 0].min():.3f}, mean {temps[:, 0].mean():.3f}, "
        f"max {temps[:, 0].max():.3f} K; bath means (water, COM, Drude) "
        f"over the replicas and the {FLAT_REPEATS} samples "
        f"{np.round(mean, 3).tolist()} K; bands {FLAT_BANDS}")
    if any(latches.values()):
        fail(f"10: a latch is set: {latches}")
    if dmax > 0.02 * 1.00001:
        fail(f"10: hard wall broken: {dmax}")
    if not (np.all(np.isfinite(temps)) and np.all(np.isfinite(ke))
            and temps.shape == (FLAT_REPLICAS, 3)):
        fail("10: non-finite or misshapen per-replica temperatures")
    if e_launches["b1_energy_bands"] != 1 or plain_e:
        fail("10: the state's energy did not come from B1's band energy "
             "alone")
    for b, name in ((0, "water"), (2, "Drude")):
        lo, hi = FLAT_BANDS["mean"][b]
        if not lo < mean[b] < hi:
            fail(f"10: the {name} bath's mean {mean[b]:.3f} K outside "
                 f"({lo}, {hi})")
    lo, hi = FLAT_BANDS["replica"]
    if not np.all((temps[:, 0] > lo) & (temps[:, 0] < hi)):
        fail(f"10: a replica's water bath outside ({lo}, {hi})")

    # the kernels on the ensemble's fields: B1 and B2 against their plain
    # versions, f64 and each other, bit-identical; their energies (the
    # terms and the plan as the steps left them: a capacity grown there
    # recompiled both)
    st = ctx._state
    nb, cfg = ctx._nb, ctx._cp_cfg
    box_diag = torch.diagonal(st.box)
    fields = nb.fields(st.positions, box_diag, st.neighbors)
    shifts = cellpair.offset_shifts(cfg, box_diag)
    args = (fields, cfg, shifts, nb.alpha, ONE_4PI_EPS0)
    kw = dict(nb.coulomb, excl_skip=nb.excl_skip)
    f_b1, err_b1, ms_b1, plain_b1 = kernel_parity("10", "B1 bands", sweep,
                                                  args, kw)
    _, err_b2, ms_b2, plain_b2 = kernel_parity(
        "10", "B2 bands", sweep_chunked, args, kw, ref=f_b1)
    del f_b1
    bound_ms, bound_by, n_tests, n_cut, n_bytes = sweep_bound(fields, cfg,
                                                              shifts)
    plan = sweep_chunked.plan_for(cfg,
                                  limits=sweep_chunked.card_limits("cuda"))
    log(f"10 force bound {bound_ms:.4f} ms ({bound_by}: {n_tests} pair "
        f"tests, {n_cut} inside the cutoff, {n_bytes} bytes): B1 "
        f"{ms_b1:.4f} ms at {bound_ms / ms_b1:.1%}, B2 {ms_b2:.4f} ms at "
        f"{bound_ms / ms_b2:.1%} (brick {plan.brick}, {plan.per_band} "
        f"chunks a band, {plan.total_chunks} chunks) on {card}")
    split = kernel_split(lambda: sweep.pair_forces(*args, **kw))
    log("10 B1's two kernels (torch.profiler, device ms a launch): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    e1 = energy_check("10 B1 bands", sweep, fields, cfg, shifts, nb.alpha,
                      card, nb.coulomb, nb.excl_skip)
    e2 = energy_check("10 B2 bands", sweep_chunked, fields, cfg, shifts,
                      nb.alpha, card, nb.coulomb, nb.excl_skip)

    # replica isolation on the card: every atom of replica 0 moved; the
    # forces of replicas 1..69 out of both kernels the same bits (both
    # sorts made afresh at the positions they sort)
    nbl1 = nb.cellsort(st.positions, box_diag)
    fields1 = nb.fields(st.positions, box_diag, nbl1)
    args1 = (fields1, cfg, shifts, nb.alpha, ONE_4PI_EPS0)
    moved = st.positions.clone()
    gen = torch.Generator(device="cpu").manual_seed(5)
    moved[:n0] = torch.remainder(
        moved[:n0] + 0.01 * torch.randn((n0, 3), generator=gen).to(
            moved.device, moved.dtype), box_diag)
    nbl2 = nb.cellsort(moved, box_diag)
    fields2 = nb.fields(moved, box_diag, nbl2)
    args2 = (fields2, cfg, shifts, nb.alpha, ONE_4PI_EPS0)
    iso = []
    for name, kernel in (("B1", sweep), ("B2", sweep_chunked)):
        fa = kernel.pair_forces(*args1, **kw)[nbl1.inv_slot]
        fb = kernel.pair_forces(*args2, **kw)[nbl2.inv_slot]
        torch.cuda.synchronize()
        changed = float(torch.max(torch.abs(fa[:n0] - fb[:n0])))
        same = bool(torch.equal(fa[n0:], fb[n0:]))
        iso.append(f"{name}: replica 0 changed by up to {changed:.3e}, "
                   f"replicas 1..{rx * rz - 1} bit for bit {same}")
        if not (same and changed > 0):
            fail(f"10: {name} let replica 0's move reach another replica")
    log("10 replica isolation (replica 0's atoms moved by 0.01 nm rms; the "
        f"sort overflowed: {bool(nbl2.overflow)}): " + "; ".join(iso))
    del fields, args, fields1, args1, nbl1, fields2, args2, nbl2, moved, \
        fa, fb
    times = breakdown(ctx, sweep.pair_forces, "b1_sweep_bands", ms_step,
                      card, "10", reps=3)

    # the f32 force pass against f64 (phase 3's floor), and the band-edge
    # replicas against single-replica f64 Contexts of the template on the
    # cell-pair strategy
    ctx64 = dt.Context(ctx._system, flatrep._clone_integrator(
        integ, ens.n_replicas_padded), precision="double",
        strategy="cellpair", nb_options=dict(ctx._nb_options),
        device="cuda", ensemble_r=ens.n_replicas_padded)
    exact = (st.positions.double() + st.pos_err.double())
    ctx64.setPositions(exact.cpu().numpy())
    flips = []
    ferr, ferr_all, frms, n_flip, fs, _ = force_pass_floor(ctx, ctx64,
                                                           flips_out=flips)
    log(f"10 force pass f32 vs f64: max {ferr:.3e} ({ferr_all:.3e} with "
        f"the atoms of {n_flip} cutoff-flipped pairs), rms {frms:.3e} "
        f"(max|F| {fs:.1f})")
    if not (ferr <= 1e-4 and frms <= 5e-6):
        fail("10: the f32 force pass misses the f32 floor against f64")
    f32_forces = ctx._state.forces.double()
    f64_forces = ctx64._state.forces
    skip = flips[0]
    del ctx64
    torch.cuda.empty_cache()
    edge = []
    for r in FLAT_EDGE_REPLICAS:
        rows = slice(r * n0, (r + 1) * n0)
        one = dt.Context(system, integrator(), precision="double",
                         strategy="cellpair", device="cuda")
        one.setPositions(exact[rows].cpu().numpy())
        one._ensure_forces()
        ref = one._state.forces
        scale = float(torch.max(torch.abs(ref)))
        keep = ~skip[rows]
        err32 = float(torch.max(torch.abs(
            f32_forces[rows] - ref)[keep])) / scale
        err32_all = float(torch.max(torch.abs(f32_forces[rows] - ref))) \
            / scale
        err64 = float(torch.max(torch.abs(f64_forces[rows] - ref))) / scale
        edge.append(f"replica {r}: f32 flat {err32:.3e} ({err32_all:.3e} "
                    f"with flipped pairs' atoms), f64 flat {err64:.3e}")
        if not (err32 <= 1e-4 and err64 <= 1e-8):
            fail(f"10: replica {r} differs from its single-replica Context")
        del one
    log("10 against single-replica f64 Contexts of the template "
        "(max |dF| / max|F|): " + "; ".join(edge))
    del f32_forces, f64_forces, skip

    # a Context of the same ensemble routed to B2 (use_pallas 3), from
    # the same state
    integ2 = flatrep._clone_integrator(integ, ens.n_replicas_padded)
    ctx2 = dt.Context(ctx._system, integ2, precision="single",
                      strategy="cellpair",
                      nb_options=dict(ctx._nb_options, use_pallas=3,
                                      capacity=cfg.capacity),
                      device="cuda", ensemble_r=ens.n_replicas_padded)
    ctx2.setPositions(exact.cpu().numpy())
    ctx2.setVelocities(st.velocities.double().cpu().numpy())
    ctx2._ensure_forces()
    if ctx2._nb.sweep_kernel != "b2" or ctx2._cp_cfg.grid != cfg.grid:
        fail(f"10: use_pallas 3 routed to {ctx2._nb.sweep_kernel}")
    _, b2_launches, plain = counted(lambda: integ2.step(FLAT_B2_STEPS))
    _, b2_e_launches, plain_e = counted(
        lambda: ctx2.getState(energy=True).getPotentialEnergy())
    log(f"10 a Context routed to B2: {FLAT_B2_STEPS} steps, launches "
        f"{b2_launches}, then its energy: {b2_e_launches}; plain sweeps "
        f"{plain + plain_e}")
    if (b2_launches["b2_sweep_bands"] < FLAT_B2_STEPS
            or b2_launches["b1_sweep_bands"]
            or b2_e_launches["b2_energy_bands"] != 1 or plain or plain_e):
        fail("10: the B2-routed Context did not run B2's band path")
    pe = ens.total_potential_energy()
    log(f"10 the {FLAT_REPLICAS} replicas' potential energies through the "
        f"template: sum {pe:.3f} kJ/mol; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not np.isfinite(pe):
        fail("10: non-finite replica energies")
    del integ2, ctx2, ens, ctx, tpl
    torch.cuda.empty_cache()

    src1 = "openmm_drudenose_tpu_torch/csrc/sweep.cu"
    src2 = "openmm_drudenose_tpu_torch/csrc/sweep_chunked.cu"
    tpu1 = "openmm_drudenose_tpu/ops/pallas_sweep.py:440"
    tpu2 = "openmm_drudenose_tpu/ops/pallas_sweep.py:851"
    common = {"route": "cuda", "coulomb": "ewald", "geometry": "bands",
              "capacity": cfg.capacity, "library_ms": None}
    return [dict(common, name="b1_sweep_bands", instantiation="forces",
                 source=src1, replaces=tpu1,
                 launches=launches["b1_sweep_bands"],
                 launches_per_step=launches["b1_sweep_bands"] / n_total,
                 max_abs_err=err_b1, ms=ms_b1, plain_ms=plain_b1,
                 bound_ms=bound_ms, bound_by=bound_by),
            dict(common, name="b1_energy_bands", instantiation="energy",
                 source=src1, replaces=tpu1,
                 launches=e_launches["b1_energy_bands"], **e1),
            dict(common, name="b2_sweep_bands", instantiation="forces",
                 source=src2, replaces=tpu2,
                 launches=b2_launches["b2_sweep_bands"],
                 launches_per_step=(b2_launches["b2_sweep_bands"]
                                    / FLAT_B2_STEPS),
                 max_abs_err=err_b2, ms=ms_b2, plain_ms=plain_b2,
                 bound_ms=bound_ms, bound_by=bound_by),
            dict(common, name="b2_energy_bands", instantiation="energy",
                 source=src2, replaces=tpu2,
                 launches=b2_e_launches["b2_energy_bands"], **e2)], times, \
        settled, (ms_step, nsd)


def energy_check_scaled(tag, kernel, fields, cfg, shifts, alpha, card,
                        excl_skip=True):
    """A kernel's scaled energy instantiation (per-replica shifts) on these
    fields: each replica's energy against the plain version in f32
    (E_PLAIN_REL of its |E_r|) and in f64 (E_F64_REL), two launches the
    same bits, timed beside the plain version and the bound.  Returns
    the numbers of its `kernels` entry."""
    import torch
    from openmm_drudenose_tpu_torch.ops import sweep
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
    kw = dict(method="ewald", excl_skip=excl_skip)
    args = (fields, cfg, shifts, alpha, ONE_4PI_EPS0)
    e1 = kernel.pair_energy(*args, **kw)
    e2 = kernel.pair_energy(*args, **kw)
    torch.cuda.synchronize()
    identical = bool(torch.equal(e1, e2))
    ep = sweep.pair_energy_plain(*args, **kw).double()
    f64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in fields.items()}
    ep64 = sweep.pair_energy_plain(f64, cfg, shifts.double(), alpha,
                                   ONE_4PI_EPS0, **kw)
    del f64
    torch.cuda.empty_cache()
    rel = float(torch.max(torch.abs(e1 - ep) / torch.abs(ep)))
    rel64 = float(torch.max(torch.abs(e1 - ep64) / torch.abs(ep64)))
    ms = cuda_time_ms(lambda: kernel.pair_energy(*args, **kw), 20)
    plain_ms = cuda_time_ms(lambda: sweep.pair_energy_plain(*args, **kw), 1,
                            warm=False)
    bound_ms, bound_by, n_tests, n_cut, n_bytes = sweep_bound(
        fields, cfg, shifts, energy=True)
    log(f"{tag} energies of {e1.shape[0]} replicas (sum {float(e1.sum()):.6f}"
        f" kJ/mol): largest |dE_r|/|E_r| against plain f32 {rel:.3e}, "
        f"against plain f64 {rel64:.3e}; two launches bit-identical: "
        f"{identical}; {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {n_tests} pair tests, {n_cut} "
        f"inside the cutoff, {n_bytes} bytes) on {card}")
    if not (np.isfinite(rel) and rel <= E_PLAIN_REL):
        fail(f"{tag} energies disagree with their plain version: {rel:.3e}")
    if not rel64 <= E_F64_REL:
        fail(f"{tag} energies miss f64: {rel64:.3e}")
    if not identical:
        fail(f"{tag}: two energy launches gave different bits")
    return {"max_abs_err": float(torch.max(torch.abs(e1 - ep))), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "capacity": cfg.capacity}


def phase_flat_npt(card, settled):
    """11. Flat NPT at the width of phase 10, each replica at its own box
    (the template box times s_r), through the scaled instantiations of
    B1 (see the module docstring).  `settled`: phase 10's settled
    template (positions, velocities).  Returns the `kernels` entries of
    the scaled instantiations of B1 and B2."""
    import torch
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.integrators import barostat
    from openmm_drudenose_tpu_torch.io import builders
    from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
    from openmm_drudenose_tpu_torch.parallel import flatrep
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0, ns_per_day
    settled_pos, settled_vel = settled
    rx, rz = FLAT_LAYOUT

    def integrator():
        integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        integ.setMaxDrudeDistance(0.02)
        return integ

    def template(freq):
        system, _ = builders.build_water_box(FLAT_MOL)
        system.addForce(dt.MonteCarloBarostat(1.01325, 300.0, freq))
        tpl = dt.Context(system, integrator(), precision="single",
                         device="cuda")
        tpl.setPositions(settled_pos)
        tpl.setVelocities(settled_vel)
        return tpl, system

    t = time.time()
    tpl, system = template(FLAT_NPT_BARO)
    n0 = system.getNumParticles()
    ens = dt.FlatReplicaEnsemble(tpl, FLAT_REPLICAS, seed=7)
    ens.setVelocities(settled_vel)
    ctx = ens.context
    integ = ctx._integrator
    ctx._ensure_neighbors()
    nb, cfg = ctx._nb, ctx._cp_cfg
    R = ens.n_replicas_padded
    log(f"11 flat NPT ensemble built in {time.time() - t:.1f} s from phase "
        f"10's settled template: layout {ens.layout} ({R} internal, "
        f"{ctx._static.n_atoms} atoms), cell grid {cfg.grid}, capacity "
        f"{cfg.capacity}, {cfg.n_offsets} offsets, PME grid {nb.pme.grid} x "
        f"{nb.n_replicas}, route {nb.sweep_kernel}, MonteCarloBarostat("
        f"1.01325, 300, {FLAT_NPT_BARO}), scales "
        f"{ctx._state.rep_scale.unique().tolist()}")
    if not (ens.layout == FLAT_LAYOUT and R == rx * rz
            and ctx._static.n_atoms == R * n0
            and cfg.grid == (5 * rx, 5, 5 * rz) and nb.sweep_kernel == "b1"
            and nb.pme.grid == (25, 25, 25) and cfg.n_offsets == 63
            and ctx._state.rep_scale is not None
            and torch.equal(ctx._state.rep_scale,
                            torch.ones(R, dtype=torch.float64))):
        fail(f"11: the ensemble is not the {FLAT_LAYOUT} flat NPT layout of "
             f"{R * n0} atoms on B1 with 25^3 PME grids")
    box0 = float(ctx._state.box[0, 0])

    # the host time inside the attempts, and each replica's accepted
    # moves (the scale changes)
    inside, accepted = [], np.zeros(R, np.int64)
    attempt = barostat.maybe_attempt_mc_move_ensemble

    def timed_attempt(spec, static, state, *a, **kw):
        t0 = time.perf_counter()
        out = attempt(spec, static, state, *a, **kw)
        if out is not state:
            inside.append(time.perf_counter() - t0)
            accepted[:] += (out.rep_scale != state.rep_scale).numpy()
        return out

    barostat.maybe_attempt_mc_move_ensemble = timed_attempt
    try:
        t = time.time()
        ens.step(FLAT_NPT_SETTLE)
        torch.cuda.synchronize()
        log(f"11 {FLAT_NPT_SETTLE} settling steps in {time.time() - t:.2f} "
            f"s; capacity {ctx._cp_cfg.capacity}; {len(inside)} attempts")
        nkbt = ctx._spec.nh_nkbt.double().numpy()
        targets = np.array([300.0, 300.0, 1.0])
        samples, walls, ins = [], [], []

        def drive():
            for _ in range(FLAT_NPT_REPEATS):
                n_in = len(inside)
                t0 = time.time()
                ens.step(FLAT_NPT_STEPS)
                torch.cuda.synchronize()
                walls.append(time.time() - t0)
                ins.append(inside[n_in:])
                samples.append((ctx._state.group_ke.double().numpy() / nkbt
                                * targets)[:FLAT_REPLICAS])

        n_before = len(inside)
        _, launches, plain = counted(drive)
    finally:
        barostat.maybe_attempt_mc_move_ensemble = attempt
    n_att = len(inside) - n_before
    best = int(np.argmin(walls))
    ms_step = walls[best] / FLAT_NPT_STEPS * 1e3
    nsd = ns_per_day(FLAT_NPT_STEPS / walls[best], integ.getStepSize())
    host_ms = [sum(x) * 1e3 for x in ins]
    log(f"11 {FLAT_NPT_REPEATS} x {FLAT_NPT_STEPS} NPT steps: "
        + ", ".join(f"{w / FLAT_NPT_STEPS * 1e3:.2f}" for w in walls)
        + f" ms/step (best {ms_step:.2f}); per replica {nsd:.4f} ns/day, "
        f"aggregate over {FLAT_REPLICAS} replicas "
        f"{nsd * FLAT_REPLICAS:.3f} ns/day on {card}; {n_att} attempts, "
        f"host ms inside them per run {[round(h, 2) for h in host_ms]} "
        f"({host_ms[best] / FLAT_NPT_STEPS:.3f} ms/step in the best run, "
        f"{np.mean([x for r in ins for x in r]) * 1e3:.2f} ms an attempt); "
        f"launches {launches}; plain sweeps on the card {plain}; capacity "
        f"{ctx._cp_cfg.capacity}; cell grid {ctx._cp_cfg.grid}")
    n_total = FLAT_NPT_REPEATS * FLAT_NPT_STEPS
    if (launches["b1_sweep_scaled"] < n_total or plain
            or launches["b1_energy_scaled"] != 2 * n_att
            or any(v for k, v in launches.items()
                   if not k.startswith("b1") or not k.endswith("_scaled"))):
        fail("11: the NPT steps did not run through B1's scaled "
             "instantiations alone (two energy launches an attempt)")

    # per-replica scales, densities, baths, latches
    st = ctx._state
    s = st.rep_scale.double().numpy()[:FLAT_REPLICAS]
    dens = ens.densities()
    temps, e_launches, plain_e = counted(ens.group_temperatures)
    nbl = st.neighbors
    latches = {"overflow": bool(nbl.overflow),
               "drift": bool(nbl.drift_exceeded) or ctx._drift_warned,
               "excl_span": bool(nbl.excl_span_exceeded)
               if nbl.excl_span_exceeded is not None else False,
               "hardwall_runaway": ctx.hardwallRunaway}
    spec = ctx._spec
    p = st.positions.double() + st.pos_err.double()
    drude = torch.nonzero(spec.is_pair & ~spec.is_parent)[:, 0]
    dmax = float(torch.max(torch.linalg.norm(
        p[drude] - p[spec.partner[drude]], dim=1)))
    mean = np.mean(np.concatenate(samples), axis=0)
    total_att = len(inside)
    log(f"11 after {FLAT_NPT_SETTLE + n_total} NPT steps ({total_att} "
        f"attempts by every replica): accepted moves a replica min "
        f"{accepted[:FLAT_REPLICAS].min()}, max "
        f"{accepted[:FLAT_REPLICAS].max()}; scales min {s.min():.6f}, max "
        f"{s.max():.6f}, {len(np.unique(s))} distinct; densities min "
        f"{dens.min():.5f}, mean {dens.mean():.5f}, max {dens.max():.5f} "
        f"g/mL; move sizes {st.baro_scale.min().item():.5f}.."
        f"{st.baro_scale.max().item():.5f} nm^3; latches {latches}; max "
        f"core-Drude distance {dmax:.6f} nm; the state's energy: launches "
        f"{e_launches}, plain sweeps {plain_e}; water bath over the "
        f"replicas at the end: min {temps[:, 0].min():.3f}, mean "
        f"{temps[:, 0].mean():.3f}, max {temps[:, 0].max():.3f} K; bath "
        f"means over the replicas and the {FLAT_NPT_REPEATS} samples "
        f"{np.round(mean, 3).tolist()} K; bands {FLAT_NPT_BANDS}, "
        f"{FLAT_BANDS}")
    lo, hi = FLAT_NPT_BANDS["scale"]
    dlo, dhi = FLAT_NPT_BANDS["density"]
    if total_att < 1 or len(np.unique(s)) < 2:
        fail("11: no attempt, or the replicas' scales did not part")
    if not (np.all((s > lo) & (s < hi)) and np.all((dens > dlo)
                                                     & (dens < dhi))):
        fail(f"11: a scale outside ({lo}, {hi}) or a density outside "
             f"({dlo}, {dhi})")
    if any(latches.values()):
        fail(f"11: a latch is set: {latches}")
    if dmax > 0.02 * 1.00001:
        fail(f"11: hard wall broken: {dmax}")
    if e_launches["b1_energy_scaled"] != 1 or plain_e:
        fail("11: the state's energy did not come from B1's scaled energy "
             "alone")
    for b, name in ((0, "water"), (2, "Drude")):
        blo, bhi = FLAT_BANDS["mean"][b]
        if not blo < mean[b] < bhi:
            fail(f"11: the {name} bath's mean {mean[b]:.3f} K outside "
                 f"({blo}, {bhi})")
    blo, bhi = FLAT_BANDS["replica"]
    if not (np.all(np.isfinite(temps))
            and np.all((temps[:, 0] > blo) & (temps[:, 0] < bhi))):
        fail(f"11: a replica's water bath outside ({blo}, {bhi})")
    if ctx._cp_cfg.grid != cfg.grid or float(st.box[0, 0]) != box0:
        fail("11: the grid was planned again (a replica left the "
             "stencil's slack)")

    # the kernels at the final state, with its distinct scales
    nb, cfg = ctx._nb, ctx._cp_cfg
    box_diag = torch.diagonal(st.box)
    rs = ctx._dev_scale(st.rep_scale)
    exact = ctx._exact_positions(st.positions, st.pos_err)
    fields = nb.fields(st.positions, box_diag, st.neighbors, exact, rs)
    shifts = cellpair.offset_shifts(cfg, box_diag, rs)
    args = (fields, cfg, shifts, nb.alpha, ONE_4PI_EPS0)
    kw = dict(nb.coulomb, excl_skip=nb.excl_skip)
    f_b1, err_b1, ms_b1, plain_b1 = kernel_parity("11", "B1 scaled", sweep,
                                                  args, kw)
    _, err_b2, ms_b2, plain_b2 = kernel_parity(
        "11", "B2 scaled", sweep_chunked, args, kw, ref=f_b1)
    del f_b1
    bound_ms, bound_by, n_tests, n_cut, n_bytes = sweep_bound(fields, cfg,
                                                              shifts)
    log(f"11 force bound {bound_ms:.4f} ms ({bound_by}: {n_tests} pair "
        f"tests, {n_cut} inside the cutoff, {n_bytes} bytes): B1 scaled "
        f"{ms_b1:.4f} ms at {bound_ms / ms_b1:.1%}, B2 scaled {ms_b2:.4f} "
        f"ms at {bound_ms / ms_b2:.1%} on {card}")
    # the band instantiation on the same fields with the unscaled table,
    # for the price of the scaled read
    shifts1 = cellpair.offset_shifts(cfg, box_diag)
    ms_band = cuda_time_ms(lambda: sweep.pair_forces(
        fields, cfg, shifts1, nb.alpha, ONE_4PI_EPS0, **kw), 20)
    log(f"11 B1 band instantiation on the same fields with one replica's "
        f"shift table: {ms_band:.4f} ms (scaled {ms_b1:.4f})")
    del fields, args
    breakdown(ctx, sweep.pair_forces, "b1_sweep_scaled", ms_step, card,
              "11", reps=3)
    fields = nb.fields(st.positions, box_diag, st.neighbors, exact, rs)
    e1 = energy_check_scaled("11 B1 scaled", sweep, fields, cfg, shifts,
                             nb.alpha, card, nb.excl_skip)
    e2 = energy_check_scaled("11 B2 scaled", sweep_chunked, fields, cfg,
                             shifts, nb.alpha, card, nb.excl_skip)

    # isolation: replica 0's scale and positions changed; replicas 1..R-1
    # the same bits out of both kernels (forces and energies)
    ls0 = 1.004
    s2 = st.rep_scale.clone()
    s2[0] *= ls0
    moved = barostat.scale_molecules_per_replica(
        spec, ctx._static, st.positions,
        np.r_[ls0, np.ones(R - 1)])
    rs2 = ctx._dev_scale(s2)
    nbl1 = nb.cellsort(st.positions, box_diag, rs)
    nbl2 = nb.cellsort(moved, box_diag, rs2)
    a1 = (nb.fields(st.positions, box_diag, nbl1, rep_scale=rs), cfg,
          shifts, nb.alpha, ONE_4PI_EPS0)
    a2 = (nb.fields(moved, box_diag, nbl2, rep_scale=rs2), cfg,
          cellpair.offset_shifts(cfg, box_diag, rs2), nb.alpha,
          ONE_4PI_EPS0)
    iso = []
    for name, kernel in (("B1", sweep), ("B2", sweep_chunked)):
        fa = kernel.pair_forces(*a1, **kw)[nbl1.inv_slot]
        fb = kernel.pair_forces(*a2, **kw)[nbl2.inv_slot]
        ea = kernel.pair_energy(*a1, **kw)
        eb = kernel.pair_energy(*a2, **kw)
        torch.cuda.synchronize()
        changed = float(torch.max(torch.abs(fa[:n0] - fb[:n0])))
        same = (bool(torch.equal(fa[n0:], fb[n0:]))
                and bool(torch.equal(ea[1:], eb[1:])))
        iso.append(f"{name}: replica 0 changed by up to {changed:.3e} (its "
                   f"energy {float(eb[0] - ea[0]):+.4f} kJ/mol), replicas "
                   f"1..{R - 1} bit for bit {same}")
        if not (same and changed > 0 and bool(ea[0] != eb[0])):
            fail(f"11: {name} let replica 0's scale reach another replica")
    log(f"11 replica isolation (replica 0 scaled by {ls0}): "
        + "; ".join(iso))
    del fields, a1, a2, nbl1, nbl2, moved, fa, fb
    torch.cuda.empty_cache()

    # physics: the f32 force pass against the f64 flat NPT pass, and the
    # band-edge replicas against single-replica f64 Contexts at the box
    # template * s_r with the flat template's PME plan
    ctx64 = dt.Context(ctx._system, flatrep._clone_integrator(
        integ, R), precision="double", strategy="cellpair",
        nb_options=dict(ctx._nb_options), device="cuda", ensemble_r=R)
    exact = (st.positions.double() + st.pos_err.double())
    ctx64._state = ctx64._state.replace(rep_scale=st.rep_scale.clone())
    ctx64.setPositions(exact.cpu().numpy())
    flips = []
    ferr, ferr_all, frms, n_flip, fs, _ = force_pass_floor(ctx, ctx64,
                                                           flips_out=flips)
    log(f"11 force pass f32 vs f64 (flat NPT): max {ferr:.3e} "
        f"({ferr_all:.3e} with the atoms of {n_flip} cutoff-flipped pairs)"
        f", rms {frms:.3e} (max|F| {fs:.1f})")
    if not (ferr <= 1e-4 and frms <= 5e-6):
        fail("11: the f32 force pass misses the f32 floor against f64")
    f32_forces = ctx._state.forces.double()
    f64_forces = ctx64._state.forces
    skip = flips[0]
    st64 = ctx64._state
    box_t = np.array(system.getDefaultPeriodicBoxVectors(), np.float64)

    def single(scale, positions):
        sys1, _ = builders.build_water_box(FLAT_MOL)
        sys1.setDefaultPeriodicBoxVectors(*(box_t * scale))
        nbf = next(f for f in sys1.getForces()
                   if type(f).__name__ == "NonbondedForce")
        nbf.setPMEParameters(nb.alpha, *nb.pme.grid)
        one = dt.Context(sys1, integrator(), precision="double",
                         strategy="cellpair", device="cuda")
        one.setPositions(positions)
        return one

    def pe(one):
        one._ensure_pe()
        return float(one._state.potential_energy)

    e_now = ctx._mc_energies(st.positions, st.box, st.neighbors, st.pos_err,
                             st.rep_scale).cpu().numpy()
    e64_now = ctx64._mc_energies(st64.positions, st64.box, st64.neighbors,
                                 None, st64.rep_scale).cpu().numpy()
    # the molecules' centres in float64 (the proposed moves below scale
    # them in float64 and split the result into float32 positions and
    # their compensation, so that the molecules keep their geometry to
    # float64 and the full-PE difference holds no intramolecular change)
    mass = spec.mass.double()
    res_mass = torch.zeros(ctx._static.n_residues, dtype=torch.float64,
                           device=mass.device).index_add_(0, spec.resid,
                                                          mass)
    com = torch.zeros((ctx._static.n_residues, 3), dtype=torch.float64,
                      device=mass.device).index_add_(
        0, spec.resid, mass[:, None] * exact) / res_mass[:, None]
    n_mol0 = ctx._static.n_residues // R
    edge, bad = [], []
    for r in FLAT_EDGE_REPLICAS:
        rows = slice(r * n0, (r + 1) * n0)
        sr = float(st.rep_scale[r])
        one = single(sr, exact[rows].cpu().numpy())
        one._ensure_forces()
        ref = one._state.forces
        scale = float(torch.max(torch.abs(ref)))
        keep = ~skip[rows]
        err32 = float(torch.max(torch.abs(
            f32_forces[rows] - ref)[keep])) / scale
        err64 = float(torch.max(torch.abs(f64_forces[rows] - ref))) / scale
        # one proposed move of replica r: the mc_energies difference
        # against the full-PE difference of two such Contexts
        ls = 1.003
        ls_res = torch.ones(ctx._static.n_residues, dtype=torch.float64,
                            device=mass.device)
        ls_res[r * n_mol0:(r + 1) * n_mol0] = ls
        new_exact = exact + ((ls_res - 1.0)[:, None] * com)[spec.resid]
        new_pos = new_exact.to(st.positions.dtype)
        new_err = (new_exact - new_pos.double()).to(st.positions.dtype)
        s_new = st.rep_scale.clone()
        s_new[r] *= ls
        e_new = ctx._mc_energies(new_pos, st.box, st.neighbors, new_err,
                                 s_new).cpu().numpy()
        e64_new = ctx64._mc_energies(new_exact, st64.box, st64.neighbors,
                                     None, s_new).cpu().numpy()
        pe0 = pe(one)
        pe1 = pe(single(sr * ls, new_exact[rows].cpu().numpy()))
        d_ref = pe1 - pe0
        d32, d64 = e_new[r] - e_now[r], e64_new[r] - e64_now[r]
        err_d32 = abs(d32 - d_ref) / abs(pe0)
        err_d64 = abs(d64 - d_ref) / abs(pe0)
        others = float(np.max(np.abs(np.delete(e_new - e_now, r))
                               / np.abs(np.delete(e_now, r))))
        edge.append(f"replica {r} (s {sr:.6f}): forces f32 flat "
                    f"{err32:.3e}, f64 flat {err64:.3e}; move x{ls}: dE "
                    f"single f64 {d_ref:+.6f}, flat f64 {d64:+.6f} "
                    f"({err_d64:.3e} of |E_r|), flat f32 {d32:+.6f} "
                    f"kJ/mol ({err_d32:.3e}); other replicas {others:.1e} "
                    "of theirs")
        if not (err32 <= 1e-4 and err64 <= 1e-8 and err_d64 <= 1e-6
                and err_d32 <= E_F64_REL and others <= 1e-12):
            bad.append(r)
        del one
    log("11 against single-replica f64 Contexts at the box template * s_r "
        "(max |dF| / max|F|; a move's energy difference): "
        + "; ".join(edge))
    del ctx64, st64
    torch.cuda.empty_cache()
    if bad:
        fail(f"11: replicas {bad} differ from their single-replica Contexts "
             "at their boxes")
    del f32_forces, f64_forces, skip
    torch.cuda.empty_cache()

    # a Context routed to B2, its barostat every FLAT_NPT_B2_BARO steps,
    # from the same state
    tpl2, _ = template(FLAT_NPT_B2_BARO)
    ens2 = dt.FlatReplicaEnsemble(
        tpl2, FLAT_REPLICAS, seed=7,
        nb_options={"use_pallas": 3, "capacity": cfg.capacity})
    ctx2 = ens2.context
    ctx2.setPositions(exact.cpu().numpy())
    ctx2.setVelocities(st.velocities.double().cpu().numpy())
    ctx2._state = ctx2._state.replace(rep_scale=st.rep_scale.clone())
    ctx2._ensure_forces()
    if ctx2._nb.sweep_kernel != "b2" or ctx2._cp_cfg.grid != cfg.grid:
        fail(f"11: use_pallas 3 routed to {ctx2._nb.sweep_kernel}")
    _, b2_launches, plain = counted(lambda: ens2.step(FLAT_NPT_B2_STEPS))
    _, b2_e_launches, plain_e = counted(
        lambda: ctx2.getState(energy=True).getPotentialEnergy())
    s2 = ctx2._state.rep_scale.numpy()
    b2_att = len(range(0, FLAT_NPT_B2_STEPS, FLAT_NPT_B2_BARO))
    log(f"11 a Context routed to B2: {FLAT_NPT_B2_STEPS} NPT steps "
        f"({b2_att} attempts), launches {b2_launches}, then its energy: "
        f"{b2_e_launches}; plain sweeps {plain + plain_e}; scales moved "
        f"in {int(np.sum(s2 != st.rep_scale.numpy()))} replicas")
    if (b2_launches["b2_sweep_scaled"] < FLAT_NPT_B2_STEPS
            or b2_launches["b2_energy_scaled"] != 2 * b2_att
            or b2_launches["b1_sweep_scaled"]
            or b2_e_launches["b2_energy_scaled"] != 1 or plain or plain_e
            or not np.any(s2 != st.rep_scale.numpy())):
        fail("11: the B2-routed Context did not run B2's scaled path, or "
             "no move fired")
    del ens2, ctx2, tpl2
    torch.cuda.empty_cache()

    # the checkpoint replay: FLAT_NPT_REPLAY steps (an attempt among
    # them) twice from one checkpoint
    path = os.path.join(HERE, "build", "chip_smoke", "flat_npt.chk")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    dt.save_checkpoint(path, ctx)
    step0 = ctx._state.step
    ens.step(FLAT_NPT_REPLAY)
    first = (ctx._state.positions.clone(), ctx._state.rep_scale.clone())
    dt.load_checkpoint(path, ctx)
    _, replay_launches, _ = counted(lambda: ens.step(FLAT_NPT_REPLAY))
    dx = float(torch.max(torch.abs(ctx._state.positions - first[0])))
    same_s = bool(torch.equal(ctx._state.rep_scale, first[1]))
    log(f"11 checkpoint of the flat NPT state at step {step0}, "
        f"{FLAT_NPT_REPLAY} steps, loaded, {FLAT_NPT_REPLAY} steps "
        f"(launches {replay_launches}): max |dx| {dx:.3e} nm, scales the "
        f"same bits {same_s}")
    if (dx != 0.0 or not same_s
            or replay_launches["b1_energy_scaled"] < 2):
        fail("11: the flat NPT checkpoint replay (with an attempt) was not "
             "bit for bit")
    log(f"11 peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del ens, ctx, tpl
    torch.cuda.empty_cache()

    src1 = "openmm_drudenose_tpu_torch/csrc/sweep.cu"
    src2 = "openmm_drudenose_tpu_torch/csrc/sweep_chunked.cu"
    tpu1 = "openmm_drudenose_tpu/ops/pallas_sweep.py:440"
    tpu2 = "openmm_drudenose_tpu/ops/pallas_sweep.py:851"
    common = {"route": "cuda", "coulomb": "ewald", "geometry": "scaled",
              "capacity": cfg.capacity, "library_ms": None}
    return [dict(common, name="b1_sweep_scaled", instantiation="forces",
                 source=src1, replaces=tpu1,
                 launches=launches["b1_sweep_scaled"],
                 launches_per_step=launches["b1_sweep_scaled"] / n_total,
                 max_abs_err=err_b1, ms=ms_b1, plain_ms=plain_b1,
                 bound_ms=bound_ms, bound_by=bound_by),
            dict(common, name="b1_energy_scaled", instantiation="energy",
                 source=src1, replaces=tpu1,
                 launches=launches["b1_energy_scaled"],
                 launches_per_step=launches["b1_energy_scaled"] / n_total,
                 **e1),
            dict(common, name="b2_sweep_scaled", instantiation="forces",
                 source=src2, replaces=tpu2,
                 launches=b2_launches["b2_sweep_scaled"],
                 launches_per_step=(b2_launches["b2_sweep_scaled"]
                                    / FLAT_NPT_B2_STEPS),
                 max_abs_err=err_b2, ms=ms_b2, plain_ms=plain_b2,
                 bound_ms=bound_ms, bound_by=bound_by),
            dict(common, name="b2_energy_scaled", instantiation="energy",
                 source=src2, replaces=tpu2,
                 launches=b2_launches["b2_energy_scaled"], **e2)]


def ff_deck(card):
    """The phase 12 deck: build_nacl_water_box(FF_WATER, FF_IONS,
    FF_IONS), written as a position PDB (Drudes, M sites) and a bare PDB
    under build/chip_smoke/; returns (bare path, position path)."""
    from openmm_drudenose_tpu_torch.examples import nacl_tg_ff
    from openmm_drudenose_tpu_torch.io import builders
    t = time.time()
    system, pos = builders.build_nacl_water_box(FF_WATER, FF_IONS, FF_IONS)
    n = system.getNumParticles()
    out = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out, exist_ok=True)
    bare = os.path.join(out, "nacl100k_bare.pdb")
    with_sites = os.path.join(out, "nacl100k_pos.pdb")
    nacl_tg_ff.write_nacl_pdbs(system, pos, bare, with_sites)
    log(f"12 deck: build_nacl_water_box({FF_WATER}, {FF_IONS}, {FF_IONS}) "
        f"= {n} atoms, written as PDB files in {time.time() - t:.1f} s")
    if n != 100000:
        fail(f"12: the deck has {n} atoms, not 100,000")
    return bare, with_sites


def ff_compare(sys_f, sys_h):
    """(a) of phase 12: the FF System against the hand-built one, term by
    term on the host (the JAX package's tests/test_forcefield.py:
    136-190): masses, constraints as sets, sites, nonbonded parameters,
    exclusions as sets, Drude rows, NBFIX and NBTHOLE."""
    import openmm_drudenose_tpu_torch as dt
    n = sys_h.getNumParticles()
    if sys_f.getNumParticles() != n:
        fail("12 (a): particle counts differ")
    m_f = np.array([sys_f.getParticleMass(i) for i in range(n)])
    m_h = np.array([sys_h.getParticleMass(i) for i in range(n)])
    con = lambda s: {(*sorted(s.getConstraintParameters(i)[:2]),
                      round(s.getConstraintParameters(i)[2], 9))
                     for i in range(s.getNumConstraints())}
    force = lambda s, cls: next(f for f in s.getForces()
                                if isinstance(f, cls))
    site_ok = all(
        sys_f.isVirtualSite(i) == sys_h.isVirtualSite(i)
        and (not sys_h.isVirtualSite(i)
             or (sys_f.getVirtualSite(i).particles
                 == sys_h.getVirtualSite(i).particles
                 and np.allclose(sys_f.getVirtualSite(i).weights,
                                 sys_h.getVirtualSite(i).weights,
                                 atol=1e-9)))
        for i in range(n))
    nb_f, nb_h = (force(s, dt.NonbondedForce) for s in (sys_f, sys_h))
    p_f = np.array(nb_f._particles)
    p_h = np.array(nb_h._particles)
    lj = p_h[:, 2] > 0
    nb_ok = (np.allclose(p_f[:, [0, 2]], p_h[:, [0, 2]], atol=1e-9)
             and np.allclose(p_f[lj, 1], p_h[lj, 1], atol=1e-9))
    exc = lambda f: {tuple(sorted(e[:2])) for e in f._exceptions}
    norm_ov = lambda f: sorted(
        tuple(sorted([tuple(sorted(o[0])), tuple(sorted(o[1]))]))
        + (round(o[2], 9), round(o[3], 9)) for o in f._lj_overrides)
    dr_f, dr_h = (force(s, dt.DrudeForce) for s in (sys_f, sys_h))
    rows_ok = (dr_f.getNumParticles() == dr_h.getNumParticles() and all(
        dr_f.getParticleParameters(i)[:5] == dr_h.getParticleParameters(i)[:5]
        and np.allclose(dr_f.getParticleParameters(i)[5:],
                        dr_h.getParticleParameters(i)[5:], atol=1e-9)
        for i in range(dr_h.getNumParticles())))
    checks = {
        "masses": bool(np.allclose(m_f, m_h, atol=1e-12)),
        "constraints": con(sys_f) == con(sys_h), "sites": site_ok,
        "nonbonded": bool(nb_ok), "exclusions": exc(nb_f) == exc(nb_h),
        "nbfix": norm_ov(nb_f) == norm_ov(nb_h), "drude_rows": rows_ok,
        "nbthole": dr_f._nbthole == dr_h._nbthole}
    log(f"12 (a) FF System against the hand-built one ({n} particles, "
        f"{sys_h.getNumConstraints()} constraints, "
        f"{len(nb_h._exceptions)} exceptions, {len(dr_h._nbthole)} "
        f"NBTHOLE pairs): {checks}")
    if not all(checks.values()):
        fail("12 (a): the FF System differs from the hand-built one")


def phase_ff(card, ms_step_nvt):
    """12. The force-field XML path at 100k, NPT through B1 (see the
    module docstring).  Returns (the FF Context's final state as
    (compensated positions, velocities, box), the deck's modeller)."""
    import torch
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.examples import nacl_tg_ff
    from openmm_drudenose_tpu_torch.integrators import barostat
    from openmm_drudenose_tpu_torch.io import nacl, pdbfile
    from openmm_drudenose_tpu_torch.ops import sweep
    bare, with_sites = ff_deck(card)
    top = pdbfile.PDBFile(bare).topology
    residues = top.residues()
    log(f"12 bare PDB: {len(top.atoms)} atoms, {len(residues)} residues "
        f"(residue numbers up to {max(a.res_seq for a in top.atoms)}, "
        f"wrapped at 10,000)")
    if (len(top.atoms), len(residues)) != (59840, 20480) or any(
            len(a) not in (1, 3) for _, a in residues):
        fail("12: the bare PDB did not read back as 20,480 residues")
    sys_f, modeller, seconds = nacl_tg_ff.build(nacl_tg_ff.FFXML, bare)
    log("12 ingestion (host seconds): " + ", ".join(
        f"{k} {v:.2f}" for k, v in seconds.items())
        + f"; total {sum(seconds.values()):.2f}")
    t = time.time()
    rmin_a = FF_NBFIX_SIGMA * 2 ** (1 / 6) / 0.1
    sys_h, _, _ = nacl.load_nacl_swm4(
        with_sites, cutoff=1.0,
        nbfix={("SOD", "CLA"): (rmin_a, FF_NBFIX_EPS / 4.184)},
        nbthole={("SOD", "CLA"): FF_NBTHOLE})
    log(f"12 hand-built System from the position PDB in "
        f"{time.time() - t:.1f} s")
    ff_compare(sys_f, sys_h)
    positions = np.asarray(modeller.positions, np.float64)

    def make_ctx(system, precision="single"):
        integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20)
        integ.setMaxDrudeDistance(0.02)
        ctx = dt.Context(system, integ, precision=precision, device="cuda")
        ctx.setPositions(positions)
        return ctx, integ

    # (b) the force pass of each System on the card at the same positions
    # (f32, through B1) and its energy in f32 and in f64: the f32 energy
    # sums parts of ~1e7 kJ/mol (the Ewald self term) whose float32 ulps
    # are several kJ/mol, so the parameters' last-bit differences show
    # there at ~4e-6 of |E| (on an NVIDIA H100); the 1e-6 is held in
    # f64, the f32 energy at the f32 energy floor E_F64_REL
    passes = []
    for system in (sys_f, sys_h):
        ctx, _ = make_ctx(system)
        (f, e), launches, plain = counted(lambda: (
            ctx.getState(forces=True).getForces(),
            ctx.getState(energy=True).getPotentialEnergy()))
        kernel = ctx._nb.sweep_kernel
        del ctx
        ctx64, _ = make_ctx(system, "double")
        e64 = ctx64.getState(energy=True).getPotentialEnergy()
        del ctx64
        torch.cuda.empty_cache()
        passes.append((f, e, e64, launches, plain, kernel))
    (f_f, e_f, e64_f, l_f, pl_f, k_f), (f_h, e_h, e64_h, _, pl_h, k_h) = \
        passes
    ferr = float(np.max(np.abs(f_f - f_h)) / np.max(np.abs(f_h)))
    erel = abs(e_f - e_h) / abs(e_h)
    erel64 = abs(e64_f - e64_h) / abs(e64_h)
    log(f"12 (b) force pass of the FF System against the hand-built one "
        f"on the card (f32, route {k_f}/{k_h}): max|dF|/max|F| {ferr:.3e}; "
        f"energy in f32 {e_f:.3f} against {e_h:.3f} kJ/mol ({erel:.3e} of "
        f"|E|), in f64 {e64_f:.6f} against {e64_h:.6f} ({erel64:.3e}); "
        f"launches {l_f}, plain sweeps in the f32 passes {pl_f + pl_h}")
    if not (ferr <= 2e-5 and erel64 <= 1e-6 and erel <= E_F64_REL) \
            or pl_f or pl_h or k_f != "b1" or l_f["b1_sweep"] < 1:
        fail("12 (b): the FF System's force pass differs from the "
             "hand-built one's, or did not run through B1")

    # (c), (d) minimize, settle, then NPT counted
    sys_f.addForce(dt.MonteCarloBarostat(1.0, 300.0, FF_BARO))
    ctx, integ = make_ctx(sys_f)
    minimized("12", ctx, FF_MIN)
    ctx.setVelocitiesToTemperature(300.0, seed=0)
    targets = np.array([300.0, 300.0, 1.0])
    for stage in ("from the minimized lattice", "after the restart"):
        t = time.time()
        integ.step(FF_SETTLE)
        torch.cuda.synchronize()
        temps = ctx.getState(groups=True).getGroupTemperatures()
        log(f"12 {FF_SETTLE} settling NPT steps {stage} in "
            f"{time.time() - t:.2f} s; bath temperatures "
            f"{np.round(temps, 3).tolist()} K; box "
            f"{float(ctx._state.box[0, 0]):.4f} nm")
        log(f"12 hard-wall runaway latched in these settling steps: "
            f"{ctx.hardwallRunaway} (fresh 300 K velocities give the "
            f"Drudes 300 K relative motion for a few hundred steps); the "
            f"latch is cleared, the counted steps must not set it")
        ctx.clearHardwallRunaway()
        if stage.startswith("from"):
            # a fresh chain at the settled positions and box
            st = ctx._state
            settled = (st.positions.double() + st.pos_err.double())
            box = st.box.double().cpu().numpy()
            sys_f.setDefaultPeriodicBoxVectors(*map(tuple, box))
            ctx.reinitialize(preserveState=False)
            ctx.setPositions(settled.cpu().numpy())
            ctx.setVelocitiesToTemperature(300.0, seed=1)
    inside = []
    attempt = barostat.maybe_attempt_mc_move

    def timed_attempt(spec, static, state, *a, **kw):
        t0 = time.perf_counter()
        out = attempt(spec, static, state, *a, **kw)
        if out is not state:
            inside.append(time.perf_counter() - t0)
        return out

    step0 = ctx._state.step
    attempts = sum(1 for k in range(step0, step0 + FF_STEPS)
                   if k % FF_BARO == 0)
    barostat.maybe_attempt_mc_move = timed_attempt
    try:
        ms_step, nsd, launches, plain, mean = run_blocks(ctx, integ,
                                                         FF_STEPS, targets)
    finally:
        barostat.maybe_attempt_mc_move = attempt
    log(f"12 {FF_STEPS} NPT steps: {ms_step:.2f} ms/step, {nsd:.3f} ns/day "
        f"on {card} (phase 3, NVT water: {ms_step_nvt:.2f}); {len(inside)} "
        f"attempts, {np.mean(inside) * 1e3:.2f} ms each inside the attempt: "
        f"{np.sum(inside) * 1e3 / FF_STEPS:.3f} ms/step; launches "
        f"{launches}; plain sweeps on the card {plain}")
    if (launches["b1_sweep"] < FF_STEPS or plain or launches["b2_sweep"]
            or launches["b1_energy"] != 2 * attempts
            or len(inside) != attempts):
        fail("12: the NPT steps did not run through B1 alone, or the "
             "attempts were not B1's energy")
    # the deck's Cl- Drudes (q_D = -3.46 e) reach 0.034-0.046 nm before
    # the bounce in the fields of their neighbours (PERF.md): the 0.02 nm
    # wall binds them, and the runaway latch (twice the wall) reads their
    # field, not an instability; printed, then cleared
    log(f"12 a Drude bounced back from past twice the wall in the counted "
        f"steps: {ctx.hardwallRunaway}")
    ctx.clearHardwallRunaway()
    last, e_launches, plain = counted(lambda: check_after_steps(ctx, "12"))
    if e_launches["b1_energy"] != 1 or plain:
        fail(f"12: the state's energy: {e_launches}, {plain} plain sweeps")
    hold_bands("12", ["water+ions", "COM", "Drude"], mean, last, FF_BANDS)
    breakdown(ctx, sweep.pair_forces, "b1_sweep", ms_step, card, "12")
    st = ctx._state
    mass = float(torch.sum(ctx._spec.mass.double()))
    vol = float(st.box[0, 0] * st.box[1, 1] * st.box[2, 2])
    density = mass * 1.66053906660 / (vol * 1e3)
    log(f"12 density {density:.4f} g/mL (band {FF_DENSITY}), volume "
        f"{vol:.3f} nm^3, {st.baro_naccept} of {st.baro_nattempt} moves "
        f"accepted since the last adaptation")
    if not FF_DENSITY[0] < density < FF_DENSITY[1]:
        fail(f"12: density {density:.4f} g/mL outside {FF_DENSITY}")
    final = ((st.positions.double() + st.pos_err.double()).cpu().numpy(),
             st.velocities.double().cpu().numpy(),
             st.box.double().cpu().numpy())
    del ctx
    torch.cuda.empty_cache()
    return final, modeller


def constraint_errors(ctx):
    """(max |r^2/d^2 - 1| over the SHAKE constraints at the compensated
    positions, max |r.v|/d^2)."""
    import torch
    spec, st = ctx._spec, ctx._state
    p = st.positions.double()
    if st.pos_err is not None:
        p = p + st.pos_err.double()
    i, j = spec.shake_idx[:, 0], spec.shake_idx[:, 1]
    r = p[i] - p[j]
    d2 = spec.shake_dist.double() ** 2
    v = st.velocities.double()
    rv = torch.sum(r * (v[i] - v[j]), dim=1)
    return (float(torch.max(torch.abs(torch.sum(r * r, 1) / d2 - 1))),
            float(torch.max(torch.abs(rv) / d2)))


def phase_shake(card, ms_step_nvt, final, modeller):
    """13. SHAKE clusters at 100k, NVT through B1 (see the module
    docstring)."""
    import torch
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.app import ForceField, HBonds, PME
    from openmm_drudenose_tpu_torch.constraints import shake
    from openmm_drudenose_tpu_torch.examples import nacl_tg_ff
    from openmm_drudenose_tpu_torch.ops import sweep
    pos, vel, box = final
    t = time.time()
    system = ForceField(nacl_tg_ff.FFXML).createSystem(
        modeller.topology, nonbondedMethod=PME, nonbondedCutoff=1.0,
        constraints=HBonds, rigidWater=False)
    nacl_tg_ff.repartition(system, modeller.topology)
    system.setDefaultPeriodicBoxVectors(*map(tuple, box))
    log(f"13 createSystem(rigidWater=False) in {time.time() - t:.1f} s")

    def make_ctx(precision):
        integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20)
        integ.setMaxDrudeDistance(0.02)
        ctx = dt.Context(system, integ, precision=precision, device="cuda")
        ctx.setPositions(pos)
        ctx.setVelocities(vel)
        return ctx, integ

    ctx, integ = make_ctx("single")
    static = ctx._static
    tol = static.constraint_tol
    log(f"13 {static.n_shake} SHAKE constraints, {static.n_settle} SETTLE "
        f"triangles, tolerance {tol}; route {ctx._nb.sweep_kernel}")
    if static.n_shake != 2 * FF_WATER or static.n_settle:
        fail("13: the flexible deck is not 39,360 SHAKE constraints")
    stats = shake.ShakeStats()
    ctx._stepper.shake_stats = stats
    nkbt = ctx._spec.nh_nkbt.double().numpy()
    targets = np.array([300.0, 300.0, 1.0])
    samples, worst, runaways = [], [0.0], [0]

    def drive():
        for _ in range(SHAKE_STEPS // BLOCK):
            integ.step(BLOCK)
            samples.append(ctx._state.group_ke.double().numpy() / nkbt
                           * targets)
            worst[0] = max(worst[0], constraint_errors(ctx)[0])
            # a Drude bounced back from past twice the wall (phase 12's
            # Cl- Drudes): counted and printed, the wall held at the end
            runaways[0] += ctx.hardwallRunaway
            ctx.clearHardwallRunaway()

    t = time.time()
    _, launches, plain = counted(drive)
    wall = time.time() - t
    ms_step = wall / SHAKE_STEPS * 1e3
    sweeps_pos = np.array(stats.per_call("pos"))
    sweeps_vel = np.array(stats.per_call("vel"))
    shake_worst = float(torch.max(torch.stack(stats.violation)))
    log(f"13 {SHAKE_STEPS} NVT steps: {ms_step:.2f} ms/step against phase "
        f"3's {ms_step_nvt:.2f} on {card}; SHAKE sweeps a step mean "
        f"{sweeps_pos.mean():.2f} (max {sweeps_pos.max()}), RATTLE "
        f"{sweeps_vel.mean():.2f} (max {sweeps_vel.max()}); host reads of "
        f"the done flag {stats.reads / SHAKE_STEPS:.2f} a step; worst "
        f"|r^2/d^2 - 1| of SHAKE's result over the steps {shake_worst:.3e} "
        f"(limit {2 * tol}), after a block {worst[0]:.3e} (the hard wall "
        f"moves a bounced Drude's parent after SHAKE, in the reference's "
        f"order: the next step's SHAKE restores it); blocks in which a "
        f"Drude was bounced back from past twice the wall: {runaways[0]} "
        f"of {SHAKE_STEPS // BLOCK}; launches {launches}; plain sweeps on "
        f"the card {plain}")
    if launches["b1_sweep"] < SHAKE_STEPS or plain or launches["b2_sweep"]:
        fail("13: the steps did not run through B1 alone")
    # (a chunk that overflowed the cell capacity is run again: more calls)
    if not shake_worst <= 2 * tol or len(sweeps_pos) < SHAKE_STEPS:
        fail("13: SHAKE left a constraint outside its 2 tol band")
    last, e_launches, plain = counted(lambda: check_after_steps(ctx, "13"))
    if e_launches["b1_energy"] != 1 or plain:
        fail(f"13: the state's energy: {e_launches}, {plain} plain sweeps")
    hold_bands("13", ["water+ions", "COM", "Drude"],
               np.mean(samples, axis=0), last, SHAKE_BANDS)
    breakdown(ctx, sweep.pair_forces, "b1_sweep", ms_step, card, "13")
    # RATTLE's projection at the final state
    after_step = constraint_errors(ctx)[1]
    ctx.applyVelocityConstraints(tol)
    projected = constraint_errors(ctx)[1]
    log(f"13 max |r.v|/d^2: {after_step:.3e} after the last step (the NH "
        f"half step scales the bath velocities after RATTLE), "
        f"{projected:.3e} after the projection (limit {tol})")
    if not projected <= tol:
        fail("13: the velocity projection left |r.v|/d^2 above tol")
    # the stream time of one SHAKE and one RATTLE call at the step's size
    st, spec = ctx._state, ctx._spec
    delta = 0.001 * st.velocities
    shake_ms = cuda_time_ms(lambda: shake.apply_position_constraints(
        st.positions, delta, spec.inv_mass, spec.shake_idx,
        spec.shake_dist, tol, static.shake_max_iter), 5)
    rattle_ms = cuda_time_ms(lambda: shake.apply_velocity_constraints(
        st.positions, st.velocities, spec.inv_mass, spec.shake_idx,
        spec.shake_dist, tol, static.shake_max_iter), 5)
    log(f"13 one SHAKE call {shake_ms:.3f} ms, one RATTLE call "
        f"{rattle_ms:.3f} ms of stream time (with their host reads) on "
        f"{card}")
    # one step in f32 against one in f64 from the same state
    p0 = (st.positions.double() + st.pos_err.double()).cpu().numpy()
    v0 = st.velocities.double().cpu().numpy()
    del ctx
    torch.cuda.empty_cache()
    out = []
    for precision in ("single", "double"):
        c, ig = make_ctx(precision)
        c.setPositions(p0)
        c.setVelocities(v0)
        ig.step(1)
        s_ = c._state
        p = s_.positions.double()
        if s_.pos_err is not None:
            p = p + s_.pos_err.double()
        out.append((p.cpu().numpy(), constraint_errors(c)[0]))
        del c
        torch.cuda.empty_cache()
    dx = float(np.max(np.abs(out[0][0] - out[1][0])))
    log(f"13 one step f32 against f64 from the same state: max |dx| "
        f"{dx:.3e} nm; |r^2/d^2 - 1| {out[0][1]:.3e} (f32), "
        f"{out[1][1]:.3e} (f64)")
    if not dx <= 1e-5:
        fail("13: the f32 step left the f64 one by more than 1e-5 nm")
    return ms_step, sweeps_pos


def phase_terms(card):
    """14. The plain-PyTorch terms on the card (see the module
    docstring)."""
    from openmm_drudenose_tpu_torch.tools import term_checks
    t = time.time()
    worst = term_checks.compare_devices("cuda")
    log(f"14 float64 card against CPU (|dE|/|E|, max|dF|/max|F|) in "
        f"{time.time() - t:.1f} s: " + ", ".join(
            f"{k} ({e:.1e}, {f:.1e})" for k, (e, f) in worst.items()))
    bad = {k: v for k, v in worst.items()
           if not (v[0] <= 1e-10 and v[1] <= 1e-8)}
    if bad:
        fail(f"14: the card left the CPU on {bad}")
    t = time.time()
    pos, pe = term_checks.custom_dynamics("cuda", 200, "single")
    log(f"14 200 float32 steps of the custom-force system on the card in "
        f"{time.time() - t:.1f} s: PE {pe:.4f} kJ/mol")
    if not (np.isfinite(pe) and np.all(np.isfinite(pos))):
        fail("14: the custom-force dynamics went non-finite")


def phase_switch(card, final, il_state, bench_args):
    """15. Switched LJ at full width, through the switched instantiations
    of B1 and B2 (see the module docstring).  Returns their `kernels`
    entries."""
    import torch
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.examples import nacl_tg_ff
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
    bare = os.path.join(HERE, "build", "chip_smoke", "nacl100k_bare.pdb")
    system, _, seconds = nacl_tg_ff.build(nacl_tg_ff.FFXML, bare,
                                          cutoff=SW_CUTOFF,
                                          switch_distance=SW_ON)
    pos, vel, box = final
    system.setDefaultPeriodicBoxVectors(*map(tuple, box))
    nbf = next(f for f in system.getForces()
               if isinstance(f, dt.NonbondedForce))
    log(f"15 the deck of phase 12 through createSystem(PME, "
        f"nonbondedCutoff={SW_CUTOFF}, switchDistance={SW_ON}, HBonds, "
        f"rigidWater): {system.getNumParticles()} atoms in "
        f"{sum(seconds.values()):.2f} s of host time; cutoff "
        f"{nbf.getCutoffDistance()}, switch {nbf.getUseSwitchingFunction()} "
        f"from {nbf.getSwitchingDistance()}")
    if not (nbf.getUseSwitchingFunction()
            and nbf.getSwitchingDistance() == SW_ON
            and nbf.getCutoffDistance() == SW_CUTOFF):
        fail("15: createSystem did not set the switch")

    def make_ctx(precision, options=None, state=(pos, vel)):
        integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20)
        integ.setMaxDrudeDistance(0.02)
        ctx = dt.Context(system, integ, precision=precision, device="cuda",
                         nb_options=options)
        ctx.setPositions(state[0])
        ctx.setVelocities(state[1])
        return ctx, integ

    ctx, integ = make_ctx("single")
    ctx._ensure_neighbors()
    nb, cfg = ctx._nb, ctx._cp_cfg
    log(f"15 context: cell grid {cfg.grid}, capacity {cfg.capacity}, "
        f"{cfg.n_offsets} offsets, PME grid {nb.pme.grid}, alpha "
        f"{nb.alpha:.6f}, route {nb.sweep_kernel}, pair kind {nb.coulomb}")
    if nb.sweep_kernel != "b1" or nb.coulomb.get("r_switch") != SW_ON:
        fail("15: the switched deck is not on B1 with the switch")
    ctx64, _ = make_ctx("double", {"capacity": cfg.capacity})
    ferr, ferr_all, frms, n_flip, fs, _ = force_pass_floor(ctx, ctx64)
    del ctx64
    torch.cuda.empty_cache()
    log(f"15 force pass f32 vs f64: max {ferr:.3e} ({ferr_all:.3e} with "
        f"the atoms of {n_flip} cutoff-flipped pairs), rms {frms:.3e} "
        f"(max|F| {fs:.1f})")
    if not (ferr <= 1e-4 and frms <= 5e-6):
        fail("15: the switched f32 force pass misses the f32 floor")

    # the switched instantiations on the deck's fields, and B1's
    # unswitched one on the same fields and on phase 3's
    st = ctx._state
    box_diag = torch.diagonal(st.box)
    fields = nb.fields(st.positions, box_diag, st.neighbors)
    shifts = cellpair.offset_shifts(cfg, box_diag)
    args = (fields, cfg, shifts, nb.alpha, ONE_4PI_EPS0)
    kw = dict(nb.coulomb, excl_skip=nb.excl_skip)
    f_b1, err_b1, ms_b1, plain_b1 = kernel_parity("15", "B1 switched",
                                                  sweep, args, kw)
    _, err_b2, ms_b2, plain_b2 = kernel_parity(
        "15", "B2 switched", sweep_chunked, args, kw, ref=f_b1)
    kw_plain = {k: v for k, v in kw.items() if k != "r_switch"}
    f_u = sweep.pair_forces(*args, **kw_plain)
    moved = float(torch.max(torch.abs(f_u - f_b1))) \
        / float(torch.max(torch.abs(f_b1)))
    del f_b1, f_u
    eff_b1, eff_ref = switch_effect("15", "B1", sweep, args, kw)
    eff_b2, _ = switch_effect("15", "B2", sweep_chunked, args, kw, eff_ref)
    del eff_ref
    ms_unsw = cuda_time_ms(lambda: sweep.pair_forces(*args, **kw_plain), 20)
    bound_ms, bound_by, n_tests, n_cut, n_bytes = sweep_bound(
        fields, cfg, shifts, r_switch=SW_ON)
    n_win = pair_counts(fields, cfg, shifts, SW_ON)[2]
    e1 = energy_check("15 B1 switched", sweep, fields, cfg, shifts,
                      nb.alpha, card, nb.coulomb, nb.excl_skip)
    e2 = energy_check("15 B2 switched", sweep_chunked, fields, cfg, shifts,
                      nb.alpha, card, nb.coulomb, nb.excl_skip)
    ms_bench = cuda_time_ms(lambda: sweep.pair_forces(*bench_args), 20)
    regs = {f"{k}_{i}{c}": mod.attributes(i == "energy", m, False, sw)
            for k, mod in (("b1", sweep), ("b2", sweep_chunked))
            for i in ("sweep", "energy") for m, c0 in (("ewald", ""),
                                                      ("rf", "_rf"))
            for sw, c in ((False, c0), (True, c0 + "_sw"))}
    log(f"15 B1 switched {ms_b1:.4f} ms, B2 switched {ms_b2:.4f} ms, B1 "
        f"unswitched on the same fields {ms_unsw:.4f} ms; bound "
        f"{bound_ms:.4f} ms ({bound_by}: {n_tests} pair tests, {n_cut} "
        f"inside the {SW_CUTOFF} nm cutoff, {n_win} of them in the switch's "
        f"window, {n_bytes} bytes); the switch moves the forces by "
        f"{moved:.3e} of max|F|; on {card}")
    log(f"15 B1 unswitched on phase 3's fields {ms_bench:.4f} ms "
        f"(PERF.md's kernel table: 0.8840 ms, 77 registers); registers of "
        f"each instantiation (read from the card): " + ", ".join(
            f"{k} {a['regs']}" + (f" ({a['local_bytes']} B local)"
                                  if a["local_bytes"] else "")
            for k, a in regs.items()))

    # steps through B1's switched instantiation
    integ.step(SW_SETTLE)
    torch.cuda.synchronize()
    log(f"15 {SW_SETTLE} settling steps; hard-wall runaway latched there: "
        f"{ctx.hardwallRunaway} (cleared)")
    ctx.clearHardwallRunaway()
    targets = np.array([300.0, 300.0, 1.0])
    ms_step, nsd, launches, plain, mean = run_blocks(ctx, integ, SW_STEPS,
                                                     targets)
    log(f"15 {SW_STEPS} NVT steps: {ms_step:.2f} ms/step, {nsd:.3f} ns/day "
        f"on {card}; launches {launches}; plain sweeps on the card {plain}")
    if (launches["b1_sweep_sw"] < SW_STEPS or plain
            or any(v for k, v in launches.items() if k != "b1_sweep_sw")):
        fail("15: the steps did not run their forces through B1's "
             "switched instantiation alone")
    log(f"15 a Drude bounced back from past twice the wall in the counted "
        f"steps: {ctx.hardwallRunaway} (cleared)")
    ctx.clearHardwallRunaway()
    last, e_launches, plain = counted(lambda: check_after_steps(ctx, "15"))
    if e_launches["b1_energy_sw"] != 1 or plain:
        fail(f"15: the state's energy: {e_launches}, {plain} plain sweeps")
    hold_bands("15", ["water+ions", "COM", "Drude"], mean, last, FF_BANDS)
    breakdown(ctx, sweep.pair_forces, "b1_sweep_sw", ms_step, card, "15")

    # the forced route to B2 from the same state
    st = ctx._state
    state = ((st.positions.double() + st.pos_err.double()).cpu().numpy(),
             st.velocities.double().cpu().numpy())
    del ctx, integ, fields, args
    torch.cuda.empty_cache()
    ctx2, integ2 = make_ctx("single", {"use_pallas": 3,
                                       "capacity": cfg.capacity}, state)
    ctx2._ensure_forces()
    _, b2_launches, plain = counted(lambda: integ2.step(SW_B2_STEPS))
    _, b2_e, plain_e = counted(
        lambda: ctx2.getState(energy=True).getPotentialEnergy())
    log(f"15 a Context routed to B2: {SW_B2_STEPS} steps, launches "
        f"{b2_launches}, then its energy: {b2_e}; plain sweeps "
        f"{plain + plain_e}")
    if (ctx2._nb.sweep_kernel != "b2"
            or b2_launches["b2_sweep_sw"] < SW_B2_STEPS
            or b2_launches["b1_sweep_sw"] or b2_e["b2_energy_sw"] != 1
            or plain or plain_e):
        fail("15: the B2-routed Context did not run B2's switched "
             "instantiation")
    del ctx2, integ2
    torch.cuda.empty_cache()

    # the reaction field, switched: phase 7's ionic liquid at its 1.2 nm
    # cutoff, the switch from SW_ON
    il_system, il_make_ctx, il_pos, il_vel = il_state
    _switch_force(il_system, SW_ON)
    ctx3, integ3 = il_make_ctx("single", {})
    ctx3.setPositions(il_pos)
    ctx3.setVelocities(il_vel)
    ctx3._ensure_neighbors()
    nb3, cfg3, st3 = ctx3._nb, ctx3._cp_cfg, ctx3._state
    if not (nb3.coulomb["method"] == "rf"
            and nb3.coulomb.get("r_switch") == SW_ON
            and nb3.sweep_kernel == "b1"):
        fail(f"15: the switched ionic liquid took {nb3.coulomb}")
    box3 = torch.diagonal(st3.box)
    fields3 = nb3.fields(st3.positions, box3, st3.neighbors)
    shifts3 = cellpair.offset_shifts(cfg3, box3)
    args3 = (fields3, cfg3, shifts3, nb3.alpha, ONE_4PI_EPS0)
    kw3 = dict(nb3.coulomb, excl_skip=nb3.excl_skip)
    _, err_rf, ms_rf, plain_rf = kernel_parity("15", "B1 switched RF", sweep,
                                               args3, kw3)
    eff_rf, _ = switch_effect("15", "B1 RF", sweep, args3, kw3)
    bound_rf, bound_by_rf, *_ = sweep_bound(fields3, cfg3, shifts3,
                                            method="rf", r_switch=SW_ON)
    e3 = energy_check("15 B1 switched RF", sweep, fields3, cfg3, shifts3,
                      nb3.alpha, card, nb3.coulomb, nb3.excl_skip)
    del fields3, args3
    _, rf_launches, plain = counted(lambda: integ3.step(SW_IL_STEPS))
    _, rf_e, plain_e = counted(
        lambda: ctx3.getState(energy=True).getPotentialEnergy())
    log(f"15 the switched ionic liquid: {SW_IL_STEPS} steps, launches "
        f"{rf_launches}, then its energy: {rf_e}; plain sweeps "
        f"{plain + plain_e}; B1 switched RF {ms_rf:.4f} ms, bound "
        f"{bound_rf:.4f} ms ({bound_by_rf})")
    if (rf_launches["b1_sweep_rf_sw"] < SW_IL_STEPS or plain or plain_e
            or rf_e["b1_energy_rf_sw"] != 1):
        fail("15: the switched ionic liquid did not step through B1's "
             "switched RF instantiation")
    del ctx3, integ3
    torch.cuda.empty_cache()

    src1 = "openmm_drudenose_tpu_torch/csrc/sweep.cu"
    src2 = "openmm_drudenose_tpu_torch/csrc/sweep_chunked.cu"
    tpu1 = "openmm_drudenose_tpu/ops/pallas_sweep.py:440"
    tpu2 = "openmm_drudenose_tpu/ops/pallas_sweep.py:851"
    common = {"route": "cuda", "geometry": "switched", "library_ms": None,
              "r_switch": SW_ON, "cutoff": SW_CUTOFF}
    return [dict(common, name="b1_sweep_sw", instantiation="forces",
                 coulomb="ewald", source=src1, replaces=tpu1,
                 launches=launches["b1_sweep_sw"],
                 launches_per_step=launches["b1_sweep_sw"] / SW_STEPS,
                 max_abs_err=err_b1, switch_effect_err=eff_b1,
                 ms=ms_b1, plain_ms=plain_b1,
                 bound_ms=bound_ms, bound_by=bound_by,
                 unswitched_ms=ms_unsw, capacity=cfg.capacity,
                 registers=regs["b1_sweep_sw"]["regs"]),
            dict(common, name="b1_energy_sw", instantiation="energy",
                 coulomb="ewald", source=src1, replaces=tpu1,
                 launches=e_launches["b1_energy_sw"],
                 registers=regs["b1_energy_sw"]["regs"], **e1),
            dict(common, name="b2_sweep_sw", instantiation="forces",
                 coulomb="ewald", source=src2, replaces=tpu2,
                 launches=b2_launches["b2_sweep_sw"],
                 launches_per_step=b2_launches["b2_sweep_sw"] / SW_B2_STEPS,
                 max_abs_err=err_b2, switch_effect_err=eff_b2,
                 ms=ms_b2, plain_ms=plain_b2,
                 bound_ms=bound_ms, bound_by=bound_by,
                 capacity=cfg.capacity,
                 registers=regs["b2_sweep_sw"]["regs"]),
            dict(common, name="b2_energy_sw", instantiation="energy",
                 coulomb="ewald", source=src2, replaces=tpu2,
                 launches=b2_e["b2_energy_sw"],
                 registers=regs["b2_energy_sw"]["regs"], **e2),
            dict(common, name="b1_sweep_rf_sw", instantiation="forces",
                 coulomb="rf", source=src1, replaces=tpu1,
                 launches=rf_launches["b1_sweep_rf_sw"],
                 launches_per_step=(rf_launches["b1_sweep_rf_sw"]
                                    / SW_IL_STEPS),
                 max_abs_err=err_rf, switch_effect_err=eff_rf,
                 ms=ms_rf, plain_ms=plain_rf,
                 bound_ms=bound_rf, bound_by=bound_by_rf,
                 capacity=cfg3.capacity,
                 registers=regs["b1_sweep_rf_sw"]["regs"]),
            dict(common, name="b1_energy_rf_sw", instantiation="energy",
                 coulomb="rf", source=src1, replaces=tpu1,
                 launches=rf_e["b1_energy_rf_sw"],
                 registers=regs["b1_energy_rf_sw"]["regs"], **e3)]


def _switch_force(system, r_on):
    """Switch the LJ of `system`'s NonbondedForce from r_on."""
    nbf = next(f for f in system.getForces()
               if type(f).__name__ == "NonbondedForce")
    nbf.setUseSwitchingFunction(True)
    nbf.setSwitchingDistance(r_on)


def phase_replicas(card, settled, flat_rate):
    """16. ReplicaEnsemble at the full width of the JAX package's
    scripts/bench_replicas.py (vmap mode), on the dense and the cell-pair
    strategy (see the module docstring)."""
    import torch
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.io import builders
    from openmm_drudenose_tpu_torch.parallel import ensemble
    from openmm_drudenose_tpu_torch.units import BOLTZ, ns_per_day
    system, _ = builders.build_water_box(FLAT_MOL)
    n0 = system.getNumParticles()
    pos, vel = settled
    R = REP_REPLICAS

    def context(strategy, precision, velocities=vel):
        integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        integ.setMaxDrudeDistance(0.02)
        ctx = dt.Context(system, integ, precision=precision,
                         strategy=strategy, device="cuda")
        ctx.setPositions(pos)
        ctx.setVelocities(velocities)
        return ctx, integ

    rates = {}
    for strategy in ("auto", "cellpair"):
        t = time.time()
        tpl, integ = context(strategy, "single")
        resolved = tpl._nb.strategy
        ens = dt.ReplicaEnsemble(tpl, R, seed=7)
        ctx = ens.context
        # each replica's 300 K velocities, from numpy
        rng = np.random.default_rng(11)
        sigma = np.sqrt(BOLTZ * 300.0
                        * ctx._spec.inv_mass.double().cpu().numpy()[:n0])
        v = rng.normal(size=(R, n0, 3)) * sigma[None, :, None]
        ens.setVelocities(v)
        # count the force passes: the Context's own method, shadowed on
        # the instance, so that a Stepper made by a recompile (capacity
        # growth) takes the counting one too
        passes = [0]
        forces_fn = ctx._forces_only

        def counting(*a, **k):
            passes[0] += 1
            return forces_fn(*a, **k)

        ctx._forces_only = counting
        ctx._stepper.forces_fn = counting
        # and the capacity growths, each of which reruns a chunk
        grows = [0]
        grow_fn = ctx._grow_pair_capacity

        def counting_grow(*a, **k):
            grows[0] += 1
            return grow_fn(*a, **k)

        ctx._grow_pair_capacity = counting_grow
        dense = resolved == "dense"
        n_settle = REP_DENSE_SETTLE if dense else REP_SETTLE
        n_steps = REP_DENSE_STEPS if dense else REP_STEPS
        log(f"16 {strategy} ({resolved}): {R} replicas of {n0} atoms "
            f"({ctx._static.n_atoms}) built in {time.time() - t:.1f} s"
            + (f"; layout {ctx._cp_cfg.bands}, cell grid {ctx._cp_cfg.grid}"
               if ctx._cp_cfg is not None else "")
            + f"; PME grid {ctx._nb.pme.grid} x {ctx._nb.n_replicas}")
        # replica REP_CHECK_REPLICA against a standalone f64 Context
        ens.step(REP_CHECK_STEPS)
        one, integ1 = context(resolved, "double", v[REP_CHECK_REPLICA])
        integ1.step(REP_CHECK_STEPS)
        st = ctx._state
        exact = (st.positions.double() + st.pos_err.double()).reshape(
            R, n0, 3)[REP_CHECK_REPLICA]
        dx = float(torch.max(torch.abs(exact - one._state.positions)))
        del one, integ1
        iso = ensemble.check_isolated(ens, 0)
        log(f"16 {resolved}: replica {REP_CHECK_REPLICA} after "
            f"{REP_CHECK_STEPS} steps against a standalone f64 Context: "
            f"max |dx| {dx:.3e} nm; replica 0 moved 0.05 nm: the other "
            f"replicas' forces moved by {iso}")
        if not dx <= REP_CHECK_TOL or iso != 0.0:
            fail(f"16 {resolved}: a replica left its standalone Context or "
                 "another replica")
        ens.step(n_settle)
        torch.cuda.synchronize()
        walls = []

        def drive():
            for _ in range(REP_REPEATS):
                t0 = time.time()
                ens.step(n_steps)
                torch.cuda.synchronize()
                walls.append(time.time() - t0)

        passes[0] = grows[0] = 0
        _, launches, plain = counted(drive)
        best = min(walls)
        ms_step = best / n_steps * 1e3
        nsd = ns_per_day(n_steps / best, integ.getStepSize())
        n_total = REP_REPEATS * n_steps
        rates[resolved] = (ms_step, nsd)
        log(f"16 {resolved}: {n_settle} settling steps, {REP_REPEATS} x "
            f"{n_steps} steps: "
            + ", ".join(f"{w / n_steps * 1e3:.2f}" for w in walls)
            + f" ms/step (best {ms_step:.2f}); per replica {nsd:.4f} "
            f"ns/day, aggregate over {R} {nsd * R:.3f} ns/day on {card}; "
            f"{passes[0]} force passes in {n_total} steps ({grows[0]} "
            f"capacity growths); launches "
            f"{ {k: v for k, v in launches.items() if v} }; plain sweeps "
            f"on the card {plain}")
        # one force pass a step for all the replicas: at most one more a
        # step() call (its forces) and, after each capacity growth, the
        # rerun of a chunk (8 rebuild intervals) and one more; each pass
        # one launch of B1's band instantiation on the cell-pair
        # strategy, no kernel on the dense one
        most = (n_total + REP_REPEATS
                + grows[0] * (8 * (ctx._rebuild_interval or 0) + 1))
        path_ok = n_total <= passes[0] <= most
        if dense:
            path_ok = path_ok and not any(launches.values())
        else:
            path_ok = (path_ok and launches["b1_sweep_bands"] == passes[0]
                       and not any(v for k, v in launches.items()
                                   if k != "b1_sweep_bands"))
        if plain or not path_ok:
            fail(f"16 {resolved}: not one force pass a step for all "
                 f"replicas on the strategy's path ({passes[0]} passes, "
                 f"{n_total} to {most} allowed)")
        if dense:
            # the dense term's block on the card (forces/dense.py):
            # BLOCK_ELEMS_ENSEMBLE_CUDA elements against BLOCK_ELEMS, one
            # force pass each, in the same call
            from openmm_drudenose_tpu_torch.forces import dense as dense_mod
            big = dense_mod.BLOCK_ELEMS_ENSEMBLE_CUDA
            st = ctx._state
            one_pass = lambda: forces_fn(st.positions, st.box, st.neighbors,
                                         st.pos_err, st.rep_scale)
            block_ms = {}
            try:
                for elems in (big, dense_mod.BLOCK_ELEMS):
                    dense_mod.BLOCK_ELEMS_ENSEMBLE_CUDA = elems
                    block_ms[elems] = cuda_time_ms(one_pass, REP_BLOCK_REPS)
            finally:
                dense_mod.BLOCK_ELEMS_ENSEMBLE_CUDA = big
            log(f"16 dense: one force pass (stream ms, {REP_BLOCK_REPS} "
                f"each) with blocks of "
                + ", ".join(f"{e} elements {v:.2f}"
                            for e, v in block_ms.items())
                + f" on {card}")
        temps = ens.group_temperatures()
        ke = ens.kinetic_energies()
        p = st.positions.double() + st.pos_err.double()
        spec = ctx._spec
        drude = torch.nonzero(spec.is_pair & ~spec.is_parent)[:, 0]
        dmax = float(torch.max(torch.linalg.norm(
            p[drude] - p[spec.partner[drude]], dim=1)))
        log(f"16 {resolved}: water bath over the replicas min "
            f"{temps[:, 0].min():.3f}, mean {temps[:, 0].mean():.3f}, max "
            f"{temps[:, 0].max():.3f} K, Drude mean {temps[:, -1].mean():.3f}"
            f" K; max core-Drude distance {dmax:.6f} nm; hard-wall runaway "
            f"{ctx.hardwallRunaway}, drift warned {ctx._drift_warned}")
        lo, hi = FLAT_BANDS["replica"]
        if not (np.all(np.isfinite(temps)) and np.all(np.isfinite(ke))
                and np.all((temps[:, 0] > lo) & (temps[:, 0] < hi))
                and dmax <= 0.02 * 1.00001 and not ctx._drift_warned):
            fail(f"16 {resolved}: temperatures, the wall or a latch")
        del ens, ctx, tpl
        torch.cuda.empty_cache()
    log(f"16 aggregate ns/day over {R} replicas on {card}: ReplicaEnsemble "
        + ", ".join(f"{k} {v[1] * R:.3f} ({v[0]:.2f} ms/step)"
                    for k, v in rates.items())
        + f"; phase 10's FlatReplicaEnsemble (70 internal replicas) "
        f"{flat_rate[1] * FLAT_REPLICAS:.3f} ({flat_rate[0]:.2f} ms/step)")


def _pdb_models(path):
    """(models, atoms, 3) positions in nm of a PDB file's MODEL blocks."""
    models, cur = [], []
    for line in open(path):
        if line.startswith("ATOM"):
            cur.append([float(line[30:38]), float(line[38:46]),
                        float(line[46:54])])
        elif line.startswith("ENDMDL"):
            models.append(cur)
            cur = []
    return np.array(models) / 10.0


def phase_rest(card, bench_system, snapshot, settled):
    """17. The neighbour-list strategy, the DCD and PDB reporters, the
    native host runtime and step_breakdown (see the module docstring)."""
    import torch
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.core import topology
    from openmm_drudenose_tpu_torch.io import builders, dcd
    from openmm_drudenose_tpu_torch.utils import native, profiling

    # (a) strategy "cell" against the cell pair sweep, f64 on the card,
    # with the cell pairs' PME plan (rounded up to its cell grid) pinned
    # for both, so that the two differ in their direct-space sums alone
    system, _ = builders.build_water_box(FLAT_MOL)
    out = {}
    for strategy in ("cellpair", "cell"):
        integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        ctx = dt.Context(system, integ, precision="double",
                         strategy=strategy, device="cuda")
        ctx.setPositions(settled[0])
        s = ctx.getState(energy=True, forces=True)
        out[strategy] = (s.getPotentialEnergy(), s.getForces(), ctx)
        next(f for f in system.getForces()
             if isinstance(f, dt.NonbondedForce)).setPMEParameters(
                 ctx._nb.pme.alpha, *ctx._nb.pme.grid)
    (e_c, f_c, ctx_c), (e_p, f_p, _) = out["cell"], out["cellpair"]
    erel = abs(e_c - e_p) / abs(e_p)
    ferr = float(np.max(np.abs(f_c - f_p)) / np.max(np.abs(f_p)))
    ncfg = ctx_c._nb.cfg
    log(f"17 (a) strategy cell ({ncfg.grid} cells of capacity "
        f"{ncfg.cell_capacity}, {ncfg.max_neighbors} neighbours an atom; "
        f"PME grid {ctx_c._nb.pme.grid}) against cellpair on the settled "
        f"4k box in f64: energy "
        f"{e_c:.6f} against {e_p:.6f} kJ/mol ({erel:.3e}), max|dF|/max|F| "
        f"{ferr:.3e}")
    if not (erel <= 1e-10 and ferr <= 1e-8):
        fail("17 (a): the neighbour lists disagree with the cell pairs")
    del out, ctx_c
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision="single", strategy="cell",
                     device="cuda")
    ctx.setPositions(settled[0])
    ctx.setVelocities(settled[1])
    t = time.time()
    _, launches, plain = counted(lambda: integ.step(REST_CELL_STEPS))
    wall = time.time() - t
    temps = ctx.getState(groups=True).getGroupTemperatures()
    log(f"17 (a) {REST_CELL_STEPS} f32 steps on the lists: "
        f"{wall / REST_CELL_STEPS * 1e3:.2f} ms/step, overflow "
        f"{ctx.neighborListOverflowed}, drift warned {ctx._drift_warned}, "
        f"baths {np.round(temps, 3).tolist()} K; kernel launches "
        f"{sum(launches.values())}, plain sweeps {plain}")
    if (ctx.neighborListOverflowed or ctx._drift_warned
            or not np.all(np.isfinite(temps)) or plain):
        fail("17 (a): the f32 steps on the lists")
    del ctx, integ

    # (b) the DCD and PDB reporters through Simulation on phase 5's
    # example box
    system, pos = builders.build_nacl_water_box(492, 10, 10)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20)
    integ.setMaxDrudeDistance(0.02)
    sim = dt.Simulation(None, system, integ, device="cuda")
    sim.context.setPositions(pos)
    sim.minimizeEnergy(maxIterations=50)
    sim.context.setVelocitiesToTemperature(300.0, seed=0)
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    dcd_path = os.path.join(out_dir, "example.dcd")
    pdb_path = os.path.join(out_dir, "example.pdb")
    sim.reporters.append(dt.DCDReporter(dcd_path, REST_DCD_EVERY))
    sim.reporters.append(dt.PDBReporter(pdb_path, REST_PDB_EVERY))
    sim.step(REST_REPORT_STEPS)
    sim.reporters[0].close()
    last = sim.context.getState(positions=True)
    frames, cells, info = dcd.read_dcd(dcd_path)
    models = _pdb_models(pdb_path)
    k = REST_PDB_EVERY // REST_DCD_EVERY
    box = np.diagonal(last.getPeriodicBoxVectors())
    d_last = float(np.max(np.abs(frames[-1] - last.getPositions())))
    d_pdb = float(np.max(np.abs(models - frames[k - 1::k])))
    log(f"17 (b) {REST_REPORT_STEPS} example steps with a DCDReporter "
        f"every {REST_DCD_EVERY} and a PDBReporter every {REST_PDB_EVERY}: "
        f"{info['n_frames']} DCD frames of {info['n_atoms']} atoms, cell "
        f"{np.round(cells[-1], 4).tolist()}, {len(models)} PDB models; last "
        f"frame against the state {d_last:.2e} nm, PDB models against the "
        f"DCD frames of their steps {d_pdb:.2e} nm")
    if not (info["n_frames"] == REST_REPORT_STEPS // REST_DCD_EVERY
            and len(models) == REST_REPORT_STEPS // REST_PDB_EVERY
            and d_last <= 1e-5 and d_pdb <= 1e-4
            and np.allclose(cells[-1, :3], box, rtol=1e-6)):
        fail("17 (b): the reporters' files did not read back")
    del sim

    # (c) the native host runtime: its union-find against the Python
    # labels that core/topology.molecule_ids takes, on the same edges
    lib = native.get_lib()
    if lib is None:
        fail(f"17 (c): the native library did not load: "
             f"{native.build_error}")
    n = bench_system.getNumParticles()
    t = time.time()
    edges = topology.link_edges(bench_system)
    t_edges = time.time() - t
    t = time.time()
    ids, _ = native.molecule_ids_native(n, edges)
    t_native = time.time() - t
    t = time.time()
    _, ids_py = np.unique(topology.component_labels(n, edges),
                          return_inverse=True)
    t_py = time.time() - t
    log(f"17 (c) native library {lib} ({native.library_path()}), build "
        f"error {native.build_error}; molecule ids of the {n}-atom water: "
        f"its {len(edges)} edges in {t_edges:.4f} s, then the native "
        f"union-find {t_native:.4f} s against the Python labels' "
        f"{t_py:.4f} s (host time): equal "
        f"{bool(np.array_equal(ids, ids_py))}, {int(ids.max()) + 1} "
        f"molecules")
    if not np.array_equal(ids, ids_py):
        fail("17 (c): the native union-find disagrees with the labels")

    # (d) step_breakdown of the 100k Context
    pos, vel, cap = snapshot
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(bench_system, integ, precision="single",
                     nb_options={"capacity": cap}, device="cuda")
    ctx.setPositions(pos)
    ctx.setVelocities(vel)
    parts = profiling.step_breakdown(ctx, n=16)
    log("17 (d) step_breakdown of the 100k Context (ms, CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f" on {card}")
    if not all(np.isfinite(v) and v > 0 for v in parts.values()):
        fail("17 (d): step_breakdown")
    del ctx
    torch.cuda.empty_cache()


# phase 18: the multi-rank paths.  MR_RANKS gloo ranks time-share
# cuda:0 (NCCL refuses two ranks on one device; it runs at world size
# 1); MR_STEPS ShardedContext steps (two rebuild blocks), MR_REF_STEPS
# of them held against a single-rank f64 Context (phase 16's gate,
# MR_REF_TOL nm); flat sub-ensembles of MR_FLAT_R replicas of the 4k box
# (phase 10's settled template), one a rank, MR_FLAT_STEPS steps; the
# collectives' timeout of the ranks, and the f32 floors of phase 2
MR_RANKS, MR_STEPS, MR_REF_STEPS, MR_REF_TOL = 3, 32, 16, 1e-4
MR_FLAT_R, MR_FLAT_STEPS = 8, 16
MR_TIMEOUT_S = 300.0
MR_F32_MAX, MR_F32_RMS = 1e-4, 5e-6


def _bench_context(snap_path, cap, precision, device, gxm=1):
    """The 100k bench Context of phase 3 from its snapshot, on `device`
    (x-slabs for gxm ranks): tools/setups.py::bench_context."""
    from openmm_drudenose_tpu_torch.tools import setups
    return setups.bench_context(device, precision, capacity=cap,
                                nb_options={"grid_x_multiple": gxm},
                                snapshot=snap_path)


def _exact(ctx):
    """The positions the integrator carries, in float64 (with the float32
    compensation where the Context has one)."""
    st = ctx._state
    p = st.positions.double()
    return (p if st.pos_err is None else p + st.pos_err.double()).cpu(
    ).numpy()


def _floor(got, ref):
    import torch
    d = (got.double() - ref.double())
    scale = float(torch.max(torch.abs(ref)))
    return (float(torch.max(torch.abs(d))) / scale,
            float(torch.sqrt(torch.mean(d * d))) / scale)


def multirank_rank(snap_path, cap, tpl_pos, tpl_vel, flat_vel):
    """18 (b)-(d), (f) on each of MR_RANKS gloo ranks on cuda:0 (run by
    parallel/comm.py::launch)."""
    import torch
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.constraints.vsites import apply_vsites
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.io import builders
    from openmm_drudenose_tpu_torch.ops import sweep
    from openmm_drudenose_tpu_torch.parallel import comm, domain, sharded
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
    mesh = comm.Mesh(("atom",))
    n, rank = mesh.size("atom"), mesh.rank
    out = {}
    ctx, _ = _bench_context(snap_path, cap, "single", mesh.device, n)
    ctx._ensure_neighbors()
    nb, cfg, st = ctx._nb, ctx._cp_cfg, ctx._state
    box = torch.diagonal(st.box)
    kw = dict(excl_skip=nb.excl_skip, **nb.coulomb)
    # (d) the halo-exchange sweep against B1's whole-grid sweep
    fields = nb.fields(st.positions, box, st.neighbors)
    window = domain.stencil_window(cfg, box.double().cpu().numpy())
    halo = domain.make_sharded_pair_sweep(mesh, "atom", cfg, window,
                                          nb.alpha, ONE_4PI_EPS0, **kw)
    e_h, f_loc = halo(domain.slab_fields(fields, cfg, mesh, "atom"), box)
    f_h = comm.all_gather(mesh, "atom", f_loc).reshape(-1, 3)
    shifts = cellpair.offset_shifts(cfg, box)
    f_w = sweep.pair_forces(fields, cfg, shifts, nb.alpha, ONE_4PI_EPS0,
                            **kw)
    e_w = sweep.pair_energy(fields, cfg, shifts, nb.alpha, ONE_4PI_EPS0,
                            **kw)
    out["d"] = {"window": list(window), "f_err": _floor(f_h, f_w)[0],
                "e_rel": abs(float(e_h) - float(e_w)) / abs(float(e_w))}
    del fields, f_h, f_w
    # (c) the distributed FFT against the replicated one
    exact = ctx._exact_positions(st.positions, st.pos_err)
    posv = apply_vsites(ctx._spec, ctx._static, st.positions)
    rep = sharded.ShardedForcePass(ctx, mesh)
    dfft = sharded.ShardedForcePass(ctx, mesh, distributed_fft=True)
    e_r = float(rep._pme(nb, posv, box, exact, None, False)[0])
    e_f = float(dfft._pme(nb, posv, box, exact, None, False)[0])
    args = (st.positions, st.box, st.neighbors, st.pos_err)
    f_rep = rep.forces(*args)
    f_dfft = dfft.forces(*args)
    out["c"] = {"e_pme": e_r, "e_rel": abs(e_f - e_r) / abs(e_r),
                "f_err": _floor(f_dfft, f_rep)[0],
                "pme_grid": list(nb.pme.grid)}
    # (b) the sharded force pass against the single Context's, then the
    # steps with the counts reset just before and read just after
    f1 = ctx._forces_only(*args)
    out["b_pass"] = _floor(f_rep, f1)
    del f_rep, f_dfft, f1
    sctx = sharded.ShardedContext(ctx, mesh)
    # the capacity growths, each of which reruns a chunk of steps
    grows = [0]
    grow_fn = ctx._grow_pair_capacity

    def counting_grow(*a, **k):
        grows[0] += 1
        return grow_fn(*a, **k)

    ctx._grow_pair_capacity = counting_grow
    for k in sweep.launches:
        sweep.launches[k] = 0
    cellpair.plain_sweeps["cuda"] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["b_mem_before"] = torch.cuda.memory_allocated()
    comm.all_reduce_sum(mesh, "atom", torch.zeros(1))
    t = time.time()
    sctx.step(MR_REF_STEPS)
    out["b_at_ref"] = _exact(ctx) if rank == 0 else None
    sctx.step(MR_STEPS - MR_REF_STEPS)
    torch.cuda.synchronize()
    wall = time.time() - t
    out["b_mem_peak"] = torch.cuda.max_memory_allocated()
    out["b_launches"] = dict(sweep.launches)
    out["b_plain"] = cellpair.plain_sweeps["cuda"]
    out["b_grows"] = grows[0]
    out["b_rebuild_interval"] = ctx._rebuild_interval
    out["b_ms_step"] = wall / MR_STEPS * 1e3
    pos = ctx._state.positions
    every = comm.all_gather(mesh, "atom", pos)
    out["b_identical"] = bool(all(torch.equal(every[0], p) for p in every))
    out["b_finite"] = bool(torch.all(torch.isfinite(pos)))
    nbl = ctx._state.neighbors
    out["b_latches"] = bool(nbl.overflow) or bool(nbl.drift_exceeded) \
        or ctx.hardwallRunaway
    out["grid"] = list(cfg.grid)
    del sctx, ctx, every
    torch.cuda.empty_cache()
    # (f) flat sub-ensembles over a ("replica",) mesh, one a rank
    rmesh = comm.Mesh(("replica",))
    system, _ = builders.build_water_box(FLAT_MOL)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    tpl = dt.Context(system, integ, precision="single", device=mesh.device)
    tpl.setPositions(tpl_pos)
    tpl.setVelocities(tpl_vel)
    flat = dt.FlatReplicaEnsemble(tpl, MR_FLAT_R)
    rens = dt.ReplicaEnsemble(flat.context, n_replicas=n, mesh=rmesh,
                              seed=5)
    rens.setVelocities(flat_vel)
    for k in sweep.launches:
        sweep.launches[k] = 0
    torch.cuda.synchronize()
    comm.all_reduce_sum(rmesh, "replica", torch.zeros(1))
    t = time.time()
    rens.step(MR_FLAT_STEPS)
    torch.cuda.synchronize()
    out["f_ms_step"] = (time.time() - t) / MR_FLAT_STEPS * 1e3
    out["f_launches"] = dict(sweep.launches)
    member = rens.members[0].context._state.positions.clone()
    gathered = rens.positions()
    flat.context.setVelocities(flat_vel[rank])
    flat.step(MR_FLAT_STEPS)
    alone = flat.context._state.positions
    out["f_identical"] = bool(torch.equal(member, alone))
    out["f_gathered"] = bool(np.array_equal(
        gathered[rank], member.double().cpu().numpy()))
    out["f_layout"] = list(flat.layout)
    out["f_dx"] = float(torch.max(torch.abs(member - alone)))
    return out


def nccl_rank(snap_path, cap):
    """18 (e): NCCL at world size 1: MR_REF_STEPS ShardedContext steps
    against the single f32 Context's."""
    import torch
    from openmm_drudenose_tpu_torch.parallel import comm, sharded
    mesh = comm.Mesh(("atom",))
    one, integ = _bench_context(snap_path, cap, "single", mesh.device)
    one._ensure_forces()
    f1 = one._state.forces
    integ.step(MR_REF_STEPS)
    ctx, _ = _bench_context(snap_path, cap, "single", mesh.device)
    sctx = sharded.ShardedContext(ctx, mesh)
    f_s = ctx._state.forces
    torch.cuda.synchronize()
    t = time.time()
    sctx.step(MR_REF_STEPS)
    torch.cuda.synchronize()
    wall = time.time() - t
    return {"backend": mesh.backend, "world": mesh.size("atom"),
            "pass": _floor(f_s, f1),
            "pass_bits": bool(torch.equal(f_s, f1)),
            "dx": float(np.max(np.abs(_exact(ctx) - _exact(one)))),
            "bits": bool(torch.equal(ctx._state.positions,
                                     one._state.positions)),
            "ms_step": wall / MR_REF_STEPS * 1e3}


def phase_multirank(card, bench_args, cap, settled, regs):
    """18. The multi-rank paths: (a) B1's home-slab range on phase 3's
    fields; (b)-(d) and (f) on MR_RANKS gloo ranks on cuda:0, (e) NCCL
    at world size 1 (see the module docstring).  Returns B1's slab entry
    of the `kernels` line."""
    import torch
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.ops import sweep
    from openmm_drudenose_tpu_torch.parallel import comm
    from openmm_drudenose_tpu_torch.units import BOLTZ
    fields, cfg, shifts, alpha, scale_c = bench_args
    args = (fields, cfg, shifts, alpha, scale_c)
    nc = cfg.n_cells
    m = nc // MR_RANKS
    slabs = [(d * m, (d + 1) * m) for d in range(MR_RANKS)]
    # (a) B1's home-slab range
    f = sweep.pair_forces(*args)
    e = sweep.pair_energy(*args)
    full_bits = bool(torch.equal(sweep.pair_forces(*args, cells=(0, nc)), f)
                     and torch.equal(sweep.pair_energy(*args,
                                                       cells=(0, nc)), e))
    scale = float(torch.max(torch.abs(f)))
    total = torch.zeros_like(f)
    e_sum, errs, ident, max_abs = 0.0, [], True, 0.0
    for c in slabs:
        fk = sweep.pair_forces(*args, cells=c)
        ident = ident and bool(torch.equal(sweep.pair_forces(*args,
                                                             cells=c), fk))
        fp = sweep.pair_forces_plain(*args, cells=c)
        errs.append(float(torch.max(torch.abs(fk - fp))) / scale)
        max_abs = max(max_abs, float(torch.max(torch.abs(fk - fp))))
        total += fk
        e_sum += float(sweep.pair_energy(*args, cells=c))
        del fp
    sum_err = float(torch.max(torch.abs(total - f))) / scale
    e_rel = abs(e_sum - float(e)) / abs(float(e))
    c0 = slabs[0]
    ms = cuda_time_ms(lambda: sweep.pair_forces(*args, cells=c0), 20)
    ms_full = cuda_time_ms(lambda: sweep.pair_forces(*args), 20)
    plain_ms = cuda_time_ms(
        lambda: sweep.pair_forces_plain(*args, cells=c0), 3)
    bound_ms, bound_by, n_tests, n_cut, n_bytes = sweep_bound(
        fields, cfg, shifts, cells=c0)
    a = sweep.attributes()
    log(f"18 (a) B1 with a home-slab range on phase 3's fields ({nc} "
        f"cells, {MR_RANKS} x-slabs of {m}): each against its plain "
        f"version {', '.join(f'{x:.3e}' for x in errs)} of max|F|, two "
        f"launches bit-identical {ident}; the full range the bits of a "
        f"launch without one {full_bits}; the slabs summed against the "
        f"whole {sum_err:.3e} of max|F|, their energies {e_rel:.3e} of "
        f"|E|; one slab {ms:.4f} ms (the whole grid {ms_full:.4f} ms), "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{n_tests} pair tests, {n_cut} inside the cutoff, {n_bytes} "
        f"bytes); {a['regs']} registers (forces; the parent's 77), "
        f"{regs['b1_energy']} (energy; the parent's 53), {a['local_bytes']} "
        f"B local, on {card}")
    if not (max(errs) <= 2e-5 and ident and full_bits and sum_err <= 2e-5
            and e_rel <= 1e-6):
        fail("18 (a) B1's home-slab range")
    del total, f
    torch.cuda.empty_cache()

    # (b)-(d), (f): MR_RANKS gloo ranks time-sharing cuda:0
    snap_path = os.path.join(HERE, "data", "bench_equil_100k.npz")
    tpl_pos, tpl_vel = settled
    n0 = tpl_pos.shape[0]
    inv_m = np.array([0.0 if mm == 0 else 1.0 / mm for mm in
                      _masses(FLAT_MOL)] * MR_FLAT_R)
    rng = np.random.default_rng(18)
    flat_vel = rng.normal(size=(MR_RANKS, MR_FLAT_R * n0, 3)) * np.sqrt(
        BOLTZ * 300.0 * inv_m)[None, :, None]
    t = time.time()
    res = comm.launch(multirank_rank, MR_RANKS, "gloo", "cuda:0",
                      MR_TIMEOUT_S, args=(snap_path, cap, tpl_pos, tpl_vel,
                                          flat_vel))
    wall = time.time() - t
    r0 = res[0]
    d, c = r0["d"], r0["c"]
    log(f"18 gloo, world {MR_RANKS}, ranks time-sharing cuda:0: launched "
        f"and joined in {wall:.1f} s")
    log(f"18 (d) gloo, world {MR_RANKS}: the halo-exchange sweep (window "
        f"{d['window']}, slabs of {r0['grid'][0] // MR_RANKS} planes) "
        f"against B1's whole-grid sweep: forces {d['f_err']:.3e} of "
        f"max|F|, energy {d['e_rel']:.3e} of |E|")
    if not (all(r["d"]["f_err"] <= 2e-5 and r["d"]["e_rel"] <= 1e-6
                for r in res)):
        fail("18 (d) the halo-exchange sweep")
    log(f"18 (c) gloo, world {MR_RANKS}: distributed_fft (PME grid "
        f"{c['pme_grid']}) against the replicated FFT: PME energy "
        f"{c['e_pme']:.6f} kJ/mol, |dE|/|E| {c['e_rel']:.3e}; forces "
        f"{c['f_err']:.3e} of max|F|")
    if not all(r["c"]["e_rel"] <= 1e-5 and r["c"]["f_err"] <= 2e-5
               for r in res):
        fail("18 (c) the distributed FFT")
    bmax, brms = r0["b_pass"]
    launches = r0["b_launches"]
    used = {k: v for k, v in launches.items() if v}
    log(f"18 (b) gloo, world {MR_RANKS}: ShardedContext force pass against "
        f"the single f32 Context's: max {bmax:.3e}, rms {brms:.3e} of "
        f"max|F|; {MR_STEPS} steps at {r0['b_ms_step']:.2f} ms/step "
        f"(ranks time-sharing one card, not a scaling figure) on {card}; "
        f"rank 0's launches {used}, plain sweeps on the card "
        f"{r0['b_plain']}; capacity growths "
        f"{[r['b_grows'] for r in res]}; the ranks' positions bit-identical "
        f"{all(r['b_identical'] for r in res)}; latches "
        f"{any(r['b_latches'] for r in res)}")
    # one slab launch a step, and after each capacity growth the rerun
    # of a chunk (8 rebuild intervals) and one more force pass
    slab_ok = all(MR_STEPS <= r["b_launches"]["b1_sweep_slab"]
                  <= MR_STEPS + r["b_grows"]
                  * (8 * r["b_rebuild_interval"] + 1)
                  and r["b_launches"]["b1_sweep"] == 0 and not r["b_plain"]
                  for r in res)
    if not (bmax <= MR_F32_MAX and brms <= MR_F32_RMS and slab_ok
            and all(r["b_identical"] and r["b_finite"]
                    and not r["b_latches"] for r in res)):
        fail("18 (b) the ShardedContext: floors, the slab launches, the "
             "ranks' bits or a latch")
    log(f"18 (f) gloo, world {MR_RANKS}: ReplicaEnsemble of flat "
        f"sub-ensembles ({MR_FLAT_R} x the 4k box, layout "
        f"{r0['f_layout']}) on a ({MR_RANKS},) replica mesh: "
        f"{MR_FLAT_STEPS} steps at {r0['f_ms_step']:.2f} ms/step (ranks "
        f"time-sharing one card) on {card}; each member against its "
        f"standalone flat ensemble bit for bit "
        f"{[r['f_identical'] for r in res]} (max |dx| "
        f"{max(r['f_dx'] for r in res):.3e}), gathered rows "
        f"{[r['f_gathered'] for r in res]}; launches "
        f"{ {k: v for k, v in r0['f_launches'].items() if v} }")
    if not all(r["f_identical"] and r["f_gathered"]
               and r["f_launches"]["b1_sweep_bands"] >= MR_FLAT_STEPS
               for r in res):
        fail("18 (f) the flat sub-ensembles over the replica mesh")
    # (b) against a single-rank f64 Context after MR_REF_STEPS
    ctx64, integ64 = _bench_context(snap_path, cap, "double", "cuda")
    integ64.step(MR_REF_STEPS)
    dx = float(np.max(np.abs(r0["b_at_ref"] - _exact(ctx64))))
    del ctx64, integ64
    torch.cuda.empty_cache()
    log(f"18 (b) gloo, world {MR_RANKS}: after {MR_REF_STEPS} steps rank "
        f"0's positions against a single-rank f64 Context: max |dx| "
        f"{dx:.3e} nm")
    if not dx <= MR_REF_TOL:
        fail("18 (b) the sharded trajectory left the f64 Context")
    # (e) NCCL at world size 1
    t = time.time()
    e_res = comm.launch(nccl_rank, 1, "nccl", "cuda:0", MR_TIMEOUT_S,
                        args=(snap_path, cap))[0]
    emax, erms = e_res["pass"]
    log(f"18 (e) {e_res['backend']}, world {e_res['world']}: ShardedContext "
        f"against the single f32 Context: force pass max {emax:.3e}, rms "
        f"{erms:.3e} of max|F| (the same bits: {e_res['pass_bits']}); after "
        f"{MR_REF_STEPS} steps max |dx| {e_res['dx']:.3e} nm (the same "
        f"bits: {e_res['bits']}); {e_res['ms_step']:.2f} ms/step; "
        f"{time.time() - t:.1f} s with the launch")
    if not (emax <= MR_F32_MAX and erms <= MR_F32_RMS
            and e_res["dx"] <= MR_REF_TOL):
        fail("18 (e) NCCL at world size 1")
    mem = {"sharded": [(r["b_mem_before"], r["b_mem_peak"]) for r in res],
           "sharded_ms_step": r0["b_ms_step"]}
    return {"name": "b1_sweep_slab", "instantiation": "forces, home-slab "
            f"range (1 of {MR_RANKS} x-slabs)", "route": "cuda",
            "source": "openmm_drudenose_tpu_torch/csrc/sweep.cu",
            "replaces": "openmm_drudenose_tpu/ops/pallas_sweep.py:440",
            "launches": launches["b1_sweep_slab"],
            "launches_per_step": launches["b1_sweep_slab"] / MR_STEPS,
            "capacity": cfg.capacity, "registers": a["regs"],
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}, mem


# phase 19: the state-resident decomposition.  RES_RANKS gloo ranks
# time-share cuda:0, each owning an x-slab of molecules of the 100k box
# (phase 16's gate MR_REF_TOL nm against a single-rank f64 Context after
# RES_STEPS steps, two rebuild blocks; phase 2's floors on the force
# pass)
RES_RANKS, RES_STEPS = 3, 32


def _mib(n_bytes):
    return n_bytes / 2 ** 20


def resident_rank(snap_path, cap):
    """19 (a)-(e), (g) on one of RES_RANKS gloo ranks (see phase 19)."""
    import torch
    import torch.distributed as dist
    from openmm_drudenose_tpu_torch.constraints.vsites import apply_vsites
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.ops import sweep
    from openmm_drudenose_tpu_torch.parallel import comm, resident
    from openmm_drudenose_tpu_torch.tools import dryrun_multichip
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
    mesh = comm.Mesh(("atom",))
    n, rank = mesh.size("atom"), mesh.rank
    out = {}
    ctx, integ = _bench_context(snap_path, cap, "single", mesh.device, n)
    ctx._ensure_forces()
    st = ctx._state
    f1 = st.forces.clone()
    e1 = float(ctx._potential(st.positions, st.box, st.neighbors,
                              st.pos_err))
    torch.cuda.synchronize()
    out["mem_context"] = torch.cuda.max_memory_allocated()
    t = time.time()
    rctx = resident.ResidentContext(ctx, mesh)
    rctx._rebuild()
    out["setup_s"] = time.time() - t
    rs = rctx._state
    lay = rctx._layout
    out["layout"] = {"Rc": lay.Rc, "Ec": lay.Ec, "K": lay.K,
                     "n_loc": lay.n_loc, "loc_x": lay.loc_x,
                     "block": list(rctx._bcfg.grid),
                     "offsets": rctx._bcfg.n_offsets,
                     "grid_offsets": ctx._cp_cfg.n_offsets,
                     "n_mol": int(rctx.state["n_mol"])}
    # (a) the resident force pass against the single Context's
    f = rctx._forces_only(rs.positions, rs.box, None, rs.pos_err)
    fg = torch.as_tensor(rctx._gathered(f.double()), device=mesh.device)
    out["a"] = _floor(fg, f1)
    e = float(rctx._potential(rs.positions, rs.box, None, rs.pos_err))
    out["a_e"] = (e, e1)
    del fg, f
    # B1 on the resident block against its plain version; timed on rank
    # 0 alone while the other ranks wait
    box_d = torch.diagonal(rs.box)
    block, bcfg, shifts, kw = rctx.block_inputs(rs.positions, rs.pos_err,
                                                box_d)
    args = (block, bcfg, shifts, ctx._nb.alpha, ONE_4PI_EPS0)
    f_k = sweep.pair_forces(*args, resident=True, **kw)
    f_k2 = sweep.pair_forces(*args, resident=True, **kw)
    f_p = sweep.pair_forces_plain(*args, **kw)
    scale = float(torch.max(torch.abs(f_p)))
    out["kernel"] = {"err": float(torch.max(torch.abs(f_k - f_p))) / scale,
                     "max_abs": float(torch.max(torch.abs(f_k - f_p))),
                     "bits": bool(torch.equal(f_k, f_k2))}
    del f_k, f_k2, f_p
    dist.barrier()
    if rank == 0:
        out["kernel"]["ms"] = cuda_time_ms(
            lambda: sweep.pair_forces(*args, resident=True, **kw), 20)
        out["kernel"]["plain_ms"] = cuda_time_ms(
            lambda: sweep.pair_forces_plain(*args, **kw), 3)
        # the function's bound: the grid's half stencil over the slab's
        # home cells (phase 18's slab row) at the same positions, from
        # the single Context's fields; the resident block's own stencil
        # (clamped binning's w + 2 reach, untrimmed) tests more pairs, a
        # cost of the scheme, logged beside it
        cfg, st = ctx._cp_cfg, ctx._state
        box_t = ctx._box_arg(st.box)
        fields = ctx._nb.fields(
            apply_vsites(ctx._spec, ctx._static, st.positions), box_t,
            st.neighbors, ctx._exact_positions(st.positions, st.pos_err))
        (out["kernel"]["bound_ms"], out["kernel"]["bound_by"], n_tests,
         n_cut, n_bytes) = sweep_bound(fields, cfg,
                                       cellpair.offset_shifts(cfg, box_t),
                                       cells=(0, rctx._halo.n_loc))
        out["kernel"]["work"] = (n_tests, n_cut, n_bytes)
        s_ms, s_by, s_tests, s_cut, _ = sweep_bound(block, bcfg, shifts,
                                                    cells=kw["cells"])
        out["kernel"]["scheme"] = (s_ms, s_by, s_tests, s_cut)
        del fields
        out["kernel"]["regs"] = sweep.attributes()["regs"]
    dist.barrier()
    # the set-up Context is freed: the rank holds its molecules alone
    del block, args, ctx, integ, st
    gc.collect()
    torch.cuda.empty_cache()
    # (b), (c), (e): the steps, the counts set to 0 just before them
    rctx._loc = None
    for k in sweep.launches:
        sweep.launches[k] = 0
    cellpair.plain_sweeps["cuda"] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["mem_before"] = torch.cuda.memory_allocated()
    comm.all_reduce_sum(mesh, "atom", torch.zeros(1))
    t = time.time()
    rctx.step(RES_STEPS)
    torch.cuda.synchronize()
    out["ms_step"] = (time.time() - t) / RES_STEPS * 1e3
    out["mem_peak"] = torch.cuda.max_memory_allocated()
    out["launches"] = dict(sweep.launches)
    out["plain"] = cellpair.plain_sweeps["cuda"]
    at_ref = rctx.positions(compensated=True)      # a gather: every rank
    out["at_ref"] = at_ref if rank == 0 else None
    stt = rctx.state
    out["replicated"] = np.concatenate([
        stt["eta"].numpy().reshape(-1), stt["box"].double().cpu().numpy()
        .reshape(-1)])
    out["n_mol"] = int(stt["n_mol"])
    out["latches"] = [k for k in ("mig_overflow", "cs_overflow",
                                  "stencil", "stray", "excl_span", "drift")
                      if bool(stt[k])]
    # (d) a forced migration: every position moved by box_x / 4 (3.75
    # of a slab's 5 planes: three quarters of each rank's molecules
    # move, so the emigrant buffers take Rc)
    rctx._layout = dataclasses.replace(rctx._layout, Ec=rctx._layout.Rc)
    owned = set(rctx._mol_base[:out["n_mol"]].tolist())
    p0 = rctx._gathered(rctx._state.positions.double())
    v0 = rctx._gathered(rctx._state.velocities.double())
    shift = torch.zeros(3, dtype=rctx._state.positions.dtype,
                        device=mesh.device)
    shift[0] = rctx._state.box[0, 0] / 4
    rctx._state = rctx._state.replace(
        positions=rctx._state.positions + shift)
    rctx._rebuild()
    p1 = rctx._gathered(rctx._state.positions.double())
    want = (torch.as_tensor(p0, dtype=torch.float32)
            + shift.cpu()).double().numpy()
    out["d"] = {"bits": bool(np.array_equal(p1, want)),
                "vel_bits": bool(np.array_equal(
                    rctx._gathered(rctx._state.velocities.double()), v0)),
                "moved": len(set(rctx._mol_base[:int(rctx.state[
                    "n_mol"])].tolist()) - owned),
                "n_mol": int(rctx.state["n_mol"]),
                "overflow": bool(rctx.state["mig_overflow"])}
    del rctx
    torch.cuda.empty_cache()
    # (g) the dryrun's part 1b on the same ranks
    t = time.time()
    out["g"] = dryrun_multichip._part1b(mesh, n)
    out["g"]["seconds"] = time.time() - t
    return out


def _profiled(fn, n_steps):
    """(host ms, device-busy ms, CUDA kernel launches) a step of fn(),
    which runs n_steps steps, under torch.profiler; and the five host
    operators and the six kernels of most self time (ms a step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.time() - t) / n_steps * 1e3
    dev = launches = 0
    host, kern = [], []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev += e.self_device_time_total
            launches += e.count
            kern.append((e.self_device_time_total, e.key[:60], e.count))
        else:
            host.append((e.self_cpu_time_total, e.key, e.count))
    top = [(k, round(us / n_steps / 1e3, 3), c // n_steps)
           for us, k, c in sorted(host, reverse=True)[:5]
           + sorted(kern, reverse=True)[:6]]
    return wall, dev / n_steps / 1e3, launches // n_steps, top


def resident_nccl_rank(snap_path, cap, profile=False):
    """19 (f): NCCL at world size 1: the resident force pass against the
    single f32 Context's, then RES_STEPS steps of each; with `profile`
    16 more of each (one rebuild block) under torch.profiler."""
    import torch
    from openmm_drudenose_tpu_torch.parallel import comm, resident
    mesh = comm.Mesh(("atom",))
    ctx, integ = _bench_context(snap_path, cap, "single", mesh.device)
    ctx._ensure_forces()
    f1 = ctx._state.forces.clone()
    rctx = resident.ResidentContext(ctx, mesh)
    rctx._rebuild()
    rs = rctx._state
    f = rctx._forces_only(rs.positions, rs.box, None, rs.pos_err)
    fg = torch.as_tensor(rctx._gathered(f.double()), device=mesh.device)
    rctx._loc = None
    torch.cuda.synchronize()
    t = time.time()
    rctx.step(RES_STEPS)
    torch.cuda.synchronize()
    ms_step = (time.time() - t) / RES_STEPS * 1e3
    integ.step(16)
    torch.cuda.synchronize()
    t = time.time()
    integ.step(RES_STEPS)
    torch.cuda.synchronize()
    single_ms = (time.time() - t) / RES_STEPS * 1e3
    prof = {} if not profile else {
        "resident": _profiled(lambda: rctx.step(16), 16),
        "single": _profiled(lambda: integ.step(16), 16)}
    return {"backend": mesh.backend, "world": mesh.size("atom"),
            "pass": _floor(fg, f1), "ms_step": ms_step,
            "single_ms_step": single_ms, "prof": prof,
            "finite": bool(np.all(np.isfinite(rctx.positions())))}


def phase_resident(card, cap, mem18=None, profile=False):
    """19. The state-resident decomposition on RES_RANKS gloo ranks on
    cuda:0 and NCCL at world size 1 (see the module docstring).  mem18:
    phase 18's ShardedContext ranks' memory and ms/step, printed beside.
    profile: (f) also profiles 16 steps of the resident and the single
    Context at world 1 (torch.profiler: host and card time, launches,
    the heaviest operators and kernels; ~30 s more, so off in the whole
    run).  Returns B1's resident-block entry of the `kernels` line."""
    import torch
    from openmm_drudenose_tpu_torch.parallel import comm
    snap_path = os.path.join(HERE, "data", "bench_equil_100k.npz")
    t = time.time()
    res = comm.launch(resident_rank, RES_RANKS, "gloo", "cuda:0",
                      MR_TIMEOUT_S, args=(snap_path, cap))
    wall = time.time() - t
    r0 = res[0]
    lay, k = r0["layout"], r0["kernel"]
    log(f"19 gloo, world {RES_RANKS}, ranks time-sharing cuda:0: launched "
        f"and joined in {wall:.1f} s; rank 0: Rc {lay['Rc']} molecule "
        f"slots ({lay['n_mol']} owned), Ec {lay['Ec']}, {lay['n_loc']} "
        f"local atom rows, slabs of {lay['loc_x']} planes, the block "
        f"{tuple(lay['block'])} with {lay['offsets']} stencil offsets "
        f"(the grid's {lay['grid_offsets']}); set-up "
        f"{max(r['setup_s'] for r in res):.1f} s")
    amax, arms = max(r["a"][0] for r in res), max(r["a"][1] for r in res)
    e, e1 = r0["a_e"]
    log(f"19 (a) the resident force pass against the single f32 Context's:"
        f" max {amax:.3e}, rms {arms:.3e} of max|F|; energy {e:.6f} "
        f"against {e1:.6f} kJ/mol ({abs(e - e1) / abs(e1):.3e} of |E|)")
    sch = k["scheme"]
    log(f"19 (a) B1 on the resident block against its plain version: "
        f"{max(r['kernel']['err'] for r in res):.3e} of max|F| (max |dF| "
        f"{k['max_abs']:.3e}), two launches bit-identical "
        f"{all(r['kernel']['bits'] for r in res)}; rank 0's block "
        f"{k['ms']:.4f} ms alone (plain {k['plain_ms']:.3f} ms, bound "
        f"{k['bound_ms']:.4f} ms ({k['bound_by']}: the grid's "
        f"{lay['grid_offsets']}-offset stencil over the slab's home cells,"
        f" {k['work'][0]} pair tests, {k['work'][1]} inside the cutoff, "
        f"{k['work'][2]} bytes); the block's own {lay['offsets']}-offset "
        f"stencil {sch[2]} pair tests ({sch[2] / k['work'][0]:.2f}x), "
        f"{sch[3]} inside the cutoff, its bound {sch[0]:.4f} ms "
        f"({sch[1]})), {k['regs']} registers, on {card}")
    if not (amax <= MR_F32_MAX and arms <= MR_F32_RMS
            and all(r["kernel"]["err"] <= 2e-5 and r["kernel"]["bits"]
                    for r in res)):
        fail("19 (a) the resident force pass or B1 on the resident block")
    # (b) against a single-rank f64 Context after RES_STEPS; its energy
    # at the start beside (a)'s two f32 ones
    ctx64, integ64 = _bench_context(snap_path, cap, "double", "cuda")
    ctx64._ensure_forces()
    s64 = ctx64._state
    e64 = float(ctx64._potential(s64.positions, s64.box, s64.neighbors,
                                 s64.pos_err))
    log(f"19 (a) the energies against the single f64 Context's "
        f"{e64:.6f} kJ/mol: resident {abs(e - e64) / abs(e64):.3e}, single "
        f"f32 {abs(e1 - e64) / abs(e64):.3e} of |E|")
    integ64.step(RES_STEPS)
    dx = float(np.max(np.abs(r0["at_ref"] - _exact(ctx64))))
    del ctx64, integ64
    torch.cuda.empty_cache()
    log(f"19 (b) {RES_STEPS} resident steps at {r0['ms_step']:.2f} ms/step "
        f"(ranks time-sharing one card, not a scaling figure) on {card}: "
        f"rank 0's gathered positions against a single-rank f64 Context: "
        f"max |dx| {dx:.3e} nm; latches "
        f"{sorted(set(sum((r['latches'] for r in res), [])))}")
    identical = all(np.array_equal(r["replicated"], r0["replicated"])
                    for r in res)
    total = sum(r["n_mol"] for r in res)
    log(f"19 (c) the ranks' eta and box bit-identical {identical}; "
        f"molecules {[r['n_mol'] for r in res]}, {total} in all")
    d = [r["d"] for r in res]
    log(f"19 (d) a forced migration (positions + box_x / 4, a rebuild): "
        f"molecules moved in {[x['moved'] for x in d]}, now "
        f"{[x['n_mol'] for x in d]}; the gathered positions p0 + shift bit"
        f" for bit {all(x['bits'] for x in d)}, velocities "
        f"{all(x['vel_bits'] for x in d)}")
    res_launch = [r["launches"]["b1_sweep_res"] for r in res]
    others = [sum(v for kk, v in r["launches"].items()
                  if kk != "b1_sweep_res") for r in res]
    log(f"19 (e) each rank's resident-block launches in the {RES_STEPS} "
        f"steps {res_launch}, other sweep launches {others}, plain sweeps "
        f"on the card {[r['plain'] for r in res]}")
    mem = ", ".join(f"rank {i}: {_mib(r['mem_before']):.1f} MiB held, "
                    f"peak {_mib(r['mem_peak']):.1f} MiB"
                    for i, r in enumerate(res))
    line = (f"19 memory in the steps (torch.cuda.max_memory_allocated, each "
            f"rank's own, its set-up Context freed): resident {mem}; "
            f"the single f32 Context's force pass "
            f"{_mib(r0['mem_context']):.1f} MiB")
    if mem18:
        line += "; phase 18's ShardedContext ranks " + ", ".join(
            f"{_mib(a):.1f} held, peak {_mib(b):.1f} MiB"
            for a, b in mem18["sharded"]) + (
            f" at {mem18['sharded_ms_step']:.2f} ms/step")
    log(line + f", on {card}")
    g = r0["g"]
    log(f"19 (g) dryrun part 1b on {RES_RANKS} ranks: {g['atoms']} atoms, "
        f"{g['planes']} x-planes, {g['molecules']} molecules owned, finite "
        f"{g['finite']}, ranks' chains and box bit-identical "
        f"{g['ranks_identical']}; {g['seconds']:.1f} s")
    if not (dx <= MR_REF_TOL and identical and total == 20000
            and sum(x["n_mol"] for x in d) == 20000
            and not any(r["latches"] for r in res)):
        fail("19 (b)/(c) the resident trajectory, the ranks' bits, the "
             "molecule count or a latch")
    if not all(x["bits"] and x["vel_bits"] and not x["overflow"]
               for x in d) or not any(x["moved"] for x in d):
        fail("19 (d) the forced migration did not relabel bit for bit")
    if not (all(n_l == RES_STEPS for n_l in res_launch)
            and not any(others) and not any(r["plain"] for r in res)):
        fail("19 (e) the resident-block launches")
    if not (g["finite"] and g["ranks_identical"] and g["molecules"] == 216):
        fail("19 (g) the dryrun's part 1b")
    # (f) NCCL at world size 1
    t = time.time()
    f_res = comm.launch(resident_nccl_rank, 1, "nccl", "cuda:0",
                        MR_TIMEOUT_S, args=(snap_path, cap, profile))[0]
    fmax, frms = f_res["pass"]
    log(f"19 (f) {f_res['backend']}, world {f_res['world']}: the resident "
        f"force pass against the single f32 Context's: max {fmax:.3e}, rms "
        f"{frms:.3e} of max|F|; {RES_STEPS} steps at "
        f"{f_res['ms_step']:.2f} ms/step (the single Context's on that "
        f"rank {f_res['single_ms_step']:.2f}); {time.time() - t:.1f} s "
        f"with the launch")
    for name, (wall, dev, n_k, top) in f_res["prof"].items():
        log(f"19 (f) {name} at world 1, 16 steps under torch.profiler: "
            f"{wall:.2f} ms/step host, the card busy {dev:.2f} ms/step, "
            f"{n_k} kernel launches a step; most self time, host then "
            f"card (ms, calls a step): {top}")
    if not (fmax <= MR_F32_MAX and frms <= MR_F32_RMS and f_res["finite"]):
        fail("19 (f) NCCL at world size 1")
    return {"name": "b1_sweep_res", "instantiation": "forces, resident "
            f"block (slab + w + 2 halo planes), 1 of {RES_RANKS} ranks at "
            "100k", "route": "cuda",
            "source": "openmm_drudenose_tpu_torch/csrc/sweep.cu",
            "replaces": "openmm_drudenose_tpu/ops/pallas_sweep.py:440",
            "launches": res_launch[0],
            "launches_per_step": res_launch[0] / RES_STEPS,
            "capacity": cap, "registers": k["regs"],
            "max_abs_err": k["max_abs"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "scheme_bound_ms": sch[0],
            "library_ms": None}


# phase 20: the long-run tools (tools/measure_drift.py, validate_npt.py,
# validate_flatnpt.py) at full width.  The drift run's samples every
# PHYS_SAMPLE_STEPS steps, PHYS_SAMPLES of them uninterrupted against
# half of them, a checkpoint, a fresh Context and the other half; the
# 500-water NPT loop one row of PHYS_NPT_STEPS steps, then B1 against
# its plain versions on that Context's grid of explicit images (phase
# 2's limits), and the 8 x 500 flat NPT loop PHYS_FLAT_PS ps (20 chunks
# of 16 steps), each in a child process beside (a) and (b) (their host
# work is the step's bottleneck, so the card takes the three)
PHYS_SAMPLE_STEPS, PHYS_SAMPLES = 128, 2
PHYS_RESUME_FIELDS = ("positions", "pos_err", "velocities", "group_ke")
PHYS_NPT_STEPS, PHYS_FLAT_PS = 256, 0.32
PHYS_CHILD_TIMEOUT_S = 600
# the JAX drift run's step counter and series position in
# data/drift_100k_state.npz (its .ps marker): it began 5,000 steps into
# the bench snapshot's trajectory
PHYS_JAX_STEP, PHYS_JAX_PS = 331000, 326


def physics_child(kind):
    """20 (b)'s resumed half, (c) or (d) in its own process: the tool's
    loop with the counts set to 0 just before and read just after; one
    JSON line."""
    sys.path.insert(0, HERE)
    from openmm_drudenose_tpu_torch.ops import sweep
    from openmm_drudenose_tpu_torch.tools import measure_drift as md
    sweep.build()
    out_dir = os.path.join(HERE, "build", "chip_smoke", "phase20", kind)
    if kind == "resume":
        # the parent writes the copy of its checkpoint, then this
        t_wait = time.time()
        while not os.path.exists(os.path.join(out_dir, "args.json")):
            if time.time() - t_wait > PHYS_CHILD_TIMEOUT_S:
                fail("20 (b) no checkpoint to resume from")
            time.sleep(0.2)
        with open(os.path.join(out_dir, "args.json")) as f:
            split = md.parse_args(json.load(f))
        ctx, integ, rows, first = md.open_run(split, "cuda",
                                              log=lambda m: None)
        t = time.time()
        rows, launches, plain = counted(lambda: md.session(
            ctx, integ, rows, first, split, log=lambda m: None))
        st = ctx._state
        np.savez(os.path.join(out_dir, "state.npz"), **{
            k: getattr(st, k).cpu().numpy() for k in PHYS_RESUME_FIELDS})
        res = {"rows": rows.tolist()}
        ctx_l = ctx
    elif kind == "npt":
        from openmm_drudenose_tpu_torch.tools import validate_npt as vn
        args = vn.parse_args([
            "--equil-ps", "0", "--sample-ps", "1",
            "--csv", os.path.join(out_dir, "npt.csv"),
            "--state", os.path.join(out_dir, "npt.npz"),
            "--commit", "chip_smoke"])
        ctx, integ, n_mol, mass, rows = vn.open_run(args, "cuda",
                                                     log=lambda m: None)
        cfg = ctx._cp_cfg
        t = time.time()
        rows, launches, plain = counted(lambda: vn.session(
            ctx, integ, n_mol, mass, rows, args, steps=PHYS_NPT_STEPS,
            log=lambda m: None))
        res = {"rows": rows.tolist(), "grid": list(cfg.grid),
               "offsets": cfg.n_offsets, "regular": cfg.regular,
               "route": sweep.route(cfg)[0], "baro_scale":
               float(ctx._state.baro_scale)}
        ctx_l = ctx
        res["seconds"] = time.time() - t
        physics_b1_parity(ctx, md.card_line())
    else:
        from openmm_drudenose_tpu_torch.tools import validate_flatnpt as vf
        ens, _ = vf.build(8, 500, "cuda")
        t = time.time()
        dens, launches, plain = counted(lambda: vf.run(
            ens, 0, PHYS_FLAT_PS, log=lambda m: None))
        res = {"densities": dens.tolist(), **vf.layout(ens),
               "scales": ens.context._state.rep_scale.tolist()}
        ctx_l = ens.context
    res.setdefault("seconds", time.time() - t)
    res.update(launches={k: v for k, v in launches.items() if v},
               plain=plain, latches=md.latches(ctx_l))
    print("PHYSICS_CHILD " + json.dumps(res), flush=True)


def physics_b1_parity(ctx, card):
    """20 (c): B1's force and energy instantiations on the 500-water
    Context's fields, its 4^3 grid of explicit images (offsets o and
    o - 4 reaching one cell through two images), against their plain
    versions in f32 and f64 at phase 2's limits (a sweep that drops or
    doubles one image misses them by over ten times: tests/
    test_torch_small_grid.py).  Not counted: the loop's counts were read
    before."""
    import torch
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.ops import sweep
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
    nb, cfg, st = ctx._nb, ctx._cp_cfg, ctx._state
    if cfg.regular or sweep.route(cfg)[0] != "b1":
        fail(f"20 (c) the 500-water grid {cfg.grid} is not the non-regular "
             f"plan routed to B1")
    box_diag = torch.diagonal(st.box)
    fields = nb.fields(st.positions, box_diag, st.neighbors)
    shifts = cellpair.offset_shifts(cfg, box_diag)
    args = (fields, cfg, shifts, nb.alpha, ONE_4PI_EPS0)
    kw = dict(nb.coulomb, excl_skip=nb.excl_skip)
    tag = f"B1 on the {cfg.grid} grid of explicit images"
    kernel_parity("20 (c)", tag, sweep, args, kw)
    energy_check(f"20 (c) {tag}", sweep, fields, cfg, shifts, nb.alpha,
                 card, nb.coulomb, nb.excl_skip)


def _physics_child(kind):
    """Start physics_child(kind) in a process of its own."""
    return subprocess.Popen(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {HERE!r}); "
         f"import chip_smoke; chip_smoke.physics_child({kind!r})"],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _child_result(kind, proc):
    try:
        out, _ = proc.communicate(timeout=PHYS_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"20 the {kind} child took over {PHYS_CHILD_TIMEOUT_S} s")
    lines = [ln for ln in out.splitlines()
             if ln.startswith("PHYSICS_CHILD ")]
    for ln in out.splitlines():
        if ln.startswith("[chip_smoke"):
            log(f"({kind} child) {ln.split('] ', 1)[-1]}")
    if proc.returncode != 0 or not lines:
        fail(f"20 the {kind} child failed (rc {proc.returncode}): "
             f"{out[-3000:]}")
    return json.loads(lines[-1][len("PHYSICS_CHILD "):])


def phase_physics(card):
    """20: (a) the JAX drift checkpoint in the bench Context, its force
    pass against f64; (b) the drift tool's loop, uninterrupted against
    checkpointed and resumed in a fresh Context, bit for bit; (c), (d)
    the NPT tools' loops (children started first, read last; (b)'s
    resumed half in a child that waits for its checkpoint)."""
    import shutil
    from openmm_drudenose_tpu_torch import convert
    from openmm_drudenose_tpu_torch.tools import measure_drift as md
    from openmm_drudenose_tpu_torch.tools import setups
    out_dir = os.path.join(HERE, "build", "chip_smoke", "phase20")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    children = {kind: _physics_child(kind)
                for kind in ("resume", "npt", "flat")}
    try:
        physics_checkpoint(convert, md, setups)
        physics_resume(out_dir, md, children["resume"])
        res = {kind: _child_result(kind, children[kind])
               for kind in ("npt", "flat")}
    finally:
        for p in children.values():
            if p.poll() is None:
                p.kill()
                p.communicate()

    # (c) the 500-water NPT loop
    r = res["npt"]
    rho, u = r["rows"][-1][1], r["rows"][-1][2]
    log(f"20 (c) validate_npt's loop, 500 waters, {PHYS_NPT_STEPS} steps: "
        f"grid {r['grid']} ({r['offsets']} offsets, regular "
        f"{r['regular']}: the half stencil of explicit images), route "
        f"{r['route']}; rho "
        f"{rho:.4f} g/mL, U {u:.3f} kJ/mol a molecule, bath temperatures "
        f"{np.round(r['rows'][-1][3:6], 3).tolist()} K; launches "
        f"{r['launches']}, plain sweeps {r['plain']}; latches "
        f"{r['latches']}; {r['seconds']:.1f} s")
    n_att = r["launches"].get("b1_energy", 0) // 2
    if not (np.isfinite(rho) and np.isfinite(u) and 0.9 < rho < 1.1):
        fail(f"20 (c) density {rho} or U {u} not finite and plausible")
    if r["route"] != "b1" or r["launches"].get("b1_sweep", 0) \
            < PHYS_NPT_STEPS or r["plain"]:
        fail("20 (c) the NPT loop did not run through its routed kernel")
    if n_att < 1 or not r["baro_scale"] > 0:
        fail("20 (c) the barostat was not attempted")
    # (d) the 8 x 500 flat NPT loop
    r = res["flat"]
    dens = np.asarray(r["densities"])
    log(f"20 (d) validate_flatnpt's loop, {r['replicas']} x 500 waters, "
        f"{PHYS_FLAT_PS} ps: layout {r['layout']} ({r['internal']} "
        f"internal replicas, {r['pad']} pad), grid {r['grid']}; densities "
        f"at the end {np.round(dens[-1], 4).tolist()} g/mL, scales "
        f"{np.round(r['scales'], 4).tolist()}; launches {r['launches']}, "
        f"plain sweeps {r['plain']}; latches {r['latches']}; "
        f"{r['seconds']:.1f} s")
    if not (dens.shape == (20, r["replicas"]) and np.all(np.isfinite(dens))
            and np.all((0.9 < dens) & (dens < 1.1))):
        fail("20 (d) flat-ensemble densities not finite and plausible")
    if r["launches"].get("b1_sweep_scaled", 0) < round(PHYS_FLAT_PS * 1000) \
            or r["launches"].get("b1_energy_scaled", 0) < 2 or r["plain"]:
        fail("20 (d) the flat NPT loop did not run through B1's scaled "
             "instantiations with barostat attempts")


def physics_checkpoint(convert, md, setups):
    """20 (a): the JAX checkpoint in the bench Context, against f64."""
    import torch
    ctx, _ = setups.bench_context("cuda")
    ctx64, _ = setups.bench_context("cuda", precision="double")
    for c in (ctx, ctx64):
        convert.load_jax_checkpoint(md.JAX_STATE, c)
    with open(md.JAX_STATE + ".ps") as f:
        at_ps = int(f.read().strip())
    jax_rows = md.read_csv(md.JAX_CSV)
    temps = md.temperatures(ctx)
    st = ctx._state
    log(f"20 (a) {md.JAX_STATE} in the bench Context: step {st.step}, "
        f"time {st.time:.4f} ps (the JAX run's float32 clock), the series "
        f"at {at_ps} ps; bath temperatures {np.round(temps, 6).tolist()} K "
        f"against the JAX CSV's {np.round(jax_rows[-1, 1:], 6).tolist()}")
    if st.step != PHYS_JAX_STEP or at_ps != PHYS_JAX_PS \
            or int(jax_rows[-1, 0]) != at_ps:
        fail("20 (a) the JAX checkpoint is not at its recorded step and ps")
    if not np.allclose(temps, jax_rows[-1, 1:], rtol=0, atol=1e-4):
        fail("20 (a) the loaded group KE does not read the JAX series' "
             "last temperatures")
    jax_forces = ctx._state.forces.clone()
    for c in (ctx, ctx64):
        c._forces_valid = False
    ferr, ferr_all, frms, n_flip, fs, _ = force_pass_floor(ctx, ctx64)
    jerr, jrms = f32_floor(jax_forces, ctx64._state.forces)
    log(f"20 (a) force pass f32 vs f64 at the JAX state: max {ferr:.3e} "
        f"({ferr_all:.3e} with the atoms of {n_flip} cutoff-flipped pairs),"
        f" rms {frms:.3e} (max|F| {fs:.1f}); the JAX run's cached float32 "
        f"forces vs the port's f64: max {jerr:.3e}, rms {jrms:.3e}")
    if not (ferr <= 1e-4 and frms <= 5e-6):
        fail("20 (a) the f32 force pass at the JAX state misses the f32 "
             "floor against f64")
    del ctx, ctx64, jax_forces
    gc.collect()
    torch.cuda.empty_cache()


def physics_resume(out_dir, md, child):
    """20 (b): the drift tool's loop from the JAX state (--snapshot),
    PHYS_SAMPLES samples in one Context, checkpointed as a session ends
    half way; the copy resumed in a fresh Context by `child` (a process
    of its own, started before and waiting for the copy) beside this
    one's second half."""
    import shutil
    import torch
    argv = ["--snapshot", "--ns", str(PHYS_SAMPLES / 1000),
            "--sample-steps", str(PHYS_SAMPLE_STEPS),
            "--ckpt-every", str(PHYS_SAMPLES), "--commit", "chip_smoke"]
    half = PHYS_SAMPLES // 2
    quiet = lambda m: None  # noqa: E731
    whole = md.parse_args(argv + [
        "--csv", os.path.join(out_dir, "whole.csv"),
        "--state", os.path.join(out_dir, "whole.npz"),
        "--max-new-ps", str(half)])
    t = time.time()
    ctx, integ, rows, first = md.open_run(whole, "cuda", log=quiet)
    rows, l1, p1 = counted(lambda: md.session(ctx, integ, rows, first,
                                              whole, log=quiet))
    res_dir = os.path.join(out_dir, "resume")
    os.makedirs(res_dir, exist_ok=True)
    split = argv + ["--csv", os.path.join(res_dir, "split.csv"),
                    "--state", os.path.join(res_dir, "split.npz")]
    for src, dst in ((whole.csv, split[-3]), (whole.state, split[-1]),
                     (whole.state + ".ps", split[-1] + ".ps")):
        shutil.copyfile(src, dst)
    with open(os.path.join(res_dir, "args.json.tmp"), "w") as f:
        json.dump(split, f)
    os.replace(os.path.join(res_dir, "args.json.tmp"),
               os.path.join(res_dir, "args.json"))
    whole.max_new_ps = None
    rows, l2, p2 = counted(lambda: md.session(ctx, integ, rows, first,
                                              whole, log=quiet))
    ms_step = ((time.time() - t) / (PHYS_SAMPLES * PHYS_SAMPLE_STEPS)
               * 1e3)
    r = _child_result("resume", child)
    rows2 = np.asarray(r["rows"])
    st = ctx._state
    with np.load(os.path.join(res_dir, "state.npz")) as z:
        got = {k: z[k] for k in PHYS_RESUME_FIELDS}
    dx = float(np.max(np.abs(st.positions.cpu().numpy()
                             - got["positions"])))
    same = all(np.array_equal(getattr(st, k).cpu().numpy(), got[k])
               for k in PHYS_RESUME_FIELDS)
    with open(whole.csv) as f1, open(split[-3]) as f2:
        csv_same = f1.read() == f2.read()
    launches = {k: l1[k] + l2[k] for k in l1 if l1[k] + l2[k]}
    log(f"20 (b) the drift loop, {PHYS_SAMPLES} x {PHYS_SAMPLE_STEPS} "
        f"steps from the JAX state ({ms_step:.2f} ms/step with the "
        f"samples, beside (c) and (d)): samples "
        f"{[int(x) for x in rows[:, 0]]}, last temperatures "
        f"{np.round(rows[-1, 1:], 4).tolist()} K; resumed at sample "
        f"{int(rows2[half - 1, 0])} in a fresh Context in another process: "
        f"max |dx| {dx:.3e} nm, positions, compensation, velocities and "
        f"group KE bit for bit {same}, CSV files equal {csv_same}; "
        f"launches {launches} and, resumed, {r['launches']}; plain "
        f"sweeps {p1 + p2 + r['plain']}")
    n = PHYS_SAMPLES * PHYS_SAMPLE_STEPS
    if not (same and dx == 0.0 and csv_same
            and np.array_equal(rows2, rows)):
        fail("20 (b) the resumed drift run is not the uninterrupted one "
             "bit for bit")
    if launches.get("b1_sweep", 0) < n \
            or r["launches"].get("b1_sweep", 0) < n // 2 \
            or p1 + p2 + r["plain"]:
        fail("20 (b) the drift loop did not run through B1 alone")
    if any(r["latches"].values()):
        fail(f"20 (b) a latch is set in the resumed run: {r['latches']}")
    check_after_steps(ctx, "20 (b)")
    del ctx
    gc.collect()
    torch.cuda.empty_cache()


def _masses(n_molecules):
    from openmm_drudenose_tpu_torch.io import builders
    system, _ = builders.build_water_box(n_molecules)
    return [system.getParticleMass(i)
            for i in range(system.getNumParticles())]


def main():
    # ---- 0. device --------------------------------------------------------
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi gave no answer"
    print(card, flush=True)
    log(f"0 device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_seconds = {"0 device": phase_mark()}

    sys.path.insert(0, HERE)
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.io import builders
    from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0, ns_per_day
    if "jax" in sys.modules or "openmm_drudenose_tpu" in sys.modules:
        fail("the port pulled in JAX or the JAX package")

    # ---- 1. build ----------------------------------------------------------
    t = time.time()
    sweep.build()
    build_s = time.time() - t
    ptxas = [ln.strip() for ln in sweep.build_log.splitlines()
             if "registers" in ln or "smem" in ln or "spill" in ln
             or ln.startswith("==")]
    log(f"1 build: B1 and B2 built by nvcc in {build_s:.1f} s")
    for ln in ptxas:
        log(f"  {ln}")
    # the bench configs: 100k (15^3 cells, C = 48) and 800k (30^3, C = 48
    # and the 56 it grows to)
    from openmm_drudenose_tpu_torch.forces.cellpair import make_config
    c100k = make_config(1.0, [8.0] * 3, 100000, [0], [4], capacity=48)
    c100k = dataclasses.replace(c100k, grid=(15, 15, 15))
    regs = report_limits({
        "100k": c100k,
        "800k": dataclasses.replace(c100k, grid=(30, 30, 30)),
        "800k grown": dataclasses.replace(c100k, grid=(30, 30, 30),
                                          capacity=56)})
    phase_seconds["1 build"] = phase_mark()

    # ---- 2. kernel parity at full size -----------------------------------
    snap = np.load(os.path.join(HERE, "data", "bench_equil_100k.npz"))
    n_atoms = int(snap["n_atoms"])
    cap = int(snap["capacity"])
    pos = np.asarray(snap["positions"], np.float64)
    vel = np.asarray(snap["velocities"], np.float64)
    system, _ = builders.build_water_box(n_atoms // 5)

    def make_ctx(precision):
        integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        integ.setMaxDrudeDistance(0.02)
        ctx = dt.Context(system, integ, precision=precision,
                         nb_options={"capacity": cap}, device="cuda")
        ctx.setPositions(pos)
        ctx.setVelocities(vel)
        return ctx, integ

    ctx, integ = make_ctx("single")
    ctx._ensure_neighbors()
    nb, cfg, st = ctx._nb, ctx._cp_cfg, ctx._state
    box_diag = torch.diagonal(st.box)
    log(f"2 context: {n_atoms} atoms, cell grid {cfg.grid}, capacity "
        f"{cfg.capacity}, {cfg.n_offsets} offsets, PME grid "
        f"{nb.pme.grid}, alpha {nb.alpha:.6f}")
    fields = nb.fields(st.positions, box_diag, st.neighbors)
    shifts = cellpair.offset_shifts(cfg, box_diag)
    args = (fields, cfg, shifts, nb.alpha, ONE_4PI_EPS0)
    f_k = sweep.pair_forces(*args)
    f_k2 = sweep.pair_forces(*args)
    torch.cuda.synchronize()
    b1_identical = bool(torch.equal(f_k, f_k2))
    del f_k2
    log(f"2 B1 launched twice on the same fields: bit-identical "
        f"{b1_identical}")
    if not b1_identical:
        fail("two B1 launches on the same fields gave different forces")
    f_p = sweep.pair_forces_plain(*args)
    scale = float(torch.max(torch.abs(f_p)))
    err_plain = float(torch.max(torch.abs(f_k - f_p))) / scale
    max_abs_err = float(torch.max(torch.abs(f_k - f_p)))
    f64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in fields.items()}
    f_p64 = sweep.pair_forces_plain(f64, cfg, shifts.double(), nb.alpha,
                                    ONE_4PI_EPS0)
    flips, n_flip = cutoff_flips(fields, f64, cfg, shifts, shifts.double())
    err64_all, _ = f32_floor(f_k, f_p64)
    err64, rms64 = f32_floor(f_k, f_p64, flips)
    log(f"2 B1 vs plain f32: max|dF|/max|F| = {err_plain:.3e} "
        f"(max|F| {scale:.1f}); vs plain f64: max {err64:.3e} "
        f"({err64_all:.3e} with the {int(flips.sum())} atoms of "
        f"{n_flip} cutoff-flipped pairs), rms {rms64:.3e}")
    if not (np.isfinite(err_plain) and err_plain <= 2e-5):
        fail(f"B1 disagrees with its plain version: {err_plain:.3e}")
    if not (err64 <= 1e-4 and rms64 <= 5e-6):
        fail(f"B1 misses the f32 floor against f64: max {err64:.3e}, "
             f"rms {rms64:.3e}")
    del f64, f_p64
    ms = cuda_time_ms(lambda: sweep.pair_forces(*args), 20)
    plain_ms = cuda_time_ms(lambda: sweep.pair_forces_plain(*args), 3)
    bound_ms, bound_by, n_tests, n_cut, n_bytes = sweep_bound(fields, cfg,
                                                              shifts)
    log(f"2 B1 {ms:.4f} ms (recorded with atomic reactions: "
        f"{RECORDED_MS['b1_sweep']} ms on NVIDIA H100 80GB HBM3, 700 W; "
        f"{regs['b1_sweep']} registers), plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: {n_tests} "
        f"pair tests, {n_cut} inside the cutoff, {n_bytes} bytes) on {card}")
    split = kernel_split(lambda: sweep.pair_forces(*args))
    log("2 B1's two kernels (torch.profiler, device ms a launch): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    phase_seconds["2 B1 at 100k"] = phase_mark()
    check_words(ctx, system)
    check_capacity(ctx, card)
    phase_seconds["2 (a), (b) words and capacity"] = phase_mark()

    # ---- 3. the slice --------------------------------------------------------
    ctx64, _ = make_ctx("double")
    ferr, ferr_all, frms, n_flip, fs, _ = force_pass_floor(ctx, ctx64)
    del ctx64
    torch.cuda.empty_cache()
    log(f"3 force pass f32 vs f64: max {ferr:.3e} ({ferr_all:.3e} with "
        f"the atoms of {n_flip} cutoff-flipped pairs), rms {frms:.3e} "
        f"(max|F| {fs:.1f})")
    if not (ferr <= 1e-4 and frms <= 5e-6):
        fail("the f32 force pass misses the f32 floor against f64")

    n_steps = 100
    t = time.time()
    _, launches, plain = counted(lambda: integ.step(n_steps))
    wall = time.time() - t
    ms_step = wall / n_steps * 1e3
    nsd = ns_per_day(n_steps / wall, integ.getStepSize())
    log(f"3 {n_steps} steps in {wall:.2f} s: {ms_step:.2f} ms/step, "
        f"{nsd:.3f} ns/day on {card}; launches {launches}; plain sweeps on "
        f"the card {plain}")
    if launches["b1_sweep"] < 1 or plain:
        fail("the main path never launched kernel B1, or ran the plain "
             "sweep")
    temps, e_launches, plain = counted(lambda: check_after_steps(ctx, "3"))
    log(f"3 the state's energy: launches {e_launches}, plain sweeps on the "
        f"card {plain}")
    if e_launches["b1_energy"] != 1 or plain:
        fail("getState(energy=True) did not come from B1's energy "
             "instantiation alone")
    if not (250.0 < temps[0] < 350.0 and 150.0 < temps[1] < 450.0
            and 0.0 < temps[2] < 10.0):
        fail(f"implausible bath temperatures {temps}")

    breakdown(ctx, sweep.pair_forces, "b1_sweep", ms_step, card, "3")
    bench_args = (nb.fields(ctx._state.positions,
                            torch.diagonal(ctx._state.box),
                            ctx._state.neighbors), cfg,
                  cellpair.offset_shifts(cfg, torch.diagonal(ctx._state.box)),
                  nb.alpha, ONE_4PI_EPS0)
    # the checkpoint replay through B1 (its forces in a fixed order)
    path = os.path.join(HERE, "build", "chip_smoke", "water100k.chk")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    dt.save_checkpoint(path, ctx)
    integ.step(REPLAY_STEPS)
    first = ctx._state.positions.clone()
    dt.load_checkpoint(path, ctx)
    _, replay_launches, _ = counted(lambda: integ.step(REPLAY_STEPS))
    dx = float(torch.max(torch.abs(ctx._state.positions - first)))
    log(f"3 checkpoint of the 100k NVT state, {REPLAY_STEPS} steps, loaded, "
        f"{REPLAY_STEPS} steps through B1 (launches {replay_launches}): "
        f"max |dx| {dx:.3e} nm")
    if dx != 0.0 or replay_launches["b1_sweep"] < REPLAY_STEPS:
        fail("the 100k checkpoint replay through B1 was not bit for bit")
    phase_seconds["3 the 100k slice"] = phase_mark()
    del ctx, integ, first
    torch.cuda.empty_cache()

    # ---- 4. B2 and the large path ------------------------------------------
    b2_entries = phase_big(card, bench_args, system)
    for e in b2_entries:
        e["registers"] = regs[e["name"]]
    phase_seconds["4 B2 and the large path"] = phase_mark()

    # ---- 5. the reference example at its own size ----------------------------
    phase_example(card)
    phase_seconds["5 the NaCl example"] = phase_mark()

    # ---- 6. NPT at full width through B1 -------------------------------------
    b1_energy = phase_npt(card, ms_step, pos, vel, cap)
    phase_seconds["6 NPT at 100k"] = phase_mark()

    # ---- 7. the ionic liquid, the reaction field through B1 ----------------
    rf_entries, _, il_state = phase_ionic_liquid(card)
    rf_regs = {f"{k}_sweep_rf": mod.attributes(False, "rf")["regs"]
               for k, mod in (("b1", sweep), ("b2", sweep_chunked))}
    rf_regs.update({f"{k}_energy_rf": mod.attributes(True, "rf")["regs"]
                    for k, mod in (("b1", sweep), ("b2", sweep_chunked))})
    for e in rf_entries:
        e["registers"] = rf_regs[e["name"]]
    phase_seconds["7 the ionic liquid"] = phase_mark()

    # ---- 8. the solvated polymer -------------------------------------------
    phase_polymer(card)
    phase_seconds["8 the polymer"] = phase_mark()

    # ---- 9. the sheared 100k box: triclinic through B1 and B2 ---------------
    tri_entries = phase_triclinic(card)
    for e in tri_entries:
        e["registers"] = regs[e["name"].replace("_triclinic", "")]
    phase_seconds["9 the sheared box"] = phase_mark()

    # ---- 10. the flattened replica ensemble: replica bands through B1 ----
    flat_entries, _, settled, flat_rate = phase_flat(card)
    for e in flat_entries:
        e["registers"] = regs[e["name"].replace("_bands", "")]
    phase_seconds["10 the flat ensemble"] = phase_mark()

    # ---- 11. flat NPT: per-replica box scales through B1 ------------------
    npt_entries = phase_flat_npt(card, settled)
    for e in npt_entries:
        mod = sweep if e["name"].startswith("b1") else sweep_chunked
        e["registers"] = mod.attributes(e["instantiation"] == "energy",
                                        "ewald", scaled=True)["regs"]
    phase_seconds["11 flat NPT"] = phase_mark()

    # ---- 12. the force-field XML path at 100k, NPT through B1 ------------
    final, modeller = phase_ff(card, ms_step)
    phase_seconds["12 the ffxml path"] = phase_mark()

    # ---- 13. SHAKE clusters at 100k ------------------------------------------
    phase_shake(card, ms_step, final, modeller)
    del modeller
    phase_seconds["13 SHAKE clusters"] = phase_mark()

    # ---- 14. the plain-PyTorch terms on the card ----------------------------
    phase_terms(card)
    phase_seconds["14 the plain terms"] = phase_mark()

    # ---- 15. switched LJ at full width --------------------------------------
    sw_entries = phase_switch(card, final, il_state, bench_args)
    del final, il_state
    phase_seconds["15 switched LJ"] = phase_mark()

    # ---- 16. ReplicaEnsemble, 64 x 4k -------------------------------------
    phase_replicas(card, settled, flat_rate)
    phase_seconds["16 ReplicaEnsemble"] = phase_mark()

    # ---- 17. lists, reporters, native runtime, breakdown -------------------
    phase_rest(card, system, (pos, vel, cap), settled)
    phase_seconds["17 the rest"] = phase_mark()

    # ---- 18. the multi-rank paths ------------------------------------------
    slab_entry, mem18 = phase_multirank(card, bench_args, cap, settled,
                                        regs)
    phase_seconds["18 the multi-rank paths"] = phase_mark()

    # ---- 19. the state-resident decomposition -----------------------------
    res_entry = phase_resident(card, cap, mem18)
    phase_seconds["19 the resident decomposition"] = phase_mark()

    # ---- 20. the long-run tools ---------------------------------------------
    phase_physics(card)
    phase_seconds["20 the long-run tools"] = phase_mark()

    # ---- 21. kernel summary -------------------------------------------------
    log("seconds per phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phase_seconds.items()))
    src, tpu = ("openmm_drudenose_tpu_torch/csrc/sweep.cu",
                "openmm_drudenose_tpu/ops/pallas_sweep.py:440")
    kernels = [{
        "name": "b1_sweep", "instantiation": "forces", "route": "cuda",
        "source": src, "replaces": tpu,
        "launches": launches["b1_sweep"],
        "launches_per_step": launches["b1_sweep"] / n_steps,
        "capacity": cfg.capacity, "registers": regs["b1_sweep"],
        "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "b1_energy", "instantiation": "energy", "route": "cuda",
        "source": src, "replaces": tpu, "registers": regs["b1_energy"],
        **b1_energy, "library_ms": None,
    }, *b2_entries, *rf_entries, *tri_entries, *flat_entries,
        *npt_entries, *sw_entries, slab_entry, res_entry]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
