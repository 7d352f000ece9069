"""Rank functions of the port's multi-rank CPU tests (tests/
test_torch_comm.py, _sharded, _distfft, _domain, _mesh_ensemble).

Spawned ranks import this module by name, so it imports only torch,
numpy and the port (never JAX: the JAX side of a test runs in the test
process).  Every function runs on each rank of a parallel/comm.py
`launch` and returns picklable results; systems arrive as the port's
System XML (the JAX system serialized in the test) and positions and
velocities as numpy arrays, so both packages see the same inputs.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from openmm_drudenose_tpu_torch.parallel import comm

# each rank's torch threads (the ranks share the CPU with the test
# process and the other test workers) and the collectives' timeout
THREADS = 1
TIMEOUT_S = 240.0


def launch(fn, world, *args):
    """fn(*args) on `world` gloo ranks on the CPU; their results."""
    return comm.launch(fn, world, "gloo", "cpu", TIMEOUT_S, args=args,
                       threads=THREADS)


def launch_beside(fn, world, *args):
    """Start `launch(fn, world, *args)` in a thread, so that the JAX side
    of a test runs while the ranks do; .result() gives their results."""
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(launch, fn, world, *args)
    pool.shutdown(wait=False)
    return fut


def _context(xml, positions, velocities, strategy, nb_options=None,
             integrator=(300.0, 0.1, 1.0, 0.005, 0.0005, 20, 2), wall=0.05):
    """A float64 CPU Context of the port on the System XML `xml`."""
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.app import serialization as tser
    system = tser.deserialize_system(xml)
    integ = dt.DrudeTGNHIntegrator(*integrator)
    integ.setMaxDrudeDistance(wall)
    ctx = dt.Context(system, integ, precision="double", strategy=strategy,
                     device="cpu", nb_options=nb_options)
    ctx.setPositions(positions)
    if velocities is not None:
        ctx.setVelocities(velocities)
    return ctx


# -- parallel/comm.py ---------------------------------------------------------

def collectives():
    """Each collective and the ring exchange on rank-dependent inputs."""
    m = comm.Mesh(("atom",))
    r = m.rank
    x = torch.arange(12, dtype=torch.float64).reshape(6, 2) + 10.0 * r
    i = torch.arange(6, dtype=torch.int64) * (r + 1)
    out = {"all_reduce": comm.all_reduce_sum(m, "atom", x),
           "all_reduce_int": comm.all_reduce_sum(m, "atom", i),
           "all_gather": comm.all_gather(m, "atom", x),
           "reduce_scatter": comm.reduce_scatter(m, "atom", x),
           "all_to_all": comm.all_to_all(m, "atom", x)}
    left, right = comm.ring_exchange(m, "atom", send_left=x[:2],
                                     send_right=x[2:4])
    out["from_left"], out["from_right"] = left, right
    return out


def mesh_axes():
    """A (2, 2) ("replica", "atom") mesh: coordinates and the sums along
    each axis."""
    m = comm.Mesh(("replica", "atom"), (2, 2))
    t = torch.tensor([float(m.rank)])
    return (m.coords, float(comm.all_reduce_sum(m, "atom", t)),
            float(comm.all_reduce_sum(m, "replica", t)))


def fails():
    m = comm.Mesh()
    if m.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return m.rank


def hangs():
    """Rank 1 never joins the all-reduce: rank 0's collective times out."""
    m = comm.Mesh()
    if m.rank == 1:
        time.sleep(60.0)
        return 1
    comm.all_reduce_sum(m, "atom", torch.ones(3))
    return 0


# -- parallel/sharded.py and parallel/distfft.py ----------------------------

def sharded_pass(xml, positions, velocities, nb_options, dfft, steps):
    """The sharded force pass (energy, forces) and the one-rank
    Context's beside it, then `steps` ShardedContext steps: positions,
    eta and the ranks' B1-free launch record."""
    from openmm_drudenose_tpu_torch.parallel import sharded
    m = comm.Mesh(("atom",))
    ctx = _context(xml, positions, velocities, "cellpair", nb_options)
    ctx._ensure_neighbors()
    st = ctx._state
    e1 = ctx._potential(st.positions, st.box, st.neighbors, st.pos_err)
    f1 = ctx._forces_only(st.positions, st.box, st.neighbors, st.pos_err)
    eaf = sharded.make_sharded_energy_and_forces(ctx, m,
                                                 distributed_fft=dfft)
    e, f = eaf(st.positions, st.box, st.neighbors, st.pos_err)
    out = {"e": float(e), "f": f.numpy(), "e1": float(e1), "f1": f1.numpy()}
    if steps:
        sctx = sharded.ShardedContext(ctx, m, distributed_fft=dfft)
        sctx.step(steps)
        out["positions"] = sctx.state.positions.numpy()
        out["eta"] = sctx.state.eta.numpy()
    return out


# -- parallel/domain.py ---------------------------------------------------------

def domain_sweep(xml, positions, capacity):
    """The halo-exchange sweep's energy and forces (atom order, gathered)
    and the whole-grid plain sweep's on the same fields."""
    from openmm_drudenose_tpu_torch.forces import cellpair
    from openmm_drudenose_tpu_torch.parallel import domain
    from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0
    m = comm.Mesh(("atom",))
    ctx = _context(xml, positions, None, "cellpair",
                   {"capacity": capacity})
    # the positions as given, the virtual sites' too (setPositions places
    # them; tests/test_domain.py sweeps the noisy positions as they are)
    ctx._state = ctx._state.replace(positions=torch.as_tensor(positions))
    ctx._ensure_neighbors()
    nb, cfg, st = ctx._nb, ctx._cp_cfg, ctx._state
    box = torch.diagonal(st.box)
    fields = domain.sorted_blocks_from_cellsort(nb.params, st.positions,
                                                box, st.neighbors, cfg)
    window = domain.stencil_window(cfg, box.numpy())
    fn = domain.make_sharded_pair_sweep(m, "atom", cfg, window, nb.alpha,
                                        ONE_4PI_EPS0, **nb.coulomb)
    e, f_loc = fn(domain.slab_fields(fields, cfg, m, "atom"), box)
    f_slots = comm.all_gather(m, "atom", f_loc).reshape(-1, 3)
    e0, f0 = cellpair.sweep(fields, cfg, cellpair.offset_shifts(cfg, box),
                            nb.alpha, ONE_4PI_EPS0, **nb.coulomb)
    inv = st.neighbors.inv_slot
    return {"grid": cfg.grid, "e": float(e), "f": f_slots[inv].numpy(),
            "e_whole": float(e0), "f_whole": f0[inv].numpy()}


# -- parallel/ensemble.py --------------------------------------------------------

def flat_mesh(xml, positions, velocities, steps, capacity):
    """Flat sub-ensembles (two replicas each) over a ("replica",) mesh of
    every rank, one sub-ensemble a rank: the gathered positions and
    kinetic energies, and on rank 0 the standalone flat ensemble run from
    the velocities of each sub-ensemble (max |dx|, bit for bit)."""
    import openmm_drudenose_tpu_torch as dt
    m = comm.Mesh(("replica",))
    tctx = _context(xml, positions, None, "cellpair",
                    {"capacity": capacity, "skin": 0.1},
                    (300.0, 0.1, 1.0, 0.005, 0.001, 20, 2, False), 0.02)
    flat = dt.FlatReplicaEnsemble(tctx, 2)
    rens = dt.ReplicaEnsemble(flat.context, n_replicas=len(velocities),
                              mesh=m, seed=3)
    rens.setVelocities(velocities)
    rens.step(steps)
    out = {"positions": rens.positions(), "ke": rens.kinetic_energies(),
           "boxes": rens.boxes(), "box": flat.context._state.box.numpy()}
    moved = out["positions"].copy()
    moved[:, :, 0] += 1e-3 * (np.arange(moved.shape[0]) + 1.0)[:, None]
    rens.setPositions(moved)
    out["set"], out["moved"] = rens.positions(), moved
    if m.rank == 0:
        flat.context.setVelocities(velocities[-1])
        flat.step(steps)
        out["standalone_last"] = flat.context.getPositions()
    return out


def replica_atom(xml, positions, velocities, shape, steps):
    """A ReplicaEnsemble over a ("replica", "atom") mesh of `shape`, each
    replica group's force pass split over its atom ranks: the gathered
    positions after `steps` (every replica from the template's state and
    the velocities given) and each rank's positions (the atom ranks of a
    group hold the same bits)."""
    import openmm_drudenose_tpu_torch as dt
    m = comm.Mesh(("replica", "atom"), shape)
    ctx = _context(xml, positions, velocities, "auto")
    ctx.applyConstraints(1e-6)
    R = shape[0]
    ens = dt.ReplicaEnsemble(ctx, n_replicas=R, mesh=m, seed=1)
    ens.step(steps)
    out = {"positions": ens.positions(), "strategy": ctx._nb.strategy,
           "local": ens.state.positions.numpy(), "boxes": ens.boxes(),
           "box": ctx._state.box.numpy()}
    # setPositions: replica r moved by r + 1 times 1e-3 nm along x, read
    # back through the gather
    moved = out["positions"].copy()
    moved[:, :, 0] += 1e-3 * (np.arange(R) + 1.0)[:, None]
    ens.setPositions(moved)
    out["set"] = ens.positions()
    out["moved"] = moved
    return out


def distfft_grid(grid, box, seed):
    """The distributed FFT's energy and potential on a random charge
    grid against the replicated sum's (forces/pme.py), on every rank."""
    from openmm_drudenose_tpu_torch.forces import pme
    from openmm_drudenose_tpu_torch.parallel import distfft
    m = comm.Mesh(("atom",))
    setup = pme.setup_pme(cutoff=0.7, tol=5e-4, box_diag=box, grid=grid)
    Q = torch.as_tensor(np.random.default_rng(seed).normal(size=grid))
    box_t = torch.as_tensor(box, dtype=torch.float64)
    k = grid[0] // m.size("atom")
    lo = m.index("atom") * k
    e, phi = distfft.energy_and_potential(setup, Q[lo:lo + k].contiguous(),
                                          box_t, m, "atom")
    e_only, none = distfft.energy_and_potential(
        setup, Q[lo:lo + k].contiguous(), box_t, m, "atom", False)
    e_ref, phi_ref = pme.grid_energy_and_potential(setup, Q, box_t)
    return {"e": float(e), "e_only": float(e_only), "none": none,
            "phi": comm.all_gather(m, "atom", phi).reshape(grid).numpy(),
            "e_ref": float(e_ref), "phi_ref": phi_ref.numpy()}


def sharded_card(n_molecules, cutoff):
    """On a card (each rank on cuda:0 over gloo): the single-rank float32
    Context's force pass, then the sharded one (B1 on each rank's slab):
    their max |dF| / max |F|, whether every rank's forces are the same
    bits, and this rank's slab launches."""
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.io import builders
    from openmm_drudenose_tpu_torch.ops import sweep
    from openmm_drudenose_tpu_torch.parallel import sharded
    m = comm.Mesh(("atom",))
    system, pos = builders.build_water_box(n_molecules, cutoff=cutoff)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision="single", device=m.device,
                     strategy="cellpair",
                     nb_options={"grid_x_multiple": m.size("atom")})
    ctx.setPositions(pos)
    ctx._ensure_neighbors()
    st = ctx._state
    f1 = ctx._forces_only(st.positions, st.box, st.neighbors, st.pos_err)
    before = sweep.launches["b1_sweep_slab"]
    fp = sharded.ShardedForcePass(ctx, m)
    f = fp.forces(st.positions, st.box, st.neighbors, st.pos_err)
    torch.cuda.synchronize()
    same = comm.all_gather(m, "atom", f)
    return {"err": float(torch.max(torch.abs(f - f1))
                         / torch.max(torch.abs(f1))),
            "identical": bool(all(torch.equal(same[0], g) for g in same)),
            "slab_launches": sweep.launches["b1_sweep_slab"] - before,
            "grid": ctx._cp_cfg.grid}


def sharded_suite(pme, rf, growth, steps):
    """sharded_pass on the PME inputs with `steps` steps and on the
    reaction-field ones without, and sharded_growth_npt: the runs of
    tests/test_torch_sharded.py in one launch."""
    return {"pme": sharded_pass(*pme, {"grid_x_multiple": 3}, False, steps),
            "rf": sharded_pass(*rf, {"grid_x_multiple": 3}, False, 0),
            **sharded_growth_npt(*growth, steps)}


def sharded_growth_npt(xml, positions, velocities, steps):
    """ShardedContext runs of Context.step's machinery against the
    one-rank Context's, from a cell capacity too small (grown before the
    first step, the recompile's Stepper on the sharded pass) and under a
    MonteCarloBarostat attempting every other step: max |dx|, the
    boxes, the capacities, and whether the Context's Stepper runs the
    sharded pass after the growth."""
    import openmm_drudenose_tpu_torch as dt
    from openmm_drudenose_tpu_torch.app import serialization as tser
    from openmm_drudenose_tpu_torch.parallel import sharded
    m = comm.Mesh(("atom",))
    out = {}
    for case in ("growth", "npt"):
        xml_c = xml
        if case == "npt":
            system = tser.deserialize_system(xml)
            system.addForce(dt.MonteCarloBarostat(1.0, 300.0, 2))
            xml_c = tser.serialize_system(system)
        opts = {"grid_x_multiple": m.size("atom")}
        if case == "growth":
            opts["capacity"] = 2
        ref = _context(xml_c, positions, velocities, "cellpair", opts)
        ref.getIntegrator().step(steps)
        ctx = _context(xml_c, positions, velocities, "cellpair", opts)
        sctx = sharded.ShardedContext(ctx, m)
        sctx.step(steps)
        out[case] = {
            "dx": float(torch.max(torch.abs(ctx._state.positions
                                            - ref._state.positions))),
            "box": (ctx._state.box.numpy(), ref._state.box.numpy()),
            "capacity": (ctx._cp_cfg.capacity, ref._cp_cfg.capacity),
            "sharded_stepper": (ctx._pair_sum is sctx._pass
                                and ctx._stepper.forces_fn
                                == ctx._forces_only),
            "positions": ctx._state.positions.numpy()}
    return out
