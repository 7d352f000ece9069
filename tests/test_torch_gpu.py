"""Card-only checks of the PyTorch port: kernels B1 and B2 against their
plain versions on CUDA tensors, also with exclusion masks of three words
and at capacity 160; B2's bit-identical repeat launches; the limits read
from the card and the routing by them; their refusals, and the Context
stepping through each; the kernels' energy instantiations against the
plain energy in f64, two launches bit-identical, getState(energy=True)
through them, an NPT Context stepping through B1, and their refusals
(no plain fallback); the fixed-order scatter-add and a checkpoint
replayed bit for bit (dense, through B2 and through B1); B1's
bit-identical repeat launches; the reaction-field instantiations of both
kernels against their plain versions and a CutoffPeriodic Context
stepping through them; the bonded terms on the card against the CPU in
f64.  The kernel-against-plain, energy, bit-identity, reaction-field
and checkpoint tests run in a triclinic box too (the 216-water box
sheared as the JAX package's scripts/check_triclinic_tpu.py shears its
100k box), where the same kernels read the triclinic shift table.  The
replica-band path: both kernels against their plain versions on a
flattened ensemble's banded grid, bit-identical launches, replicas
isolated bit for bit, a flat-ensemble Context stepping through each, and
a checkpoint of a flat-ensemble run replayed bit for bit.  The
force-field path, SHAKE clusters and the plain-PyTorch terms (phases
12-14 of chip_smoke.py at small size): a small NaCl deck read through
ForceField against io/nacl.py's System and stepped in NPT through B1, its
flexible-water variant stepped with SHAKE and RATTLE, and
tools/term_checks.py's systems in f64 on the card against the CPU.
The long-run tools' pieces: the JAX drift checkpoint read into the
bench Context on the card, tools/measure_drift.py's loop resumed bit for
bit through B1, and B1 on the 500-water 4^3 grid of explicit images
against its plain version.  The NH chain kernel against its plain
version in each form, and 2 x 16 steps of the 216-water box under
set_sync_debug_mode("error").
Marked `gpu`; each test skips (through the `cuda` fixture) where
no CUDA card is present.
On the card (tests/conftest.py imports JAX, which the machine with the
card lacks): python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu_torch.forces import cellpair
from openmm_drudenose_tpu_torch.integrators import barostat
from openmm_drudenose_tpu_torch.io import builders
from openmm_drudenose_tpu_torch.ops import sweep, sweep_chunked
from openmm_drudenose_tpu_torch.units import ONE_4PI_EPS0

pytestmark = pytest.mark.gpu

GEOMETRIES = pytest.mark.parametrize("triclinic", [False, True],
                                     ids=["orthorhombic", "triclinic"])


def _shear(system):
    """Shear the box as scripts/check_triclinic_tpu.py shears its own:
    b = (0.2 L, L, 0), c = (0.1 L, 0.15 L, L)."""
    L = system.getDefaultPeriodicBoxVectors()[0][0]
    system.setDefaultPeriodicBoxVectors((L, 0, 0), (0.2 * L, L, 0),
                                        (0.1 * L, 0.15 * L, L))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ctx(device, precision="single", nb_options=None, exception=None,
         barostat=0, triclinic=False):
    system, pos = builders.build_water_box(216, cutoff=0.6)
    if triclinic:
        _shear(system)
    if barostat:
        system.addForce(dt.MonteCarloBarostat(1.01325, 300.0, barostat))
    if exception is not None:
        nonbonded = next(f for f in system.getForces()
                         if type(f).__name__ == "NonbondedForce")
        nonbonded.addException(*exception, 0.0, 1.0, 0.0)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision=precision, device=device,
                     strategy="cellpair", nb_options=nb_options)
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, seed=1)
    ctx._ensure_neighbors()
    assert ctx._triclinic == triclinic
    return ctx, integ


def _fields(ctx):
    st, nb = ctx._state, ctx._nb
    box = ctx._box_arg(st.box)
    return (nb.fields(st.positions, box, st.neighbors), nb.cfg,
            cellpair.offset_shifts(nb.cfg, box), nb.alpha, ONE_4PI_EPS0)


@GEOMETRIES
def test_kernel_matches_plain_on_card(cuda, triclinic):
    ctx, _ = _ctx(cuda, triclinic=triclinic)
    args = _fields(ctx)
    f_k = sweep.pair_forces(*args)
    torch.cuda.synchronize()
    f_p = sweep.pair_forces_plain(*args)
    scale = float(torch.max(torch.abs(f_p)))
    assert float(torch.max(torch.abs(f_k - f_p))) <= 2e-5 * scale


def test_kernel_refuses_float64(cuda):
    ctx, _ = _ctx(cuda)
    fields, cfg, shifts, alpha, scale = _fields(ctx)
    f64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in fields.items()}
    with pytest.raises(ValueError):
        sweep.pair_forces(f64, cfg, shifts.double(), alpha, scale)


@GEOMETRIES
def test_context_steps_through_kernel(cuda, triclinic):
    ctx, integ = _ctx(cuda, triclinic=triclinic)
    before = sweep.launches["b1_sweep"]
    integ.step(20)
    torch.cuda.synchronize()
    assert sweep.launches["b1_sweep"] - before >= 20
    st = ctx.getState(positions=True, energy=True)
    assert np.all(np.isfinite(st.getPositions()))
    assert np.isfinite(st.getPotentialEnergy())


@GEOMETRIES
def test_b2_matches_plain_on_card(cuda, triclinic):
    ctx, _ = _ctx(cuda, triclinic=triclinic)
    args = _fields(ctx)
    f_k = sweep_chunked.pair_forces(*args)
    torch.cuda.synchronize()
    f_p = sweep_chunked.pair_forces_plain(*args)
    scale = float(torch.max(torch.abs(f_p)))
    assert float(torch.max(torch.abs(f_k - f_p))) <= 2e-5 * scale
    f_b1 = sweep.pair_forces(*args)
    assert float(torch.max(torch.abs(f_k - f_b1))) <= 2e-5 * scale


@GEOMETRIES
def test_b2_launches_are_bit_identical(cuda, triclinic):
    ctx, _ = _ctx(cuda, triclinic=triclinic)
    args = _fields(ctx)
    first = sweep_chunked.pair_forces(*args)
    for _ in range(3):
        assert torch.equal(sweep_chunked.pair_forces(*args), first)


def test_b2_refuses_float64(cuda):
    ctx, _ = _ctx(cuda)
    fields, cfg, shifts, alpha, scale = _fields(ctx)
    f64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in fields.items()}
    with pytest.raises(ValueError):
        sweep_chunked.pair_forces(f64, cfg, shifts.double(), alpha, scale)


@GEOMETRIES
def test_context_steps_through_b2(cuda, triclinic):
    ctx, integ = _ctx(cuda, nb_options={"use_pallas": 3},
                      triclinic=triclinic)
    assert ctx._nb.sweep_kernel == "b2"
    before = dict(sweep.launches)
    integ.step(20)
    torch.cuda.synchronize()
    assert sweep.launches["b2_sweep"] - before["b2_sweep"] >= 20
    assert sweep.launches["b1_sweep"] == before["b1_sweep"]
    st = ctx.getState(positions=True, energy=True)
    assert np.all(np.isfinite(st.getPositions()))
    assert np.isfinite(st.getPotentialEnergy())


def _held_to_plain(args):
    f_p = sweep.pair_forces_plain(*args)
    scale = float(torch.max(torch.abs(f_p)))
    for kernel in (sweep, sweep_chunked):
        f_k = kernel.pair_forces(*args)
        torch.cuda.synchronize()
        assert float(torch.max(torch.abs(f_k - f_p))) <= 2e-5 * scale


def test_kernels_take_three_exclusion_words(cuda):
    """An exclusion over 40 atom indices: W = 40, three mask words, every
    intramolecular exclusion in word 1."""
    ctx, _ = _ctx(cuda, exception=(0, 40))
    assert ctx._cp_cfg.excl_words == 3
    assert ctx._nb.sweep_kernel in ("b1", "b2")
    _held_to_plain(_fields(ctx))


def test_kernels_take_capacity_160(cuda):
    ctx, _ = _ctx(cuda, nb_options={"capacity": 160})
    assert ctx._cp_cfg.capacity == 160
    assert ctx._nb.sweep_kernel in ("b1", "b2")
    _held_to_plain(_fields(ctx))


def test_limits_read_from_the_card(cuda):
    for kernel in (sweep, sweep_chunked):
        a = kernel.attributes()
        assert 0 < a["regs"] <= 255 and a["local_bytes"] >= 0
    lim = sweep_chunked.card_limits(cuda)
    assert lim.max_threads >= 256 and lim.smem_block >= 48 * 1024
    assert lim.regs == sweep_chunked.attributes()["regs"]
    ctx, _ = _ctx(cuda)
    cfg = ctx._cp_cfg
    brick = sweep_chunked.choose_brick(cfg, lim)
    assert sweep_chunked.resident_ctas(brick, cfg.capacity, lim) >= 1


def test_route_on_card_limits(cuda):
    import dataclasses
    ctx, _ = _ctx(cuda)
    lim = sweep_chunked.card_limits(cuda)
    for C in (160, 512):
        cfg = dataclasses.replace(ctx._cp_cfg, capacity=C)
        assert sweep_chunked.b2_takes(cfg, lim)
        assert sweep.route(cfg, limits=lim)[0] == "b1"
        assert sweep.route(cfg, use_pallas=3, limits=lim)[0] == "b2"


@GEOMETRIES
def test_energy_kernels_match_plain_on_card(cuda, triclinic):
    """Both energy instantiations against the plain energy in f64 (1e-3
    kJ/mol here: the box's |E| is ~60 kJ/mol of ~1e4 kJ/mol terms, and
    the plain f32 sum is itself ~3e-4 off), the same bits twice."""
    ctx, _ = _ctx(cuda, triclinic=triclinic)
    fields, cfg, shifts, alpha, scale = _fields(ctx)
    f64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in fields.items()}
    e64 = float(sweep.pair_energy_plain(f64, cfg, shifts.double(), alpha,
                                        scale))
    for kernel in (sweep, sweep_chunked):
        e1 = kernel.pair_energy(fields, cfg, shifts, alpha, scale)
        e2 = kernel.pair_energy(fields, cfg, shifts, alpha, scale)
        torch.cuda.synchronize()
        assert e1.dtype == torch.float64 and torch.equal(e1, e2)
        assert abs(float(e1) - e64) <= 1e-3


def test_state_energy_runs_the_energy_kernel(cuda):
    ctx, _ = _ctx(cuda)
    before = dict(sweep.launches)
    plain = cellpair.plain_sweeps["cuda"]
    st = ctx.getState(energy=True)
    torch.cuda.synchronize()
    assert np.isfinite(st.getPotentialEnergy())
    assert sweep.launches["b1_energy"] == before["b1_energy"] + 1
    assert cellpair.plain_sweeps["cuda"] == plain


def test_npt_context_steps_through_b1(cuda):
    """50 steps with a barostat every 10: every force pass by B1, two B1
    energy launches an attempt, no plain sweep."""
    ctx, integ = _ctx(cuda, barostat=10)
    ctx._ensure_forces()
    before = dict(sweep.launches)
    plain = cellpair.plain_sweeps["cuda"]
    integ.step(50)
    torch.cuda.synchronize()
    assert sweep.launches["b1_sweep"] - before["b1_sweep"] >= 50
    assert sweep.launches["b1_energy"] - before["b1_energy"] == 2 * 5
    assert cellpair.plain_sweeps["cuda"] == plain
    assert ctx._state.baro_nattempt == 5
    st = ctx.getState(positions=True, energy=True)
    assert np.all(np.isfinite(st.getPositions()))
    assert np.isfinite(st.getPotentialEnergy())


def test_sweep_energy_raises_where_the_kernel_refuses(cuda):
    """A config the kernels do not take (not a half stencil; for B2 also
    not a regular grid, which B1 takes since it sweeps grids of fewer
    than 2w + 1 cells), and float64 fields: the energy wrappers raise on
    the card and never fall back to the plain sweep."""
    import dataclasses
    ctx, _ = _ctx(cuda)
    fields, cfg, shifts, alpha, scale = _fields(ctx)
    bad = dataclasses.replace(cfg, half_stencil=False)
    f64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in fields.items()}
    plain = cellpair.plain_sweeps["cuda"]
    with pytest.raises(ValueError):
        sweep_chunked.pair_energy(fields, dataclasses.replace(
            cfg, regular=False), shifts, alpha, scale)
    for kernel in (sweep, sweep_chunked):
        with pytest.raises(ValueError):
            kernel.pair_energy(fields, bad, shifts, alpha, scale)
        with pytest.raises(ValueError):
            kernel.pair_energy(f64, cfg, shifts.double(), alpha, scale)
    ctx._nb.cfg = bad
    with pytest.raises(ValueError):
        ctx._nb.sweep_energy(ctx._state.positions,
                             torch.diagonal(ctx._state.box),
                             ctx._state.neighbors)
    assert cellpair.plain_sweeps["cuda"] == plain


def test_scatter_add_is_the_same_every_call(cuda):
    """ops/scatter.py on the card: 2e6 float32 rows into 1000 targets (2000
    collisions a target) give the same bits every call and match the
    float64 sum to float32 rounding."""
    from openmm_drudenose_tpu_torch.ops import scatter
    g = torch.Generator(device="cpu").manual_seed(3)
    idx = torch.randint(0, 1000, (2_000_000,), generator=g).to(cuda)
    src = torch.randn(2_000_000, 3, generator=g).to(cuda)
    runs = [scatter.index_add_(torch.zeros(1000, 3, device=cuda), idx, src)
            for _ in range(3)]
    ref = torch.zeros(1000, 3, dtype=torch.float64, device=cuda)
    ref.index_add_(0, idx, src.double())
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert float(torch.max(torch.abs(runs[0].double() - ref))) < 1e-2


@pytest.mark.parametrize(
    "strategy,use_pallas,triclinic",
    [("dense", 3, False), ("cellpair", 3, False), ("cellpair", None, False),
     ("dense", 3, True), ("cellpair", 3, True), ("cellpair", None, True)],
    ids=["dense", "cellpair", "cellpair-b1", "dense-triclinic",
         "cellpair-triclinic", "cellpair-b1-triclinic"])
def test_checkpoint_replay_is_bit_exact_on_card(cuda, tmp_path, strategy,
                                                use_pallas, triclinic):
    """NPT on the card in PyTorch's default (not deterministic) mode: save,
    40 steps, load, 40 steps give the same positions bit for bit, on the
    dense strategy and on the cell-pair strategy through B2 and through
    B1 (whose reactions go through frames with one writer an entry), in
    an orthorhombic and a triclinic box (whose (3, 3) box comes back
    too)."""
    system, pos = builders.build_water_box(216, cutoff=0.6)
    if triclinic:
        _shear(system)
    system.addForce(dt.MonteCarloBarostat(1.01325, 300.0, 10))
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision="single", device=cuda,
                     strategy=strategy, nb_options={"use_pallas": use_pallas})
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, seed=1)
    assert ctx._nb.strategy == strategy
    if strategy == "cellpair":
        assert ctx._nb.sweep_kernel == ("b2" if use_pallas == 3 else "b1")
    integ.step(20)
    path = str(tmp_path / "npt.chk")
    dt.save_checkpoint(path, ctx)
    integ.step(40)
    first = ctx._state.positions.clone()
    first_box = ctx._state.box.clone()
    dt.load_checkpoint(path, ctx)
    integ.step(40)
    assert not torch.are_deterministic_algorithms_enabled()
    assert torch.equal(first, ctx._state.positions)
    assert torch.equal(first_box, ctx._state.box)
    assert ctx._triclinic == triclinic


def test_pme_spread_is_the_same_every_call(cuda):
    """The PME charge spread (int64 fixed point) on the card: the same bits
    every call, and the CPU's grid to float32 rounding."""
    from openmm_drudenose_tpu_torch.forces import pme
    rng = np.random.default_rng(4)
    n, box = 20000, 6.0
    setup = pme.setup_pme(1.0, 5e-4, [box] * 3)
    q = rng.normal(size=n)
    pos = rng.uniform(0.0, box, (n, 3))
    grids = []
    for dev in (cuda, cuda, torch.device("cpu")):
        charges = torch.as_tensor(q, dtype=torch.float32, device=dev)
        p = torch.as_tensor(pos, dtype=torch.float32, device=dev)
        b = torch.full((3,), box, dtype=torch.float32, device=dev)
        idx, wts, _ = pme._taps(setup, p, b)
        grids.append(pme.spread(setup, charges, idx, wts).cpu())
    assert torch.equal(grids[0], grids[1])
    scale = float(torch.max(torch.abs(grids[2])))
    assert float(torch.max(torch.abs(grids[0] - grids[2]))) <= 1e-5 * scale


@GEOMETRIES
def test_b1_launches_are_bit_identical(cuda, triclinic):
    ctx, _ = _ctx(cuda, triclinic=triclinic)
    args = _fields(ctx)
    first = sweep.pair_forces(*args)
    for _ in range(3):
        assert torch.equal(sweep.pair_forces(*args), first)


def _rf_ctx(device, nb_options=None, triclinic=False):
    """The 216-water box under CutoffPeriodic (the reaction field) on the
    cell-pair strategy."""
    system, pos = builders.build_water_box(
        216, cutoff=0.6, method=dt.NonbondedForce.CutoffPeriodic)
    if triclinic:
        _shear(system)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision="single", device=device,
                     strategy="cellpair", nb_options=nb_options)
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, seed=1)
    ctx._ensure_neighbors()
    return ctx, integ


@GEOMETRIES
def test_rf_kernels_match_plain_on_card(cuda, triclinic):
    """B1's and B2's reaction-field instantiations against their plain
    versions: forces 2e-5 of max|F|, energy against the plain energy in
    f64 to 2e-2 kJ/mol (|E| is ~225 kJ/mol here, of ~8e4 pairs inside
    the cutoff whose reaction-field energies, qq (1/r + krf r^2 - crf)
    with |qq| up to ~400 kJ nm/mol, each round by ~1e-4 kJ/mol in
    float32), each the same bits twice."""
    ctx, _ = _rf_ctx(cuda, triclinic=triclinic)
    nb = ctx._nb
    assert nb.coulomb["method"] == "rf" and nb.pme is None
    fields, cfg, shifts, alpha, scale = _fields(ctx)
    kw = nb.coulomb
    f_p = sweep.pair_forces_plain(fields, cfg, shifts, alpha, scale, **kw)
    f64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in fields.items()}
    e64 = float(sweep.pair_energy_plain(f64, cfg, shifts.double(), alpha,
                                        scale, **kw))
    fmax = float(torch.max(torch.abs(f_p)))
    before = dict(sweep.launches)
    for kernel in (sweep, sweep_chunked):
        f1 = kernel.pair_forces(fields, cfg, shifts, alpha, scale, **kw)
        f2 = kernel.pair_forces(fields, cfg, shifts, alpha, scale, **kw)
        e1 = kernel.pair_energy(fields, cfg, shifts, alpha, scale, **kw)
        e2 = kernel.pair_energy(fields, cfg, shifts, alpha, scale, **kw)
        torch.cuda.synchronize()
        assert torch.equal(f1, f2) and torch.equal(e1, e2)
        assert float(torch.max(torch.abs(f1 - f_p))) <= 2e-5 * fmax
        assert abs(float(e1) - e64) <= 2e-2
    for k in ("b1_sweep_rf", "b2_sweep_rf", "b1_energy_rf", "b2_energy_rf"):
        assert sweep.launches[k] - before[k] == 2
    for k in ("b1_sweep", "b2_sweep", "b1_energy", "b2_energy"):
        assert sweep.launches[k] == before[k]


@pytest.mark.parametrize("use_pallas", [None, 3], ids=["b1", "b2"])
def test_rf_context_steps_through_the_rf_kernels(cuda, use_pallas):
    """A CutoffPeriodic Context steps through the routed kernel's
    reaction-field instantiation, reads its energy there, and never runs
    the plain sweep on the card."""
    ctx, integ = _rf_ctx(cuda, {"use_pallas": use_pallas})
    name = "b2" if use_pallas == 3 else "b1"
    assert ctx._nb.sweep_kernel == name
    before = dict(sweep.launches)
    plain = cellpair.plain_sweeps["cuda"]
    integ.step(20)
    st = ctx.getState(positions=True, energy=True)
    torch.cuda.synchronize()
    assert sweep.launches[f"{name}_sweep_rf"] - before[f"{name}_sweep_rf"] \
        >= 20
    assert sweep.launches[f"{name}_energy_rf"] \
        == before[f"{name}_energy_rf"] + 1
    assert cellpair.plain_sweeps["cuda"] == plain
    assert np.all(np.isfinite(st.getPositions()))
    assert np.isfinite(st.getPotentialEnergy())


def test_bonded_terms_on_card_match_cpu(cuda):
    """The four bonded forces on the card in f64 against the CPU: energy
    1e-12 relative, forces 1e-10 of max|F| (the same arithmetic, other
    sum orders)."""
    rng = np.random.default_rng(21)
    n = 60
    pos = rng.normal(size=(n, 3))
    forces = [dt.HarmonicBondForce(), dt.HarmonicAngleForce(),
              dt.PeriodicTorsionForce(), dt.HarmonicTorsionForce()]
    for _ in range(40):
        i, j, k, l = (int(v) for v in rng.choice(n, 4, replace=False))
        forces[0].addBond(i, j, 0.2, 1e4)
        forces[1].addAngle(i, j, k, 1.9, 300.0)
        forces[2].addTorsion(i, j, k, l, 3, 0.3, 2.0)
        forces[3].addTorsion(i, j, k, l, 0.5, 20.0)
    for f in forces:
        out = []
        for dev in ("cpu", cuda):
            term = f.compile(None, torch.float64, dev)
            e, fo = term.energy_forces(torch.as_tensor(pos, device=dev))
            out.append((float(e), fo.cpu().numpy()))
        (e_ref, f_ref), (e, fc) = out
        assert abs(e - e_ref) <= 1e-12 * abs(e_ref)
        assert np.abs(fc - f_ref).max() <= 1e-10 * np.abs(f_ref).max()


# -- the replica-band path (a flattened replica ensemble) ---------------------

KERNELS = pytest.mark.parametrize("version", ["b1", "b2"])


def _flat(device, nb_options=None, barostat=0):
    """Four replicas of the 216-water box (the template on the dense
    strategy) in a 2 x 2 layout: a (10, 5, 10) grid of 5^3 replica
    grids; with `barostat` a MonteCarloBarostat of that interval (flat
    NPT)."""
    system, pos = builders.build_water_box(216, cutoff=0.6)
    if barostat:
        system.addForce(dt.MonteCarloBarostat(1.01325, 300.0, barostat))
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    tpl = dt.Context(system, integ, precision="single", device=device)
    tpl.setPositions(pos)
    ens = dt.FlatReplicaEnsemble(tpl, 4, rx=2, rz=2, nb_options=nb_options)
    ens.setVelocitiesToTemperature(300.0, seed=1)
    ens.context._ensure_neighbors()
    cfg = ens.context._cp_cfg
    assert cfg.grid == (10, 5, 10) and cfg.phys_grid == (5, 5, 5)
    return ens


@KERNELS
def test_band_kernels_match_plain_on_card(cuda, version):
    ens = _flat(cuda)
    kernel = sweep if version == "b1" else sweep_chunked
    args = _fields(ens.context)
    key = f"{version}_sweep_bands"
    before = sweep.launches[key]
    f_k = kernel.pair_forces(*args)
    torch.cuda.synchronize()
    assert sweep.launches[key] == before + 1
    f_p = kernel.pair_forces_plain(*args)
    scale = float(torch.max(torch.abs(f_p)))
    assert float(torch.max(torch.abs(f_k - f_p))) <= 2e-5 * scale
    e_k = float(kernel.pair_energy(*args))
    e_p = float(sweep.pair_energy_plain(*args))
    assert abs(e_k - e_p) <= 1e-6 * abs(e_p)


@KERNELS
def test_band_launches_are_bit_identical_and_isolated(cuda, version):
    """Two launches on the same banded fields give the same bits; moving
    every atom of replica 0 leaves the other replicas' forces bit for
    bit."""
    ens = _flat(cuda)
    kernel = sweep if version == "b1" else sweep_chunked
    ctx = ens.context
    args = _fields(ctx)
    first = kernel.pair_forces(*args)
    assert torch.equal(kernel.pair_forces(*args), first)
    st, nb = ctx._state, ctx._nb
    n0 = st.positions.shape[0] // 4
    box = torch.diagonal(st.box)
    moved = st.positions.clone()
    gen = torch.Generator(device="cpu").manual_seed(2)
    moved[:n0] = torch.remainder(moved[:n0] + 0.01 * torch.randn(
        (n0, 3), generator=gen).to(moved.device), box)
    nbl = nb.cellsort(moved, box)
    fb = kernel.pair_forces(nb.fields(moved, box, nbl), *args[1:])
    fa = first[st.neighbors.inv_slot]
    fb = fb[nbl.inv_slot]
    assert float(torch.max(torch.abs(fa[:n0] - fb[:n0]))) > 0
    assert torch.equal(fa[n0:], fb[n0:])


@pytest.mark.parametrize("use_pallas", [None, 3], ids=["b1", "b2"])
def test_flat_ensemble_steps_through_band_kernels(cuda, use_pallas):
    ens = _flat(cuda, {"use_pallas": use_pallas})
    version = "b2" if use_pallas == 3 else "b1"
    assert ens.context._nb.sweep_kernel == version
    before = dict(sweep.launches)
    ens.step(20)
    torch.cuda.synchronize()
    assert (sweep.launches[f"{version}_sweep_bands"]
            - before[f"{version}_sweep_bands"]) >= 20
    assert sweep.launches["b1_sweep"] == before["b1_sweep"]
    t = ens.group_temperatures()
    assert t.shape == (4, 3) and np.all(np.isfinite(t))
    assert np.all(np.isfinite(ens.kinetic_energies()))


def test_flat_checkpoint_replay_is_bit_exact_on_card(cuda, tmp_path):
    """A flat-ensemble run through B1's band path: save, 32 steps, load,
    32 steps give the same positions and (R, G+2) baths bit for bit."""
    ens = _flat(cuda)
    ctx = ens.context
    ens.step(16)
    path = str(tmp_path / "flat.chk")
    dt.save_checkpoint(path, ctx)
    ens.step(32)
    first = ctx._state.positions.clone()
    eta = ctx._state.eta_dot.clone()
    dt.load_checkpoint(path, ctx)
    ens.step(32)
    assert torch.equal(first, ctx._state.positions)
    assert torch.equal(eta, ctx._state.eta_dot) and eta.shape[0] == 4


# -- flat NPT: the scaled instantiations --------------------------------------

SCALES4 = (1.012, 0.991, 1.0, 0.984)


def _scaled_args(ctx, scales, positions=None):
    """The sorted fields and the per-replica shift table of `ctx` at
    `scales` (the flat NPT fields: physical, binned at p / s_r; by
    default the state's molecules scaled about their centres by each
    replica's scale, as volume moves leave them), and the sort."""
    st, nb = ctx._state, ctx._nb
    box = ctx._box_arg(st.box)
    pos = (barostat.scale_molecules_per_replica(
        ctx._spec, ctx._static, st.positions, np.asarray(scales))
        if positions is None else positions)
    rs = torch.tensor(scales, dtype=torch.float64, device=pos.device)
    nbl = nb.cellsort(pos, box, rs)
    return (nb.fields(pos, box, nbl, rep_scale=rs), nb.cfg,
            cellpair.offset_shifts(nb.cfg, box, rs), nb.alpha,
            ONE_4PI_EPS0), nbl


@KERNELS
def test_scaled_kernels_match_plain_on_card(cuda, version):
    ens = _flat(cuda, barostat=25)
    kernel = sweep if version == "b1" else sweep_chunked
    args, _ = _scaled_args(ens.context, SCALES4)
    before = dict(sweep.launches)
    f_k = kernel.pair_forces(*args)
    e_k = kernel.pair_energy(*args)
    torch.cuda.synchronize()
    for kind in ("sweep", "energy"):
        key = f"{version}_{kind}_scaled"
        assert sweep.launches[key] == before[key] + 1
    f_p = kernel.pair_forces_plain(*args)
    scale = float(torch.max(torch.abs(f_p)))
    assert float(torch.max(torch.abs(f_k - f_p))) <= 2e-5 * scale
    e_p = sweep.pair_energy_plain(*args).double()
    assert e_k.shape == (4,) and e_k.dtype == torch.float64
    # each replica within 1e-6 of the ensemble's sum |E_r| (the band
    # test's 1e-6 of |E|): on the lattice start a replica's direct-space
    # energy nearly cancels (tens of kJ/mol), below the float32 plain
    # sum's own rounding relative to it
    tol = 1e-6 * float(torch.sum(torch.abs(e_p)))
    assert float(torch.max(torch.abs(e_k - e_p))) <= tol


@KERNELS
def test_scaled_launches_are_bit_identical_and_isolated(cuda, version):
    """Two launches give the same bits (forces and per-replica
    energies); changing replica 0's scale and moving its atoms leaves the
    other replicas' forces and energies bit for bit."""
    ens = _flat(cuda, barostat=25)
    kernel = sweep if version == "b1" else sweep_chunked
    ctx = ens.context
    args, nbl = _scaled_args(ctx, SCALES4)
    fa = kernel.pair_forces(*args)
    assert torch.equal(kernel.pair_forces(*args), fa)
    ea = kernel.pair_energy(*args)
    assert torch.equal(kernel.pair_energy(*args), ea)
    n0 = ctx._state.positions.shape[0] // 4
    scales2 = (1.003,) + SCALES4[1:]
    moved = barostat.scale_molecules_per_replica(
        ctx._spec, ctx._static, ctx._state.positions, np.asarray(scales2))
    gen = torch.Generator(device="cpu").manual_seed(2)
    moved[:n0] += 0.01 * torch.randn((n0, 3), generator=gen).to(
        moved.device)
    args2, nbl2 = _scaled_args(ctx, scales2, moved)
    fb = kernel.pair_forces(*args2)[nbl2.inv_slot]
    eb = kernel.pair_energy(*args2)
    fa = fa[nbl.inv_slot]
    assert float(torch.max(torch.abs(fa[:n0] - fb[:n0]))) > 0
    assert torch.equal(fa[n0:], fb[n0:])
    assert ea[0] != eb[0] and torch.equal(ea[1:], eb[1:])


@pytest.mark.parametrize("use_pallas", [None, 3], ids=["b1", "b2"])
def test_flat_npt_steps_through_scaled_kernels(cuda, use_pallas):
    ens = _flat(cuda, {"use_pallas": use_pallas}, barostat=4)
    version = "b2" if use_pallas == 3 else "b1"
    before = dict(sweep.launches)
    ens.step(20)
    torch.cuda.synchronize()
    runs = {k: sweep.launches[k] - before[k] for k in before}
    assert runs[f"{version}_sweep_scaled"] >= 20
    assert runs[f"{version}_energy_scaled"] >= 2 * 5
    assert not any(v for k, v in runs.items() if not k.endswith("_scaled"))
    st = ens.context._state
    assert st.baro_nattempt.tolist() == [5] * 4
    s = st.rep_scale.numpy()
    assert np.all((s > 0.97) & (s < 1.03))
    assert np.all(np.isfinite(ens.group_temperatures()))


def test_flat_npt_checkpoint_replay_is_bit_exact_on_card(cuda, tmp_path):
    """A flat NPT run through B1's scaled instantiations (a move every 4
    steps): save, 32 steps, load, 32 steps give the same positions and
    scales bit for bit."""
    ens = _flat(cuda, barostat=4)
    ctx = ens.context
    ens.step(16)
    path = str(tmp_path / "flatnpt.chk")
    dt.save_checkpoint(path, ctx)
    ens.step(32)
    first = ctx._state.positions.clone()
    scales = ctx._state.rep_scale.clone()
    dt.load_checkpoint(path, ctx)
    ens.step(32)
    assert torch.equal(first, ctx._state.positions)
    assert torch.equal(scales, ctx._state.rep_scale)


# -- the force-field XML path, SHAKE clusters and the plain terms -------------

def _ff_deck(tmp_path, rigid_water=True, n_water=1000, n_ion=10):
    """A small NaCl deck through PDBFile -> ForceField -> Modeller ->
    createSystem (cutoff 0.6: a cell grid at this size), with the
    position PDB for io/nacl.load_nacl_swm4."""
    from openmm_drudenose_tpu_torch.examples import nacl_tg_ff
    system, pos = builders.build_nacl_water_box(n_water, n_ion, n_ion)
    bare, with_sites = str(tmp_path / "bare.pdb"), str(tmp_path / "pos.pdb")
    nacl_tg_ff.write_nacl_pdbs(system, pos, bare, with_sites)
    sys_f, modeller, _ = nacl_tg_ff.build(nacl_tg_ff.FFXML, bare, cutoff=0.6,
                                          rigid_water=rigid_water)
    return sys_f, np.asarray(modeller.positions), with_sites


def _ff_ctx(system, positions, device, precision="single"):
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision=precision, device=device,
                     strategy="cellpair")
    ctx.setPositions(positions)
    ctx.setVelocitiesToTemperature(300.0, seed=2)
    return ctx, integ


def test_ff_deck_matches_hand_built_and_steps_through_b1(cuda, tmp_path):
    """Phase 12 of chip_smoke.py at small size: the FF System's force
    pass against io/nacl.load_nacl_swm4's on the card, then NPT steps
    through B1 (two energy launches an attempt, no plain sweep)."""
    from openmm_drudenose_tpu_torch.io import nacl
    sys_f, pos, with_sites = _ff_deck(tmp_path)
    sys_h, _, _ = nacl.load_nacl_swm4(
        with_sites, cutoff=0.6,
        nbfix={("SOD", "CLA"): (0.31 * 2 ** (1 / 6) / 0.1, 0.20 / 4.184)},
        nbthole={("SOD", "CLA"): 2.6})
    forces = [_ff_ctx(s, pos, cuda)[0].getState(forces=True).getForces()
              for s in (sys_f, sys_h)]
    assert np.max(np.abs(forces[0] - forces[1])) \
        <= 2e-5 * np.max(np.abs(forces[1]))
    sys_f.addForce(dt.MonteCarloBarostat(1.0, 300.0, 8))
    ctx, integ = _ff_ctx(sys_f, pos, cuda)
    ctx.minimizeEnergy(maxIterations=50)
    before = dict(sweep.launches)
    plain = cellpair.plain_sweeps["cuda"]
    integ.step(32)
    torch.cuda.synchronize()
    assert sweep.launches["b1_sweep"] - before["b1_sweep"] >= 32
    assert sweep.launches["b1_energy"] - before["b1_energy"] == 2 * 4
    assert cellpair.plain_sweeps["cuda"] == plain
    st = ctx.getState(positions=True, energy=True)
    assert np.isfinite(st.getPotentialEnergy())
    # the wall holds (its Cl- Drudes may come back from past twice the
    # wall: the runaway latch reads their field, chip_smoke.py phase 12)
    spec, s_ = ctx._spec, ctx._state
    p = s_.positions.double() + s_.pos_err.double()
    drude = torch.nonzero(spec.is_pair & ~spec.is_parent)[:, 0]
    dist = torch.linalg.norm(p[drude] - p[spec.partner[drude]], dim=1)
    assert float(torch.max(dist)) <= 0.02 * 1.00001


def test_shake_clusters_step_through_b1(cuda, tmp_path):
    """Phase 13 at small size: the flexible deck (O-H constraints, no
    SETTLE) stepped on the card through B1: SHAKE leaves every constraint
    within 2 tol of its length in every step (the hard wall may move a
    bounced Drude's parent after it) and |r.v|/d^2 within tol after a
    projection; one step in f32 against f64 from the same state to 1e-5
    nm."""
    from openmm_drudenose_tpu_torch.constraints import shake
    sys_f, pos, _ = _ff_deck(tmp_path, rigid_water=False)
    ctx, integ = _ff_ctx(sys_f, pos, cuda)
    assert ctx._static.n_shake == 2000 and ctx._static.n_settle == 0
    ctx.minimizeEnergy(maxIterations=50)
    stats = shake.ShakeStats()
    ctx._stepper.shake_stats = stats
    before = sweep.launches["b1_sweep"]
    spec = ctx._spec
    i, j = spec.shake_idx[:, 0], spec.shake_idx[:, 1]
    d2 = spec.shake_dist.double() ** 2
    integ.step(32)
    assert float(torch.max(torch.stack(stats.violation))) <= 2e-5
    st = ctx._state
    r = (st.positions.double() + st.pos_err.double())[i] \
        - (st.positions.double() + st.pos_err.double())[j]
    assert sweep.launches["b1_sweep"] - before >= 32
    assert len(stats.per_call("pos")) == 32
    ctx.applyVelocityConstraints(1e-5)
    v = ctx._state.velocities.double()
    assert float(torch.max(torch.abs(torch.sum(
        r * (v[i] - v[j]), 1)) / d2)) <= 1e-5
    p0 = (ctx._state.positions.double()
          + ctx._state.pos_err.double()).cpu().numpy()
    v0 = v.cpu().numpy()
    out = []
    for precision in ("single", "double"):
        c, ig = _ff_ctx(sys_f, p0, cuda, precision)
        c.setVelocities(v0)
        ig.step(1)
        s_ = c._state
        q = s_.positions.double()
        if s_.pos_err is not None:
            q = q + s_.pos_err.double()
        out.append(q.cpu().numpy())
    assert np.max(np.abs(out[0] - out[1])) <= 1e-5


def test_plain_terms_on_card_match_cpu(cuda):
    """Phase 14: CMAP, the sites, anisotropic Drudes, every custom force,
    a setParameter scan and a System read back from its XML in float64
    on the card against the CPU (1e-10 on energies, 1e-8 on forces), and
    200 float32 steps of the custom-force system."""
    from openmm_drudenose_tpu_torch.tools import term_checks
    worst = term_checks.compare_devices(cuda)
    for name, (e, f) in worst.items():
        assert e <= 1e-10 and f <= 1e-8, name
    pos, pe = term_checks.custom_dynamics(cuda, 200, "single")
    assert np.isfinite(pe) and np.all(np.isfinite(pos))


# -- switched LJ, and the replica ensemble (chip_smoke.py phases 15-16) --

R_ON = 0.5   # the switch's start at the 216-water box's 0.6 nm cutoff


def _jitter(ctx, amount=0.02, seed=2):
    """Move every atom by up to `amount` nm: on the lattice start the
    pairs of the switching window (0.5-0.6 nm) cancel by symmetry."""
    p = ctx._state.positions.double().cpu().numpy()
    rng = np.random.default_rng(seed)
    ctx.setPositions(p + rng.uniform(-amount, amount, p.shape))
    ctx._ensure_neighbors()
    return ctx


def _switched_check(kernel, args, kw, name, geometry):
    """kernel with the switch on these fields against its plain version
    (forces 2e-5 of max|F|; energy 1e-6 of |E| against the plain energy
    under Ewald, 2e-2 kJ/mol against the plain energy in f64 under the
    reaction field, test_rf_kernels_match_plain_on_card's bound), each
    the same bits twice, counted under the "_sw" keys alone; the switch
    changes the forces (more than 1e-4 of max|F| from the unswitched
    plain version), and the switch's own effect on the LJ alone (the
    charges zeroed: switched minus unswitched kernel) is the plain
    version's in f64 to 2e-2 of that effect's max."""
    before = dict(sweep.launches)
    f1 = kernel.pair_forces(*args, **kw, r_switch=R_ON)
    f2 = kernel.pair_forces(*args, **kw, r_switch=R_ON)
    e1 = kernel.pair_energy(*args, **kw, r_switch=R_ON)
    e2 = kernel.pair_energy(*args, **kw, r_switch=R_ON)
    torch.cuda.synchronize()
    assert torch.equal(f1, f2) and torch.equal(e1, e2)
    f_p = kernel.pair_forces_plain(*args, **kw, r_switch=R_ON)
    f_u = kernel.pair_forces_plain(*args, **kw)
    fmax = float(torch.max(torch.abs(f_p)))
    assert float(torch.max(torch.abs(f1 - f_p))) <= 2e-5 * fmax
    assert float(torch.max(torch.abs(f_u - f_p))) > 1e-4 * fmax
    if kw.get("method") == "rf":
        fields, cfg, shifts, alpha, scale = args
        f64 = {k: (v.double() if v.is_floating_point() else v)
               for k, v in fields.items()}
        e_p = sweep.pair_energy_plain(f64, cfg, shifts.double(), alpha,
                                      scale, **kw, r_switch=R_ON)
        tol = 2e-2
    else:
        e_p = sweep.pair_energy_plain(*args, **kw, r_switch=R_ON).double()
        tol = 1e-6 * float(torch.sum(torch.abs(e_p)))
    assert float(torch.max(torch.abs(e1 - e_p))) <= tol
    rf = "_rf" if kw.get("method") == "rf" else ""
    for kind in ("sweep", "energy"):
        key = f"{name}_{kind}{rf}{geometry}"
        assert sweep.launches[key + "_sw"] - before[key + "_sw"] == 2
        assert sweep.launches[key] == before[key]
    fields, cfg, shifts, alpha, scale = args
    lj = dict(fields, q=torch.zeros_like(fields["q"]))
    lj_args = (lj, cfg, shifts, alpha, scale)
    d_k = (kernel.pair_forces(*lj_args, **kw, r_switch=R_ON)
           - kernel.pair_forces(*lj_args, **kw)).double()
    lj64 = {k: (v.double() if v.is_floating_point() else v)
            for k, v in lj.items()}
    a64 = (lj64, cfg, shifts.double(), alpha, scale)
    d_p = (kernel.pair_forces_plain(*a64, **kw, r_switch=R_ON)
           - kernel.pair_forces_plain(*a64, **kw))
    assert float(torch.max(torch.abs(d_k - d_p))) \
        <= 2e-2 * float(torch.max(torch.abs(d_p)))


@KERNELS
@GEOMETRIES
@pytest.mark.parametrize("method", ["ewald", "rf"])
def test_switched_kernels_match_plain_on_card(cuda, version, triclinic,
                                              method):
    ctx, _ = (_ctx(cuda, triclinic=triclinic) if method == "ewald"
              else _rf_ctx(cuda, triclinic=triclinic))
    kernel = sweep if version == "b1" else sweep_chunked
    _switched_check(kernel, _fields(_jitter(ctx)), ctx._nb.coulomb, version,
                    "")


@KERNELS
def test_switched_band_and_scaled_kernels_match_plain_on_card(cuda,
                                                              version):
    kernel = sweep if version == "b1" else sweep_chunked
    ens = _flat(cuda)
    _switched_check(kernel, _fields(_jitter(ens.context)), {}, version,
                    "_bands")
    ens = _flat(cuda, barostat=25)
    args, _ = _scaled_args(_jitter(ens.context), SCALES4)
    _switched_check(kernel, args, {}, version, "_scaled")


@pytest.mark.parametrize("use_pallas", [None, 3], ids=["b1", "b2"])
def test_switched_context_steps_through_the_switch(cuda, use_pallas):
    """A switched Context steps through the routed kernel's switched
    launches and reads its energy there; the unswitched keys stay as
    they were and no plain sweep runs on the card."""
    system, pos = builders.build_water_box(216, cutoff=0.6)
    nbf = next(f for f in system.getForces()
               if type(f).__name__ == "NonbondedForce")
    nbf.setUseSwitchingFunction(True)
    nbf.setSwitchingDistance(R_ON)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision="single", device=cuda,
                     strategy="cellpair", nb_options={"use_pallas":
                                                      use_pallas})
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, seed=1)
    name = "b2" if use_pallas == 3 else "b1"
    before = dict(sweep.launches)
    plain = cellpair.plain_sweeps["cuda"]
    integ.step(20)
    st = ctx.getState(positions=True, energy=True)
    torch.cuda.synchronize()
    assert sweep.launches[f"{name}_sweep_sw"] - before[f"{name}_sweep_sw"] \
        >= 20
    assert sweep.launches[f"{name}_energy_sw"] \
        == before[f"{name}_energy_sw"] + 1
    assert sweep.launches[f"{name}_sweep"] == before[f"{name}_sweep"]
    assert cellpair.plain_sweeps["cuda"] == plain
    assert np.all(np.isfinite(st.getPositions()))
    assert np.isfinite(st.getPotentialEnergy())


@pytest.mark.parametrize("strategy", ["dense", "cellpair"])
def test_replica_ensemble_replica_matches_context_on_card(cuda, strategy):
    """A ReplicaEnsemble in f64 on the card: replica 2 against its
    template Context stepped with the same velocities (positions to
    1e-10 nm); on the cell-pair strategy in f32 the ensemble's steps go
    through B1's band instantiation, one launch a step for all replicas,
    and the replicas stay isolated bit for bit."""
    from openmm_drudenose_tpu_torch.parallel import ensemble
    system, pos = builders.build_water_box(216, cutoff=0.6)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    integ.setMaxDrudeDistance(0.02)
    ctx = dt.Context(system, integ, precision="double", device=cuda,
                     strategy=strategy)
    ctx.setPositions(pos)
    ens = dt.ReplicaEnsemble(ctx, 3)
    ens.setVelocitiesToTemperature(300.0, seed=4)
    v = ens.velocities()
    ens.step(10)
    ctx.setVelocities(v[2])
    integ.step(10)
    np.testing.assert_allclose(ens.positions()[2], ctx.getPositions(),
                               atol=1e-10)
    if strategy == "cellpair":
        integ32 = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
        integ32.setMaxDrudeDistance(0.02)
        tpl = dt.Context(system, integ32, precision="single", device=cuda,
                         strategy="cellpair")
        tpl.setPositions(pos)
        ens32 = dt.ReplicaEnsemble(tpl, 4)
        ens32.setVelocitiesToTemperature(300.0, seed=4)
        before = sweep.launches["b1_sweep_bands"]
        ens32.step(16)
        torch.cuda.synchronize()
        # 16 steps, and the force pass the first step starts from
        assert 16 <= sweep.launches["b1_sweep_bands"] - before <= 17
        assert ensemble.check_isolated(ens32, 0) == 0.0


def test_b1_slab_range_on_card(cuda):
    """B1 with a home-slab range (parallel/sharded.py's x-slabs): each
    slab against its plain version (2e-5 of max|F|), bit-identical on a
    second launch; the full range the bits of a launch without one; the
    slabs summed against the whole (2e-5) and their energies against the
    whole energy (1e-6 of |E|); launches counted under "_slab"."""
    ctx, _ = _ctx(cuda)
    args = _fields(ctx)
    nc = args[1].n_cells
    f = sweep.pair_forces(*args)
    e = sweep.pair_energy(*args)
    assert torch.equal(sweep.pair_forces(*args, cells=(0, nc)), f)
    assert torch.equal(sweep.pair_energy(*args, cells=(0, nc)), e)
    scale = float(torch.max(torch.abs(f)))
    before = sweep.launches["b1_sweep_slab"]
    total, e_total = torch.zeros_like(f), 0.0
    for cells in ((0, 25), (25, 75), (75, nc)):
        fk = sweep.pair_forces(*args, cells=cells)
        assert torch.equal(sweep.pair_forces(*args, cells=cells), fk)
        fp = sweep.pair_forces_plain(*args, cells=cells)
        assert float(torch.max(torch.abs(fk - fp))) <= 2e-5 * scale
        total += fk
        e_total += float(sweep.pair_energy(*args, cells=cells))
    torch.cuda.synchronize()
    assert sweep.launches["b1_sweep_slab"] - before == 6
    assert float(torch.max(torch.abs(total - f))) <= 2e-5 * scale
    assert abs(e_total - float(e)) <= 1e-6 * abs(float(e))


def test_sharded_force_pass_two_ranks_on_card(cuda):
    """Two gloo ranks on cuda:0: the sharded force pass against the
    single float32 Context's (phase 2's floor, 1e-4 of max|F|; the pass
    differs only in the order of the sums), the ranks' forces the same
    bits, B1 launched on each rank's slab."""
    import torch_ranks
    from openmm_drudenose_tpu_torch.parallel import comm
    got = comm.launch(torch_ranks.sharded_card, 2, "gloo", "cuda:0", 300.0,
                      args=(512, 0.6))
    for out in got:
        assert out["grid"][0] % 2 == 0
        assert out["err"] <= 1e-4
        assert out["identical"]
        assert out["slab_launches"] >= 1


def test_resident_block_two_ranks_on_card(cuda):
    """Two gloo ranks on cuda:0, each owning a slab of molecules of a
    1000-water box (8 x-planes, 4 a slab, the w + 2 = 4 plane halo): the
    resident block's B1 launch against its plain version on the same
    block (2e-5 of max|F|, as phase 2), two launches the same bits; the
    resident force pass against the single float32 Context's (phase 2's
    floor, 1e-4 of max|F|); 4 steps through B1 alone, one resident
    launch a step."""
    import torch_ranks
    from openmm_drudenose_tpu_torch.parallel import comm
    got = comm.launch(torch_ranks.resident_card, 2, "gloo", "cuda:0",
                      300.0, args=(1000, 0.6, 4))
    for out in got:
        assert out["grid"][0] == 8
        assert out["kernel_err"] <= 2e-5
        assert out["kernel_bits"]
        assert out["kernel_launches"] == 2
        assert out["pass_err"] <= 1e-4
        assert out["step_launches"] == 4 and out["plain"] == 0
        assert out["finite"]


def test_jax_checkpoint_reader_on_card(cuda):
    """convert.py's reader puts the JAX drift run's 100k checkpoint
    (data/drift_100k_state.npz) into the bench Context on the card: every
    carried field the file's bits, the group KE reading the JAX series'
    last temperatures, and a step through B1 from it."""
    from openmm_drudenose_tpu_torch import convert
    from openmm_drudenose_tpu_torch.tools import measure_drift as md
    from openmm_drudenose_tpu_torch.tools import setups
    raw = np.load(md.JAX_STATE)
    ctx, integ = setups.bench_context(cuda)
    convert.load_jax_checkpoint(md.JAX_STATE, ctx)
    st = ctx._state
    for name, leaf in (("positions", 0), ("velocities", 1), ("forces", 2),
                       ("pos_err", 27)):
        t = getattr(st, name)
        assert t.device.type == "cuda"
        np.testing.assert_array_equal(t.cpu().numpy(), raw[f"leaf_{leaf}"])
    assert st.step == int(raw["leaf_10"])
    np.testing.assert_allclose(md.temperatures(ctx),
                               md.read_csv(md.JAX_CSV)[-1, 1:], rtol=0,
                               atol=1e-4)
    for k in sweep.launches:
        sweep.launches[k] = 0
    integ.step(16)
    assert sweep.launches["b1_sweep"] >= 16
    assert not any(md.latches(ctx).values())


def test_drift_tool_resume_is_bit_exact_through_b1(cuda, tmp_path):
    """tools/measure_drift.py's loop on the card (500 waters, the 4^3
    grid of explicit images, through B1): 4 samples in one Context
    against 2, the session's checkpoint, a fresh Context and 2 more: the
    CSV text and the state bit for bit."""
    import os
    import shutil
    from openmm_drudenose_tpu_torch.tools import measure_drift as md

    def args(name, *extra):
        return md.parse_args([
            "--equil-ps", "0", "--sample-steps", "16",
            "--ns", "0.004", "--ckpt-every", "4", "--commit", "test",
            "--csv", os.path.join(tmp_path, f"{name}.csv"),
            "--state", os.path.join(tmp_path, f"{name}.npz"), *extra])

    quiet = lambda m: None  # noqa: E731
    whole = args("whole", "--max-new-ps", "2")
    ctx, integ, rows, first = md.open_run(whole, cuda, log=quiet)
    assert ctx._cp_cfg.grid == (4, 4, 4) and not ctx._cp_cfg.regular
    rows = md.session(ctx, integ, rows, first, whole, log=quiet)
    split = args("split")
    for src, dst in ((whole.csv, split.csv), (whole.state, split.state),
                     (whole.state + ".ps", split.state + ".ps")):
        shutil.copyfile(src, dst)
    whole.max_new_ps = None
    for k in sweep.launches:
        sweep.launches[k] = 0
    rows = md.session(ctx, integ, rows, first, whole, log=quiet)
    assert sweep.launches["b1_sweep"] >= 32
    ctx2, integ2, rows2, first2 = md.open_run(split, cuda, log=quiet)
    rows2 = md.session(ctx2, integ2, rows2, first2, split, log=quiet)
    np.testing.assert_array_equal(rows2, rows)
    with open(whole.csv) as f1, open(split.csv) as f2:
        assert f1.read() == f2.read()
    for name in ("positions", "pos_err", "velocities", "group_ke"):
        assert torch.equal(getattr(ctx._state, name),
                           getattr(ctx2._state, name)), name


def test_b1_on_the_small_grid_matches_plain_on_card(cuda):
    """B1 on the 500-water 4^3 grid (offsets reaching one cell through two
    images) against its plain version: forces 2e-5 of max|F|, two
    launches bit-identical; the energy instantiation against the plain
    energy in f64; B2 refuses the grid."""
    system, pos = builders.build_water_box(500)
    integ = dt.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.1, 0.001, 20, 1)
    ctx = dt.Context(system, integ, precision="single", device=cuda,
                     strategy="cellpair")
    ctx.setPositions(pos)
    ctx._ensure_neighbors()
    nb, cfg, st = ctx._nb, ctx._cp_cfg, ctx._state
    assert cfg.grid == (4, 4, 4) and not cfg.regular
    box = torch.diagonal(st.box)
    args = (nb.fields(st.positions, box, st.neighbors), cfg,
            cellpair.offset_shifts(cfg, box), nb.alpha, ONE_4PI_EPS0)
    f, f2 = sweep.pair_forces(*args), sweep.pair_forces(*args)
    assert torch.equal(f, f2)
    ref = sweep.pair_forces_plain(*args)
    scale = float(torch.max(torch.abs(ref)))
    assert float(torch.max(torch.abs(f - ref))) <= 2e-5 * scale
    # the energy against the plain energy in f64, as
    # test_energy_kernels_match_plain_on_card holds the 216-water box to
    # 1e-3 kJ/mol (its |E| ~60 kJ/mol of ~1e4 kJ/mol terms), scaled by the
    # ~10x more pairs inside this box's 1.0 nm cutoff: 2e-2 kJ/mol (|E|
    # here ~490 kJ/mol)
    e = float(sweep.pair_energy(*args))
    f64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in args[0].items()}
    e_ref = float(sweep.pair_energy_plain(f64, cfg, args[2].double(),
                                          nb.alpha, ONE_4PI_EPS0))
    assert abs(e - e_ref) <= 2e-2
    assert sweep_chunked.b2_takes(cfg) is False
    with pytest.raises(ValueError, match="regular grids only"):
        sweep_chunked.pair_forces(*args)


def test_1m_snapshot_steps_through_b2(cuda):
    """data/bench_equil_1m.npz (tools/make_snapshot.py) in the bench
    Context (tools/setups.py::bench_context: 1,000,000 atoms, 33^3
    cells): the sweep routed to B2, 16 steps through it, B1 never, no
    latch, positions finite."""
    from openmm_drudenose_tpu_torch.tools import measure_drift as md
    from openmm_drudenose_tpu_torch.tools import setups
    ctx, integ = setups.bench_context(
        cuda, snapshot=f"{setups.ROOT}/data/bench_equil_1m.npz")
    ctx._ensure_neighbors()
    assert ctx._cp_cfg.grid == (33, 33, 33)
    assert ctx._nb.sweep_kernel == "b2"
    for k in sweep.launches:
        sweep.launches[k] = 0
    integ.step(16)
    assert sweep.launches["b2_sweep"] >= 16
    assert sweep.launches["b1_sweep"] == 0
    assert not any(md.latches(ctx).values())
    assert bool(torch.all(torch.isfinite(ctx._state.positions)))


def _chain_inputs(R, G, M, dtype, device, seed):
    """Bath constants (a _ChainSpec-like namespace, on `device`) and the
    chain's inputs of R replicas (R = 0: one set of (G+2,) baths), made
    from a seed with numpy."""
    import types
    rng = np.random.default_rng(seed)
    nb = G + 2
    lead = (R,) if R else ()
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    link = np.ones((nb, M), bool)
    link[nb - 1, 1:] = False
    spec = types.SimpleNamespace(
        nh_eta_mass=t(np.abs(rng.normal(5.0, 1.0, (nb, M)))),
        nh_nkbt=t(np.abs(rng.normal(250.0, 2.5, nb))),
        nh_kbt_chain=t(np.r_[np.full(nb - 1, 2.494), 0.008314]),
        nh_link_active=torch.as_tensor(link, device=device))
    eta_dot = rng.normal(0, 0.5, lead + (nb, M + 1))
    eta_dot[..., M] = 0.0
    chain = (t(np.abs(rng.normal(250.0, 25.0, lead + (nb,)))),
             t(rng.normal(0, 0.1, lead + (nb, M))), t(eta_dot),
             t(rng.normal(0, 0.5, lead + (nb, M))))
    cm = dict(mom=t(rng.normal(0, 5.0, lead + (3,))),
              total_mass=t(np.abs(rng.normal(1e4, 10.0, lead))), m01=1.0)
    return spec, chain, cm


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("R,G,M,steps", [(0, 1, 1, 20), (0, 2, 1, 20),
                                         (70, 1, 1, 20), (3, 2, 4, 7)])
def test_nh_chain_kernel_matches_plain_on_card(cuda, R, G, M, steps, dtype):
    """The NH chain kernel against its plain version on the card in each
    form (a half step, the fused pair with the CM correction in one
    launch, the pair in two launches around a barostat move): every
    output to 1e-12 of its scale, in f64 and in f32 (both compute in
    float64 and round to the chain's type at the same points); two
    launches the same bits."""
    import types
    from openmm_drudenose_tpu_torch.ops import nh_chain
    spec, (ke, eta, ed, edd), cm = _chain_inputs(R, G, M, dtype, cuda,
                                                 R + 10 * G + 100 * M)
    static = types.SimpleNamespace(n_temp_groups=G, n_chains=M,
                                   drude_steps=steps)
    tol = 1e-12
    F, S, C = nh_chain.FIRST, nh_chain.SECOND, nh_chain.CM

    def both(mode, ke_in, chain, **kw):
        before = nh_chain.launches["nh_chain"]
        got = nh_chain.run(spec, static, mode, ke_in, *chain, 0.001, **kw)
        again = nh_chain.run(spec, static, mode, ke_in, *chain, 0.001, **kw)
        assert nh_chain.launches["nh_chain"] == before + 2
        ref = nh_chain.run_plain(spec, static, mode, ke_in, *chain, 0.001,
                                 **kw)
        torch.cuda.synchronize()
        for g, a, r in zip(got, again, ref):
            if r is None:
                assert g is None
                continue
            assert g.dtype == dtype and g.shape == r.shape
            assert torch.equal(g, a)
            err = float(torch.max(torch.abs(g.double() - r.double())))
            assert err <= tol * max(float(torch.max(torch.abs(r.double()))),
                                    1e-300)
        return got

    chain = (eta, ed, edd)
    both(F, ke, chain)
    both(F | S | C, ke, chain, **cm)
    both(F | S, ke, chain)
    vs_a, ke_a, _, *mid = both(F | C, ke, chain, **cm)
    both(S | C, ke_a, tuple(mid), vs=vs_a, **cm)


def test_step_makes_no_sync_on_card(cuda):
    """The 216-water box through B1: 2 x 16 steps under
    torch.cuda.set_sync_debug_mode("error") (the chunk's latch read
    apart) raise nothing, and the NH chain kernel ran (a launch a half
    step and one a fused pair: 17 a 16-step block)."""
    from openmm_drudenose_tpu_torch.ops import nh_chain
    ctx, integ = _ctx(cuda)
    integ.step(16)
    torch.cuda.synchronize()
    before = nh_chain.launches["nh_chain"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        integ.step(16)
        integ.step(16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert nh_chain.launches["nh_chain"] - before == 2 * 17
    assert bool(torch.all(torch.isfinite(ctx._state.positions)))
