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
a checkpoint of a flat-ensemble run replayed bit for bit.
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
    """A config the kernels do not take (not a regular grid), and float64
    fields: the energy wrappers raise on the card and never fall back to
    the plain sweep."""
    import dataclasses
    ctx, _ = _ctx(cuda)
    fields, cfg, shifts, alpha, scale = _fields(ctx)
    bad = dataclasses.replace(cfg, regular=False)
    f64 = {k: (v.double() if v.is_floating_point() else v)
           for k, v in fields.items()}
    plain = cellpair.plain_sweeps["cuda"]
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


def _flat(device, nb_options=None):
    """Four replicas of the 216-water box (the template on the dense
    strategy) in a 2 x 2 layout: a (10, 5, 10) grid of 5^3 replica
    grids."""
    system, pos = builders.build_water_box(216, cutoff=0.6)
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
