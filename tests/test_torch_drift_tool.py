"""The port's long-run tools on the CPU: tools/measure_drift.py's loop at
a small size (100 waters, a few steps a sample) interrupted against
uninterrupted, bit for bit in the CSV and the state; its refusal to
append to a CSV without a checkpoint; --fit-only reading the CSV it is
given (the JAX script's --fit-only ignores DRIFT_CSV, ROADMAP.md C7);
the fit (tools/series.py) of the JAX run's 326 ps series reproducing
its recorded numbers; validate_npt's and validate_flatnpt's loops
resumed bit for bit."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import openmm_drudenose_tpu_torch as dt
from openmm_drudenose_tpu_torch.tools import measure_drift as md
from openmm_drudenose_tpu_torch.tools import series
from openmm_drudenose_tpu_torch.tools import validate_flatnpt as vf
from openmm_drudenose_tpu_torch.tools import validate_npt as vn

# a small run: 100 waters at a 0.45 nm cutoff (tests/test_torch_flatnpt.py's
# small replica), SAMPLE_STEPS steps a sample, SAMPLES samples
N_MOL, CUTOFF = 100, 0.45
SAMPLE_STEPS, SAMPLES = 3, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def short_fire(monkeypatch):
    """A fresh start's FIRE cut from the tools' 300 iterations to 5 (the
    lattice only has to be stepped, not equilibrated, here)."""
    fire = dt.Context.minimizeEnergy
    monkeypatch.setattr(dt.Context, "minimizeEnergy",
                        lambda self, tolerance=10.0, maxIterations=500:
                        fire(self, tolerance, min(maxIterations, 5)))


def _args(tmp_path, name, *extra):
    return md.parse_args([
        "--molecules", str(N_MOL), "--cutoff", str(CUTOFF),
        "--equil-ps", "0",
        "--sample-steps", str(SAMPLE_STEPS), "--ns", str(SAMPLES / 1000),
        "--ckpt-every", str(SAMPLES), "--commit", "test",
        "--csv", os.path.join(tmp_path, f"{name}.csv"),
        "--state", os.path.join(tmp_path, f"{name}.npz"), *extra])


def _quiet(msg):
    pass


def test_drift_loop_resumes_bit_for_bit(tmp_path, short_fire):
    """SAMPLES samples in one Context against half of them, the session's
    checkpoint, a fresh Context resumed from it and the other half: the
    same CSV text, positions, compensation, velocities and chain."""
    half = SAMPLES // 2
    whole = _args(tmp_path, "whole", "--max-new-ps", str(half))
    ctx, integ, rows, first = md.open_run(whole, "cpu", log=_quiet)
    assert first == 0 and len(rows) == 0
    rows = md.session(ctx, integ, rows, first, whole, log=_quiet)
    assert rows[:, 0].tolist() == list(range(1, half + 1))
    with open(whole.state + ".ps") as f:
        assert int(f.read()) == half
    split = _args(tmp_path, "split")
    for src, dst in ((whole.csv, split.csv), (whole.state, split.state),
                     (whole.state + ".ps", split.state + ".ps")):
        shutil.copyfile(src, dst)
    whole.max_new_ps = None
    rows = md.session(ctx, integ, rows, first, whole, log=_quiet)
    assert rows[:, 0].tolist() == list(range(1, SAMPLES + 1))
    ctx2, integ2, rows2, first2 = md.open_run(split, "cpu", log=_quiet)
    assert len(rows2) == half and ctx2._state.step == half * SAMPLE_STEPS
    rows2 = md.session(ctx2, integ2, rows2, first2, split, log=_quiet)
    np.testing.assert_array_equal(rows2, rows)
    with open(whole.csv) as f1, open(split.csv) as f2:
        assert f1.read() == f2.read()
    a, b = ctx._state, ctx2._state
    for name in ("positions", "pos_err", "velocities", "eta", "eta_dot",
                 "group_ke"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert np.all(np.isfinite(rows[:, 1:]))


def test_drift_tool_drops_samples_past_the_checkpoint(tmp_path, short_fire):
    """A killed session can leave the CSV ahead of the state: the next
    call drops the rows past the marker before it resumes."""
    args = _args(tmp_path, "run", "--max-new-ps", "1")
    ctx, integ, rows, first = md.open_run(args, "cpu", log=_quiet)
    md.session(ctx, integ, rows, first, args, log=_quiet)
    with open(args.csv, "a") as f:
        f.write("2, 1.0, 2.0, 3.0\n")
    args.max_new_ps = None
    ctx2, _, rows2, _ = md.open_run(args, "cpu", log=_quiet)
    assert rows2[:, 0].tolist() == [1.0]
    assert md.read_csv(args.csv)[:, 0].tolist() == [1.0]


@pytest.mark.parametrize("where", ["steps", "row"])
def test_sigterm_leaves_csv_and_checkpoint_consistent(tmp_path, short_fire,
                                                      monkeypatch, where):
    """A SIGTERM in the second sample's steps ends the session there with
    the first sample's checkpoint standing; one while the second row is
    written waits for the row and checkpoints it.  Either way the next
    call resumes from a state whose marker is the CSV's last row."""
    import signal
    args = _args(tmp_path, "term", "--ckpt-every", "1")
    ctx, integ, rows, first = md.open_run(args, "cpu", log=_quiet)
    step, calls = integ.step, {"steps": 0, "row": 0}
    handler = signal.getsignal(signal.SIGTERM)

    def term_once(kind):
        calls[kind] += 1
        if kind == where and calls[kind] == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    def stepped(n):
        term_once("steps")
        step(n)

    def sample(c):
        term_once("row")
        return md.temperatures(c)

    monkeypatch.setattr(integ, "step", stepped)
    run = lambda: md.sample_loop(  # noqa: E731
        ctx, integ, rows, first, first + SAMPLES, sample, args,
        SAMPLE_STEPS, log=_quiet)
    if where == "steps":
        with pytest.raises(KeyboardInterrupt):
            run()
        done = 1
    else:
        try:
            out = run()
        except KeyboardInterrupt:
            pytest.fail("a SIGTERM between the steps escaped the loop")
        assert out[:, 0].tolist() == [1.0, 2.0]
        done = 2
    assert signal.getsignal(signal.SIGTERM) is handler
    with open(args.state + ".ps") as f:
        assert int(f.read()) == done
    assert md.read_csv(args.csv)[:, 0].tolist() == list(range(1, done + 1))
    ctx2, _, rows2, _ = md.open_run(args, "cpu", log=_quiet)
    assert rows2[:, 0].tolist() == list(range(1, done + 1))
    assert ctx2._state.step == done * SAMPLE_STEPS


def test_drift_tool_refuses_a_csv_without_checkpoint(tmp_path):
    args = _args(tmp_path, "orphan")
    with open(args.csv, "w") as f:
        f.write(md.COLUMNS + "1, 300.0, 300.0, 1.0\n")
    with pytest.raises(SystemExit, match="no checkpoint"):
        md.open_run(args, "cpu", log=_quiet)
    assert md.read_csv(args.csv).shape == (1, 4)


@pytest.mark.parametrize("snapshot", [False, True])
def test_fit_only_reads_the_csv_it_is_given(tmp_path, capsys, snapshot):
    """--fit-only fits the file named by --csv, with or without
    --snapshot (whose default CSV it must not read instead)."""
    rng = np.random.default_rng(3)
    path = os.path.join(tmp_path, "given.csv")
    t = 300.0 + rng.normal(0.0, 1.5, (40, 2))
    d = 1.0 + rng.normal(0.0, 0.05, (40, 1))
    rows = np.concatenate([np.arange(1, 41)[:, None], t, d], axis=1)
    with open(path, "w") as f:
        f.write("# a hand-made series\n" + md.COLUMNS)
        for r in rows:
            f.write(", ".join(f"{v:.6f}" for v in r) + "\n")
    argv = ["--fit-only", "--csv", path] + (["--snapshot"] if snapshot
                                            else [])
    assert md.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["csv"]["label"] == "given.csv"
    assert out["csv"]["samples"] == 40
    np.testing.assert_allclose(out["csv"]["baths"]["Drude"]["mean"],
                               d.mean(), rtol=1e-6)   # the CSV's 6 decimals
    with pytest.raises(SystemExit, match="no samples CSV"):
        md.main(["--fit-only", "--csv", os.path.join(tmp_path, "none.csv")])


def test_fit_of_the_jax_series_reproduces_its_numbers():
    """The JAX run's 326 ps (data/drift_100k_samples.csv): bath means
    299.9505 / 300.0262 / 0.9997 K, per-ps sd 1.654 / 1.648 / 0.0549 K,
    OLS drift -0.672 +- 0.976 / +0.317 +- 0.973 / +0.002 +- 0.032 K/ns,
    AR(1) rho 0.109 / -0.041 / -0.155, each to its last printed digit."""
    rows = md.read_csv(md.JAX_CSV)
    assert rows.shape == (326, 4)
    fits = md.fits(rows)
    want = {"mean": ((299.9505, 300.0262, 0.9997), 5e-5),
            "sd": ((1.654, 1.648, 0.0549), 5e-4),
            "drift": ((-0.672, 0.317, 0.002), 5e-4),
            "drift_se": ((0.976, 0.973, 0.032), 5e-4),
            "rho": ((0.109, -0.041, -0.155), 5e-4)}
    for key, (vals, tol) in want.items():
        got = [f[key] for f in fits]
        np.testing.assert_allclose(got, vals, rtol=0, atol=tol,
                                   err_msg=key)


def test_block_se_and_bands():
    """series.block_se on white noise: the plain SE of 5-sample blocks
    near sd / sqrt(n); the AR(1) factor only widens; `within`'s band."""
    rng = np.random.default_rng(11)
    x = rng.normal(0.0, 2.0, 5000)
    se, rho, plain = series.block_se(x, 5)
    assert se >= plain
    np.testing.assert_allclose(plain, 2.0 / np.sqrt(5000), rtol=0.1)
    assert series.inflation(-0.5) == 1.0
    np.testing.assert_allclose(series.inflation(0.6), 2.0, rtol=1e-12)
    assert series.within(1.0, 0.0, 0.3, 0.4) == (True, 1.5)
    assert series.within(1.6, 0.0, 0.3, 0.4)[0] is False


def test_validate_npt_loop_resumes_bit_for_bit(tmp_path, short_fire):
    """validate_npt's rows every few steps, cut by its budget and resumed
    from the checkpoint, against one run: the same rows and state."""
    def args(name, budget=None):
        argv = ["--molecules", str(N_MOL), "--cutoff", str(CUTOFF),
                "--equil-ps", "1", "--sample-ps", "1", "--csv",
                os.path.join(tmp_path, f"{name}.csv"), "--state",
                os.path.join(tmp_path, f"{name}.npz")]
        return vn.parse_args(argv + (["--budget-s", str(budget)]
                                     if budget is not None else []))
    a = args("one")
    ctx, integ, n_mol, mass, rows = vn.open_run(a, "cpu", log=_quiet)
    one = vn.session(ctx, integ, n_mol, mass, rows, a, steps=2,
                     log=_quiet)
    b = args("cut", budget=0.0)
    ctx2, integ2, _, _, rows2 = vn.open_run(b, "cpu", log=_quiet)
    rows2 = vn.session(ctx2, integ2, n_mol, mass, rows2, b, steps=2,
                       log=_quiet)
    assert len(rows2) == 1
    ctx3, integ3, _, _, rows3 = vn.open_run(b, "cpu", log=_quiet)
    rows3 = vn.session(ctx3, integ3, n_mol, mass, rows3, b, steps=2,
                       log=_quiet)
    np.testing.assert_array_equal(rows3, one)
    assert one.shape == (2, vn.NCOLS)
    assert torch.equal(ctx3._state.positions, ctx._state.positions)
    assert 0.9 < one[0, 1] < 1.1 and np.all(np.isfinite(one))
    res = vn.summary(np.concatenate([one] * 10), 0.0, log=_quiet)
    assert set(res) == {"sample_ps", "rho", "u", "t_drude"}


def test_validate_flatnpt_run_resumes_bit_for_bit(tmp_path, monkeypatch):
    """validate_flatnpt's loop (2 replicas, 4 chunks of 5 steps), cut by
    its budget after every chunk and resumed, against one run."""
    monkeypatch.setattr(vf, "N_CHUNKS", 4)
    state = os.path.join(tmp_path, "flat.npz")
    ens, _ = vf.build(2, N_MOL, "cpu", cutoff=CUTOFF)
    lay = vf.layout(ens)
    assert lay["layout"] == [1, 2] and lay["pad"] == 0
    one = vf.run(ens, 0, 0.2, steps_per_ps=100, log=_quiet)
    assert one.shape == (4, 2)
    got, cuts = None, 0
    while got is None:
        ens2, _ = vf.build(2, N_MOL, "cpu", cutoff=CUTOFF)
        got = vf.run(ens2, 0, 0.2, steps_per_ps=100, state=state,
                     budget_s=0.0, log=_quiet)
        cuts += 1
    assert cuts == 4
    np.testing.assert_array_equal(got, one)
    res = vf.summary(one, ens.context._state.rep_scale.numpy(), log=_quiet)
    assert res["replicas_in_band"]


@pytest.mark.parametrize("tool", [md, vn, vf],
                         ids=["measure_drift", "validate_npt",
                              "validate_flatnpt"])
def test_tools_refuse_to_run_without_cuda(tmp_path, capsys, tool):
    """The card entry points exit 1 where there is no CUDA device; they do
    not go on on the CPU (and write nothing)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would run")
    argv = {md: ["--snapshot"], vn: [], vf: []}[tool] + (
        ["--csv", os.path.join(tmp_path, "x.csv"), "--state",
         os.path.join(tmp_path, "x.npz")] if tool is not vf else
        ["--state", os.path.join(tmp_path, "x.npz")])
    assert tool.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []
