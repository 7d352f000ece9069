"""The port's ForceField / Modeller / createSystem against the JAX
package's, both in float64 on the CPU: the same force-field XML and the
same PDB give the same System (the two packages' System XML, which lists
every particle, constraint, site, exclusion and Drude row, is the same
text), and the FF System's energy and forces in a port Context equal the
JAX Context's (1e-10 relative on energy, 1e-8 on forces, as JAX
tests/test_forcefield.py:193-208).  The decks are the JAX tests':
swm4_nacl.xml (rigid and flexible water), chain.xml, the hoh_patch
stacks, the two- and three-residue patch decks, graph-matched renamed
residues, both CHARMM LJ-table encodings, the CMAP deck and the general
custom deck."""

import os
import types

import numpy as np
import pytest

import openmm_drudenose_tpu as dn
import openmm_drudenose_tpu_torch as dt
import test_cmap as jcmap
import test_custom_ingestion as jci
import test_forcefield as jtf
from openmm_drudenose_tpu.app import forcefield as jff
from openmm_drudenose_tpu.app import serialization as jser
from openmm_drudenose_tpu.io import pdbfile as jpdb
from openmm_drudenose_tpu_torch.app import forcefield as tff
from openmm_drudenose_tpu_torch.app import serialization as tser
from openmm_drudenose_tpu_torch.io import pdbfile as tpdb
from torch_threads import _one_thread  # noqa: F401

DATA = jtf.DATA
JAX = types.SimpleNamespace(ff=jff, pdb=jpdb, pkg=dn, ser=jser,
                            ctx_kw={})
PORT = types.SimpleNamespace(ff=tff, pdb=tpdb, pkg=dt, ser=tser,
                             ctx_kw={"device": "cpu"})


def _from_pdb(pk, xmls, pdb_path, rigid=True, cutoff=0.9, repartition=True):
    ff = pk.ff.ForceField(*xmls)
    pdb = pk.pdb.PDBFile(pdb_path)
    modeller = pk.ff.Modeller(pdb.topology, pdb.positions)
    modeller.addExtraParticles(ff)
    system = ff.createSystem(modeller.topology, nonbondedMethod=pk.ff.PME,
                             nonbondedCutoff=cutoff,
                             constraints=pk.ff.HBonds, rigidWater=rigid)
    if repartition:
        jtf._repartition(system, modeller.topology)
    return system, np.asarray(modeller.positions, np.float64)


def _water_entries(seed, centers, last_names):
    rng = np.random.default_rng(seed)
    entries = []
    for o in centers[:-1]:
        w = jtf._water_sites(o, jtf._rotation(rng))
        entries.append(("HOH", list(zip(["OH2", "H1", "H2"], w[:3]))))
    w = jtf._water_sites(centers[-1], jtf._rotation(rng))
    entries.append(("HOH", list(zip(last_names, w))))
    return entries


CENTERS = [np.array([0.6, 0.6, 0.6]), np.array([1.6, 1.0, 1.0]),
           np.array([1.0, 1.7, 1.6])]
BOX = np.array([2.4, 2.4, 2.4])


def _nacl(rigid):
    def build(pk, tmp_path):
        _, bare = jtf._make_nacl_files(tmp_path)
        return _from_pdb(pk, [os.path.join(DATA, "swm4_nacl.xml")], bare,
                         rigid=rigid)
    return build


def _lj_table(variant):
    def build(pk, tmp_path):
        _, bare = jtf._make_nacl_files(tmp_path)
        return _from_pdb(pk, [jtf._custom_nb_xml(tmp_path, variant)], bare)
    return build


def _patch(names, xmls, seed):
    def build(pk, tmp_path):
        path = str(tmp_path / "patched.pdb")
        jtf._write_pdb(path, _water_entries(seed, CENTERS, names), BOX)
        return _from_pdb(pk, [os.path.join(DATA, x) for x in xmls], path,
                         repartition=False)
    return build


def _renamed(pk, tmp_path):
    rng = np.random.default_rng(5)
    entries = []
    for o in CENTERS:
        w = jtf._water_sites(o, jtf._rotation(rng))
        entries.append(("WAT", [(n, e, x) for (n, e), x in zip(
            [("OW1", "O"), ("HA", "H"), ("HB", "H")], w[:3])]))
    path = str(tmp_path / "renamed.pdb")
    jtf._write_pdb_elems(path, entries, BOX)
    return _from_pdb(pk, [os.path.join(DATA, "swm4_nacl.xml")], path,
                     repartition=False)


def _spread_positions(n, seed):
    """Atoms 0.15 nm apart along a bent walk with jitter (no overlaps)."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3))
    for i in range(1, n):
        step = np.array([0.15, 0.05 * (-1) ** i, 0.03 * (i % 3 - 1)])
        pos[i] = pos[i - 1] + step + rng.normal(0, 0.01, 3)
    return pos


def _topology(pk, rows):
    """rows: (atom name, residue name, residue number, element)."""
    return pk.pdb.PDBTopology([pk.pdb.PDBAtom(i + 1, nm, res, "A", seq, el)
                               for i, (nm, res, seq, el) in enumerate(rows)])


def _no_cutoff(pk, xml_path, rows, positions=None):
    ff = pk.ff.ForceField(xml_path)
    system = ff.createSystem(_topology(pk, rows),
                             nonbondedMethod=pk.ff.NoCutoff,
                             constraints=None, removeCMMotion=False,
                             **({} if positions is None
                                else {"positions": positions}))
    return system, (positions if positions is not None
                    else _spread_positions(len(rows), 3))


def _chain(pk, tmp_path):
    rows = [(f"A{i + 1}", "BUT", 1, "C") for i in range(4)]
    return _no_cutoff(pk, os.path.join(DATA, "chain.xml"), rows)


def _disu(pk, tmp_path):
    out = tmp_path / "disu.xml"
    out.write_text(jtf._DISU_XML)
    rows = [(nm, "THL", r + 1, el) for r in range(4)
            for nm, el in (("C1", "C"), ("S1", "S"))]
    pos = np.array([[0.0, 0.0, 0.0], [0.2, 0.0, 0.0], [2.0, 0.0, 0.0],
                    [1.8, 0.0, 0.0], [1.4, 0.1, 0.0], [1.6, 0.1, 0.0],
                    [0.6, 0.1, 0.1], [0.4, 0.1, 0.1]])
    return _no_cutoff(pk, str(out), rows, pos)


def _tri(pk, tmp_path):
    out = tmp_path / "tri.xml"
    out.write_text(jtf._TRI_XML)
    rows = []
    rid = 1
    for _ in range(2):
        for res, (cn, sn) in (("RA", ("CA1", "SA1")), ("RB", ("CB1", "SB1")),
                              ("RC", ("CC1", "SC1"))):
            rows += [(cn, res, rid, "C"), (sn, res, rid, "S")]
            rid += 1
    far = 10.0
    pos = np.array([[0.0, 0, 0], [0.2, 0, 0], [far + 1.0, 0, 0],
                    [far + 0.8, 0.1, 0], [0.8, 0.1, 0.1], [0.6, 0, 0.05],
                    [far, 0.2, 0], [far + 0.2, 0, 0.1], [1.0, 0.2, 0],
                    [0.4, 0.15, 0.02], [far + 1.4, 0.1, 0],
                    [far + 0.6, 0.2, 0.1]])
    return _no_cutoff(pk, str(out), rows, pos)


def _cmap(pk, tmp_path):
    rows = [(f"A{i + 1}", "PEN", 1, "C") for i in range(6)]
    pos = np.vstack([jcmap._chain_positions(np.random.default_rng(4)),
                     [[0.25, 0.25, -0.12]]])
    return _no_cutoff(pk, jcmap._write_cmap_xml(tmp_path), rows, pos)


def _custom(pk, tmp_path):
    xml = tmp_path / "custom_deck.xml"
    xml.write_text(jci.DECK)
    rows = [(nm, "MOL", 1, "C") for nm in ("C1", "C2", "C3", "C4")]
    ff = pk.ff.ForceField(str(xml))
    return ff.createSystem(_topology(pk, rows)), jci.POS.copy()


# four polarizable atoms in a chain, each with its Drude (the first
# anisotropic along one axis: with aniso34 = 3 - aniso12 - aniso34 the
# second axis has k2 = 0; a second axis beside isotropic rows is C20):
# Thole screened pairs between the Drudes of 1-2 and 1-3 bonded parents,
# none for 1-4
_DRUDE_CHAIN_XML = """<ForceField>
  <AtomTypes>
    <Type name="tA" class="CA" element="C" mass="12.011"/>
    <Type name="tB" class="CB" element="C" mass="12.011"/>
    <Type name="tC" class="CC" element="C" mass="12.011"/>
    <Type name="tD" class="CD" element="C" mass="12.011"/>
    <Type name="dA" class="DA" mass="0"/>
    <Type name="dB" class="DB" mass="0"/>
    <Type name="dC" class="DC" mass="0"/>
    <Type name="dD" class="DD" mass="0"/>
  </AtomTypes>
  <Residues>
    <Residue name="CHN">
      <Atom name="C1" type="tA" charge="0.9"/>
      <Atom name="C2" type="tB" charge="0.6"/>
      <Atom name="C3" type="tC" charge="0.6"/>
      <Atom name="C4" type="tD" charge="0.9"/>
      <Atom name="D1" type="dA" charge="-1.0"/>
      <Atom name="D2" type="dB" charge="-0.6"/>
      <Atom name="D3" type="dC" charge="-0.6"/>
      <Atom name="D4" type="dD" charge="-0.8"/>
      <Bond atomName1="C1" atomName2="C2"/>
      <Bond atomName1="C2" atomName2="C3"/>
      <Bond atomName1="C3" atomName2="C4"/>
    </Residue>
  </Residues>
  <HarmonicBondForce>
    <Bond class1="CA" class2="CB" length="0.15" k="200000"/>
    <Bond class1="CB" class2="CC" length="0.15" k="200000"/>
    <Bond class1="CC" class2="CD" length="0.15" k="200000"/>
  </HarmonicBondForce>
  <HarmonicAngleForce>
    <Angle class1="CA" class2="CB" class3="CC" angle="1.9" k="300"/>
    <Angle class1="CB" class2="CC" class3="CD" angle="1.9" k="300"/>
  </HarmonicAngleForce>
  <NonbondedForce coulomb14scale="0.5" lj14scale="0.5">
    <UseAttributeFromResidue name="charge"/>
    <Atom type="tA" sigma="0.35" epsilon="0.3"/>
    <Atom type="tB" sigma="0.35" epsilon="0.3"/>
    <Atom type="tC" sigma="0.35" epsilon="0.3"/>
    <Atom type="tD" sigma="0.35" epsilon="0.3"/>
    <Atom type="dA" sigma="1.0" epsilon="0"/>
    <Atom type="dB" sigma="1.0" epsilon="0"/>
    <Atom type="dC" sigma="1.0" epsilon="0"/>
    <Atom type="dD" sigma="1.0" epsilon="0"/>
  </NonbondedForce>
  <DrudeForce>
    <Particle type1="dA" type2="tA" type3="tB" type4="tC" type5="tD"
              charge="-1.0" polarizability="0.0012" thole="1.1"
              aniso12="0.8" aniso34="1.1"/>
    <Particle type1="dB" type2="tB" charge="-0.6" polarizability="0.001"
              thole="1.3"/>
    <Particle type1="dC" type2="tC" charge="-0.6" polarizability="0.001"
              thole="1.3"/>
    <Particle type1="dD" type2="tD" charge="-0.8" polarizability="0.0011"
              thole="1.2"/>
  </DrudeForce>
</ForceField>
"""


def _drude_chain(pk, tmp_path):
    xml = tmp_path / "drude_chain.xml"
    xml.write_text(_DRUDE_CHAIN_XML)
    rows = [(f"C{k + 1}", "CHN", r + 1, "C") for r in range(3)
            for k in range(4)]
    pos = np.vstack([_spread_positions(4, 7 + r) + [0.9 * r, 0.0, 0.0]
                     for r in range(3)])
    ff = pk.ff.ForceField(str(xml))
    m = pk.ff.Modeller(_topology(pk, rows), pos)
    m.addExtraParticles(ff)
    system = ff.createSystem(m.topology, nonbondedMethod=pk.ff.NoCutoff,
                             constraints=None, removeCMMotion=False)
    jtf._repartition(system, m.topology)
    return system, np.asarray(m.positions, np.float64)


CASES = {
    "swm4_nacl": _nacl(True), "swm4_nacl_flexible": _nacl(False),
    "lj_table_stock": _lj_table(False), "lj_table_normalized": _lj_table(True),
    "hoh_patch": _patch(["OH2", "H1"], ["swm4_nacl.xml", "hoh_patch.xml"],
                        11),
    "hoh_patch_stack": _patch(["OH2"], ["swm4_nacl.xml", "hoh_patch.xml",
                                        "hoh_patch2.xml"], 13),
    "renamed_graph_match": _renamed, "chain": _chain,
    "two_residue_patch": _disu, "three_residue_patch": _tri, "cmap": _cmap,
    "custom_deck": _custom, "drude_chain": _drude_chain,
}


def _both(case, tmp_path):
    sj, pos_j = CASES[case](JAX, tmp_path)
    st, pos_t = CASES[case](PORT, tmp_path)
    np.testing.assert_array_equal(pos_j, pos_t)
    return sj, st, pos_t


@pytest.mark.parametrize("case", sorted(CASES))
def test_ff_system_equals_jax(case, tmp_path):
    sj, st, _ = _both(case, tmp_path)
    assert st.getNumParticles() == sj.getNumParticles()
    assert st.getNumConstraints() == sj.getNumConstraints()
    assert [type(f).__name__ for f in st.getForces()] == \
        [type(f).__name__ for f in sj.getForces()]
    for i in range(sj.getNumParticles()):
        assert st.getParticleMass(i) == sj.getParticleMass(i)
        assert st.isVirtualSite(i) == sj.isVirtualSite(i)
    # every particle, constraint, site, exclusion and Drude row
    assert tser.serialize_system(st) == jser.serialize_system(sj)


def _with_drude(pk, system, pos):
    """A Context needs a DrudeForce: where the deck has none, one far,
    neutral Drude pair joins the System (the same in both packages)."""
    if any(type(f).__name__ == "DrudeForce" for f in system.getForces()):
        return pos
    core = system.addParticle(10.0)
    shell = system.addParticle(0.4)
    for f in system.getForces():
        if type(f).__name__ == "NonbondedForce":
            f.addParticle(0.0, 0.3, 0.0)
            f.addParticle(0.0, 0.3, 0.0)
            f.addException(core, shell, 0.0, 1.0, 0.0)
        elif type(f).__name__ == "CustomNonbondedForce":
            f.addParticle([0.0] * f.getNumPerParticleParameters())
            f.addParticle([0.0] * f.getNumPerParticleParameters())
            f.addExclusion(core, shell)
    drude = pk.pkg.DrudeForce()
    drude.addParticle(shell, core, -1, -1, -1, -1.0, 0.001, 1, 1)
    system.addForce(drude)
    return np.vstack([pos, [[5.0, 5.0, 5.0], [5.01, 5.0, 5.0]]])


def _energy_forces(pk, system, pos):
    integ = pk.pkg.DrudeTGNHIntegrator(300.0, 0.1, 1.0, 0.005, 0.001, 20,
                                       1)
    ctx = pk.pkg.Context(system, integ, precision="double", **pk.ctx_kw)
    ctx.setPositions(pos)
    st = ctx.getState(energy=True, forces=True)
    return st.getPotentialEnergy(), np.asarray(st.getForces())


@pytest.mark.parametrize("case", ["swm4_nacl", "swm4_nacl_flexible",
                                  "lj_table_stock", "hoh_patch_stack",
                                  "chain", "three_residue_patch", "cmap",
                                  "custom_deck", "drude_chain"])
def test_ff_energy_and_forces_equal_jax(case, tmp_path):
    sj, st, pos = _both(case, tmp_path)
    pos_j = _with_drude(JAX, sj, pos)
    pos_t = _with_drude(PORT, st, pos)
    e_j, f_j = _energy_forces(JAX, sj, pos_j)
    e_t, f_t = _energy_forces(PORT, st, pos_t)
    assert e_t == pytest.approx(e_j, rel=1e-10)
    np.testing.assert_allclose(f_t, f_j, rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(f_j)))


def test_ff_system_matches_hand_built(tmp_path):
    """The JAX package's pin: the FF System equals io/nacl.load_nacl_swm4
    of the position PDB term by term, here for the port's two paths."""
    from openmm_drudenose_tpu_torch.io import nacl
    pos_pdb, bare = jtf._make_nacl_files(tmp_path)
    sys_f, pos = _from_pdb(PORT, [os.path.join(DATA, "swm4_nacl.xml")], bare)
    rmin_a = jtf.NBFIX_SIGMA * 2 ** (1 / 6) / 0.1
    sys_h, positions, _ = nacl.load_nacl_swm4(
        pos_pdb, cutoff=0.9,
        nbfix={("SOD", "CLA"): (rmin_a, jtf.NBFIX_EPS / 4.184)},
        nbthole={("SOD", "CLA"): jtf.NBTHOLE_A})
    n = sys_h.getNumParticles()
    assert sys_f.getNumParticles() == n
    np.testing.assert_allclose([sys_f.getParticleMass(i) for i in range(n)],
                               [sys_h.getParticleMass(i) for i in range(n)],
                               atol=1e-12)
    con = lambda s: {(*sorted(s.getConstraintParameters(i)[:2]),
                      round(s.getConstraintParameters(i)[2], 9))
                     for i in range(s.getNumConstraints())}
    assert con(sys_f) == con(sys_h)
    nb = lambda s: next(f for f in s.getForces()
                        if isinstance(f, dt.NonbondedForce))
    exc = lambda f: {tuple(sorted(f.getExceptionParameters(i)[:2]))
                     for i in range(f.getNumExceptions())}
    assert exc(nb(sys_f)) == exc(nb(sys_h))
    e_f, f_f = _energy_forces(PORT, sys_f, positions)
    e_h, f_h = _energy_forces(PORT, sys_h, positions)
    assert e_f == pytest.approx(e_h, rel=1e-10)
    np.testing.assert_allclose(f_f, f_h, rtol=1e-8, atol=1e-8)


def test_switched_lj_deck_runs_in_a_context(tmp_path):
    """createSystem(switchDistance=...) builds the System as the JAX one
    does, and a Context of it compiles the switch and matches the JAX
    Context's f64 energy (1e-10) and forces (1e-8 of max|F|)."""
    _, bare = jtf._make_nacl_files(tmp_path)
    systems = []
    for pk in (JAX, PORT):
        ff = pk.ff.ForceField(os.path.join(DATA, "swm4_nacl.xml"))
        pdb = pk.pdb.PDBFile(bare)
        m = pk.ff.Modeller(pdb.topology, pdb.positions)
        m.addExtraParticles(ff)
        systems.append(ff.createSystem(
            m.topology, nonbondedMethod=pk.ff.PME, nonbondedCutoff=0.9,
            constraints=pk.ff.HBonds, switchDistance=0.8))
    assert tser.serialize_system(systems[1]) == \
        jser.serialize_system(systems[0])
    nb = next(f for f in systems[1].getForces()
              if isinstance(f, dt.NonbondedForce))
    assert nb.getUseSwitchingFunction() and nb.getSwitchingDistance() == 0.8
    pos = np.asarray(m.positions, np.float64)
    e_j, f_j = _energy_forces(JAX, systems[0], pos)
    e_t, f_t = _energy_forces(PORT, systems[1], pos)
    assert e_t == pytest.approx(e_j, rel=1e-10)
    np.testing.assert_allclose(f_t, f_j, rtol=0,
                               atol=1e-8 * np.abs(f_j).max())


def test_errors_as_jax(tmp_path):
    bad = tmp_path / "bad.xml"
    bad.write_text("<ForceField><MysteryForce/></ForceField>")
    for pk in (JAX, PORT):
        with pytest.raises(pk.ff.ForceFieldError, match="MysteryForce"):
            pk.ff.ForceField(str(bad))
        ff = pk.ff.ForceField(os.path.join(DATA, "swm4_nacl.xml"))
        with pytest.raises(pk.ff.ForceFieldError,
                           match="no residue template"):
            ff.match_template("XYZ", ["Q1", "Q2"])
        with pytest.raises(pk.ff.ForceFieldError,
                           match="positions unavailable"):
            ff.match_residue("WAT", ["OW1", "HA", "HB"], ["O", "H", "H"],
                             None)
    out = tmp_path / "disu.xml"
    out.write_text(jtf._DISU_XML)
    rows = [(nm, "THL", r + 1, el) for r in range(3)
            for nm, el in (("C1", "C"), ("S1", "S"))]
    for pk in (JAX, PORT):
        with pytest.raises(pk.ff.ForceFieldError, match="odd"):
            pk.ff.ForceField(str(out)).createSystem(
                _topology(pk, rows), nonbondedMethod=pk.ff.NoCutoff,
                constraints=None, removeCMMotion=False,
                positions=np.zeros((6, 3)))
    import xml.etree.ElementTree as ET
    tree = ET.parse(os.path.join(DATA, "swm4_nacl.xml"))
    root = tree.getroot()
    root.remove(root.find("LennardJonesForce"))
    cnb = ET.SubElement(root, "CustomNonbondedForce",
                        attrib={"energy": "k*exp(-r/rho)"})
    ET.SubElement(cnb, "PerParticleParameter", name="type")
    undeclared = str(tmp_path / "bad_custom.xml")
    tree.write(undeclared)
    for pk in (JAX, PORT):
        with pytest.raises(pk.ff.ForceFieldError, match="unknown name"):
            pk.ff.ForceField(undeclared)


def test_modeller_places_extra_particles_as_jax(tmp_path):
    _, bare = jtf._make_nacl_files(tmp_path)
    out = []
    for pk in (JAX, PORT):
        ff = pk.ff.ForceField(os.path.join(DATA, "swm4_nacl.xml"))
        pdb = pk.pdb.PDBFile(bare)
        m = pk.ff.Modeller(pdb.topology, pdb.positions)
        m.addExtraParticles(ff)
        out.append(([(a.name, a.res_name) for a in m.topology.atoms],
                    np.asarray(m.positions)))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_example_runs_on_cpu(tmp_path):
    """examples/nacl_tg_ff.py on a small generated box: the bare PDB it
    writes goes through PDBFile -> ForceField -> Modeller ->
    createSystem, then minimize and NPT steps in single precision."""
    import io as io_mod
    from openmm_drudenose_tpu_torch.examples import nacl_tg_ff
    from openmm_drudenose_tpu_torch.io import builders
    system, pos = builders.build_nacl_water_box(400, 5, 5)
    bare = str(tmp_path / "bare.pdb")
    nacl_tg_ff.write_nacl_pdbs(system, pos, bare)
    out = io_mod.StringIO()
    sim = nacl_tg_ff.main(pdb=bare, n_steps=4, device="cpu",
                          report_every=2, out=out, min_iterations=20)
    st = sim.context.getState(energy=True, positions=True)
    assert sim.system.getNumParticles() == system.getNumParticles()
    assert np.isfinite(st.getPotentialEnergy())
    assert np.all(np.isfinite(st.getPositions()))
    assert len(out.getvalue().splitlines()) == 3


def test_wrapped_residue_numbers_stay_apart(tmp_path):
    """More than 10,000 residues: the writer wraps residue numbers at
    10,000 and serials at 100,000 (io/pdbfile.py), and the reader groups
    maximal runs, so no two residues merge; the position PDB reads back
    into io/nacl.load_nacl_swm4's layout."""
    from openmm_drudenose_tpu_torch.examples import nacl_tg_ff
    from openmm_drudenose_tpu_torch.io import builders
    system, pos = builders.build_nacl_water_box(10010, 0, 0)
    bare, with_sites = str(tmp_path / "bare.pdb"), str(tmp_path / "pos.pdb")
    nacl_tg_ff.write_nacl_pdbs(system, pos, bare, with_sites)
    top = tpdb.PDBFile(bare).topology
    residues = top.residues()
    assert len(residues) == 10010
    assert all(len(atoms) == 3 for _, atoms in residues)
    assert max(a.res_seq for a in top.atoms) == 9999
    full = tpdb.PDBFile(with_sites)
    assert len(full.topology.residues()) == 10010
    assert len(full.topology.atoms) == system.getNumParticles()
