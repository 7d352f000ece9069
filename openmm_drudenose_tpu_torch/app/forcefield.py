"""OpenMM-format force-field XML ingestion: ForceField / Modeller / createSystem.

The reference workflow builds its System through OpenMM's app layer::

    forcefield = ForceField('charmm_polar_2013.xml')
    modeller = Modeller(pdb.topology, pdb.positions)
    modeller.addExtraParticles(forcefield)          # add Drudes + lone pairs
    system = forcefield.createSystem(modeller.topology, nonbondedMethod=PME,
                                     nonbondedCutoff=1.0, constraints=HBonds,
                                     rigidWater=True)

(the reference plugin's example/nacl_tg.py:37-42; the XML ships with
OpenMM, not with the plugin.)  This module is a copy of the JAX package's
app/forcefield.py, which the port may not import: numpy and xml.etree
only, so the two packages build the same System from the same files.

Supported schema subset (the tags CHARMM-Drude-2013-style files use):

  <AtomTypes><Type name class element mass/>
  <Residues><Residue name>
      <Atom name type charge/>
      <Bond atomName1 atomName2/>  or  <Bond from to/>
      <ExternalBond atomName/>  or  <ExternalBond from/>
      <VirtualSite type="average2|average3|outOfPlane|localCoords" .../>
  <HarmonicBondForce><Bond class1 class2 length k/>        (or type1/type2)
  <HarmonicAngleForce><Angle class1 class2 class3 angle k/>
  <UreyBradleyForce><UreyBradley class1 class2 class3 d k/>  (extension: the
      CHARMM 1-3 spring; OpenMM folds these into its CHARMM ports)
  <PeriodicTorsionForce><Proper class1..4 periodicity1 phase1 k1 .../>
                        <Improper .../>      (central atom first, CHARMM)
  <NonbondedForce coulomb14scale lj14scale>
      <UseAttributeFromResidue name="charge"/>
      <Atom type|class [charge] sigma epsilon/>
  <LennardJonesForce lj14scale>
      <Atom class sigma epsilon [sigma14 epsilon14]/>
      <NBFixPair class1 class2 sigma epsilon/>
  <CustomNonbondedForce energy="acoef(type1, type2)/r^12 - bcoef(...)/r^6">
      <PerParticleParameter name/> <Function name type="Discrete2D" .../>
      <Atom class|type <param>=index/>   (the stock charmm_polar_2013.xml
      LJ encoding — mapped onto LennardJonesForce + NBFixPair; see
      _parse_CustomNonbondedForce)
  <CustomTorsionForce energy="k*(theta-theta0)^2">
      <PerTorsionParameter name="k|theta0"/> <Improper class1..4 k theta0/>
      (CHARMM harmonic impropers; the known harmonic shapes map onto
      HarmonicTorsionForce — see _parse_CustomTorsionForce)
  <CmapTorsionForce>  (or CMAPTorsionForce)
      <Map>size^2 whitespace-separated energies</Map>
      <Torsion map class1..5/>   (backbone (phi, psi) correction maps ->
      forces/cmap.py CMAPTorsionForce; five consecutively bonded atoms)
  <DrudeForce><Particle type1 type2 [type3 type4 type5] charge
                        polarizability thole [aniso12] [aniso34]/>
              <NBTholePair type1 type2 thole/>   (extension: CHARMM NBTHOLE)
  <Patches><Patch name [residues="1"]>
      <AddAtom name type charge/> <ChangeAtom name type charge/>
      <RemoveAtom name/> <AddBond atomName1 atomName2/> <RemoveBond .../>
      <AddExternalBond atomName/> <RemoveExternalBond atomName/>
      <VirtualSite .../> <ApplyToResidue name/>
  (plus <AllowPatch name/> inside <Residue>)

Unsupported tags raise at parse time unless listed in ``ignore_tags``
(``<Info>`` is skipped by default).

Design notes / divergences from OpenMM, stated explicitly:

  * Residue-template matching tries residue name + atom-name multiset
    first (the CHARMM-GUI-shaped inputs the reference example uses,
    where atoms are named exactly as the templates), then falls back to
    BOND-GRAPH matching: element-labeled graph isomorphism between the
    residue's inferred bond graph (covalent-radius criterion on the input
    positions) and each template's core-atom graph, so renamed-atom PDBs
    ingest through Modeller.addExtraParticles (which carries positions;
    createSystem accepts an optional ``positions=`` to enable the same
    fallback on already-complete topologies).  The graph fallback matches
    core (non-Drude, non-virtual-site) atoms — inputs that already
    contain Drudes/vsites must name them as the template does.
  * When no unpatched template matches, every allowed (template, patch)
    combination — via the patch's <ApplyToResidue> or the residue's
    <AllowPatch> — is tried, including STACKS of up to two patches per
    residue (both application orders, structurally deduplicated; OpenMM
    tries arbitrary-depth stacks).  ``residues="k"`` patches (k >= 2:
    disulfide and multi-residue crosslink classes, '1:'..'k:'-prefixed
    names) split into per-residue part patches that flow through the
    same matching; their cross-residue AddBonds apply after matching by
    grouping one residue of each part (nearest cross-bond-atom distance
    when positions are available; symmetric 2-residue parts pair within
    the shared pool).
  * Exclusions use OpenMM's excludeAtomWith semantics: Drudes and virtual
    sites anchor to their parent atom; anchor pairs at bond distance 1-2
    are fully excluded, distance 3 gets 1-4 exceptions scaled by
    coulomb14scale/lj14scale (applied between ALL members of the two anchor
    groups, so charge-carrying lone pairs participate in 1-4 Coulomb).
  * Thole screened pairs are generated between Drude pairs whose parents
    are 1-2 or 1-3 bonded, with the pair thole = thole_i + thole_j
    (OpenMM DrudeGenerator behavior).
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..forces.bonded import (HarmonicAngleForce, HarmonicBondForce,
                             HarmonicTorsionForce, PeriodicTorsionForce)
from ..forces.cmap import CMAPTorsionForce
from ..forces.cmmotion import CMMotionRemover
from ..forces.drude import DrudeForce
from ..forces.nonbonded import NonbondedForce
from ..io.pdbfile import PDBAtom, PDBTopology
from ..system import (LocalCoordinatesSite, OutOfPlaneSite, System,
                      ThreeParticleAverageSite, TwoParticleAverageSite)

# app-layer constants mirroring OpenMM's names (example/nacl_tg.py:42)
NoCutoff = NonbondedForce.NoCutoff
CutoffNonPeriodic = NonbondedForce.CutoffNonPeriodic
CutoffPeriodic = NonbondedForce.CutoffPeriodic
PME = NonbondedForce.PME
HBonds = "HBonds"
AllBonds = "AllBonds"

_WATER_NAMES = {"HOH", "WAT", "H2O", "TIP3", "TIP4", "SWM4", "SPC", "SPCE"}


@dataclasses.dataclass
class _AtomType:
    name: str
    klass: str
    element: str
    mass: float


@dataclasses.dataclass
class _TemplateAtom:
    name: str
    type: str
    charge: float


@dataclasses.dataclass
class _VSiteDef:
    site: int                    # template index of the virtual-site atom
    kind: str                    # average2 | average3 | outOfPlane | localCoords
    atoms: Tuple[int, ...]       # template indices of the parent atoms
    params: dict


@dataclasses.dataclass
class _Template:
    name: str
    atoms: List[_TemplateAtom]
    bonds: List[Tuple[int, int]]
    external: List[int]
    vsites: List[_VSiteDef]
    allow_patches: List[str] = dataclasses.field(default_factory=list)

    def atom_index(self, name: str) -> int:
        for i, a in enumerate(self.atoms):
            if a.name == name:
                return i
        raise KeyError(f"residue template {self.name!r} has no atom {name!r}")


@dataclasses.dataclass
class _Patch:
    """A single-residue <Patch>: named edits applied to a template to
    produce a patched-template candidate (OpenMM Patches semantics,
    restricted to residues="1")."""
    name: str
    add_atoms: List[_TemplateAtom]
    change_atoms: List[_TemplateAtom]
    remove_atoms: List[str]
    add_bonds: List[Tuple[str, str]]
    remove_bonds: List[Tuple[str, str]]
    add_external: List[str]
    remove_external: List[str]
    vsite_elems: List[object]          # raw <VirtualSite> elements
    apply_to: List[str]


@dataclasses.dataclass
class _DrudeDef:
    type1: str
    type2: str
    type3: str
    type4: str
    type5: str
    charge: float
    polarizability: float
    thole: float
    aniso12: float
    aniso34: float


class ForceFieldError(ValueError):
    pass


def _f(el, key, default=None):
    v = el.get(key)
    if v is None:
        if default is None:
            raise ForceFieldError(f"<{el.tag}> missing attribute {key!r}")
        return default
    return float(v)


def _subst_idents(expr: str, mapping: Dict[str, str]) -> str:
    """Whole-identifier substitution in an energy expression (so a
    parameter named ``lj`` never clobbers ``ljtype1``)."""
    return re.sub(r"[A-Za-z_][A-Za-z0-9_]*",
                  lambda m: mapping.get(m.group(0), m.group(0)), expr)


def _split_terms(expr: str) -> List[Tuple[str, str]]:
    """Split a whitespace-free expression into top-level signed terms:
    ``'a-b+c' -> [('+', 'a'), ('-', 'b'), ('+', 'c')]``.  +/- inside
    parentheses stay inside their term."""
    terms: List[Tuple[str, str]] = []
    depth = 0
    sign = "+"
    cur: List[str] = []
    for ch in expr:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if depth == 0 and ch in "+-":
            if cur:
                terms.append((sign, "".join(cur)))
                cur = []
            sign = ch
        else:
            cur.append(ch)
    if cur:
        terms.append((sign, "".join(cur)))
    return terms


# covalent radii (nm), Cordero 2008 — used only to infer intra-residue
# bonds for the graph-matching fallback
_COV_RADII = {
    "H": 0.031, "B": 0.084, "C": 0.076, "N": 0.071, "O": 0.066,
    "F": 0.057, "SI": 0.111, "P": 0.107, "S": 0.105, "CL": 0.102,
    "BR": 0.120, "I": 0.139, "LI": 0.128, "NA": 0.166, "K": 0.203,
    "MG": 0.141, "CA": 0.176, "ZN": 0.122, "FE": 0.132,
}


def _infer_bonds(elems: List[str], pos: np.ndarray) -> List[set]:
    """Adjacency sets from a covalent-distance criterion
    (d < r_i + r_j + 0.04 nm); small residues, O(n^2) is fine."""
    n = len(elems)
    adj = [set() for _ in range(n)]
    for i in range(n):
        ri = _COV_RADII.get(elems[i], 0.077)
        for j in range(i + 1, n):
            d = float(np.linalg.norm(pos[i] - pos[j]))
            if d < ri + _COV_RADII.get(elems[j], 0.077) + 0.04:
                adj[i].add(j)
                adj[j].add(i)
    return adj


def _isomorphism(labels_a: List[str], adj_a: List[set],
                 labels_b: List[str], adj_b: List[set]):
    """Backtracking graph isomorphism a->b with element labels and exact
    degree/edge correspondence; returns mapping list m[a_idx] = b_idx or
    None.  Residues are small (tens of atoms), and the (label, degree)
    pruning keeps the search tiny for chemical graphs."""
    n = len(labels_a)
    if n != len(labels_b):
        return None
    key_a = [(labels_a[i], len(adj_a[i])) for i in range(n)]
    key_b = [(labels_b[i], len(adj_b[i])) for i in range(n)]
    if sorted(key_a) != sorted(key_b):
        return None
    # order a-vertices: rarest (label, degree) first, then prefer vertices
    # adjacent to already-placed ones (connectivity-guided search)
    from collections import Counter
    rarity = Counter(key_a)
    order = []
    placed = set()
    remaining = set(range(n))
    while remaining:
        adjacent = [v for v in remaining if adj_a[v] & placed]
        pool = adjacent or list(remaining)
        v = min(pool, key=lambda x: (rarity[key_a[x]], x))
        order.append(v)
        placed.add(v)
        remaining.discard(v)

    m = [-1] * n
    used = [False] * n

    def extend(k: int) -> bool:
        if k == n:
            return True
        a = order[k]
        for b in range(n):
            if used[b] or key_a[a] != key_b[b]:
                continue
            ok = True
            for na in adj_a[a]:
                if m[na] != -1 and m[na] not in adj_b[b]:
                    ok = False
                    break
            if ok:
                # reverse direction: every mapped b-neighbor must come
                # from an a-neighbor (degrees equal => subset == equality)
                for nb in adj_b[b]:
                    src = m.index(nb) if nb in m else -1
                    if src != -1 and src not in adj_a[a]:
                        ok = False
                        break
            if not ok:
                continue
            m[a] = b
            used[b] = True
            if extend(k + 1):
                return True
            m[a] = -1
            used[b] = False
        return False

    return m if extend(0) else None


class ForceField:
    """Parses one or more OpenMM-format force-field XML files and builds
    Systems from topologies (the role OpenMM's app.ForceField plays for the
    reference, example/nacl_tg.py:37)."""

    def __init__(self, *files: str, ignore_tags: Sequence[str] = ("Info",)):
        self.atom_types: Dict[str, _AtomType] = {}
        self.templates: Dict[str, _Template] = {}
        self.patches: Dict[str, _Patch] = {}
        self._patched_cache: Dict[Tuple[str, str], Optional[_Template]] = {}
        self.bond_params: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self.angle_params: Dict[Tuple[str, str, str], Tuple[float, float]] = {}
        self.urey_params: Dict[Tuple[str, str, str], Tuple[float, float]] = {}
        self.proper: List[Tuple[Tuple[str, str, str, str], list]] = []
        self.improper: List[Tuple[Tuple[str, str, str, str], list]] = []
        # harmonic (CustomTorsionForce-encoded) impropers: key -> (theta0, k)
        self.harmonic_improper: List[Tuple[Tuple[str, str, str, str],
                                           Tuple[float, float]]] = []
        self.cmap_maps: List[Tuple[int, "np.ndarray"]] = []
        self.cmap_torsions: List[Tuple[Tuple[str, ...], int]] = []
        self.coulomb14: float = 1.0
        self.lj14: float = 1.0
        self.nb_by_type: Dict[str, Tuple[float, float, Optional[float]]] = {}
        self.nb_uses_residue_charge = False
        self.lj_by_class: Dict[str, Tuple[float, float, float, float]] = {}
        self.lj_lj14: float = 1.0
        self.has_lj_force = False
        self.nbfix: List[Tuple[str, str, float, float]] = []
        # general Custom*Force sections (expression-compiled fallbacks
        # for shapes outside the stock charmm_polar_2013.xml encodings)
        self.custom_bonded: List[dict] = []
        self.custom_nonbonded: Optional[dict] = None
        self.drude_defs: List[_DrudeDef] = []
        self.nbthole_defs: List[Tuple[str, str, float]] = []
        # residues="k" patches: name -> (n_parts, cross-residue bonds
        # [(part_i, atom_i, part_j, atom_j)] with part_i < part_j)
        self.multipatch_cross: Dict[
            str, Tuple[int, List[Tuple[int, str, int, str]]]] = {}
        self._ignore = set(ignore_tags)
        for f in files:
            self._load(f)

    # ------------------------------------------------------------------ parse
    def _load(self, path: str) -> None:
        if not os.path.exists(path):
            raise ForceFieldError(f"force field file not found: {path}")
        root = ET.parse(path).getroot()
        if root.tag != "ForceField":
            raise ForceFieldError(f"{path}: root tag is <{root.tag}>, "
                                  "expected <ForceField>")
        for sec in root:
            handler = getattr(self, f"_parse_{sec.tag}", None)
            if handler is not None:
                handler(sec)
            elif sec.tag not in self._ignore:
                raise ForceFieldError(
                    f"{path}: unsupported section <{sec.tag}> (pass "
                    f"ignore_tags=[...,'{sec.tag}'] to skip it)")

    def _parse_AtomTypes(self, sec) -> None:
        for el in sec:
            if el.tag != "Type":
                continue
            name = el.get("name")
            self.atom_types[name] = _AtomType(
                name=name, klass=el.get("class", name),
                element=el.get("element", ""), mass=_f(el, "mass"))

    def _parse_Residues(self, sec) -> None:
        for rel in sec:
            if rel.tag != "Residue":
                continue
            atoms: List[_TemplateAtom] = []
            bonds: List[Tuple[int, int]] = []
            external: List[int] = []
            vsites: List[_VSiteDef] = []
            allow: List[str] = []
            name = rel.get("name")

            def idx(el, key_name, key_idx):
                v = el.get(key_name)
                if v is not None:
                    for i, a in enumerate(atoms):
                        if a.name == v:
                            return i
                    raise ForceFieldError(
                        f"residue {name!r}: unknown atom {v!r} in <{el.tag}>")
                v = el.get(key_idx)
                if v is None:
                    raise ForceFieldError(
                        f"residue {name!r}: <{el.tag}> needs "
                        f"{key_name} or {key_idx}")
                return int(v)

            for el in rel:
                if el.tag == "Atom":
                    atoms.append(_TemplateAtom(
                        name=el.get("name"), type=el.get("type"),
                        charge=float(el.get("charge", "0"))))
            for el in rel:
                if el.tag == "Bond":
                    bonds.append((idx(el, "atomName1", "from"),
                                  idx(el, "atomName2", "to")))
                elif el.tag == "ExternalBond":
                    external.append(idx(el, "atomName", "from"))
                elif el.tag == "VirtualSite":
                    vsites.append(self._parse_vsite(name, atoms, el))
                elif el.tag == "AllowPatch":
                    allow.append(el.get("name"))
                elif el.tag == "Atom":
                    pass
                else:
                    raise ForceFieldError(
                        f"residue {name!r}: unsupported tag <{el.tag}>")
            self.templates[name] = _Template(name, atoms, bonds, external,
                                             vsites, allow)

    def _parse_vsite(self, res_name, atoms, el) -> _VSiteDef:
        kind = el.get("type")

        def aidx(key_name, key_idx):
            v = el.get(key_name)
            if v is not None:
                for i, a in enumerate(atoms):
                    if a.name == v:
                        return i
                raise ForceFieldError(
                    f"residue {res_name!r}: unknown atom {v!r} in VirtualSite")
            v = el.get(key_idx)
            return None if v is None else int(v)

        site = aidx("siteName", "index")
        if site is None:
            raise ForceFieldError(
                f"residue {res_name!r}: VirtualSite needs siteName or index")
        parents = []
        for k in range(1, 10):
            p = aidx(f"atomName{k}", f"atom{k}")
            if p is None:
                break
            parents.append(p)
        if kind in ("average2", "average3"):
            n = 2 if kind == "average2" else 3
            params = {"weights": [_f(el, f"weight{k + 1}") for k in range(n)]}
        elif kind == "outOfPlane":
            params = {"weights": [_f(el, "weight12"), _f(el, "weight13"),
                                  _f(el, "weightCross")]}
        elif kind == "localCoords":
            n = len(parents)
            params = {
                "origin": [_f(el, f"wo{k + 1}") for k in range(n)],
                "x": [_f(el, f"wx{k + 1}") for k in range(n)],
                "y": [_f(el, f"wy{k + 1}") for k in range(n)],
                "pos": [_f(el, "p1"), _f(el, "p2"), _f(el, "p3")],
            }
        else:
            raise ForceFieldError(
                f"residue {res_name!r}: unsupported VirtualSite type {kind!r}")
        return _VSiteDef(site=site, kind=kind, atoms=tuple(parents), params=params)

    def _parse_Patches(self, sec) -> None:
        for pel in sec:
            if pel.tag != "Patch":
                continue
            name = pel.get("name")
            n_res = int(pel.get("residues", "1"))
            if n_res == 1:
                self.patches[name] = self._parse_one_patch(pel, name)
            else:
                self._parse_multi_residue_patch(pel, name, n_res)

    def _parse_one_patch(self, pel, name: str) -> "_Patch":
        p = _Patch(name, [], [], [], [], [], [], [], [], [])
        for el in pel:
            if el.tag == "AddAtom":
                p.add_atoms.append(_TemplateAtom(
                    el.get("name"), el.get("type"),
                    float(el.get("charge", "0"))))
            elif el.tag == "ChangeAtom":
                p.change_atoms.append(_TemplateAtom(
                    el.get("name"), el.get("type"),
                    float(el.get("charge", "0"))))
            elif el.tag == "RemoveAtom":
                p.remove_atoms.append(el.get("name"))
            elif el.tag == "AddBond":
                p.add_bonds.append((el.get("atomName1"),
                                    el.get("atomName2")))
            elif el.tag == "RemoveBond":
                p.remove_bonds.append((el.get("atomName1"),
                                       el.get("atomName2")))
            elif el.tag == "AddExternalBond":
                p.add_external.append(el.get("atomName"))
            elif el.tag == "RemoveExternalBond":
                p.remove_external.append(el.get("atomName"))
            elif el.tag == "VirtualSite":
                p.vsite_elems.append(el)
            elif el.tag == "ApplyToResidue":
                p.apply_to.append(el.get("name"))
            else:
                raise ForceFieldError(
                    f"patch {name!r}: unsupported tag <{el.tag}>")
        return p

    def _parse_multi_residue_patch(self, pel, name: str,
                                   n_res: int) -> None:
        """A residues=\"k\" <Patch> (k >= 2; OpenMM's disulfide-class and
        multi-residue crosslink patches): atom names carry '1:'..'k:'
        prefixes selecting the residue copy.  Split into k single-residue
        part-patches '<name>#i' that flow through the ordinary
        patched-template matching, plus the CROSS-residue AddBonds
        recorded as (part_i, name_i, part_j, name_j), which createSystem
        applies after matching by grouping one residue of each part
        (nearest cross-bond-atom distance when positions are
        available)."""
        parts = [_Patch(f"{name}#{i + 1}", [], [], [], [], [], [], [], [],
                        []) for i in range(n_res)]
        cross: List[Tuple[int, str, int, str]] = []

        def split(nm):
            if nm is None or ":" not in nm:
                raise ForceFieldError(
                    f"patch {name!r}: atom name {nm!r} must be prefixed "
                    f"'1:'..'{n_res}:' in a residues=\"{n_res}\" patch")
            head, _, rest = nm.partition(":")
            try:
                k = int(head)
            except ValueError:
                k = 0
            if not (1 <= k <= n_res) or not rest:
                raise ForceFieldError(
                    f"patch {name!r}: atom name {nm!r} must be prefixed "
                    f"'1:'..'{n_res}:' in a residues=\"{n_res}\" patch")
            return k - 1, rest

        for el in pel:
            if el.tag in ("AddAtom", "ChangeAtom"):
                k, nm = split(el.get("name"))
                dest = (parts[k].add_atoms if el.tag == "AddAtom"
                        else parts[k].change_atoms)
                dest.append(_TemplateAtom(nm, el.get("type"),
                                          float(el.get("charge", "0"))))
            elif el.tag == "RemoveAtom":
                k, nm = split(el.get("name"))
                parts[k].remove_atoms.append(nm)
            elif el.tag in ("AddBond", "RemoveBond"):
                k1, n1 = split(el.get("atomName1"))
                k2, n2 = split(el.get("atomName2"))
                if k1 == k2:
                    dest = (parts[k1].add_bonds if el.tag == "AddBond"
                            else parts[k1].remove_bonds)
                    dest.append((n1, n2))
                elif el.tag == "AddBond":
                    cross.append((k1, n1, k2, n2) if k1 < k2
                                 else (k2, n2, k1, n1))
                else:
                    raise ForceFieldError(
                        f"patch {name!r}: cross-residue RemoveBond is "
                        "not supported")
            elif el.tag in ("AddExternalBond", "RemoveExternalBond"):
                k, nm = split(el.get("atomName"))
                dest = (parts[k].add_external
                        if el.tag == "AddExternalBond"
                        else parts[k].remove_external)
                dest.append(nm)
            elif el.tag == "ApplyToResidue":
                k, nm = split(el.get("name"))
                parts[k].apply_to.append(nm)
            elif el.tag == "VirtualSite":
                raise ForceFieldError(
                    f"patch {name!r}: VirtualSite in a residues>=2 "
                    "patch is not supported")
            else:
                raise ForceFieldError(
                    f"patch {name!r}: unsupported tag <{el.tag}>")
        for p in parts:
            self.patches[p.name] = p
        self.multipatch_cross[name] = (n_res, cross)

    def _patched_template(self, tmpl: _Template,
                          patch: _Patch) -> Optional[_Template]:
        """Apply `patch` to `tmpl` -> a new template named
        '<res>-<patch>' (None if the patch does not apply cleanly).
        Cached per (template, patch)."""
        key = (tmpl.name, patch.name)
        if key in self._patched_cache:
            return self._patched_cache[key]
        try:
            out = self._apply_patch(tmpl, patch)
        except (ForceFieldError, KeyError, ValueError):
            out = None
        self._patched_cache[key] = out
        return out

    def _apply_patch(self, tmpl: _Template, patch: _Patch) -> _Template:
        atoms = [dataclasses.replace(a) for a in tmpl.atoms]
        names = [a.name for a in atoms]
        bonds = {frozenset((names[i], names[j])) for (i, j) in tmpl.bonds}
        external = [names[e] for e in tmpl.external]
        for ca in patch.change_atoms:
            i = names.index(ca.name)          # KeyError-> ValueError: no match
            atoms[i] = _TemplateAtom(ca.name, ca.type, ca.charge)
        removed = set(patch.remove_atoms)
        for rn in removed:
            names.index(rn)                   # must exist
        for (a, b) in patch.remove_bonds:
            k = frozenset((a, b))
            if k not in bonds:
                raise ForceFieldError(
                    f"patch {patch.name!r}: no bond {a}-{b} to remove")
            bonds.discard(k)
        for rn in patch.remove_external:
            external.remove(rn)
        atoms = [a for a in atoms if a.name not in removed]
        bonds = {k for k in bonds if not (k & removed)}
        external = [e for e in external if e not in removed]
        atoms.extend(patch.add_atoms)
        names = [a.name for a in atoms]
        for (a, b) in patch.add_bonds:
            names.index(a), names.index(b)
            bonds.add(frozenset((a, b)))
        external.extend(patch.add_external)
        # surviving vsites (those not referencing removed atoms) + new ones
        old_by_name = {tmpl.atoms[v.site].name: v for v in tmpl.vsites}
        vsites = []
        for sname, v in old_by_name.items():
            ref = {tmpl.atoms[p].name for p in v.atoms} | {sname}
            if ref & removed:
                continue
            vsites.append(_VSiteDef(
                site=names.index(sname), kind=v.kind,
                atoms=tuple(names.index(tmpl.atoms[p].name)
                            for p in v.atoms),
                params=v.params))
        pname = f"{tmpl.name}-{patch.name}"
        for el in patch.vsite_elems:
            vsites.append(self._parse_vsite(pname, atoms, el))
        idx = {n: i for i, n in enumerate(names)}
        return _Template(
            pname, atoms,
            [tuple(sorted((idx[a], idx[b]))) for k in bonds
             for (a, b) in [tuple(k)]],
            [idx[e] for e in external], vsites, [])

    def _allowed_patches(self, tmpl: _Template) -> List[_Patch]:
        base = tmpl.name
        out = []
        for p in self.patches.values():
            base_name = p.name.split("#")[0]   # residues="2" part patches
            if (base in p.apply_to or p.name in tmpl.allow_patches
                    or base_name in tmpl.allow_patches):
                out.append(p)
        return out

    def _key2(self, el) -> Tuple[str, str]:
        c1 = el.get("class1", None)
        if c1 is not None:
            return (c1, el.get("class2"))
        return ("@" + el.get("type1"), "@" + el.get("type2"))

    def _parse_HarmonicBondForce(self, sec) -> None:
        for el in sec:
            if el.tag == "Bond":
                self.bond_params[self._key2(el)] = (_f(el, "length"), _f(el, "k"))

    def _parse_HarmonicAngleForce(self, sec) -> None:
        for el in sec:
            if el.tag == "Angle":
                key = tuple(el.get(f"class{k}", "@" + el.get(f"type{k}", ""))
                            for k in (1, 2, 3))
                self.angle_params[key] = (_f(el, "angle"), _f(el, "k"))

    def _parse_UreyBradleyForce(self, sec) -> None:
        for el in sec:
            if el.tag == "UreyBradley":
                key = tuple(el.get(f"class{k}") for k in (1, 2, 3))
                self.urey_params[key] = (_f(el, "d"), _f(el, "k"))

    def _parse_torsion_terms(self, el) -> list:
        terms = []
        for k in range(1, 7):
            p = el.get(f"periodicity{k}")
            if p is None:
                break
            terms.append((int(p), _f(el, f"phase{k}"), _f(el, f"k{k}")))
        return terms

    def _parse_PeriodicTorsionForce(self, sec) -> None:
        for el in sec:
            if el.tag not in ("Proper", "Improper"):
                continue
            key = tuple(el.get(f"class{k}", "") for k in (1, 2, 3, 4))
            dest = self.proper if el.tag == "Proper" else self.improper
            dest.append((key, self._parse_torsion_terms(el)))

    def _parse_CustomTorsionForce(self, sec) -> None:
        """OpenMM's CHARMM ports express harmonic impropers through a
        CustomTorsionForce.  Only the known harmonic shapes are accepted
        and mapped onto HarmonicTorsionForce (E = k * wrap(theta -
        theta0)^2); a genuinely different expression raises.  The
        expression is NORMALIZED before the shape match: whitespace is
        stripped, the two PerTorsionParameters may be declared under ANY
        names (the stiffness is the multiplier, the offset the subtracted
        angle — both assignments are tried), and (theta0-theta) ==
        (theta-theta0) under the square.  Accepted canonical shapes:
        k*(theta-theta0)^2, k*(acos(cos(theta-theta0)))^2, and the
        explicit min-image forms k*min(dtheta,2*pi-dtheta)^2;
        dtheta=abs(theta-theta0) — all equal on the wrapped branch;
        0.5*-prefixed variants fold the half into k."""
        raw = sec.get("energy") or ""
        energy = re.sub(r"\s+", "", raw).rstrip(";")
        pnames = [el.get("name") for el in sec
                  if el.tag == "PerTorsionParameter"]
        if len(pnames) != 2:
            # harmonic impropers carry exactly (stiffness, offset); any
            # other arity is a general torsion for the expression compiler
            self._collect_custom_bonded(sec, "torsion", 4,
                                        "PerTorsionParameter",
                                        ("Proper", "Improper"))
            return
        known = (
            "k*(theta-theta0)^2",
            "k*(acos(cos(theta-theta0)))^2",
            "k*min(dtheta,2*pi-dtheta)^2;dtheta=abs(theta-theta0)",
            "k*dtheta^2;dtheta=min(d,2*pi-d);d=abs(theta-theta0)",
        )
        match = None  # (k_attr, theta0_attr, half)
        for k_name, t0_name in (tuple(pnames), tuple(reversed(pnames))):
            e = _subst_idents(energy, {k_name: "k", t0_name: "theta0"})
            # the square makes the subtraction order irrelevant
            e = e.replace("(theta0-theta)", "(theta-theta0)")
            half = e.startswith("0.5*")
            if half:
                e = e[4:]
            if e in known:
                match = (k_name, t0_name, half)
                break
        if match is None:
            # not a harmonic improper: ingest as a GENERAL torsion via the
            # expression compiler (utils/expr.py) — the path OpenMM's
            # Lepton machinery covers for the reference workflow
            self._collect_custom_bonded(sec, "torsion", 4,
                                        "PerTorsionParameter",
                                        ("Proper", "Improper"))
            return
        k_name, t0_name, half = match
        scale = 0.5 if half else 1.0
        for el in sec:
            if el.tag in ("Improper", "Proper"):
                key = tuple(el.get(f"class{k}", "") for k in (1, 2, 3, 4))
                self.harmonic_improper.append(
                    (key, (_f(el, t0_name), scale * _f(el, k_name))))

    def _parse_CmapTorsionForce(self, sec) -> None:
        """CMAP backbone correction maps (the CHARMM-Drude-2013 protein
        decks' <CmapTorsionForce>): <Map> children hold size^2
        whitespace-separated energies (kJ/mol, angle1-fastest starting at
        -pi — forces/cmap.py documents the grid convention); <Torsion
        map= class1..class5/> names five consecutively bonded atoms whose
        two overlapping dihedrals (1-2-3-4, 2-3-4-5) index the map."""
        base = len(self.cmap_maps)
        for el in sec:
            if el.tag == "Map":
                vals = np.array((el.text or "").split(), np.float64)
                size = int(round(math.sqrt(vals.size)))
                if size * size != vals.size:
                    raise ForceFieldError(
                        f"<Map> has {vals.size} values (not a square)")
                self.cmap_maps.append((size, vals))
            elif el.tag == "Torsion":
                key = tuple(el.get(f"class{k}", "") for k in (1, 2, 3, 4, 5))
                self.cmap_torsions.append((key, base + int(el.get("map"))))

    # OpenMM historically spells the section both ways
    _parse_CMAPTorsionForce = _parse_CmapTorsionForce

    # -- general Custom*Force sections (utils/expr.py fallback) ---------
    # These play the role OpenMM's Lepton-driven generators play for the
    # reference workflow (example/nacl_tg.py:37-42): the energy expression
    # is validated at parse time, per-term parameters keep their declared
    # names, and each term entry records (tag, class/type key, values)
    # for createSystem's topology matching.
    def _collect_custom_nonbonded(self, sec) -> None:
        from ..utils.expr import ExpressionError, compile_expression
        raw = sec.get("energy") or ""
        pnames = [el.get("name") for el in sec
                  if el.tag == "PerParticleParameter"]
        globs = [(el.get("name"), float(el.get("defaultValue", "0")))
                 for el in sec if el.tag == "GlobalParameter"]
        for el in sec:
            if el.tag in ("Function", "TabulatedFunction"):
                raise ForceFieldError(
                    "general <CustomNonbondedForce> expressions with "
                    "tabulated functions are not supported — only the "
                    "stock CHARMM 'A(type1,type2)/r^12 - B(...)/r^6' "
                    "Discrete2D form (which maps onto the "
                    "LennardJonesForce tables)")
        names = (["r"] + [p + "1" for p in pnames]
                 + [p + "2" for p in pnames] + [g[0] for g in globs])
        try:
            compile_expression(raw, names)
        except ExpressionError as err:
            raise ForceFieldError(
                f"<CustomNonbondedForce> energy expression: {err}") from err
        by_type: Dict[str, tuple] = {}
        by_class: Dict[str, tuple] = {}
        for el in sec:
            if el.tag != "Atom":
                continue
            vals = tuple(_f(el, p) for p in pnames)
            t = el.get("type")
            if t is not None:
                by_type[t] = vals
            else:
                by_class[el.get("class")] = vals
        if self.custom_nonbonded is not None:
            raise ForceFieldError(
                "multiple general <CustomNonbondedForce> sections")
        self.custom_nonbonded = {
            "energy": raw, "pnames": pnames, "globals": globs,
            "bond_cutoff": int(sec.get("bondCutoff", "3")),
            "by_type": by_type, "by_class": by_class}

    def _parse_CustomBondForce(self, sec) -> None:
        self._collect_custom_bonded(sec, "bond", 2, "PerBondParameter",
                                    ("Bond",))

    def _parse_CustomAngleForce(self, sec) -> None:
        self._collect_custom_bonded(sec, "angle", 3, "PerAngleParameter",
                                    ("Angle",))

    def _collect_custom_bonded(self, sec, kind: str, n_cls: int,
                               per_tag: str, term_tags) -> None:
        from ..utils.expr import ExpressionError, compile_expression
        raw = sec.get("energy") or ""
        pnames = [el.get("name") for el in sec if el.tag == per_tag]
        globs = [(el.get("name"), float(el.get("defaultValue", "0")))
                 for el in sec if el.tag == "GlobalParameter"]
        var = "r" if kind == "bond" else "theta"
        try:
            compile_expression(raw, [var] + pnames + [g[0] for g in globs])
        except ExpressionError as err:
            raise ForceFieldError(
                f"<{sec.tag}> energy expression: {err}") from err
        entries = []
        for el in sec:
            if el.tag in term_tags:
                key = []
                for kx in range(1, n_cls + 1):
                    c = el.get(f"class{kx}")
                    t = el.get(f"type{kx}")
                    if c:
                        key.append(("class", c))
                    elif t:
                        key.append(("type", t))
                    else:
                        key.append(("class", ""))       # wildcard
                entries.append((el.tag, tuple(key),
                                tuple(_f(el, p) for p in pnames)))
        self.custom_bonded.append({
            "kind": kind, "tag": sec.tag, "energy": raw, "pnames": pnames,
            "globals": globs, "entries": entries})

    def _parse_NonbondedForce(self, sec) -> None:
        self.coulomb14 = float(sec.get("coulomb14scale", "1"))
        self.lj14 = float(sec.get("lj14scale", "1"))
        for el in sec:
            if el.tag == "UseAttributeFromResidue":
                if el.get("name") == "charge":
                    self.nb_uses_residue_charge = True
            elif el.tag == "Atom":
                sigma = _f(el, "sigma")
                eps = _f(el, "epsilon")
                q = el.get("charge")
                q = None if q is None else float(q)
                t = el.get("type")
                if t is not None:
                    self.nb_by_type[t] = (sigma, eps, q)
                else:
                    klass = el.get("class")
                    for ty in self.atom_types.values():
                        if ty.klass == klass:
                            self.nb_by_type[ty.name] = (sigma, eps, q)

    def _parse_LennardJonesForce(self, sec) -> None:
        self.has_lj_force = True
        self.lj_lj14 = float(sec.get("lj14scale", "1"))
        for el in sec:
            if el.tag == "Atom":
                sigma = _f(el, "sigma")
                eps = _f(el, "epsilon")
                self.lj_by_class[el.get("class")] = (
                    sigma, eps, _f(el, "sigma14", sigma), _f(el, "epsilon14", eps))
            elif el.tag == "NBFixPair":
                self.nbfix.append((el.get("class1"), el.get("class2"),
                                   _f(el, "sigma"), _f(el, "epsilon")))

    def _parse_CustomNonbondedForce(self, sec) -> None:
        """The stock ``charmm_polar_2013.xml`` LJ encoding: OpenMM ships
        that file's Lennard-Jones as a CustomNonbondedForce with a
        Discrete2D acoef/bcoef table indexed by a per-particle parameter
        (the reference's own workflow comment points this out,
        the reference plugin's example/nacl_tg.py:44).  Only that known shape is
        accepted — energy ``acoef(type1, type2)/r^12 - bcoef(type1,
        type2)/r^6`` — and it is mapped onto the LennardJonesForce
        machinery: per-class sigma/epsilon from the table diagonal
        (A = 4 eps sigma^12, B = 4 eps sigma^6), off-diagonal entries
        deviating from Lorentz-Berthelot mixing become NBFixPair
        overrides.  The expression is NORMALIZED before the shape match:
        whitespace is stripped, the PerParticleParameter and the two
        Discrete2D functions may carry ANY names (the /r^12 function is
        A, the /r^6 one B), the two terms may appear in either order, and
        (type2, type1) argument order is accepted (the table is
        transposed).  Anything genuinely different raises with
        guidance."""
        raw = sec.get("energy") or ""
        energy = re.sub(r"\s+", "", raw).rstrip(";")
        pnames = [el.get("name") for el in sec
                  if el.tag == "PerParticleParameter"]
        if len(pnames) != 1:
            # not the tabulated-LJ shape: ingest as a GENERAL custom
            # nonbonded force via the expression compiler
            self._collect_custom_nonbonded(sec)
            return
        pname = pnames[0]
        energy = _subst_idents(
            energy, {pname + "1": "type1", pname + "2": "type2"})
        a_name = b_name = None
        a_rev = b_rev = False
        term_re = re.compile(
            r"([A-Za-z_]\w*)\((type1,type2|type2,type1)\)/r\^(12|6)")
        terms = _split_terms(energy)
        ok = len(terms) == 2
        if ok:
            for sign, t in terms:
                m = term_re.fullmatch(t)
                if m is None:
                    ok = False
                    break
                rev = m.group(2) == "type2,type1"
                if m.group(3) == "12" and sign == "+" and a_name is None:
                    a_name, a_rev = m.group(1), rev
                elif m.group(3) == "6" and sign == "-" and b_name is None:
                    b_name, b_rev = m.group(1), rev
                else:
                    ok = False
                    break
        if not ok or a_name is None or b_name is None:
            self._collect_custom_nonbonded(sec)
            return
        funcs = {}
        for el in sec:
            if el.tag in ("Function", "TabulatedFunction"):
                if el.get("type", "Discrete2D") != "Discrete2D":
                    raise ForceFieldError(
                        f"<Function {el.get('name')}> must be Discrete2D")
                xs = int(_f(el, "xsize"))
                ys = int(_f(el, "ysize"))
                txt = el.get("values") or (el.text or "")
                vals = np.array(txt.split(), np.float64)
                if vals.size != xs * ys:
                    raise ForceFieldError(
                        f"<Function {el.get('name')}> has {vals.size} "
                        f"values, expected {xs * ys}")
                # Discrete2D ordering: x varies fastest -> [y, x]
                funcs[el.get("name")] = vals.reshape(ys, xs).T
        if a_name not in funcs or b_name not in funcs:
            raise ForceFieldError(
                f"<CustomNonbondedForce> needs {a_name} and {b_name} "
                f"Discrete2D functions (named in the energy expression)")
        A, B = funcs[a_name], funcs[b_name]
        if a_rev:
            A = A.T
        if b_rev:
            B = B.T

        idx_by_class: Dict[str, int] = {}
        for el in sec:
            if el.tag != "Atom":
                continue
            kl = el.get("class")
            if kl is None:
                t = el.get("type")
                if t not in self.atom_types:
                    raise ForceFieldError(
                        f"<CustomNonbondedForce> atom type {t!r} unknown")
                kl = self.atom_types[t].klass
            idx_by_class[kl] = int(float(_f(el, pname)))

        def ab_to_sig_eps(a, b):
            if a <= 0.0 or b <= 0.0:
                return 1.0, 0.0
            sig = (a / b) ** (1.0 / 6.0)
            return sig, b * b / (4.0 * a)

        self.has_lj_force = True
        self.lj_lj14 = float(sec.get("lj14scale", self.lj_lj14))
        per_class = {}
        for kl, i in idx_by_class.items():
            sig, eps = ab_to_sig_eps(A[i, i], B[i, i])
            per_class[kl] = (sig, eps)
            self.lj_by_class[kl] = (sig, eps, sig, eps)
        # off-diagonal deviations from Lorentz-Berthelot -> NBFIX pairs
        classes = sorted(idx_by_class)
        for x, k1 in enumerate(classes):
            i = idx_by_class[k1]
            s1, e1 = per_class[k1]
            for k2 in classes[x:]:
                j = idx_by_class[k2]
                s2, e2 = per_class[k2]
                sig_lb = 0.5 * (s1 + s2)
                eps_lb = math.sqrt(e1 * e2)
                a_lb = 4.0 * eps_lb * sig_lb ** 12
                b_lb = 4.0 * eps_lb * sig_lb ** 6
                a, b = A[i, j], B[i, j]
                tol_a = 1e-6 * max(abs(a), abs(a_lb), 1e-300)
                tol_b = 1e-6 * max(abs(b), abs(b_lb), 1e-300)
                if abs(a - a_lb) > tol_a or abs(b - b_lb) > tol_b:
                    sig_ij, eps_ij = ab_to_sig_eps(a, b)
                    self.nbfix.append((k1, k2, sig_ij, eps_ij))

    def _parse_DrudeForce(self, sec) -> None:
        for el in sec:
            if el.tag == "Particle":
                self.drude_defs.append(_DrudeDef(
                    type1=el.get("type1"), type2=el.get("type2"),
                    type3=el.get("type3", ""), type4=el.get("type4", ""),
                    type5=el.get("type5", ""),
                    charge=_f(el, "charge"),
                    polarizability=_f(el, "polarizability"),
                    thole=_f(el, "thole", 1.3),
                    aniso12=_f(el, "aniso12", 1.0),
                    aniso34=_f(el, "aniso34", 1.0)))
            elif el.tag == "NBTholePair":
                self.nbthole_defs.append((el.get("type1"), el.get("type2"),
                                          _f(el, "thole")))

    # ------------------------------------------------------- template matching
    def _drude_types(self) -> set:
        return {d.type1 for d in self.drude_defs}

    def _extra_atoms(self, tmpl: _Template) -> set:
        """Template indices of atoms Modeller.addExtraParticles may add:
        virtual sites and Drude particles."""
        extra = {v.site for v in tmpl.vsites}
        dtypes = self._drude_types()
        extra.update(i for i, a in enumerate(tmpl.atoms) if a.type in dtypes)
        return extra

    def _name_candidates(self, res_name: str, atom_names: Sequence[str],
                         pool) -> list:
        names = sorted(atom_names)
        cands = []
        for tmpl in pool:
            full = sorted(a.name for a in tmpl.atoms)
            extra = self._extra_atoms(tmpl)
            core = sorted(a.name for i, a in enumerate(tmpl.atoms)
                          if i not in extra)
            if names == full or names == core:
                cands.append(tmpl)
        named = [t for t in cands
                 if t.name == res_name or t.name.startswith(res_name + "-")]
        return named or cands

    def match_template(self, res_name: str, atom_names: Sequence[str]):
        """Backward-compatible wrapper around match_residue (name-only
        matching; no positions for the graph fallback)."""
        return self.match_residue(res_name, atom_names)[0]

    def match_residue(self, res_name: str, atom_names: Sequence[str],
                      elements: Optional[Sequence[str]] = None,
                      positions=None):
        """Find the template for a residue and the atom mapping.

        Returns (template, mapping) where mapping[template_index] = local
        residue index for every template atom present in the input.

        Matching order (docstring at the top of this module):
          1. atom-name multiset vs unpatched templates (Drudes/vsites
             optional), residue-named templates preferred;
          2. the same vs single-patched templates (<ApplyToResidue> /
             <AllowPatch> pairs);
          3. bond-graph isomorphism of the residue's inferred bond graph
             (covalent-radius criterion on `positions`) against each
             template's core graph — requires `elements` + `positions`,
             and the input to contain exactly the core atoms.
        """
        for pool in (self.templates.values(),
                     self._all_patched_templates()):
            cands = self._name_candidates(res_name, atom_names, pool)
            if len(cands) > 1:
                raise ForceFieldError(
                    f"ambiguous templates for {res_name!r}: "
                    f"{[t.name for t in cands]}")
            if cands:
                tmpl = cands[0]
                by_name = {a.name: ti for ti, a in enumerate(tmpl.atoms)}
                return tmpl, {by_name[nm]: li
                              for li, nm in enumerate(atom_names)}

        if elements is not None and positions is not None:
            got = self._graph_match(res_name, elements, positions)
            if got is not None:
                return got

        raise ForceFieldError(
            f"no residue template matches {res_name!r} with atoms "
            f"{list(atom_names)}"
            + ("" if positions is not None else
               " (positions unavailable, so bond-graph matching was not "
               "attempted; renamed-atom inputs ingest through "
               "Modeller.addExtraParticles or createSystem(positions=...))"))

    @staticmethod
    def _template_key(t: _Template):
        """Structural identity of a template (order-independent): used to
        deduplicate patch stacks applied in different orders."""
        names = [a.name for a in t.atoms]
        return (tuple(sorted((a.name, a.type, round(a.charge, 12))
                             for a in t.atoms)),
                tuple(sorted(tuple(sorted((names[i], names[j])))
                             for (i, j) in t.bonds)),
                tuple(sorted(names[e] for e in t.external)),
                len(t.vsites))

    def _all_patched_templates(self) -> list:
        out = []
        seen = set()
        for tmpl in self.templates.values():
            allowed = self._allowed_patches(tmpl)
            singles = []
            for patch in allowed:
                pt = self._patched_template(tmpl, patch)
                if pt is not None:
                    key = self._template_key(pt)
                    if key in seen:
                        # e.g. the two parts of a SYMMETRIC residues="2"
                        # patch produce identical templates; keeping one
                        # avoids a spurious ambiguity (createSystem pairs
                        # such residues within the shared-part pool)
                        continue
                    singles.append((patch, pt))
                    out.append(pt)
                    seen.add(key)
            # two-patch stacks (OpenMM tries patch stacks; pairs cover the
            # termination + modification combinations).  Both application
            # orders are tried — patches can be order-dependent — and
            # structurally identical results deduplicate.
            for p1, pt1 in singles:
                for p2 in allowed:
                    if p2.name == p1.name:
                        continue
                    stacked = self._patched_template(pt1, p2)
                    if stacked is None:
                        continue
                    key = self._template_key(stacked)
                    if key in seen:
                        continue
                    seen.add(key)
                    out.append(stacked)
        return out

    def _graph_match(self, res_name: str, elements, positions):
        """Element-labeled graph isomorphism between the residue's
        inferred bonds and each template's core graph; unique match
        required across all (patched and unpatched) templates."""
        elems = [str(e).upper() for e in elements]
        radj = _infer_bonds(elems, np.asarray(positions, np.float64))
        found = []
        for tmpl in (list(self.templates.values())
                     + self._all_patched_templates()):
            extra = self._extra_atoms(tmpl)
            core = [i for i in range(len(tmpl.atoms)) if i not in extra]
            if len(core) != len(elems):
                continue
            tmpl_elems = []
            ok = True
            for i in core:
                t = self.atom_types.get(tmpl.atoms[i].type)
                if t is None:
                    ok = False
                    break
                tmpl_elems.append((t.element or "").upper())
            if not ok or sorted(tmpl_elems) != sorted(elems):
                continue
            pos_of = {g: k for k, g in enumerate(core)}
            tadj = [set() for _ in core]
            for (i, j) in tmpl.bonds:
                if i in pos_of and j in pos_of:
                    tadj[pos_of[i]].add(pos_of[j])
                    tadj[pos_of[j]].add(pos_of[i])
            m = _isomorphism(tmpl_elems, tadj, elems, radj)
            if m is not None:
                found.append((tmpl, {core[k]: m[k] for k in range(len(core))}))
        if not found:
            return None
        # prefer residue-named templates on ambiguity, mirroring the
        # name-multiset path
        named = [f for f in found
                 if f[0].name == res_name
                 or f[0].name.startswith(res_name + "-")]
        if named:
            found = named
        if len(found) > 1:
            raise ForceFieldError(
                f"ambiguous graph-matched templates for {res_name!r}: "
                f"{[t.name for t, _ in found]}")
        return found[0]

    def _drude_def_for(self, type1: str) -> Optional[_DrudeDef]:
        for d in self.drude_defs:
            if d.type1 == type1:
                return d
        return None

    def _drude_parent(self, tmpl: _Template, site: int, parent_type: str) -> int:
        """Parent atom of a Drude within its template: the unique atom of
        the Drude definition's type2; ties broken by the nearest preceding
        atom (CHARMM files list the Drude near its parent) or the name
        convention Drude = 'D' + parent name."""
        matches = [i for i, a in enumerate(tmpl.atoms)
                   if a.type == parent_type and i != site]
        if len(matches) == 1:
            return matches[0]
        if not matches:
            raise ForceFieldError(
                f"residue {tmpl.name!r}: no atom of type {parent_type!r} to "
                f"parent Drude {tmpl.atoms[site].name!r}")
        dname = tmpl.atoms[site].name
        for i in matches:
            if "D" + tmpl.atoms[i].name == dname:
                return i
        prev = [i for i in matches if i < site]
        return (prev[-1] if prev else matches[0])

    # ------------------------------------------------------------ createSystem
    def createSystem(self, topology: PDBTopology, nonbondedMethod=NoCutoff,
                     nonbondedCutoff: float = 1.0, constraints=None,
                     rigidWater: bool = True, removeCMMotion: bool = True,
                     ewaldErrorTolerance: float = 5e-4,
                     switchDistance: Optional[float] = None,
                     useDispersionCorrection: bool = True, box=None,
                     positions=None) -> System:
        """Build a System for a topology whose residues each carry ALL
        template atoms (run Modeller.addExtraParticles first when the input
        PDB lacks Drudes/virtual sites).  `box` is a 3-vector of orthorhombic
        edge lengths in nm; defaults to `topology.box`'s diagonal when the
        topology came from a PDBFile/Modeller with a CRYST1 record.
        `positions` (nm, optional) enables the bond-graph template-matching
        fallback for renamed-atom inputs."""
        n = len(topology.atoms)
        sys_ = System()
        nonbonded = NonbondedForce()
        drude = DrudeForce()
        hbond_f = HarmonicBondForce()
        hangle_f = HarmonicAngleForce()
        torsion_f = PeriodicTorsionForce()

        if box is None:
            b = getattr(topology, "box", None)
            if b is not None:
                b = np.asarray(b, np.float64)
                box = np.diagonal(b) if b.ndim == 2 else b
        if box is not None:
            sys_.setDefaultPeriodicBoxVectors(
                (float(box[0]), 0, 0), (0, float(box[1]), 0),
                (0, 0, float(box[2])))

        # per-atom resolution --------------------------------------------------
        types: List[_AtomType] = [None] * n
        charges = np.zeros(n)
        res_of = np.zeros(n, np.int32)
        tmpl_of: List[_Template] = []
        map_of: List[Dict[int, int]] = []     # template index -> global index
        residues = topology.residues()
        pos_arr = (None if positions is None
                   else np.asarray(positions, np.float64))
        for ri, (res_name, idxs) in enumerate(residues):
            names = [topology.atoms[i].name for i in idxs]
            elems = [topology.atoms[i].element for i in idxs]
            rpos = None if pos_arr is None else pos_arr[idxs]
            tmpl, local_map = self.match_residue(res_name, names, elems,
                                                 rpos)
            mapping = {}
            for ti, li in local_map.items():
                g = idxs[li]
                mapping[ti] = g
                ta = tmpl.atoms[ti]
                if ta.type not in self.atom_types:
                    raise ForceFieldError(f"unknown atom type {ta.type!r}")
                types[g] = self.atom_types[ta.type]
                charges[g] = ta.charge
                res_of[g] = ri
            if len(mapping) != len(tmpl.atoms):
                missing = [tmpl.atoms[ti].name for ti in range(len(tmpl.atoms))
                           if ti not in mapping]
                raise ForceFieldError(
                    f"residue {res_name!r} is missing template atoms "
                    f"{missing}; run Modeller.addExtraParticles first")
            tmpl_of.append(tmpl)
            map_of.append(mapping)

        for g in range(n):
            sys_.addParticle(types[g].mass)

        # bond graph over real atoms ------------------------------------------
        bonds: List[Tuple[int, int]] = []
        for ri, (res_name, idxs) in enumerate(residues):
            tmpl, mapping = tmpl_of[ri], map_of[ri]
            for (a, b2) in tmpl.bonds:
                bonds.append((mapping[a], mapping[b2]))
        # external bonds: pair consecutive residues' external slots in order
        # (covers linear chains; branched inter-residue topologies would need
        # CONECT records, which the reference inputs don't use)
        prev_ext: List[int] = []
        for ri, (res_name, idxs) in enumerate(residues):
            tmpl, mapping = tmpl_of[ri], map_of[ri]
            ext = [mapping[e] for e in tmpl.external]
            while prev_ext and ext:
                bonds.append((prev_ext.pop(), ext.pop(0)))
            prev_ext = ext

        # residues="k" patch CROSS bonds (disulfide / crosslink class):
        # group one residue of each part; symmetric 2-residue patches
        # (whose parts collapse to one template) pair within the shared
        # pool.  Multiple candidate groups disambiguate by nearest
        # cross-bond-atom distance, which needs positions.
        def _pg(ri_, nm):
            return map_of[ri_][tmpl_of[ri_].atom_index(nm)]

        for pname, (n_parts, cross) in self.multipatch_cross.items():
            if not cross:
                continue
            pools = [[ri for ri, t in enumerate(tmpl_of)
                      if f"-{pname}#{i + 1}" in t.name]
                     for i in range(n_parts)]
            if not any(pools):
                continue
            if n_parts == 2 and pools[0] and not pools[1]:
                # symmetric-part pool: any two members bond to each other
                pool = pools[0]
                if len(pool) % 2:
                    raise ForceFieldError(
                        f"patch {pname!r}: odd number of patched "
                        f"residues ({len(pool)}) cannot pair")
                if any(n1 != n2 for (_, n1, _, n2) in cross):
                    raise ForceFieldError(
                        f"patch {pname!r}: asymmetric cross bonds with "
                        "a symmetric part pool")
                a1n = cross[0][1]
                cand_pairs = [(a, b) for i, a in enumerate(pool)
                              for b in pool[i + 1:]]
                need = len(pool) // 2
                if need == 1 and len(cand_pairs) == 1:
                    pairs = cand_pairs
                elif pos_arr is None:
                    raise ForceFieldError(
                        f"patch {pname!r}: multiple candidate residue "
                        "pairs need positions= to disambiguate by "
                        "distance")
                else:
                    scored = sorted(
                        (float(np.linalg.norm(pos_arr[_pg(a, a1n)]
                                              - pos_arr[_pg(b, a1n)])),
                         a, b)
                        for (a, b) in cand_pairs)
                    used: set = set()
                    pairs = []
                    for _, a, b in scored:
                        if a in used or b in used:
                            continue
                        pairs.append((a, b))
                        used.update((a, b))
                    if len(pairs) != need:
                        raise ForceFieldError(
                            f"patch {pname!r}: could not pair all "
                            "patched residues")
                groups = [{0: a, 1: b} for (a, b) in pairs]
            else:
                if len({len(p) for p in pools}) != 1:
                    raise ForceFieldError(
                        f"patch {pname!r}: unequal part pools "
                        f"{[len(p) for p in pools]} cannot group"
                        + ("" if all(pools) else
                           " (structurally identical parts deduplicate "
                           "to one template; symmetric pools are only "
                           "supported for residues=\"2\")"))
                need = len(pools[0])
                # greedy group assembly: seed with part 1, then attach
                # each remaining part through a cross bond to an
                # already-placed part (nearest-atom greedy matching, the
                # same rule as the 2-residue case applied per link)
                groups = [{0: a} for a in pools[0]]
                placed = {0}
                while len(placed) < n_parts:
                    link = None
                    for (k1, n1, k2, n2) in cross:
                        if k1 in placed and k2 not in placed:
                            link = (k1, n1, k2, n2)
                            break
                        if k2 in placed and k1 not in placed:
                            link = (k2, n2, k1, n1)
                            break
                    if link is None:
                        raise ForceFieldError(
                            f"patch {pname!r}: parts "
                            f"{sorted(set(range(n_parts)) - placed)} are "
                            "not connected to the rest by cross bonds; "
                            "cannot group residues")
                    ki, ni, kj, nj = link
                    pool_j = pools[kj]
                    if need == 1 and len(pool_j) == 1:
                        groups[0][kj] = pool_j[0]
                    elif pos_arr is None:
                        raise ForceFieldError(
                            f"patch {pname!r}: multiple candidate "
                            "residue groups need positions= to "
                            "disambiguate by distance")
                    else:
                        scored = sorted(
                            (float(np.linalg.norm(
                                pos_arr[_pg(g[ki], ni)]
                                - pos_arr[_pg(b, nj)])), gi, b)
                            for gi, g in enumerate(groups)
                            for b in pool_j)
                        used_g: set = set()
                        used_b: set = set()
                        for _, gi, b in scored:
                            if gi in used_g or b in used_b:
                                continue
                            groups[gi][kj] = b
                            used_g.add(gi)
                            used_b.add(b)
                        if len(used_b) != need:
                            raise ForceFieldError(
                                f"patch {pname!r}: could not group all "
                                "patched residues")
                    placed.add(kj)
            for g in groups:
                for (k1, n1, k2, n2) in cross:
                    bonds.append((_pg(g[k1], n1), _pg(g[k2], n2)))

        # virtual sites + drude identification --------------------------------
        vsite_sites = set()
        drude_rows: Dict[int, int] = {}       # global drude index -> force row
        drude_thole: List[float] = []
        anchor = np.arange(n, dtype=np.int64)  # excludeAtomWith anchor
        for ri, (res_name, idxs) in enumerate(residues):
            tmpl, mapping = tmpl_of[ri], map_of[ri]
            for v in tmpl.vsites:
                g = mapping[v.site]
                vsite_sites.add(g)
                parents = [mapping[p] for p in v.atoms]
                sys_.setVirtualSite(g, _make_vsite(v, parents))
                anchor[g] = parents[0]
            for ti, ta in enumerate(tmpl.atoms):
                d = self._drude_def_for(ta.type)
                if d is None:
                    continue
                g = mapping[ti]
                parent = mapping[self._drude_parent(tmpl, ti, d.type2)]

                def opt(t):
                    if not t:
                        return -1
                    m = [i for i, a in enumerate(tmpl.atoms) if a.type == t]
                    return mapping[m[0]] if m else -1

                row = drude.addParticle(g, parent, opt(d.type3), opt(d.type4),
                                        opt(d.type5), d.charge,
                                        d.polarizability, d.aniso12, d.aniso34)
                drude_rows[g] = row
                drude_thole.append(d.thole)
                anchor[g] = parent

        # constraints ----------------------------------------------------------
        constrained: set = set()
        dtypes = self._drude_types()
        is_h = np.array([t.element == "H" or (0 < t.mass < 1.5
                                              and t.name not in dtypes)
                         for t in types])

        def bond_key(i, j):
            ci, cj = types[i].klass, types[j].klass
            for key in ((ci, cj), (cj, ci),
                        ("@" + types[i].name, "@" + types[j].name),
                        ("@" + types[j].name, "@" + types[i].name)):
                if key in self.bond_params:
                    return self.bond_params[key]
            return None

        def angle_key(i, j, k, table):
            ci, cj, ck = types[i].klass, types[j].klass, types[k].klass
            for key in ((ci, cj, ck), (ck, cj, ci)):
                if key in table:
                    return table[key]
            return None

        water_res = set()
        if rigidWater:
            for ri, (res_name, idxs) in enumerate(residues):
                real = [g for g in idxs
                        if g not in vsite_sites and g not in drude_rows]
                elems = sorted(types[g].element for g in real)
                if res_name in _WATER_NAMES or elems == ["H", "H", "O"]:
                    if elems != ["H", "H", "O"]:
                        continue
                    water_res.add(ri)
                    o = [g for g in real if types[g].element == "O"][0]
                    hs = [g for g in real if types[g].element == "H"]
                    bp = bond_key(o, hs[0])
                    ap = angle_key(hs[0], o, hs[1], self.angle_params)
                    if bp is None or ap is None:
                        raise ForceFieldError(
                            f"rigidWater: no bond/angle parameters for "
                            f"{res_name!r} water geometry")
                    r_oh = bp[0]
                    d_hh = 2.0 * r_oh * math.sin(ap[0] / 2.0)
                    sys_.addConstraint(o, hs[0], r_oh)
                    sys_.addConstraint(o, hs[1], r_oh)
                    sys_.addConstraint(hs[0], hs[1], d_hh)
                    constrained.update({frozenset((o, hs[0])),
                                        frozenset((o, hs[1])),
                                        frozenset((hs[0], hs[1]))})

        for (i, j) in bonds:
            key = frozenset((i, j))
            if key in constrained:
                continue
            do_constrain = (constraints == AllBonds
                            or (constraints == HBonds
                                and (is_h[i] or is_h[j])))
            if do_constrain:
                bp = bond_key(i, j)
                if bp is None:
                    raise ForceFieldError(
                        f"no bond parameters for classes "
                        f"({types[i].klass}, {types[j].klass})")
                sys_.addConstraint(i, j, bp[0])
                constrained.add(key)

        # bonded terms ---------------------------------------------------------
        adj: List[List[int]] = [[] for _ in range(n)]
        for (i, j) in bonds:
            adj[i].append(j)
            adj[j].append(i)

        # general Custom*Force matching helpers (used both to excuse
        # missing harmonic parameters below and to build the forces)
        def ck_ok(item, g):
            kindk, v = item
            if v == "":
                return True
            return (v == types[g].klass if kindk == "class"
                    else v == types[g].name)

        def match_entries(entries, atoms, tags):
            best, best_wild = None, 99
            for (tag, key, vals) in entries:
                if tag not in tags:
                    continue
                for cand in (atoms, atoms[::-1]):
                    if all(ck_ok(ki, g) for ki, g in zip(key, cand)):
                        wild = sum(1 for ki in key if ki[1] == "")
                        if wild < best_wild:
                            best, best_wild = vals, wild
            return best

        def custom_covers(atoms, kind, tags):
            for cspec in self.custom_bonded:
                if cspec["kind"] == kind and match_entries(
                        cspec["entries"], atoms, tags) is not None:
                    return True
            return False

        for (i, j) in bonds:
            if frozenset((i, j)) in constrained:
                continue
            bp = bond_key(i, j)
            if bp is None:
                # decks may parameterize a bond ONLY through a general
                # CustomBondForce section (OpenMM semantics)
                if custom_covers((i, j), "bond", ("Bond",)):
                    continue
                raise ForceFieldError(
                    f"no bond parameters for classes "
                    f"({types[i].klass}, {types[j].klass})")
            hbond_f.addBond(i, j, bp[0], bp[1])

        angles = []
        for j in range(n):
            nb = sorted(adj[j])
            for x in range(len(nb)):
                for y in range(x + 1, len(nb)):
                    angles.append((nb[x], j, nb[y]))
        for (i, j, k) in angles:
            if res_of[j] in water_res:
                continue
            ap = angle_key(i, j, k, self.angle_params)
            if ap is None:
                if custom_covers((i, j, k), "angle", ("Angle",)):
                    continue
                raise ForceFieldError(
                    f"no angle parameters for classes "
                    f"({types[i].klass}, {types[j].klass}, {types[k].klass})")
            hangle_f.addAngle(i, j, k, ap[0], ap[1])
            up = angle_key(i, j, k, self.urey_params)
            if up is not None and frozenset((i, k)) not in constrained:
                hbond_f.addBond(i, k, up[0], up[1])

        def match_torsion(entries, cls):
            best = None
            best_wild = 5
            for key, terms in entries:
                for cand in (cls, cls[::-1]):
                    if all(k == "" or k == c for k, c in zip(key, cand)):
                        wild = sum(1 for k in key if k == "")
                        if wild < best_wild:
                            best, best_wild = terms, wild
            return best

        if self.proper:
            seen = set()
            for (j, k) in bonds:
                for (a, b2) in ((j, k), (k, j)):
                    for i in adj[a]:
                        if i == b2:
                            continue
                        for l in adj[b2]:
                            if l == a or l == i:
                                continue
                            quad = (i, a, b2, l)
                            if quad[::-1] in seen or quad in seen:
                                continue
                            seen.add(quad)
                            terms = match_torsion(
                                self.proper, tuple(types[x].klass for x in quad))
                            if terms:
                                for (per, phase, kk) in terms:
                                    torsion_f.addTorsion(*quad, per, phase, kk)
        if self.improper:
            for c in range(n):
                nb = sorted(adj[c])
                if len(nb) < 3:
                    continue
                import itertools
                matched = None
                for perm in itertools.permutations(nb, 3):
                    quad = (c,) + perm
                    terms = match_torsion(
                        self.improper, tuple(types[x].klass for x in quad))
                    if terms:
                        matched = (quad, terms)
                        break
                if matched:
                    quad, terms = matched
                    for (per, phase, kk) in terms:
                        torsion_f.addTorsion(*quad, per, phase, kk)

        harm_torsion_f = HarmonicTorsionForce()
        if self.harmonic_improper:
            import itertools
            for c in range(n):
                nbh = sorted(adj[c])
                if len(nbh) < 3:
                    continue
                matched = None
                for perm in itertools.permutations(nbh, 3):
                    quad = (c,) + perm
                    hit = match_torsion(
                        self.harmonic_improper,
                        tuple(types[x].klass for x in quad))
                    if hit:
                        matched = (quad, hit)
                        break
                if matched:
                    quad, (th0, kk) = matched
                    harm_torsion_f.addTorsion(*quad, th0, kk)

        # CMAP (phi, psi) pairs: every path of five consecutively bonded
        # atoms whose classes match a <Torsion> entry (forward or
        # reversed; reversed matches add the atoms reversed so the
        # asymmetric map keeps its (angle1, angle2) orientation)
        cmap_f = CMAPTorsionForce()
        if self.cmap_torsions:
            map_rows: Dict[int, int] = {}
            seen5 = set()
            for (ba, bb) in bonds:
                for (p2, p3) in ((ba, bb), (bb, ba)):
                    for p1 in adj[p2]:
                        if p1 == p3:
                            continue
                        for p4 in adj[p3]:
                            if p4 in (p2, p1):
                                continue
                            for p5 in adj[p4]:
                                if p5 in (p3, p2, p1):
                                    continue
                                quint = (p1, p2, p3, p4, p5)
                                if quint in seen5 or quint[::-1] in seen5:
                                    continue
                                seen5.add(quint)
                                cls = tuple(types[x].klass for x in quint)
                                best = None
                                best_wild = 6
                                for key, mi in self.cmap_torsions:
                                    for cand, atoms in ((cls, quint),
                                                        (cls[::-1],
                                                         quint[::-1])):
                                        if all(kk == "" or kk == cc
                                               for kk, cc in zip(key, cand)):
                                            wild = sum(1 for kk in key
                                                       if kk == "")
                                            if wild < best_wild:
                                                best = (mi, atoms)
                                                best_wild = wild
                                if best is not None:
                                    mi, atoms = best
                                    if mi not in map_rows:
                                        size, vals = self.cmap_maps[mi]
                                        map_rows[mi] = cmap_f.addMap(size,
                                                                     vals)
                                    cmap_f.addTorsion(map_rows[mi],
                                                      *atoms[0:4],
                                                      *atoms[1:5])

        # general Custom*Force bonded sections (expression-compiled) ----------
        custom_forces: list = []
        if self.custom_bonded:
            from ..forces.custom import (CustomAngleForce, CustomBondForce,
                                         CustomTorsionForce)

            for cspec in self.custom_bonded:
                if cspec["kind"] == "bond":
                    f = CustomBondForce(cspec["energy"])
                    for p in cspec["pnames"]:
                        f.addPerBondParameter(p)
                    for nm, dv in cspec["globals"]:
                        f.addGlobalParameter(nm, dv)
                    for (i, j) in bonds:
                        vals = match_entries(cspec["entries"], (i, j),
                                             ("Bond",))
                        if vals is not None:
                            f.addBond(i, j, vals)
                    if f.getNumBonds():
                        custom_forces.append(f)
                elif cspec["kind"] == "angle":
                    f = CustomAngleForce(cspec["energy"])
                    for p in cspec["pnames"]:
                        f.addPerAngleParameter(p)
                    for nm, dv in cspec["globals"]:
                        f.addGlobalParameter(nm, dv)
                    for (i, j, k) in angles:
                        vals = match_entries(cspec["entries"], (i, j, k),
                                             ("Angle",))
                        if vals is not None:
                            f.addAngle(i, j, k, vals)
                    if f.getNumAngles():
                        custom_forces.append(f)
                else:                                   # torsion
                    f = CustomTorsionForce(cspec["energy"])
                    for p in cspec["pnames"]:
                        f.addPerTorsionParameter(p)
                    for nm, dv in cspec["globals"]:
                        f.addGlobalParameter(nm, dv)
                    if any(t == "Proper" for (t, _, _) in cspec["entries"]):
                        seen_q = set()
                        for (bj, bk) in bonds:
                            for (a, b2) in ((bj, bk), (bk, bj)):
                                for i in adj[a]:
                                    if i == b2:
                                        continue
                                    for l in adj[b2]:
                                        if l == a or l == i:
                                            continue
                                        quad = (i, a, b2, l)
                                        if (quad in seen_q
                                                or quad[::-1] in seen_q):
                                            continue
                                        seen_q.add(quad)
                                        vals = match_entries(
                                            cspec["entries"], quad,
                                            ("Proper",))
                                        if vals is not None:
                                            f.addTorsion(*quad, vals)
                    if any(t == "Improper"
                           for (t, _, _) in cspec["entries"]):
                        import itertools
                        for c in range(n):
                            nbh = sorted(adj[c])
                            if len(nbh) < 3:
                                continue
                            for perm in itertools.permutations(nbh, 3):
                                quad = (c,) + perm
                                vals = match_entries(cspec["entries"],
                                                     quad, ("Improper",))
                                if vals is not None:
                                    f.addTorsion(*quad, vals)
                                    break
                    if f.getNumTorsions():
                        custom_forces.append(f)

        # nonbonded ------------------------------------------------------------
        sig = np.ones(n)
        eps = np.zeros(n)
        sig14 = np.ones(n)
        eps14 = np.zeros(n)
        for g in range(n):
            t = types[g]
            if t.name in self.nb_by_type:
                s, e, q = self.nb_by_type[t.name]
                sig[g], eps[g] = s, e
                sig14[g], eps14[g] = s, e
                if q is not None and not self.nb_uses_residue_charge:
                    charges[g] = q
            elif self.nb_by_type:
                raise ForceFieldError(
                    f"no NonbondedForce parameters for type {t.name!r}")
            if self.has_lj_force and t.klass in self.lj_by_class:
                s, e, s14, e14 = self.lj_by_class[t.klass]
                sig[g], eps[g] = s, e
                sig14[g], eps14[g] = s14, e14
        for g in range(n):
            nonbonded.addParticle(charges[g], sig[g], eps[g])

        nonbonded.setNonbondedMethod(nonbondedMethod)
        nonbonded.setCutoffDistance(nonbondedCutoff)
        nonbonded.setEwaldErrorTolerance(ewaldErrorTolerance)
        nonbonded.setUseDispersionCorrection(useDispersionCorrection)
        if switchDistance is not None:
            nonbonded.setUseSwitchingFunction(True)
            nonbonded.setSwitchingDistance(switchDistance)

        # exceptions: anchor-graph distances (excludeAtomWith semantics) ------
        real_adj: List[List[int]] = [[] for _ in range(n)]
        for (i, j) in bonds:
            ai, aj = int(anchor[i]), int(anchor[j])
            if ai != aj:
                real_adj[ai].append(aj)
                real_adj[aj].append(ai)
        for key in constrained:
            i, j = tuple(key)
            ai, aj = int(anchor[i]), int(anchor[j])
            if ai != aj and aj not in real_adj[ai]:
                real_adj[ai].append(aj)
                real_adj[aj].append(ai)
        group: Dict[int, List[int]] = {}
        for g in range(n):
            group.setdefault(int(anchor[g]), []).append(g)

        lj14scale = self.lj_lj14 if self.has_lj_force else self.lj14
        seen_exc = set()

        def add_exception(a, b2, scale14):
            key = (min(a, b2), max(a, b2))
            if key in seen_exc:
                return
            seen_exc.add(key)
            if scale14:
                qq = charges[a] * charges[b2] * self.coulomb14
                ss = 0.5 * (sig14[a] + sig14[b2])
                ee = math.sqrt(eps14[a] * eps14[b2]) * lj14scale
                nonbonded.addException(a, b2, qq, ss, ee)
            else:
                nonbonded.addException(a, b2, 0.0, 1.0, 0.0)

        for a0 in group:
            # BFS to distance 3 over anchors
            dist = {a0: 0}
            frontier = [a0]
            for d in range(1, 4):
                nxt = []
                for u in frontier:
                    for v in real_adj[u]:
                        if v not in dist:
                            dist[v] = d
                            nxt.append(v)
                frontier = nxt
            for b0, d in dist.items():
                if b0 < a0:
                    continue
                for a in group[a0]:
                    for b2 in group[b0]:
                        if a == b2:
                            continue
                        if d <= 2:
                            add_exception(a, b2, False)
                        elif d == 3:
                            add_exception(a, b2, True)

        # Thole screened pairs between 1-2 / 1-3 bonded Drude parents ---------
        rows = sorted(drude_rows.items())  # (global drude idx, row)
        parent_of_row = {row: int(anchor[g]) for g, row in rows}
        # the rows of each parent, with their place in `rows`: a row's
        # partners are looked up among the parents 1-2 bonds away, in the
        # order of `rows` (the JAX package scans every row for every row,
        # quadratic: ~25 s of host time at 20,480 Drude rows)
        rows_of_parent: Dict[int, list] = {}
        for k, (gj, rj_) in enumerate(rows):
            rows_of_parent.setdefault(parent_of_row[rj_], []).append((k, rj_))
        for gi, ri_ in rows:
            pi = parent_of_row[ri_]
            dist = {pi: 0}
            frontier = [pi]
            for d in range(1, 3):
                nxt = []
                for u in frontier:
                    for v in real_adj[u]:
                        if v not in dist:
                            dist[v] = d
                            nxt.append(v)
                frontier = nxt
            partners = sorted(kr for v, d in dist.items() if d >= 1
                              for kr in rows_of_parent.get(v, ())
                              if kr[1] > ri_)
            for _, rj_ in partners:
                drude.addScreenedPair(
                    ri_, rj_, drude_thole[ri_] + drude_thole[rj_])

        # NBTHOLE (extension tag): screened NONBONDED ion pairs ---------------
        if self.nbthole_defs:
            type_of_row = {row: types[g].name for g, row in rows}
            for (t1, t2, th) in self.nbthole_defs:
                r1 = [r for r, t in type_of_row.items() if t == t1]
                r2 = [r for r, t in type_of_row.items() if t == t2]
                for a in r1:
                    for b2 in r2:
                        if a == b2 or (t1 == t2 and a > b2):
                            continue
                        if parent_of_row[a] == parent_of_row[b2]:
                            continue
                        drude.addNBTholePair(a, b2, th)

        # general CustomNonbondedForce (expression-compiled) ------------------
        if self.custom_nonbonded is not None:
            from ..forces.custom import CustomNonbondedForce
            cnspec = self.custom_nonbonded
            cn = CustomNonbondedForce(cnspec["energy"])
            for p in cnspec["pnames"]:
                cn.addPerParticleParameter(p)
            for nm, dv in cnspec["globals"]:
                cn.addGlobalParameter(nm, dv)
            for g in range(n):
                t = types[g]
                vals = cnspec["by_type"].get(
                    t.name, cnspec["by_class"].get(t.klass))
                if vals is None:
                    raise ForceFieldError(
                        f"no <CustomNonbondedForce> parameters for type "
                        f"{t.name!r} (class {t.klass!r})")
                cn.addParticle(vals)
            # exclusions: pairs within bondCutoff bonds over the anchor
            # graph, groups expanded so Drudes/vsites follow their parents
            # (same excludeAtomWith semantics as the NonbondedForce
            # exception machinery above)
            bc = cnspec["bond_cutoff"]
            for a0 in group:
                dist = {a0: 0}
                frontier = [a0]
                for d in range(1, bc + 1):
                    nxt = []
                    for u in frontier:
                        for v in real_adj[u]:
                            if v not in dist:
                                dist[v] = d
                                nxt.append(v)
                    frontier = nxt
                for b0 in dist:
                    if b0 < a0:
                        continue
                    for a in group[a0]:
                        for b2 in group[b0]:
                            if a < b2:
                                cn.addExclusion(a, b2)
            if nonbondedMethod == NoCutoff:
                cn.setNonbondedMethod(CustomNonbondedForce.NoCutoff)
            elif nonbondedMethod == CutoffNonPeriodic:
                cn.setNonbondedMethod(
                    CustomNonbondedForce.CutoffNonPeriodic)
                cn.setCutoffDistance(nonbondedCutoff)
            else:
                cn.setNonbondedMethod(CustomNonbondedForce.CutoffPeriodic)
                cn.setCutoffDistance(nonbondedCutoff)
            if switchDistance is not None:
                cn.setUseSwitchingFunction(True)
                cn.setSwitchingDistance(switchDistance)
            custom_forces.append(cn)

        # NBFIX pair overrides -------------------------------------------------
        for (c1, c2, s, e) in self.nbfix:
            p1 = [g for g in range(n) if types[g].klass == c1]
            p2 = [g for g in range(n) if types[g].klass == c2]
            if p1 and p2:
                nonbonded.addLJPairOverride(p1, p2, s, e)

        # assemble -------------------------------------------------------------
        sys_.addForce(nonbonded)
        if drude.getNumParticles():
            sys_.addForce(drude)
        if hbond_f.getNumBonds():
            sys_.addForce(hbond_f)
        if hangle_f.getNumAngles():
            sys_.addForce(hangle_f)
        if torsion_f.getNumTorsions():
            sys_.addForce(torsion_f)
        if harm_torsion_f.getNumTorsions():
            sys_.addForce(harm_torsion_f)
        if cmap_f.getNumTorsions():
            sys_.addForce(cmap_f)
        for f in custom_forces:
            sys_.addForce(f)
        if removeCMMotion:
            sys_.addForce(CMMotionRemover())
        return sys_


def _make_vsite(v: _VSiteDef, parents: List[int]):
    if v.kind == "average2":
        w = v.params["weights"]
        return TwoParticleAverageSite(parents[0], parents[1], w[0], w[1])
    if v.kind == "average3":
        w = v.params["weights"]
        return ThreeParticleAverageSite(parents[0], parents[1], parents[2],
                                        w[0], w[1], w[2])
    if v.kind == "outOfPlane":
        w = v.params["weights"]
        return OutOfPlaneSite(parents[0], parents[1], parents[2],
                              w[0], w[1], w[2])
    if v.kind == "localCoords":
        p = v.params
        return LocalCoordinatesSite(parents, p["origin"], p["x"], p["y"],
                                    p["pos"])
    raise ForceFieldError(f"unsupported virtual site kind {v.kind!r}")


def _vsite_position(v: _VSiteDef, pos: np.ndarray, parents: List[int]):
    ppos = pos[parents]
    if v.kind in ("average2", "average3"):
        w = np.asarray(v.params["weights"])
        return (w[:, None] * ppos).sum(0)
    if v.kind == "outOfPlane":
        w12, w13, wc = v.params["weights"]
        r12 = ppos[1] - ppos[0]
        r13 = ppos[2] - ppos[0]
        return ppos[0] + w12 * r12 + w13 * r13 + wc * np.cross(r12, r13)
    if v.kind == "localCoords":
        p = v.params
        origin = (np.asarray(p["origin"])[:, None] * ppos).sum(0)
        xdir = (np.asarray(p["x"])[:, None] * ppos).sum(0)
        ydir = (np.asarray(p["y"])[:, None] * ppos).sum(0)
        xhat = xdir / np.linalg.norm(xdir)
        z = np.cross(xdir, ydir)
        zhat = z / np.linalg.norm(z)
        yhat = np.cross(zhat, xhat)
        local = p["pos"]
        return origin + local[0] * xhat + local[1] * yhat + local[2] * zhat
    raise ForceFieldError(f"unsupported virtual site kind {v.kind!r}")


class Modeller:
    """Holds a topology + positions and edits them (the subset of OpenMM's
    Modeller the reference workflow uses: addExtraParticles,
    example/nacl_tg.py:38-40)."""

    def __init__(self, topology: PDBTopology, positions, box=None):
        self.topology = topology
        self.positions = np.asarray(positions, np.float64)
        if box is None:
            box = getattr(topology, "box", None)
        self.box = None if box is None else np.asarray(box, np.float64)

    def addExtraParticles(self, forcefield: ForceField) -> None:
        """Add the template atoms missing from each residue (Drude shells at
        their parent's position, virtual sites at their computed position),
        re-ordering each residue into template order."""
        atoms = self.topology.atoms
        new_atoms: List[PDBAtom] = []
        new_pos: List[np.ndarray] = []
        dtypes = forcefield._drude_types()
        for res_name, idxs in self.topology.residues():
            names = [atoms[i].name for i in idxs]
            elems = [atoms[i].element for i in idxs]
            tmpl, local_map = forcefield.match_residue(
                res_name, names, elems, self.positions[idxs])
            have_ti = {ti: idxs[li] for ti, li in local_map.items()}
            a0 = atoms[idxs[0]]
            # first pass: place real + drude atoms in template order
            placed: Dict[int, np.ndarray] = {}
            deferred: List[int] = []
            for ti, ta in enumerate(tmpl.atoms):
                if ti in have_ti:
                    placed[ti] = self.positions[have_ti[ti]]
                elif ta.type in dtypes:
                    d = forcefield._drude_def_for(ta.type)
                    pi = forcefield._drude_parent(tmpl, ti, d.type2)
                    if pi not in have_ti:
                        raise ForceFieldError(
                            f"residue {res_name!r}: Drude {ta.name!r} parent "
                            f"{tmpl.atoms[pi].name!r} missing from input")
                    placed[ti] = self.positions[have_ti[pi]]
                else:
                    deferred.append(ti)
            vs_by_site = {v.site: v for v in tmpl.vsites}
            for ti in deferred:
                v = vs_by_site.get(ti)
                if v is None:
                    raise ForceFieldError(
                        f"residue {res_name!r}: atom {tmpl.atoms[ti].name!r} "
                        "is missing and is neither a Drude nor a virtual site")
                ppos = np.stack([placed[p] for p in v.atoms])
                placed[ti] = _vsite_position(v, ppos,
                                             list(range(len(v.atoms))))
            for ti, ta in enumerate(tmpl.atoms):
                elem = (forcefield.atom_types[ta.type].element
                        or ta.name[:1])
                new_atoms.append(PDBAtom(
                    serial=len(new_atoms) + 1, name=ta.name,
                    res_name=res_name, chain=a0.chain, res_seq=a0.res_seq,
                    element=elem))
                new_pos.append(placed[ti])
        top = PDBTopology(new_atoms)
        if self.box is not None:
            top.box = self.box
        self.topology = top
        self.positions = np.asarray(new_pos, np.float64)
