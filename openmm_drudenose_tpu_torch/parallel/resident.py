"""State-resident spatial decomposition over torch.distributed ranks: each
rank owns an x-slab of MOLECULES, their dynamic state, their cell sort
and every per-molecule table, so memory a rank is O(N / ranks) (the JAX
package's parallel/resident.py; parallel/sharded.py keeps the whole
state on every rank instead).

  * Molecule-major local layout (the JAX module's :10-15): Rc molecule
    slots of K atom slots each (K the largest molecule), then a dummy
    block of Kd = max(K, 5) atoms, where the unused slots' partner and
    residue rows point.  Every table comes from per-TYPE templates
    (`analyze`: molecules typed by their parameters), so a migration
    moves only (type, global base, positions, velocities, forces,
    pos_err).  The term rows (constraints, sites, springs, pairs,
    bonded) are the used molecules' alone, compacted at each rebuild
    (`local_tables`); the JAX tables pad them onto the dummies.
  * Clamped binning (`local_cellsort`): an owned molecule's atoms bin
    into the slab's own cell planes, an atom's x-cell clamped to the
    nearest slab edge in periodic plane distance.  The clamp moves an
    atom at most one plane (a latch says where it would move more), so
    a pair's cells lie at most w + 2 planes apart, w the grid's window.
    The sweep reads cell-local coordinates (position - image * box -
    the CLAMPED cell's centre, in float64 from the compensated
    positions, then rounded once) and one image shift an offset, not a
    minimum image a pair, so a clamped atom's image is the one that
    puts it beside its clamped cell: rank 0's atom just below x = box_x,
    clamped into cell 0, takes image + 1.
  * The sweep on kernel B1 (`ResidentContext._sweep`): the JAX module
    runs the full +/- stencil in XLA over a ring halo of (w + 2) planes
    on each side (:1094-1233).  The port's block is the slab plus the
    next rank's first w + 2 planes, open in x (parallel/domain.py), and
    its stencil the UNTRIMMED half stencil of window (w + 2, w_y, w_z)
    (forces/cellpair.py::_neighbor_offsets; the trim reads cell
    geometry a clamped atom does not keep): B1 sums it with a home-slab
    range of the slab's cells and the halo's reactions go back on the
    ring.  A pair the stencil reaches twice (across the periodic x
    edge) is reached with two images a box length apart, of which one
    at most lies inside the cutoff.  Float64 runs the plain sweep with
    the exact erfc, as forces/nonbonded.py::CellPairTerm does.  B2 has
    no resident form: a block config B1 does not take raises.
  * The molecule-local pair terms (exceptions, the Ewald exclusion
    corrections with forces/pairterms.py's float32 series), the Drude
    springs and screened pairs (forces/drude.py) and the bonded terms
    (forces/bonded.py) run on local rows with analytic forces: the
    port's own term objects, built on local indices at each rebuild.
    NBTHOLE (type-complete lists only, `_analyze_nbthole`) is a dense
    block of each rank's class-tagged sites against the all_gather of
    every rank's: each rank sums its rows, so the forces on owned atoms
    are complete; the half factor is the energy's alone.
  * PME: each rank spreads its own atoms into the int64 fixed-point
    grid, all-reduced (parallel/sharded.py::reduced_reciprocal), so
    the grid is the one-rank grid bit for bit; every rank transforms
    the whole grid and interpolates its own atoms' forces.
  * No force is all-reduced: the forces on owned atoms are complete.
    The energy is the all-reduce of the ranks' parts, with the constant
    terms (PME self term, dispersion / V) added once after it.
  * The TGNH step is integrators/tgnh.py::Stepper on the LOCAL spec
    and state with a `reduce` (the JAX make_step's reduce_axis): the
    (G+2) KE vector, and with CM removal the CM momentum and the total
    mass, are summed over the ranks on their way to the host, once a
    fused step; the NH chains (one a rank, on its host) and the box,
    the step and the barostat's generator and counters stay the same
    bits on every rank (`step` checks it).  The barostat's N kT ln V
    term takes the GLOBAL molecule count.
  * Migration at rebuild cadence (`_migrate`): molecules whose anchor
    (first atom) crossed into a neighbouring slab move on the ring in
    fixed-capacity Ec buffers; a latch catches Ec or Rc overflow and a
    jump of more than one slab.

Per step on the wire: the halo of w + 2 boundary planes and its
reactions, one (G+2) KE all-reduce (with the CM momentum), the PME grid.

Scope (the JAX module's, its refusals kept with their exception types):
the cell-pair strategy, PME or the reaction field, SETTLE, SHAKE
clusters, virtual sites, Drude springs, screened pairs, exceptions and
exclusion corrections, harmonic bonds and angles, periodic torsions, the
MC barostat, NBTHOLE where its list is type-complete.  CMAP, custom and
harmonic-torsion forces and NBFIX overrides raise NotImplementedError.

    mesh = comm.Mesh(("atom",))              # on every rank
    rctx = ResidentContext(ctx, mesh)
    rctx.step(1000)
    pos = rctx.positions()                   # global atom order
"""

from __future__ import annotations

import collections
import dataclasses
import types
import warnings

import numpy as np
import torch

from ..app.context import exact_positions, force_pass
from ..constraints.vsites import apply_vsites
from ..core.spec import SystemSpec
from ..forces import bonded, boxutils, cellpair, pairterms
from ..forces.drude import DrudeForce, DrudeTerm
from ..integrators import barostat, tgnh
from ..ops import scatter, sweep
from ..units import ONE_4PI_EPS0
from . import comm, domain, sharded


# ---------------------------------------------------------------------------
# host-side analysis: molecule types and per-type templates
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResidentLayout:
    n_dev: int
    K: int            # atom slots per molecule
    Rc: int           # molecule slots per rank
    Ec: int           # emigrant molecule capacity per direction
    s_max: int        # settle rows per molecule
    va_max: int
    vo_max: int
    vl_max: int
    lc_k: int
    d_max: int        # drude spring rows per molecule
    sp_max: int       # screened-pair rows
    e_max: int        # exclusion-correction rows
    x_max: int        # active exception rows
    b_max: int        # harmonic bond rows
    a_max: int        # harmonic angle rows
    t_max: int        # torsion rows
    sh_max: int       # SHAKE constraint rows per molecule
    n_words: int
    loc_x: int        # cell planes per rank
    has_aniso1: bool
    has_aniso2: bool
    Kd: int = 5       # dummy block size
    nt_cap: int = 0   # NBTHOLE site capacity per rank (0 = no NBTHOLE)

    @property
    def n_loc(self) -> int:
        return self.Rc * self.K + self.Kd


# per-molecule-TYPE tables, every one leading with the type (the JAX
# Templates :110-196 without the settle gather and the incidence tables,
# which the port's SETTLE and scatter-adds do not read; with the inverse
# residue mass, taken from the spec so that the local spec holds its
# bits)
Templates = collections.namedtuple("Templates", (
    "mass", "inv_mass", "charge", "sigma", "eps", "tg", "is_pair",
    "is_parent", "partner_off", "gid_off", "ew", "valid", "res_mass",
    "res_inv_mass", "settle_off", "settle_dist", "vsa_site", "vsa_p",
    "vsa_w", "vso_site", "vso_p", "vso_w", "vsl_site", "vsl_p", "vsl_ow",
    "vsl_xw", "vsl_yw", "vsl_local", "dr_d", "dr_c", "dr_p2", "dr_p3",
    "dr_p4", "dr_k3", "dr_k1", "dr_k2", "sp_d1", "sp_c1", "sp_d2",
    "sp_c2", "sp_scale", "sp_qq", "exc_i", "exc_j", "exc_qq", "x_i",
    "x_j", "x_qq", "x_sig", "x_eps", "bd_i", "bd_j", "bd_r0", "bd_k",
    "an_i", "an_j", "an_k_", "an_t0", "an_k", "to_i", "to_j", "to_k_",
    "to_l", "to_phase", "to_n", "to_k", "sh_i", "sh_j", "sh_d",
    "nt_class", "nt_w"))

# the compiled terms a resident Context takes besides the nonbonded one,
# by class (the JAX :383-405 tells them apart by their parameter keys)
_TERM_KINDS = {DrudeTerm: "drude", bonded._BondTerm: "bond",
               bonded._AngleTerm: "angle",
               bonded._PeriodicTorsionTerm: "torsion"}


def _drude_force(system):
    return next((f for f in system.getForces()
                 if isinstance(f, DrudeForce)), None)


def _analyze_nbthole(context, mol_of, n):
    """Type-class analysis of the DrudeForce NBTHOLE pair list (the JAX
    :199-273).  The explicit list pins pairs by Drude-pair index, which
    cannot follow a migration.  When it is TYPE-COMPLETE (classes of
    involved Drude pairs by (polarizability, shell charge), one thole a
    class pair, every cross-molecule combination of listed class pairs
    present once) it is the dense sum over class-tagged sites

        E = k_e/2 sum over sites a != b, mol_a != mol_b, of
              w_a w_b deficit(tab[c_a, c_b] r_ab) / r_ab

    with w = +q_d on shells and -q_d on cores, deficit(u) = -(1 + u/2)
    e^-u and tab[a, b] = thole_ab / (alpha_a alpha_b)^(1/6).

    Returns (nt_class (n,) int32, 0 = inactive; nt_w (n,) float64;
    scale_tab (ncls+1, ncls+1) float64); raises NotImplementedError when
    the list does not have this structure."""
    df = _drude_force(context._system)
    parts = df._particles
    ntl = df._nbthole
    involved = sorted({p for e in ntl for p in e[:2]})
    keys = {}
    cls_of = {}
    for p in involved:
        key = (float(parts[p][6]), float(parts[p][5]))  # (alpha, q_d)
        cls_of[p] = keys.setdefault(key, len(keys) + 1)
    tab_thole = {}
    seen = set()
    for p1, p2, th in ntl:
        a, b = cls_of[p1], cls_of[p2]
        kk = (min(a, b), max(a, b))
        if tab_thole.setdefault(kk, float(th)) != float(th):
            raise NotImplementedError(
                "resident mode: NBTHOLE thole values differ within one "
                "(polarizability, charge) class pair")
        pr = (min(p1, p2), max(p1, p2))
        if p1 == p2 or pr in seen:
            raise NotImplementedError(
                "resident mode: degenerate/duplicate NBTHOLE pair")
        seen.add(pr)
        if mol_of[parts[p1][1]] == mol_of[parts[p2][1]]:
            raise NotImplementedError(
                "resident mode: NBTHOLE pair within one molecule (use "
                "addScreenedPair for bonded Thole screening)")
    for i, p in enumerate(involved):
        for q in involved[i + 1:]:
            kk = (min(cls_of[p], cls_of[q]), max(cls_of[p], cls_of[q]))
            if kk not in tab_thole:
                continue
            if (mol_of[parts[p][1]] != mol_of[parts[q][1]]
                    and (p, q) not in seen):
                raise NotImplementedError(
                    "resident mode: NBTHOLE list is not type-complete "
                    f"(missing pair of Drude pairs {p}, {q})")
    ncls = len(keys)
    alpha_of = {c: k[0] for k, c in keys.items()}
    tab = np.zeros((ncls + 1, ncls + 1))
    for (a, b), th in tab_thole.items():
        tab[a, b] = tab[b, a] = th / (alpha_of[a] * alpha_of[b]) ** (1 / 6)
    nt_class = np.zeros(n, np.int32)
    nt_w = np.zeros(n)
    for p in involved:
        shell, core, qd = parts[p][0], parts[p][1], parts[p][5]
        nt_class[shell] = nt_class[core] = cls_of[p]
        nt_w[shell] = qd
        nt_w[core] = -qd
    return nt_class, nt_w, tab


def _group_rows(rows, mol_of, R):
    """Term rows (P, m) atom indices (-1 pads) grouped by the molecule
    of their first atom: a list of R row-index arrays.  A row across
    molecules raises AssertionError (the JAX module's assert)."""
    if not len(rows):
        return [np.zeros(0, np.int64)] * R
    rows = np.asarray(rows, np.int64).reshape(len(rows), -1)
    mol = mol_of[rows[:, 0]]
    other = np.where(rows >= 0, mol_of[np.maximum(rows, 0)], mol[:, None])
    if np.any(other != mol[:, None]):
        raise AssertionError("resident mode requires intra-molecular term "
                             "rows")
    order = np.argsort(mol, kind="stable")
    return np.split(order, np.cumsum(np.bincount(mol, minlength=R))[:-1])


def _host(t, dtype=None):
    return np.asarray(t.detach().cpu().numpy(), dtype)


def analyze(context):
    """Molecule-type analysis of a built port Context (the JAX :276-690):
    its spec, its compiled nonbonded term (the cell-pair strategy) and
    its other terms, with the parameters in float64 from the System's
    forces, as the terms compile them.

    Returns (templates: dict of numpy arrays by the Templates names,
    mol_type (R,), mol_base (R,), maxima dict: the row counts a molecule,
    lc_k, n_words, K, has_aniso1/2, nt_tab and the term kinds in the
    Context's order)."""
    spec, static = context._spec, context._static
    n = static.n_atoms
    nb = context._nb
    if nb is None or getattr(nb, "strategy", None) != "cellpair":
        raise ValueError("resident mode requires the cellpair strategy "
                         "(Context(..., strategy='cellpair'))")
    if nb.n_replicas > 1 or nb.cfg.triclinic:
        raise ValueError("resident mode takes one orthorhombic system")
    if nb.override_term is not None:
        raise NotImplementedError("resident mode: NBFIX overrides "
                                  "(addLJPairOverride) are not supported")
    kinds = []
    for term in context._terms:
        kind = _TERM_KINDS.get(type(term))
        if kind is None:
            raise NotImplementedError(
                "resident mode supports nonbonded + DrudeForce + harmonic "
                "bonds, angles and periodic torsions (found "
                f"{type(term).__name__})")
        if kind not in kinds:
            kinds.append(kind)
    system = context._system
    nbf = next(f for f in system.getForces()
               if type(f).__name__ == "NonbondedForce")
    prt = nbf._particles
    charge = np.array([x[0] for x in prt], np.float64)
    sigma = np.array([x[1] for x in prt], np.float64)
    eps = np.array([x[2] for x in prt], np.float64)
    ew = _host(nb.params["excl_words"], np.int32)
    mass = _host(spec.mass, np.float64)
    inv_mass = _host(spec.inv_mass, np.float64)
    tg = _host(spec.tg, np.int64)
    is_pair = _host(spec.is_pair, bool)
    is_parent = _host(spec.is_parent, bool)
    partner = _host(spec.partner, np.int64)
    resid = _host(spec.resid, np.int64)
    res_mass = _host(spec.res_mass, np.float64)
    res_inv_mass = _host(spec.res_inv_mass, np.float64)
    R = len(res_mass)
    counts = np.bincount(resid, minlength=R)
    K = int(counts.max())
    n_words = ew.shape[1]
    # each molecule's atoms in ascending order (the JAX spec's
    # res_members), their molecule and member offset
    order = np.argsort(resid, kind="stable")
    start = np.concatenate([[0], np.cumsum(counts)])
    mol_of = resid
    off_of = np.empty(n, np.int64)
    off_of[order] = np.arange(n) - start[resid[order]]
    members = [order[start[r]:start[r + 1]] for r in range(R)]

    settle_idx = _host(spec.settle_idx, np.int64).reshape(-1, 3)
    settle_dist = _host(spec.settle_dist, np.float64).reshape(-1, 2)
    settle_by = _group_rows(settle_idx, mol_of, R)
    shk_idx = _host(spec.shake_idx, np.int64).reshape(-1, 2)
    shk_dist = _host(spec.shake_dist, np.float64)
    shake_by = _group_rows(shk_idx, mol_of, R)
    vsa_idx = _host(spec.vs_avg_idx, np.int64)
    vsa_p = _host(spec.vs_avg_p, np.int64).reshape(-1, 3)
    vsa_w = _host(spec.vs_avg_w, np.float64).reshape(-1, 3)
    vsa_by = _group_rows(vsa_idx[:, None], mol_of, R)
    vso_idx = _host(spec.vs_oop_idx, np.int64)
    vso_p = _host(spec.vs_oop_p, np.int64).reshape(-1, 3)
    vso_w = _host(spec.vs_oop_w, np.float64).reshape(-1, 3)
    vso_by = _group_rows(vso_idx[:, None], mol_of, R)
    vsl_idx = _host(spec.vs_lc_idx, np.int64)
    lc_k = spec.vs_lc_p.shape[1] if len(vsl_idx) else 1
    vsl_p = _host(spec.vs_lc_p, np.int64).reshape(-1, lc_k)
    vsl_ow, vsl_xw, vsl_yw = (_host(t, np.float64).reshape(-1, lc_k)
                              for t in (spec.vs_lc_ow, spec.vs_lc_xw,
                                        spec.vs_lc_yw))
    vsl_local = _host(spec.vs_lc_local, np.float64).reshape(-1, 3)
    vsl_by = _group_rows(vsl_idx[:, None], mol_of, R)

    # the DrudeForce, as forces/drude.py compiles it
    df = _drude_force(system) if "drude" in kinds else None
    nt_class_a = np.zeros(n, np.int32)
    nt_w_a = np.zeros(n)
    nt_tab = None
    dp = {}
    dr_by = sp_by = [np.zeros(0, np.int64)] * R
    has_aniso1 = has_aniso2 = False
    if df is not None:
        P = df._particles
        col = lambda c, dt: np.array([x[c] for x in P], dt)
        dp["drude"], dp["parent"] = col(0, np.int64), col(1, np.int64)
        p2, p3, p4 = col(2, np.int64), col(3, np.int64), col(4, np.int64)
        q_d, alpha = col(5, np.float64), col(6, np.float64)
        a1 = np.where(p2 >= 0, col(7, np.float64), 1.0)
        a2 = np.where(p3 >= 0, col(8, np.float64), 1.0)
        ktot = ONE_4PI_EPS0 * q_d * q_d / alpha
        dp["k3"] = ktot / (3.0 - a1 - a2)
        dp["k1"] = np.where(p2 >= 0, ktot / a1 - dp["k3"], 0.0)
        dp["k2"] = np.where(p3 >= 0, ktot / a2 - dp["k3"], 0.0)
        dp["p2"], dp["p3"], dp["p4"] = (np.maximum(p, 0)
                                        for p in (p2, p3, p4))
        has_aniso1 = bool(np.any(dp["k1"] != 0.0))
        has_aniso2 = bool(np.any(dp["k2"] != 0.0))
        if df._nbthole:
            nt_class_a, nt_w_a, nt_tab = _analyze_nbthole(context, mol_of,
                                                          n)
        dr_by = _group_rows(np.stack([dp["drude"], dp["parent"]], 1),
                            mol_of, R)
        if df._screened_pairs:
            sp1 = np.array([s[0] for s in df._screened_pairs], np.int64)
            sp2 = np.array([s[1] for s in df._screened_pairs], np.int64)
            th = np.array([s[2] for s in df._screened_pairs], np.float64)
            dp["sp_d1"], dp["sp_c1"] = dp["drude"][sp1], dp["parent"][sp1]
            dp["sp_d2"], dp["sp_c2"] = dp["drude"][sp2], dp["parent"][sp2]
            dp["sp_scale"] = th / (alpha[sp1] * alpha[sp2]) ** (1.0 / 6.0)
            dp["sp_qq"] = ONE_4PI_EPS0 * q_d[sp1] * q_d[sp2]
            sp_by = _group_rows(np.stack([dp["sp_d1"], dp["sp_c1"],
                                          dp["sp_d2"], dp["sp_c2"]], 1),
                                mol_of, R)

    # the bonded forces' rows (float64, as forces/bonded.py compiles them)
    def rows_of(cls_name, attr, n_idx, n_prm):
        rows = [r for f in system.getForces()
                if type(f).__name__ == cls_name for r in getattr(f, attr)]
        arr = np.array(rows, np.float64).reshape(len(rows), n_idx + n_prm)
        return arr[:, :n_idx].astype(np.int64), arr[:, n_idx:]

    bd, bd_prm = rows_of("HarmonicBondForce", "_bonds", 2, 2)
    an, an_prm = rows_of("HarmonicAngleForce", "_angles", 3, 2)
    to, to_prm = rows_of("PeriodicTorsionForce", "_torsions", 4, 3)
    bd_by = _group_rows(bd, mol_of, R)
    an_by = _group_rows(an, mol_of, R)
    to_by = _group_rows(to, mol_of, R)

    # the exclusions (every exception) and the active exceptions, as
    # forces/nonbonded.py::NonbondedTerm compiles them
    ex = nbf._exceptions
    exc_i = np.array([e[0] for e in ex], np.int64)
    exc_j = np.array([e[1] for e in ex], np.int64)
    exc_qq = np.array([e[2] for e in ex], np.float64)
    exc_sig = np.array([e[3] for e in ex], np.float64)
    exc_eps = np.array([e[4] for e in ex], np.float64)
    corr_qq = (ONE_4PI_EPS0 * charge[exc_i] * charge[exc_j]
               if nb.pme is not None else np.zeros(len(exc_i)))
    corr_by = _group_rows(np.stack([exc_i, exc_j], 1), mol_of, R)
    act = (exc_qq != 0.0) | (exc_eps != 0.0)
    xi, xj = exc_i[act], exc_j[act]
    xqq, xsig, xeps = ONE_4PI_EPS0 * exc_qq[act], exc_sig[act], exc_eps[act]
    x_by = _group_rows(np.stack([xi, xj], 1), mol_of, R)

    # ---- molecule signatures -> types ----------------------------------
    fo = lambda a: int(off_of[a])
    fl = lambda v: tuple(map(float, v))
    sigs = {}
    mol_type = np.zeros(R, np.int64)
    mol_base = np.zeros(R, np.int64)
    type_data = []
    for r in range(R):
        A = members[r]
        base = int(A[0])
        mol_base[r] = base
        atom_sig = tuple(
            (float(mass[a]), float(charge[a]), float(sigma[a]),
             float(eps[a]), int(tg[a]), bool(is_pair[a]),
             bool(is_parent[a]), fo(partner[a]) if is_pair[a] else k,
             int(a - base), tuple(int(x) for x in ew[a]),
             int(nt_class_a[a]), float(nt_w_a[a]),
             float(inv_mass[a])) for k, a in enumerate(A))
        sig = (
            atom_sig,
            tuple(sorted((fo(settle_idx[w, 0]), fo(settle_idx[w, 1]),
                          fo(settle_idx[w, 2]), float(settle_dist[w, 0]),
                          float(settle_dist[w, 1]))
                         for w in settle_by[r])),
            tuple(sorted((fo(vsa_idx[w]), tuple(fo(p) for p in vsa_p[w]),
                          fl(vsa_w[w])) for w in vsa_by[r])),
            tuple(sorted((fo(vso_idx[w]), tuple(fo(p) for p in vso_p[w]),
                          fl(vso_w[w])) for w in vso_by[r])),
            tuple(sorted((fo(vsl_idx[w]), tuple(fo(p) for p in vsl_p[w]),
                          fl(vsl_ow[w]), fl(vsl_xw[w]), fl(vsl_yw[w]),
                          fl(vsl_local[w])) for w in vsl_by[r])),
            tuple(sorted(
                (fo(dp["drude"][w]), fo(dp["parent"][w]),
                 float(dp["k3"][w]),
                 fo(dp["p2"][w]) if has_aniso1 else -1,
                 float(dp["k1"][w]) if has_aniso1 else 0.0,
                 fo(dp["p3"][w]) if has_aniso2 else -1,
                 fo(dp["p4"][w]) if has_aniso2 else -1,
                 float(dp["k2"][w]) if has_aniso2 else 0.0)
                for w in dr_by[r])),
            tuple(sorted((fo(dp["sp_d1"][w]), fo(dp["sp_c1"][w]),
                          fo(dp["sp_d2"][w]), fo(dp["sp_c2"][w]),
                          float(dp["sp_scale"][w]), float(dp["sp_qq"][w]))
                         for w in sp_by[r])),
            tuple(sorted((fo(exc_i[w]), fo(exc_j[w]), float(corr_qq[w]))
                         for w in corr_by[r])),
            tuple(sorted((fo(xi[w]), fo(xj[w]), float(xqq[w]),
                          float(xsig[w]), float(xeps[w]))
                         for w in x_by[r])),
            tuple(sorted((fo(bd[w, 0]), fo(bd[w, 1]), float(bd_prm[w, 0]),
                          float(bd_prm[w, 1])) for w in bd_by[r])),
            tuple(sorted((fo(an[w, 0]), fo(an[w, 1]), fo(an[w, 2]),
                          float(an_prm[w, 0]), float(an_prm[w, 1]))
                         for w in an_by[r])),
            # (i, j, k, l, phase, periodicity, k): the JAX key order
            tuple(sorted((fo(to[w, 0]), fo(to[w, 1]), fo(to[w, 2]),
                          fo(to[w, 3]), float(to_prm[w, 1]),
                          float(to_prm[w, 0]), float(to_prm[w, 2]))
                         for w in to_by[r])),
            tuple(sorted((fo(shk_idx[w, 0]), fo(shk_idx[w, 1]),
                          float(shk_dist[w])) for w in shake_by[r])),
            float(res_mass[r]), float(res_inv_mass[r]))
        t = sigs.get(sig)
        if t is None:
            t = sigs[sig] = len(type_data)
            type_data.append(sig)
        mol_type[r] = t

    T = len(type_data)
    names = ("s_max", "va_max", "vo_max", "vl_max", "d_max", "sp_max",
             "e_max", "x_max", "b_max", "a_max", "t_max", "sh_max")
    mx = {k: max((len(s[i + 1]) for s in type_data), default=0)
          for i, k in enumerate(names)}

    # ---- pack the templates ----------------------------------------------
    z = np.zeros
    neg = lambda *shape: np.full(shape, -1, np.int32)
    S, Va, Vo, Vl = mx["s_max"], mx["va_max"], mx["vo_max"], mx["vl_max"]
    Dm, Sp, E, X = mx["d_max"], mx["sp_max"], mx["e_max"], mx["x_max"]
    B, A_, To, Sh = mx["b_max"], mx["a_max"], mx["t_max"], mx["sh_max"]
    tp = dict(
        mass=z((T, K)), inv_mass=z((T, K)), charge=z((T, K)),
        sigma=np.ones((T, K)), eps=z((T, K)), tg=z((T, K), np.int32),
        is_pair=z((T, K), bool), is_parent=z((T, K), bool),
        partner_off=np.tile(np.arange(K, dtype=np.int32), (T, 1)),
        gid_off=z((T, K), np.int32), ew=z((T, K, n_words), np.int32),
        valid=z((T, K), bool), res_mass=z((T,)), res_inv_mass=z((T,)),
        settle_off=neg(T, S, 3), settle_dist=np.full((T, S, 2), 0.1),
        vsa_site=neg(T, Va), vsa_p=z((T, Va, 3), np.int32),
        vsa_w=z((T, Va, 3)),
        vso_site=neg(T, Vo), vso_p=z((T, Vo, 3), np.int32),
        vso_w=z((T, Vo, 3)),
        vsl_site=neg(T, Vl), vsl_p=z((T, Vl, lc_k), np.int32),
        vsl_ow=z((T, Vl, lc_k)), vsl_xw=z((T, Vl, lc_k)),
        vsl_yw=z((T, Vl, lc_k)), vsl_local=z((T, Vl, 3)),
        dr_d=neg(T, Dm), dr_c=neg(T, Dm), dr_p2=neg(T, Dm),
        dr_p3=neg(T, Dm), dr_p4=neg(T, Dm), dr_k3=z((T, Dm)),
        dr_k1=z((T, Dm)), dr_k2=z((T, Dm)),
        sp_d1=neg(T, Sp), sp_c1=neg(T, Sp), sp_d2=neg(T, Sp),
        sp_c2=neg(T, Sp), sp_scale=z((T, Sp)), sp_qq=z((T, Sp)),
        exc_i=neg(T, E), exc_j=neg(T, E), exc_qq=z((T, E)),
        x_i=neg(T, X), x_j=neg(T, X), x_qq=z((T, X)),
        x_sig=np.ones((T, X)), x_eps=z((T, X)),
        bd_i=neg(T, B), bd_j=neg(T, B), bd_r0=np.full((T, B), 0.1),
        bd_k=z((T, B)),
        an_i=neg(T, A_), an_j=neg(T, A_), an_k_=neg(T, A_),
        an_t0=z((T, A_)), an_k=z((T, A_)),
        to_i=neg(T, To), to_j=neg(T, To), to_k_=neg(T, To),
        to_l=neg(T, To), to_phase=z((T, To)), to_n=np.ones((T, To)),
        to_k=z((T, To)),
        sh_i=neg(T, Sh), sh_j=neg(T, Sh), sh_d=np.full((T, Sh), 0.1),
        nt_class=z((T, K), np.int32), nt_w=z((T, K)),
    )
    for t, sig in enumerate(type_data):
        (atom_sig, st_sig, va_sig, vo_sig, vl_sig, dr_sig, sp_sig,
         corr_sig, x_sig, bd_sig, an_sig, to_sig, sh_sig, rmass,
         rinv) = sig
        tp["res_mass"][t], tp["res_inv_mass"][t] = rmass, rinv
        for k, a in enumerate(atom_sig):
            (m, q, sg, ep, g, ip, ipar, po, go, eww, ntc, ntw, im) = a
            for key, v in (("mass", m), ("charge", q), ("sigma", sg),
                           ("eps", ep), ("tg", g), ("is_pair", ip),
                           ("is_parent", ipar), ("partner_off", po),
                           ("gid_off", go), ("ew", eww), ("valid", True),
                           ("nt_class", ntc), ("nt_w", ntw),
                           ("inv_mass", im)):
                tp[key][t, k] = v
        for s, row in enumerate(st_sig):
            tp["settle_off"][t, s] = row[:3]
            tp["settle_dist"][t, s] = row[3:]
        for pre, rows in (("vsa", va_sig), ("vso", vo_sig)):
            for s, row in enumerate(rows):
                tp[f"{pre}_site"][t, s] = row[0]
                tp[f"{pre}_p"][t, s] = row[1]
                tp[f"{pre}_w"][t, s] = row[2]
        for s, row in enumerate(vl_sig):
            for key, v in zip(("vsl_site", "vsl_p", "vsl_ow", "vsl_xw",
                               "vsl_yw", "vsl_local"), row):
                tp[key][t, s] = v
        tables = (
            (dr_sig, ("dr_d", "dr_c", "dr_k3", "dr_p2", "dr_k1", "dr_p3",
                      "dr_p4", "dr_k2")),
            (sp_sig, ("sp_d1", "sp_c1", "sp_d2", "sp_c2", "sp_scale",
                      "sp_qq")),
            (corr_sig, ("exc_i", "exc_j", "exc_qq")),
            (x_sig, ("x_i", "x_j", "x_qq", "x_sig", "x_eps")),
            (bd_sig, ("bd_i", "bd_j", "bd_r0", "bd_k")),
            (an_sig, ("an_i", "an_j", "an_k_", "an_t0", "an_k")),
            (to_sig, ("to_i", "to_j", "to_k_", "to_l", "to_phase", "to_n",
                      "to_k")),
            (sh_sig, ("sh_i", "sh_j", "sh_d")))
        for rows, keys in tables:
            for s, row in enumerate(rows):
                for key, v in zip(keys, row):
                    tp[key][t, s] = v

    mx.update(lc_k=lc_k, n_words=n_words, K=K, has_aniso1=has_aniso1,
              has_aniso2=has_aniso2, nt_tab=nt_tab, kinds=tuple(kinds))
    return tp, mol_type, mol_base, mx


# ---------------------------------------------------------------------------
# local construction (on the rank's device)
# ---------------------------------------------------------------------------

def _dummy_positions(Kd: int) -> np.ndarray:
    """Kd fixed, pairwise-distinct dummy coordinates: an equilateral
    0.1 nm triangle (well-conditioned padded SETTLE rows) plus a z-line."""
    pts = np.zeros((Kd, 3))
    a = 0.1
    if Kd > 1:
        pts[1] = (a, 0.0, 0.0)
    if Kd > 2:
        pts[2] = (a / 2, a * np.sqrt(3) / 2, 0.0)
    for k in range(3, Kd):
        pts[k] = (0.0, 0.0, a * (k - 2))
    return pts


def local_tables(tpl: Templates, layout: ResidentLayout, mol_type,
                 mol_base, n_mol, rdt) -> dict:
    """A rank's atom and molecule tables gathered from the type
    templates for the molecules of its slots (the JAX _local_tables
    :711-983): per-atom rows (n_loc,), the dummy block last, and the
    term rows of the used molecules alone.  The JAX tables keep a row
    for every slot and template pad, each pointing at dummy atoms, for
    fixed shapes under jit; the port's scatter-adds (SETTLE, SHAKE, the
    force sums: ops/scatter.py) would add up the pad rows' float32
    residuals on the shared dummies and serialise their long runs of
    equal indices, so the rows are compacted at each rebuild."""
    Rc, K, Kd = layout.Rc, layout.K, layout.Kd
    dev = mol_type.device
    i64 = torch.int64
    r = torch.arange(Rc, device=dev)
    used = r < n_mol
    ty = torch.where(used, mol_type, torch.zeros_like(mol_type))
    valid_atom = used.repeat_interleave(K) & tpl.valid[ty].reshape(-1)
    D = Rc * K
    sb = (r * K)[:, None]                               # slot bases
    at = lambda t: t[ty].reshape(-1)

    def pad_atoms(v_main, v_dummy):
        return torch.cat([v_main, torch.full((Kd,), v_dummy,
                                             dtype=v_main.dtype,
                                             device=dev)])

    def atoms(field, empty):
        v = at(getattr(tpl, field))
        return pad_atoms(torch.where(valid_atom, v, torch.full_like(
            v, empty)), empty)

    out = {"valid": pad_atoms(valid_atom, False)}
    for field, empty, dummy in (("mass", 0.0, 0.0), ("inv_mass", 0.0, 1.0),
                                ("charge", 0.0, 0.0), ("sigma", 1.0, 1.0),
                                ("eps", 0.0, 0.0)):
        out[field] = atoms(field, empty)
        out[field][D:] = dummy
    out["tg"] = atoms("tg", 0).to(i64)
    out["is_pair"] = atoms("is_pair", False)
    out["is_parent"] = atoms("is_parent", False)
    out["partner"] = torch.cat([
        torch.where(valid_atom, (sb + tpl.partner_off[ty]).reshape(-1),
                    torch.arange(D, device=dev)),
        torch.arange(D, D + Kd, device=dev)])
    out["resid"] = torch.cat([torch.arange(Rc, device=dev)
                              .repeat_interleave(K),
                              torch.full((Kd,), Rc, device=dev)])
    zero1 = torch.zeros(1, dtype=rdt, device=dev)
    for f in ("res_mass", "res_inv_mass"):
        v = getattr(tpl, f)[ty]
        out[f] = torch.cat([torch.where(used, v, torch.zeros_like(v)),
                            zero1])

    def rows(field):
        """The rows of a template table that the used molecules have:
        their mask (Rc, m), and a gather of any (T, m, ...) table of the
        same rows, its atom offsets made local with `idx`."""
        first = getattr(tpl, field)[ty]
        first = first[..., 0] if first.dim() == 3 else first
        ok = (first >= 0) & used[:, None]

        def take(f, idx=False):
            v = getattr(tpl, f)[ty]
            if idx:
                v = (sb.reshape((Rc,) + (1,) * (v.dim() - 1)) + v)
            return v[ok]
        return ok, take

    if layout.s_max:
        _, take = rows("settle_off")
        out["settle_idx"] = take("settle_off", True)
        out["settle_dist"] = take("settle_dist")
    for pre, key in (("vsa", "avg"), ("vso", "oop")):
        if getattr(layout, f"v{pre[2]}_max"):
            _, take = rows(f"{pre}_site")
            out[f"vs_{key}_idx"] = take(f"{pre}_site", True)
            out[f"vs_{key}_p"] = take(f"{pre}_p", True)
            out[f"vs_{key}_w"] = take(f"{pre}_w")
    if layout.vl_max:
        _, take = rows("vsl_site")
        out["vs_lc_idx"] = take("vsl_site", True)
        out["vs_lc_p"] = take("vsl_p", True)
        for f in ("ow", "xw", "yw", "local"):
            out[f"vs_lc_{f}"] = take(f"vsl_{f}")

    # NBTHOLE class tags and each atom's molecule (its global base)
    if layout.nt_cap:
        out["nt_class"] = atoms("nt_class", 0).to(i64)
        out["nt_w"] = atoms("nt_w", 0.0)
        out["mol_gid"] = torch.cat([
            torch.where(used, mol_base, -1).repeat_interleave(K),
            torch.full((Kd,), -1, device=dev)])

    # drude springs (the anisotropic rows: those with k != 0, indexed
    # into the spring rows) and screened pairs
    if layout.d_max:
        _, take = rows("dr_d")
        dr = {"drude": take("dr_d", True), "parent": take("dr_c", True),
              "k3": take("dr_k3")}
        for key, kf, head, tail in (("aniso1", "dr_k1", "dr_c", "dr_p2"),
                                    ("aniso2", "dr_k2", "dr_p3", "dr_p4")):
            if getattr(layout, f"has_{key}"):
                k = take(kf)
                sel = torch.nonzero(k != 0.0).reshape(-1)
                dr[key] = (sel, take(head, True)[sel], take(tail, True)[sel],
                           k[sel])
        if layout.sp_max:
            _, take = rows("sp_d1")
            dr["screened"] = tuple(take(f, True) for f in (
                "sp_d1", "sp_c1", "sp_d2", "sp_c2")) + (
                take("sp_scale"), take("sp_qq"))
        out["drude"] = dr

    # exclusion corrections and exceptions
    if layout.e_max:
        _, take = rows("exc_i")
        out["corr"] = {"ii": take("exc_i", True), "jj": take("exc_j", True),
                       "qq": take("exc_qq")}
    if layout.x_max:
        _, take = rows("x_i")
        out["exc"] = {"ii": take("x_i", True), "jj": take("x_j", True),
                      "qq": take("x_qq"), "sig": take("x_sig"),
                      "eps": take("x_eps")}
    words = tpl.ew[ty].reshape(Rc * K, -1)
    out["ew"] = torch.cat([
        torch.where(valid_atom[:, None], words, torch.zeros_like(words)),
        torch.zeros((Kd, layout.n_words), dtype=words.dtype, device=dev)])

    # bonded terms: (atom index rows, parameters) as forces/bonded.py
    for key, cap, fields, n_idx in (
            ("bond", "b_max", ("bd_i", "bd_j", "bd_r0", "bd_k"), 2),
            ("angle", "a_max", ("an_i", "an_j", "an_k_", "an_t0", "an_k"),
             3),
            ("torsion", "t_max", ("to_i", "to_j", "to_k_", "to_l", "to_n",
                                  "to_phase", "to_k"), 4)):
        if getattr(layout, cap):
            _, take = rows(fields[0])
            out[key] = ([take(f, True) for f in fields[:n_idx]],
                        tuple(take(f) for f in fields[n_idx:]))
    if layout.sh_max:
        _, take = rows("sh_i")
        out["shake_idx"] = torch.stack([take("sh_i", True),
                                        take("sh_j", True)], dim=1)
        out["shake_dist"] = take("sh_d")

    gid = torch.where(valid_atom, (mol_base[:, None]
                                   + tpl.gid_off[ty]).reshape(-1),
                      -1 - torch.arange(D, device=dev))
    out["gid"] = torch.cat([gid, -1 - torch.arange(D, D + Kd, device=dev)])
    return out


# the SystemSpec fields every rank takes from the global spec: the NH,
# integration, hard-wall and barostat constants
SPEC_CONSTANTS = ("nh_nkbt", "nh_eta_mass", "nh_kbt_chain",
                  "nh_link_active", "dt", "max_drude_distance",
                  "hardwall_scale", "baro_pressure", "baro_kt")


def local_spec(consts: dict, t: dict, rdt) -> SystemSpec:
    """The rank's SystemSpec: the local tables and the global constants
    `consts` (SPEC_CONSTANTS; the JAX _local_spec :985-1019), so that
    integrators/tgnh.py runs unchanged on the local state."""
    dev = t["mass"].device
    e = lambda *shape, dt=torch.int64: torch.zeros(shape, dtype=dt,
                                                   device=dev)
    lk = t["vs_lc_p"].shape[1] if "vs_lc_p" in t else 1
    return SystemSpec(
        mass=t["mass"], inv_mass=t["inv_mass"], tg=t["tg"],
        resid=t["resid"], res_mass=t["res_mass"],
        res_inv_mass=t["res_inv_mass"], is_pair=t["is_pair"],
        is_parent=t["is_parent"], partner=t["partner"], **consts,
        settle_idx=t.get("settle_idx", e(0, 3)),
        settle_dist=t.get("settle_dist", e(0, 2, dt=rdt)),
        vs_avg_idx=t.get("vs_avg_idx", e(0)),
        vs_avg_p=t.get("vs_avg_p", e(0, 3)),
        vs_avg_w=t.get("vs_avg_w", e(0, 3, dt=rdt)),
        shake_idx=t.get("shake_idx", e(0, 2)),
        shake_dist=t.get("shake_dist", e(0, dt=rdt)),
        vs_oop_idx=t.get("vs_oop_idx", e(0)),
        vs_oop_p=t.get("vs_oop_p", e(0, 3)),
        vs_oop_w=t.get("vs_oop_w", e(0, 3, dt=rdt)),
        vs_lc_idx=t.get("vs_lc_idx", e(0)),
        vs_lc_p=t.get("vs_lc_p", e(0, lk)),
        vs_lc_ow=t.get("vs_lc_ow", e(0, lk, dt=rdt)),
        vs_lc_xw=t.get("vs_lc_xw", e(0, lk, dt=rdt)),
        vs_lc_yw=t.get("vs_lc_yw", e(0, lk, dt=rdt)),
        vs_lc_local=t.get("vs_lc_local", e(0, 3, dt=rdt)))


def local_static(static_g, layout: ResidentLayout):
    """The rank's StaticSpec: the local atom, residue and row counts (the
    JAX local_static :1021-1039).  The JAX module also turns off its
    uniform-block fast paths there (uniform_k, settle_uniform, the lane
    shifts); the port's StaticSpec has none."""
    return dataclasses.replace(
        static_g, n_atoms=layout.n_loc, n_residues=layout.Rc + 1,
        n_settle=layout.Rc * layout.s_max,
        n_shake=layout.Rc * layout.sh_max,
        n_vsites_avg=layout.Rc * layout.va_max,
        n_vsites_oop=layout.Rc * layout.vo_max,
        n_vsites_lc=layout.Rc * layout.vl_max)


def local_terms(t: dict, kinds, alpha) -> dict:
    """The port's term objects on the local rows: the Drude springs,
    anisotropy and screened pairs (forces/drude.py::DrudeTerm), the
    bonded terms (forces/bonded.py), the exceptions and, with PME
    (alpha), the Ewald exclusion corrections (forces/pairterms.py)."""
    out = {}
    dev = t["mass"].device
    if "exc" in t:
        x = t["exc"]
        out["exc"] = pairterms.make_pair_list_term(
            x["ii"], x["jj"], pairterms.exception_eg(x["qq"], x["sig"],
                                                     x["eps"]), dev)
    if "corr" in t and alpha is not None:
        c = t["corr"]
        out["corr"] = pairterms.make_pair_list_term(
            c["ii"], c["jj"], pairterms.ewald_correction_eg(c["qq"], alpha),
            dev)
    for kind in kinds:
        if kind == "drude":
            if "drude" not in t:
                continue
            dr = t["drude"]
            term = DrudeTerm(dr["drude"], dr["parent"], dr["k3"])
            term.aniso = [dr[k] for k in ("aniso1", "aniso2") if k in dr]
            term.screened = dr.get("screened")
            out["drude"] = term
        elif kind in t:
            idx, prm = t[kind]
            cls = {"bond": bonded._BondTerm, "angle": bonded._AngleTerm,
                   "torsion": bonded._PeriodicTorsionTerm}[kind]
            out[kind] = cls(idx, prm)
    return out


# ---------------------------------------------------------------------------
# the local cell sort and the resident block
# ---------------------------------------------------------------------------

def local_cellsort(positions, valid, box_diag, cfg, layout, d):
    """Sort the rank's atoms into its slab's cell planes [lo, lo + loc_x)
    (the JAX _local_cellsort :1046-1091), x-cells CLAMPED into the slab
    at the nearest edge in periodic plane distance; invalid slots park
    at the sentinel.  Returns (CellSort: slot_atom (S,), inv_slot (n_loc,)
    pointing at row S, a zero row, for invalid atoms, and image (n_loc,
    3): the image that puts each atom beside its clamped cell; the
    clamped cells (n_loc, 3) in slab coordinates; the capacity overflow;
    the stray latch: an atom more than one plane from its clamped
    cell)."""
    gx, gy, gz = cfg.grid
    loc_x, C = layout.loc_x, cfg.capacity
    n_cells = loc_x * gy * gz
    n = positions.shape[0]
    dev = positions.device
    lo = d * loc_x
    p = positions.double()
    box = box_diag.double()
    grid = torch.tensor(cfg.grid, dtype=torch.int64, device=dev)
    image = torch.floor(p / box)
    frac = p / box - image
    cell3 = torch.minimum(torch.clamp(
        (frac * grid.double()).to(torch.int64), min=0), grid - 1)
    rel = torch.remainder(cell3[:, 0] - lo, gx)
    near_hi = rel - (loc_x - 1) <= gx - rel
    cx = torch.where(rel < loc_x, rel,
                     torch.where(near_hi, torch.full_like(rel, loc_x - 1),
                                 torch.zeros_like(rel)))
    # the periodic plane distance from the clamped cell, and the image
    # that puts the atom there
    delta = cell3[:, 0] - (lo + cx)
    wrap = torch.where(delta > gx // 2, 1, torch.where(delta < -(gx // 2),
                                                       -1, 0))
    stray = torch.any(valid & (torch.abs(delta - wrap * gx) > 1))
    image = image.to(torch.int64)
    image[:, 0] += wrap
    local3 = torch.stack([cx, cell3[:, 1], cell3[:, 2]], dim=1)
    flat = (cx * gy + cell3[:, 1]) * gz + cell3[:, 2]
    flat = torch.where(valid, flat, torch.full_like(flat, n_cells))
    order = torch.argsort(flat, stable=True)
    sorted_flat = flat[order]
    starts = torch.searchsorted(sorted_flat, torch.arange(
        n_cells, dtype=torch.int64, device=dev))
    in_range = sorted_flat < n_cells
    rank = torch.arange(n, device=dev) - starts[
        torch.clamp(sorted_flat, max=n_cells - 1)]
    overflow = torch.any(in_range & (rank >= C))
    slot = torch.where(in_range, sorted_flat * C + torch.clamp(rank,
                                                                max=C - 1),
                       torch.full_like(sorted_flat, n_cells * C))
    slot_atom = torch.full((n_cells * C + 1,), n, dtype=torch.int64,
                           device=dev)
    slot_atom[slot] = order
    inv_slot = torch.empty((n,), dtype=torch.int64, device=dev)
    inv_slot[order] = slot
    cs = cellpair.CellSort(
        slot_atom=slot_atom[:-1], inv_slot=inv_slot, overflow=overflow,
        ref_positions=positions, image=image,
        stencil_invalid=torch.zeros((), dtype=torch.bool, device=dev),
        drift_exceeded=torch.zeros((), dtype=torch.bool, device=dev))
    return cs, local3, overflow, stray


def resident_offsets(cfg) -> np.ndarray:
    """The block's stencil: the UNTRIMMED half stencil of window (w + 2,
    w_y, w_z), self first (cellpair._neighbor_offsets over a grid at
    least 2 (w + 2) + 1 planes in x)."""
    w2 = cfg.window[0] + 2
    grid = (max(cfg.grid[0], 2 * w2 + 1), cfg.grid[1], cfg.grid[2])
    offs = cellpair._neighbor_offsets(grid, (w2,) + tuple(cfg.window[1:]))
    half = [o for o in offs.tolist() if (o[0], o[1], o[2]) > (0, 0, 0)]
    return np.array([[0, 0, 0]] + half, np.int64)


def resident_sweep(mesh, axis: str, nb) -> domain.HaloSweep:
    """The direct-space sum over each rank's resident block: the halo
    sweep of parallel/domain.py with the block's stencil
    (resident_offsets) and a halo of w + 2 planes, on B1 (its launches
    counted under the resident keys) or, where the compiled nonbonded
    term `nb` runs no kernel (float64), the plain sweep with the exact
    erfc."""
    cfg = nb.cfg
    return domain.make_sharded_pair_sweep(
        mesh, axis, cfg, (cfg.window[0] + 2,) + tuple(cfg.window[1:]),
        nb.alpha, ONE_4PI_EPS0, excl_skip=nb.excl_skip,
        offsets=resident_offsets(cfg), resident=True,
        use_kernel=nb.use_kernel, **nb.coulomb)


# ---------------------------------------------------------------------------
# the resident Context
# ---------------------------------------------------------------------------

class _Local:
    """What one rebuild makes of a rank's molecules: tables, the fields'
    parameters, spec, terms (by name, and the force pass's list), the
    clamped cell sort and the NBTHOLE site rows."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class ResidentContext:
    """Run a port Context's simulation with molecule-resident x-slabs
    over `mesh[axis]` (module docstring).  Built on every rank, in the
    same order, from a Context built alike on each (the same System,
    state and seed); the rank's tables and state live on mesh.device
    (a CPU mesh runs on the CPU).  It keeps nothing of the Context's
    per-atom data, so the caller may free the Context once it is built.
    Rc, Ec: molecule slots a rank and emigrants a direction (the JAX
    defaults: Rc = ceil(1.3 x the largest initial count) + 2, Ec =
    max(floor(0.15 Rc), 4))."""

    def __init__(self, context, mesh, axis: str = "atom", Rc: int = None,
                 Ec: int = None):
        context._ensure_forces()
        self._mesh = mesh
        self._axis = axis
        n_dev = mesh.size(axis)
        self._d = d = mesh.index(axis)
        dev = torch.device(mesh.device)
        self._device = dev

        tp, mol_type, mol_base, mx = analyze(context)
        self._kinds = mx.pop("kinds")
        nt_tab = mx.pop("nt_tab")
        # what the passes read of the nonbonded term: its grid plan, the
        # Coulomb kind and the PME set-up and constants
        nb = types.SimpleNamespace(**{
            k: getattr(context._nb, k, None) for k in (
                "cfg", "alpha", "pme", "charge_bound", "pme_self", "disp",
                "excl_skip", "use_kernel", "coulomb")})
        cfg = nb.cfg
        if not cfg.regular:
            # resident_offsets wraps the stencil as the JAX grid does
            # (offsets 0..n-1 on a dimension of n < 2w + 1 cells); the
            # sweep takes each offset as one explicit image
            raise ValueError(
                f"the resident decomposition takes a regular grid (>= 2w+1 "
                f"cells per dimension); got grid {cfg.grid}, window "
                f"{cfg.window}")
        self._nb, self._cfg = nb, cfg
        self._n_atoms = context._static.n_atoms
        self._hardwall_strict = context._hardwall_strict
        gx = cfg.grid[0]
        if gx % n_dev:
            raise ValueError(f"cell grid x dim {gx} not divisible by "
                             f"{n_dev} ranks")
        loc_x = gx // n_dev
        w2 = cfg.window[0] + 2
        if n_dev > 1 and loc_x < w2:
            raise ValueError(
                f"slab x-extent {loc_x} planes < halo {w2}; use fewer "
                f"ranks or a larger box")

        # initial owners (anchor = first atom's x)
        st = context._state
        pos0 = _host(st.positions, np.float64)
        box0 = np.diagonal(_host(st.box, np.float64))
        R = len(mol_type)
        self._n_mol_global = R
        anchor = pos0[mol_base, 0] / box0[0]
        anchor = anchor - np.floor(anchor)
        plane = np.clip((anchor * gx).astype(np.int64), 0, gx - 1)
        owner = plane // loc_x
        counts = np.bincount(owner, minlength=n_dev)
        if Rc is None:
            Rc = max(int(np.ceil(counts.max() * 1.3)) + 2, 4)
        if Ec is None:
            Ec = max(int(Rc * 0.15), 4)
        if counts.max() > Rc:
            raise ValueError(
                f"initial molecule count {counts.max()} on rank "
                f"{int(np.argmax(counts))} exceeds capacity {Rc}")
        K = tp["mass"].shape[1]
        nt_cap = 0
        if nt_tab is not None:
            per_type = (tp["nt_class"] > 0).sum(axis=1)
            site_counts = np.array([per_type[mol_type[owner == r]].sum()
                                    for r in range(n_dev)])
            nt_cap = max(int(np.ceil(site_counts.max() * 1.35)) + 4, 8)
            if n_dev * nt_cap > 16384:
                raise NotImplementedError(
                    f"NBTHOLE dense fold-in would gather {n_dev * nt_cap} "
                    "sites (> 16384); too many NBTHOLE sites for resident "
                    "mode")
        self._layout = layout = ResidentLayout(
            n_dev=n_dev, K=K, Rc=Rc, Ec=Ec, loc_x=loc_x,
            Kd=max(K, 5), nt_cap=nt_cap,
            **{k: mx[k] for k in (
                "s_max", "va_max", "vo_max", "vl_max", "lc_k", "d_max",
                "sp_max", "e_max", "x_max", "b_max", "a_max", "t_max",
                "sh_max", "n_words", "has_aniso1", "has_aniso2")})

        rdt = context._prec.real
        self._rdt = rdt
        self._tp_np = tp
        self._tpl = Templates(**{
            k: torch.as_tensor(v, device=dev,
                               dtype=rdt if v.dtype == np.float64
                               else torch.int64 if v.dtype.kind == "i"
                               else None) for k, v in tp.items()})
        self._nt_tab = (None if nt_tab is None
                        else torch.as_tensor(nt_tab, dtype=rdt, device=dev))
        self._static_loc = local_static(context._static, layout)
        self._consts = {k: getattr(context._spec, k)
                        for k in SPEC_CONSTANTS}
        self._rebuild_interval = context._rebuild_interval

        # the block B1 sweeps: the slab and the next rank's first w + 2
        # planes, the untrimmed half stencil of window (w + 2, w_y, w_z)
        self._halo = resident_sweep(mesh, axis, nb)
        self._bcfg = bcfg = self._halo.bcfg
        if nb.use_kernel and not sweep.b1_takes(bcfg):
            raise ValueError(
                f"kernel B1 does not take the resident block (grid "
                f"{bcfg.grid}, capacity {cfg.capacity}, "
                f"{bcfg.n_offsets} offsets), and B2 has no resident form")
        n_home = self._halo.n_loc
        self._home = (d * n_home, (d + 1) * n_home)
        self._nbthole_term = types.SimpleNamespace(
            energy_forces=self._nbthole)

        # ---- the rank's initial state ------------------------------------
        n_loc = layout.n_loc
        mine = np.nonzero(owner == d)[0]
        A = np.full((Rc, K), -1, np.int64)
        for slot, m in enumerate(mine):
            ids = mol_base[m] + tp["gid_off"][mol_type[m]]
            A[slot, :int(tp["valid"][mol_type[m]].sum())] = \
                ids[tp["valid"][mol_type[m]]]
        sel = torch.as_tensor(A.reshape(-1), device=st.positions.device)
        ok = (sel >= 0)[:, None]
        dummy = torch.as_tensor(_dummy_positions(layout.Kd), dtype=rdt,
                                device=dev)

        def take(t, tail):
            if t is None:
                return None
            rows = torch.where(ok, t[torch.clamp(sel, min=0)],
                               torch.zeros((), dtype=t.dtype,
                                           device=t.device))
            return torch.cat([rows.to(dev), tail])

        zd = torch.zeros((layout.Kd, 3), dtype=rdt, device=dev)
        ty = np.zeros(Rc, np.int64)
        base = np.zeros(Rc, np.int64)
        ty[:len(mine)] = mol_type[mine]
        base[:len(mine)] = mol_base[mine]
        self._mol_type = torch.as_tensor(ty, device=dev)
        self._mol_base = torch.as_tensor(base, device=dev)
        self._n_mol = torch.as_tensor(len(mine), device=dev)
        gen = torch.Generator(device="cpu")
        gen.set_state(st.baro_gen.get_state())
        self._state = st.replace(
            positions=take(st.positions, dummy),
            velocities=take(st.velocities, zd),
            forces=take(st.forces, zd),
            pos_err=take(st.pos_err, zd),
            potential_energy=st.potential_energy.to(dev),
            box=st.box.to(dev), neighbors=None, baro_gen=gen,
            hardwall_runaway=torch.zeros((), dtype=torch.bool, device=dev))
        false = lambda: torch.zeros((), dtype=torch.bool, device=dev)
        self._latch = {k: false() for k in (
            "mig_overflow", "cs_overflow", "nt_overflow", "stencil",
            "stray", "excl_span", "drift")}
        self._loc = None
        self._stepper = tgnh.Stepper(
            self._static_loc, self._forces_only,
            self._mc_move if self._static_loc.baro_freq else None,
            reduce=self._host_reduce)
        self._drift_warned = False
        self._hw_warned = False

    # -- collectives on host values ---------------------------------------
    def _host_reduce(self, x: np.ndarray) -> np.ndarray:
        """x summed over the ranks (every rank the same bits); NCCL takes
        device tensors, gloo the host's as they are."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self._mesh.backend == "nccl":
            t = t.to(self._device)
        return comm.all_reduce_sum(self._mesh, self._axis, t).cpu().numpy()

    def _gather(self, t):
        if self._mesh.backend == "nccl":
            t = t.to(self._device)
        return comm.all_gather(self._mesh, self._axis, t)

    # -- the force pass ----------------------------------------------------
    def _slab_fields(self, pos, exact, box_d) -> dict:
        """The slab's sorted fields (forces/cellpair.py::sorted_fields over
        the slab's cells of the grid, the atoms' global ids as gid):
        cell-local coordinates at the clamped cells' centres."""
        L = self._loc
        return cellpair.sorted_fields(L.params, pos, box_d, L.cs, self._cfg,
                                      exact, cells=self._home,
                                      gid=L.tables["gid"])

    def block_inputs(self, positions, pos_err, box_d):
        """(block fields, config, shifts, the kernel's keyword arguments)
        of the resident block at these (uncomposed) positions: the
        slab's fields and the next rank's first w + 2 planes (a ring
        exchange, so every rank calls it), B1's home-slab range and the
        Coulomb kind."""
        spec, static = self._loc.spec, self._static_loc
        pos = apply_vsites(spec, static, positions)
        exact = exact_positions(spec, static, positions, pos_err)
        return self._halo.block(self._slab_fields(pos, exact, box_d), box_d)

    def _sweep(self, pos, exact, box_d, energy: bool):
        """The direct-space sum over the resident block: this rank's
        share of the energy (float64, 0-d) with `energy`, else the forces
        on its atoms (n_loc, 3)."""
        local = self._slab_fields(pos, exact, box_d)
        if energy:
            return self._halo.energy(local, box_d)
        f = self._halo.forces(local, box_d)
        f = torch.cat([f, torch.zeros((1, 3), dtype=f.dtype,
                                      device=f.device)])
        return f[self._loc.cs.inv_slot]

    def _recip(self, pos, exact, box_d, with_forces):
        nb = self._nb
        return sharded.reduced_reciprocal(
            self._mesh, self._axis, nb.pme, self._loc.tables["charge"], pos,
            exact, box_d, nb.charge_bound, with_forces)

    def _nbthole(self, pos, box_d, with_forces=True, pos_err=None):
        """(this rank's half of the NBTHOLE energy, forces on its atoms
        or None): its compacted sites against every rank's (a term of
        the force pass, after the Drude springs)."""
        L = self._loc
        p_i = pos[L.nt_idx]
        pj = self._gather(p_i).to(pos.device).reshape(-1, 3)
        delta = boxutils.min_image(p_i[:, None, :] - pj[None, :, :],
                                   box_d)
        r = torch.sqrt(torch.clamp(torch.sum(delta * delta, dim=-1),
                                   min=1e-12))
        scale = self._nt_tab[L.nt_c[:, None], L.nt_cj[None, :]]
        on = (scale > 0.0) & (L.nt_m[:, None] != L.nt_mj[None, :])
        u = scale * r
        expu = torch.exp(-u)
        ww = L.nt_w[:, None] * L.nt_wj[None, :]
        zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
        e = 0.5 * ONE_4PI_EPS0 * torch.sum(torch.where(
            on, ww * (-(1.0 + 0.5 * u) * expu) / r, zero))
        if not with_forces:
            return e, None
        dedr = ONE_4PI_EPS0 * ww * expu * (0.5 * scale * (1.0 + u) / r
                                           + (1.0 + 0.5 * u) / (r * r))
        g = torch.where(on, -dedr / r, zero)
        f_i = torch.sum(g[..., None] * delta, dim=1)
        f = torch.zeros_like(pos)
        scatter.index_add_(f, L.nt_idx, torch.where(L.nt_ok[:, None], f_i,
                                                    zero))
        return e, f

    def _pairs(self, pos, exact, box_d, with_forces):
        """The nonbonded sums over the rank's rows: the block sweep, the
        exceptions and exclusion corrections, and with forces the PME
        reciprocal forces on its atoms."""
        L = self._loc
        out = self._sweep(pos, exact, box_d, energy=not with_forces)
        if with_forces and self._nb.pme is not None:
            out = out + self._recip(pos, exact, box_d, True)[1]
        for key in ("exc", "corr"):
            if key in L.terms:
                r = L.terms[key](pos, box_d, exact, with_forces)
                out = out + (r[1] if with_forces else r[0].double())
        return out

    def _forces_only(self, positions, box, neighbors, pos_err):
        """The forces on the rank's atoms (n_loc, 3), complete for its
        owned atoms, zero on the others (no force all-reduce): the
        Context's force pass (app/context.py::force_pass) on the local
        rows."""
        L = self._loc
        box_d = torch.diagonal(box)
        f = force_pass(L.spec, self._static_loc, positions, pos_err, box_d,
                       lambda pos, exact: self._pairs(pos, exact, box_d,
                                                      True),
                       L.term_list)
        return torch.where(L.tables["valid"][:, None], f,
                           torch.zeros_like(f))

    def _potential(self, positions, box, neighbors, pos_err):
        """The total potential energy (float64, 0-d), the same bits on
        every rank: the all-reduce of the ranks' parts (the force pass's
        energy on the local rows), then the PME reciprocal energy of the
        reduced grid and the constant terms, once."""
        L = self._loc
        box_d = torch.diagonal(box)
        nb = self._nb
        recip = []

        def pairs(pos, exact):
            if nb.pme is not None:
                # every rank's (the grid is the reduced one): added once,
                # after the reduction
                recip.append(self._recip(pos, exact, box_d,
                                         False)[0].double())
            return self._pairs(pos, exact, box_d, False)

        e = force_pass(L.spec, self._static_loc, positions, pos_err, box_d,
                       pairs, L.term_list, with_forces=False)
        e = comm.all_reduce_sum(self._mesh, self._axis,
                                e.to(self._device).reshape(1))[0]
        for r in recip:
            e = e + r
        if nb.pme is not None:
            e = e + nb.pme_self
        if nb.disp is not None:
            e = e + nb.disp / boxutils.volume(box_d.double())
        return e

    def _mc_move(self, spec, state):
        return barostat.maybe_attempt_mc_move(
            spec, self._static_loc, state, self._potential,
            self._forces_only, n_mol=self._n_mol_global)

    # -- migration and rebuild --------------------------------------------
    def _migrate(self, state):
        """Molecules whose anchor crossed into a neighbouring slab move
        there on the ring (the JAX _migrate :1473-1550): returns the
        state with the new slots and the overflow latch (Ec or Rc
        exceeded, or an anchor more than one slab away)."""
        layout, mesh, axis = self._layout, self._mesh, self._axis
        Rc, K, Kd, Ec, n = (layout.Rc, layout.K, layout.Kd, layout.Ec,
                            layout.n_dev)
        d, dev = self._d, self._device
        gx = self._cfg.grid[0]
        r = torch.arange(Rc, device=dev)
        used = r < self._n_mol
        views = [state.positions, state.velocities, state.forces] + (
            [] if state.pos_err is None else [state.pos_err])
        fl = torch.cat([v[:Rc * K].reshape(Rc, K * 3) for v in views],
                       dim=1)
        it = torch.stack([self._mol_type, self._mol_base], dim=1)
        box_x = torch.diagonal(state.box)[0].double()
        frac = state.positions[:Rc * K:K, 0].double() / box_x
        frac = frac - torch.floor(frac)
        owner = torch.clamp((frac * gx).to(torch.int64), 0,
                            gx - 1) // layout.loc_x
        if n == 1:
            go_r = go_l = torch.zeros_like(used)
        else:
            go_r = used & (owner == (d + 1) % n)
            go_l = used & (owner == (d - 1) % n)
            if n <= 2:
                # the neighbours coincide: send right only
                go_r, go_l = go_r | go_l, torch.zeros_like(go_l)
        too_far = used & (owner != d) & ~go_r & ~go_l
        stay = used & ~go_r & ~go_l

        def pack(go):
            order = torch.argsort(torch.where(go, r, Rc + r),
                                  stable=True)[:Ec]
            return torch.cat([it[order], go[order, None].to(torch.int64)],
                             dim=1), fl[order]

        overflow = ((go_r.sum() > Ec) | (go_l.sum() > Ec)
                    | torch.any(too_far))
        send_r = pack(go_r)
        send_l = pack(go_l) if n > 2 else (None, None)
        from_l_i, from_r_i = comm.ring_exchange(mesh, axis, send_l[0],
                                                send_r[0])
        from_l_f, from_r_f = comm.ring_exchange(mesh, axis, send_l[1],
                                                send_r[1])
        empty_i = torch.zeros((Ec, 3), dtype=torch.int64, device=dev)
        empty_f = torch.zeros((Ec, fl.shape[1]), dtype=fl.dtype, device=dev)
        if from_r_i is None:
            from_r_i, from_r_f = empty_i, empty_f
        rv_l, rv_r = from_l_i[:, 2] > 0, from_r_i[:, 2] > 0
        big = Rc + 2 * Ec + 1
        ar = torch.arange(Ec, device=dev)
        keys = torch.cat([torch.where(stay, r, big),
                          torch.where(rv_l, Rc + ar, big),
                          torch.where(rv_r, Rc + Ec + ar, big)])
        order = torch.argsort(keys, stable=True)[:Rc]
        m_i = torch.cat([it, from_l_i[:, :2], from_r_i[:, :2]])[order]
        m_f = torch.cat([fl, from_l_f, from_r_f])[order]
        new_n = stay.sum() + rv_l.sum() + rv_r.sum()
        overflow = overflow | (new_n > Rc)
        self._mol_type, self._mol_base = m_i[:, 0], m_i[:, 1]
        self._n_mol = new_n
        dummy = torch.as_tensor(_dummy_positions(Kd), dtype=self._rdt,
                                device=dev)
        zd = torch.zeros((Kd, 3), dtype=self._rdt, device=dev)
        cols = m_f.reshape(Rc, len(views), K * 3)
        new = [torch.cat([cols[:, k].reshape(Rc * K, 3),
                          dummy if k == 0 else zd])
               for k in range(len(views))]
        state = state.replace(positions=new[0], velocities=new[1],
                              forces=new[2],
                              pos_err=new[3] if len(new) > 3 else None)
        return state, overflow

    def _rebuild(self) -> None:
        """Migration, the local tables and terms, the clamped cell sort,
        the NPT stencil latch and the NBTHOLE site count (the JAX _get_reb
        :1790-1834)."""
        layout, cfg, dev = self._layout, self._cfg, self._device
        state = self._state
        lt = self._latch
        if self._loc is not None:
            # drift since the last rebuild (the local order is unchanged
            # until the migration below)
            dd = state.positions - self._loc.cs.ref_positions
            d2 = torch.where(self._loc.tables["valid"],
                             torch.sum(dd * dd, dim=1),
                             torch.zeros((), dtype=dd.dtype, device=dev))
            top2 = torch.topk(d2, 2).values
            skin = cfg.skin
            lt["drift"] |= ((top2[0] > 4.0 * skin * skin)
                            | (torch.sqrt(top2[0]) + torch.sqrt(top2[1])
                               > 3.0 * skin))
        state, ovf = self._migrate(state)
        lt["mig_overflow"] |= ovf
        tables = local_tables(self._tpl, layout, self._mol_type,
                              self._mol_base, self._n_mol, self._rdt)
        spec = local_spec(self._consts, tables, self._rdt)
        terms = local_terms(tables, self._kinds,
                            self._nb.alpha if self._nb.pme is not None
                            else None)
        box_d = torch.diagonal(state.box)
        cs, local3, cs_ovf, stray = local_cellsort(
            state.positions, tables["valid"], box_d, cfg, layout, self._d)
        lt["cs_overflow"] |= cs_ovf
        lt["stray"] |= stray
        # the static stencil covers r_list only while window * cell >=
        # r_list (forces/cellpair.py::build_cellsort's latch)
        wcell = (torch.as_tensor(cfg.window, dtype=torch.float64,
                                 device=dev) * box_d.double()
                 / torch.as_tensor(cfg.grid, dtype=torch.float64,
                                   device=dev))
        lt["stencil"] |= torch.any(wcell < cfg.r_list)
        if self._nb.excl_skip and "corr" in tables:
            # the kernel skips the exclusion test at offsets with any
            # |o| >= 2: an excluded pair must stay within one cell
            c = tables["corr"]
            d3 = local3[c["ii"]] - local3[c["jj"]]
            g = torch.as_tensor(cfg.grid, device=dev)
            d3 = torch.remainder(d3 + g // 2, g) - g // 2
            lt["excl_span"] |= torch.any(torch.amax(torch.abs(d3),
                                                    dim=1) >= 2)
        term_list = []
        for kind in self._kinds:
            if kind in terms:
                term_list.append(terms[kind])
                if kind == "drude" and layout.nt_cap:
                    term_list.append(self._nbthole_term)
        params = {"charge": tables["charge"], "sigma": tables["sigma"],
                  "eps": tables["eps"], "excl_words": tables["ew"]}
        loc = _Local(tables=tables, params=params, spec=spec, terms=terms,
                     term_list=term_list, cs=cs)
        if layout.nt_cap:
            active = (tables["nt_class"] > 0) & tables["valid"]
            n_nt = active.sum()
            lt["nt_overflow"] |= n_nt > layout.nt_cap
            idx = torch.nonzero(active).reshape(-1)[:layout.nt_cap]
            ok = torch.zeros(layout.nt_cap, dtype=torch.bool, device=dev)
            ok[:idx.shape[0]] = True
            idx = torch.cat([idx, torch.zeros(layout.nt_cap - idx.shape[0],
                                              dtype=idx.dtype, device=dev)])
            zero = torch.zeros((), device=dev)
            loc.nt_idx, loc.nt_ok = idx, ok
            loc.nt_w = torch.where(ok, tables["nt_w"][idx],
                                   zero.to(self._rdt))
            loc.nt_c = torch.where(ok, tables["nt_class"][idx],
                                   zero.to(torch.int64))
            loc.nt_m = torch.where(ok, tables["mol_gid"][idx],
                                   zero.to(torch.int64) - 1)
            loc.nt_wj, loc.nt_cj, loc.nt_mj = (
                self._gather(v).to(dev).reshape(-1)
                for v in (loc.nt_w, loc.nt_c, loc.nt_m))
        self._loc = loc
        self._state = state.replace(neighbors=cs)

    # -- public API --------------------------------------------------------
    def step(self, steps: int) -> None:
        """Alternate a rebuild with a block of min(rebuild_interval,
        remaining) fused steps; then check every latch (all ranks raise
        together) and that the replicated state is the same bits on every
        rank."""
        remaining = int(steps)
        while remaining > 0:
            k = min(self._rebuild_interval, remaining)
            self._rebuild()
            self._state = self._stepper.multi_step(self._loc.spec,
                                                   self._state, k)
            remaining -= k
        self._check()

    def _replicated(self) -> np.ndarray:
        """The state every rank holds alike, as float64 numbers."""
        st = self._state
        parts = [st.eta, st.eta_dot, st.eta_dot_dot, st.group_ke,
                 st.box.cpu(),
                 torch.tensor([st.step, st.time, float(st.baro_scale),
                               st.baro_naccept, st.baro_nattempt])]
        return np.concatenate([np.asarray(p, np.float64).reshape(-1)
                               for p in parts])

    def _check(self) -> None:
        lt = self._latch
        names = ("mig_overflow", "cs_overflow", "nt_overflow", "stencil",
                 "stray", "excl_span", "drift")
        flags = torch.stack([lt[k] for k in names]
                            + [self._state.hardwall_runaway]).cpu()
        rep = torch.from_numpy(self._replicated())
        both = self._gather(torch.cat([flags.double(), rep])).cpu()
        flags = dict(zip(names + ("hw",), (both[:, :len(names) + 1]
                                           .amax(dim=0) > 0).tolist()))
        rep_all = both[:, len(names) + 1:]
        if not all(torch.equal(rep_all[0], x) for x in rep_all[1:]):
            raise RuntimeError("the ranks' replicated state (NH chains, "
                               "box, step, barostat) diverged")
        if flags["mig_overflow"]:
            raise RuntimeError(
                "resident migration overflow (emigrant/slot capacity or a "
                ">1-slab anchor jump) — raise Rc/Ec or rebuild the context")
        if flags["cs_overflow"]:
            raise RuntimeError("resident cell-capacity overflow")
        if flags["nt_overflow"]:
            raise RuntimeError(
                "resident NBTHOLE site-capacity overflow — migrations "
                "concentrated NBTHOLE sites past the planned per-rank "
                "capacity; rebuild the context")
        if flags["stencil"]:
            raise RuntimeError(
                "cell stencil no longer covers the cutoff (NPT box shrank "
                "past the compile-time grid plan) — rebuild the context")
        if flags["stray"]:
            raise RuntimeError(
                "an atom sat more than one cell plane from the slab that "
                "owns its molecule (a molecule wider than a cell): the "
                "w + 2 stencil does not cover it")
        if flags["excl_span"]:
            raise RuntimeError(
                "an excluded pair stretched across >= 2 cells while the "
                "sweep skipped the exclusion test at far stencil offsets "
                "(pass nb_options={'excl_skip': False} to the Context)")
        if flags["drift"] and not self._drift_warned:
            self._drift_warned = True
            warnings.warn(
                "an atom moved further than the neighbor skin between "
                "rebuilds — pair interactions may have been missed; "
                "reduce the step size or the rebuild interval",
                RuntimeWarning, stacklevel=3)
        if flags["hw"]:
            if self._hardwall_strict:
                raise RuntimeError(
                    "Drude particle moved too far beyond the hard wall")
            if not self._hw_warned:
                self._hw_warned = True
                warnings.warn(
                    "a Drude particle transiently moved >2x past the hard "
                    "wall (bounced back)", RuntimeWarning, stacklevel=3)

    def positions(self, compensated: bool = False) -> np.ndarray:
        """(N, 3) float64 positions in global atom order, gathered from
        every rank (with compensated, plus the float32 compensation
        pos_err where the state has one)."""
        st = self._state
        p = st.positions.double()
        if compensated and st.pos_err is not None:
            p = p + st.pos_err.double()
        return self._gathered(p)

    def velocities(self) -> np.ndarray:
        return self._gathered(self._state.velocities.double())

    def _gathered(self, vals) -> np.ndarray:
        layout = self._layout
        Rc, K = layout.Rc, layout.K
        head = torch.cat([self._mol_type, self._mol_base,
                          self._n_mol.reshape(1)]).double()
        both = self._gather(torch.cat([head, vals[:Rc * K].reshape(-1)]))
        both = both.cpu().numpy()
        n = self._n_atoms
        out = np.zeros((n, 3))
        goff, gvalid = self._tp_np["gid_off"], self._tp_np["valid"]
        for row in both:
            types = row[:Rc].astype(np.int64)
            bases = row[Rc:2 * Rc].astype(np.int64)
            v = row[2 * Rc + 1:].reshape(Rc, K, 3)
            for slot in range(int(row[2 * Rc])):
                t = types[slot]
                sel = gvalid[t]
                out[bases[slot] + goff[t][sel]] = v[slot][sel]
        return out

    @property
    def state(self) -> dict:
        """This rank's state: the local SimState's arrays under the JAX
        module's names, with the slots' molecules and the latches."""
        st = self._state
        out = {"pos": st.positions, "vel": st.velocities,
               "force": st.forces, "pos_err": st.pos_err,
               "mol_type": self._mol_type, "mol_base": self._mol_base,
               "n_mol": self._n_mol, "eta": st.eta, "eta_dot": st.eta_dot,
               "eta_dot_dot": st.eta_dot_dot, "ke_sum": st.ke_sum,
               "group_ke": st.group_ke, "step": st.step, "time": st.time,
               "box": st.box, "pe": st.potential_energy,
               "baro_scale": st.baro_scale, "baro_na": st.baro_naccept,
               "baro_nt": st.baro_nattempt, "hw": st.hardwall_runaway}
        out.update(self._latch)
        return out
