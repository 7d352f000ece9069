"""Temperature-grouped dual Nose-Hoover (TGNH) integrator.

The per-step pipeline of the reference CUDA platform
(CudaIntegrateDrudeTGNHStepKernel::execute, CudaDrudeTGNHKernels.cpp:
284-408), as the JAX package's integrators/tgnh.py implements it:
NH half step -> velocity scaling -> half kick -> position constraints
(SETTLE triangles, then SHAKE on the other constraints) ->
position update -> hard wall -> virtual sites -> force pass -> half kick
-> velocity constraints (SETTLE, then RATTLE) -> NH half step.

Per-bath kinetic energies are device reductions, and the NH chain (a
few numbers per bath, numDrudeSteps sequential substeps: the reference's
host loop, CudaDrudeTGNHKernels.cpp:558-642) runs on the device too, in
the kernel of ops/nh_chain.py (its plain version on the CPU), so a step
reads nothing back, as the JAX package's jitted step does.  Drude pairs
move in centre-of-mass/relative coordinates (drudeTGNH.cu:249-365), each
pair member computing its own row.

A flattened replica ensemble (static.ensemble_r = R > 1, replica-major
atoms, replica = index // n0) has (R, G+2) baths: every KE and CM
reduction is per replica (the JAX integrators/tgnh.py:148-160, :305-320,
:557, :841), and the chain runs on all R x (G+2) baths in one launch.
With per-replica
box scales (flat-ensemble NPT, SimState.rep_scale) the force pass and the
cell sort take the scales, and the drift latch compares stored
coordinates p / s_r, the frame the cells are binned in (the JAX
integrators/tgnh.py:632, :757-760).
"""

from __future__ import annotations

import torch

from ..constraints import settle, shake
from ..constraints.vsites import apply_vsites
from ..ops import nh_chain, scatter
# the chain's plain version (ops/nh_chain.py), under its JAX name
from ..ops.nh_chain import propagate_nh_chain  # noqa: F401


def _safe_inv(x):
    return torch.where(x > 0, 1.0 / torch.where(x > 0, x,
                                                torch.ones_like(x)),
                       torch.zeros_like(x))


def com_and_norm_velocities(spec, static, v):
    """Per-residue COM velocities (R, 3) and residue-relative velocities
    (N, 3) (drudeTGNH.cu:82-133)."""
    if static.use_com_temp_group:
        mom = torch.zeros((static.n_residues, 3), dtype=v.dtype,
                          device=v.device)
        scatter.index_add_(mom, spec.resid, spec.mass[:, None] * v)
        com_vel = mom * spec.res_inv_mass[:, None]
    else:
        com_vel = torch.zeros((static.n_residues, 3), dtype=v.dtype,
                              device=v.device)
    return com_vel, v - com_vel[spec.resid]


def _rsum(static, x):
    """The sum of a per-atom (or per-residue) vector: a 0-d tensor, or
    (R,) per-replica sums in a flattened ensemble (replica-major)."""
    E = static.ensemble_r
    if E == 1:
        return torch.sum(x)
    return torch.sum(x.reshape(E, -1), dim=1)


def _per_replica_atoms(static, x):
    """(R, ...) per-replica values repeated for each replica's atoms:
    (N, ...)."""
    E = static.ensemble_r
    n0 = static.n_atoms // E
    return x[:, None].expand((E, n0) + x.shape[1:]).reshape(
        (E * n0,) + x.shape[1:])


def group_kinetic_energies(spec, static, v, accum_dtype):
    """Per-bath 2*KE, (G+2,) on the device (drudeTGNH.cu:138-200):
    slots 0..G-1 molecular-internal DOF per group, G the COM bath, G+1 the
    Drude relative bath; (R, G+2) in a flattened ensemble.  Also returns
    the COM and relative velocities."""
    G = static.n_temp_groups
    com_vel, norm_vel = com_and_norm_velocities(spec, static, v)
    cv = com_vel.to(accum_dtype)
    nv = norm_vel.to(accum_dtype)
    mass = spec.mass.to(accum_dtype)
    ke_com = _rsum(static, spec.res_mass.to(accum_dtype)
                   * torch.sum(cv * cv, dim=1))
    ke_atom = mass * torch.sum(nv * nv, dim=1)
    if static.has_pairs:
        m_j = mass[spec.partner]
        mtot = mass + m_j
        inv_mtot = _safe_inv(mtot)
        nv_j = nv[spec.partner]
        cm = (mass[:, None] * nv + m_j[:, None] * nv_j) * inv_mtot[:, None]
        rel = nv - nv_j
        mu = mass * m_j * inv_mtot
        ke_cm = 0.5 * mtot * torch.sum(cm * cm, dim=1)
        ke_rel = 0.5 * mu * torch.sum(rel * rel, dim=1)
        directed = torch.where(spec.is_pair, ke_cm, ke_atom)
        ke_drude = _rsum(static, torch.where(spec.is_pair, ke_rel,
                                             torch.zeros_like(ke_rel)))
    else:
        directed = ke_atom
        ke_drude = torch.zeros_like(ke_com)
    if G == 1:
        groups = [_rsum(static, directed)]
    else:
        groups = [_rsum(static, torch.where(spec.tg == g, directed,
                                            torch.zeros_like(directed)))
                  for g in range(G)]
    return (torch.stack(groups + [ke_com, ke_drude], dim=-1), com_vel,
            norm_vel)


def apply_vscale(spec, static, v, com_vel, norm_vel, vscale):
    """Rescale velocities bath by bath (drudeTGNH.cu:249-301): internal
    part by the group scale, COM part by the COM scale; Drude pairs split
    into pair COM (group scale) and relative (Drude scale)."""
    G = static.n_temp_groups
    vs = vscale.to(v.dtype)
    if static.ensemble_r > 1:
        # (R, G+2) per-replica scales, each column repeated over its
        # replica's atoms; the group resolved by masked selects
        def col(c):
            return _per_replica_atoms(static, vs[:, c])[:, None]
        vs_atom = col(0)
        for g in range(1, G):
            vs_atom = torch.where((spec.tg == g)[:, None], col(g), vs_atom)
        vs_com, vs_drude = col(G), col(G + 1)
    else:
        vs_atom = vs[0] if G == 1 else vs[spec.tg][:, None]
        vs_com = vs[G]
        vs_drude = vs[G + 1]
    vel_com_part = v - norm_vel
    new_v = vs_atom * norm_vel + vs_com * vel_com_part
    if static.has_pairs:
        m_i = spec.mass
        m_j = spec.mass[spec.partner]
        inv_mtot = _safe_inv(m_i + m_j)
        nv_j = norm_vel[spec.partner]
        sign = torch.where(spec.is_parent, 1.0, -1.0).to(v.dtype)[:, None]
        wi = (m_i * inv_mtot)[:, None]
        wj = (m_j * inv_mtot)[:, None]
        cm = wi * norm_vel + wj * nv_j
        rel = sign * (norm_vel - nv_j)
        pair_v = (vs_atom * cm + vs_drude * rel * sign * wj
                  + vs_com * vel_com_part)
        new_v = torch.where(spec.is_pair[:, None], pair_v, new_v)
    return torch.where((spec.inv_mass > 0)[:, None], new_v, v)


def half_kick(spec, static, v, f, dt):
    """Half-step kick (drudeTGNH.cu:307-365): v += dt/2 F/m, Drude pairs
    in COM/relative coordinates."""
    fscale = 0.5 * dt
    new_v = v + fscale * spec.inv_mass[:, None] * f
    if static.has_pairs:
        j = spec.partner
        m_i = spec.mass
        m_j = spec.mass[j]
        mtot = m_i + m_j
        inv_mtot = _safe_inv(mtot)
        inv_red = mtot * spec.inv_mass * spec.inv_mass[j]
        v_j = v[j]
        f_j = f[j]
        sign = torch.where(spec.is_parent, 1.0, -1.0).to(v.dtype)[:, None]
        wi = (m_i * inv_mtot)[:, None]
        wj = (m_j * inv_mtot)[:, None]
        cm = wi * v + wj * v_j
        rel = sign * (v - v_j)
        cm = cm + fscale * inv_mtot[:, None] * (f + f_j)
        rel = rel + fscale * inv_red[:, None] * (sign * (wj * f - wi * f_j))
        pair_v = cm + sign * wj * rel
        new_v = torch.where(spec.is_pair[:, None], pair_v, new_v)
    return torch.where((spec.inv_mass > 0)[:, None], new_v, v)


def apply_hardwall(spec, static, positions, velocities, dt, pos_err=None):
    """Elastic bounce of the Drude-parent distance off the hard wall
    (drudeTGNH.cu:471-574).  Returns (positions, velocities, runaway) with
    runaway set when a pre-bounce distance exceeded twice the wall (the
    Reference platform throws there, ReferenceDrudeTGNHKernels.cpp:311)."""
    r = positions.dtype
    max_dist = spec.max_drude_distance
    hw_scale = spec.hardwall_scale
    par = spec.is_parent[:, None]
    j = spec.partner
    pos_j, vel_j = positions[j], velocities[j]
    pos_d = torch.where(par, pos_j, positions)
    pos_p = torch.where(par, positions, pos_j)
    vel_d = torch.where(par, vel_j, velocities)
    vel_p = torch.where(par, velocities, vel_j)
    m_d = torch.where(spec.is_parent, spec.mass[j], spec.mass)
    m_p = torch.where(spec.is_parent, spec.mass, spec.mass[j])
    delta = pos_d - pos_p
    if pos_err is not None:
        err_j = pos_err[j]
        delta = delta + (torch.where(par, err_j, pos_err)
                         - torch.where(par, pos_err, err_j))
    r2 = torch.sum(delta * delta, dim=1)
    one = torch.ones((), dtype=r, device=positions.device)
    rdist = torch.sqrt(torch.where(spec.is_pair, r2, one))
    violated = spec.is_pair & (rdist > max_dist)
    runaway = torch.any(spec.is_pair & (rdist > 2.0 * max_dist))
    bond_dir = delta / rdist[:, None]
    dotvr1 = torch.sum(vel_d * bond_dir, dim=1)
    dotvr2 = torch.sum(vel_p * bond_dir, dim=1)
    delta_r = rdist - max_dist
    parent_massless = m_p <= 0
    dt_t = torch.full_like(rdist, dt)
    m_d_safe = torch.sqrt(torch.where(m_d > 0, m_d, one))

    # massless parent: move only the Drude particle
    abs_v1 = torch.abs(dotvr1)
    dt_a = torch.minimum(torch.where(abs_v1 > 0, delta_r / torch.where(
        abs_v1 > 0, abs_v1, one), dt_t), dt_t)
    new_dotvr1_a = -torch.sign(dotvr1) * hw_scale / m_d_safe
    dr_a = -delta_r + dt_a * new_dotvr1_a

    # both massive
    inv_mtot = _safe_inv(m_d + m_p)
    vb_cm = (m_d * dotvr1 + m_p * dotvr2) * inv_mtot
    dv1 = dotvr1 - vb_cm
    dv2 = dotvr2 - vb_cm
    dvrel = torch.abs(dv1 - dv2)
    dt_b = torch.minimum(torch.where(dvrel > 0, delta_r / torch.where(
        dvrel > 0, dvrel, one), dt_t), dt_t)
    v_bond = hw_scale / m_d_safe
    new_dv1 = -torch.sign(dv1) * v_bond * m_p * inv_mtot
    new_dv2 = -torch.sign(dv2) * v_bond * m_d * inv_mtot
    dr1 = -delta_r * m_p * inv_mtot + dt_b * new_dv1
    dr2 = delta_r * m_d * inv_mtot + dt_b * new_dv2

    is_drude = spec.is_pair & ~spec.is_parent
    zero = torch.zeros_like(rdist)
    own_dotvr = torch.where(is_drude, dotvr1, dotvr2)
    dr_own = torch.where(parent_massless, torch.where(is_drude, dr_a, zero),
                         torch.where(is_drude, dr1, dr2))
    new_dotvr_own = torch.where(
        parent_massless, torch.where(is_drude, new_dotvr1_a, own_dotvr),
        torch.where(is_drude, new_dv1 + vb_cm, new_dv2 + vb_cm))
    vel_perp = velocities - own_dotvr[:, None] * bond_dir
    moved = (violated & ~(parent_massless & spec.is_parent))[:, None]
    new_pos = torch.where(moved, positions + bond_dir * dr_own[:, None],
                          positions)
    new_vel = torch.where(moved, vel_perp + bond_dir
                          * new_dotvr_own[:, None], velocities)
    return new_pos, new_vel, runaway


class Stepper:
    """One TGNH step and the fused multi-step, around a force pass
    forces_fn(positions, box, neighbors, pos_err[, rep_scale]) -> forces
    (N, 3) (rep_scale passed where the state has it) and, with a
    MonteCarloBarostat, its move barostat_fn(spec, state) -> state
    (velocity-independent; the JAX package's apply_barostat).

    The NH chain runs on the device (ops/nh_chain.py: one launch a half
    step, one for the fused step's NH pair), so neither nh_half nor
    fused_body reads anything back.

    reduce (the JAX make_step's reduce_axis, :494-572 there): for a
    state that holds one rank's atoms (parallel/resident.py),
    reduce(host ndarray) -> its sum over the ranks.  The per-bath KE
    vector, and with CM removal the CM momentum and the total mass, pass
    through it (to the host, summed, and back to the device), one call a
    measurement, so every rank's chain advances on the global sums.  This
    multi-rank path keeps that host round trip a step."""

    def __init__(self, static, forces_fn, barostat_fn=None, reduce=None):
        self.static = static
        self.forces_fn = forces_fn
        self.barostat_fn = barostat_fn
        self.reduce = reduce
        # constraints/shake.ShakeStats to count SHAKE/RATTLE sweeps
        self.shake_stats = None

    def _to_host(self, x):
        """A device tensor as a host array, summed over the ranks (the
        Stepper has a reduce)."""
        return self.reduce(x.cpu().numpy())

    def _global(self, x):
        """x summed over the ranks, back on x's device (x itself without
        a reduce)."""
        if self.reduce is None:
            return x
        return torch.as_tensor(self._to_host(x), dtype=x.dtype,
                               device=x.device)

    def _chain(self, spec, state, mode, ke, **kw):
        return nh_chain.run(spec, self.static, mode, ke, state.eta,
                            state.eta_dot, state.eta_dot_dot, spec.dt, **kw)

    def nh_half(self, spec, state, v):
        static = self.static
        accum = state.eta.dtype
        ke, com_vel, norm_vel = group_kinetic_energies(spec, static, v,
                                                       accum)
        ke = self._global(ke)
        vscale, _, _, eta, ed, edd = self._chain(spec, state,
                                                 nh_chain.FIRST, ke)
        new_v = apply_vscale(spec, static, v, com_vel, norm_vel, vscale)
        state = state.replace(eta=eta, eta_dot=ed, eta_dot_dot=edd,
                              ke_sum=0.5 * torch.sum(ke, dim=-1),
                              group_ke=ke)
        return state, new_v

    def update_context_state(self, spec, state):
        """CM motion removal every cm_freq steps, then the barostat
        (DrudeTGNHIntegrator.cpp:186-189)."""
        static = self.static
        cm = static.cm_freq
        if cm > 0 and state.step % cm == 0:
            v = state.velocities
            E = static.ensemble_r
            if E > 1:
                # each replica's own CM (replica-major)
                mv = (spec.mass[:, None] * v).reshape(E, -1, 3)
                mom = torch.sum(mv, dim=1)
                total = torch.sum(spec.mass.reshape(E, -1), dim=1)
                v_cm = _per_replica_atoms(static, mom / total[:, None])
            elif self.reduce is not None:
                # the global CM: momentum and mass summed over the ranks
                acc = state.eta.dtype
                mom = torch.sum((spec.mass[:, None] * v).to(acc), dim=0)
                h = self._to_host(torch.cat([
                    mom, torch.sum(spec.mass).to(acc).reshape(1)]))
                v_cm = torch.as_tensor(h[:3] / h[3], device=v.device).to(
                    v.dtype)
            else:
                mom = torch.sum(spec.mass[:, None] * v, dim=0)
                v_cm = mom / torch.sum(spec.mass)
            state = state.replace(velocities=torch.where(
                (spec.inv_mass > 0)[:, None], v - v_cm, v))
        if self.barostat_fn is not None:
            state = self.barostat_fn(spec, state)
        return state

    def core(self, spec, state, v):
        """First half kick through velocity constraints; returns (state, v)
        with v the post-constraint velocities (second NH half pending)."""
        static = self.static
        dt = spec.dt
        v = half_kick(spec, static, v, state.forces, dt)
        movable = (spec.inv_mass > 0)[:, None]
        delta = torch.where(movable, dt * v, torch.zeros_like(v))
        if static.n_settle:
            delta = settle.apply_position_constraints(
                state.positions, delta, spec.inv_mass, spec.settle_idx,
                spec.settle_dist)
        if static.n_shake:
            delta = shake.apply_position_constraints(
                state.positions, delta, spec.inv_mass, spec.shake_idx,
                spec.shake_dist, static.constraint_tol,
                static.shake_max_iter, stats=self.shake_stats,
                pos_err=state.pos_err)
        if state.pos_err is not None:
            total = state.pos_err + delta
            pos = state.positions + total
            state = state.replace(pos_err=(state.positions - pos) + total)
        else:
            pos = state.positions + delta
        v = torch.where(movable, delta / dt, v)
        if static.has_hardwall and static.has_pairs:
            pos, v, runaway = apply_hardwall(spec, static, pos, v, dt,
                                             pos_err=state.pos_err)
            state = state.replace(
                hardwall_runaway=state.hardwall_runaway | runaway)
        pos = apply_vsites(spec, static, pos)
        scales = () if state.rep_scale is None else (state.rep_scale,)
        forces = self.forces_fn(pos, state.box, state.neighbors,
                                state.pos_err, *scales)
        v = half_kick(spec, static, v, forces, dt)
        if static.n_settle:
            v = settle.apply_velocity_constraints(
                pos, v, spec.inv_mass, spec.settle_idx, spec.settle_dist)
        if static.n_shake:
            v = shake.apply_velocity_constraints(
                pos, v, spec.inv_mass, spec.shake_idx, spec.shake_dist,
                static.constraint_tol, static.shake_max_iter,
                stats=self.shake_stats, pos_err=state.pos_err)
        state = state.replace(positions=pos, forces=forces,
                              step=state.step + 1,
                              time=state.time + spec.dt)
        return state, v

    def step(self, spec, state):
        state = self.update_context_state(spec, state)
        state, v = self.nh_half(spec, state, state.velocities)
        state, v = self.core(spec, state, v)
        state, v = self.nh_half(spec, state, v)
        return state.replace(velocities=v)

    def fused_body(self, spec, state):
        """NH2 of the previous step and NH1 of this one on ONE KE
        measurement, one composed velocity scaling, then the core.  Exact
        in real arithmetic (bath scalings commute with the decomposition;
        CM removal lowers only the COM bath by M_tot |v_cm|^2).  The NH
        pair, the CM correction between its halves and the composed
        scales are one launch of the chain kernel; with a barostat, two
        launches around its move."""
        static = self.static
        accum = state.eta.dtype
        v = state.velocities
        ke, com_vel, norm_vel = group_kinetic_energies(spec, static, v,
                                                       accum)
        E = static.ensemble_r
        cm_on = static.cm_freq > 0
        kw = {}
        mode = nh_chain.FIRST
        if cm_on:
            # the CM momenta (per replica in a flattened ensemble: (R, 3)
            # momenta, (R,) masses)
            mv = (spec.mass[:, None] * v).to(accum)
            if E > 1:
                mom = torch.sum(mv.reshape(E, -1, 3), dim=1)
                total_mass = torch.sum(spec.mass.reshape(E, -1),
                                       dim=1).to(accum)
            else:
                mom = torch.sum(mv, dim=0)
                total_mass = torch.sum(spec.mass).to(accum)
            if self.reduce is not None:
                # one host round trip of the KE and the CM momenta
                nk = ke.numel()
                g = self._global(torch.cat([ke.reshape(-1), mom.reshape(-1),
                                            total_mass.reshape(-1)]))
                ke = g[:nk].reshape(ke.shape)
                mom = g[nk:nk + 3 * E].reshape(mom.shape)
                total_mass = g[nk + 3 * E:].reshape(total_mass.shape)
            kw = dict(mom=mom, total_mass=total_mass,
                      m01=float(state.step % static.cm_freq == 0))
            mode |= nh_chain.CM
        else:
            ke = self._global(ke)
        if self.barostat_fn is None:
            scale, ke_a, shift, eta, ed, edd = self._chain(
                spec, state, mode | nh_chain.SECOND, ke, **kw)
        else:
            vs_a, ke_a, _, eta, ed, edd = self._chain(spec, state, mode,
                                                      ke, **kw)
            # between the two NH halves, where the JAX fused body moves
            # the volume (it reads no velocity)
            state = self.barostat_fn(spec, state)
            state = state.replace(eta=eta, eta_dot=ed, eta_dot_dot=edd)
            scale, _, shift, eta, ed, edd = self._chain(
                spec, state, (mode & nh_chain.CM) | nh_chain.SECOND, ke_a,
                vs=vs_a, **kw)
        state = state.replace(eta=eta, eta_dot=ed, eta_dot_dot=edd,
                              ke_sum=0.5 * torch.sum(ke_a, dim=-1),
                              group_ke=ke_a)
        new_v = apply_vscale(spec, static, v, com_vel, norm_vel, scale)
        if cm_on:
            sub = shift.to(new_v.dtype)
            if E > 1:
                sub = _per_replica_atoms(static, sub)
            new_v = torch.where((spec.inv_mass > 0)[:, None], new_v - sub,
                                new_v)
        state, v = self.core(spec, state, new_v)
        return state.replace(velocities=v)

    def multi_step(self, spec, state, n: int, fuse_nh: bool = True):
        """n steps; with fuse_nh (and n >= 2) adjacent NH halves share one
        KE measurement (the JAX package's _make_multi_step_fused :809)."""
        if not fuse_nh or n < 2:
            for _ in range(n):
                state = self.step(spec, state)
            return state
        state = self.update_context_state(spec, state)
        state, v = self.nh_half(spec, state, state.velocities)
        state, v = self.core(spec, state, v)
        state = state.replace(velocities=v)
        for _ in range(n - 1):
            state = self.fused_body(spec, state)
        state, v = self.nh_half(spec, state, state.velocities)
        return state.replace(velocities=v)


def rebuild_neighbors(state, neighbor_fn, skin):
    """Fresh cell sort; the overflow, stencil, drift and excl-span latches
    carry forward.  Drift latches when one atom moved > 2x skin or the two
    largest displacements sum to > 3x skin since the last rebuild (in
    stored coordinates p / s_r with per-replica scales: the sort's
    ref_positions)."""
    old = state.neighbors
    rs = state.rep_scale
    if rs is None:
        nbl = neighbor_fn(state.positions, state.box)
        cur = state.positions
    else:
        nbl = neighbor_fn(state.positions, state.box, rs)
        cur = nbl.ref_positions
    nbl.overflow = nbl.overflow | old.overflow
    nbl.stencil_invalid = nbl.stencil_invalid | old.stencil_invalid
    d = cur - old.ref_positions
    d2 = torch.sum(d * d, dim=1)
    top2 = torch.topk(d2, 2).values
    exceeded = ((top2[0] > (2.0 * skin) * (2.0 * skin))
                | (torch.sqrt(top2[0]) + torch.sqrt(top2[1]) > 3.0 * skin))
    nbl.drift_exceeded = exceeded | old.drift_exceeded
    if old.excl_span_exceeded is not None \
            and nbl.excl_span_exceeded is not None:
        nbl.excl_span_exceeded = nbl.excl_span_exceeded \
            | old.excl_span_exceeded
    return state.replace(neighbors=nbl)
