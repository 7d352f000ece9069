"""The TGNH step of the openmm_drudeNose plugin (Son et al., JPCL 10,
7523 (2019); the reference plugin's DrudeTGNH integrator), for R
replicas of rigid SWM4-NDP water, one step at a time in plain PyTorch.

Baths (one temperature group): the molecules' internal motion with each
core-Drude pair at its centre of mass (T), the molecules' centres of
mass (T), and the pairs' relative motion (T_Drude).  A step:

  CM removal        every cm_freq steps: each replica's CM velocity off
                    every massive site;
  NH half step      the per-bath 2 KE, then drude_substeps symmetric
                    Trotter substeps of each bath's chain (exp(-dtc/8)
                    damping, dtc/4 kicks), the product of the substeps'
                    exp(-dtc/2 eta_dot_0) the bath's velocity scale;
  half kick         v += dt/2 F / m;
  positions         d = dt v; SHAKE on O-H1, O-H2, H1-H2 along the old
                    bonds, solved by Newton to round-off; x += d,
                    v = d / dt;
  hard wall         each pair farther apart than the wall bounces
                    elastically back inside along its bond, at the
                    thermal speed sqrt(kT_Drude / m_Drude);
  M sites, forces, half kick, RATTLE (the exact 3 x 3 solve on the new
  bonds), NH half step.

Each replica's baths, chain and CM are its own.
"""

from __future__ import annotations

import dataclasses
import math

import torch

BOLTZ = 8.31446261815324e-3   # kJ/(mol K), OpenMM's value
NEWTON_ITERS = 15


@dataclasses.dataclass
class State:
    x: torch.Tensor          # (R, n0, 3)
    v: torch.Tensor
    f: torch.Tensor
    eta: torch.Tensor        # (R, 3, M)
    eta_dot: torch.Tensor    # (R, 3, M)
    eta_dd: torch.Tensor     # (R, 3, M)
    step: int = 0


class TGNH:
    def __init__(self, field, cfg: dict):
        self.field = field
        w = field.w
        self.w = w
        ig = cfg["integrator"]
        self.dt = float(ig["step_ps"])
        self.substeps = int(ig["drude_substeps"])
        self.M = int(ig["nh_chains"])
        self.wall = float(ig["max_drude_distance_nm"])
        self.cm_freq = int(ig["cm_remover_frequency"])
        kt = BOLTZ * float(ig["temperature_K"])
        kt_d = BOLTZ * float(ig["drude_temperature_K"])
        tau, tau_d = float(ig["coupling_time_ps"]), float(
            ig["drude_coupling_time_ps"])
        dof = w.dof(self.cm_freq > 0)
        dev = field.device
        dt = field.arith.dtype
        self.nkt = torch.tensor([dof[0] * kt, dof[1] * kt, dof[2] * kt_d],
                                dtype=torch.float64, device=dev)
        q0 = [dof[0] * kt * tau ** 2, dof[1] * kt * tau ** 2,
              dof[2] * kt_d * tau_d ** 2]
        self.q_mass = torch.tensor(
            [[q0[b]] + [(kt_d * tau_d ** 2 if b == 2 else kt * tau ** 2)]
             * (self.M - 1) for b in range(3)], dtype=torch.float64,
            device=dev)
        self.kt_chain = torch.tensor([kt, kt, kt_d], dtype=torch.float64,
                                     device=dev)
        # links past the first of the Drude bath stay still (no Drude
        # NH chains)
        self.link = torch.ones((3, self.M), dtype=torch.bool, device=dev)
        self.link[2, 1:] = False
        self.v_wall = math.sqrt(kt_d)
        m = torch.as_tensor(w.mass, dtype=dt, device=dev)
        self.m = m                                    # (5,)
        self.inv_m = torch.where(m > 0, 1.0 / torch.where(
            m > 0, m, torch.ones_like(m)), torch.zeros_like(m))
        self.o, self.d, self.h1, self.h2 = (w.site(s) for s in
                                            ("O", "D", "H1", "H2"))

    # -- state ---------------------------------------------------------------
    def start(self, x, v) -> State:
        dt = self.field.arith.dtype
        x = self.field.place_m(torch.as_tensor(x, dtype=dt,
                                               device=self.field.device))
        v = torch.as_tensor(v, dtype=dt, device=self.field.device)
        R = x.shape[0]
        z = torch.zeros((R, 3, self.M), dtype=torch.float64,
                        device=x.device)
        # links past the first start at -kT / Q (the plugin's start)
        dd = torch.where(self.link[None, :, 1:],
                         -self.kt_chain[None, :, None] / self.q_mass[None, :, 1:],
                         torch.zeros_like(z[..., 1:]))
        return State(x=x, v=v, f=self.field.forces(x), eta=z,
                     eta_dot=z.clone(),
                     eta_dd=torch.cat([z[..., :1], dd], -1))

    def _mol(self, t):
        return t.view(t.shape[0], self.w.n_mol, 5, *t.shape[2:])

    # -- baths ---------------------------------------------------------------
    def _split(self, v):
        """(molecule COM velocities (R, n, 3), velocities relative to it
        (R, n, 5, 3), pair COM of the relative velocities (R, n, 3), the
        Drude's velocity relative to its core (R, n, 3))."""
        m = self.m
        vm = self._mol(v)
        com = torch.sum(m[:, None] * vm, dim=2) / torch.sum(m)
        nv = vm - com[:, :, None]
        mo, md = m[self.o], m[self.d]
        pcm = (mo * nv[:, :, self.o] + md * nv[:, :, self.d]) / (mo + md)
        rel = nv[:, :, self.d] - nv[:, :, self.o]
        return com, nv, pcm, rel

    def kinetic(self, v):
        """(R, 3) twice the KE of each bath, float64."""
        m = self.m.double()
        com, nv, pcm, rel = (t.double() for t in self._split(v))
        h = [self.h1, self.h2]
        internal = (torch.sum(m[h][None, None, :, None] * nv[:, :, h] ** 2,
                              dim=(1, 2, 3))
                    + (m[self.o] + m[self.d]) * torch.sum(pcm ** 2,
                                                          dim=(1, 2)))
        mu = m[self.o] * m[self.d] / (m[self.o] + m[self.d])
        return torch.stack([internal, torch.sum(m) * torch.sum(
            com ** 2, dim=(1, 2)), mu * torch.sum(rel ** 2, dim=(1, 2))], 1)

    def chain(self, st: State, ke):
        """One NH half step of every bath's chain; returns the (R, 3)
        velocity scales and updates the chain in st."""
        M = self.M
        dtc = self.dt / self.substeps
        ed = torch.cat([st.eta_dot, torch.zeros_like(st.eta_dot[..., :1])],
                       dim=-1)
        eta = st.eta.clone()
        Q, link = self.q_mass, self.link
        G = lambda ke: (ke - self.nkt) / Q[:, 0]
        edd = st.eta_dd.clone()
        edd[..., 0] = G(ke)
        scale = torch.ones_like(ke)
        for _ in range(self.substeps):
            for i in reversed(range(M)):
                e = torch.exp(-dtc / 8.0 * ed[..., i + 1])
                new = (ed[..., i] * e + edd[..., i] * dtc / 4.0) * e
                ed[..., i] = torch.where(link[:, i], new, ed[..., i])
            damp = torch.exp(-dtc / 2.0 * ed[..., 0])
            scale = scale * damp
            ke = ke * damp * damp
            eta = torch.where(link, eta + dtc / 2.0 * ed[..., :M], eta)
            edd[..., 0] = G(ke)
            e = torch.exp(-dtc / 8.0 * ed[..., 1])
            ed[..., 0] = (ed[..., 0] * e + edd[..., 0] * dtc / 4.0) * e
            for i in range(1, M):
                e = torch.exp(-dtc / 8.0 * ed[..., i + 1])
                g = (Q[:, i - 1] * ed[..., i - 1] ** 2
                     - self.kt_chain) / Q[:, i]
                new = (ed[..., i] * e + g * dtc / 4.0) * e
                ed[..., i] = torch.where(link[:, i], new, ed[..., i])
                edd[..., i] = torch.where(link[:, i], g, edd[..., i])
        st.eta, st.eta_dot, st.eta_dd = eta, ed[..., :M], edd
        return scale

    def nh_half(self, st: State, v):
        s = self.chain(st, self.kinetic(v)).to(v.dtype)   # (R, 3)
        com, nv, pcm, rel = self._split(v)
        s_int, s_com, s_d = (s[:, b, None, None, None] for b in range(3))
        out = s_int * nv + s_com * com[:, :, None]
        pair = [self.o, self.d]
        out[:, :, pair] = (s_int * pcm[:, :, None]
                           + s_d * (nv[:, :, pair] - pcm[:, :, None])
                           + s_com * com[:, :, None])
        keep = (self.m > 0)[None, None, :, None]
        return torch.where(keep, out, self._mol(v)).reshape(v.shape)

    # -- constraints ---------------------------------------------------------
    def _bonds(self):
        o, h1, h2 = self.o, self.h1, self.h2
        return [(o, h1, self.w.r_oh), (o, h2, self.w.r_oh),
                (h1, h2, self.w.r_hh)]

    def shake(self, x, d):
        """The constrained displacements: d + sum_k lam_k g r0_k / m, r0_k
        the bonds at x, such that every bond at x + d has its length."""
        xm, dm = self._mol(x), self._mol(d).clone()
        bonds = self._bonds()
        r0 = [xm[:, :, a] - xm[:, :, b] for a, b, _ in bonds]
        inv = self.inv_m
        lam = torch.zeros(x.shape[0], self.w.n_mol, 3, dtype=x.dtype,
                          device=x.device)

        def moved(lam):
            out = dm.clone()
            for k, (a, b, _) in enumerate(bonds):
                out[:, :, a] += lam[..., k, None] * inv[a] * r0[k]
                out[:, :, b] -= lam[..., k, None] * inv[b] * r0[k]
            return out

        for _ in range(NEWTON_ITERS):
            dd = moved(lam)
            rk = [r0[k] + dd[:, :, a] - dd[:, :, b]
                  for k, (a, b, _) in enumerate(bonds)]
            F = torch.stack([torch.sum(rk[k] ** 2, -1) - L ** 2
                             for k, (_, _, L) in enumerate(bonds)], -1)
            J = torch.empty(F.shape + (3,), dtype=x.dtype, device=x.device)
            for k, (a, b, _) in enumerate(bonds):
                for l, (c, e, _) in enumerate(bonds):
                    # d r_k / d lam_l = r0_l (g_la inv_a - g_lb inv_b)
                    ca = ((1.0 if c == a else -1.0 if e == a else 0.0)
                          * inv[a])
                    cb = ((1.0 if c == b else -1.0 if e == b else 0.0)
                          * inv[b])
                    J[..., k, l] = 2.0 * (ca - cb) * torch.sum(
                        rk[k] * r0[l], -1)
            lam = lam - torch.linalg.solve(J, F)
        return moved(lam).reshape(d.shape)

    def rattle(self, x, v):
        """v with every bond's relative velocity along it removed (mass
        weighted, along the bonds at x)."""
        xm, vm = self._mol(x), self._mol(v).clone()
        bonds = self._bonds()
        r = [xm[:, :, a] - xm[:, :, b] for a, b, _ in bonds]
        inv = self.inv_m
        A = torch.empty(x.shape[0], self.w.n_mol, 3, 3, dtype=x.dtype,
                        device=x.device)
        rhs = torch.stack([-torch.sum(r[k] * (vm[:, :, a] - vm[:, :, b]),
                                      -1) for k, (a, b, _) in
                           enumerate(bonds)], -1)
        for k, (a, b, _) in enumerate(bonds):
            for l, (c, e, _) in enumerate(bonds):
                ca = (1.0 if c == a else -1.0 if e == a else 0.0) * inv[a]
                cb = (1.0 if c == b else -1.0 if e == b else 0.0) * inv[b]
                A[..., k, l] = (ca - cb) * torch.sum(r[k] * r[l], -1)
        mu = torch.linalg.solve(A, rhs)
        for k, (a, b, _) in enumerate(bonds):
            vm[:, :, a] += mu[..., k, None] * inv[a] * r[k]
            vm[:, :, b] -= mu[..., k, None] * inv[b] * r[k]
        return vm.reshape(v.shape)

    # -- hard wall -----------------------------------------------------------
    def hard_wall(self, x, v):
        xm, vm = self._mol(x).clone(), self._mol(v).clone()
        o, d = self.o, self.d
        md, mo = self.m[d], self.m[o]
        mt = md + mo
        delta = xm[:, :, d] - xm[:, :, o]
        r = torch.sqrt(torch.sum(delta ** 2, -1))
        hit = r > self.wall
        u = delta / r[..., None]
        v1 = torch.sum(vm[:, :, d] * u, -1)
        v2 = torch.sum(vm[:, :, o] * u, -1)
        vcm = (md * v1 + mo * v2) / mt
        dv1, dv2 = v1 - vcm, v2 - vcm
        dr = r - self.wall
        rel = torch.abs(dv1 - dv2)
        tb = torch.minimum(torch.where(rel > 0, dr / torch.where(
            rel > 0, rel, torch.ones_like(rel)), torch.full_like(r, self.dt)),
            torch.full_like(r, self.dt))
        vb = self.v_wall / torch.sqrt(md)
        n1 = -torch.sign(dv1) * vb * mo / mt
        n2 = -torch.sign(dv2) * vb * md / mt
        r1 = -dr * mo / mt + tb * n1
        r2 = dr * md / mt + tb * n2
        h = hit[..., None]
        xm[:, :, d] = torch.where(h, xm[:, :, d] + u * r1[..., None],
                                  xm[:, :, d])
        xm[:, :, o] = torch.where(h, xm[:, :, o] + u * r2[..., None],
                                  xm[:, :, o])
        vm[:, :, d] = torch.where(
            h, vm[:, :, d] + u * (n1 + vcm - v1)[..., None], vm[:, :, d])
        vm[:, :, o] = torch.where(
            h, vm[:, :, o] + u * (n2 + vcm - v2)[..., None], vm[:, :, o])
        return xm.reshape(x.shape), vm.reshape(v.shape)

    # -- the step ------------------------------------------------------------
    def _per_site(self, t):
        return t.repeat(self.w.n_mol)

    def step(self, st: State) -> State:
        dt = self.dt
        inv = self._per_site(self.inv_m)[None, :, None]
        moving = inv > 0
        m_all = self._per_site(self.m)[None, :, None]
        v = st.v
        if self.cm_freq > 0 and st.step % self.cm_freq == 0:
            vcm = torch.sum(m_all * v, dim=1) / torch.sum(m_all)
            v = torch.where(moving, v - vcm[:, None], v)
        v = self.nh_half(st, v)
        v = torch.where(moving, v + 0.5 * dt * inv * st.f, v)
        d = torch.where(moving, dt * v, torch.zeros_like(v))
        d = self.shake(st.x, d)
        x = st.x + d
        v = torch.where(moving, d / dt, v)
        x, v = self.hard_wall(x, v)
        x = self.field.place_m(x)
        f = self.field.forces(x)
        v = torch.where(moving, v + 0.5 * dt * inv * f, v)
        v = self.rattle(x, v)
        st.step += 1
        st.x, st.f = x, f
        st.v = self.nh_half(st, v)
        return st
