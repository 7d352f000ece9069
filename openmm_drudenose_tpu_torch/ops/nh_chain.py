"""The Nose-Hoover chain of the TGNH integrator on the card: the kernel
csrc/nh_chain.cu, with its plain PyTorch version beside it.

Replaces no TPU kernel: the JAX package runs the chain inside its jitted
step as XLA code (integrators/tgnh.py::propagate_nh_chain, :211-294
there, and the fused body's NH pair, _make_multi_step_fused :809-941).
The port ran it in numpy on the host, reading the KE back every step; a
kernel keeps the chain, the KE and the constants on the card, so the
step never waits for the stream.  One thread a (replica, bath) row, in
float64 registers; latency-bound (csrc/nh_chain.cu says why).

`run(spec, static, mode, ke, eta, eta_dot, eta_dot_dot, dt, vs, mom,
total_mass, m01)` -> (scale, ke_a, shift, eta, eta_dot, eta_dot_dot):

  FIRST               one half step (Stepper.nh_half): scale = vscale,
                      ke_a the damped KE
  FIRST | SECOND      the fused step's NH pair on one KE measurement
                      (Stepper.fused_body): scale = vs_a vs_b, ke_a the KE
                      between the halves
  FIRST, then SECOND  the same pair around a barostat move: vs_a (the
                      first launch's scale) and ke_a pass to the second
  | CM                the COM bath's KE lowered by m01 M_tot |vs_a[G]
                      v_cm|^2 after the first half (v_cm = mom /
                      total_mass); with SECOND also the CM shift m01
                      vs_a[G] vs_b[G] v_cm, (R, 3) or (3,)

Shapes: ke (G+2,) or (R, G+2) for R replicas; the chain (.., G+2, M),
(.., G+2, M + 1), (.., G+2, M); the spec's constants one replica's.
Everything is computed in float64 and rounded to the chain's type at
the points `run_plain` rounds it.  For a CPU tensor `run` takes the plain
version; for a CUDA tensor it launches the kernel (float32 or float64)
or raises.  The kernel builds with the sweep kernels (ops/sweep.py::
build) and counts its launches in `launches["nh_chain"]`.
"""

from __future__ import annotations

import ctypes

import torch

FIRST, SECOND, CM = 1, 2, 4

# launches of the kernel, counted where it is launched and nowhere else
launches = {"nh_chain": 0}


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _safe_inv(x):
    pos = x > 0
    return torch.where(pos, 1.0 / torch.where(pos, x, torch.ones_like(x)),
                       torch.zeros_like(x))


def propagate_nh_chain(spec, static, ke, eta, eta_dot, eta_dot_dot, dt,
                       return_final_ke: bool = False):
    """Half-step NH chain update of all G+2 baths at once ((R, G+2)
    baths of a flattened ensemble too: the chain arrays carry the leading
    replica axis, the constants broadcast), on the device of its inputs.

    The reference's propagateNHChain (CudaDrudeTGNHKernels.cpp:558-642),
    as the JAX package's propagate_nh_chain (integrators/tgnh.py:211-294
    there) writes it: drude_steps symmetric Trotter substeps with
    exp(-dtc/8) damping and dtc/4 kicks; the Drude bath freezes links
    >= 1 unless Drude NH chains are on.  Computed in float64 whatever the
    chain's type, and returned in it: (vscale, eta, eta_dot,
    eta_dot_dot[, the damped KE]).  Inputs are tensors or arrays; the
    kernel's plain version (`run_plain`)."""
    eta = _tensor(eta)
    out = eta.dtype
    dev = eta.device
    f64 = lambda x: _tensor(x).to(device=dev, dtype=torch.float64)
    M = static.n_chains
    eta = f64(eta).clone()
    ed = f64(eta_dot).clone()
    edd = f64(eta_dot_dot).clone()
    ke = f64(ke)
    eta_mass = f64(spec.nh_eta_mass)
    nkbt = f64(spec.nh_nkbt)
    kbt_chain = f64(spec.nh_kbt_chain)
    link = _tensor(spec.nh_link_active).to(device=dev, dtype=torch.bool)
    dtc = float(dt) / static.drude_steps
    dtc2, dtc4, dtc8 = dtc / 2.0, dtc / 4.0, dtc / 8.0
    mass0_pos = eta_mass[:, 0] > 0
    inv_eta_mass0 = _safe_inv(eta_mass[:, 0])
    inv_eta_mass = _safe_inv(eta_mass)

    edd[..., 0] = torch.where(mass0_pos, (ke - nkbt) * inv_eta_mass0,
                              edd[..., 0])
    vscale = torch.ones_like(ke)
    for _ in range(static.drude_steps):
        for i in reversed(range(M)):
            expfac = torch.exp(-dtc8 * ed[..., i + 1])
            new = (ed[..., i] * expfac + edd[..., i] * dtc4) * expfac
            ed[..., i] = torch.where(link[:, i], new, ed[..., i])
        damp = torch.exp(-dtc2 * ed[..., 0])
        vscale = vscale * damp
        ke = ke * damp * damp
        eta = torch.where(link, eta + dtc2 * ed[..., :M], eta)
        edd0 = torch.where(mass0_pos, (ke - nkbt) * inv_eta_mass0,
                           edd[..., 0])
        edd[..., 0] = edd0
        expfac0 = torch.exp(-dtc8 * ed[..., 1])
        ed[..., 0] = (ed[..., 0] * expfac0 + edd0 * dtc4) * expfac0
        for i in range(1, M):
            expfac = torch.exp(-dtc8 * ed[..., i + 1])
            d = ed[..., i] * expfac
            eddi = (eta_mass[:, i - 1] * (ed[..., i - 1] * ed[..., i - 1])
                    - kbt_chain) * inv_eta_mass[:, i]
            d = (d + eddi * dtc4) * expfac
            ed[..., i] = torch.where(link[:, i], d, ed[..., i])
            edd[..., i] = torch.where(link[:, i], eddi, edd[..., i])
    res = tuple(x.to(out) for x in (vscale, eta, ed, edd))
    return res + (ke.to(out),) if return_final_ke else res


def _v_cm(mom, total_mass):
    """The CM velocity mom / M_tot in float64: (3,) or (R, 3)."""
    return mom.double() / total_mass.double().unsqueeze(-1)


def run_plain(spec, static, mode, ke, eta, eta_dot, eta_dot_dot, dt,
              vs=None, mom=None, total_mass=None, m01=0.0):
    """The kernel's plain version, on any device: propagate_nh_chain for
    each half, the CM correction and the composition in float64, each
    result rounded to the chain's type where the kernel rounds it."""
    G = static.n_temp_groups
    out = eta.dtype
    v_cm = _v_cm(mom, total_mass) if mode & CM else None
    if mode & FIRST:
        vs_a, eta, eta_dot, eta_dot_dot, ke_a = propagate_nh_chain(
            spec, static, ke, eta, eta_dot, eta_dot_dot, dt,
            return_final_ke=True)
        if mode & CM:
            s = vs_a[..., G, None].double() * v_cm
            sq = s * s
            ke_a = ke_a.clone()
            ke_a[..., G] = (ke_a[..., G].double() - m01
                            * total_mass.double()
                            * (sq[..., 0] + sq[..., 1] + sq[..., 2])).to(out)
    else:
        vs_a, ke_a = vs, ke
    scale, shift = vs_a, None
    if mode & SECOND:
        vs_b, eta, eta_dot, eta_dot_dot = propagate_nh_chain(
            spec, static, ke_a, eta, eta_dot, eta_dot_dot, dt)
        scale = (vs_a.double() * vs_b.double()).to(out)
        if mode & CM:
            fac = m01 * vs_b[..., G].double() * vs_a[..., G].double()
            shift = (fac.unsqueeze(-1) * v_cm).to(out)
    return scale, ke_a, shift, eta, eta_dot, eta_dot_dot


def _declare(lib):
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.nh_chain.argtypes = [ci] * 7 + [cd, cd] + [vp] * 18
    lib.nh_chain.restype = ci
    lib.nh_chain_attributes.argtypes = [vp, ci]
    lib.nh_chain_attributes.restype = ci
    lib.nh_chain_max_links.restype = ci


def _lib():
    from . import sweep
    return sweep.load("nh_chain", _declare)


def attributes(is_double: bool = False) -> dict:
    """Registers a thread, static shared memory, the most threads a CTA
    may have and local bytes a thread of the kernel's float32 (or
    float64) instantiation, read from the card."""
    out = (ctypes.c_int * 4)()
    err = _lib().nh_chain_attributes(ctypes.cast(out, ctypes.c_void_p),
                                     int(is_double))
    if err != 0:
        raise RuntimeError(f"nh_chain_attributes failed: CUDA error {err}")
    return {"regs": out[0], "static_smem": out[1], "max_threads": out[2],
            "local_bytes": out[3]}


def run(spec, static, mode, ke, eta, eta_dot, eta_dot_dot, dt, vs=None,
        mom=None, total_mass=None, m01=0.0):
    """The chain's half step or NH pair (module docstring): the plain
    version for CPU tensors, the kernel for CUDA tensors (or raise)."""
    if ke.device.type == "cpu":
        return run_plain(spec, static, mode, ke, eta, eta_dot, eta_dot_dot,
                         dt, vs, mom, total_mass, m01)
    if ke.device.type != "cuda":
        raise ValueError(f"unsupported device {ke.device}")
    T = eta.dtype
    if T not in (torch.float32, torch.float64):
        raise ValueError(f"the NH chain kernel takes float32 or float64, "
                         f"not {T}")
    B, M = static.n_temp_groups + 2, static.n_chains
    rows = ke.numel()
    R = rows // B if rows % B == 0 else 0
    lib = _lib()
    if R < 1 or not 1 <= M <= lib.nh_chain_max_links():
        raise ValueError(f"{rows} bath rows of {B} baths and {M} links: "
                         f"the kernel takes whole replicas and 1 to "
                         f"{lib.nh_chain_max_links()} links")
    cm = bool(mode & CM)
    ke, eta, eta_dot, eta_dot_dot = (t.contiguous() for t in (
        ke, eta, eta_dot, eta_dot_dot))
    if not mode & FIRST:
        vs = vs.contiguous()
    if cm:
        mom, total_mass = mom.contiguous(), total_mass.contiguous()
    shapes = [(ke, rows), (eta, rows * M), (eta_dot, rows * (M + 1)),
              (eta_dot_dot, rows * M), (spec.nh_eta_mass, B * M),
              (spec.nh_nkbt, B), (spec.nh_kbt_chain, B)]
    if not mode & FIRST:
        shapes.append((vs, rows))
    if cm:
        shapes += [(mom, R * 3), (total_mass, R)]
    for t, n in shapes:
        if (t.device != ke.device or t.dtype != T or t.numel() != n
                or not t.is_contiguous()):
            raise ValueError(f"the NH chain kernel needs contiguous {T} "
                             f"tensors of {n} values on {ke.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    link = spec.nh_link_active
    if (link.device != ke.device or link.dtype != torch.bool
            or link.numel() != B * M or not link.is_contiguous()):
        raise ValueError("the NH chain kernel needs the link mask as a "
                         f"contiguous bool ({B}, {M}) tensor on "
                         f"{ke.device}")
    scale = torch.empty_like(ke)
    ke_a = torch.empty_like(ke)
    shift = (torch.empty(mom.shape, dtype=T, device=ke.device)
             if cm and mode & SECOND else None)
    eta_o = torch.empty_like(eta)
    ed_o = torch.empty_like(eta_dot)
    edd_o = torch.empty_like(eta_dot_dot)
    p = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())
    stream = torch.cuda.current_stream(ke.device).cuda_stream
    err = lib.nh_chain(
        int(T == torch.float64), int(mode), rows, B, M,
        int(static.drude_steps), static.n_temp_groups, float(dt),
        float(m01), p(ke), p(None if mode & FIRST else vs), p(eta),
        p(eta_dot), p(eta_dot_dot), p(spec.nh_eta_mass), p(spec.nh_nkbt),
        p(spec.nh_kbt_chain), p(link), p(mom if cm else None),
        p(total_mass if cm else None), p(scale), p(ke_a), p(shift),
        p(eta_o), p(ed_o), p(edd_o), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"NH chain kernel launch failed: CUDA error "
                           f"{err}")
    launches["nh_chain"] += 1
    return scale, ke_a, shift, eta_o, ed_o, edd_o
