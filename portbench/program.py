"""The system under test, built from a configuration file: the port's
Context (one replica) or FlatReplicaEnsemble (several), at the
configuration's sizes, started from the benchmark's inputs.

Everything the harness takes from the program passes through `Program`:
`step(n)` (the window's call), `state()` (positions, velocities, forces
the chain and the boxes as host arrays, (R, n0, ...) for R replicas, the pad
replicas of a flat layout included), `launches()` (the port's kernel
launch counters) and `free()`.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def load_inputs(cfg: dict, root: str) -> dict:
    """The configuration's input file, refused unless its sha256 is the
    one the configuration pins."""
    spec = cfg["inputs"]
    path = os.path.join(root, spec["path"])
    got = sha256(path)
    if got != spec["sha256"]:
        raise ValueError(f"{spec['path']}: sha256 {got}, the configuration "
                         f"pins {spec['sha256']}")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class Program:
    def __init__(self, cfg: dict, inputs: dict, system_mod, generator,
                 traffic: dict, device: str):
        """The configuration's system (`system_mod.build`), what the
        traffic's ensemble adds to it (`generator.prepare`), one Context
        at the configuration's precision, and a FlatReplicaEnsemble of
        cfg["replicas"] where that is more than one."""
        import openmm_drudenose_tpu_torch as port
        self.cfg = cfg
        system, integ = system_mod.build(cfg, port)
        generator.prepare(system, traffic, port)
        # the cell capacity: the snapshot's, or the configuration's (a
        # capacity growth inside the window would rerun a whole call)
        nb = {}
        cap = inputs.get("capacity", cfg.get("capacity"))
        if cap is not None:
            nb["capacity"] = int(cap)
        ctx = port.Context(system, integ, precision=cfg["precision"],
                           device=device, nb_options=nb)
        ctx.setPositions(np.asarray(inputs["positions"], np.float64))
        R = int(cfg["replicas"])
        self.ensemble = None
        if R > 1:
            self.ensemble = port.FlatReplicaEnsemble(ctx, R)
            self.context = self.ensemble.context
            self.r_int = self.ensemble.n_replicas_padded
        else:
            self.context = ctx
            self.r_int = 1
        self.n_replicas = R
        self.n0 = system.getNumParticles()
        self._check_plan()

    def _check_plan(self) -> None:
        """The PME grid and cell grid the program planned are the
        configuration's (its reference sums on that grid)."""
        nbt = self.context._nb
        grid = list(nbt.pme.grid)
        if grid != list(self.cfg["pme_grid"]):
            raise ValueError(f"PME grid {grid}, the configuration "
                             f"{self.cfg['pme_grid']}")
        want = self.cfg.get("cell_grid")
        cp = self.context._cp_cfg
        if want is not None and (cp is None
                                 or list(cp.phys_grid) != list(want)):
            got = None if cp is None else list(cp.phys_grid)
            raise ValueError(f"cell grid {got}, the configuration {want}")

    def set_velocities(self, v: np.ndarray) -> None:
        """(r_int, n0, 3) velocities, one block a replica."""
        self.context.setVelocities(np.asarray(v, np.float64).reshape(-1, 3))

    def step(self, n: int) -> None:
        self.context._integrator.step(int(n))

    def state(self) -> dict:
        """Host copies: exact positions (positions + compensation),
        velocities, forces (r_int, n0, 3); the chain's eta_dot
        (r_int, baths, links); each replica's (3, 3) box (r_int, 3, 3)
        (the template box times its scale in flat-ensemble NPT); the
        step count."""
        st = self.context._state
        shape = (self.r_int, self.n0, 3)
        x = st.positions.double()
        if st.pos_err is not None:
            x = x + st.pos_err.double()
        ed = st.eta_dot.double().cpu().numpy()
        ed = ed.reshape(self.r_int, -1, ed.shape[-1])[..., :-1]
        return {"x": x.cpu().numpy().reshape(shape),
                "v": st.velocities.double().cpu().numpy().reshape(shape),
                "f": st.forces.double().cpu().numpy().reshape(shape),
                "eta_dot": ed, "box": self._boxes(st), "step": int(st.step)}

    def _boxes(self, st) -> np.ndarray:
        box = st.box.double().cpu().numpy()
        s = (np.ones(self.r_int) if st.rep_scale is None
             else st.rep_scale.double().cpu().numpy())
        return s[:, None, None] * box[None]

    def capacity(self):
        """The cell capacity the program runs at (None without cells)."""
        cp = self.context._cp_cfg
        return None if cp is None else int(cp.capacity)

    @staticmethod
    def launches() -> dict:
        from openmm_drudenose_tpu_torch.ops import nh_chain, sweep
        out = dict(sweep.launches)
        out.update(nh_chain.launches)
        return out

    def free(self) -> None:
        self.context = None
        self.ensemble = None
