"""Collectives over torch.distributed ranks: the port's counterpart of
what `shard_map` gives the JAX package's multi-chip modules (psum,
all_gather, all_to_all, psum_scatter, ppermute on a ring), and a rank
launcher.

A `Mesh` names the ranks' axes, as jax.sharding.Mesh does: ("atom",),
("replica",) or ("replica", "atom"), ranks laid out row-major over the
axes, with a process group for each axis (the ranks that differ only in
that axis's coordinate).  Collectives take the axis name.

The backend is the caller's choice (`launch(..., backend=...)`), never
switched quietly; every collective calls it, an axis of one rank too.
NCCL takes each collective as it is.  Gloo takes
CUDA tensors only in broadcast and all_reduce, so with gloo every
collective on a CUDA tensor goes through a pinned host copy and back to
the tensor's device.  A machine with one card runs several ranks on it
only over gloo: NCCL refuses two ranks on one device.

`launch(fn, world, backend, device, timeout_s)` starts `world` ranks with
the "spawn" start method, joins them through a FileStore in a temporary
directory (no TCP port, so that concurrent runs never race for one),
calls fn(mesh_args...) on each, and returns each rank's result.  The
process group's timeout bounds every collective, so a rank that hangs
fails the run after `timeout_s`; a rank's exception reaches the caller
with its traceback.  `Deferred(world, backend, device, timeout_s)`
starts the ranks at once and runs a function given later (`go`), so
that their start-up overlaps the caller's work.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

AXES = (("atom",), ("replica",), ("replica", "atom"))
# the device `launch` gave this process's rank (the CPU outside a launch)
_RANK_DEVICE = [torch.device("cpu")]
# the flat-tensor collectives under their newer names where this torch
# has them (the older ones warn there)
_ALL_GATHER = getattr(dist, "all_gather_single",
                      dist.all_gather_into_tensor)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


class Mesh:
    """The ranks of the default process group over named axes.

    shape: each axis's size (their product is the world size); rank r
    sits at the row-major coordinates of r.  Built by every rank, in the
    same order, after the process group is up (`launch` does it).
    device: the rank's torch device, by default the one `launch` gave
    it (rank_device)."""

    def __init__(self, axis_names=("atom",), shape=None, device=None):
        axis_names = tuple(axis_names)
        if axis_names not in AXES:
            raise ValueError(f"mesh axes {axis_names}: the port takes "
                             f"{AXES}")
        world = dist.get_world_size()
        if shape is None:
            shape = (world,) if len(axis_names) == 1 else None
        if shape is None or len(shape) != len(axis_names) \
                or int(np.prod(shape)) != world:
            raise ValueError(f"mesh shape {shape} over {axis_names} does "
                             f"not cover {world} ranks")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, (int(s) for s in shape)))
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.device = rank_device() if device is None else torch.device(
            device)
        grid = np.arange(world).reshape(tuple(self.shape.values()))
        self.coords = dict(zip(axis_names, (
            int(c) for c in np.unravel_index(self.rank, grid.shape))))
        self._groups = {}
        self._ranks = {}
        for i, name in enumerate(axis_names):
            # every line of ranks along axis i; each rank makes all of
            # them (new_group is collective) and keeps its own
            lines = np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i])
            for line in lines:
                ranks = [int(r) for r in line]
                g = (dist.group.WORLD if len(ranks) == world
                     else dist.new_group(ranks))
                if self.rank in ranks:
                    self._groups[name] = g
                    self._ranks[name] = ranks

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (jax.lax.axis_index)."""
        return self.coords[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def ranks(self, axis: str) -> list:
        """The global ranks along `axis` through this rank, in
        coordinate order."""
        return self._ranks[axis]


def rank_device() -> torch.device:
    """This rank's device as `launch` set it: cuda:i for a "cuda" launch
    (rank r on card r mod the card count, all on cuda:0 on a one-card
    machine), the CPU otherwise."""
    return _RANK_DEVICE[0]


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    """Whether a collective on `t` goes through a pinned host copy (gloo
    on a CUDA tensor)."""
    return mesh.backend == "gloo" and t.is_cuda


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor (a synchronous copy)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce_sum(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks along `axis` (jax.lax.psum), a new
    tensor on t's device; every rank gets the same bits."""
    g = mesh.group(axis)
    if _staged(mesh, t):
        h = _host(t)
        dist.all_reduce(h, group=g)
        return h.to(t.device)
    out = t.clone()
    dist.all_reduce(out, group=g)
    return out


def all_gather(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """The ranks' `t` along `axis` stacked on a new leading axis in
    coordinate order: (size,) + t.shape."""
    n = mesh.size(axis)
    g = mesh.group(axis)
    flat = t.reshape(-1)
    staged = _staged(mesh, flat)
    src = _host(flat) if staged else flat.contiguous()
    out = torch.empty(n * src.numel(), dtype=t.dtype, device=src.device,
                      pin_memory=staged)
    _ALL_GATHER(out, src, group=g)
    return out.reshape((n,) + tuple(t.shape)).to(t.device)


def reduce_scatter(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks along `axis` of `t`, of which each rank
    keeps its block of the leading dimension (jax.lax.psum_scatter,
    tiled): t.shape[0] must divide by the axis size."""
    n = mesh.size(axis)
    if t.shape[0] % n:
        raise ValueError(f"leading dimension {t.shape[0]} does not divide "
                         f"into {n} ranks")
    g = mesh.group(axis)
    t = t.contiguous()
    shape = (t.shape[0] // n,) + tuple(t.shape[1:])
    if _staged(mesh, t):
        h = _host(t)
        out = torch.empty(shape, dtype=t.dtype, pin_memory=True)
        _REDUCE_SCATTER(out, h, group=g)
        return out.to(t.device)
    out = torch.empty(shape, dtype=t.dtype, device=t.device)
    _REDUCE_SCATTER(out, t, group=g)
    return out


def all_to_all(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """Block i of t's leading dimension goes to the rank at coordinate i,
    and block j of the result came from the rank at coordinate j
    (jax.lax.all_to_all, split and concatenated on axis 0)."""
    n = mesh.size(axis)
    if t.shape[0] % n:
        raise ValueError(f"leading dimension {t.shape[0]} does not divide "
                         f"into {n} ranks")
    g = mesh.group(axis)
    t = t.contiguous()
    if _staged(mesh, t):
        h = _host(t)
        out = torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
        dist.all_to_all_single(out, h, group=g)
        return out.to(t.device)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=g)
    return out


def _shift(mesh: Mesh, axis: str, t, step: int):
    """Send `t` to the rank `step` places on along the ring of `axis` and
    return what the rank `step` places back sent (a new tensor of t's
    shape, dtype and device)."""
    ranks = mesh.ranks(axis)
    n = len(ranks)
    me = mesh.index(axis)
    dst, src = ranks[(me + step) % n], ranks[(me - step) % n]
    staged = _staged(mesh, t)
    send = _host(t) if staged else t.contiguous()
    recv = torch.empty(send.shape, dtype=send.dtype, device=send.device,
                       pin_memory=staged)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dst, group=mesh.group(axis)),
        dist.P2POp(dist.irecv, recv, src, group=mesh.group(axis))])
    for r in reqs:
        r.wait()
    return recv.to(t.device) if staged else recv


def ring_exchange(mesh: Mesh, axis: str, send_left=None, send_right=None):
    """One step on the ring of `axis` (jax.lax.ppermute with the
    permutations i -> i - 1 and i -> i + 1): `send_left` goes to the rank
    before this one, `send_right` to the rank after.  Returns (from_left,
    from_right): what the rank before sent right and what the rank after
    sent left (None for a direction nobody sent; a direction is sent by
    every rank of the ring or by none).  The two directions go one after
    the other, so two ranks (each the other's left and right) never
    confuse them."""
    if mesh.size(axis) == 1:
        return (None if send_right is None else send_right.clone(),
                None if send_left is None else send_left.clone())
    from_right = (None if send_left is None
                  else _shift(mesh, axis, send_left, -1))
    from_left = (None if send_right is None
                 else _shift(mesh, axis, send_right, 1))
    return from_left, from_right


# -- the rank launcher --------------------------------------------------------

def _rank_main(rank, fn, args, world, backend, device, store_path,
               out_dir, timeout_s, threads):
    """One rank: join the group, run fn(*args), save its result."""
    if threads:
        torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    _RANK_DEVICE[0] = dev
    store = dist.FileStore(store_path, world)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"result_{rank}.pt"))
        dist.barrier()
    except BaseException:
        # the first failure is the cause; the other ranks' failures that
        # follow (a closed connection) are written too
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def launch(fn, world: int, backend: str = "gloo", device="cuda",
           timeout_s: float = 300.0, args=(), threads: int | None = None):
    """Run fn(*args) on `world` new ranks ("spawn") joined in one process
    group of `backend` ("gloo" or "nccl"; chosen by the caller) and
    return the list of their results, rank by rank (torch.save'd and
    loaded: tensors, numpy arrays, numbers).  fn is importable by name
    (a module-level function) and builds its Mesh itself.

    device: "cuda" (the default: rank r on card r mod the card count),
    "cuda:i" (every rank on card i) or "cpu" (asked for explicitly);
    ranks share a card over gloo only (NCCL refuses two ranks on one
    device), and a cuda device without a card raises here.  timeout_s bounds each collective (the
    process group's timeout) and the whole run (twice it, and the ranks
    killed on expiry).  A rank's exception raises here with its
    traceback.  threads: torch's CPU threads a rank (the ranks of a CPU
    run share the host's cores)."""
    import torch.multiprocessing as mp
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: 'gloo' or 'nccl'")
    if backend == "nccl" and torch.device(device).type != "cuda":
        raise ValueError("the nccl backend needs a cuda device")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA card here (pass "
                           f"device='cpu' to run the ranks on the CPU)")
    with tempfile.TemporaryDirectory(prefix="dn_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, tuple(args), int(world), backend,
                              str(device), store, tmp, float(timeout_s),
                              threads),
            nprocs=int(world), join=False, start_method="spawn")
        deadline = time.time() + 2.0 * float(timeout_s)
        try:
            while not ctx.join(timeout=1.0):
                if time.time() > deadline:
                    raise TimeoutError(
                        f"{world} ranks did not finish within "
                        f"{2.0 * timeout_s:.0f} s")
        except BaseException as err:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(timeout=30)
            reports = [(os.path.getmtime(f), f) for f in (
                os.path.join(tmp, f"error_{r}.txt") for r in range(world))
                if os.path.exists(f)]
            if not reports:
                raise
            text = "\n".join(open(f).read() for _, f in sorted(reports))
            raise RuntimeError(f"a rank failed (the failing ranks' "
                               f"tracebacks, in the order they were "
                               f"written):\n{text}") from err
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"),
                           weights_only=False) for r in range(int(world))]


def _run_when_told(go_path):
    """A deferred rank: wait for the launcher's (fn, args) in `go_path`,
    then fn(*args); None there ends the rank with no work."""
    while not os.path.exists(go_path):
        time.sleep(0.2)
    job = torch.load(go_path, weights_only=False)
    return None if job is None else job[0](*job[1])


class Deferred:
    """`world` ranks started now, in a background thread, that run a
    function given later: `go(fn, *args)` hands it to them and returns
    their results as `launch` does; `cancel()` ends them with no work
    (a no-op once they have run).  The ranks start their processes, join
    their group and reach their device while the caller works on, so
    their start-up leaves the caller's path.  timeout_s is launch's, and
    it also bounds the wait for the go."""

    def __init__(self, world, backend="gloo", device="cuda",
                 timeout_s=300.0, threads=None):
        import threading
        self._dir = tempfile.mkdtemp(prefix="dn_deferred_")
        self._go = os.path.join(self._dir, "go.pt")
        self._out = {}
        self._sent = False

        def run():
            try:
                self._out["res"] = launch(_run_when_told, world, backend,
                                          device, timeout_s,
                                          args=(self._go,), threads=threads)
            except BaseException as err:
                self._out["err"] = err

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _send(self, job):
        if self._sent:
            return False
        self._sent = True
        tmp = self._go + ".tmp"
        torch.save(job, tmp)
        os.replace(tmp, self._go)
        return True

    def _join(self):
        self._thread.join()
        shutil.rmtree(self._dir, ignore_errors=True)

    def go(self, fn, *args):
        """Run fn(*args) on the ranks; their results, rank by rank."""
        if not self._send((fn, args)):
            raise RuntimeError("these ranks already ran")
        self._join()
        if "err" in self._out:
            raise self._out["err"]
        return self._out["res"]

    def cancel(self):
        if self._send(None):
            self._join()
