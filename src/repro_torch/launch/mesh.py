"""Device meshes over ``torch.distributed`` (the twin of the JAX package's
``launch/mesh.py``).

JAX serves a mesh from one controller; the port runs one process per mesh
position (SPMD): ``torchrun`` launches them on the card, and tests and
``chip_smoke.py`` spawn them with ``torch.multiprocessing``.  A ``Mesh``
names the axes of the world's ranks laid out row-major over ``shape`` (the
order ``jax.make_mesh`` gives host devices), and owns one process group
per axis, one over all the data axes (every axis but ``model``) and the
world over all axes — the groups the runtime's collectives
(``runtime.py``) run over.

Single pod: (16, 16) = 256 chips, axes (data, model).
Multi-pod:  (2, 16, 16) = 512 chips, axes (pod, data, model) — "pod" is
extra data parallelism.

Functions, not module constants: importing this module touches no process
group.  Rank ``r`` computes on ``cuda:(local_rank % device_count)`` (or the
CPU when the caller asks for it); the backend is NCCL when the ranks map to
distinct cards and gloo otherwise — NCCL refuses two ranks on one card.
The choice is printed, never silent.

Collectives that training differentiates (``all_gather``, ``all_reduce``,
``copy_to``) are autograd ``Function``s whenever their input requires
grad, each with the backward its consumer needs; ``ShapeMesh`` is the
same interface at one rank of a mesh of any shape with no process group,
for the meta-device dry run (``launch/dryrun.py``).
"""
from __future__ import annotations

import math
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(device: str = "cuda", *, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None,
                     local_rank: Optional[int] = None,
                     verbose: bool = True) -> torch.device:
    """Join the process group (once) and return this rank's device.

    Without arguments it reads what ``torchrun`` exports (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``);
    tests pass ``rank``, ``world_size`` and a ``file://`` ``init_method``
    (a ``FileStore`` rendezvous, no TCP port).  ``device="cuda"`` raises
    without a card."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) \
        if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank)) \
        if local_rank is None else local_rank
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda (the default) needs a CUDA "
                               "card; pass --device cpu to run on the CPU")
        n = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n)
        torch.cuda.set_device(dev)
        backend = "nccl" if world_size <= n else "gloo"
        why = (f"{world_size} ranks on {n} card(s): "
               + ("one card each" if backend == "nccl"
                  else "ranks share a card, which NCCL refuses"))
    else:
        dev = torch.device("cpu")
        backend, why = "gloo", "CPU tensors"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
        if verbose and rank == 0:
            print(f"distributed: backend={backend} ({why}), "
                  f"world={world_size}, device={dev.type}", flush=True)
    return dev


class Mesh:
    """Named axes over the world's ranks (row-major over ``shape``), this
    rank's coordinates on them, and the process groups the collectives run
    over.  A one-position mesh needs no process group: every collective
    over it is the identity.

    ``shape`` is a dict axis -> size in axis order, as ``jax.sharding.Mesh``
    exposes it; ``devices`` the (shape) array of ranks; ``device`` this
    rank's torch device.  ``moved`` counts the bytes each collective moved
    on this rank, keyed ``"<op>/<axes>"``, and ``calls`` the calls."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device=None):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        size = math.prod(shape)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if size != world:
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs "
                             f"{size} ranks, the world has {world}")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.devices = np.arange(size).reshape(shape)
        self.size = size
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(
            self.rank, shape))))
        self.device = torch.device(device) if device is not None else \
            torch.device("cpu")
        self.backend = dist.get_backend() if dist.is_initialized() else None
        self.moved: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}
        self.scatter_route: Dict[str, str] = {}   # device type -> route
        self._groups = {}
        data = tuple(a for a in axis_names if a != "model")
        for axes in [(a,) for a in axis_names] + ([data] if len(data) > 1
                                                  else []):
            self._groups[axes] = self._new_groups(axes)
        # every axis: the whole world, in rank (= row-major) order
        self._groups.setdefault(axis_names, dist.group.WORLD
                                if size > 1 else None)

    def _new_groups(self, axes: Tuple[str, ...]):
        """Every rank builds every group of ``axes`` (``new_group`` is
        collective) and keeps the one it belongs to."""
        if self.size == 1:
            return None
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in idx]
        grid = np.transpose(self.devices, rest + idx).reshape(
            -1, math.prod(self.devices.shape[i] for i in idx))
        mine = None
        for ranks in grid:
            g = dist.new_group([int(r) for r in ranks])
            if self.rank in ranks:
                mine = g
        return mine

    # ------------------------------------------------------------ axes
    def axis_size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes)

    def axis_index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (``lax.axis_index``)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self._groups[axes]

    # ------------------------------------------------------------ collectives
    # The raw collectives (``_gather``, ``_reduce``, ``_scatter_sum``) move
    # bytes and count them in ``moved``; autograd does not see them.  The
    # public ones are what model code calls: each is an autograd
    # ``Function`` when its input requires grad, with the backward its
    # consumer needs (the module docstring of ``launch/sharding.py``).
    def _count(self, op: str, axes, nbytes: int):
        key = f"{op}/{','.join((axes,) if isinstance(axes, str) else axes)}"
        self.moved[key] = self.moved.get(key, 0) + nbytes
        self.calls[key] = self.calls.get(key, 0) + 1

    def _gather(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        n = self.axis_size(axes)
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(out, x, group=self.group(axes))
        self._count("all_gather", axes, x.nbytes * n)
        return torch.cat(out, dim=dim)

    def _reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        y = x.contiguous().clone()
        dist.all_reduce(y, group=self.group(axes))
        self._count("all_reduce", axes, y.nbytes)
        return y

    def _scatter_sum(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """This member's block along ``dim`` of the sum of every member's
        ``x`` (a reduce-scatter).  Where the backend has no reduce-scatter
        for the tensor's device (gloo on CUDA tensors may lack it) it is an
        all-reduce and a slice; rank 0 prints the route the first time."""
        n = self.axis_size(axes)
        x = x.movedim(dim, 0).contiguous()
        kind = x.device.type
        if self.scatter_route.get(kind) != "all_reduce":
            out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
            try:
                _REDUCE_SCATTER(out, x, group=self.group(axes))
            except (RuntimeError, NotImplementedError, ValueError) as e:
                self._route(kind, "all_reduce", f" ({e!r:.120})")
            else:
                self._route(kind, "reduce_scatter")
                self._count("reduce_scatter", axes, x.nbytes)
                return out.movedim(0, dim)
        y = self._reduce(x, axes)
        i, k = self.axis_index(axes), x.shape[0] // n
        return y[i * k:(i + 1) * k].movedim(0, dim)

    def _route(self, kind: str, route: str, why: str = ""):
        if kind not in self.scatter_route:
            self.scatter_route[kind] = route
            if self.rank == 0:
                print(f"distributed: reduce-scatter of {kind} tensors as "
                      f"{route}{why}", flush=True)

    def _local(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """This member's block along ``dim`` of a tensor whole on every
        member (no communication)."""
        k = x.shape[dim] // self.axis_size(axes)
        return x.narrow(dim, self.axis_index(axes) * k, k)

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0, *,
                   grad: str = "local"):
        """Concatenate every member's ``x`` along ``dim`` in the axes'
        row-major order (``lax.all_gather(..., tiled=True)``).  Its
        gradient: ``grad="sum"`` where the members compute different things
        on the whole (an FSDP weight gathered over the data axes: a
        reduce-scatter of the members' gradients), ``"local"`` where every
        member computes the same thing on it (this member's block of the
        gradient, no communication)."""
        if self.axis_size(axes) == 1:
            return x
        if _tracks(x):
            return _Gather.apply(x, self, axes, dim, grad)
        return self._gather(x, axes, dim)

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"):
        """Sum (or mean) of every member's ``x`` (``lax.psum`` / ``pmean``);
        returns a new tensor.  Its gradient is the identity (each member's
        part of a row-parallel sum, whose result every member then uses
        alike, gets the whole gradient of that result)."""
        n = self.axis_size(axes)
        if n == 1:
            return x
        y = _Sum.apply(x, self, axes) if _tracks(x) else self._reduce(x, axes)
        return y / n if op == "mean" else y

    def copy_to(self, x: torch.Tensor, axes):
        """``x`` itself, whose gradient is summed over ``axes``: the input
        of a computation split over the axes (a column-parallel projection
        over 'model', Megatron's *f*), where each member's gradient holds
        only its part."""
        if self.axis_size(axes) == 1 or not _tracks(x):
            return x
        return _Copy.apply(x, self, axes)

    def broadcast(self, x: torch.Tensor, src: int = 0):
        """Rank ``src``'s ``x`` on every rank of the mesh; returns a new
        tensor."""
        if self.size == 1:
            return x
        y = x.contiguous().clone()
        dist.broadcast(y, src, group=self.group(self.axis_names))
        self._count("broadcast", self.axis_names, y.nbytes)
        return y

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


# ``reduce_scatter_tensor`` under its newer name where torch has it
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _tracks(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Gather(torch.autograd.Function):
    """All-gather; the backward reduce-scatters (``grad="sum"``) or takes
    this member's block (``"local"``)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, grad):
        ctx.mesh, ctx.axes, ctx.dim, ctx.grad = mesh, axes, dim, grad
        return mesh._gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        g = m._scatter_sum(g, ctx.axes, ctx.dim) if ctx.grad == "sum" \
            else m._local(g, ctx.axes, ctx.dim)
        return g, None, None, None, None


class _Sum(torch.autograd.Function):
    """All-reduce sum; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh._reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    """Identity; all-reduce sum backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._reduce(g, ctx.axes), None, None


class ShapeMesh(Mesh):
    """The ``Mesh`` interface at one rank's coordinates of a mesh of any
    shape, with no process group: every collective returns a meta tensor
    of the shape the real one would give and counts in ``moved`` the
    bytes the real one would count.  Run on meta tensors, a step through
    it shows what one rank of that mesh computes, holds and moves — the
    port's stand-in for JAX's ``--xla_force_host_platform_device_count``
    (``launch/dryrun.py``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        self.devices = np.arange(self.size).reshape(shape)
        self.rank = int(rank)
        self.coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(
            self.rank, shape))))
        self.device = torch.device("meta")
        self.backend = None
        self.moved = {}
        self.calls = {}
        self._groups = {}

    def group(self, axes):
        return None

    def _gather(self, x, axes, dim):
        n = self.axis_size(axes)
        shape = list(x.shape)
        shape[dim] *= n
        self._count("all_gather", axes, x.nbytes * n)
        return x.new_empty(shape, device="meta")

    def _reduce(self, x, axes):
        self._count("all_reduce", axes, x.nbytes)
        return x.new_empty(x.shape, device="meta")

    def _scatter_sum(self, x, axes, dim):
        shape = list(x.shape)
        shape[dim] //= self.axis_size(axes)
        self._count("reduce_scatter", axes, x.nbytes)
        return x.new_empty(shape, device="meta")

    def broadcast(self, x, src: int = 0):
        if self.size > 1:
            self._count("broadcast", self.axis_names, x.nbytes)
        return x.new_empty(x.shape, device="meta")

    def __repr__(self):
        return f"ShapeMesh({self.shape}, rank={self.rank})"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device=None) -> Mesh:
    return Mesh(shape, axis_names, device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_shape_mesh(*, multi_pod: bool = False, rank: int = 0) -> ShapeMesh:
    """``make_production_mesh``'s shape and axes as a ``ShapeMesh`` at
    ``rank``'s coordinates: no process group, no card."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ShapeMesh(shape, axes, rank)


def make_host_mesh(data: int = 2, model: int = 2, device=None) -> Mesh:
    """Small (data, model) mesh: the CPU tests' (over gloo ranks) and the
    one-card chip phase's."""
    return make_mesh((data, model), ("data", "model"), device)


def _balanced_factor(rem: int, k: int) -> int:
    """Smallest divisor of ``rem`` >= rem**(1/k) — peeling these off from
    the TRAILING axis backward splits ``rem`` into k near-balanced factors
    with the larger shares on later axes (the 'model' axis sits last in
    serving specs, and tensor parallelism wants the bigger slice)."""
    if k <= 1:
        return rem
    t = rem ** (1.0 / k)
    for f in range(max(2, math.ceil(t)), rem + 1):
        if rem % f == 0:
            return f
    return rem


def parse_mesh_arg(spec: str, device=None) -> Mesh:
    """Mesh from a CLI axis spec over the WORLD's ranks.

    ``"data,model"`` sizes the axes automatically (near-balanced factors of
    the world size, larger factors trailing: 8 ranks -> (2, 4));
    ``"data=2,model=4"`` pins sizes explicitly (mixes allowed — pinned axes
    are honored, the rest split the remaining ranks)."""
    names, sizes = [], []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, size = part.partition("=")
        names.append(name)
        sizes.append(int(size) if size else 0)
    if not names:
        raise ValueError(f"empty mesh spec {spec!r}")
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate axis in mesh spec {spec!r}")
    ndev = dist.get_world_size() if dist.is_initialized() else 1
    fixed = math.prod(s for s in sizes if s)
    if fixed == 0 or ndev % fixed != 0:
        raise ValueError(f"mesh spec {spec!r} needs a divisor of the "
                         f"{ndev} ranks, got fixed product {fixed}")
    rem = ndev // fixed
    free = [i for i, s in enumerate(sizes) if s == 0]
    for j, i in enumerate(reversed(free)):
        f = _balanced_factor(rem, len(free) - j)
        sizes[i] = f
        rem //= f
    if rem != 1:
        raise ValueError(f"mesh spec {spec!r} does not use all {ndev} "
                         f"ranks (shape {tuple(sizes)})")
    return make_mesh(tuple(sizes), tuple(names), device)


def data_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a != "model")


def mesh_devices(mesh) -> int:
    n = 1
    for s in mesh.devices.shape:
        n *= s
    return n


# ---------------------------------------------------------------- spawning
def _rank_main(fn, rank, world_size, init_method, device, args, queue):
    import traceback
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        init_distributed(device, rank=rank, world_size=world_size,
                         init_method=init_method, local_rank=rank,
                         verbose=False)
        out = fn(rank, *args)
        queue.put((rank, True, out))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, *args, store: str, device: str = "cpu",
                timeout: float = 600.0):
    """Run ``fn(rank, *args)`` in ``world_size`` fresh processes joined in
    one process group (rendezvous through a ``FileStore`` at the path
    ``store``, which must not exist yet) and return their results in rank
    order — how tests and ``chip_smoke.py`` stand in for ``torchrun``.
    ``fn`` and its results must pickle.  A rank that raises re-raises here
    with its traceback; every process is stopped before this returns."""
    import multiprocessing
    import queue as queue_mod
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, f"file://{store}", device,
                               args, q), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world_size and not errors:
            try:
                rank, ok, out = q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    errors.append(f"ranks {dead} exited without a result "
                                  f"(exit codes "
                                  f"{[procs[r].exitcode for r in dead]})")
                elif time.monotonic() > deadline:
                    errors.append(f"ranks timed out after {timeout:.0f} s "
                                  f"(finished: {sorted(results)})")
                continue
            if ok:
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.1)
            if p.is_alive():
                p.terminate()
                p.join()
    if errors:
        raise RuntimeError("spawned ranks failed: " + "\n".join(errors))
    return [results[r] for r in range(world_size)]
