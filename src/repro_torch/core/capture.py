"""CUDA-graph capture of a function's device work: the port's twin of
``jax.jit(fn, static_argnames=...)``.

``capture(fn, static_argnames=..., copy_argnames=...)`` wraps ``fn`` as
JAX's jit wraps it.  A call is keyed, as JAX keys its compile cache, by

* the values of the static arguments;
* the shape, dtype and device of each ``copy_argnames`` argument: the
  small tensors whose VALUES change from call to call (tokens, budgets,
  ``pos``), which every call copies into the graph's own buffers;
* the shape, strides, dtype, device and ``data_ptr`` of every tensor of
  the other arguments (parameters, K/V pools, block tables): the graph
  reads and writes them where they lie, so it holds only for the buffers
  it was captured on.  JAX recompiles on a new shape and never on a new
  buffer; a graph is tied to addresses, which is why the scheduler reuses
  its states' buffers (``Lane.make_state``, ``Lane.release``) and why a
  recurrent state's steps write their new leaves back into the state's
  own tensors (``SpecOps``).

The first call of a key is its warm-up: ``fn`` runs once on a side
stream on the caller's buffers (kernel libraries built and loaded, lazy
caches filled), and that run is the call's result, its state writes and
random draws those of an eager call.  Then ``fn`` is captured there
(``CUDAGraph.capture_begin`` / ``capture_end``; nothing runs, so a state
updated in place — a recurrent step reads the leaves it overwrites — is
advanced once, not twice) and every listener
(``analysis/compile_guard.py`` ``CaptureCounter``) told one event naming
the function and its key.  Every later call copies the small inputs in,
replays the graph and clones the outputs that escape; an output that IS
an addressed input comes back as the caller's tensor.  Each random
generator handed in is registered with the graph
(``CUDAGraph.register_generator_state``), so a replay draws from where
the calls before it left the generator, as an eager call would.

``fn`` must treat its copied inputs as read-only, take every value that
changes between calls as a tensor or a static argument (a Python number in
a traced argument raises: it would be baked into the graph), and do no
host work that depends on device values (a sync raises under capture).

A capture that fails raises ``CaptureError``: nothing runs ``fn`` eagerly
in its place.  A call whose tensors lie on the CPU runs ``fn`` eagerly,
because the CPU has no graphs and it is the device the caller chose.

Launch counts (``kernels/ops.py``): the warm-up counts as the first
call's launches; the capture runs nothing, so its launches are taken back,
and every replay adds them again.  ``ops.launch_counts()`` then counts what
the calls launched, as many as eager calls would.

Memory.  Every graph on a device allocates in ONE memory pool
(``torch.cuda.graph_pool_handle``), not a private pool each: a replay's
temporaries are dead once it ends, since every output that escapes is
cloned at once and replays run one at a time on the caller's stream, so
the graphs share them.  A private pool keeps its capture's peak of
temporaries reserved for good: 0.12-0.95 GB a graph at full width (one
H100, ``chip_smoke.py``'s ``[graphs] pool`` lines).  What a graph keeps
allocated in the pool is its static outputs.  The pool stays open for the
process (``pool``: an anchor graph holds it); a failed capture leaves it
marked as being recorded into, so the next capture opens a new one.

Bounds.  A ``Captured`` keeps at most ``MAX_GRAPHS`` graphs, the least
recently called dropped first, once the capture that overflows the bound
has ended (never while a capture is in flight: destroying a graph mid-
capture invalidates the capture).  ``evict(tensors)`` drops, in every
live ``Captured`` of the process, each graph whose key addresses one of
those tensors' storages: the lanes call it when they drop a released
state's buffers (``Lane.release``), so no graph outlives the buffers it
reads.  A dropped graph holds nothing: its static inputs and outputs go
with it, back to the pool for the next capture.
"""
from __future__ import annotations

import gc
import inspect
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops

_LISTENERS: List[Callable[[str], None]] = []
_SIDE: Dict[torch.device, torch.cuda.Stream] = {}
# per device: the shared pool's handle, its anchor graph and its tensor
_POOLS: Dict[torch.device, tuple] = {}
# graphs kept per captured function.  A drain of one shape calls each
# function on a handful of keys (the tick's pow2 step counts on the edge's
# and each escalation group's state, a prefill per token bucket, an extend
# per chunk bucket and detached cache): 32 holds them all, so a repeated
# drain replays without a capture, while drains of ever new lengths keep
# at most 32 graphs, and the outputs they hold in the pool, per function
MAX_GRAPHS = 32
# every live Captured, for ``evict``
_LIVE: "weakref.WeakSet[Captured]" = weakref.WeakSet()


class CaptureError(RuntimeError):
    """A CUDA-graph capture failed; the call ran nothing in its place."""


def add_listener(fn: Callable[[str], None]) -> None:
    """Call ``fn(event)`` on every capture from now on."""
    _LISTENERS.append(fn)


def remove_listener(fn: Callable[[str], None]) -> None:
    _LISTENERS.remove(fn)


def capture(fn, *, static_argnames: Sequence[str] = (),
            copy_argnames: Sequence[str] = (),
            name: Optional[str] = None) -> "Captured":
    """``fn`` captured once per key and replayed (see the module
    docstring)."""
    return Captured(fn, static_argnames=static_argnames,
                    copy_argnames=copy_argnames, name=name)


def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    s = _SIDE.get(dev)
    if s is None:
        s = _SIDE[dev] = torch.cuda.Stream(dev)
    return s


def pool(dev: torch.device) -> tuple:
    """The memory pool every graph on ``dev`` allocates in.  The allocator
    lets a shared pool go, and refuses its handle from then on, once the
    last graph captured into it is gone (as when every engine of a process
    has been dropped), so a one-kernel anchor graph, captured into the
    pool first and never dropped, holds it open."""
    p = _POOLS.get(dev)
    if p is None:
        handle = torch.cuda.graph_pool_handle()
        anchor, x = torch.cuda.CUDAGraph(), torch.zeros(1, device=dev)
        side = _side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            anchor.capture_begin(pool=handle)
            x.add_(0)
            anchor.capture_end()
        p = _POOLS[dev] = (handle, anchor, x)
    return p[0]


def _meta(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)


def _storage(t: torch.Tensor) -> int:
    """The address of the storage ``t`` views (shared by all its views)."""
    return t.untyped_storage().data_ptr()


def evict(tensors) -> int:
    """Drop, in every live ``Captured``, each graph whose key addresses the
    storage of one of ``tensors``; returns how many went.  Called with a
    released state's buffers before they are freed, never under a
    capture."""
    storages = {_storage(t) for t in tensors}
    return sum(c.drop(storages) for c in list(_LIVE)) if storages else 0


class _Walk:
    """The tensors, generators and constants of the addressed arguments,
    and the part of the key they make."""

    def __init__(self):
        self.tensors: List[torch.Tensor] = []
        self.gens: List[torch.Generator] = []
        self.key: List[Any] = []

    def add(self, name: str, x) -> None:
        if isinstance(x, torch.Tensor):
            self.tensors.append(x)
            self.key.append(_meta(x))
        elif isinstance(x, nn.Module):
            self.key.append(type(x).__name__)
            for t in x.parameters():
                self.add(name, t)
            for t in x.buffers():
                self.add(name, t)
        elif isinstance(x, dict):
            self.key.append(tuple(x))
            for v in x.values():
                self.add(name, v)
        elif isinstance(x, (list, tuple)):
            self.key.append(len(x))
            for v in x:
                self.add(name, v)
        elif isinstance(x, torch.Generator):
            self.gens.append(x)
            self.key.append(("generator", id(x)))
        elif x is None or isinstance(x, str):
            self.key.append(x)
        else:
            raise TypeError(
                f"argument {name!r} holds a {type(x).__name__}: a captured "
                "function takes tensors, generators, containers of them, "
                "None and strings in its traced arguments (a Python number "
                "would be baked into the graph: make it a tensor or a "
                "static argument)")


class _Graph:
    """One captured key: the graph, its input buffers, how to build the
    call's outputs, the kernel launches one replay makes, the generators
    it draws from (held, so their ids stay theirs), and the storages of
    the tensors it addresses (``evict``)."""

    __slots__ = ("graph", "static_in", "plan", "rebuild", "launches", "gens",
                 "storages")


def _flatten_out(x, leaves: list):
    """The output tree's tensors in order, and a function rebuilding the
    tree from a list of tensors in that order."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return lambda it: next(it)
    if isinstance(x, dict):
        parts = [(k, _flatten_out(v, leaves)) for k, v in x.items()]
        return lambda it: {k: f(it) for k, f in parts}
    if isinstance(x, (list, tuple)):
        parts = [_flatten_out(v, leaves) for v in x]
        kind = type(x)
        if hasattr(x, "_fields"):           # a named tuple (``GLAState``)
            return lambda it: kind(*(f(it) for f in parts))
        return lambda it: kind(f(it) for f in parts)
    return lambda it: x          # a constant of the capture (None, ints)


class Captured:
    """A function captured per key into CUDA graphs (see the module
    docstring).  ``captures`` counts this function's captures,
    ``capture_seconds`` sums their host wall time (warm-up included),
    ``live_graphs`` is the number of graphs held (at most ``MAX_GRAPHS``)
    and ``dropped`` counts the graphs let go (bound or ``evict``)."""

    def __init__(self, fn, *, static_argnames: Sequence[str] = (),
                 copy_argnames: Sequence[str] = (),
                 name: Optional[str] = None):
        self.fn = fn
        self.name = name or getattr(fn, "__qualname__", repr(fn))
        self._sig = inspect.signature(fn)
        for n in (*static_argnames, *copy_argnames):
            if n not in self._sig.parameters:
                raise ValueError(f"{self.name} has no argument {n!r}")
        self.static_argnames = frozenset(static_argnames)
        self.copy_argnames = frozenset(copy_argnames)
        self._graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self.captures = 0
        self.capture_seconds = 0.0
        self.dropped = 0
        _LIVE.add(self)

    @property
    def live_graphs(self) -> int:
        return len(self._graphs)

    def _lookup(self, key: tuple):
        """The graph of ``key`` (now the most recently used), or None."""
        g = self._graphs.get(key)
        if g is not None:
            self._graphs.move_to_end(key)
        return g

    def _keep(self, key: tuple, g) -> None:
        """File a new graph as the most recently used; past ``MAX_GRAPHS``
        the least recently used go (the capture has ended)."""
        self._graphs[key] = g
        while len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
            self.dropped += 1

    def drop(self, storages) -> int:
        """Drop every graph addressing one of ``storages`` (addresses, as
        ``_storage`` gives them); returns how many went."""
        gone = [k for k, g in self._graphs.items()
                if not storages.isdisjoint(g.storages)]
        for k in gone:
            del self._graphs[k]
        self.dropped += len(gone)
        return len(gone)

    def __call__(self, *args, **kwargs):
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        arg = bound.arguments
        key: List[Any] = []
        copied: List[Tuple[str, torch.Tensor]] = []
        walk = _Walk()
        for name, val in arg.items():
            if name in self.static_argnames:
                key.append((name, val))
            elif name in self.copy_argnames:
                if not isinstance(val, torch.Tensor):
                    raise TypeError(f"{self.name}: copied argument {name!r} "
                                    f"must be a tensor, got "
                                    f"{type(val).__name__}")
                copied.append((name, val))
                key.append((name, tuple(val.shape), val.dtype, val.device))
            else:
                walk.add(name, val)
        devs = {t.device for _, t in copied} | \
            {t.device for t in walk.tensors}
        if len(devs) != 1:
            raise ValueError(f"{self.name}: tensors on "
                             f"{sorted(map(str, devs))} (a call takes one "
                             "device)")
        dev = devs.pop()
        if dev.type != "cuda":
            return self.fn(*args, **kwargs)
        key = (tuple(key), tuple(walk.key))
        g = self._lookup(key)
        if g is None:           # the warm-up is this call; later calls replay
            g, out = self._capture(arg, copied, walk, dev)
            self._keep(key, g)
            return out
        for buf, (_, src) in zip(g.static_in, copied):
            buf.copy_(src)
        g.graph.replay()
        if g.launches:
            ops.add_launch_counts(g.launches)
        return g.rebuild(iter([walk.tensors[p] if isinstance(p, int)
                               else p.clone() for p in g.plan]))

    def _describe(self, arg, copied) -> str:
        parts = [f"{n}={arg[n]!r}" for n in arg if n in self.static_argnames]
        parts += [f"{n}={tuple(t.shape)}" for n, t in copied]
        return f"{self.name}[{', '.join(parts)}]"

    def _capture(self, arg, copied, walk: _Walk, dev):
        """The warm-up (the call's own run) and the capture of a new key:
        (the graph, the warm-up's outputs)."""
        what = self._describe(arg, copied)
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(dev)
        side = _side_stream(dev)
        began = False
        try:
            # warm-up: libraries built and loaded, lazy caches filled, on
            # the stream the capture will use
            side.wait_stream(main)
            with torch.cuda.stream(side):
                first = self.fn(**arg)
            main.wait_stream(side)
            ret: List[torch.Tensor] = []
            _flatten_out(first, ret)
            for t in ret:       # made on the side stream, used on the main
                t.record_stream(main)
            g = _Graph()
            g.static_in = [t.clone() for _, t in copied]
            call = dict(arg)
            for buf, (name, _) in zip(g.static_in, copied):
                call[name] = buf
            g.graph = torch.cuda.CUDAGraph()
            for gen in walk.gens:
                g.graph.register_generator_state(gen)
            g.gens = list(walk.gens)
            before = ops.launch_counts()
            # capture_begin / capture_end on the side stream: what
            # ``torch.cuda.graph`` does, without its device synchronize and
            # allocator cache flush, which would cost every later
            # allocation a fresh cudaMalloc.  The cyclic garbage collector
            # is held off meanwhile (``torch.cuda.graph`` collects before
            # it captures): a collection freeing an unreachable engine's
            # graphs would destroy them and free their memory pools, which
            # invalidates the capture in flight
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.stream(side):
                    shared = pool(dev)
                    began = True
                    g.graph.capture_begin(pool=shared)
                    try:
                        out = self.fn(**call)
                    finally:
                        g.graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
                after = ops.launch_counts()
                g.launches = {k: n - before[k] for k, n in after.items()
                              if n != before[k]}
                ops.add_launch_counts({k: -n for k, n in g.launches.items()})
        except Exception as e:
            if began:   # the allocator still deems the pool recorded
                _POOLS.pop(dev, None)   # into: the next capture opens one
            raise CaptureError(f"capture of {what} failed: "
                               f"{type(e).__name__}: {e}") from e
        leaves: List[torch.Tensor] = []
        g.rebuild = _flatten_out(out, leaves)
        where = {_meta(t): i for i, t in enumerate(walk.tensors)}
        g.plan = [where.get(_meta(t), t) for t in leaves]
        g.storages = frozenset(_storage(t) for t in walk.tensors)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        for fn in list(_LISTENERS):
            fn(what)
        return g, first
