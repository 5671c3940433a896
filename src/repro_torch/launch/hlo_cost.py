"""Cost of one step of the port, counted as it runs: the twin of the JAX
package's ``launch/hlo_cost.py::analyze_hlo``, which reads the same three
roofline inputs off a compiled step's HLO.

    cost = cost_of(step, params, opt_state, batch, mesh=mesh)

returns JAX's keys:

* ``flops`` — ``torch.utils.flop_counter.FlopCounterMode``: 2 * M * N * K
  per matrix product (``mm``, ``bmm``, ``addmm``, attention; elementwise
  flops ignored, as ``analyze_hlo`` ignores them).  The port runs its
  layers in a Python loop, so every layer counts, as ``analyze_hlo``'s
  trip counts make XLA's ``while`` bodies count; unsharded, the two agree
  exactly (``tests/test_torch_mesh_training.py``).  A hand-written CUDA
  kernel (flash attention on the card) is invisible to the counter: count
  on the CPU or the meta device, where attention runs its plain version.
* ``bytes`` — operand + result bytes of every dispatched operator that is
  not a view (a ``TorchDispatchMode``).  Eager operators are unfused, so
  this is an upper bound on memory traffic and is not comparable with
  XLA's, whose fusions keep their internals out of HBM.
* ``collective_bytes`` and ``coll_<op>`` under JAX's op names
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ...) — the bytes
  the mesh's collectives counted in ``Mesh.moved`` during the call; a
  port collective with no JAX name keeps its own (``coll_broadcast``).

``measure`` also returns the call's result, the collective calls per op
(``Mesh.calls``) and ``saved_bytes``: the distinct tensors autograd saved
during the call, parameters excluded — for a train step, what its forward
keeps for the backward (under remat the checkpointed blocks' inputs).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_JAX_NAME = {"all_gather": "all-gather", "all_reduce": "all-reduce",
             "reduce_scatter": "reduce-scatter"}


class _Bytes(TorchDispatchMode):
    """Operand + result bytes of every non-view operator dispatched."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            self.bytes += sum(t.nbytes for t in tree_leaves((args, kwargs,
                                                             out))
                              if isinstance(t, torch.Tensor))
        return out


class _Saved:
    """Bytes of the distinct tensors autograd saves while active,
    parameters (leaves that require grad) excluded."""

    def __init__(self):
        self.seen: Dict[int, int] = {}

    def pack(self, t):
        if not (t.is_leaf and t.requires_grad):
            self.seen.setdefault(id(t), t.nbytes)
        return t

    @property
    def bytes(self) -> int:
        return sum(self.seen.values())


def collective_costs(moved: Dict[str, int]) -> Dict[str, float]:
    """``Mesh.moved`` (``"<op>/<axes>"`` -> bytes) under JAX's keys."""
    coll = {c: 0.0 for c in COLLECTIVES}
    for key, n in moved.items():
        op = key.split("/")[0]
        name = _JAX_NAME.get(op, op)
        coll[name] = coll.get(name, 0.0) + n
    out = {"collective_bytes": float(sum(coll.values()))}
    out.update({f"coll_{k}": float(v) for k, v in coll.items()})
    return out


def _diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def measure(fn, *args, mesh=None, **kwargs) -> Tuple[Dict, object]:
    """(cost, ``fn(*args, **kwargs)``): the cost as ``cost_of`` gives it,
    plus ``moved`` and ``calls`` (this call's collective bytes and calls
    per ``"<op>/<axes>"``) and ``saved_bytes`` (module docstring)."""
    moved0 = dict(getattr(mesh, "moved", {}))
    calls0 = dict(getattr(mesh, "calls", {}))
    flops = FlopCounterMode(display=False)
    saved = _Saved()
    with flops, _Bytes() as counted, \
            torch.autograd.graph.saved_tensors_hooks(saved.pack,
                                                     lambda t: t):
        out = fn(*args, **kwargs)
    moved = _diff(getattr(mesh, "moved", {}), moved0)
    cost = {"flops": float(flops.get_total_flops()),
            "bytes": float(counted.bytes)}
    cost.update(collective_costs(moved))
    cost.update(moved=moved, calls=_diff(getattr(mesh, "calls", {}), calls0),
                saved_bytes=saved.bytes)
    return cost, out


def cost_of(fn, *args, mesh=None, **kwargs) -> Dict[str, float]:
    """``flops``, ``bytes``, ``collective_bytes`` and ``coll_<op>`` of one
    call of ``fn`` (module docstring); ``mesh``: the mesh whose
    collectives the call runs, if any."""
    cost, _ = measure(fn, *args, mesh=mesh, **kwargs)
    return {k: v for k, v in cost.items()
            if k not in ("moved", "calls", "saved_bytes")}
