"""repro-lint rule R4 for the PyTorch port (the twin of the JAX package's
``analysis/protocol.py``): protocol conformance + scheduler purity.

Two halves:

* every class that DIRECTLY subclasses one of the serving protocols
  (``SequenceState`` / ``SpecOps`` / ``CollabPolicy``) must define the
  protocol's required-method surface with a compatible arity — the
  methods whose base implementation raises ``NotImplementedError``.
  (Indirect subclasses — e.g. ``RecurrentState(DenseKV)`` — inherit a
  real implementation and are out of static reach; the tier-1 parity
  tests cover them.)
* ``core/scheduler.py`` must contain ZERO knowledge of concrete KV
  layouts or model families: no ``isinstance`` against the concrete
  adapter/pool classes, no comparisons on ``.layout``/``.family``
  attributes, no ``getattr``/``hasattr`` probes for paged-pool
  internals.  This is the PR 3/5 invariant ("adding a layout or family
  never touches the scheduler"), made mechanical.

``PROTOCOL_SURFACES`` is a baked table (method -> exact positional
arity incl. ``self``) of the port's protocols; ``tests/test_torch_analysis.py``
pins it against the port's live protocol classes via ``inspect.signature``
so it cannot rot.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Tuple

from repro_torch.analysis.core import Finding, ModuleContext, rule

# protocol -> {required method -> positional arity including self}
PROTOCOL_SURFACES: Dict[str, Dict[str, int]] = {
    "SequenceState": {"admit": 4, "finalize": 3, "detached_len": 2},
    "CollabPolicy": {"decide": 4},
    "SpecOps": {"step": 4, "extend": 4, "snapshot": 2, "commit": 6},
}

# concrete layout/pool classes (and a mesh's local views of them) the
# scheduler must never name
CONCRETE_STATE_CLASSES = {"DenseKV", "PagedKV", "RecurrentState",
                          "BlockPool", "ShardedBlockPool", "LocalView",
                          "ShardView", "DenseView"}
# attribute probes that reach into paged-pool internals
LAYOUT_PROBE_ATTRS = {"pool", "table", "blocks", "block_size"}
SCHEDULER_SUFFIX = "core/scheduler.py"


@rule("R4", "protocol conformance: SequenceState/SpecOps/CollabPolicy "
            "subclasses define the required surface with matching arity; "
            "core/scheduler.py never branches on concrete layouts or "
            "families")
def check_protocols(ctx: ModuleContext) -> Iterable[Finding]:
    yield from _check_implementors(ctx)
    if ctx.relpath.endswith(SCHEDULER_SUFFIX):
        yield from _check_scheduler_purity(ctx)


def _check_implementors(ctx: ModuleContext) -> Iterable[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for base in node.bases:
            name = base.id if isinstance(base, ast.Name) else (
                base.attr if isinstance(base, ast.Attribute) else None)
            surface = PROTOCOL_SURFACES.get(name or "")
            if not surface:
                continue
            methods = {n.name: n for n in node.body
                       if isinstance(n, ast.FunctionDef)}
            for meth, arity in surface.items():
                impl = methods.get(meth)
                if impl is None:
                    yield Finding(
                        ctx.path, node.lineno, node.col_offset, "R4",
                        f"`{node.name}` subclasses `{name}` but does not "
                        f"define required method `{meth}` — the inherited "
                        "base raises NotImplementedError at runtime")
                    continue
                lo, hi = _arity_range(impl)
                if not (lo <= arity <= hi):
                    yield Finding(
                        ctx.path, impl.lineno, impl.col_offset, "R4",
                        f"`{node.name}.{meth}` accepts {lo}..{_fmt(hi)} "
                        f"positional args but the `{name}` protocol calls "
                        f"it with {arity}")


def _arity_range(fn: ast.FunctionDef) -> Tuple[int, float]:
    args = fn.args
    pos: List[ast.arg] = list(args.posonlyargs) + list(args.args)
    hi: float = float("inf") if args.vararg else len(pos)
    lo = len(pos) - len(args.defaults)
    return lo, hi


def _fmt(hi: float) -> str:
    return "*" if hi == float("inf") else str(int(hi))


def _check_scheduler_purity(ctx: ModuleContext) -> Iterable[Finding]:
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            fname = node.func.id if isinstance(node.func, ast.Name) else None
            if fname == "isinstance" and len(node.args) == 2:
                classes = (node.args[1].elts
                           if isinstance(node.args[1], ast.Tuple)
                           else [node.args[1]])
                for c in classes:
                    cname = c.id if isinstance(c, ast.Name) else (
                        c.attr if isinstance(c, ast.Attribute) else None)
                    if cname in CONCRETE_STATE_CLASSES:
                        yield Finding(
                            ctx.path, node.lineno, node.col_offset, "R4",
                            f"scheduler isinstance-checks concrete state "
                            f"class `{cname}` — route through the "
                            "SequenceState protocol instead")
            elif (fname in ("getattr", "hasattr") and len(node.args) >= 2
                    and isinstance(node.args[1], ast.Constant)
                    and node.args[1].value in LAYOUT_PROBE_ATTRS):
                yield Finding(
                    ctx.path, node.lineno, node.col_offset, "R4",
                    f"scheduler probes layout internals via "
                    f"`{fname}(..., {node.args[1].value!r})` — add the "
                    "query to the SequenceState protocol instead")
        elif isinstance(node, ast.Compare):
            for side in [node.left] + node.comparators:
                if (isinstance(side, ast.Attribute)
                        and side.attr in ("layout", "family")):
                    yield Finding(
                        ctx.path, node.lineno, node.col_offset, "R4",
                        f"scheduler compares `.{side.attr}` — layout/"
                        "family dispatch belongs behind SequenceState/"
                        "Lane, not in the scheduler")
