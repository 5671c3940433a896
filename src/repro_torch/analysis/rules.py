"""repro-lint rules R1-R3 for the PyTorch port (the twins of the JAX
package's ``analysis/rules.py``): hot-path purity, capture hazards, kernel
hygiene.  R4 (protocol conformance) lives in ``protocol.py``.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from repro_torch.analysis.core import (Finding, ModuleContext, _name_is,
                                       positional_params, rule)

# attributes of a tensor that are host metadata — branching on them reads
# no device value
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "requires_grad", "nbytes", "itemsize"}
# reductions whose result, wrapped in float()/int()/bool(), is a device
# scalar pulled to the host
REDUCTIONS = {"sum", "mean", "max", "min", "argmax", "argmin", "any", "all",
              "norm", "prod", "amax", "amin"}
# host -> device constructors: under capture they bake a host value into
# the graph as a constant
H2D_CTORS = {"tensor", "as_tensor", "from_numpy"}
# conversions that make a Python scalar at a call site
SCALAR_CALLS = {"int", "float", "bool", "len"}


# ------------------------------------------------------------------- R1
@rule("R1", "no host syncs on the hot path: `.item()`, `.tolist()`, "
            "`.cpu()`, `.numpy()`, `.to(\"cpu\")`, `synchronize()`, "
            "`np.asarray` on a tensor, `float()`/`int()`/`bool()` of a "
            "tensor, and `host_pull` (the one sanctioned pull per tick or "
            "wave, suppressed with a reason) inside @hot_path functions")
def check_host_sync(ctx: ModuleContext) -> Iterable[Finding]:
    if not ctx.hot_functions:
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not ctx.in_hot_function(node):
            continue
        msg = _host_sync_message(node)
        if msg:
            yield Finding(ctx.path, node.lineno, node.col_offset, "R1", msg)


def _is_cpu(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (isinstance(node, ast.Call) and _name_is(node.func, "device")
            and len(node.args) == 1 and _is_cpu(node.args[0]))


def _host_sync_message(call: ast.Call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        if fn.attr == "item" and not call.args:
            return "`.item()` forces a device->host sync"
        if fn.attr in ("tolist", "cpu", "numpy") and not call.args:
            return f"`.{fn.attr}()` copies a tensor to the host and syncs"
        if fn.attr == "to" and (any(_is_cpu(a) for a in call.args[:1])
                                or any(k.arg == "device" and _is_cpu(k.value)
                                       for k in call.keywords)):
            return "`.to(\"cpu\")` copies a tensor to the host and syncs"
        if fn.attr == "synchronize":
            return ("`synchronize()` stalls the host until the device (or "
                    "an event) catches up")
        if (fn.attr == "asarray" and isinstance(fn.value, ast.Name)
                and fn.value.id in ("np", "numpy")):
            return ("`np.asarray(...)` on a tensor is an implicit "
                    "device->host sync; batch it into one `host_pull` per "
                    "wave (use `np.array` for host-list conversions)")
        if fn.attr == "host_pull":
            return _HOST_PULL
    elif isinstance(fn, ast.Name):
        if fn.id == "host_pull":
            return _HOST_PULL
        if fn.id in ("float", "int", "bool") and len(call.args) == 1:
            arg = call.args[0]
            if isinstance(arg, ast.Call) and _host_sync_message(arg):
                return (f"`{fn.id}(...)` over a syncing call — double "
                        "host pull")
            if isinstance(arg, ast.Call) and isinstance(
                    arg.func, ast.Attribute) and arg.func.attr in REDUCTIONS:
                return (f"`{fn.id}(tensor.{arg.func.attr}())` pulls a "
                        "device scalar to the host")
    return None


_HOST_PULL = ("`host_pull` syncs host and device — allowed only as the "
              "single batched pull per tick or wave (suppress with a "
              "reason)")


# ------------------------------------------------------------------- R2
@rule("R2", "no capture hazards in captured code: Python branching, loops "
            "or f-strings on tensor params, host->device construction "
            "(`torch.tensor`/`as_tensor`/`from_numpy`), host syncs, and "
            "call sites passing a Python value that changes between calls "
            "outside the key (or an unhashable static arg)")
def check_capture_hazards(ctx: ModuleContext) -> Iterable[Finding]:
    for fn in ctx.capture_static:
        traced = ctx.traced_params(fn)
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            yield from _scan_captured_body(ctx, stmt, traced)
    yield from _check_call_sites(ctx)


def _scan_captured_body(ctx: ModuleContext, root: ast.AST,
                        traced: Set[str]) -> Iterable[Finding]:
    # nested defs and lambdas run under the capture too, so the walk
    # descends into them; shadowed names can in principle false-positive,
    # which is what the suppression markers are for
    for node in ast.walk(root):
        if isinstance(node, (ast.If, ast.While)):
            name = _traced_ref(node.test, traced)
            if name:
                kind = "if" if isinstance(node, ast.If) else "while"
                yield Finding(
                    ctx.path, node.lineno, node.col_offset, "R2",
                    f"Python `{kind}` on tensor param `{name}` reads its "
                    "value on the host (a sync) and freezes one branch "
                    "into the graph — use `torch.where` or make it static")
        elif isinstance(node, ast.IfExp):
            name = _traced_ref(node.test, traced)
            if name:
                yield Finding(
                    ctx.path, node.lineno, node.col_offset, "R2",
                    f"conditional expression on tensor param `{name}` "
                    "freezes one branch into the graph — use `torch.where`")
        elif isinstance(node, ast.JoinedStr):
            for val in node.values:
                if isinstance(val, ast.FormattedValue):
                    name = _traced_ref(val.value, traced)
                    if name:
                        yield Finding(
                            ctx.path, node.lineno, node.col_offset, "R2",
                            f"f-string formats tensor param `{name}` — "
                            "a host read of its value")
        elif isinstance(node, ast.For):
            name = _loop_over_traced(node.iter, traced)
            if name:
                yield Finding(
                    ctx.path, node.lineno, node.col_offset, "R2",
                    f"Python loop over tensor param `{name}` unrolls one "
                    "value into the graph — make the count static")
        elif isinstance(node, ast.Call):
            fn = node.func
            if (isinstance(fn, ast.Attribute) and fn.attr in H2D_CTORS
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id == "torch"):
                yield Finding(
                    ctx.path, node.lineno, node.col_offset, "R2",
                    f"`torch.{fn.attr}(...)` under capture copies a host "
                    "value into the graph as a constant — pass it in as a "
                    "tensor")
            else:
                msg = _host_sync_message(node)
                if msg:
                    yield Finding(ctx.path, node.lineno, node.col_offset,
                                  "R2", f"under capture: {msg}")


def _fn_name(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Name):
        return call.func.id
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


def _traced_ref(expr: ast.AST, traced: Set[str]) -> Optional[str]:
    """Name of a tensor param whose VALUE the expression depends on, or
    None.  References through host metadata (``x.shape``...), through
    ``len(x)``/``isinstance(x, ...)`` and identity tests (``x is None``)
    read no device value and are excluded."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return None
        if not isinstance(node, ast.Name) or node.id not in traced:
            continue
        parent = getattr(node, "_rl_parent", None)
        if (isinstance(parent, ast.Attribute) and parent.value is node
                and parent.attr in STATIC_ATTRS):
            continue
        if (isinstance(parent, ast.Call) and node in parent.args
                and isinstance(parent.func, ast.Name)
                and parent.func.id in ("len", "isinstance", "type")):
            continue
        return node.id
    return None


def _loop_over_traced(it: ast.AST, traced: Set[str]) -> Optional[str]:
    if isinstance(it, ast.Call) and _name_is(it.func, "range"):
        for arg in it.args:
            name = _traced_ref(arg, traced)
            if name:
                return name
        return None
    if isinstance(it, ast.Name) and it.id in traced:
        return it.id
    return None


_UNHASHABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
               ast.SetComp, ast.GeneratorExp)


def _python_scalar(expr: ast.AST, scope: Optional[ast.AST]) -> bool:
    """True when ``expr`` evidently makes a Python number: a numeric
    literal, ``int(...)``/``float(...)``/``bool(...)``/``len(...)``, a
    conditional with such a branch, or a name the enclosing function binds
    to one of those."""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, (int, float)) and expr.value is not None
    if isinstance(expr, ast.UnaryOp):
        return _python_scalar(expr.operand, scope)
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name):
        return expr.func.id in SCALAR_CALLS
    if isinstance(expr, ast.IfExp):
        return _python_scalar(expr.body, scope) or \
            _python_scalar(expr.orelse, scope)
    if isinstance(expr, ast.Name) and scope is not None:
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == expr.id
                    for t in node.targets):
                if _python_scalar(node.value, None):
                    return True
    return False


def _check_call_sites(ctx: ModuleContext) -> Iterable[Finding]:
    if not ctx.capture_aliases:
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _fn_name(node)
        target = ctx.capture_aliases.get(name)
        if target is None:
            continue
        statics = ctx.capture_static.get(target, set())
        params = positional_params(target)
        scope = next(ctx.enclosing_functions(node), None)
        bound = [(params[i] if i < len(params) else None, a)
                 for i, a in enumerate(node.args)]
        bound += [(kw.arg, kw.value) for kw in node.keywords]
        for pname, value in bound:
            if pname in statics:
                if isinstance(value, _UNHASHABLE):
                    yield Finding(
                        ctx.path, node.lineno, node.col_offset, "R2",
                        f"unhashable value for static arg `{pname}` of "
                        f"captured `{name}` — every call raises; pass a "
                        "tuple/scalar")
            elif pname is not None and _python_scalar(value, scope):
                yield Finding(
                    ctx.path, node.lineno, node.col_offset, "R2",
                    f"captured `{name}` gets a Python value for `{pname}`, "
                    "which is not in its key: the first call's value would "
                    "be baked into the graph — pass a device tensor (or "
                    "make the arg static)")


# ------------------------------------------------------------------- R3
@rule("R3", "kernel hygiene in `kernels/`: every public function that "
            "launches a `CudaKernel` has a plain PyTorch counterpart in its "
            "module, and no `try`/`except` wraps a launch (no fallback)")
def check_kernels(ctx: ModuleContext) -> Iterable[Finding]:
    if "kernels/" not in ctx.relpath or "CudaKernel" not in ctx.source:
        return
    kernels: Set[str] = set()
    for node in ctx.tree.body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and _name_is(node.value.func, "CudaKernel")):
            kernels |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    if not kernels:
        return
    defs: Dict[str, ast.FunctionDef] = {
        n.name: n for n in ctx.tree.body if isinstance(n, ast.FunctionDef)}
    launchers = {name for name, fn in defs.items()
                 if any(_launches(n, kernels) for n in ast.walk(fn))}
    for name in sorted(launchers):
        if name.startswith("_"):
            continue
        base = name
        for suffix in ("_cuda", "_kernel"):
            base = base.removesuffix(suffix)
        if f"{base}_plain" not in defs:
            fn = defs[name]
            yield Finding(ctx.path, fn.lineno, fn.col_offset, "R3",
                          f"kernel entry `{name}` has no plain PyTorch "
                          f"counterpart `{base}_plain` in its module")
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Try):
            continue
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if _launches(sub, kernels) or (
                        isinstance(sub, ast.Call)
                        and _fn_name(sub) in launchers):
                    yield Finding(
                        ctx.path, node.lineno, node.col_offset, "R3",
                        "`try` around a kernel launch: a kernel that fails "
                        "must raise, never fall back")
                    break
            else:
                continue
            break


def _launches(node: ast.AST, kernels: Set[str]) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
            and node.func.attr == "launch"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in kernels)
