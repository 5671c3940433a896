"""repro-lint core for the PyTorch port (the twin of the JAX package's
``analysis/core.py``): findings, suppressions, the rule registry, and the
file/tree walkers.

A rule is a callable ``(ModuleContext) -> Iterable[Finding]`` registered
under a stable id (``R1``..``R4``).  Suppression is per-line and
per-rule: a finding at line ``L`` is dropped when line ``L`` or line
``L - 1`` carries ``# repro-lint: ok(<rule>, <reason>)`` with a
non-empty reason.  A marker WITHOUT a reason never suppresses anything
and is itself reported (rule ``R0``), so every shipped suppression
documents why the construct is deliberate.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

from repro_torch.analysis.markers import HOT_PATH_MODULES

SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*ok\(\s*([A-Za-z0-9_]+)\s*(?:,\s*([^)]*?)\s*)?\)")
# a marker that LOOKS like a suppression but doesn't parse (wrong spelling,
# missing parens) — flagged so typos don't silently stop suppressing
SUPPRESS_LIKE_RE = re.compile(r"#\s*repro-lint\b")

PY_EXTENSIONS = (".py",)
SKIP_DIRS = {"__pycache__", ".git", ".ruff_cache", ".pytest_cache", "build"}


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ModuleContext:
    """Per-file analysis state shared by every rule: the parsed tree, raw
    lines, hot-path function set, and the capture registry (function ->
    static-arg names) rules R1/R2 consume: the functions handed to
    ``core/capture.py``'s ``capture``, the port's ``jax.jit``."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.relpath = Path(path).as_posix()
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self._attach_parents()
        self.suppressions: Dict[int, Set[str]] = {}
        self.bare_markers: List[int] = []
        self._scan_markers()
        self.hot_functions = self._find_hot_functions()
        self.capture_static: Dict[ast.AST, Set[str]] = {}
        self.capture_aliases: Dict[str, ast.AST] = {}
        self._find_captured()

    # ---------------------------------------------------------- structure
    def _attach_parents(self):
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._rl_parent = node

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return getattr(node, "_rl_parent", None)

    def enclosing_functions(self, node: ast.AST):
        cur = self.parent(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                yield cur
            cur = self.parent(cur)

    # --------------------------------------------------------- suppression
    def _scan_markers(self):
        # only COMMENT tokens count — docstrings that merely describe the
        # marker syntax are not markers
        try:
            tokens = tokenize.generate_tokens(
                io.StringIO(self.source).readline)
            comments = [(t.start[0], t.string) for t in tokens
                        if t.type == tokenize.COMMENT]
        except (tokenize.TokenError, IndentationError):
            comments = []
        for i, text in comments:
            if not SUPPRESS_LIKE_RE.search(text):
                continue
            matched = False
            for m in SUPPRESS_RE.finditer(text):
                matched = True
                rule, reason = m.group(1), (m.group(2) or "").strip()
                if reason:
                    self.suppressions.setdefault(i, set()).add(rule)
                else:
                    self.bare_markers.append(i)
            if not matched:
                self.bare_markers.append(i)

    def suppressed(self, line: int, rule: str) -> bool:
        for ln in (line, line - 1):
            if rule in self.suppressions.get(ln, ()):
                return True
        return False

    # ----------------------------------------------------------- hot paths
    def _find_hot_functions(self) -> Set[ast.AST]:
        allow: Set[str] = set()
        for suffix, names in HOT_PATH_MODULES.items():
            if self.relpath.endswith(suffix):
                allow |= set(names)
        hot: Set[ast.AST] = set()
        for node in ast.walk(self.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name in allow or any(
                    _name_is(d, "hot_path") for d in node.decorator_list):
                hot.add(node)
        # hot-ness extends into lexically nested functions
        grew = True
        while grew:
            grew = False
            for node in ast.walk(self.tree):
                if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and node not in hot
                        and any(f in hot
                                for f in self.enclosing_functions(node))):
                    hot.add(node)
                    grew = True
        return hot

    def in_hot_function(self, node: ast.AST) -> bool:
        return any(f in self.hot_functions
                   for f in self.enclosing_functions(node))

    # -------------------------------------------------------- capture info
    def _find_captured(self):
        """Map captured functions/lambdas to their static-arg name sets,
        and record the names/attrs the captured callables are bound to so
        R2 can check their call sites.

        Recognized forms: ``@capture`` decorators (bare or via
        ``functools.partial(capture, static_argnames=...)``), and ``X =
        capture(fn, ...)`` assignments where ``fn`` is a lambda, a
        function of the module by name, or ``self.<method>`` (a method of
        the module by name), and the target a plain name or
        ``self.<attr>``.
        """
        defs_by_name: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs_by_name.setdefault(node.name, []).append(node)

        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    statics = _capture_statics_from(dec, node)
                    if statics is not None:
                        self.capture_static[node] = statics
            elif isinstance(node, ast.Assign):
                call = node.value
                if not (isinstance(call, ast.Call)
                        and _name_is(call.func, "capture") and call.args):
                    continue
                fn_arg = call.args[0]
                target_fn: Optional[ast.AST] = None
                if isinstance(fn_arg, ast.Lambda):
                    target_fn = fn_arg
                elif isinstance(fn_arg, (ast.Name, ast.Attribute)):
                    name = fn_arg.id if isinstance(fn_arg, ast.Name) \
                        else fn_arg.attr
                    cands = defs_by_name.get(name, [])
                    if len(cands) == 1:
                        target_fn = cands[0]
                if target_fn is None:
                    continue
                self.capture_static[target_fn] = _static_names(call,
                                                               target_fn)
                for tgt in node.targets:
                    name = None
                    if isinstance(tgt, ast.Name):
                        name = tgt.id
                    elif isinstance(tgt, ast.Attribute):
                        name = tgt.attr
                    if name:
                        self.capture_aliases[name] = target_fn

    def traced_params(self, fn: ast.AST) -> Set[str]:
        """Param names of a registered captured function that are traced
        (everything positional except ``self`` and the static args)."""
        statics = self.capture_static.get(fn)
        if statics is None:
            return set()
        return set(positional_params(fn)) - statics


def positional_params(fn: ast.AST) -> List[str]:
    """A function's positional parameter names, without ``self``."""
    args = fn.args
    return [a.arg for a in args.posonlyargs + args.args if a.arg != "self"]


def _name_is(node: ast.AST, name: str) -> bool:
    """True when ``node`` is ``name``, ``x.name``, or a
    ``functools.partial(x.name, ...)`` wrapper of either."""
    if isinstance(node, ast.Name):
        return node.id == name
    if isinstance(node, ast.Attribute):
        return node.attr == name
    if (isinstance(node, ast.Call) and _name_is(node.func, "partial")
            and node.args):
        return _name_is(node.args[0], name)
    return False


def _capture_statics_from(dec: ast.AST, fn: ast.AST) -> Optional[Set[str]]:
    """Static-arg names when ``dec`` is a capture decorator, else None."""
    if isinstance(dec, (ast.Name, ast.Attribute)) and _name_is(dec,
                                                               "capture"):
        return set()
    if isinstance(dec, ast.Call):
        if _name_is(dec.func, "capture"):
            return _static_names(dec, fn)
        if (_name_is(dec.func, "partial") and dec.args
                and _name_is(dec.args[0], "capture")):
            return _static_names(dec, fn)
    return None


def _static_names(call: ast.Call, fn: ast.AST) -> Set[str]:
    statics: Set[str] = set()
    pos_names = ([a.arg for a in fn.args.posonlyargs + fn.args.args]
                 if hasattr(fn, "args") else [])
    for kw in call.keywords:
        vals: Sequence[ast.AST]
        if isinstance(kw.value, (ast.Tuple, ast.List)):
            vals = kw.value.elts
        else:
            vals = [kw.value]
        if kw.arg == "static_argnames":
            statics |= {v.value for v in vals
                        if isinstance(v, ast.Constant)
                        and isinstance(v.value, str)}
        elif kw.arg == "static_argnums":
            for v in vals:
                if (isinstance(v, ast.Constant) and isinstance(v.value, int)
                        and 0 <= v.value < len(pos_names)):
                    statics.add(pos_names[v.value])
    return statics


# ---------------------------------------------------------------- registry
Rule = Callable[[ModuleContext], Iterable[Finding]]
RULES: Dict[str, Rule] = {}
RULE_DOCS: Dict[str, str] = {}


def rule(rule_id: str, doc: str):
    def register(fn: Rule) -> Rule:
        RULES[rule_id] = fn
        RULE_DOCS[rule_id] = doc
        return fn
    return register


@rule("R0", "suppression hygiene: every `# repro-lint: ok(...)` marker "
            "must name a rule and carry a non-empty reason")
def check_markers(ctx: ModuleContext) -> Iterable[Finding]:
    for line in ctx.bare_markers:
        yield Finding(ctx.path, line, 0, "R0",
                      "repro-lint marker without `ok(<rule>, <reason>)` — "
                      "a reasonless marker suppresses nothing")


# ---------------------------------------------------------------- analysis
def analyze_source(path: str, source: str,
                   rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the selected rules (default: all) over one file's source."""
    try:
        ctx = ModuleContext(path, source)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, e.offset or 0, "E0",
                        f"syntax error: {e.msg}")]
    selected = list(RULES) if rules is None else list(rules)
    out: List[Finding] = []
    for rid in selected:
        if rid not in RULES:
            raise KeyError(f"unknown rule {rid!r}; known: {sorted(RULES)}")
        for f in RULES[rid](ctx):
            if not ctx.suppressed(f.line, f.rule):
                out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def analyze_file(path, rules: Optional[Sequence[str]] = None) -> List[Finding]:
    p = Path(path)
    return analyze_source(str(p), p.read_text(), rules)


def iter_python_files(paths: Sequence) -> List[Path]:
    files: List[Path] = []
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            files.extend(
                f for f in sorted(p.rglob("*.py"))
                if not (set(f.parts) & SKIP_DIRS))
        elif p.suffix in PY_EXTENSIONS:
            files.append(p)
    return files


def analyze_paths(paths: Sequence,
                  rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Analyze every ``.py`` under ``paths`` (files or directories)."""
    out: List[Finding] = []
    for f in iter_python_files(paths):
        out.extend(analyze_file(f, rules))
    return out
