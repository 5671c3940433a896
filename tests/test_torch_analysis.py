"""The port's repro-lint (``src/repro_torch/analysis``) — rule fixtures,
suppression semantics, the CLI (``python -m repro_torch.analysis``), and
the real-tree gate over ``src/repro_torch``, ``examples/torch_port`` and
``chip_smoke.py``.

Each rule gets a positive and a negative fixture driven through
``analyze_source``; the suppression tests pin that a marker WITHOUT a
reason suppresses nothing, and the strip test pins that the port
scheduler's shipped suppressions (its ``host_pull``s) hold back real
findings.  The baked protocol arities are held against the port's live
classes, and the plain counterpart R3 asks of the flash backward against
``jax.vjp`` of the JAX package's attention oracle.
"""
import inspect
import json
import re
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch.analysis import (RULE_DOCS, RULES, analyze_file,
                                  analyze_paths, analyze_source)
from repro_torch.analysis.__main__ import main as lint_main
from repro_torch.analysis.protocol import PROTOCOL_SURFACES

REPO = Path(__file__).resolve().parents[1]


def _lint(source, path="mod.py", rules=None):
    return analyze_source(path, textwrap.dedent(source), rules)


def _rules(findings):
    return [f.rule for f in findings]


# ------------------------------------------------------------------- R1
HOT_ITEM = """
    from repro_torch.analysis import hot_path

    @hot_path
    def tick(x):
        return x.item()
"""


def test_r1_item_in_hot_function():
    (f,) = _lint(HOT_ITEM)
    assert f.rule == "R1" and ".item()" in f.message and f.line == 6


def test_r1_cold_function_not_flagged():
    assert _lint("def tick(x):\n    return x.cpu().tolist()\n") == []


@pytest.mark.parametrize("expr,word", [
    ("x.tolist()", "tolist"), ("x.cpu()", "cpu"), ("x.numpy()", "numpy"),
    ("x.to('cpu')", "cpu"), ("x.to(device=torch.device('cpu'))", "cpu"),
    ("torch.cuda.synchronize()", "synchronize"),
    ("ev.synchronize()", "synchronize"), ("np.asarray(x)", "asarray"),
    ("float(x.sum())", "device scalar"), ("int(x.argmax())", "device scalar"),
    ("bool(x.any())", "device scalar"), ("host_pull(x, y)", "host_pull")])
def test_r1_host_syncs(expr, word):
    src = f"""
        @hot_path
        def tick(x, y, ev):
            return {expr}
    """
    (f,) = _lint(src)
    assert f.rule == "R1" and word in f.message


def test_r1_device_moves_and_host_reads_are_clean():
    # moving to the device, numpy host arrays, and int() over indexing of
    # the host mirrors are legal on the hot path
    src = """
        @hot_path
        def tick(steps_h, b, x):
            y = x.to("cuda")
            z = np.array([1, 2])
            return int(steps_h[b]), y, z, x.to(torch.int32)
    """
    assert _lint(src) == []


def test_r1_nested_hotness():
    src = """
        @hot_path
        def outer(v):
            def inner(u):
                return float(u.max())
            return inner(v)
    """
    (f,) = _lint(src)
    assert f.rule == "R1" and "device scalar" in f.message


# ---------------------------------------------------------- suppression
def test_suppression_same_line_and_line_above():
    src = """
        @hot_path
        def tick(v):
            a = host_pull(v)  # repro-lint: ok(R1, the one batched pull)
            # repro-lint: ok(R1, second batched pull for the group path)
            b = host_pull(v)
            return a, b
    """
    assert _lint(src) == []


def test_reasonless_marker_suppresses_nothing_and_is_flagged():
    src = """
        @hot_path
        def tick(v):
            return host_pull(v)  # repro-lint: ok(R1)
    """
    assert sorted(_rules(_lint(src))) == ["R0", "R1"]


def test_wrong_rule_suppression_does_not_apply():
    src = """
        @hot_path
        def tick(v):
            return host_pull(v)  # repro-lint: ok(R2, wrong rule id)
    """
    assert _rules(_lint(src)) == ["R1"]


def test_malformed_marker_flagged():
    (f,) = _lint("x = 1  # repro-lint: okay(R1, typo)\n")
    assert f.rule == "R0"


def test_docstring_mentioning_marker_is_not_a_marker():
    src = '''
        def doc():
            """Suppress with `# repro-lint: ok(R1)` — reasonless example."""
            return 1
    '''
    assert _lint(src) == []


# ------------------------------------------------------------------- R2
def test_r2_branch_on_a_tensor_param():
    src = """
        def body(x):
            if x > 0:
                return x
            return -x

        run = capture(body)
    """
    (f,) = _lint(src)
    assert f.rule == "R2" and "`if` on tensor param `x`" in f.message


def test_r2_statics_and_metadata_are_clean():
    src = """
        class Lane:
            def __init__(self):
                self._graph = capture(self._body, static_argnames=("n",),
                                      copy_argnames=("x",))

            def _body(self, x, n):
                if x.shape[0] > 2 and x.dtype == torch.float32:
                    pass
                if n > 0:
                    pass
                if x is None:
                    pass
                for _ in range(n):
                    x = x + 1
                return torch.where(x > 0, x, -x)
    """
    assert _lint(src) == []


def test_r2_host_to_device_syncs_fstrings_and_loops():
    src = """
        @capture
        def body(x, n):
            c = torch.tensor([1.0, 2.0], device=x.device)
            s = f"value={x}"
            k = x.sum().item()
            for i in range(n):
                x = x + i
            return x * c, s, k
    """
    findings = _lint(src)
    assert _rules(findings) == ["R2"] * 4
    msgs = " | ".join(f.message for f in findings)
    assert "torch.tensor" in msgs and "f-string" in msgs
    assert ".item()" in msgs and "loop over tensor param `n`" in msgs


def test_r2_python_value_at_a_call_site():
    src = """
        class Lane:
            def __init__(self):
                self._graph = capture(self._body, static_argnames=("n",))

            def _body(self, x, stop, n):
                return torch.where(x == stop, 0, x)

            def drive(self, x, token):
                a = self._graph(x, -1, n=4)
                stop = -1 if token is None else int(token)
                b = self._graph(x, stop, n=4)
                c = self._graph(x, stop=len(token), n=[4])
                return a, b, c
    """
    findings = _lint(src)
    assert _rules(findings) == ["R2"] * 4
    msgs = " | ".join(f.message for f in findings)
    assert msgs.count("Python value for `stop`") == 3
    assert "unhashable value for static arg `n`" in msgs


def test_r2_tensor_at_a_call_site_is_clean():
    src = """
        def body(x, stop, n):
            return torch.where(x == stop, 0, x)

        run = capture(body, static_argnames=("n",))

        def drive(x, stop_t):
            return run(x, stop_t, n=4)
    """
    assert _lint(src) == []


# ------------------------------------------------------------------- R3
KERNEL_MODULE = """
    from repro_torch.kernels.build import CudaKernel

    KERNEL = CudaKernel("double.cu", "repro_double", [])

    def double_plain(x):
        return 2 * x

    def double_cuda(x):
        out = torch.empty_like(x)
        KERNEL.launch(x.data_ptr(), out.data_ptr(), x.numel())
        return out
"""


def test_r3_kernel_with_plain_counterpart_clean():
    assert _lint(KERNEL_MODULE, path="src/repro_torch/kernels/double.py") \
        == []


def test_r3_missing_plain_counterpart():
    src = KERNEL_MODULE.replace("double_plain", "twice")
    (f,) = _lint(src, path="src/repro_torch/kernels/double.py")
    assert f.rule == "R3" and "`double_plain`" in f.message


def test_r3_try_around_a_launch():
    src = KERNEL_MODULE + """
    def double(x):
        try:
            return double_cuda(x)
        except RuntimeError:
            return double_plain(x)
    """
    (f,) = _lint(src, path="src/repro_torch/kernels/double.py")
    assert f.rule == "R3" and "fall back" in f.message


def test_r3_outside_kernels_skipped():
    src = KERNEL_MODULE.replace("double_plain", "twice")
    assert _lint(src, path="src/repro_torch/core/double.py") == []


def test_flash_backward_plain_counterpart_matches_jax():
    """R3's plain counterpart of the flash backward: autograd through the
    plain forward, held against ``jax.vjp`` of the JAX package's oracle."""
    torch = pytest.importorskip("torch")
    jax = pytest.importorskip("jax")
    from repro.kernels.ref import flash_attention_ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_plain)
    rng = np.random.default_rng(0)
    q, k, v, dout = (rng.standard_normal((1, 2, 12, 16)).astype(np.float32)
                     for _ in range(4))
    for causal, window in ((True, 0), (True, 5), (False, 0)):
        tq, tk, tv, td = map(torch.as_tensor, (q, k, v, dout))
        out = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
        got = flash_attention_bwd_plain(tq, tk, tv, out, None, td,
                                        causal=causal, window=window)
        _, vjp = jax.vjp(lambda a, b, c: flash_attention_ref(
            a, b, c, causal=causal, window=window), q, k, v)
        for g, w in zip(got, vjp(dout)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


# ------------------------------------------------------------------- R4
def test_r4_missing_method_and_bad_arity():
    src = """
        class Partial(SpecOps):
            def step(self, params, tok):
                return tok
    """
    findings = _lint(src)
    assert sorted(_rules(findings)) == ["R4"] * 4
    msgs = " | ".join(f.message for f in findings)
    assert "extend" in msgs and "snapshot" in msgs and "commit" in msgs


def test_r4_conforming_subclass_clean():
    src = """
        class Full(SequenceState):
            def admit(self, b, prompt, need_tokens):
                return True

            def finalize(self, b, cache, extra=None):
                pass

            def detached_len(self, entry_count):
                return entry_count
    """
    assert _lint(src) == []


def test_r4_scheduler_purity():
    src = """
        def route(state, lane):
            if isinstance(state, (PagedKV, ShardView)):
                pass
            if lane.layout == "paged":
                pass
            return getattr(state, "pool", None)
    """
    findings = _lint(src, path="src/repro_torch/core/scheduler.py")
    assert sorted(_rules(findings)) == ["R4"] * 4
    # the same constructs OUTSIDE the scheduler are legal
    assert _lint(src, path="src/repro_torch/core/seq_state.py") == []


def test_protocol_surfaces_match_live_signatures():
    """The baked arity table cannot rot: every entry equals the port's
    live protocol method's positional arity (incl. self)."""
    pytest.importorskip("torch")
    from repro_torch.core.policy import CollabPolicy
    from repro_torch.core.seq_state import SequenceState, SpecOps
    live = {"SequenceState": SequenceState, "CollabPolicy": CollabPolicy,
            "SpecOps": SpecOps}
    assert set(PROTOCOL_SURFACES) == set(live)
    for cls_name, surface in PROTOCOL_SURFACES.items():
        for meth, arity in surface.items():
            sig = inspect.signature(getattr(live[cls_name], meth))
            pos = [p for p in sig.parameters.values()
                   if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
            assert len(pos) == arity, (cls_name, meth, sig)


# ------------------------------------------------------------ machinery
def test_syntax_error_reported_not_raised():
    (f,) = _lint("def broken(:\n")
    assert f.rule == "E0"


def test_unknown_rule_raises():
    with pytest.raises(KeyError, match="R9"):
        _lint("x = 1\n", rules=["R9"])


def test_rule_registry_complete():
    assert set(RULES) == {"R0", "R1", "R2", "R3", "R4"}
    assert set(RULE_DOCS) == set(RULES)


def test_rule_selection():
    src = """
        @hot_path
        def tick(v):
            return v.item()

        @capture
        def f(x):
            if x > 0:
                return x
            return -x
    """
    assert _rules(_lint(src, rules=["R1"])) == ["R1"]
    assert _rules(_lint(src, rules=["R2"])) == ["R2"]


# ----------------------------------------------------------------- tree
def test_real_tree_is_clean():
    """The port, its examples and the chip script lint clean under the
    port's rules."""
    findings = analyze_paths([REPO / "src" / "repro_torch",
                              REPO / "examples" / "torch_port",
                              REPO / "chip_smoke.py"])
    assert findings == [], "\n".join(f.format() for f in findings)


def test_shipped_suppressions_are_load_bearing():
    """Stripping the port scheduler's suppression markers re-surfaces R1
    findings: each shipped `ok(R1, ...)` holds back a real one (the
    tick's and the groups' `host_pull`s)."""
    path = REPO / "src" / "repro_torch" / "core" / "scheduler.py"
    src = path.read_text()
    stripped = re.sub(r"#\s*repro-lint:[^\n]*", "", src)
    assert stripped != src, "scheduler.py lost its suppression markers"
    findings = analyze_source(str(path), stripped, rules=["R1"])
    assert len(findings) >= 3
    assert all(f.rule == "R1" for f in findings)
    assert sum("host_pull" in f.message for f in findings) >= 2


def test_the_captured_tick_and_round_are_registered():
    """R2 sees the port's captured functions (the tick, the linear, tree
    and self rounds, the prefill and the chunked prefill's extend), with
    the tick's and the prefill's static arguments."""
    from repro_torch.analysis.core import ModuleContext
    seen = {}
    for rel in ("core/seq_state.py", "core/speculative.py"):
        path = REPO / "src" / "repro_torch" / rel
        ctx = ModuleContext(str(path), path.read_text())
        seen.update({fn.name: statics
                     for fn, statics in ctx.capture_static.items()})
    assert seen == {"_chunk_body": {"n_steps", "topk"}, "_linear_round": set(),
                    "_tree_round": set(), "_self_body": set(),
                    "_prefill_body": {"max_seq"}, "_extend_body": set()}


def test_reseeded_violation_turns_tree_dirty(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(HOT_ITEM))
    assert lint_main([str(bad)]) == 1
    assert analyze_file(bad)[0].rule == "R1"


# ------------------------------------------------------------------ CLI
def test_cli_clean_exit_and_json_report(tmp_path, capsys):
    good = tmp_path / "good.py"
    good.write_text("def f(x):\n    return x + 1\n")
    report_path = tmp_path / "report.json"
    rc = lint_main([str(good), "--format", "json",
                    "--json-out", str(report_path)])
    assert rc == 0
    report = json.loads(report_path.read_text())
    assert report["count"] == 0 and report["rules"] == sorted(RULES)
    assert json.loads(capsys.readouterr().out)["findings"] == []


def test_cli_findings_exit_one_with_location(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(HOT_ITEM))
    assert lint_main([str(bad), "--rules", "R1"]) == 1
    out = capsys.readouterr().out
    assert "bad.py:6" in out and "R1" in out


def test_cli_unknown_rule_exit_two(tmp_path):
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert lint_main([str(good), "--rules", "R7"]) == 2


def test_cli_list_rules_and_help(capsys):
    from repro_torch.analysis import __main__ as cli
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in RULES:
        assert rid in out
    assert "repro-lint: ok(" in cli.__doc__ and "REQUIRED" in cli.__doc__
