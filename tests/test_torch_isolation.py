"""The port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py``) imports ``jax`` or the JAX package ``repro``; the whole
package imports and serves with both blocked; its entry points default to
CUDA and raise without a card instead of carrying on on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
BANNED = ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.JoinedStr):
            first = node.args[0].values[0]
            if isinstance(first, ast.Constant):
                yield node.lineno, str(first.value).rstrip(".")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_imports(path):
    bad = [(ln, mod) for ln, mod in _imports(path)
           if mod.split(".")[0] in BANNED]
    assert not bad, f"{path}: imports {bad}"


_BLOCKED_SERVE = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now fails
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for m in mods:
    importlib.import_module(m)
from repro_torch.launch.serve import main
traces, stats = main(["--device", "cpu", "--reduced", "--requests", "2",
                      "--max-new", "4"])
assert len(traces) == 2 and all(len(t.tokens) == 4 for t in traces)
assert not any(k.split(".")[0] in ("jax", "jaxlib", "repro")
               for k, v in sys.modules.items() if v is not None)
print("OK", len(mods))
"""


def test_port_imports_and_serves_with_jax_blocked():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", _BLOCKED_SERVE], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    n = int(out.stdout.strip().splitlines()[-1].split()[1])
    # every module and subpackage: each .py file except the root __init__
    assert n == len(list(PORT.rglob("*.py"))) - 1


def test_serve_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced", "--requests", "1"])


def test_model_init_defaults_to_cuda():
    import inspect
    from repro_torch.models import Model
    from repro_torch.configs import get_config
    sig = inspect.signature(Model.init)
    assert sig.parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            Model(get_config("smollm-135m").reduced()).init(seed=0)


def test_chip_smoke_refuses_without_the_package(tmp_path):
    """Alone in a directory (no ``src/repro_torch`` beside it) the chip
    smoke test exits non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
