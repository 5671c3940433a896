"""The port's four examples (``examples/torch_port/``) run in-process on
the CPU at their reduced sizes, each checked for its own invariant;
quickstart's tokens are also held against the JAX package's on bridged
parameters."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import speculative as jspec  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch_port"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_port_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


def test_quickstart_is_lossless_and_matches_jax(capsys):
    je = jget("smollm-135m").reduced()
    jc = jget("granite-8b").reduced().replace(vocab_size=je.vocab_size)
    jem, jcm = JModel(je), JModel(jc)
    jep = jem.init(jax.random.PRNGKey(0))
    jcp = jcm.init(jax.random.PRNGKey(1))
    te = tget("smollm-135m").reduced()
    tc = tget("granite-8b").reduced().replace(vocab_size=te.vocab_size)
    out = _load("quickstart").main(
        ["--device", "cpu"], params=(params_from_numpy(_host(jep), te, "cpu"),
                                     params_from_numpy(_host(jcp), tc, "cpu")))
    assert out["lossless"] and out["speculative"] == out["baseline"]
    assert len(out["speculative"]) == 24
    assert "identical (lossless): True" in capsys.readouterr().out
    prompt = np.arange(12) % je.vocab_size
    want, _ = jspec.SpecDecoder(jem, jcm, gamma=4, temperature=0.0).generate(
        jep, jcp, prompt, 24)
    assert out["speculative"] == [int(t) for t in want]
    assert 0.0 < out["epistemic"] and 0.0 < out["aleatoric"] <= 1.0


def test_quickstart_seeded_runs():
    out = _load("quickstart").main(["--device", "cpu"])
    assert out["lossless"]
    assert out["accounting"]["tokens_out"] == 24


def test_train_distill_loss_falls():
    out = _load("train_distill").main(["--device", "cpu", "--steps", "16",
                                       "--batch", "4", "--seq", "32"])
    hist = out["teacher_history"]
    assert hist[-1][1] < hist[0][1]
    d = out["distill_losses"]
    assert len(d) == 8 and d[-1] < d[0]
    assert 0.0 < out["acceptance_before"] <= 1.0
    assert np.isfinite(out["student_ce"])


def test_federated_lora_aggregates_right_shapes():
    mod = _load("federated_lora")
    out = mod.main(["--device", "cpu", "--steps", "3"])
    R = max(mod.RANKS)
    agg = out["aggregate"]
    assert set(agg) == set(out["adapters"][0])
    for path, a in agg.items():
        assert a["A"].shape[-2] == R and a["B"].shape[-1] == R
        for c, ad in enumerate(out["adapters"]):
            assert ad[path]["A"].shape[-2] == mod.RANKS[c]
            assert ad[path]["A"].shape[:-2] == a["A"].shape[:-2]
            assert ad[path]["B"].shape[-2] == a["B"].shape[-2]
    assert all(np.isfinite(out["client_losses"]))
    assert np.isfinite(out["merged_ce"]) and np.isfinite(out["base_ce"])


def test_collaborative_serving_serves_every_request():
    out = _load("collaborative_serving").main(["--device", "cpu"])
    assert set(out) == {"speculative@0.55", "cascade"}
    for label, (req_s, paths, ct, stats, traces) in out.items():
        assert len(traces) == 13 and sum(paths.values()) == 13
        assert all(t.tokens for t in traces), label
        assert paths.get("cache", 0) >= 3       # the three repeats
        assert stats["kv_layout"] == "paged"


@pytest.mark.parametrize("name", ["quickstart", "collaborative_serving",
                                  "federated_lora", "train_distill"])
def test_examples_refuse_cuda_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        _load(name).main([])
