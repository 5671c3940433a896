"""Serve-time adaptation in the port vs the JAX package, on the CPU.

Both engines serve the reduced smollm-135m edge and granite-8b cloud (the
JAX init, bridged into the port) with an ``AdaptationLoop`` attached:
capture off the retirement path (store records, domain/SLA/path tags, the
cloud's top-k teacher logits), the distill loop's update between drains,
the hot swap, and the serve CLI's ``--adapt`` flags.

Tolerances: teacher top-k values 1e-5 (float32 logits of two layers summed
in another order), indices equal (the random logits have no exact ties);
the swapped parameters after one distillation step 1e-5 — the test's
AdamW takes eps = 1e-3, so that the first step's update g / (|g| + eps)
is smooth in the gradient (at the default 1e-8 it is sign(g), which
float32 noise flips on gradients within rounding of zero).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.core.adaptation import AdaptationLoop as JLoop  # noqa: E402
from repro.core.policy import ThresholdPolicy as JThreshold  # noqa: E402
from repro.core.scheduler import BatchedEngine as JEngine  # noqa: E402
from repro.data.feedback_store import FeedbackStore as JStore  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.training.optimizer import AdamW as JAdamW  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.adaptation import AdaptationLoop as TLoop  # noqa
from repro_torch.core.policy import ThresholdPolicy as TThreshold  # noqa
from repro_torch.core.scheduler import BatchedEngine as TEngine  # noqa
from repro_torch.data.feedback_store import TOPK_FILL  # noqa: E402
from repro_torch.data.feedback_store import FeedbackStore as TStore  # noqa
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.training import tree as T  # noqa: E402
from repro_torch.training.optimizer import AdamW as TAdamW  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


@pytest.fixture(scope="module")
def pair():
    je = jget("smollm-135m").reduced()
    jc = jget("granite-8b").reduced().replace(vocab_size=je.vocab_size)
    te = tget("smollm-135m").reduced()
    tc = tget("granite-8b").reduced().replace(vocab_size=te.vocab_size)
    jep, jcp = (JModel(je).init(jax.random.PRNGKey(0)),
                JModel(jc).init(jax.random.PRNGKey(1)))
    return {"j": (JModel(je), jep, JModel(jc), jcp),
            "t": (TModel(te), params_from_numpy(_host(jep), te, "cpu"),
                  TModel(tc), params_from_numpy(_host(jcp), tc, "cpu"))}


def _prompts(vocab, n, length=8):
    return [((np.arange(length) * 7 + 3 * i) % vocab).astype(np.int32)
            for i in range(n)]


def _engine(side, pair, adapt, threshold=0.0, batch=4):
    edge, _, cloud, _ = pair[side]
    Engine, Pol = (JEngine, JThreshold) if side == "j" else \
        (TEngine, TThreshold)
    return Engine(edge, cloud, batch_size=batch, temperature=0.0,
                  policy=Pol(threshold), use_cache=False, tick_tokens=4,
                  adaptation=adapt)


def _records(store):
    return [(r.prompt.tolist(), r.tokens.tolist(),
             None if r.draft is None else r.draft.tolist(), r.domain, r.sla,
             r.path) for r in store.records()]


# ------------------------------------------------------------ store
def test_feedback_store_batches_byte_equal():
    """The same records and the same numpy seed give byte-equal batches:
    tokens, labels, the scattered teacher logits and the KD mask."""
    rng = np.random.default_rng(0)
    stores = (JStore(capacity=5), TStore(capacity=5))
    for i in range(7):
        prompt = rng.integers(0, 40, 3 + i % 3).astype(np.int32)
        toks = rng.integers(0, 40, 2 + i % 4).astype(np.int32)
        tv = rng.standard_normal((toks.size, 3)).astype(np.float32)
        ti = np.stack([rng.permutation(40)[:3] for _ in range(toks.size)]
                      ).astype(np.int32)
        for s in stores:
            s.add(prompt, toks, draft=toks[::-1],
                  teacher_topk=(tv, ti) if i % 2 else None, domain=i % 3,
                  sla="met", path="cloud")
    assert stores[0].stats() == stores[1].stats()
    for kw in (dict(topk=2), dict(topk=0), dict(topk=3, domains=[1])):
        jb = stores[0].sample_batch(np.random.default_rng(4), 6, 9, 40, **kw)
        tb = stores[1].sample_batch(np.random.default_rng(4), 6, 9, 40, **kw)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            a = np.asarray(jb[k])
            assert a.dtype == tb[k].dtype and a.tobytes() == tb[k].tobytes()
    assert TOPK_FILL == -30.0


# ------------------------------------------------------------ capture
def test_scheduler_capture_and_tags_match_jax(pair):
    """Threshold 0 sends every request to the cloud: both engines capture
    the same records and the same teacher top-k off the same pull."""
    loops = {s: L(mode="distill", interval=0, topk=4)
             for s, L in (("j", JLoop), ("t", TLoop))}
    vocab = pair["t"][0].cfg.vocab_size
    prompts = _prompts(vocab, 6)
    traces = {}
    for s in "jt":
        _, ep, _, cp = pair[s]
        eng = _engine(s, pair, loops[s])
        traces[s] = eng.serve_batch(ep, cp, prompts, 5,
                                    domains=[i % 2 for i in range(6)])
        assert "adaptation" in eng.stats()
    assert [t.tokens for t in traces["t"]] == [t.tokens for t in traces["j"]]
    assert all(t.path == "cloud" for t in traces["t"])
    js, ts = loops["j"].store, loops["t"].store
    assert _records(ts) == _records(js)
    assert ts.stats() == js.stats()
    for a, b in zip(ts.records(), js.records()):
        assert a.teacher_values.shape == (5, 4)
        assert np.array_equal(a.teacher_indices, b.teacher_indices)
        np.testing.assert_allclose(a.teacher_values, b.teacher_values,
                                   atol=1e-5, rtol=0)
    for t, j in zip(traces["t"], traces["j"]):
        assert np.array_equal(t.teacher_topk[1], j.teacher_topk[1])
    assert loops["t"].capture_topk == 4
    assert TLoop(mode="lora", topk=4).capture_topk == 0
    assert loops["t"].updates == 0 and loops["t"].maybe_update(
        pair["t"][1]) is None


def test_adaptation_validation():
    with pytest.raises(ValueError):
        TLoop(mode="finetune")
    with pytest.raises(ValueError):
        TLoop(interval=-1)


# ------------------------------------------------------------ training
def test_distill_loop_over_two_drains_matches_jax(pair):
    """Drain 1 fills the store and marks an update due; drain 2 takes it
    at its first tick and serves on the swapped weights.  Traces, store
    contents and the swapped parameters agree with JAX."""
    kw = dict(mode="distill", interval=6, batch_size=4, seq_len=16, topk=4,
              min_records=1)
    loops = {"j": JLoop(opt=JAdamW(lr=1e-3, eps=1e-3), **kw),
             "t": TLoop(opt=TAdamW(lr=1e-3, eps=1e-3), **kw)}
    vocab = pair["t"][0].cfg.vocab_size
    prompts = _prompts(vocab, 6)
    traces = {"j": [], "t": []}
    for s in "jt":
        _, ep, _, cp = pair[s]
        eng = _engine(s, pair, loops[s])
        for _ in range(2):
            traces[s].append([t.tokens for t in
                              eng.serve_batch(ep, cp, prompts, 5)])
    assert traces["t"] == traces["j"]
    jl, tl = loops["j"], loops["t"]
    assert (tl.swaps, tl.updates, tl.steps) == (jl.swaps, jl.updates,
                                                jl.steps) == (1, 1, 1)
    assert _records(tl.store) == _records(jl.store)
    assert abs(tl.stats()["last_loss"] - jl.stats()["last_loss"]) <= 1e-5
    cfg = pair["t"][0].cfg
    got, want = params_to_numpy(tl.latest, cfg), _host(jl.latest)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(want)[0]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0,
                                   err_msg=str(path))
    # the swap has the serving tree's structure, shapes, dtypes, device
    ep = pair["t"][1]
    assert [n for n, _ in T.leaves(tl.latest)] == \
        [n for n, _ in T.leaves(ep)]
    for a, b in zip(T.tensors(tl.latest), T.tensors(ep)):
        assert (a.shape, a.dtype, a.device) == (b.shape, b.dtype, b.device)
        assert not a.requires_grad


def test_zero_lr_lora_serves_identical_tokens(pair):
    """lr=0 LoRA: every swap installs merge(base, zero adapters) == base,
    so the adapted engine serves exactly the adaptation-free tokens."""
    _, ep, _, cp = pair["t"]
    adapt = TLoop(mode="lora", interval=4, batch_size=4, seq_len=16,
                  opt=TAdamW(lr=0.0), min_records=1)
    prompts = _prompts(pair["t"][0].cfg.vocab_size, 8)
    eng = _engine("t", pair, adapt, threshold=0.6)
    plain = _engine("t", pair, None, threshold=0.6)
    for _ in range(2):
        a = eng.serve_batch(ep, cp, prompts, 6)
        b = plain.serve_batch(ep, cp, prompts, 6)
        assert [t.tokens for t in a] == [t.tokens for t in b]
    assert adapt.swaps >= 1 and adapt.steps >= 1


def test_adaptation_persists_across_drains(pair):
    _, ep, _, cp = pair["t"]
    adapt = TLoop(mode="distill", interval=4, batch_size=4, seq_len=16,
                  topk=4, min_records=1)
    eng = _engine("t", pair, adapt)
    prompts = _prompts(pair["t"][0].cfg.vocab_size, 4)
    eng.serve_batch(ep, cp, prompts, 5)
    eng.serve_batch(ep, cp, prompts, 5)
    assert adapt.latest is not None
    assert adapt.current(ep) is adapt.latest
    assert not torch.equal(T.tensors(adapt.latest)[0], T.tensors(ep)[0])


def test_serve_cli_adapt_lora_runs(tmp_path, capsys):
    from repro_torch.launch import serve
    traces, stats = serve.main(
        ["--device", "cpu", "--reduced", "--requests", "4", "--max-new",
         "4", "--batch-size", "2", "--adapt", "lora", "--adapt-interval",
         "2", "--adapt-checkpoint", str(tmp_path / "ad.npz")])
    assert len(traces) == 4 and all(len(t.tokens) == 4 for t in traces)
    a = stats["adaptation"]
    assert a["mode"] == "lora" and a["observed"] == 4 and a["swaps"] >= 1
    out = capsys.readouterr().out
    assert "adapt: mode=lora" in out and "saved lora artifact" in out
    keys = np.load(tmp_path / "ad.npz").files
    assert "blocks%2Fattn%2Fwq/A" in keys
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--reduced", "--scheduler",
                    "per-request", "--adapt", "lora"])
