"""The port's per-request engine and single-request decoders vs the JAX
package's, on bridged parameters (reduced smollm-135m edge, granite-8b
cloud, f32), T = 0.

``CollaborativeEngine.serve_reference`` must give the JAX engine's path,
tokens, ``edge_calls`` and ``cloud_passes`` for the edge, speculative,
skeleton and cloud outcomes and a semantic-cache hit, with the uncertainty
within 1e-5; the port's ``serve`` (a one-slot ``BatchedEngine``) must give
its own ``serve_reference``'s path and tokens.  ``SpecDecoder`` (dense
draft, mamba2 draft, adaptive gamma), ``TreeSpecDecoder`` (3, 2, 1),
``SelfSpecDecoder`` (gamma 1 and 3) and ``autoregressive_baseline`` must
give identical tokens and every stat.  The small functions, the
sequential tree-acceptance oracle, ``mha_chunked`` and the serve CLI's
per-request scheduler are held too.
"""
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.core import speculative as jspec  # noqa: E402
from repro.core import tree_speculation as jtree  # noqa: E402
from repro.core.engine import CollaborativeEngine as JEngine  # noqa: E402
from repro.core.self_speculative import SelfSpecDecoder as JSelf  # noqa: E402
from repro.data import SyntheticLM  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.core import speculative as tspec  # noqa: E402
from repro_torch.core import tree_speculation as ttree  # noqa: E402
from repro_torch.core.engine import CollaborativeEngine as TEngine  # noqa: E402
from repro_torch.core.self_speculative import SelfSpecDecoder as TSelf  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its host loops issue many
    tiny ops, which threads only slow down when the test workers share
    the CPU; the previous count is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(get, edge="smollm-135m", cloud="granite-8b"):
    e, c = get(edge).reduced(), get(cloud).reduced()
    v = min(e.vocab_size, c.vocab_size)
    return e.replace(vocab_size=v), c.replace(vocab_size=v)


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


@pytest.fixture(scope="module")
def setup():
    (je, jc), (te, tc) = _pair(jget), _pair(tget)
    jep = JModel(je).init(jax.random.PRNGKey(0))
    jcp = JModel(jc).init(jax.random.PRNGKey(1))
    return {"j": (JModel(je), JModel(jc), jep, jcp),
            "t": (TModel(te), TModel(tc),
                  params_from_numpy(_host(jep), te, "cpu"),
                  params_from_numpy(_host(jcp), tc, "cpu")),
            "vocab": te.vocab_size}


def _prompts(vocab, n=2, length=12):
    synth = SyntheticLM(vocab)
    rng = np.random.default_rng(0)
    return [synth.sample(rng, i % synth.n_domains, length) for i in range(n)]


OUTCOMES = {"edge": ("SpeculativePolicy", 1.1),
            "speculative": ("SpeculativePolicy", -1.0),
            "skeleton": ("SkeletonPolicy", -1.0),
            "cloud": ("ThresholdPolicy", -1.0)}


def _engine(side, setup, outcome, **kw):
    em, cm, _, _ = setup[side]
    pol, Engine = (jpol, JEngine) if side == "j" else (tpol, TEngine)
    name, thr = OUTCOMES[outcome]
    return Engine(em, cm, gamma=3, temperature=0.0, skeleton_len=4,
                  policy=getattr(pol, name)(threshold=thr), **kw)


@pytest.mark.parametrize("outcome", list(OUTCOMES))
def test_serve_reference_matches_jax(setup, outcome):
    """Two prompts take the outcome's path, the first again hits the
    semantic cache; every field agrees with the JAX engine."""
    prompts = _prompts(setup["vocab"])
    prompts.append(prompts[0])
    traces = {}
    for side in ("j", "t"):
        eng = _engine(side, setup, outcome)
        _, _, ep, cp = setup[side]
        traces[side] = [eng.serve_reference(ep, cp, p, 8) for p in prompts]
    assert [tr.path for tr in traces["t"]] == [outcome, outcome, "cache"]
    for a, b in zip(traces["j"], traces["t"]):
        assert (a.path, a.tokens, a.edge_calls, a.cloud_passes) == \
            (b.path, b.tokens, b.edge_calls, b.cloud_passes)
        assert abs(a.uncertainty - b.uncertainty) < 1e-5


@pytest.mark.parametrize("outcome", list(OUTCOMES))
def test_serve_matches_serve_reference(setup, outcome):
    """The one-slot batched path gives the reference loop's path, tokens
    and uncertainty (fresh engines: the two share a semantic cache)."""
    _, _, ep, cp = setup["t"]
    for p in _prompts(setup["vocab"]):
        a = _engine("t", setup, outcome).serve_reference(ep, cp, p, 10)
        b = _engine("t", setup, outcome).serve(ep, cp, p, 10)
        assert (a.path, a.tokens) == (b.path, b.tokens)
        assert abs(a.uncertainty - b.uncertainty) < 1e-5


def test_serve_shares_one_semantic_cache(setup):
    """A request served by ``serve_reference`` is a cache hit for
    ``serve``, and the legacy rule holds: a non-threshold policy is served
    at speculative@0.6 with a ``RuntimeWarning``."""
    em, cm, ep, cp = setup["t"]
    p = _prompts(setup["vocab"], 1)[0]
    eng = _engine("t", setup, "edge")
    a = eng.serve_reference(ep, cp, p, 6)
    b = eng.serve(ep, cp, p, 6)
    assert b.path == "cache" and b.tokens == a.tokens
    assert eng.stats()["cache_hit_rate"] > 0
    legacy = TEngine(em, cm, gamma=3, temperature=0.0,
                     policy=tpol.CascadePolicy(), use_cache=False)
    assert (legacy.threshold, legacy.escalation) == (0.6, "speculative")
    with pytest.warns(RuntimeWarning, match="speculative@0.6"):
        tr = legacy.serve_reference(ep, cp, p, 4)
    assert tr.path == "speculative"


# ------------------------------------------------------------ decoders
@pytest.fixture(scope="module")
def mamba(setup):
    """A reduced mamba2-370m draft for the granite cloud, bridged."""
    e, _ = _pair(jget, "mamba2-370m")
    jp = JModel(e).init(jax.random.PRNGKey(2))
    te, _ = _pair(tget, "mamba2-370m")
    return (JModel(e), jp), (TModel(te), params_from_numpy(_host(jp), te,
                                                          "cpu"))


def _stats(st):
    return st.summary(), st.accepted


@pytest.mark.parametrize("draft,adaptive", [("dense", False),
                                            ("mamba2", False),
                                            ("dense", True)])
def test_spec_decoder_matches_jax(setup, mamba, draft, adaptive):
    prompt = _prompts(setup["vocab"], 1)[0]
    out = {}
    for side, k in (("j", 0), ("t", 1)):
        dm, cm, dp, cp = setup[side]
        if draft == "mamba2":
            dm, dp = mamba[k]
        dec = (jspec if side == "j" else tspec).SpecDecoder(
            dm, cm, gamma=3, temperature=0.0, adaptive=adaptive)
        toks, st = dec.generate(dp, cp, prompt, 8)
        out[side] = toks, _stats(st)
    assert out["j"] == out["t"]
    if draft == "mamba2":
        assert out["t"][1][0]["replay_passes"] > 0


def test_spec_decoder_self_draft_accepts_everything(setup):
    """The cloud drafting for itself: every draft token is accepted."""
    _, cm, _, cp = setup["t"]
    toks, st = tspec.SpecDecoder(cm, cm, gamma=3, temperature=0.0).generate(
        cp, cp, _prompts(setup["vocab"], 1)[0], 8)
    assert st.accepted == [3, 3] and len(toks) == 8
    assert toks == tspec.autoregressive_baseline(
        cm, cp, _prompts(setup["vocab"], 1)[0], 8, temperature=0.0)


def test_tree_spec_decoder_matches_jax(setup):
    prompt = _prompts(setup["vocab"], 1)[0]
    out = {}
    for side, mod in (("j", jtree), ("t", ttree)):
        dm, cm, dp, cp = setup[side]
        out[side] = mod.TreeSpecDecoder(dm, cm, branching=(3, 2, 1),
                                        temperature=0.0).generate(
            dp, cp, prompt, 4)
    assert out["j"] == out["t"]


def test_tree_spec_decoder_refuses_recurrent_target(mamba):
    tm = mamba[1][0]
    with pytest.raises(ValueError, match="attention target"):
        ttree.TreeSpecDecoder(tm, tm)


def test_build_tree_matches_jax(setup):
    """One (3, 2, 1) expansion: tokens, parents and the stored draft
    log-probs against JAX's.  At T = 0 the logits are divided by 1e-6, so
    the log-probs are compared back in logit units (times 1e-6), within
    1e-5."""
    p = _prompts(setup["vocab"], 1)[0]
    trees = {}
    for side, mod in (("j", jtree), ("t", ttree)):
        dm, _, dp, _ = setup[side]
        arr = jnp.asarray(p[None, :-1]) if side == "j" else \
            torch.as_tensor(p[None, :-1])
        _, cache = dm.prefill(dp, {"tokens": arr}, max_seq=40)
        kw = {"rng": jax.random.PRNGKey(0)} if side == "j" else {}
        trees[side] = mod.build_tree(dm, dp, cache, int(p[-1]), (3, 2, 1),
                                     temperature=0.0, **kw)
    (jt, jc), (tt, tc) = trees["j"], trees["t"]
    assert jc == tc == 19
    np.testing.assert_array_equal(jt.tokens, tt.tokens)
    np.testing.assert_array_equal(jt.parent, tt.parent)
    np.testing.assert_allclose(tt.draft_logp * 1e-6, jt.draft_logp * 1e-6,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("gamma", [1, 3])
def test_self_spec_decoder_matches_jax(setup, gamma):
    prompt = _prompts(setup["vocab"], 1)[0]
    out = {}
    for side, Dec in (("j", JSelf), ("t", TSelf)):
        em, _, ep, _ = setup[side]
        toks, st = Dec(em, exit_layer=1, gamma=gamma,
                       temperature=0.0).generate(ep, prompt, 10)
        out[side] = toks, _stats(st)
    assert out["j"] == out["t"]


def test_self_spec_decoder_refuses_bad_models(mamba):
    tm = mamba[1][0]
    with pytest.raises(ValueError, match="self-speculation"):
        TSelf(tm, exit_layer=1)
    with pytest.raises(ValueError, match="exit_layer"):
        TSelf(TModel(_pair(tget)[0]), exit_layer=2)


def test_autoregressive_baseline_matches_jax(setup):
    prompt = _prompts(setup["vocab"], 1)[0]
    outs = [mod.autoregressive_baseline(setup[side][1], setup[side][3],
                                        prompt, 10, temperature=0.0)
            for side, mod in (("j", jspec), ("t", tspec))]
    assert outs[0] == outs[1]


# ------------------------------------------------------------ small pieces
def test_acceptance_rate_bound_matches_jax():
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(32), size=5).astype(np.float32)
    q = rng.dirichlet(np.ones(32), size=5).astype(np.float32)
    j = np.asarray(jspec.acceptance_rate_bound(jnp.asarray(p),
                                               jnp.asarray(q)))
    t = tspec.acceptance_rate_bound(torch.as_tensor(p),
                                    torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
    assert np.all(t <= 1.0 + 1e-6)


def test_adaptive_gamma_matches_jax():
    rng = np.random.default_rng(0)
    a, b = jspec.AdaptiveGamma(4, hi=7), tspec.AdaptiveGamma(4, hi=7)
    for _ in range(40):
        used = a.gamma
        n = int(rng.integers(0, used + 1))
        assert a.update(n, used) == b.update(n, used)


def test_token_tree_matches_jax():
    rng = np.random.default_rng(0)
    parent = np.asarray([-1] + [int(rng.integers(0, i)) for i in range(1, 12)],
                        np.int32)
    tokens = rng.integers(0, 100, 12).astype(np.int32)
    logp = rng.standard_normal((12, 8)).astype(np.float32)
    jt = jtree.TokenTree(tokens, parent, logp)
    tt = ttree.TokenTree(tokens, parent, logp)
    assert jt.n == tt.n
    np.testing.assert_array_equal(jt.attention_mask(), tt.attention_mask())
    np.testing.assert_array_equal(jt.depths(), tt.depths())
    for i in range(12):
        assert jt.ancestors(i) == tt.ancestors(i)
        assert jt.children(i) == tt.children(i)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_tree_accept_ref_matches_jax(temperature):
    """The sequential oracle on the JAX oracle's own uniforms (split and
    drawn from its key)."""
    plan_j, plan_t = jtree.TreePlan((3, 2, 1)), ttree.TreePlan((3, 2, 1))
    rng = np.random.default_rng(1)
    V = 16
    for seed in range(8):
        tl = rng.standard_normal((plan_t.n_pad, V)).astype(np.float32) * 2
        ql = rng.standard_normal((plan_t.n_pad, V)).astype(np.float32) * 2
        toks = rng.integers(0, V, plan_t.n_pad).astype(np.int32)
        toks[1] = int(np.argmax(tl[0]))        # the root's first child hits
        key = jax.random.PRNGKey(seed)
        r_acc, r_res = jax.random.split(key)
        u_acc = np.asarray(jax.random.uniform(r_acc, (3, 3)))
        u_res = np.asarray(jax.random.uniform(r_res, (4,)))
        j = jtree.tree_accept_ref(key, tl, ql, toks, plan_j,
                                  temperature=temperature)
        t = ttree.tree_accept_ref(tl, ql, toks, plan_t, u_acc, u_res,
                                  temperature=temperature)
        assert (int(j[0]), [int(x) for x in j[1]]) == t


# ------------------------------------------------------------ mha_chunked
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
def test_mha_chunked_matches_jax_and_mha(causal, window):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    j = np.asarray(JL.mha_chunked(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, bq=8, bk=4))
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    t = TL.mha_chunked(tq, tk, tv, causal=causal, window=window, bq=8, bk=4)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5, rtol=1e-5)
    pos = torch.arange(32)
    mask = TL._attn_mask(pos, pos, causal=causal, window=window) \
        if causal or window else None
    np.testing.assert_allclose(t.numpy(), TL.mha(tq, tk, tv, mask).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_attention_block_chunks_from_threshold(monkeypatch):
    """The plain prefill switches to ``mha_chunked`` at the threshold, and
    the two paths agree."""
    cfg = tget("smollm-135m").reduced()
    attn = TModel(cfg).init(seed=0, device="cpu").blocks[0].attn
    x = torch.randn((1, 24, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    pos = torch.arange(24)
    full, _ = TL.attention_block(attn, x, pos, cfg, window=7)
    calls = []
    real = TL.mha_chunked
    monkeypatch.setattr(TL, "mha_chunked",
                        lambda *a, **kw: calls.append(1) or real(
                            *a, **kw, bq=8, bk=8))
    monkeypatch.setattr(TL, "CHUNKED_ATTN_THRESHOLD", 24)
    chunked, _ = TL.attention_block(attn, x, pos, cfg, window=7)
    assert calls == [1]
    torch.testing.assert_close(chunked, full, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ serve CLI
def test_serve_cli_per_request_runs(capsys):
    traces, stats = tserve.main(["--device", "cpu", "--reduced",
                                 "--scheduler", "per-request",
                                 "--requests", "2", "--max-new", "4",
                                 "--threshold", "-1"])
    assert [tr.path for tr in traces] == ["speculative"] * 2
    assert all(len(tr.tokens) == 4 for tr in traces)
    assert stats["policy"] == "speculative"
    assert "req   1 path=speculative" in capsys.readouterr().out


REFUSALS = {"policy": ["--policy", "cascade"],
            "arrival": ["--arrival", "poisson"],
            "spec_mode": ["--spec-mode", "tree"],
            "mesh": ["--mesh", "data"]}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_serve_cli_refusals_match_jax(monkeypatch, name):
    argv = ["--reduced", "--scheduler", "per-request", "--requests", "1"] \
        + REFUSALS[name]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(SystemExit) as j:
            jserve.main()
    with pytest.raises(SystemExit) as t:
        tserve.main(["--device", "cpu"] + argv)
    assert str(t.value) == str(j.value) and str(t.value)


class _FixedTarget:
    """A target whose extend returns fixed logits (1, n, V): enough for
    ``verify_tree``'s acceptance walk."""
    rewindable_cache = True

    def __init__(self, logits, arr):
        self.logits, self.arr = logits, arr

    def extend_step(self, params, tokens, cache, **kw):
        return self.arr(self.logits[None]), cache


def _walk_case(branching, draw, V=6):
    """A token tree of ``branching`` over V tokens: fixed random draft
    log-probs per node and target logits (seed 0), each node's token drawn
    from its parent's draft distribution with the generator ``draw`` (so
    a walk over fresh draws sees the draft's sampling too).  Returns
    (tokens, parent, draft_logp, target logits)."""
    fixed = np.random.default_rng(0)
    parent, logp, toks = [-1], [np.zeros(V, np.float32)], [0]
    frontier = [0]
    for width in branching:
        new = []
        for node in frontier:
            lp = fixed.standard_normal(V).astype(np.float32)
            lp = lp - np.log(np.exp(lp).sum())
            q = np.exp(lp.astype(np.float64))
            for t in draw.choice(V, width, replace=False, p=q / q.sum()):
                parent.append(node)
                logp.append(lp)
                toks.append(int(t))
                new.append(len(toks) - 1)
        frontier = new
    tl = fixed.standard_normal((len(toks), V)).astype(np.float32)
    return (np.asarray(toks, np.int32), np.asarray(parent, np.int32),
            np.stack(logp), tl)


def _first_tokens(side, branching, n):
    """(first-token frequencies, mean accepted length) over ``n`` walks of
    ``side``'s ``verify_tree`` at T = 1, walk ``s`` on the tree drawn with
    seed ``s``."""
    first, n_acc = np.zeros(6), 0
    for s in range(n):
        toks, parent, logp, tl = _walk_case(branching,
                                            np.random.default_rng(s))
        if side == "t":
            acc, nxt, _, _ = ttree.verify_tree(
                _FixedTarget(tl, torch.as_tensor), None,
                {"pos": torch.zeros((), dtype=torch.int32)},
                ttree.TokenTree(toks, parent, logp),
                np.random.default_rng(10**6 + s), 1.0)
        else:
            acc, nxt, _, _ = jtree.verify_tree(
                _FixedTarget(tl, jnp.asarray), None, {"pos": jnp.int32(0)},
                jtree.TokenTree(toks, parent, logp),
                jax.random.PRNGKey(s), 1.0)
        first[(acc + [nxt])[0]] += 1
        n_acc += len(acc)
    return first / n, n_acc / n, tl[0]


def test_verify_tree_walk_at_t1_is_statistically_jax(setup):
    """T = 1, trees drawn from the draft: on a chain the walk is lossless
    (its first token follows the target's softmax at the root: 4000 walks
    within 0.03); on a (2, 1) tree the port's first-token distribution
    and mean acceptance agree with JAX's walk (1500 and 400 walks, within
    0.1)."""
    first, _, root = _first_tokens("t", (1, 1), 4000)
    p = np.exp(root - root.max())
    np.testing.assert_allclose(first, p / p.sum(), atol=0.03)
    t_first, t_acc, _ = _first_tokens("t", (2, 1), 1500)
    j_first, j_acc, _ = _first_tokens("j", (2, 1), 400)
    np.testing.assert_allclose(t_first, j_first, atol=0.1)
    assert abs(t_acc - j_acc) < 0.1
