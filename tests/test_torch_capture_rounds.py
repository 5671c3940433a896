"""The captured tree, self and recurrent rounds and the recurrent tick's
host side, on the CPU, against the JAX package.

On the card the tree round, the self round, the linear round over a
recurrent state and ``Lane.chunk`` on the recurrent layout run as CUDA
graphs (``core/capture.py``), which are tied to buffer addresses.  Here
that shows as: every state of a drain or an escalation wave sits in the
buffers of the state of its shape before it (``Lane.make_state`` /
``Lane.release``, spied as ``tests/test_torch_capture.py`` does), a
recurrent tick and round leave every state leaf at its own ``data_ptr``
(``SpecOps`` writes the new leaves back), and the tokens, paths, edge
calls and cloud passes stay JAX's ``BatchedEngine``'s exactly.  Models:
the reduced smollm-135m edge (tree and self lanes) and the reduced
mamba2-370m, xlstm-125m and zamba2-2.7b edges (linear lane) with the
reduced granite-8b cloud, the JAX init bridged by
``bridge.params_from_numpy``, float32, T = 0.  States after the same
steps agree with JAX's within 1e-5 (atol = rtol, as
``tests/test_torch_recurrent.py`` holds caches).  The graphs themselves
are held on the card (``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.core.policy import SpeculativePolicy as JPol  # noqa: E402
from repro.core.scheduler import BatchedEngine as JEngine  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.analysis import analyze_source  # noqa: E402
from repro_torch.analysis.core import ModuleContext  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.policy import SpeculativePolicy as TPol  # noqa: E402
from repro_torch.core.scheduler import BatchedEngine as TEngine  # noqa
from repro_torch.core.seq_state import VIEW  # noqa: E402
from repro_torch.core.seq_state import Lane as TLane  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models.ssm import tree_leaves  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CLOUD = "granite-8b"
TOL = 1e-5
# served path -> (edge arch, engine settings)
PATHS = {"tree": ("smollm-135m", {"spec_mode": "tree", "kv_layout": "dense"}),
         "self": ("smollm-135m", {"spec_mode": "self"}),
         "mamba2": ("mamba2-370m", {}),
         "xlstm": ("xlstm-125m", {}),
         "zamba2": ("zamba2-2.7b", {})}
RECURRENT = ("mamba2", "xlstm", "zamba2")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


@pytest.fixture(scope="module")
def models():
    """arch -> {"j": (JAX model, params), "t": (port model, bridged
    params)}, made on first use; one vocabulary for every model."""
    vocab = min(jget(a).reduced().vocab_size
                for a in {CLOUD, *(e for e, _ in PATHS.values())})
    made = {}

    def get(arch):
        if arch not in made:
            j = jget(arch).reduced().replace(vocab_size=vocab)
            t = tget(arch).reduced().replace(vocab_size=vocab)
            jp = JModel(j).init(jax.random.PRNGKey(int(arch == CLOUD)))
            made[arch] = {"j": (JModel(j), jp),
                          "t": (TModel(t), params_from_numpy(_host(jp), t,
                                                             "cpu"))}
        return made[arch]
    get.vocab = vocab
    return get


def _prompts(vocab, n, length=8):
    return [((np.arange(length) * 7 + 3 * i) % vocab).astype(np.int32)
            for i in range(n)]


def _ptrs(caches):
    """The data_ptr of every state leaf (``pos`` aside: it is copied into
    a graph's own buffer, never addressed)."""
    return tuple(t.data_ptr() for k in sorted(caches)
                 if k not in ("pos", VIEW) for t in tree_leaves(caches[k]))


def _key(traces):
    return [(t.path, t.tokens, t.edge_calls, t.cloud_passes) for t in traces]


@pytest.fixture(scope="module")
def engines(models):
    """path -> {"j": JAX engine, "t": port engine}, made on first use and
    kept, so that the tick and round test reuses the JAX engine's compiled
    tick and round."""
    made = {}

    def get(name):
        if name not in made:
            arch, kw = PATHS[name]
            made[name] = {}
            for s, Engine, Pol in (("j", JEngine, JPol), ("t", TEngine, TPol)):
                (em, _), (cm, _) = models(arch)[s], models(CLOUD)[s]
                made[name][s] = Engine(em, cm, batch_size=4, gamma=4,
                                       temperature=0.0, policy=Pol(-1.0),
                                       use_cache=False, tick_tokens=4, **kw)
        return made[name]
    return get


@pytest.mark.parametrize("name", list(PATHS))
def test_drains_and_waves_reuse_state_buffers_and_match_jax(
        models, engines, monkeypatch, name):
    """Eight requests on four slots, every one escalating: each drain runs
    two escalation waves of the same shape.  The second wave's group
    states, and every state of the second drain, sit in the first's
    buffers (the same ``data_ptr`` of every leaf), both drains give JAX's
    traces, and the rounds' rules read "captured" for a CUDA device."""
    arch, _ = PATHS[name]
    prompts = _prompts(models.vocab, 8)
    made = []
    orig = TLane.make_state

    def spy(self, *a, **k):
        st = orig(self, *a, **k)
        made.append((self.model.cfg.name, st.layout, _ptrs(st.caches)))
        return st

    traces = {}
    for s in "jt":
        if s == "t":
            monkeypatch.setattr(TLane, "make_state", spy)
        eng = engines(name)[s]
        ep, cp = models(arch)[s][1], models(CLOUD)[s][1]
        traces[s] = [_key(eng.serve_batch(ep, cp, prompts, 6))
                     for _ in range(2)]
    assert traces["t"] == traces["j"]
    assert all(p == "speculative" for d in traces["t"] for p, *_ in d)
    # per drain: the edge's state, then the group states of two waves
    # (draft and target; the self lane's one shared state)
    per_wave = 1 if name == "self" else 2
    n = 1 + 2 * per_wave
    assert len(made) == 2 * n
    first, second = made[:n], made[n:]
    assert second == first
    assert first[1 + per_wave:] == first[1:1 + per_wave]
    if name in RECURRENT:
        assert first[0][1] == first[1][1] == "recurrent"
    st = eng.stats()
    assert st["graphs"] == {
        **dict.fromkeys(("edge", "cloud", "spec", "cloud prefill"),
                        "eager (cpu: no graphs)"),
        "edge prefill": "eager (recurrent prefill: exact length)"
        if name in RECURRENT else "eager (cpu: no graphs)"}
    assert eng.spec.graph_rule("cuda") == eng.edge.graph_rule("cuda") \
        == "captured"


def _jax_slot_layers(name, caches):
    """A JAX stacked slot state's recurrent layers in the port's layout:
    one entry per layer, slot axis first (JAX stacks the slots on a
    leading axis of the single-sequence caches, whose layers it stacks
    too)."""
    if name == "mamba2":
        L = jax.tree.leaves(caches["layers"])[0].shape[1]
        return [jax.tree.map(lambda x: x[:, l, 0], caches["layers"])
                for l in range(L)]
    if name == "zamba2":
        G, K = jax.tree.leaves(caches["mamba"])[0].shape[1:3]
        return [jax.tree.map(lambda x: x[:, g, k, 0], caches["mamba"])
                for g in range(G) for k in range(K)]
    return [jax.tree.map(lambda x: x[:, 0], st) for st in caches["layers"]]


def _same_state(name, jc, tc, rows):
    """The port's state ``tc`` against JAX's ``jc`` on slot rows
    ``rows``: every recurrent leaf within ``TOL``, ``pos``, and the
    hybrid's committed K/V rows."""
    key = "mamba" if name == "zamba2" else "layers"
    for jl, tl in zip(_jax_slot_layers(name, jc), tc[key]):
        for a, b in zip(jax.tree.leaves(jl), tree_leaves(tl)):
            np.testing.assert_allclose(b.numpy()[rows], np.asarray(a)[rows],
                                       atol=TOL, rtol=TOL)
    pos = np.asarray(jc["pos"]).reshape(-1)
    np.testing.assert_array_equal(tc["pos"].numpy()[rows], pos[rows])
    if name == "zamba2":
        for b in rows:
            for slab in ("k", "v"):
                np.testing.assert_allclose(
                    tc[slab][:, b, :pos[b]].numpy(),
                    np.asarray(jc[slab])[b, :, 0, :pos[b]],
                    atol=TOL, rtol=TOL)


def _states(lane, params, prompts, slot_len):
    st = lane.make_state(params, len(prompts), slot_len)
    for i, p in enumerate(prompts):
        st.admit(i, p, len(p) - 1 + 12)
    st.flush()
    return st


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_tick_and_round_write_state_in_place(models, engines,
                                                       name):
    """A recurrent edge's 4-step tick (budgets 4, 2, 4, 1) and a linear
    round over it (one slot frozen), through the served engines' lanes
    and decoders at their drain's shapes, against JAX's: the tapes,
    acceptances and tokens equal, every state leaf at its own
    ``data_ptr`` after each, and the state within ``TOL`` of JAX's after
    the same steps."""
    arch, _ = PATHS[name]
    eng = engines(name)
    prompts = _prompts(models.vocab, 4)
    for s in "jt":      # a drain: the JAX side's compiled shapes
        eng[s].serve_batch(models(arch)[s][1], models(CLOUD)[s][1],
                           prompts, 6)
    (jp, tp), (jcp, tcp) = ((models(a)["j"][1], models(a)["t"][1])
                            for a in (arch, CLOUD))
    je, te = eng["j"], eng["t"]
    slot_len = te._slot_len
    last = np.array([[[p[-1]]] for p in prompts], np.int32)
    js = _states(je.edge, jp, prompts, slot_len)
    ts = _states(te.edge, tp, prompts, slot_len)
    ptrs = _ptrs(ts.caches)
    steps = np.array([4, 2, 4, 1], np.int32)
    jout = je.edge._chunk(jp, js.caches, jnp.asarray(last),
                          jnp.asarray(steps), jnp.zeros(4, jnp.float32),
                          jax.random.PRNGKey(0), jnp.int32(-1), n_steps=4)
    gen = torch.Generator().manual_seed(0)
    tout = te.edge.chunk(tp, ts.caches, torch.from_numpy(last),
                         torch.from_numpy(steps), torch.zeros(4), gen,
                         torch.tensor(-1, dtype=torch.int32), n_steps=4)
    for a, b in zip(jout[4:], tout[4:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert _ptrs(tout[0]) == ptrs
    _same_state(name, jout[0], tout[0], range(4))

    # a linear round: the recurrent draft, the dense granite target
    jd, td = (_states(je.edge, jp, prompts, slot_len),
              _states(te.edge, tp, prompts, slot_len))
    jt, tt = (_states(je.cloud, jcp, prompts, slot_len),
              _states(te.cloud, tcp, prompts, slot_len))
    ptrs = _ptrs(td.caches), _ptrs(tt.caches)
    active = np.array([True, True, False, True])
    jr = je.spec._round(jp, jcp, jd.caches, jt.caches, jnp.asarray(last),
                        jnp.asarray(active), jax.random.PRNGKey(1))
    tr = te.spec._round(tp, tcp, td.caches, tt.caches,
                        torch.from_numpy(last), torch.from_numpy(active),
                        gen)
    for a, b in zip(jr[2:], tr[2:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert (_ptrs(tr[0]), _ptrs(tr[1])) == ptrs
    _same_state(name, jr[0], tr[0], range(4))


def test_captured_bodies_are_registered_and_linted():
    """The tree, self and linear rounds and the tick (the recurrent
    layout's too: one body per lane) are registered captured functions,
    and R2 scans their bodies: a host-to-device constructor slipped into
    each is a finding."""
    seen = {}
    for rel, bodies in (("core/speculative.py",
                         ("_linear_round", "_tree_round", "_self_body")),
                        ("core/seq_state.py", ("_chunk_body",))):
        path = REPO / "src" / "repro_torch" / rel
        src = path.read_text()
        ctx = ModuleContext(str(path), src)
        seen.update({fn.name: s for fn, s in ctx.capture_static.items()})
        assert analyze_source(str(path), src, rules=["R2"]) == []
        for body in bodies:
            bad, n = re.subn(
                rf"(def {body}\([^)]*\):\n(?:.*\n)*?        \"\"\"(?:.*\n)*?"
                r".*\"\"\"\n)",
                r"\1        torch.as_tensor(0)\n", src, count=1)
            assert n == 1, body
            found = analyze_source(str(path), bad, rules=["R2"])
            assert [f.rule for f in found] == ["R2"], body
            assert "as_tensor" in found[0].message
    assert set(seen) == {"_linear_round", "_tree_round", "_self_body",
                         "_chunk_body", "_prefill_body", "_extend_body"}
