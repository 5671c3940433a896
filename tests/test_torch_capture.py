"""The compiled serving tick's host side, on the CPU, against the JAX
package: state buffers reused across drains and escalation waves
(``Lane.make_state`` / ``Lane.release``, which keep the CUDA graphs of
``core/capture.py`` valid), adaptation swaps landing in place in the
served edge parameters, and the capture helper's CPU contract.

Both engines serve the reduced smollm-135m edge and granite-8b cloud (the
JAX init, bridged into the port), f32, T = 0: tokens and paths must be
JAX's exactly.  On the CPU the helper runs every call eagerly (the CPU has
no graphs); the graphs themselves are held on the card
(``tests/test_torch_cuda.py``, slice 19).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.core.adaptation import AdaptationLoop as JLoop  # noqa: E402
from repro.core.policy import SpeculativePolicy as JSpec  # noqa: E402
from repro.core.scheduler import BatchedEngine as JEngine  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.training.optimizer import AdamW as JAdamW  # noqa: E402
from repro_torch.analysis.compile_guard import CaptureCounter  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.adaptation import AdaptationLoop as TLoop  # noqa
from repro_torch.core.capture import capture  # noqa: E402
from repro_torch.core.policy import SpeculativePolicy as TSpec  # noqa: E402
from repro_torch.core.scheduler import BatchedEngine as TEngine  # noqa
from repro_torch.core.seq_state import Lane  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
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


def _engine(side, pair, threshold, adapt=None, **kw):
    edge, _, cloud, _ = pair[side]
    Engine, Pol = (JEngine, JSpec) if side == "j" else (TEngine, TSpec)
    return Engine(edge, cloud, batch_size=4, temperature=0.0,
                  policy=Pol(threshold), use_cache=False, tick_tokens=4,
                  adaptation=adapt, **kw)


def _traces(traces):
    return [(t.path, t.tokens) for t in traces]


@pytest.mark.parametrize("kv_layout", ["paged", "dense"])
def test_drains_and_waves_reuse_state_buffers_and_match_jax(
        pair, monkeypatch, kv_layout):
    """Eight requests on four slots, every one escalating: each drain runs
    two escalation waves of the same shape.  The second wave's group
    states, and every state of the second drain, sit in the first's
    buffers (same ``data_ptr`` of K and V), and both drains give JAX's
    tokens and paths."""
    prompts = _prompts(pair["t"][0].cfg.vocab_size, 8)
    want = []
    eng = _engine("j", pair, -1.0, kv_layout=kv_layout)
    _, ep, _, cp = pair["j"]
    for _ in range(2):
        want.append(_traces(eng.serve_batch(ep, cp, prompts, 6)))
    made = []
    orig = Lane.make_state

    def spy(self, *a, **kw):
        st = orig(self, *a, **kw)
        made.append((self.model.cfg.name, st.layout,
                     st.caches["k"].data_ptr(), st.caches["v"].data_ptr()))
        return st

    monkeypatch.setattr(Lane, "make_state", spy)
    eng = _engine("t", pair, -1.0, kv_layout=kv_layout)
    _, ep, _, cp = pair["t"]
    got = []
    for _ in range(2):
        got.append(_traces(eng.serve_batch(ep, cp, prompts, 6)))
    assert got == want
    assert all(p == "speculative" for d in got for p, _ in d)
    # per drain: the edge's state, then (draft, target) per wave
    assert len(made) == 2 * 5
    first, second = made[:5], made[5:]
    assert second == first
    assert first[3:5] == first[1:3]             # wave 2 reuses wave 1's
    assert len({m[2] for m in first}) == 3      # edge, draft, target


def test_adaptation_swaps_land_in_place_and_match_jax(pair):
    """A distill loop swapping at the start of drains 2 and 3: the served
    edge parameters keep their buffers (the swap is a copy into them), the
    caller's parameters are never written, and every drain gives JAX's
    tokens and paths."""
    kw = dict(mode="distill", interval=6, batch_size=4, seq_len=16, topk=4,
              min_records=1)
    prompts = _prompts(pair["t"][0].cfg.vocab_size, 6)
    traces = {}
    for side, Loop, AdamW in (("j", JLoop, JAdamW), ("t", TLoop, TAdamW)):
        loop = Loop(opt=AdamW(lr=1e-3, eps=1e-3), **kw)
        eng = _engine(side, pair, 0.0, adapt=loop)
        _, ep, _, cp = pair[side]
        if side == "t":
            before = [t.clone() for t in T.tensors(ep)]
        out, ptrs, vals = [], [], []
        for _ in range(3):
            out.append(_traces(eng.serve_batch(ep, cp, prompts, 5)))
            if side == "t":
                served = T.tensors(eng._served)
                ptrs.append([t.data_ptr() for t in served])
                vals.append(served[0].clone())
        traces[side] = out
        assert loop.swaps == 2
    assert traces["t"] == traces["j"]
    assert ptrs[0] == ptrs[1] == ptrs[2]
    assert not torch.equal(vals[0], vals[1])    # the swaps landed
    assert all(torch.equal(a, b) for a, b in zip(before, T.tensors(ep)))


def test_graph_rules_in_stats(pair):
    """``stats()`` names how each tick and round runs, and counts the
    captures: on the CPU everything runs eager, by the device's rule."""
    edge, ep, cloud, cp = pair["t"]
    prompts = _prompts(edge.cfg.vocab_size, 2)
    eng = _engine("t", pair, -1.0)
    eng.serve_batch(ep, cp, prompts, 3)
    st = eng.stats()
    assert st["captures"] == {"edge": 0, "cloud": 0, "spec": 0}
    assert st["graphs"] == dict.fromkeys(
        ("edge", "cloud", "spec", "edge prefill", "cloud prefill"),
        "eager (cpu: no graphs)")
    tree = _engine("t", pair, -1.0, spec_mode="tree", kv_layout="dense",
                   graphs=False)
    assert tree.edge.graph_rule() == "eager (graphs=False)"
    assert tree.spec.graph_rule() == "eager (graphs=False)"
    rec = Lane(TModel(tget("mamba2-370m").reduced()), "entropy", 0.0,
               layout="recurrent")
    assert rec.graph_rule("cuda") == "captured"
    assert eng.edge.graph_rule("cuda") == "captured"
    assert rec.prefill_rule("cuda") == \
        "eager (recurrent prefill: exact length)"
    assert eng.edge.prefill_rule("cuda") == "captured"
    assert tree.edge.prefill_rule() == "eager (graphs=False)"


def test_capture_helper_on_the_cpu():
    """The helper's contract off the card: a CPU call runs the function
    eagerly and captures nothing; a Python number in a traced argument, a
    copied argument that is no tensor, and a call across two devices
    raise."""
    def body(x, pools, stop, n):
        return {"y": torch.where(x == stop, 0, x) * n, "pools": pools}

    fn = capture(body, static_argnames=("n",), copy_argnames=("x", "stop"),
                 name="body")
    x = torch.arange(4)
    pools = {"k": torch.ones(3)}
    with CaptureCounter() as cc:
        out = fn(x, pools, torch.tensor(2), n=3)
    assert torch.equal(out["y"], torch.tensor([0, 3, 0, 9]))
    assert out["pools"]["k"] is pools["k"]
    assert cc.count == 0 and fn.captures == 0
    with pytest.raises(TypeError, match="Python number"):
        fn(x, {"k": 1.0}, torch.tensor(2), n=3)
    with pytest.raises(TypeError, match="must be a tensor"):
        fn(x, pools, 2, n=3)
    with pytest.raises(ValueError, match="one device"):
        fn(x, {"k": torch.ones(3, device="meta")}, torch.tensor(2), n=3)
    with pytest.raises(ValueError, match="no argument"):
        capture(body, static_argnames=("m",))


def test_launch_counts_take_a_replays_launches():
    """``ops.add_launch_counts`` adds (and takes back) launches per kernel
    and per backward route, as a replayed graph reports them."""
    ops.reset_launch_counts()
    delta = {"paged_decode_attention": 3, "spec_verify": 1,
             "flash_attention_bwd/wgmma": 2}
    ops.add_launch_counts(delta)
    got = ops.launch_counts()
    assert {k: got[k] for k in delta} == delta
    assert sum(got.values()) == 6
    ops.add_launch_counts({k: -n for k, n in delta.items()})
    assert not any(ops.launch_counts().values())
