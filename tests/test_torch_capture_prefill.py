"""The bounded spare states and graphs, and the captured admission prefill
and chunked-prefill extend, on the CPU against the JAX package.

On the card a lane's prefills and extends run as CUDA graphs
(``core/capture.py``) keyed on the buffers they address, and every lane
keeps at most ``MAX_SPARE_STATES`` released states and
``MAX_SPARE_DETACHED`` detached prefill caches (``SparePool``), dropping
with each the graphs keyed on its buffers (``capture.evict``), while each
captured function keeps at most ``MAX_GRAPHS`` graphs.  Here that shows
as: one engine serving drains of ever new prompt lengths gives JAX's
``BatchedEngine``'s tokens, paths, edge calls and cloud passes drain by
drain while no lane holds more than its bound; a chunked prefill's jobs
share a few detached buffers; the bookkeeping of the bounds drops exactly
what it should (stand-in graphs, no card needed); and the prefill and
extend bodies are captured functions that R2 scans.  Models: the reduced
smollm-135m edge (paged linear and dense tree lanes) and the reduced
mamba2-370m edge (recurrent, linear lane) with the reduced granite-8b
cloud, the JAX init bridged by ``bridge.params_from_numpy``, float32,
T = 0.  The graphs themselves are held on the card
(``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path
from types import SimpleNamespace

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
from repro_torch.core import capture as C  # noqa: E402
from repro_torch.core.policy import SpeculativePolicy as TPol  # noqa: E402
from repro_torch.core.scheduler import BatchedEngine as TEngine  # noqa
from repro_torch.core.seq_state import (MAX_SPARE_DETACHED,  # noqa: E402
                                        MAX_SPARE_STATES, Lane, SparePool)
from repro_torch.models import Model as TModel  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CLOUD = "granite-8b"
# served path -> (edge arch, engine settings).  Every escalation group
# admits its prompts whole (``Lane.prefill``); the paged and tree paths'
# edges admit prompts of more than 4 entries chunked (``advance_prefill``)
PATHS = {"paged": ("smollm-135m", {"prefill_chunk": 4}),
         "tree": ("smollm-135m", {"spec_mode": "tree", "kv_layout": "dense",
                                  "prefill_chunk": 4}),
         "mamba2": ("mamba2-370m", {"prefill_chunk": 0})}
# one drain per entry: its prompts' lengths, distinct from drain to drain,
# and its new tokens; three drains in a row share a slot_len (the longest
# prompt plus the new tokens), so JAX compiles two sets of shapes
DRAINS = (((9, 5), 3), ((6, 9), 3), ((9, 4), 3),
          ((14, 7), 3), ((10, 14), 3), ((14, 12), 3))
BATCH = 2


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


def _prompts(vocab, lengths, salt):
    return [((np.arange(n) * 7 + 3 * i + salt) % vocab).astype(np.int32)
            for i, n in enumerate(lengths)]


def _key(traces):
    return [(t.path, t.tokens, t.edge_calls, t.cloud_passes) for t in traces]


def _engine(side, models, name, **kw):
    arch, settings = PATHS[name]
    Engine, Pol = (JEngine, JPol) if side == "j" else (TEngine, TPol)
    (em, _), (cm, _) = models(arch)[side], models(CLOUD)[side]
    return Engine(em, cm, batch_size=BATCH, gamma=3, temperature=0.0,
                  policy=Pol(-1.0), use_cache=False, tick_tokens=4,
                  **{**settings, **kw})


def _lanes(eng):
    """Every lane of a port engine that holds states (dense sides too)."""
    return list({id(x): x for x in (eng.edge, eng.cloud, eng._spec_edge,
                                    eng._spec_cloud)}.values())


def _bounded(eng):
    for lane in _lanes(eng):
        assert lane.spare_states <= MAX_SPARE_STATES
        assert lane.spare_detached <= MAX_SPARE_DETACHED


@pytest.mark.parametrize("name", list(PATHS))
def test_distinct_length_drains_match_jax_within_the_bounds(models,
                                                            monkeypatch,
                                                            name):
    """Six drains in a row, each of its own prompt lengths, every request
    escalating: the port's traces equal JAX's drain by drain and no lane
    ever holds more than ``MAX_SPARE_STATES`` released states or
    ``MAX_SPARE_DETACHED`` detached caches.  A drain of a seen slot_len
    reuses the states of the drain before it (no new buffers); the chunked
    edge's jobs write a few detached buffers, reused across drains (paged:
    one 32-entry block whatever the prompt, at most one per slot)."""
    arch, _ = PATHS[name]
    je, te = _engine("j", models, name), _engine("t", models, name)
    bufs, keys = set(), []
    advance, make = Lane.advance_prefill, Lane.make_state

    def spy_advance(self, params, job):
        done = advance(self, params, job)
        if "buffers" in job:
            bufs.add(job["buffers"][2]["k"].data_ptr())
        return done

    def spy_make(self, *a, **k):
        st = make(self, *a, **k)
        if self is te.edge:
            keys.append(st.reuse_key)
        return st

    monkeypatch.setattr(Lane, "advance_prefill", spy_advance)
    monkeypatch.setattr(Lane, "make_state", spy_make)
    (jep, tep), (jcp, tcp) = ((models(a)["j"][1], models(a)["t"][1])
                              for a in (arch, CLOUD))
    made, seen = [0], set()
    for d, (lengths, new) in enumerate(DRAINS):
        prompts = _prompts(models.vocab, lengths, d)
        jt = _key(je.serve_batch(jep, jcp, prompts, new))
        tt = _key(te.serve_batch(tep, tcp, prompts, new))
        assert tt == jt, f"drain {d}"
        assert all(p == "speculative" for p, *_ in tt)
        _bounded(te)
        made.append(te.edge._spare._made)
        # the edge lane makes new buffers only for a shape it has not seen
        if made[-1] > made[-2]:
            assert not seen.issuperset(keys), f"drain {d}"
        seen.update(keys)
        keys.clear()
    assert made[3] == made[2]       # the third drain of a slot_len
    if name == "mamba2":
        assert not bufs and te.edge._detached._made == 0
    else:
        assert 0 < len(bufs) == te.edge._detached._made <= \
            (BATCH if name == "paged" else 2 * BATCH)
    st = te.stats()
    rule = "eager (recurrent prefill: exact length)" if name == "mamba2" \
        else "eager (cpu: no graphs)"
    assert st["graphs"]["edge prefill"] == rule
    assert st["graphs"]["cloud prefill"] == "eager (cpu: no graphs)"


@pytest.mark.parametrize("name", ["paged", "tree"])
def test_bounds_fill_and_evict_without_changing_a_token(models, name):
    """Twelve drains of ever new slot_lens on one engine: every lane keeps
    at most its bound of spare states and detached caches, the edge lane
    fills both bounds and drops the least recently used, and each drain's
    traces equal those of a fresh engine, which has no spares to reuse."""
    arch, _ = PATHS[name]
    te = _engine("t", models, name)
    ep, cp = models(arch)["t"][1], models(CLOUD)["t"][1]
    for d in range(12):
        prompts = _prompts(models.vocab, (6 + d, 7 + d), d)
        tt = _key(te.serve_batch(ep, cp, prompts, 2))
        assert tt == _key(_engine("t", models, name).serve_batch(
            ep, cp, prompts, 2)), f"drain {d}"
        _bounded(te)
    assert te.edge._spare._made == 24
    assert te.edge.spare_states == MAX_SPARE_STATES
    if name == "tree":      # dense detached caches are slot_len long
        assert te.edge._detached._made == 24
        assert te.edge.spare_detached == MAX_SPARE_DETACHED
    else:                   # paged ones one block, for every drain
        assert te.edge._detached._made <= BATCH


def _stand_in(*tensors):
    """A stand-in graph addressing ``tensors``' storages."""
    return SimpleNamespace(storages=frozenset(C._storage(t) for t in tensors))


def test_captured_bound_and_eviction_bookkeeping():
    """A ``Captured`` never holds more than ``MAX_GRAPHS`` graphs, drops
    the least recently used first (a lookup makes a key the most recent),
    and ``capture.evict`` drops, in every live ``Captured``, exactly the
    graphs whose key addresses a storage of the given tensors, a view of
    one included."""
    a = C.capture(lambda x: x, name="a")
    b = C.capture(lambda x: x, name="b")
    assert a in C._LIVE and b in C._LIVE
    bufs = [torch.zeros(8) for _ in range(4)]
    n = C.MAX_GRAPHS + 5
    for i in range(n):
        a._keep(("k", i), _stand_in(bufs[i % 4]))
        assert a.live_graphs <= C.MAX_GRAPHS
        if i == C.MAX_GRAPHS - 1:      # full: 0 becomes the newest
            assert a._lookup(("k", 0)) is not None
    assert a.live_graphs == C.MAX_GRAPHS
    kept = [k[1] for k in a._graphs]
    # the five least recently used went: 1 to 5, not 0
    assert kept == list(range(6, C.MAX_GRAPHS)) + [0] + \
        list(range(C.MAX_GRAPHS, n))
    assert a.dropped == n - C.MAX_GRAPHS
    assert a._lookup(("k", 1)) is None
    b._keep("only", _stand_in(bufs[1], torch.zeros(2)))
    b._keep("other", _stand_in(bufs[2]))
    # a view of bufs[1] shares its storage
    gone = C.evict([bufs[1][2:5], torch.zeros(3)])
    want = [i for i in kept if i % 4 == 1]
    assert gone == len(want) + 1
    assert [k[1] for k in a._graphs] == [i for i in kept if i % 4 != 1]
    assert list(b._graphs) == ["other"]
    assert C.evict([]) == 0


def test_spare_pool_reuses_first_made_and_evicts_least_recent():
    """``SparePool`` hands out the first-made spare of a key whatever
    order the spares came back in, keeps at most its bound (the least
    recently given back dropped first), and a dropped spare's graphs go
    with it (``capture.evict``)."""
    pool = SparePool(3)
    fn = C.capture(lambda x: x, name="pool graphs")
    bufs = {}
    for want in range(3):
        i, got = pool.take(("s", 1))
        assert (i, got) == (want, None)
        bufs[i] = {"k": torch.zeros(4), "pos": torch.zeros(())}
        fn._keep(("g", i), _stand_in(bufs[i]["k"]))
    for i in (2, 0, 1):                 # back in another order
        pool.give(("s", 1), i, bufs[i])
    i, got = pool.take(("s", 1))
    assert i == 0 and got is bufs[0]
    pool.give(("s", 1), 0, got)
    assert pool.take(("s", 2)) == (3, None)
    pool.give(("s", 2), 3, {"k": torch.zeros(2)})
    assert len(pool) == 3
    # the least recently given back (2) went, with its graph
    assert [k for k, _ in pool._held.items()] == [1, 0, 3]
    assert list(fn._graphs) == [("g", 0), ("g", 1)]


def test_prefill_and_extend_bodies_are_captured_and_linted():
    """``Lane._prefill_body`` and ``Lane._extend_body`` are registered
    captured functions (their statics: ``max_seq``; none), R2 passes on
    the module, and a host-to-device constructor slipped into either body
    is a finding; the tokens' host-to-device copies stay outside them."""
    path = REPO / "src" / "repro_torch" / "core" / "seq_state.py"
    src = path.read_text()
    ctx = ModuleContext(str(path), src)
    seen = {fn.name: s for fn, s in ctx.capture_static.items()}
    assert seen["_prefill_body"] == {"max_seq"}
    assert seen["_extend_body"] == set()
    assert analyze_source(str(path), src, rules=["R2"]) == []
    for body in ("_prefill_body", "_extend_body"):
        bad, n = re.subn(
            rf"(def {body}\([^)]*\):\n(?:.*\n)*?        \"\"\"(?:.*\n)*?"
            r".*\"\"\"\n)",
            r"\1        torch.as_tensor(0)\n", src, count=1)
        assert n == 1, body
        found = analyze_source(str(path), bad, rules=["R2"])
        assert [f.rule for f in found] == ["R2"], body
        assert "as_tensor" in found[0].message
