"""The port's BatchedEngine vs the JAX package's, on bridged parameters.

Both engines serve the same prompts (``SyntheticLM``, as ``serve.py`` makes
them) with the JAX init of the reduced smollm-135m edge and granite-8b
cloud, bridged into the port; the port runs on the CPU.  Every request must
get identical ``tokens``, ``path``, ``edge_calls`` and ``cloud_passes``
(greedy decoding, T = 0), and the speculation counters must agree.  The
cases cover the serve defaults (paged KV, SpeculativePolicy(0.6), linear
lane), the dense layout, pure-edge serving (threshold 1.1), the cloud and
skeleton escalations, an edge that drafts with the cloud's own weights
(every draft accepted, on the linear and on the tree lane), chunked
prefill with preemption by swap, and the tree lane (on paged serving with
dense side groups, and on dense serving) and the self lane.  Each recurrent
edge family (mamba2, xLSTM, zamba2) drafts for the same cloud on the
recurrent layout, and a recurrent cloud verifies for the dense edge.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.core.paged_cache import BlockPool as JPool  # noqa: E402
from repro.core.scheduler import BatchedEngine as JEngine  # noqa: E402
from repro.data import SyntheticLM  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.core.paged_cache import BlockPool as TPool  # noqa: E402
from repro_torch.core.scheduler import BatchedEngine as TEngine  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402


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
            "vocab": je.vocab_size}


def _prompts(vocab, n=8, length=16, lengths=None):
    synth = SyntheticLM(vocab)
    rng = np.random.default_rng(0)
    lengths = lengths or [length] * n
    return [synth.sample(rng, i % synth.n_domains, L)
            for i, L in enumerate(lengths)]


CASES = {
    "serve_defaults": dict(policy=("SpeculativePolicy", 0.6)),
    "dense_layout": dict(policy=("SpeculativePolicy", 0.6),
                         kv_layout="dense"),
    "pure_edge": dict(policy=("SpeculativePolicy", 1.1)),
    "cloud_escalation": dict(policy=("ThresholdPolicy", 0.6)),
    "skeleton_escalation": dict(policy=("SkeletonPolicy", 0.6),
                                max_new=12),
    "chunked_prefill_and_swap": dict(
        policy=("SpeculativePolicy", 1.1), kv_blocks=9, batch_size=4,
        lengths=[40, 12, 36, 20, 44, 16]),
    "tree_lane": dict(policy=("SpeculativePolicy", 0.6), spec_mode="tree"),
    "tree_lane_dense": dict(policy=("SpeculativePolicy", 0.6),
                            spec_mode="tree", kv_layout="dense"),
    "self_lane": dict(policy=("SpeculativePolicy", 0.6), spec_mode="self"),
}


def _serve(side, setup, case, edge_is_cloud=False):
    em, cm, ep, cp = setup[side]
    if edge_is_cloud:
        em, ep = cm, cp
    pol_mod = jpol if side == "j" else tpol
    Engine = JEngine if side == "j" else TEngine
    name, thr = case["policy"]
    eng = Engine(em, cm, batch_size=case.get("batch_size", 8), gamma=4,
                 temperature=0.0,
                 policy=getattr(pol_mod, name)(threshold=thr),
                 kv_layout=case.get("kv_layout", "auto"),
                 kv_blocks=case.get("kv_blocks"),
                 spec_mode=case.get("spec_mode"))
    prompts = _prompts(setup["vocab"], lengths=case.get("lengths"))
    traces = eng.serve_batch(ep, cp, prompts, case.get("max_new", 24))
    return traces, eng.stats()


def _assert_same(jt, tt):
    assert len(jt) == len(tt)
    for i, (a, b) in enumerate(zip(jt, tt)):
        assert (a.path, a.edge_calls, a.cloud_passes) == \
            (b.path, b.edge_calls, b.cloud_passes), i
        assert a.tokens == b.tokens, i


@pytest.mark.parametrize("name", list(CASES))
def test_engine_traces_match_jax(setup, name):
    case = CASES[name]
    jt, js = _serve("j", setup, case)
    tt, ts = _serve("t", setup, case)
    _assert_same(jt, tt)
    assert js["spec_lanes"] == ts["spec_lanes"]
    for key in ("preemptions", "kv_swaps", "kv_blocks_peak",
                "kv_prefix_hits", "cache_hit_rate"):
        assert js.get(key) == ts.get(key), key
    if name == "chunked_prefill_and_swap":
        assert ts["preemptions"] > 0      # the case does exercise the swap


def test_engine_full_acceptance_matches_jax(setup):
    """Edge drafting with the cloud's own weights: every draft is accepted
    (gamma + 1 tokens per verify), on both engines alike."""
    case = CASES["serve_defaults"]
    jt, js = _serve("j", setup, case, edge_is_cloud=True)
    tt, ts = _serve("t", setup, case, edge_is_cloud=True)
    _assert_same(jt, tt)
    c = ts["spec_lanes"]["linear"]
    assert c["accepted_tokens"] == c["draft_tokens"] > 0
    assert js["spec_lanes"] == ts["spec_lanes"]


def test_engine_tree_full_acceptance_matches_jax(setup):
    """The tree lane with the cloud's own weights drafting: every round
    accepts a whole root path (``depth`` tokens, plus the bonus token), on
    both engines alike."""
    case = CASES["tree_lane"]
    jt, js = _serve("j", setup, case, edge_is_cloud=True)
    tt, ts = _serve("t", setup, case, edge_is_cloud=True)
    _assert_same(jt, tt)
    c = ts["spec_lanes"]["tree"]
    assert c["accepted_tokens"] == 4 * c["member_rounds"] > 0
    assert js["spec_lanes"] == ts["spec_lanes"]


RECURRENT = {"ssm": "mamba2-370m", "xlstm": "xlstm-125m",
             "hybrid": "zamba2-2.7b"}
STAGGERED = [10, 16, 7, 13]
# per recurrent edge family: speculative escalation over staggered prompt
# lengths (more requests than slots) with chunked prefill, asking for a
# lane the family cannot serve (it falls back to linear); cloud and
# skeleton escalations
RCASES = {
    "speculative": dict(policy=("SpeculativePolicy", 0.6), prefill_chunk=6,
                        lengths=STAGGERED, batch_size=2, max_new=8),
    "cloud_escalation": dict(policy=("ThresholdPolicy", 0.6),
                             lengths=STAGGERED[:3], batch_size=2, max_new=8),
    "skeleton_escalation": dict(policy=("SkeletonPolicy", 0.6), max_new=10,
                                lengths=STAGGERED[:3], batch_size=2),
}
FALLBACK = {"ssm": "tree", "xlstm": "self", "hybrid": "tree"}


@pytest.fixture(scope="module")
def rec_models(setup):
    """JAX and bridged port models of each reduced recurrent edge (vocab
    512, as the granite cloud of ``setup``)."""
    out = {}
    for fam, arch in RECURRENT.items():
        je, te = _pair(jget, arch), _pair(tget, arch)
        jcfg, tcfg = je[0], te[0]
        jp = JModel(jcfg).init(jax.random.PRNGKey(0))
        out[fam] = {"j": (JModel(jcfg), jp),
                    "t": (TModel(tcfg), params_from_numpy(_host(jp), tcfg,
                                                          "cpu"))}
    return out


def _serve_pair(side, edge, cloud, case, vocab, spec_mode=None):
    (em, ep), (cm, cp) = edge[side], cloud[side]
    pol_mod = jpol if side == "j" else tpol
    Engine = JEngine if side == "j" else TEngine
    name, thr = case["policy"]
    eng = Engine(em, cm, batch_size=case.get("batch_size", 8), gamma=4,
                 temperature=0.0,
                 policy=getattr(pol_mod, name)(threshold=thr),
                 prefill_chunk=case.get("prefill_chunk"),
                 spec_mode=spec_mode)
    prompts = _prompts(vocab, lengths=case.get("lengths"))
    return eng.serve_batch(ep, cp, prompts, case.get("max_new", 10)), \
        eng.stats()


@pytest.mark.parametrize("family", list(RECURRENT))
@pytest.mark.parametrize("name", list(RCASES))
def test_recurrent_edge_traces_match_jax(setup, rec_models, family, name):
    """A recurrent edge (dense layout resolved from ``auto``, rewinds by
    batched replay) drafting for the granite cloud: identical traces and
    speculation counters on both engines."""
    case = RCASES[name]
    cloud = {s: (setup[s][1], setup[s][3]) for s in "jt"}
    mode = FALLBACK[family] if name == "speculative" else None
    jt, js = _serve_pair("j", rec_models[family], cloud, case,
                         setup["vocab"], mode)
    tt, ts = _serve_pair("t", rec_models[family], cloud, case,
                         setup["vocab"], mode)
    _assert_same(jt, tt)
    assert js["spec_lanes"] == ts["spec_lanes"]
    assert ts["spec_mode"] == js["spec_mode"] == "linear"
    assert ts["kv_layout"] == js["kv_layout"] == "dense"
    if name == "speculative":
        assert ts["spec_lanes"]["linear"]["member_rounds"] > 0


def test_recurrent_cloud_side_replay_matches_jax(setup, rec_models):
    """A recurrent CLOUD (the dense edge drafting for the hybrid verifier):
    the target-side rewind is the replay, on both engines alike."""
    case = dict(policy=("SpeculativePolicy", -1.0), lengths=[8, 6],
                batch_size=2)
    edge = {s: (setup[s][0], setup[s][2]) for s in "jt"}
    jt, js = _serve_pair("j", edge, rec_models["hybrid"], case,
                         setup["vocab"])
    tt, ts = _serve_pair("t", edge, rec_models["hybrid"], case,
                         setup["vocab"])
    _assert_same(jt, tt)
    assert js["spec_lanes"] == ts["spec_lanes"]


def test_block_pool_allocation_sequence_matches_jax():
    """The copied BlockPool hands out, shares, forks and frees exactly the
    block ids the JAX pool does over a random operation sequence."""
    jp, tp = JPool(33, 8), TPool(33, 8)
    rng = np.random.default_rng(0)
    for _ in range(400):
        owner = int(rng.integers(0, 6))
        op = rng.choice(["alloc", "grow", "share", "fork", "free"])
        outs = []
        for pool in (jp, tp):
            try:
                if op == "alloc":
                    n = int(rng.integers(1, 4)) if pool is jp else n
                    outs.append(pool.alloc(owner, n) if pool.can_alloc(n)
                                else None)
                elif op == "grow":
                    t = int(rng.integers(0, 40)) if pool is jp else t
                    outs.append(pool.grow_to(owner, t)
                                if pool.can_alloc(pool.blocks_for(t))
                                else None)
                elif op == "share":
                    src = (owner + 1) % 6
                    blocks = pool.owned(src)[:1]
                    outs.append(pool.share(owner, blocks) if blocks
                                and not pool.owned(owner) else None)
                elif op == "fork":
                    mine = pool.owned(owner)
                    outs.append(pool.fork(owner, mine[0])
                                if mine and pool.can_alloc(1) else None)
                else:
                    outs.append(pool.free(owner))
            except RuntimeError as e:
                outs.append(str(e))
        assert outs[0] == outs[1], op
        assert jp.used == tp.used and jp.peak_used == tp.peak_used
        assert all(jp.owned(o) == tp.owned(o) for o in range(6))


@pytest.mark.parametrize("k", [0, 2, 4])
def test_speculative_sample_greedy_matches_jax(k):
    """The per-sequence acceptance oracle at T=0: the first ``k`` drafts
    agree with the target's argmax, so both frameworks accept exactly
    ``k`` and emit the target's argmax at row ``k``."""
    from repro.core.speculative import speculative_sample as jsample
    from repro_torch.core.speculative import speculative_sample as tsample
    gamma, V = 4, 300
    rng = np.random.default_rng(k)
    tl = rng.standard_normal((gamma + 1, V)).astype(np.float32)
    dl = rng.standard_normal((gamma, V)).astype(np.float32)
    toks = dl.argmax(-1).astype(np.int32)
    toks[:k] = tl[:k].argmax(-1)
    toks[k:] = np.where(toks[k:] == tl[k:gamma].argmax(-1),
                        (toks[k:] + 1) % V, toks[k:])
    dl[np.arange(gamma), toks] = 50.0            # drafts are greedy picks
    n_j, t_j = jsample(jax.random.PRNGKey(0), jnp.asarray(tl),
                       jnp.asarray(dl), jnp.asarray(toks), temperature=0.0)
    gen = torch.Generator().manual_seed(0)
    n_t, t_t = tsample(gen, torch.from_numpy(tl), torch.from_numpy(dl),
                       torch.from_numpy(toks), temperature=0.0)
    assert (n_t, t_t) == (int(n_j), int(t_j)) == (k, int(tl[k].argmax()))
