"""The port's BatchedEngine vs the JAX package's, on bridged parameters.

Both engines serve the same prompts (``SyntheticLM``, as ``serve.py`` makes
them) with the JAX init of the reduced smollm-135m edge and granite-8b
cloud, bridged into the port; the port runs on the CPU.  Every request must
get identical ``tokens``, ``path``, ``edge_calls`` and ``cloud_passes``
(greedy decoding, T = 0), and the speculation counters must agree.  The
cases cover the serve defaults (paged KV, SpeculativePolicy(0.6), linear
lane), the dense layout, pure-edge serving (threshold 1.1), the cloud and
skeleton escalations, an edge that drafts with the cloud's own weights
(every draft accepted), and chunked prefill with preemption by swap.
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
                 kv_blocks=case.get("kv_blocks"))
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
