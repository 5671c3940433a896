"""The port's MoE family vs the JAX package's, on bridged parameters.

``moe_block`` and its auxiliary loss against JAX's for both moe configs
(reduced, f32) within 1e-5, including a batch of more than 4096 tokens
whose capacity drops assignments; the dense fallback against the sparse
dispatch; the model entry points' logits; and ``BatchedEngine`` traces
with a moe edge (reduced granite-moe-1b-a400m) for the reduced granite-8b
cloud on the paged linear, tree and self lanes, identical to JAX's at
T = 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.core.scheduler import BatchedEngine as JEngine  # noqa: E402
from repro.data import SyntheticLM  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.core.scheduler import BatchedEngine as TEngine  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

MOE_CONFIGS = ("granite-moe-1b-a400m", "olmoe-1b-7b")
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its host loops issue many
    tiny ops, which threads only slow down when the test workers share
    the CPU; the previous count is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


@pytest.fixture(scope="module")
def models():
    """Each moe config reduced, JAX-initialised and bridged."""
    out = {}
    for seed, name in enumerate(MOE_CONFIGS):
        jc, tc = jget(name).reduced(), tget(name).reduced()
        jp = JModel(jc).init(jax.random.PRNGKey(seed))
        out[name] = (jc, jp, tc, params_from_numpy(_host(jp), tc, "cpu"))
    return out


def _layer0(jp):
    return jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_moe_block_matches_jax(models, name):
    jc, jp, tc, tp = models[name]
    x = _x((3, 7, jc.d_model), 0)
    jo, jaux = JMOE.moe_block(_layer0(jp), jnp.asarray(x), jc)
    to, taux = TMOE.moe_block(tp.blocks[0].moe, torch.as_tensor(x), tc)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=TOL, rtol=TOL)


def test_moe_capacity_drops_match_jax(models):
    """5000 tokens (past the dropless 4096) routed mostly to one expert:
    the capacity factor drops assignments, the same ones as JAX's stable
    sort, so every token's output agrees."""
    jc, jp, tc, tp = models["granite-moe-1b-a400m"]
    p = _layer0(jp)
    router = np.asarray(p["router"])
    x = _x((1, 5000, jc.d_model), 1) + 0.5 * router[:, 0] / \
        np.linalg.norm(router[:, 0])**2
    jo, jaux = JMOE.moe_block(p, jnp.asarray(x), jc)
    to, taux = TMOE.moe_block(tp.blocks[0].moe, torch.as_tensor(x), tc)
    C = TMOE.capacity(5000, tc)
    assert C == JMOE.capacity(5000, jc) < 5000
    _, _, idx = TMOE._route(tp.blocks[0].moe, torch.as_tensor(x[0]),
                            tc.top_k)
    assert int(torch.bincount(idx.reshape(-1)).max()) > C   # drops happen
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("tokens", [1, 8, 4096, 4097, 100000])
def test_moe_capacity_matches_jax(tokens):
    for name in MOE_CONFIGS:
        assert TMOE.capacity(tokens, tget(name)) == \
            JMOE.capacity(tokens, jget(name))


@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_moe_dense_fallback_matches_sparse_and_jax(models, name):
    jc, jp, tc, tp = models[name]
    x = _x((2, 9, jc.d_model), 2)
    sparse, _ = TMOE.moe_block(tp.blocks[0].moe, torch.as_tensor(x), tc)
    dense, aux0 = TMOE.moe_block_dense_fallback(tp.blocks[0].moe,
                                                torch.as_tensor(x), tc)
    jd, _ = JMOE.moe_block_dense_fallback(_layer0(jp), jnp.asarray(x), jc)
    torch.testing.assert_close(dense, sparse, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jd), atol=TOL,
                               rtol=TOL)
    assert float(aux0) == 0.0


def test_moe_top_k_ties_go_to_the_lower_expert(models):
    """Equal router probabilities: the lower expert index ranks first, as
    ``jax.lax.top_k`` orders them."""
    tc = models["olmoe-1b-7b"][2]
    p = {"router": torch.zeros((tc.d_model, tc.num_experts))}
    p["router"][:, 1] = 1.0
    x = torch.zeros((3, tc.d_model))
    x[1, 0] = 1.0
    _, gate, idx = TMOE._route(p, x, tc.top_k)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x.numpy())
                                           @ jnp.asarray(p["router"].numpy()),
                                           -1), tc.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0].tolist() == [0, 1] and idx[1].tolist() == [1, 0]


def test_moe_router_stays_float32_in_a_bfloat16_model(models):
    jc, jp, _, _ = models["granite-moe-1b-a400m"]
    cfg = tget("granite-moe-1b-a400m").reduced().replace(
        param_dtype="bfloat16", activ_dtype="bfloat16")
    for params in (params_from_numpy(_host(jp), cfg, "cpu"),
                   TModel(cfg).init(seed=0, device="cpu")):
        moe = params.blocks[1].moe
        assert moe["router"].dtype == torch.float32
        assert {moe[k].dtype for k in ("w_gate", "w_up", "w_down")} == \
            {torch.bfloat16}
        assert params.blocks[1].mlp is None
    x = torch.randn((1, 4, cfg.d_model)).to(torch.bfloat16)
    out, aux = TMOE.moe_block(params.blocks[1].moe, x, cfg)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32


# ------------------------------------------------------------ model
def test_moe_model_entry_points_match_jax(models):
    """forward (logits and summed aux), prefill, decode, extend and the
    paged decode and extend of the moe family against JAX's."""
    jc, jp, tc, tp = models["granite-moe-1b-a400m"]
    jm, tm = JModel(jc), TModel(tc)
    assert tm.paged_kv and tm.rewindable_cache
    toks = np.random.default_rng(3).integers(0, tc.vocab_size, (2, 10)) \
        .astype(np.int32)
    jl, ja = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, ta = tm.forward(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    np.testing.assert_allclose(float(ta), float(ja), atol=TOL, rtol=TOL)
    assert float(ta) > 0

    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :6])},
                            max_seq=16)
    tl, tcache = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :6])},
                            max_seq=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    jl, jcache = jm.decode_step(jp, jnp.asarray(toks[:, 6:7]), jcache)
    tl, tcache = tm.decode_step(tp, torch.as_tensor(toks[:, 6:7]), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    jl, _ = jm.extend_step(jp, jnp.asarray(toks[:, 7:]), jcache)
    tl, _ = tm.extend_step(tp, torch.as_tensor(toks[:, 7:]), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)

    # paged: both sequences' 6-token prefixes in 4-token blocks
    table = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    caches = []
    for m, arr in ((jm, jnp.asarray), (tm, torch.as_tensor)):
        kw = {} if m is jm else {"device": "cpu"}
        c = m.init_paged_cache(7, 4, 2, 3, **kw)
        c = {**c, "table": arr(table), "pos": arr(np.zeros(2, np.int32))}
        _, c = m.paged_extend_step(jp if m is jm else tp, arr(toks[:, :6]),
                                   c)
        caches.append(c)
    jl, _ = jm.paged_decode_step(jp, jnp.asarray(toks[:, 6:7]), caches[0],
                                 attn_backend="ref")
    tl, _ = tm.paged_decode_step(tp, torch.as_tensor(toks[:, 6:7]),
                                 caches[1])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)


# ------------------------------------------------------------ serving
def _pair(get):
    e, c = get("granite-moe-1b-a400m").reduced(), get("granite-8b").reduced()
    v = min(e.vocab_size, c.vocab_size)
    return e.replace(vocab_size=v), c.replace(vocab_size=v)


@pytest.fixture(scope="module")
def serving():
    (je, jc), (te, tc) = _pair(jget), _pair(tget)
    jep = JModel(je).init(jax.random.PRNGKey(0))
    jcp = JModel(jc).init(jax.random.PRNGKey(1))
    return {"j": (JModel(je), JModel(jc), jep, jcp),
            "t": (TModel(te), TModel(tc),
                  params_from_numpy(_host(jep), te, "cpu"),
                  params_from_numpy(_host(jcp), tc, "cpu")),
            "vocab": te.vocab_size}


@pytest.mark.parametrize("spec_mode", ["linear", "tree", "self"])
def test_moe_edge_engine_traces_match_jax(serving, spec_mode):
    """A moe edge on paged serving (tree groups on dense side states) at
    SpeculativePolicy(0.6): the same traces and lane counters as JAX's."""
    synth = SyntheticLM(serving["vocab"])
    rng = np.random.default_rng(0)
    prompts = [synth.sample(rng, i % synth.n_domains, 12) for i in range(4)]
    out = {}
    for side, pol, Engine in (("j", jpol, JEngine), ("t", tpol, TEngine)):
        em, cm, ep, cp = serving[side]
        eng = Engine(em, cm, batch_size=4, gamma=3, temperature=0.0,
                     policy=pol.SpeculativePolicy(0.6), spec_mode=spec_mode)
        traces = eng.serve_batch(ep, cp, prompts, 10)
        stats = eng.stats()
        out[side] = ([(tr.path, tr.tokens, tr.edge_calls, tr.cloud_passes)
                      for tr in traces],
                     stats["spec_mode"], stats["kv_layout"],
                     stats["spec_lanes"])
    assert out["t"][1:3] == (spec_mode, "paged")
    assert out["j"] == out["t"]
