"""The port's dense layers and transformer entries vs the JAX package.

Parameters are the JAX init of the reduced smollm-135m and granite-8b
configs (float32, 2 layers), bridged into the port with
``repro_torch.bridge.params_from_numpy``; inputs and caches come from numpy
seeds and go to both frameworks.  Tolerances: layer outputs atol = rtol =
1e-5, logits atol 1e-4 (two layers of float32 matmuls summed in another
order), caches atol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["smollm-135m", "granite-8b"]
LOGIT_TOL = 1e-4


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


def _close(t_out, j_out, tol=1e-5):
    np.testing.assert_allclose(t_out.detach().float().numpy(),
                               np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
        jp = JModel(jcfg).init(jax.random.PRNGKey(3))
        out[arch] = (jcfg, tcfg, jp,
                     params_from_numpy(_host(jp), tcfg, "cpu"))
    return out


def _layer0(jp):
    """Layer-0 attention params as (JAX dict, torch dict)."""
    j = {k: v[0] for k, v in jp["blocks"]["attn"].items()}
    return j, {k: _t(v) for k, v in _host(j).items()}


# ------------------------------------------------------------ layers
def test_rmsnorm():
    x, w = _np(0, (2, 5, 32)), _np(1, (32,), 0.1)
    _close(TL.rmsnorm(_t(x), _t(w), 1e-5),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("rank", [1, 2])
def test_apply_rope(rank):
    x = _np(0, (2, 6, 3, 16))
    pos = np.arange(6, dtype=np.int32) + 7
    if rank == 2:
        pos = np.stack([pos, pos * 3])
    _close(TL.apply_rope(_t(x), _t(pos), 500.0),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0))


@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_mha_masked(softcap):
    q, k, v = _np(0, (2, 5, 4, 16)), _np(1, (2, 7, 2, 16)), _np(2,
                                                              (2, 7, 2, 16))
    mask = np.random.default_rng(3).random((5, 7)) > 0.3
    mask[:, 0] = True
    mask[0] = False                          # a fully masked row: uniform
    _close(TL.mha(_t(q), _t(k), _t(v), mask=_t(mask), softcap=softcap),
           JL.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  mask=jnp.asarray(mask), softcap=softcap))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [0, 5])
def test_attention_block(models, arch, window):
    jcfg, tcfg, jp, _ = models[arch]
    jpa, tpa = _layer0(jp)
    x = _np(0, (2, 12, jcfg.d_model))
    pos = np.arange(12, dtype=np.int32)
    to, (tk, tv) = TL.attention_block(tpa, _t(x), _t(pos), tcfg,
                                      window=window)
    jo, (jk, jv) = JL.attention_block(jpa, jnp.asarray(x), jnp.asarray(pos),
                                      jcfg, window=window)
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("pos", [0, 9, 15])
def test_decode_attention_dense(models, window, pos):
    """Dense single-token decode, in place; pos 15 = Smax-1 (the write
    lands on the last row)."""
    jcfg, tcfg, jp, _ = models["smollm-135m"]
    jpa, tpa = _layer0(jp)
    B, Smax = 2, 16
    shape = (B, Smax, jcfg.num_kv_heads, jcfg.head_dim)
    ck, cv, x = _np(1, shape), _np(2, shape), _np(3, (B, 1, jcfg.d_model))
    tk, tv = _t(ck), _t(cv)
    to, tk2, tv2 = TL.decode_attention(tpa, _t(x), tk, tv,
                                       torch.tensor(pos), tcfg,
                                       window=window)
    jo, jk, jv = JL.decode_attention(jpa, jnp.asarray(x), jnp.asarray(ck),
                                     jnp.asarray(cv), pos, jcfg,
                                     window=window)
    _close(to, jo)
    _close(tk, jk)                            # written in place
    _close(tv, jv)
    assert tk2 is tk


@pytest.mark.parametrize("pos", [0, 6, 13])
def test_extend_attention_dense(models, pos):
    """Multi-token dense extend; pos 13 with T=5 and Smax=16 exercises the
    start clamp JAX's dynamic_update_slice applies."""
    jcfg, tcfg, jp, _ = models["granite-8b"]
    jpa, tpa = _layer0(jp)
    B, T, Smax = 2, 5, 16
    shape = (B, Smax, jcfg.num_kv_heads, jcfg.head_dim)
    ck, cv, x = _np(1, shape), _np(2, shape), _np(3, (B, T, jcfg.d_model))
    tk, tv = _t(ck), _t(cv)
    to, _, _ = TL.extend_attention(tpa, _t(x), tk, tv, torch.tensor(pos),
                                   tcfg)
    jo, jk, jv = JL.extend_attention(jpa, jnp.asarray(x), jnp.asarray(ck),
                                     jnp.asarray(cv), pos, jcfg)
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)


def _pool_case(cfg, B=3, bs=8, MB=4, seed=0):
    NB = B * MB + 1
    shape = (NB, bs, cfg.num_kv_heads, cfg.head_dim)
    rng = np.random.default_rng(seed)
    table = rng.permutation(np.arange(1, NB)).reshape(B, MB).astype(np.int32)
    return _np(seed + 1, shape), _np(seed + 2, shape), table


@pytest.mark.parametrize("T", [1, 5])
def test_paged_extend_attention(models, T):
    jcfg, tcfg, jp, _ = models["smollm-135m"]
    jpa, tpa = _layer0(jp)
    kp, vp, table = _pool_case(jcfg)
    pos = np.array([0, 9, 26], np.int32)
    x = _np(4, (3, T, jcfg.d_model))
    tk, tv = _t(kp), _t(vp)
    to, _, _ = TL.paged_extend_attention(tpa, _t(x), tk, tv, _t(table),
                                         _t(pos), tcfg)
    jo, jk, jv = JL.paged_extend_attention(jpa, jnp.asarray(x),
                                           jnp.asarray(kp), jnp.asarray(vp),
                                           jnp.asarray(table),
                                           jnp.asarray(pos), jcfg)
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("backend", ["auto", "plain"])
def test_paged_decode_attention_block(models, backend):
    jcfg, tcfg, jp, _ = models["granite-8b"]
    jpa, tpa = _layer0(jp)
    kp, vp, table = _pool_case(jcfg)
    pos = np.array([0, 9, 31], np.int32)
    x = _np(4, (3, 1, jcfg.d_model))
    tk, tv = _t(kp), _t(vp)
    to, _, _ = TL.paged_decode_attention_block(tpa, _t(x), tk, tv,
                                               _t(table), _t(pos), tcfg,
                                               backend=backend)
    jo, jk, jv = JL.paged_decode_attention_block(
        jpa, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(pos), jcfg, backend="ref")
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("activation", ["silu", "geglu", "relu2", "gelu"])
def test_mlp_block(activation):
    from types import SimpleNamespace
    cfg = SimpleNamespace(d_model=24, d_ff=40, mlp_activation=activation)
    jp = JL.init_mlp(jax.random.PRNGKey(1), cfg, jnp.float32)
    tp = {k: _t(v) for k, v in _host(jp).items()}
    x = _np(0, (2, 3, 24))
    _close(TL.mlp_block(tp, _t(x), activation),
           JL.mlp_block(jp, jnp.asarray(x), activation))


def test_embed_unembed():
    table = _np(0, (50, 16))
    toks = np.array([[3, 49, 0]], np.int32)
    _close(TL.embed(_t(table), _t(toks)),
           JL.embed(jnp.asarray(table), jnp.asarray(toks)))
    h = _np(1, (2, 3, 16))
    out = TL.unembed(_t(table).to(torch.bfloat16), _t(h))
    assert out.dtype == torch.float32
    _close(out, JL.unembed(jnp.asarray(table).astype(jnp.bfloat16),
                           jnp.asarray(h)), 1e-4)


def test_init_helpers():
    cfg = tget("smollm-135m").reduced()
    gen = torch.Generator().manual_seed(0)
    w = TL.dense_init(gen, (256, 512), device="cpu")
    assert w.shape == (256, 512) and w.dtype == torch.float32
    assert abs(float(w.std()) - 1 / 16) < 0.003
    e = TL.init_embedding(gen, 512, 64, torch.bfloat16, device="cpu")
    assert e.dtype == torch.bfloat16 and abs(float(e.float().std()) - 0.02) \
        < 0.002
    attn = TL.init_attention(gen, cfg, torch.float32, device="cpu")
    assert attn["wk"].shape == (cfg.d_model, cfg.num_kv_heads * cfg.head_dim)
    mlp = TL.init_mlp(gen, cfg, torch.float32, device="cpu")
    assert set(mlp) == {"w_gate", "w_up", "w_down"}
    p1 = TT.init_params(cfg, seed=5, device="cpu")
    p2 = TT.init_params(cfg, seed=5, device="cpu")
    assert torch.equal(p1.blocks[1].mlp["w_up"], p2.blocks[1].mlp["w_up"])
    assert p1.lm_head is None and p1.head is p1.embed


# ------------------------------------------------------------ transformer
@pytest.mark.parametrize("arch", ARCHS)
def test_forward(models, arch):
    jcfg, tcfg, jp, tp = models[arch]
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 11)) \
        .astype(np.int32)
    tl, _ = TT.forward(tp, _t(toks), tcfg)
    jl, _ = JT.forward(jp, jnp.asarray(toks), jcfg)
    _close(tl, jl, LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_extend(models, arch):
    """prefill (padded to max_seq) -> decode_step -> extend_step, logits
    and caches against JAX at every stage."""
    jcfg, tcfg, jp, tp = models[arch]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    tl, tc = TT.prefill(tp, _t(toks), tcfg, max_seq=20)
    jl, jc = JT.prefill(jp, jnp.asarray(toks), jcfg, max_seq=20)
    _close(tl, jl, LOGIT_TOL)
    _close(tc["k"], jc["k"])
    assert int(tc["pos"]) == int(jc["pos"]) == 9
    tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
    tl, tc = TT.decode_step(tp, _t(tok), tc, tcfg)
    jl, jc = JT.decode_step(jp, jnp.asarray(tok), jc, jcfg)
    _close(tl, jl, LOGIT_TOL)
    ext = rng.integers(0, jcfg.vocab_size, (2, 4)).astype(np.int32)
    tl, tc = TT.extend_step(tp, _t(ext), tc, tcfg)
    jl, jc = JT.extend_step(jp, jnp.asarray(ext), jc, jcfg)
    _close(tl, jl, LOGIT_TOL)
    _close(tc["v"], jc["v"])
    assert int(tc["pos"]) == int(jc["pos"]) == 14


def test_init_caches(models):
    jcfg, tcfg, _, _ = models["smollm-135m"]
    tc = TT.init_cache(tcfg, 3, 17, device="cpu")
    jc = JT.init_cache(jcfg, 3, 17)
    assert tuple(tc["k"].shape) == jc["k"].shape and tc["pos"].shape == ()
    tpc = TT.init_paged_cache(tcfg, 9, 8, 3, 4, device="cpu")
    jpc = JT.init_paged_cache(jcfg, 9, 8, 3, 4)
    for key in ("k", "v", "table", "pos"):
        assert tuple(tpc[key].shape) == jpc[key].shape
    assert tpc["table"].dtype == torch.int32


def _paged_cache(cfg, pos, seed=0, B=3, bs=8, MB=4):
    NB = B * MB + 1
    shape = (cfg.num_layers, NB, bs, cfg.num_kv_heads, cfg.head_dim)
    rng = np.random.default_rng(seed)
    table = rng.permutation(np.arange(1, NB)).reshape(B, MB).astype(np.int32)
    c = {"k": _np(seed + 1, shape), "v": _np(seed + 2, shape),
         "table": table, "pos": np.asarray(pos, np.int32)}
    return ({k: jnp.asarray(v) for k, v in c.items()},
            {k: _t(v) for k, v in c.items()})


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", ["auto", "plain", "gather"])
def test_paged_decode_step(models, arch, backend):
    jcfg, tcfg, jp, tp = models[arch]
    jc, tc = _paged_cache(jcfg, [0, 7, 30])
    tok = np.array([[5], [17], [300]], np.int32)
    tl, tc2 = TT.paged_decode_step(tp, _t(tok), tc, tcfg,
                                   attn_backend=backend)
    jl, jc2 = JT.paged_decode_step(jp, jnp.asarray(tok), jc, jcfg,
                                   attn_backend="ref" if backend != "gather"
                                   else "gather")
    _close(tl, jl, LOGIT_TOL)
    _close(tc2["k"], jc2["k"])
    _close(tc2["v"], jc2["v"])
    assert tc2["pos"].tolist() == [1, 8, 31]
    assert tc["pos"].tolist() == [0, 7, 30]      # the old pos is untouched


def test_paged_decode_kernel_backend_needs_cuda(models):
    _, tcfg, _, tp = models["smollm-135m"]
    _, tc = _paged_cache(tcfg, [0, 7, 30])
    with pytest.raises(ValueError):
        TT.paged_decode_step(tp, torch.zeros((3, 1), dtype=torch.int32), tc,
                             tcfg, attn_backend="kernel")


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_extend_step(models, arch):
    jcfg, tcfg, jp, tp = models[arch]
    jc, tc = _paged_cache(jcfg, [2, 11, 20], seed=4)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (3, 5)) \
        .astype(np.int32)
    tl, tc2 = TT.paged_extend_step(tp, _t(toks), tc, tcfg)
    jl, jc2 = JT.paged_extend_step(jp, jnp.asarray(toks), jc, jcfg)
    _close(tl, jl, LOGIT_TOL)
    _close(tc2["k"], jc2["k"])
    assert tc2["pos"].tolist() == [7, 16, 25]


@pytest.mark.parametrize("T", [1, 5])
def test_paged_writes_past_the_table_are_dropped(models, T):
    """A slot decoding past its block table (4 blocks x 8 = 32 entries):
    JAX drops those writes (the out-of-range block id becomes INT_MIN and
    the scatter skips it); the port must leave the pool exactly as JAX
    does, and the other slots' logits must agree."""
    jcfg, tcfg, jp, tp = models["smollm-135m"]
    jc, tc = _paged_cache(jcfg, [3, 30, 40], seed=7)
    before = tc["k"].clone()
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (3, T)) \
        .astype(np.int32)
    if T == 1:
        tl, tc2 = TT.paged_decode_step(tp, _t(toks), tc, tcfg)
        jl, jc2 = JT.paged_decode_step(jp, jnp.asarray(toks), jc, jcfg,
                                       attn_backend="ref")
    else:
        tl, tc2 = TT.paged_extend_step(tp, _t(toks), tc, tcfg)
        jl, jc2 = JT.paged_extend_step(jp, jnp.asarray(toks), jc, jcfg)
    _close(tl, jl, LOGIT_TOL)
    _close(tc2["k"], jc2["k"])
    _close(tc2["v"], jc2["v"])
    # slot 2 sits wholly past its table: none of its blocks changed
    for blk in tc["table"][2].tolist():
        assert torch.equal(tc2["k"][:, blk], before[:, blk])


@pytest.mark.parametrize("arch", ARCHS)
def test_model_facade(models, arch):
    """The Model entry points the serving path calls, plus rewind."""
    jcfg, tcfg, jp, tp = models[arch]
    tm, jm = TModel(tcfg), JModel(jcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (1, 6)) \
        .astype(np.int32)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)}, max_seq=8)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=8)
    _close(tl, jl, LOGIT_TOL)
    assert tm.paged_kv and tm.rewindable_cache
    assert int(tm.rewind(tc, 3)["pos"]) == 3 and int(tc["pos"]) == 6
    jc, tc = _paged_cache(jcfg, [1, 2, 3])
    tl, _ = tm.paged_decode_step(tp, _t(toks[:, :3].T), tc)
    jl, _ = jm.paged_decode_step(jp, jnp.asarray(toks[:, :3].T), jc,
                                 attn_backend="ref")
    _close(tl, jl, LOGIT_TOL)


# ------------------------------------------------------------ bridge
def test_bridge_untied_head_and_bfloat16():
    """An untied lm_head crosses the bridge; bfloat16 leaves go through
    float32 (exact) and come back as bfloat16 bit for bit."""
    jcfg = jget("smollm-135m").reduced().replace(tie_embeddings=False,
                                                param_dtype="bfloat16")
    tcfg = tget("smollm-135m").reduced().replace(tie_embeddings=False,
                                                 param_dtype="bfloat16")
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(_host(jp), tcfg, "cpu")
    assert tp.lm_head is not None and tp.head is tp.lm_head
    assert tp.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp.lm_head.float().numpy(),
        np.asarray(jp["lm_head"].astype(jnp.float32)))
    np.testing.assert_array_equal(
        tp.blocks[1].attn["wo"].float().numpy(),
        np.asarray(jp["blocks"]["attn"]["wo"][1].astype(jnp.float32)))
    with pytest.raises(ValueError):
        params_from_numpy(_host(jp), tcfg.replace(tie_embeddings=True), "cpu")
