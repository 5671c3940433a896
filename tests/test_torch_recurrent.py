"""The port's recurrent families (mamba2 ``ssm``, ``xlstm``, zamba2
``hybrid``) and the plain SSD scan vs the JAX package.

Parameters are the JAX init of the reduced configs (float32, vocab 512),
bridged into the port with ``repro_torch.bridge.params_from_numpy``; inputs
and states come from numpy seeds and go to both frameworks.  Tolerances:
the scan 1e-4 (atol = rtol, the JAX kernel sweep's: chunked sums of up to
128 products in another order), layer outputs and caches 1e-5 (ROADMAP:
about 1e-5 at float32), logits ``LOGIT_TOL`` = 1e-4 as for the dense
family.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.seq_state import SpecOps  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_chunk_scan_bwd_plain, ssd_chunk_scan_kernel, ssd_chunk_scan_plain)
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402

ARCHS = {"ssm": "mamba2-370m", "xlstm": "xlstm-125m", "hybrid": "zamba2-2.7b"}
LOGIT_TOL = 1e-4
SCAN_TOL = 1e-4
CACHE_TOL = 1e-5


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


def _close(t_out, j_out, tol=CACHE_TOL):
    np.testing.assert_allclose(t_out.detach().float().numpy(),
                               np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


def _cfgs(family):
    arch = ARCHS[family]
    return (jget(arch).reduced().replace(vocab_size=512),
            tget(arch).reduced().replace(vocab_size=512))


@pytest.fixture(scope="module")
def models():
    out = {}
    for fam in ARCHS:
        jcfg, tcfg = _cfgs(fam)
        jp = JModel(jcfg).init(jax.random.PRNGKey(3))
        out[fam] = (jcfg, tcfg, jp, params_from_numpy(_host(jp), tcfg, "cpu"))
    return out


def _gates(seed, shape):
    """log_a = -softplus(x) (decays), log_i = 0.5 x: the JAX sweep's."""
    la = -np.logaddexp(_np(seed, shape), 0.0).astype(np.float32)
    return la, _np(seed + 1, shape) * 0.5


# ------------------------------------------------------------ the scan
@pytest.mark.parametrize("B,S,H,N,P,Q", [(1, 128, 2, 16, 32, 32),
                                         (2, 256, 3, 32, 64, 64),
                                         (1, 512, 1, 64, 64, 128)])
def test_ssd_scan_plain_vs_pallas(B, S, H, N, P, Q):
    """The plain scan against the Pallas kernel in interpret mode, on the
    sweep of ``tests/test_kernels.py`` (zero initial state)."""
    q, k = _np(0, (B, S, H, N)), _np(1, (B, S, H, N))
    v = _np(2, (B, S, H, P))
    la, li = _gates(3, (B, S, H))
    yj, dj, mj = jops.ssd_chunk_scan(*map(jnp.asarray, (q, k, v, la, li)),
                                     chunk=Q)
    yt, dt, mt, _ = ssd_chunk_scan_plain(*map(_t, (q, k, v, la, li)),
                                         chunk=Q)
    for a, b in ((yt, yj), (dt, dj), (mt, mj)):
        _close(a, b, SCAN_TOL)


@pytest.mark.parametrize("S,chunk", [(37, 16), (5, 16), (48, 16)])
@pytest.mark.parametrize("carried", [False, True])
def test_ssd_scan_plain_vs_gla_chunked(S, chunk, carried):
    """Ragged S (front-padded chunks), short S (Q = S) and a carried random
    state: outputs and the final state equal ``gla_chunked``'s.  q and k
    go in as head-broadcast views, as mamba2 hands them over."""
    B, H, N, P = 2, 3, 8, 16
    q, k = _np(0, (B, S, 1, N)), _np(1, (B, S, 1, N))
    v = _np(2, (B, S, H, P))
    la, li = _gates(3, (B, S, H))
    st = None
    if carried:
        st = (_np(5, (B, H, N, P)), _np(6, (B, H, N)), _np(7, (B, H)))
    jq, jk = (jnp.broadcast_to(jnp.asarray(x), (B, S, H, N)) for x in (q, k))
    yj, dj, mj, fj = JS.gla_chunked(
        jq, jk, jnp.asarray(v), jnp.asarray(la), jnp.asarray(li), chunk=chunk,
        state=None if st is None else JS.GLAState(*map(jnp.asarray, st)))
    tq, tk = (_t(x).expand(B, S, H, N) for x in (q, k))
    yt, dt, mt, ft = ssd_chunk_scan_plain(
        tq, tk, _t(v), _t(la), _t(li), chunk=chunk,
        state=None if st is None else tuple(map(_t, st)))
    for a, b in zip((yt, dt, mt) + tuple(ft), (yj, dj, mj) + tuple(fj)):
        _close(a, b, SCAN_TOL)


def test_ssd_dispatch_and_no_fallback():
    """On CPU tensors the dispatcher runs the plain version; the kernel's
    wrapper handed CPU tensors raises instead of running it."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_cuda
    B, S, H, N, P = 1, 9, 2, 4, 8
    args = (_t(_np(0, (B, S, H, N))), _t(_np(1, (B, S, H, N))),
            _t(_np(2, (B, S, H, P))), *map(_t, _gates(3, (B, S, H))))
    for a, b in zip(ops.ssd_chunk_scan(*args, chunk=4)[:3],
                    ssd_chunk_scan_plain(*args, chunk=4)[:3]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        ssd_chunk_scan_cuda(*args, chunk=4)


# ssd_chunk_scan_bwd_plain (the backward kernel's model) against jax.grad of
# the JAX package's gla_chunked composed with each caller's form of the
# outputs, sum(R * form(y, den, m)): mamba2's y * exp(m) and mLSTM's
# y / max(|den|, exp(-m)).  (B, S, H, N, P, chunk, q/k head-broadcast, form,
# the JAX side's chunk): several chunks, head-broadcast q/k, Q = S < chunk,
# and front-padded ragged lengths.  JAX's own gradient is NaN at a
# front-padded length (its masked decay entries overflow before the mask),
# so a ragged case takes its reference at a chunk length that divides S:
# both forms do not depend on the chunk length.  Tolerance: max |port -
# JAX| <= 1e-5 x max(1, max |JAX|) per gradient (float32, the stabilisers'
# path cancelling to rounding on the JAX side)
SSD_BWD_CASES = [(2, 32, 2, 4, 3, 8, True, "mamba", 8),
                 (1, 5, 2, 4, 3, 8, False, "mlstm", 8),
                 (2, 27, 2, 4, 3, 8, False, "mlstm", 9),
                 (1, 21, 3, 5, 7, 4, True, "mamba", 7)]


@pytest.mark.parametrize("B,S,H,N,P,chunk,bc,form,jchunk", SSD_BWD_CASES)
def test_ssd_bwd_plain_matches_jax(B, S, H, N, P, chunk, bc, form, jchunk):
    hq = 1 if bc else H
    q, k = _np(0, (B, S, hq, N)), _np(1, (B, S, hq, N))
    v = _np(2, (B, S, H, P))
    la, li = _gates(3, (B, S, H))
    R = _np(5, (B, S, H, P))

    def jform(y, den, m):
        if form == "mamba":
            return y * jnp.exp(m)[..., None]
        return y / jnp.maximum(jnp.abs(den), jnp.exp(-m))[..., None]

    def jloss(q, k, v, la, li):
        y, den, m, _ = JS.gla_chunked(
            jnp.broadcast_to(q, (B, S, H, N)),
            jnp.broadcast_to(k, (B, S, H, N)), v, la, li, chunk=jchunk)
        return jnp.sum(R * jform(y, den, m))

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(q, k, v, la, li)
    tq, tk = _t(q).expand(B, S, H, N), _t(k).expand(B, S, H, N)
    tv, tla, tli = _t(v), _t(la), _t(li)
    y, den, m, fin, saved = ssd_chunk_scan_plain(
        tq, tk, tv, tla, tli, chunk=chunk, chunk_states=True)
    y, den = y.requires_grad_(True), den.requires_grad_(True)
    if form == "mamba":
        out = y * torch.exp(m)[..., None]
    else:
        out = y / torch.maximum(den.abs(), torch.exp(-m))[..., None]
    dy, dden = torch.autograd.grad((_t(R) * out).sum(), (y, den),
                                   allow_unused=True)
    got = list(ssd_chunk_scan_bwd_plain(tq, tk, tv, tla, tli, m, saved,
                                        fin[2], dy, dden, chunk=chunk))
    if bc:                                   # the expand's backward
        got[0], got[1] = (g.sum(2, keepdim=True) for g in got[:2])
    for name, a, b in zip(("q", "k", "v", "log_a", "log_i"), got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        err = float(np.abs(a.numpy() - b).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(b).max())), (name, err)


def test_ssd_scan_refuses_a_state_that_requires_grad():
    """No backward flows into a carried-in state: under grad the
    differentiable entry raises before any launch (here on CPU tensors,
    the check precedes the device's)."""
    B, S, H, N, P = 1, 6, 2, 4, 8
    q = _t(_np(0, (B, S, H, N))).requires_grad_(True)
    k, v = _t(_np(1, (B, S, H, N))), _t(_np(2, (B, S, H, P)))
    la, li = map(_t, _gates(3, (B, S, H)))
    st = (torch.zeros((B, H, N, P), requires_grad=True),
          torch.zeros((B, H, N)), torch.full((B, H), -1e30))
    with pytest.raises(RuntimeError, match="requires grad"):
        ssd_chunk_scan_kernel(q, k, v, la, li, chunk=4, state=st)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ssd_chunk_scan_kernel(q, k, v, la, li, chunk=4, state=st)


def test_plain_scan_gradients_are_finite_at_a_front_pad():
    """Autograd through the plain scan (its stabiliser path included) at a
    front-padded length gives finite gradients equal to its backward
    model's (the pad rows' masked decay entries are masked before the
    exp)."""
    B, S, H, N, P, chunk = 2, 13, 2, 4, 3, 8
    leaves = [_t(_np(0, (B, S, H, N))), _t(_np(1, (B, S, H, N))),
              _t(_np(2, (B, S, H, P))), *map(_t, _gates(3, (B, S, H)))]
    leaves = [x.requires_grad_(True) for x in leaves]
    y, den, m, fin, saved = ssd_chunk_scan_plain(*leaves, chunk=chunk,
                                                 chunk_states=True)
    out = y / torch.maximum(den.abs(), torch.exp(-m))[..., None]
    R = _t(_np(5, (B, S, H, P)))
    got = torch.autograd.grad((R * out).sum(), leaves)
    yl, dl = y.detach().requires_grad_(True), den.detach().requires_grad_(True)
    o2 = yl / torch.maximum(dl.abs(), torch.exp(-m.detach()))[..., None]
    dy, dden = torch.autograd.grad((R * o2).sum(), (yl, dl))
    ref = ssd_chunk_scan_bwd_plain(*(x.detach() for x in leaves),
                                   m.detach(), [x.detach() for x in saved],
                                   fin[2].detach(), dy, dden, chunk=chunk)
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))


def test_gla_step():
    B, H, N, P = 2, 3, 8, 16
    q, k, v = _np(0, (B, H, N)), _np(1, (B, H, N)), _np(2, (B, H, P))
    la, li = _gates(3, (B, H))
    st = (_np(5, (B, H, N, P)), _np(6, (B, H, N)), _np(7, (B, H)))
    outj = JS.gla_step(*map(jnp.asarray, (q, k, v, la, li)),
                       JS.GLAState(*map(jnp.asarray, st)))
    outt = TS.gla_step(*map(_t, (q, k, v, la, li)),
                       TS.GLAState(*map(_t, st)))
    for a, b in zip(outt[:3] + tuple(outt[3]), outj[:3] + tuple(outj[3])):
        _close(a, b)


# ------------------------------------------------------------ layers
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    W, C = 4, 12
    p = {"w": _np(0, (W, C)), "b": _np(1, (C,))}
    x = _np(2, (2, 5, C))
    st = _np(3, (2, W - 1, C)) if with_state else None
    yj, sj = JS.causal_conv(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            None if st is None else jnp.asarray(st))
    yt, s_t = TS.causal_conv({k: _t(v) for k, v in p.items()}, _t(x),
                             None if st is None else _t(st))
    _close(yt, yj)
    _close(s_t, sj)
    yj, sj = JS.causal_conv_step(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x[:, :1]), sj)
    yt, s_t = TS.causal_conv_step({k: _t(v) for k, v in p.items()},
                                  _t(x[:, :1]), s_t)
    _close(yt, yj)
    _close(s_t, sj)


def test_groupnorm_heads():
    x, w = _np(0, (2, 5, 3, 16)), _np(1, (3, 16))
    _close(TL.groupnorm_heads(_t(x), _t(w), 1e-5),
           JL.groupnorm_heads(jnp.asarray(x), jnp.asarray(w), 1e-5))


def _cache_pair(j, t):
    """Compare a JAX cache subtree with the port's (layer lists where JAX
    stacks on a leading axis are compared entry by entry)."""
    for a, b in zip(jax.tree.leaves(j), TS.tree_leaves(t)):
        _close(b, a)


def test_mamba2_block(models):
    jcfg, tcfg, jp, tp = models["ssm"]
    pj = jax.tree.map(lambda x: x[0], jp["blocks"])
    pt = tp.blocks[0]
    x = _np(0, (2, 11, jcfg.d_model))
    yj, cj = JS.mamba2_forward(pj, jnp.asarray(x), jcfg)
    yt, ct = TS.mamba2_forward(pt, _t(x), tcfg)
    _close(yt, yj)
    _cache_pair(cj, ct)
    # continue the segment by one step and by a 5-token extend
    x1 = _np(1, (2, 1, jcfg.d_model))
    yj, sj = JS.mamba2_step(pj, jnp.asarray(x1), cj, jcfg)
    yt, s_t = TS.mamba2_step(pt, _t(x1), ct, tcfg)
    _close(yt, yj)
    _cache_pair(sj, s_t)
    x5 = _np(2, (2, 5, jcfg.d_model))
    yj, sj = JS.mamba2_forward(pj, jnp.asarray(x5), jcfg, cache=cj)
    yt, s_t = TS.mamba2_forward(pt, _t(x5), tcfg, cache=ct)
    _close(yt, yj)
    _cache_pair(sj, s_t)


def test_xlstm_blocks(models):
    jcfg, tcfg, jp, tp = models["xlstm"]
    x = _np(0, (2, 9, jcfg.d_model))
    x1 = _np(1, (2, 1, jcfg.d_model))
    for l in range(jcfg.num_layers):
        pj, pt = jp["blocks"][l], tp.blocks[l]
        slstm = JX.is_slstm(jcfg, l)
        assert slstm == TX.is_slstm(tcfg, l)
        fj, sj_ = (JX.slstm_forward, JX.slstm_step) if slstm else \
            (JX.mlstm_forward, JX.mlstm_step)
        ft, st_ = (TX.slstm_forward, TX.slstm_step) if slstm else \
            (TX.mlstm_forward, TX.mlstm_step)
        yj, cj = fj(pj, jnp.asarray(x), jcfg)
        yt, ct = ft(pt, _t(x), tcfg)
        _close(yt, yj)
        _cache_pair(cj, ct)
        yj, cj = sj_(pj, jnp.asarray(x1), cj, jcfg)
        yt, ct = st_(pt, _t(x1), ct, tcfg)
        _close(yt, yj)
        _cache_pair(cj, ct)


# ------------------------------------------------------------ models
def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def _jax_layers(family, jc):
    """JAX cache in the port's layout: per-layer lists where JAX stacks."""
    if family == "ssm":
        L = jax.tree.leaves(jc["layers"])[0].shape[0]
        return [jax.tree.map(lambda x: x[l], jc["layers"]) for l in range(L)]
    if family == "hybrid":
        G, K = jax.tree.leaves(jc["mamba"])[0].shape[:2]
        return [jax.tree.map(lambda x: x[g, k], jc["mamba"])
                for g in range(G) for k in range(K)]
    return jc["layers"]


def _same_cache(family, jc, tc):
    key = "mamba" if family == "hybrid" else "layers"
    _cache_pair(_jax_layers(family, jc), tc[key])
    if family == "hybrid":
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("family", list(ARCHS))
def test_model_entries(models, family):
    """forward, prefill, decode_step and extend_step against JAX, logits
    and caches; ``block_mask`` is refused as in JAX; the family neither
    pages nor rewinds by ``pos``."""
    jcfg, tcfg, jp, tp = models[family]
    jm, tm = JModel(jcfg), TModel(tcfg)
    toks = _tokens(0, (2, 15))
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tp, {"tokens": _t(toks)})
    _close(tl, jl, LOGIT_TOL)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=24)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)}, max_seq=24)
    _close(tl, jl, LOGIT_TOL)
    _same_cache(family, jc, tc)
    one = _tokens(1, (2, 1))
    jl, jc = jm.decode_step(jp, jnp.asarray(one), jc)
    tl, tc = tm.decode_step(tp, _t(one), tc)
    _close(tl, jl, LOGIT_TOL)
    _same_cache(family, jc, tc)
    five = _tokens(2, (2, 5))
    jl, jc = jm.extend_step(jp, jnp.asarray(five), jc)
    tl, tc = tm.extend_step(tp, _t(five), tc)
    _close(tl, jl, LOGIT_TOL)
    _same_cache(family, jc, tc)
    assert not tm.paged_kv and not tm.rewindable_cache
    with pytest.raises(ValueError):
        tm.extend_step(tp, _t(five), tc, block_mask=torch.ones(5, 5))


@pytest.mark.parametrize("family", list(ARCHS))
def test_replay_step_per_slot_counts(models, family):
    """The batched replay with per-slot counts equals JAX's ``replay_step``
    vmapped over slots (each slot a single-sequence cache), and count 0
    leaves a slot on its snapshot."""
    jcfg, tcfg, jp, tp = models[family]
    jm, tm = JModel(jcfg), TModel(tcfg)
    B, T = 3, 5
    toks = _tokens(0, (B, 12))
    tape = _tokens(1, (B, T))
    counts = np.array([0, 2, 5], np.int32)
    _, tc = tm.prefill(tp, {"tokens": _t(toks)}, max_seq=24)
    tc = {**tc, "pos": tc["pos"].expand(B).clone()}        # per-slot pos
    out = tm.replay_step(tp, _t(tape), tc, _t(counts))
    for b in range(B):
        _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[b:b + 1])},
                           max_seq=24)
        jc = jm.replay_step(jp, jnp.asarray(tape[b:b + 1]), jc,
                            jnp.int32(counts[b]))
        one = TS.tree_map(lambda x: x[b:b + 1], {
            k: v for k, v in out.items() if k not in ("k", "v", "pos")})
        key = "mamba" if family == "hybrid" else "layers"
        _cache_pair(_jax_layers(family, jc), one[key])
        assert int(out["pos"][b]) == int(jc["pos"])
        if family == "hybrid":     # the committed K/V rows
            n = int(jc["pos"])
            _close(out["k"][:, b:b + 1, :n], jc["k"][:, :, :n])


# ------------------------------------------------------------ serving glue
def test_bridge_keeps_float32_leaves():
    """Under a bfloat16 config the gate and norm leaves JAX keeps in
    float32 stay float32 across the bridge; the rest is bfloat16."""
    for family, f32 in (("ssm", TS.F32_LEAVES), ("xlstm", TX.F32_LEAVES),
                        ("hybrid", TS.F32_LEAVES)):
        jcfg, tcfg = _cfgs(family)
        jcfg = jcfg.replace(param_dtype="bfloat16")
        tcfg = tcfg.replace(param_dtype="bfloat16")
        jp = JModel(jcfg).init(jax.random.PRNGKey(0))
        tp = params_from_numpy(_host(jp), tcfg, "cpu")
        own = TModel(tcfg).init(seed=0, device="cpu")
        for params in (tp, own):
            seen = set()
            for name, p in params.named_parameters():
                leaf = name.split(".")[-1]
                want = torch.float32 if leaf in f32 else torch.bfloat16
                assert p.dtype == want, (family, name, p.dtype)
                seen.add(leaf)
            assert seen & set(f32), family


@pytest.mark.parametrize("family", list(ARCHS))
def test_bfloat16_engine_keeps_slot_dtypes(family):
    """At bfloat16 a prefill returns its conv state in the activation type
    while the slots keep float32 (as JAX's slot init does): admission casts
    on the slot write, and a speculative drain with chunked prefill runs
    through to the end."""
    from repro_torch.core.policy import SpeculativePolicy
    from repro_torch.core.scheduler import BatchedEngine
    bf = dict(param_dtype="bfloat16", activ_dtype="bfloat16")
    ecfg = _cfgs(family)[1].replace(**bf)
    ccfg = tget("granite-8b").reduced().replace(vocab_size=512, **bf)
    em, cm = TModel(ecfg), TModel(ccfg)
    ep, cp = em.init(seed=0, device="cpu"), cm.init(seed=1, device="cpu")
    eng = BatchedEngine(em, cm, batch_size=2, gamma=2, temperature=0.0,
                        policy=SpeculativePolicy(0.6), prefill_chunk=4)
    prompts = [_tokens(i, (n,)) for i, n in enumerate((9, 6, 12))]
    traces = eng.serve_batch(ep, cp, prompts, 5)
    assert [len(t.tokens) for t in traces] == [5, 5, 5]
    state = eng.edge.make_state(ep, 2, 24)
    state.admit(0, prompts[0], 13)
    state.flush()
    key = "mamba" if family == "hybrid" else "layers"
    for st in state.caches[key]:
        assert all(x.dtype == torch.float32 for x in TS.tree_leaves(st))


@pytest.mark.parametrize("family", list(ARCHS))
def test_recurrent_snapshot_survives_a_draft(models, family):
    """A recurrent snapshot is unchanged by the round's draft steps and
    verify extend (states are new tensors, the slabs are copied), and a
    commit of count 0 restores it exactly."""
    _, tcfg, _, tp = models[family]
    tm = TModel(tcfg)
    ops = SpecOps(tm, "recurrent")
    B = 2
    _, caches = tm.prefill(tp, {"tokens": _t(_tokens(0, (B, 10)))},
                           max_seq=24)
    caches = {**caches, "pos": caches["pos"].expand(B).clone()}
    snap = ops.snapshot(caches)
    before = TS.tree_map(lambda x: x.clone(), snap)
    tok = _t(_tokens(1, (B, 1, 1)))
    for _ in range(3):
        _, caches = ops.step(tp, tok, caches)
    _, caches = ops.extend(tp, _t(_tokens(2, (B, 4))), caches)
    for a, b in zip(TS.tree_leaves(before), TS.tree_leaves(snap)):
        assert torch.equal(a, b)
    back = ops.commit(tp, caches, snap, _t(_tokens(3, (B, 4))),
                      torch.zeros(B, dtype=torch.int32))
    # the state and pos come back bit for bit; the slabs keep every
    # committed row (dead replay steps write only AT pos, which is masked)
    state = lambda c: {k: v for k, v in c.items() if k not in ("k", "v")}
    for a, b in zip(TS.tree_leaves(state(before)),
                    TS.tree_leaves(state(back))):
        assert torch.equal(a, b)
    if family == "hybrid":
        for name in ("k", "v"):
            assert torch.equal(back[name][:, :, :10], before[name][:, :, :10])
    # on the recurrent layout the replay commit is the commit
    tape, counts = _t(_tokens(4, (B, 4))), _t(np.array([1, 3], np.int32))
    a = ops.commit(tp, caches, snap, tape, counts)
    b = ops.commit_replay(tp, caches, snap, tape, counts)
    for x, y in zip(TS.tree_leaves(state(a)), TS.tree_leaves(state(b))):
        assert torch.equal(x, y)
