"""The encdec (whisper) and vlm (paligemma) families in the port vs the JAX
package, on the CPU: layers, the model API, the trainer, early exit,
distillation, LoRA targets and checkpoints, and the prefix-LM and
cross-attention forms of the flash kernels' plain versions.

Parameters are the JAX init of the reduced (float32, 2-layer) configs,
bridged into the port with ``params_from_numpy``; inputs and stub inputs
(vlm ``embeds``, encdec ``frames``) come from numpy seeds and go to both
frameworks.  Tolerances (float32, sums in another order): layer outputs
1e-5, logits 1e-4, losses 1e-5, gradients rtol 1e-4 / atol 1e-5, one AdamW
step on the same gradients 1e-6 (its global gradient norm 1e-5
relative), a five-step loss history 1e-4; tokens,
checkpoints and LoRA targets exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.core import early_exit as JE  # noqa: E402
from repro.data.pipeline import batches as jbatches  # noqa: E402
from repro.kernels import flash_attention as JF  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import checkpoint as jck  # noqa: E402
from repro.training import distillation as jdist  # noqa: E402
from repro.training import lora as jlora  # noqa: E402
from repro.training.optimizer import AdamW as JAdamW  # noqa: E402
from repro.training.trainer import train as jtrain  # noqa: E402
from repro_torch.bridge import (jax_ndims, params_from_numpy,  # noqa: E402
                                params_to_numpy)
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import early_exit as TE  # noqa: E402
from repro_torch.data.pipeline import batches as tbatches  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain, flash_bwd_plan)
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.model import example_batch  # noqa: E402
from repro_torch.training import checkpoint as tck  # noqa: E402
from repro_torch.training import distillation as tdist  # noqa: E402
from repro_torch.training import lora as tlora  # noqa: E402
from repro_torch.training import tree as T  # noqa: E402
from repro_torch.training.optimizer import AdamW as TAdamW  # noqa: E402
from repro_torch.training.trainer import train as ttrain  # noqa: E402

ARCHS = {"encdec": "whisper-small", "vlm": "paligemma-3b"}
FAMS = list(ARCHS)
STUB = {"encdec": "frames", "vlm": "embeds"}
LOGIT_TOL = 1e-4


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(t_out, j_out, tol=1e-5):
    np.testing.assert_allclose(t_out.detach().float().numpy(),
                               np.asarray(j_out, np.float32), atol=tol,
                               rtol=tol)


def _leaves_close(a_tree, b_tree, rtol, atol):
    fa, ta = jax.tree_util.tree_flatten_with_path(a_tree)
    fb, tb = jax.tree_util.tree_flatten_with_path(b_tree)
    assert ta == tb
    for (path, a), (_, b) in zip(fa, fb):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), rtol=rtol,
                                   atol=atol, err_msg=str(path))


def _cfgs(arch):
    return jget(arch).reduced(), tget(arch).reduced()


@pytest.fixture(scope="module")
def models():
    out = {}
    for fam, arch in ARCHS.items():
        jcfg, tcfg = _cfgs(arch)
        jp = JModel(jcfg).init(jax.random.PRNGKey(3))
        out[fam] = (jcfg, tcfg, jp, params_from_numpy(_host(jp), tcfg, "cpu"))
    return out


def _stub(cfg, B, seed):
    rows = cfg.encoder_seq if cfg.family == "encdec" else cfg.num_image_tokens
    return _np(seed, (B, rows, cfg.d_model))


def _batch(cfg, B=2, S=12, seed=0, labels=True):
    """(JAX batch, port batch): tokens, labels (some ignored) and the
    family's stub input."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         STUB[cfg.family]: _stub(cfg, B, seed + 100)}
    if labels:
        lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        lab[0, :3] = -1
        b["labels"] = lab
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: _t(v) for k, v in b.items()})


def _port_grads(model, params, batch, **kw):
    train_p = T.replace(params, [t.detach().requires_grad_(True)
                                 for t in T.tensors(params)])
    loss = model.loss(train_p, batch, **kw)
    grads = torch.autograd.grad(loss, T.tensors(train_p))
    return loss, T.replace(params, list(grads))


# ------------------------------------------------------------ layers
def test_layernorm():
    x, w, b = _np(0, (2, 5, 32)), _np(1, (32,), 0.1) + 1, _np(2, (32,), 0.1)
    _close(TL.layernorm(_t(x), _t(w), _t(b)),
           JL.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("Sq", [1, 5])
def test_cross_attention(models, Sq):
    """cross_attention_kv and cross_attention (no mask; one query row takes
    the decode-kernel branch on CUDA, several the flash branch)."""
    jcfg, tcfg, jp, _ = models["encdec"]
    j = {k: v[0] for k, v in jp["decoder"]["cross"].items()}
    t = {k: _t(v) for k, v in _host(j).items()}
    enc, x = _np(0, (2, 16, jcfg.d_model)), _np(1, (2, Sq, jcfg.d_model))
    jk, jv = JL.cross_attention_kv(j, jnp.asarray(enc), jcfg)
    tk, tv = TL.cross_attention_kv(t, _t(enc), tcfg)
    _close(tk, jk)
    _close(tv, jv)
    for backend in ("auto", "plain"):
        _close(TL.cross_attention(t, _t(x), tk, tv, tcfg, backend=backend),
               JL.cross_attention(j, jnp.asarray(x), jk, jv, jcfg))


@pytest.mark.parametrize("prefix_len,window", [(4, 0), (9, 0), (4, 5)])
def test_attention_block_prefix(models, prefix_len, window):
    jcfg, tcfg, jp, _ = models["vlm"]
    j = {k: v[0] for k, v in jp["blocks"]["attn"].items()}
    t = {k: _t(v) for k, v in _host(j).items()}
    x = _np(3, (2, 12, jcfg.d_model))
    pos = np.arange(12, dtype=np.int32)
    to, (tk, _) = TL.attention_block(t, _t(x), _t(pos), tcfg, window=window,
                                     prefix_len=prefix_len)
    jo, (jk, _) = JL.attention_block(j, jnp.asarray(x), jnp.asarray(pos),
                                     jcfg, window=window,
                                     prefix_len=prefix_len)
    _close(to, jo)
    _close(tk, jk)


@pytest.mark.parametrize("causal,window,prefix_len,G",
                         [(True, 0, 5, 1), (True, 0, 40, 3), (True, 7, 12, 2),
                          (True, 0, 0, 2), (False, 0, 9, 1)])
def test_flash_plain_prefix_matches_jax(causal, window, prefix_len, G):
    """flash_attention_plain(prefix_len=) against JAX's ``mha`` under
    ``_attn_mask(prefix_len=)`` and against ``mha_chunked(prefix_len=)``
    (over 16-row blocks); a non-causal call ignores the prefix, as JAX's
    mask does."""
    B, Kv, S, hd = 2, 2, 32, 16
    q = _np(0, (B, Kv * G, S, hd))
    k, v = _np(1, (B, Kv, S, hd)), _np(2, (B, Kv, S, hd))
    out = flash_attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                window=window, prefix_len=prefix_len)
    pos = jnp.arange(S)
    mask = JL._attn_mask(pos, pos, causal=causal, window=window,
                         prefix_len=prefix_len)
    jq, jk, jv = (jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v))
    ref = JL.mha(jq, jk, jv, mask=mask).transpose(0, 2, 1, 3)
    _close(out, ref)
    chunked = JL.mha_chunked(jq, jk, jv, causal=causal, window=window,
                             prefix_len=prefix_len, bq=16, bk=16)
    _close(out, chunked.transpose(0, 2, 1, 3))
    tch = TL.mha_chunked(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                         _t(v).transpose(1, 2), causal=causal, window=window,
                         prefix_len=prefix_len, bq=16, bk=16)
    _close(tch, chunked)


@pytest.mark.parametrize("Sq,Sk,hd", [(16, 128, 32), (64, 192, 64)])
def test_flash_plain_cross_matches_pallas(Sq, Sk, hd):
    """The non-causal Sq != Sk plain version (cross attention) against the
    Pallas kernel in interpret mode, at shapes that divide its blocks."""
    B, H = 2, 3
    q = _np(4, (B, H, Sq, hd))
    k, v = _np(5, (B, H, Sk, hd)), _np(6, (B, H, Sk, hd))
    ref = JF.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=False, bq=16, bk=64, interpret=True)
    _close(flash_attention_plain(_t(q), _t(k), _t(v), causal=False), ref)


def _visible(Sq, Sk, causal, window, prefix):
    i = np.arange(Sq)[:, None]
    j = np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis = (j <= i) | (j < prefix)
    if window:
        vis = vis & (j > i - window)
    return vis


@pytest.mark.parametrize("G,S,window,prefix", [
    (8, 272, 0, 256), (1, 100, 0, 37), (3, 90, 0, 64), (4, 75, 17, 20),
    (2, 130, 0, 200), (8, 40, 0, 1)])
def test_flash_bwd_plan_walks_the_prefix(G, S, window, prefix):
    """With a prefix (paligemma's 8 heads on one kv head at 256 + 16 rows,
    prefixes that end inside and at the edge of a tile, one past S, and
    under a window) every (query tile, key tile) pair holding a visible
    (row, key) is walked by both blocks of the backward, and each walk
    starts and ends on such a pair, on both routes."""
    vis = _visible(S, S, True, window, prefix)
    for dtype in (torch.bfloat16, torch.float32):
        plan = flash_bwd_plan(dtype, 64, G, S, S, True, window, prefix)
        t, pack = plan.tile, plan.pack
        packed = np.repeat(vis, pack, axis=0)

        def seen(qt, kt):
            return packed[qt * t:(qt + 1) * t, kt * t:(kt + 1) * t].any()

        for kt in range(plan.n_key_tiles):
            walk = plan.query_tiles(kt)
            assert all(qt in walk for qt in range(plan.n_query_tiles)
                       if seen(qt, kt))
            if len(walk):
                assert seen(walk[0], kt) and seen(walk[-1], kt)
        for qt in range(plan.n_query_tiles):
            walk = plan.key_tiles(qt)
            assert all(kt in walk for kt in range(plan.n_key_tiles)
                       if seen(qt, kt))
            assert len(walk) and seen(qt, walk[0]) and seen(qt, walk[-1])


# ------------------------------------------------------------ model
def test_example_batch():
    for fam, arch in ARCHS.items():
        cfg = tget(arch).reduced()
        b = example_batch(cfg, 2, 21, device="cpu")
        s_text = 21 - cfg.num_image_tokens if fam == "vlm" else 21
        assert b["tokens"].shape == b["labels"].shape == (2, s_text)
        rows = cfg.encoder_seq if fam == "encdec" else cfg.num_image_tokens
        assert b[STUB[fam]].shape == (2, rows, cfg.d_model)
        assert b[STUB[fam]].dtype == torch.float32
    vlm = tget("paligemma-3b").reduced()
    assert example_batch(vlm, 1, 6, device="cpu")["tokens"].shape == (1, 8)


@pytest.mark.parametrize("fam", FAMS)
def test_forward_and_loss_match_jax(models, fam):
    jcfg, tcfg, jp, tp = models[fam]
    jb, tb = _batch(jcfg)
    jm, tm = JModel(jcfg), TModel(tcfg)
    jl, jaux, jh = jm.forward(jp, jb, collect_hidden=True)
    tl, taux, th = tm.forward(tp, tb, collect_hidden=True)
    _close(tl, jl, LOGIT_TOL)
    _close(th, jh, LOGIT_TOL)
    assert float(taux) == float(jaux) == 0.0
    assert abs(float(tm.loss(tp, tb)) - float(jm.loss(jp, jb))) <= 1e-5


@pytest.mark.parametrize("fam", FAMS)
def test_prefill_decode_extend_consistency(models, fam):
    """tests/test_consistency.py's check in the port — prefill, one
    decode step and a 4-token extend against the teacher-forced forward —
    and each step's logits and cache against JAX's."""
    jcfg, tcfg, jp, tp = models[fam]
    jb, tb = _batch(jcfg, S=21, labels=False)
    jm, tm = JModel(jcfg), TModel(tcfg)
    full = tm.forward(tp, tb)[0]
    off = jcfg.num_image_tokens if fam == "vlm" else 0
    cut = 16

    def part(b, lo, hi):
        return {**b, "tokens": b["tokens"][:, lo:hi]}

    tlg, tc = tm.prefill(tp, part(tb, 0, cut), max_seq=40)
    jlg, jc = jm.prefill(jp, part(jb, 0, cut), max_seq=40)
    _close(tlg, full[:, off + cut - 1], 2e-3)
    _close(tlg, jlg, LOGIT_TOL)
    for key in jc:
        _close(tc[key], jc[key])
    tl1, tc = tm.decode_step(tp, tb["tokens"][:, cut:cut + 1], tc)
    jl1, jc = jm.decode_step(jp, jb["tokens"][:, cut:cut + 1], jc)
    _close(tl1, full[:, off + cut], 2e-3)
    _close(tl1, jl1, LOGIT_TOL)
    tl4, tc = tm.extend_step(tp, tb["tokens"][:, cut + 1:], tc)
    jl4, jc = jm.extend_step(jp, jb["tokens"][:, cut + 1:], jc)
    _close(tl4, full[:, off + cut + 1:], 2e-3)
    _close(tl4, jl4, LOGIT_TOL)
    for key in jc:
        _close(tc[key], jc[key])


def test_encdec_decoder_positions_clamp(models):
    """A step at pos past the position table reads its last rows, as
    ``lax.dynamic_slice_in_dim`` clamps its start."""
    jcfg, tcfg, jp, tp = models["encdec"]
    jb, tb = _batch(jcfg, S=4, labels=False)
    jm, tm = JModel(jcfg), TModel(tcfg)
    _, jc = jm.prefill(jp, jb, max_seq=8)
    _, tc = tm.prefill(tp, tb, max_seq=8)
    P = jcfg.max_position_embeddings
    jc = {**jc, "pos": jnp.asarray(P - 1, jnp.int32)}
    tc = {**tc, "pos": torch.tensor(P - 1, dtype=torch.int32)}
    tl, _ = tm.extend_step(tp, tb["tokens"][:, :3], tc)
    jl, _ = jm.extend_step(jp, jb["tokens"][:, :3], jc)
    _close(tl, jl, LOGIT_TOL)


@pytest.mark.parametrize("fam", FAMS)
def test_greedy_tokens_match_jax(models, fam):
    jcfg, tcfg, jp, tp = models[fam]
    jb, tb = _batch(jcfg, S=6, seed=7, labels=False)
    jm, tm = JModel(jcfg), TModel(tcfg)
    jlg, jc = jm.prefill(jp, jb, max_seq=20)
    tlg, tc = tm.prefill(tp, tb, max_seq=20)
    jstep = jax.jit(jm.decode_step)
    jt, tt = [], []
    for _ in range(10):
        jn = jnp.argmax(jlg, -1).astype(jnp.int32)
        tn = torch.argmax(tlg, -1).to(torch.int32)
        jt.append(np.asarray(jn).tolist())
        tt.append(tn.tolist())
        jlg, jc = jstep(jp, jn[:, None], jc)
        tlg, tc = tm.decode_step(tp, tn[:, None], tc)
    assert tt == jt


@pytest.mark.parametrize("fam", FAMS)
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(models, fam, remat):
    jcfg, tcfg, jp, tp = models[fam]
    jb, tb = _batch(jcfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JModel(jcfg).loss(p, jb, remat=remat))(jp)
    tloss, tgrads = _port_grads(TModel(tcfg), tp, tb, remat=remat)
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-5
    _leaves_close(params_to_numpy(tgrads, tcfg), _host(jgrads), 1e-4, 1e-5)


def _rand_tree(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: rng.standard_normal(x.shape)
                        .astype(np.float32), tree)


@pytest.mark.parametrize("fam", FAMS)
def test_adamw_steps_match_jax(models, fam):
    """Two AdamW steps on the same gradients, and JAX's decay rule: the
    stacked (L, d) block norms and the position tables are decayed, the
    final norms are not."""
    jcfg, tcfg, jp, tp = models[fam]
    jopt, topt = JAdamW(lr=1e-2), TAdamW(lr=1e-2)
    jst, tst = jopt.init(jp), topt.init(tp)
    decay = dict(zip([n for n, _ in T.leaves(tp)], tst.decay))
    if fam == "encdec":
        assert decay["encoder.0.attn_norm_w"]
        assert decay["decoder.1.cross_norm_b"]
        assert decay["enc_pos"] and decay["dec_pos"]
        assert not decay["enc_norm_w"] and not decay["final_norm_b"]
        assert jax_ndims(tp, tcfg)["decoder.0.mlp_norm_w"] == 2
    else:
        assert decay["blocks.0.attn_norm"] and not decay["final_norm"]
    for step in range(2):
        g = _rand_tree(_host(jp), step)
        jp, jst, jn = jopt.update(jax.tree.map(jnp.asarray, g), jst, jp)
        tg = T.tensors(params_from_numpy(g, tcfg, "cpu"))
        tp, tst, tn = topt.update(tg, tst, tp)
        # the global norm sums 1.2e6 squares for encdec (the 4096-row
        # decoder position table) in another order: 1e-5 relative
        assert abs(float(tn) - float(jn)) <= 1e-5 * float(jn)
        _leaves_close(params_to_numpy(tp, tcfg), _host(jp), 1e-6, 1e-6)


@pytest.mark.parametrize("fam", FAMS)
def test_five_step_train_matches_jax(fam):
    """train() on the pipeline's stream (the same tokens and stub inputs,
    drawn in JAX's order) and the loss history of five steps."""
    jcfg, tcfg = _cfgs(ARCHS[fam])
    jp = JModel(jcfg).init(jax.random.PRNGKey(7))
    tp = params_from_numpy(_host(jp), tcfg, "cpu")
    fj = next(jbatches(jcfg, 2, 16, seed=3))
    ft = next(tbatches(tcfg, 2, 16, seed=3, device="cpu"))
    assert set(fj) == set(ft)
    for key in fj:
        assert np.array_equal(np.asarray(fj[key]), ft[key].numpy()), key
    kw = dict(steps=5, log_every=1, log=lambda *_: None)
    jres = jtrain(JModel(jcfg), jp, jbatches(jcfg, 2, 16, seed=3),
                  opt=JAdamW(lr=3e-3), **kw)
    tres = ttrain(TModel(tcfg), tp, tbatches(tcfg, 2, 16, seed=3,
                                             device="cpu"),
                  opt=TAdamW(lr=3e-3), **kw)
    jh = np.array([l for _, l in jres["history"]])
    th = np.array([l for _, l in tres["history"]])
    assert len(th) == 5
    np.testing.assert_allclose(th, jh, atol=1e-4, rtol=0)


@pytest.mark.parametrize("fam", FAMS)
def test_checkpoints_cross_between_packages(models, fam, tmp_path):
    jcfg, tcfg, jp, tp = models[fam]
    jck.save(str(tmp_path / "jp"), jp, step=4)
    back, step = tck.restore(str(tmp_path / "jp"), tp, cfg=tcfg)
    assert step == 4
    _leaves_close(params_to_numpy(back, tcfg), _host(jp), 0, 0)
    moved = T.replace(tp, [t + 1.0 for t in T.tensors(tp)])
    tck.save(str(tmp_path / "tp"), moved, step=6, cfg=tcfg)
    jback, step = jck.restore(str(tmp_path / "tp"), jp)
    assert step == 6
    _leaves_close(_host(jback), params_to_numpy(moved, tcfg), 0, 0)


@pytest.mark.parametrize("fam", FAMS)
def test_train_launcher_saves_for_jax(fam, tmp_path):
    """``launch/train.py --save`` on the CPU at reduced size: the loss is
    finite and the file restores in JAX leaf for leaf."""
    from repro_torch.launch.train import main
    path = str(tmp_path / "ck.npz")
    res = main(["--arch", ARCHS[fam], "--device", "cpu", "--reduced",
                "--steps", "2", "--batch", "2", "--seq", "16", "--remat",
                "--save", path])
    assert all(np.isfinite(l) for _, l in res["history"])
    jcfg = jget(ARCHS[fam]).reduced()
    like = JModel(jcfg).init(jax.random.PRNGKey(0))
    jback, step = jck.restore(path, like)
    assert step == 2
    _leaves_close(_host(jback), params_to_numpy(res["params"],
                                                tget(ARCHS[fam]).reduced()),
                  0, 0)


# ------------------------------------------------------------ library
@pytest.mark.parametrize("fam", FAMS)
def test_early_exit_matches_jax(models, fam):
    """exit_logits (the encdec layernorm head) and the LayerSkip loss (the
    vlm prefix rows sliced off)."""
    jcfg, tcfg, jp, tp = models[fam]
    jb, tb = _batch(jcfg)
    jm, tm = JModel(jcfg), TModel(tcfg)
    _, _, jh = jm.forward(jp, jb, collect_hidden=True)
    _, _, th = tm.forward(tp, tb, collect_hidden=True)
    _close(TE.exit_logits(tm, tp, th, [0, 1]),
           JE.exit_logits(jm, jp, jh, [0, 1]), LOGIT_TOL)
    jl, jce = JE.layerskip_loss(jm, jp, jb, [0])
    tl, tce = TE.layerskip_loss(tm, tp, tb, [0])
    assert abs(float(tl) - float(jl)) <= 1e-5
    _close(tce, jce)


def test_vlm_kd_losses_match_jax(models):
    jcfg, tcfg, jp, tp = models["vlm"]
    jb, tb = _batch(jcfg)
    teacher = _np(11, (2, 12, jcfg.vocab_size), 3.0)
    mask = np.random.default_rng(11).random((2, 12)) < 0.5
    jm, tm = JModel(jcfg), TModel(tcfg)
    pairs = [
        (jdist.kd_loss(jm, jp, jb, jnp.asarray(teacher), alpha=0.3,
                       kd_mask=jnp.asarray(mask)),
         tdist.kd_loss(tm, tp, tb, _t(teacher), alpha=0.3, kd_mask=_t(mask))),
        (jdist.reverse_kd_loss(jm, jp, jb, jnp.asarray(teacher),
                               temperature=1.5),
         tdist.reverse_kd_loss(tm, tp, tb, _t(teacher), temperature=1.5)),
    ]
    for j, t in pairs:
        assert abs(float(t) - float(j)) <= 1e-5 * max(1.0, abs(float(j)))
    tl = tdist.teacher_logits_fn(tm, tp)(tb)
    assert tl.shape == (2, 12, tcfg.vocab_size)
    _close(tl, jdist.teacher_logits_fn(jm, jp)(jb), LOGIT_TOL)


@pytest.mark.parametrize("fam", FAMS)
def test_lora_target_paths_match_jax(models, fam):
    """LoRA's default targets: JAX's paths in JAX's order — for encdec the
    encoder's and the decoder's self-attention, not the cross-attention —
    and a merge of JAX's adapters."""
    jcfg, tcfg, jp, tp = models[fam]
    paths = tlora.target_paths(tp)
    assert paths == jlora.target_paths(jp)
    if fam == "encdec":
        assert sorted(paths) == sorted(f"{s}/attn/{w}"
                                       for s in ("encoder", "decoder")
                                       for w in ("wq", "wk", "wv", "wo"))
    ad = jlora.init_lora(jax.random.PRNGKey(0), jp, rank=4)
    ad = {p: {**a, "B": jnp.asarray(_np(i, a["B"].shape, 0.05))}
          for i, (p, a) in enumerate(ad.items())}
    tad = {p: {k: _t(np.asarray(v)) for k, v in a.items()}
           for p, a in ad.items()}
    _leaves_close(params_to_numpy(tlora.merge_lora(tp, tad), tcfg),
                  _host(jlora.merge_lora(jp, ad)), 1e-5, 1e-5)


@pytest.mark.parametrize("backend", ["auto", "plain", "gather"])
def test_vlm_paged_decode_matches_jax(models, backend):
    """vlm paged decode (the dense decoder's, at one kv head) against JAX's
    ``attn_backend="ref"`` (or "gather")."""
    jcfg, tcfg, jp, tp = models["vlm"]
    B, bs, MB = 3, 8, 4
    NB = B * MB + 1
    shape = (jcfg.num_layers, NB, bs, jcfg.num_kv_heads, jcfg.head_dim)
    table = np.random.default_rng(0).permutation(np.arange(1, NB)) \
        .reshape(B, MB).astype(np.int32)
    c = {"k": _np(1, shape), "v": _np(2, shape), "table": table,
         "pos": np.array([0, 7, 30], np.int32)}
    tok = np.array([[5], [17], [300]], np.int32)
    tl, tc = TT.paged_decode_step(tp, _t(tok), {k: _t(v) for k, v in
                                                c.items()}, tcfg,
                                  attn_backend=backend)
    jl, jc = JT.paged_decode_step(jp, jnp.asarray(tok),
                                  {k: jnp.asarray(v) for k, v in c.items()},
                                  jcfg, attn_backend="gather"
                                  if backend == "gather" else "ref")
    _close(tl, jl, LOGIT_TOL)
    _close(tc["k"], jc["k"])


def _kernel_route(monkeypatch):
    """Send every "auto" attention read down its kernel route on the CPU,
    where each kernel wrapper runs its plain version, and count the reads
    of the extend kernels."""
    from repro_torch.kernels import ops
    monkeypatch.setattr(TL, "use_kernel", lambda backend, x:
                        backend == "auto")
    calls = {"tree_verify_attention": 0, "paged_decode_attention": 0}
    for name in calls:
        def counted(*a, _name=name, _fn=getattr(ops, name), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("fam", FAMS)
def test_linear_extend_kernel_route_matches_jax(models, fam, monkeypatch):
    """On CUDA a linear extend of either family reads the tree-verify
    kernel under a causal block mask: that route (the kernel's plain
    version here) gives JAX's logits and cache."""
    jcfg, tcfg, jp, tp = models[fam]
    jb, tb = _batch(jcfg, S=20, seed=3, labels=False)
    jm, tm = JModel(jcfg), TModel(tcfg)

    def part(b, lo, hi):
        return {**b, "tokens": b["tokens"][:, lo:hi]}

    _, jc = jm.prefill(jp, part(jb, 0, 16), max_seq=32)
    _, tc = tm.prefill(tp, part(tb, 0, 16), max_seq=32)
    calls = _kernel_route(monkeypatch)
    tl, tc = tm.extend_step(tp, tb["tokens"][:, 16:], tc)
    jl, jc = jm.extend_step(jp, jb["tokens"][:, 16:], jc)
    assert calls["tree_verify_attention"] == tcfg.num_layers
    _close(tl, jl, LOGIT_TOL)
    for key in jc:
        _close(tc[key], jc[key])


def test_vlm_paged_extend_kernel_route_matches_jax(models, monkeypatch):
    """On CUDA the vlm paged extend reads the paged-decode kernel, one row
    per new token: that route (the kernel's plain version here) gives
    JAX's logits and pools, windowed too."""
    jcfg, tcfg, jp, tp = models["vlm"]
    calls = _kernel_route(monkeypatch)
    B, bs, MB, T = 3, 8, 4, 5
    NB = B * MB + 1
    shape = (jcfg.num_layers, NB, bs, jcfg.num_kv_heads, jcfg.head_dim)
    table = np.random.default_rng(1).permutation(np.arange(1, NB)) \
        .reshape(B, MB).astype(np.int32)
    c = {"k": _np(3, shape), "v": _np(4, shape), "table": table,
         "pos": np.array([0, 9, 25], np.int32)}
    tok = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, T)) \
        .astype(np.int32)
    for window in (0, 6):
        jc_, tc_ = jcfg.replace(sliding_window=window), \
            tcfg.replace(sliding_window=window)
        calls["paged_decode_attention"] = 0
        tl, tc = TT.paged_extend_step(tp, _t(tok), {k: _t(v) for k, v in
                                                    c.items()}, tc_)
        jl, jc = JT.paged_extend_step(jp, jnp.asarray(tok),
                                      {k: jnp.asarray(v)
                                       for k, v in c.items()}, jc_)
        assert calls["paged_decode_attention"] == tcfg.num_layers
        _close(tl, jl, LOGIT_TOL)
        _close(tc["k"], jc["k"])


# ------------------------------------------------------------ serving
def _refusals(fam):
    from repro_torch.core.engine import CollaborativeEngine
    from repro_torch.core.scheduler import BatchedEngine
    from repro_torch.core.seq_state import Lane
    from repro_torch.core.speculative import (SpecDecoder,
                                              autoregressive_baseline)
    from repro_torch.launch.serve import main as serve_main
    other = TModel(tget("smollm-135m").reduced())
    m = TModel(tget(ARCHS[fam]).reduced())
    return [lambda: BatchedEngine(other, m), lambda: BatchedEngine(m, other),
            lambda: Lane(m, "entropy", 0.0),
            lambda: CollaborativeEngine(m, other),
            lambda: SpecDecoder(other, m),
            lambda: autoregressive_baseline(m, None, [1, 2, 3], 4),
            lambda: serve_main(["--device", "cpu", "--reduced", "--edge",
                                ARCHS[fam]])]


@pytest.mark.parametrize("fam", FAMS)
def test_serving_engine_refuses_stub_families(fam):
    """The serving engine prefills with tokens alone, as the JAX package's
    does: every engine entry refuses these families with one clear error
    before it builds anything."""
    for make in _refusals(fam):
        with pytest.raises(NotImplementedError, match=STUB[fam]):
            make()
