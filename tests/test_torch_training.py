"""The port's learning half vs the JAX package's, on the CPU.

Parameters are the JAX init of reduced (float32, 2-layer) configs, bridged
into the port with ``params_from_numpy``; updated parameters and gradients
come back through ``params_to_numpy`` and are compared leaf for leaf in
the JAX layout.  Inputs come from numpy seeds and go to both frameworks.

Tolerances (float32, sums in another order): losses 1e-5; gradients
rtol 1e-4 / atol 1e-5; one AdamW step on the SAME gradients 1e-6; a
five-step training run's loss history 1e-4; adapter and merge results
1e-5; flash attention gradients 1e-5 (the plain autograd and the tiled
model of the backward kernel's walk).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.data.pipeline import batches as jbatches  # noqa: E402
from repro.data.pipeline import client_divergence as jdiv  # noqa: E402
from repro.data.pipeline import dirichlet_clients as jdir  # noqa: E402
from repro.kernels.ref import flash_attention_ref  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.training import checkpoint as jck  # noqa: E402
from repro.training import distillation as jdist  # noqa: E402
from repro.training import lora as jlora  # noqa: E402
from repro.training.optimizer import AdamW as JAdamW  # noqa: E402
from repro.training.optimizer import cosine_schedule as jcos  # noqa: E402
from repro.training.trainer import make_train_step as jstep  # noqa: E402
from repro.training.trainer import train as jtrain  # noqa: E402
from repro_torch.bridge import (jax_ndims, params_from_numpy,  # noqa: E402
                                params_to_numpy)
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data.pipeline import batches as tbatches  # noqa: E402
from repro_torch.data.pipeline import client_divergence as tdiv  # noqa: E402
from repro_torch.data.pipeline import dirichlet_clients as tdir  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain, flash_bwd_plan)
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models.model import example_batch  # noqa: E402
from repro_torch.training import checkpoint as tck  # noqa: E402
from repro_torch.training import distillation as tdist  # noqa: E402
from repro_torch.training import lora as tlora  # noqa: E402
from repro_torch.training import tree as T  # noqa: E402
from repro_torch.training.optimizer import AdamW as TAdamW  # noqa: E402
from repro_torch.training.optimizer import cosine_schedule as tcos  # noqa
from repro_torch.training.trainer import make_train_step as tstep  # noqa
from repro_torch.training.trainer import train as ttrain  # noqa: E402

ARCHS = {"dense": "smollm-135m", "moe": "granite-moe-1b-a400m",
         "ssm": "mamba2-370m", "xlstm": "xlstm-125m", "hybrid": "zamba2-2.7b"}
RECURRENT = ("ssm", "xlstm", "hybrid")


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _leaves_close(a_tree, b_tree, rtol, atol):
    fa, ta = jax.tree_util.tree_flatten_with_path(a_tree)
    fb, tb = jax.tree_util.tree_flatten_with_path(b_tree)
    assert ta == tb
    for (path, a), (_, b) in zip(fa, fb):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), rtol=rtol,
                                   atol=atol, err_msg=str(path))


@pytest.fixture(scope="module")
def models():
    out = {}
    for fam, arch in ARCHS.items():
        jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
        jp = JModel(jcfg).init(jax.random.PRNGKey(3))
        out[fam] = (jcfg, tcfg, jp, params_from_numpy(_host(jp), tcfg, "cpu"))
    return out


def _batch(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1                       # ignored positions
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": _t(toks), "labels": _t(labels)})


def _port_grads(model, params, batch, **kw):
    train_p = T.replace(params, [t.detach().requires_grad_(True)
                                 for t in T.tensors(params)])
    loss = model.loss(train_p, batch, **kw)
    grads = torch.autograd.grad(loss, T.tensors(train_p))
    return loss, T.replace(params, list(grads))


# ------------------------------------------------------------ loss, grads
@pytest.mark.parametrize("fam", list(ARCHS))
def test_loss_and_grads_match_jax(models, fam):
    """Model.loss (shifted CE + the moe aux term) and every gradient leaf,
    compared in the JAX layout, against jax.value_and_grad.  The recurrent
    families take 16 tokens, two whole chunks of the reduced configs' 8:
    the JAX package's own gradient of ``gla_chunked`` is NaN at a
    front-padded length (its masked decay entries overflow before the
    mask); the ragged length is held in the next test."""
    jcfg, tcfg, jp, tp = models[fam]
    jb, tb = _batch(jcfg, S=16 if fam in RECURRENT else 12)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JModel(jcfg).loss(p, jb))(jp)
    tloss, tgrads = _port_grads(TModel(tcfg), tp, tb)
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-5
    _leaves_close(params_to_numpy(tgrads, tcfg), _host(jgrads), 1e-4, 1e-5)
    if fam == "moe":                         # the aux term is in the loss
        _, aux = TModel(tcfg).forward(tp, tb)
        assert float(aux) > 0


@pytest.mark.parametrize("fam", ["xlstm"])
def test_ragged_recurrent_loss_and_grads_match_jax(models, fam):
    """At a front-padded length (20 tokens over chunks of 8) the port's
    loss and gradients are finite and match jax.value_and_grad of the same
    model with chunks of 20: the function does not depend on the chunk
    length (the stabilisers cancel in both callers' forms), and at 20 the
    JAX package pads nothing."""
    jcfg, tcfg, jp, tp = models[fam]
    jb, tb = _batch(jcfg, S=20)
    jcfg = jcfg.replace(ssm_chunk=20)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JModel(jcfg).loss(p, jb))(jp)
    tloss, tgrads = _port_grads(TModel(tcfg), tp, tb)
    assert tcfg.ssm_chunk == 8
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-5
    for g in T.tensors(tgrads):
        assert torch.isfinite(g).all()
    _leaves_close(params_to_numpy(tgrads, tcfg), _host(jgrads), 1e-4, 1e-5)


@pytest.mark.parametrize("fam", list(ARCHS))
def test_remat_gives_the_same_loss_and_grads(models, fam):
    _, tcfg, _, tp = models[fam]
    _, tb = _batch(tcfg)
    m = TModel(tcfg)
    l0, g0 = _port_grads(m, tp, tb)
    l1, g1 = _port_grads(m, tp, tb, remat=True)
    assert torch.equal(l0, l1)
    for a, b in zip(T.tensors(g0), T.tensors(g1)):
        assert torch.equal(a, b)


def test_example_batch():
    cfg = tget("smollm-135m").reduced()
    gen = torch.Generator().manual_seed(1)
    b = example_batch(cfg, 3, 7, gen, device="cpu")
    assert b["tokens"].shape == b["labels"].shape == (3, 7)
    assert b["tokens"].dtype == torch.int32
    assert int(b["tokens"].max()) < cfg.vocab_size
    assert "labels" not in example_batch(cfg, 1, 4, with_labels=False,
                                         device="cpu")


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m",
                                  "mamba2-370m", "xlstm-125m",
                                  "zamba2-2.7b"])
def test_params_to_numpy_inverts_the_bridge(arch):
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    jp = _host(JModel(jcfg).init(jax.random.PRNGKey(0)))
    back = params_to_numpy(params_from_numpy(jp, tcfg, "cpu"), tcfg)
    _leaves_close(back, jp, 0, 0)


# ------------------------------------------------------------ optimizer
def _rand_tree(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), tree)


def test_adamw_steps_match_jax(models):
    """Two AdamW steps (clipped: the random gradients' norm is far above
    1) on the same gradients: new params, grad norm, and the decay mask —
    the stacked (L, d) block norms ARE decayed, the final norm is not."""
    jcfg, tcfg, jp, tp = models["dense"]
    kw = dict(lr=1e-2, weight_decay=0.1, schedule=jcos(1, 4))
    jopt = JAdamW(**kw)
    topt = TAdamW(**{**kw, "schedule": tcos(1, 4)})
    jst, tst = jopt.init(jp), topt.init(tp)
    ranks = jax_ndims(tp, tcfg)
    decay = dict(zip([n for n, _ in T.leaves(tp)], tst.decay))
    assert decay["blocks.0.attn_norm"] and decay["blocks.1.mlp_norm"]
    assert ranks["blocks.0.attn_norm"] == 2
    assert not decay["final_norm"] and decay["embed"]
    for step in range(2):
        g = _rand_tree(_host(jp), step)
        jp, jst, jn = jopt.update(jax.tree.map(jnp.asarray, g), jst, jp)
        tg = T.tensors(params_from_numpy(g, tcfg, "cpu"))
        tp, tst, tn = topt.update(tg, tst, tp)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        _leaves_close(params_to_numpy(tp, tcfg), _host(jp), 1e-6, 1e-6)


def test_adamw_inplace_update_equals_functional(models):
    _, tcfg, jp, tp = models["dense"]
    opt = TAdamW(lr=1e-2)
    g = T.tensors(params_from_numpy(_rand_tree(_host(jp), 5), tcfg, "cpu"))
    a, _, _ = opt.update(g, opt.init(tp), tp)
    mine = T.replace(tp, [t.clone() for t in T.tensors(tp)])
    b, _, _ = opt.update(g, opt.init(mine), mine, inplace=True)
    assert b is mine
    for x, y, z in zip(T.tensors(a), T.tensors(b), T.tensors(tp)):
        assert torch.equal(x, y) and not torch.equal(x, z)


def test_adamw_groups_change_nothing(models, monkeypatch):
    """The update walks the leaves in groups of bounded size; any grouping
    gives the same bits as one group (functional and in place)."""
    from repro_torch.training import optimizer
    _, tcfg, jp, tp = models["dense"]
    opt = TAdamW(lr=1e-2, schedule=tcos(1, 4))
    g = T.tensors(params_from_numpy(_rand_tree(_host(jp), 7), tcfg, "cpu"))
    outs = []
    for cap in (optimizer.GROUP_ELEMS, 1, 5000):
        monkeypatch.setattr(optimizer, "GROUP_ELEMS", cap)
        for inplace in (False, True):
            mine = T.replace(tp, [t.clone() for t in T.tensors(tp)])
            st = opt.init(mine)
            p1, st, n = opt.update(g, st, mine, inplace=inplace)
            outs.append((T.tensors(p1), st.m, st.v, n))
    assert len(optimizer._groups(T.tensors(tp), 5000)) > 2
    for o in outs[1:]:
        for a, b in zip(o[0] + o[1] + o[2] + [o[3]],
                        outs[0][0] + outs[0][1] + outs[0][2] + [outs[0][3]]):
            assert torch.equal(a, b)


def test_cosine_schedule_matches_jax():
    j, t = jcos(10, 100, 0.05), tcos(10, 100, 0.05)
    for s in [0, 1, 5, 10, 11, 50, 99, 100, 150]:
        assert abs(float(j(jnp.int32(s))) - t(s)) <= 1e-6


def test_five_step_train_matches_jax():
    """train() on the data pipeline's stream: the same tokens, and the
    loss history of five AdamW steps within 1e-4."""
    jcfg, tcfg = jget("smollm-135m").reduced(), tget("smollm-135m").reduced()
    jp = JModel(jcfg).init(jax.random.PRNGKey(7))
    tp = params_from_numpy(_host(jp), tcfg, "cpu")
    jit, tit = jbatches(jcfg, 2, 16, seed=3), tbatches(tcfg, 2, 16, seed=3,
                                                      device="cpu")
    first_j, first_t = next(jbatches(jcfg, 2, 16, seed=3)), \
        next(tbatches(tcfg, 2, 16, seed=3, device="cpu"))
    assert np.array_equal(np.asarray(first_j["tokens"]),
                          first_t["tokens"].numpy())
    kw = dict(steps=5, log_every=1, log=lambda *_: None)
    jres = jtrain(JModel(jcfg), jp, jit, opt=JAdamW(lr=3e-3), **kw)
    tres = ttrain(TModel(tcfg), tp, tit, opt=TAdamW(lr=3e-3), **kw)
    jh = np.array([l for _, l in jres["history"]])
    th = np.array([l for _, l in tres["history"]])
    assert len(th) == 5 and th[-1] < th[0]
    np.testing.assert_allclose(th, jh, atol=1e-4, rtol=0)


def test_train_step_stays_on_the_device(models):
    """The step returns tensors (no host numbers) and, with donate=False,
    leaves its inputs untouched."""
    _, tcfg, _, tp = models["dense"]
    _, tb = _batch(tcfg)
    before = [t.clone() for t in T.tensors(tp)]
    opt = TAdamW(lr=1e-2)
    step = tstep(TModel(tcfg), opt, donate=False)
    new, st, met = step(tp, opt.init(tp), tb)
    assert isinstance(met["loss"], torch.Tensor)
    assert isinstance(met["grad_norm"], torch.Tensor)
    assert all(torch.equal(a, b) for a, b in zip(before, T.tensors(tp)))
    assert not any(t.requires_grad for t in T.tensors(new))
    assert [t.dtype for t in T.tensors(new)] == \
        [t.dtype for t in T.tensors(tp)]


# ------------------------------------------------------------ distillation
def test_kd_losses_match_jax(models):
    jcfg, tcfg, jp, tp = models["dense"]
    jb, tb = _batch(jcfg)
    rng = np.random.default_rng(11)
    teacher = (rng.standard_normal((2, 12, jcfg.vocab_size)) * 3
               ).astype(np.float32)
    mask = rng.random((2, 12)) < 0.5
    jm, tm = JModel(jcfg), TModel(tcfg)
    pairs = [
        (jdist.kd_loss(jm, jp, jb, jnp.asarray(teacher), alpha=0.3,
                       temperature=2.0, kd_mask=jnp.asarray(mask)),
         tdist.kd_loss(tm, tp, tb, _t(teacher), alpha=0.3, temperature=2.0,
                       kd_mask=_t(mask))),
        (jdist.kd_loss(jm, jp, jb, jnp.asarray(teacher)),
         tdist.kd_loss(tm, tp, tb, _t(teacher))),
        (jdist.reverse_kd_loss(jm, jp, jb, jnp.asarray(teacher),
                               temperature=1.5),
         tdist.reverse_kd_loss(tm, tp, tb, _t(teacher), temperature=1.5)),
    ]
    s = rng.standard_normal((3, 5, jcfg.vocab_size)).astype(np.float32)
    pairs += [
        (jdist.acceptance_estimate(jnp.asarray(s), jnp.asarray(teacher[:1, :5]
                                                               * 0.5)),
         tdist.acceptance_estimate(_t(s), _t(teacher[:1, :5] * 0.5))),
        (jdist.logit_delta_guidance(jnp.asarray(s), jnp.asarray(s * 2),
                                    jnp.asarray(s * 3), 0.7).sum(),
         tdist.logit_delta_guidance(_t(s), _t(s * 2), _t(s * 3), 0.7).sum()),
    ]
    for j, t in pairs:
        assert abs(float(t) - float(j)) <= 1e-5 * max(1.0, abs(float(j)))


def test_distillspec_data_greedy_matches_jax(models):
    jcfg, tcfg, jp, tp = models["dense"]
    prompts = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    j = jdist.distillspec_data(JModel(jcfg), jp, jnp.asarray(prompts), 5,
                               jax.random.PRNGKey(0), temperature=0.0)
    t = tdist.distillspec_data(TModel(tcfg), tp, _t(prompts), 5,
                               torch.Generator(), temperature=0.0)
    assert np.array_equal(np.asarray(j), t.numpy())


# ------------------------------------------------------------ LoRA
def _lora_pair(jp, tcfg, rank=4, seed=0):
    """JAX's init_lora adapters (B made non-zero so the merge is not the
    identity), and the same adapters bridged into the port."""
    ad = jlora.init_lora(jax.random.PRNGKey(seed), jp, rank=rank)
    rng = np.random.default_rng(seed)
    ad = {p: {**a, "B": jnp.asarray(rng.standard_normal(a["B"].shape)
                                   .astype(np.float32) * 0.05)}
          for p, a in ad.items()}
    return ad, {p: {k: _t(np.asarray(v)) for k, v in a.items()}
                for p, a in ad.items()}


def test_lora_targets_merge_and_step_match_jax(models):
    jcfg, tcfg, jp, tp = models["dense"]
    assert tlora.target_paths(tp) == jlora.target_paths(jp)
    assert sorted(tlora.target_paths(tp)) == [
        "blocks/attn/wk", "blocks/attn/wo", "blocks/attn/wq",
        "blocks/attn/wv"]
    jad, tad = _lora_pair(jp, tcfg)
    assert tlora.lora_param_count(tad) == jlora.lora_param_count(jad)
    _leaves_close(params_to_numpy(tlora.merge_lora(tp, tad), tcfg),
                  _host(jlora.merge_lora(jp, jad)), 1e-5, 1e-5)
    # one LoRA train step: loss, and every adapter leaf (alpha included)
    jb, tb = _batch(jcfg)
    jm, tm = JModel(jcfg), TModel(tcfg)
    js = jstep(jm, JAdamW(lr=1e-2), loss_fn=jlora.lora_loss_fn(jm, jp),
               donate=False)
    topt = TAdamW(lr=1e-2)
    ts = tstep(tm, topt, loss_fn=tlora.lora_loss_fn(tm, tp), donate=False)
    jnew, _, jmet = js(jad, JAdamW(lr=1e-2).init(jad), jb)
    tnew, _, tmet = ts(tad, topt.init(tad), tb)
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-5
    assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) \
        <= 1e-4 * float(jmet["grad_norm"])
    _leaves_close({p: {k: v.numpy() for k, v in a.items()}
                   for p, a in tnew.items()}, _host(jnew), 1e-5, 1e-5)


def test_lora_zero_init_merge_is_identity(models):
    _, tcfg, _, tp = models["dense"]
    ad = tlora.init_lora(0, tp, rank=4)
    assert ad["blocks/attn/wq"]["A"].shape == (2, 4, tcfg.d_model)
    assert ad["blocks/attn/wo"]["B"].shape == (2, tcfg.d_model, 4)
    for a, b in zip(T.tensors(tlora.merge_lora(tp, ad)), T.tensors(tp)):
        assert torch.equal(a, b)


def test_fedavg_and_hetlora_match_jax(models):
    jcfg, tcfg, jp, tp = models["dense"]
    clients = [_lora_pair(jp, tcfg, rank=r, seed=s)
               for s, r in enumerate((2, 4, 3))]
    jagg = jlora.hetlora_aggregate([c[0] for c in clients], max_rank=4)
    tagg = tlora.hetlora_aggregate([c[1] for c in clients], max_rank=4)
    _leaves_close({p: {k: v.numpy() for k, v in a.items()}
                   for p, a in tagg.items()}, _host(jagg), 1e-5, 1e-6)
    same = [_lora_pair(jp, tcfg, rank=4, seed=s) for s in range(2)]
    javg = jlora.fedavg_adapters([c[0] for c in same], [0.3, 0.7])
    tavg = tlora.fedavg_adapters([c[1] for c in same], [0.3, 0.7])
    _leaves_close({p: {k: v.numpy() for k, v in a.items()}
                   for p, a in tavg.items()}, _host(javg), 1e-6, 1e-7)


# ------------------------------------------------------------ checkpoints
def test_checkpoints_cross_between_packages(models, tmp_path):
    """A checkpoint saved by JAX restores in the port and the reverse:
    parameters (the JAX layout) and adapters (keys with "/")."""
    jcfg, tcfg, jp, tp = models["dense"]
    jad, tad = _lora_pair(jp, tcfg)
    jck.save(str(tmp_path / "jp"), jp, step=4)
    jck.save(str(tmp_path / "jad"), jad, step=5)
    back, step = tck.restore(str(tmp_path / "jp"), tp)
    assert step == 4
    _leaves_close(params_to_numpy(back, tcfg), _host(jp), 0, 0)
    back_ad, step = tck.restore(str(tmp_path / "jad"), tad)
    assert step == 5
    _leaves_close({p: {k: v.numpy() for k, v in a.items()}
                   for p, a in back_ad.items()}, _host(jad), 0, 0)
    # the reverse: the port saves (moved params, adapters), JAX restores
    moved = T.replace(tp, [t + 1.0 for t in T.tensors(tp)])
    tck.save(str(tmp_path / "tp"), moved, step=6)
    tck.save(str(tmp_path / "tad"), tad, step=7)
    jback, step = jck.restore(str(tmp_path / "tp"), jp)
    assert step == 6
    _leaves_close(_host(jback), params_to_numpy(moved, tcfg), 0, 0)
    jback_ad, step = jck.restore(str(tmp_path / "tad"), jad)
    assert step == 7
    _leaves_close(_host(jback_ad), _host(jad), 0, 0)
    keys = set(np.load(str(tmp_path / "tad.npz")).files)
    assert "blocks%2Fattn%2Fwq/A" in keys


# ------------------------------------------------------------ data
def test_dirichlet_clients_match_jax():
    j, t = jdir(5, 4, alpha=0.3, seed=9), tdir(5, 4, alpha=0.3, seed=9)
    for a, b in zip(j, t):
        assert np.array_equal(a, b)
    assert jdiv(j) == tdiv(t)


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("causal,window,G", [(True, 0, 1), (True, 5, 1),
                                             (True, 0, 3), (False, 0, 2),
                                             (True, 7, 2)])
def test_flash_attention_plain_grad_matches_jax_ref(causal, window, G):
    """The plain backward (autograd of flash_attention_plain, which the
    backward kernel is held against on the card) vs jax.grad of the JAX
    oracle; GQA through the repeated kv heads."""
    B, Kv, S, hd = 2, 2, 19, 16
    rng = np.random.default_rng(G + window)
    q, dout = (rng.standard_normal((B, Kv * G, S, hd)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((B, Kv, S, hd)).astype(np.float32)
            for _ in range(2))

    def jf(q, k, v):
        out = flash_attention_ref(q, jnp.repeat(k, G, 1), jnp.repeat(v, G, 1),
                                  causal=causal, window=window)
        return jnp.sum(out * dout)

    jg = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    tg = torch.autograd.grad((out * _t(dout)).sum(), (tq, tk, tv))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


# ------------------------------------------------- flash backward's walk
@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 80, "wgmma"),
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, 256, "wgmma256"), (torch.bfloat16, 144, "wgmma256"),
    (torch.float32, 64, "cuda_cores"), (torch.float32, 128, "cuda_cores")])
def test_flash_bwd_plan_route(dtype, hd, route):
    """The route follows the dtype and the head dim alone: wgmma for
    bfloat16 with hd <= 128, wgmma256 above it (both 64-row query tiles
    packed over the G heads, 64-key tiles), the CUDA cores for float32
    (32-row per-head tiles)."""
    for G, S, causal, window in ((1, 16, True, 0), (4, 2048, False, 9)):
        plan = flash_bwd_plan(dtype, hd, G, S, S, causal, window)
        assert plan.route == route
        assert (plan.tile, plan.pack) == ((32, 1) if route == "cuda_cores"
                                          else (64, G))


def test_flash_bwd_plan_tile_counts():
    """Tiles at the training shape (smollm-135m heads: G 3, S 256, hd 64)
    and at granite-8b's heads over S 2048 (G 4, hd 128), causal: per (kv
    head, sequence), the dK/dV blocks walk 12 + 9 + 6 + 3 and 128 + 124 +
    ... + 4 query tiles, the dQ blocks 1 to 4 and 1 to 32 key tiles."""
    train = flash_bwd_plan(torch.bfloat16, 64, 3, 256, 256, True, 0)
    assert (train.n_query_tiles, train.n_key_tiles) == (12, 4)
    assert [len(train.query_tiles(kt)) for kt in range(4)] == [12, 9, 6, 3]
    assert [train.key_tiles(qt) for qt in (0, 2, 3, 11)] == \
        [range(0, 1), range(0, 1), range(0, 2), range(0, 4)]
    long = flash_bwd_plan(torch.bfloat16, 128, 4, 2048, 2048, True, 0)
    assert (long.n_query_tiles, long.n_key_tiles) == (128, 32)
    assert [len(long.query_tiles(kt)) for kt in range(32)] == \
        list(range(128, 0, -4))
    assert [len(long.key_tiles(qt)) for qt in range(128)] == \
        [qt // 4 + 1 for qt in range(128)]
    f32 = flash_bwd_plan(torch.float32, 64, 3, 256, 256, True, 0)
    assert (f32.n_query_tiles, f32.n_key_tiles) == (8, 8)


def _visible(Sq, Sk, causal, window):
    i = np.arange(Sq)[:, None]
    j = np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis = j <= i
    if window:
        vis = vis & (j > i - window)
    return vis


# (G, Sq, Sk, causal, window): the kv head's G query heads packed into
# 64-row tiles that straddle positions (G 3), bands of the causal
# diagonal and of a window, ragged lengths, Sq != Sk with and without
# causality; every row sees a key
WALK_CASES = [(1, 130, 130, True, 0), (3, 100, 100, True, 0),
              (4, 75, 75, True, 17), (3, 90, 90, False, 0),
              (8, 40, 40, True, 0), (3, 70, 70, False, 23),
              (4, 40, 72, True, 0), (3, 72, 40, True, 0),
              (1, 50, 90, False, 0), (3, 92, 64, True, 30)]


@pytest.mark.parametrize("G,Sq,Sk,causal,window", WALK_CASES)
def test_flash_bwd_plan_bounds(G, Sq, Sk, causal, window):
    """With packed rows (row r = position r // G), every (query tile, key
    tile) pair holding a visible (row, key) is walked by the dK/dV block of
    its key tile and the dQ block of its query tile, and the first and
    last tile of each walk hold one: the bounds skip only masked tiles and
    are tight at both ends.  On the CUDA-core route too (per-head tiles)."""
    vis = _visible(Sq, Sk, causal, window)
    for dtype in (torch.bfloat16, torch.float32):
        plan = flash_bwd_plan(dtype, 64, G, Sq, Sk, causal, window)
        t, pack = plan.tile, plan.pack
        packed = np.repeat(vis, pack, axis=0)            # row r: pos r // pack

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


def _tiled_bwd(q, k, v, dout, causal, window):
    """A plain model of the wgmma backward (csrc/flash_attention_bwd.cu):
    the forward's LSE and D = rowsum(dO o O), then the dK/dV blocks (per
    key tile, the packed query tiles of ``query_tiles``) and the dQ walks
    (per packed query tile, the key tiles of ``key_tiles``; a dQ block of
    two tiles walks their union, whose extra tiles are masked), each tile
    recomputing P = exp(scale S - LSE) and dS = P o (dP - D), exact zeros
    where masked.  float32 on the CPU."""
    B, H, Sq, hd = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    G = H // Kv
    plan = flash_bwd_plan(torch.bfloat16, hd, G, Sq, Sk, causal, window)
    assert plan.route == "wgmma"
    t, scale = plan.tile, hd ** -0.5
    vis = torch.from_numpy(_visible(Sq, Sk, causal, window))
    kk = k.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk) * scale
    lse = torch.logsumexp(s.masked_fill(~vis, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None])
                       * vis, v.repeat_interleave(G, dim=1))
    delta = (dout * out).sum(-1)

    def pack(x):             # (B, H, Sq, ...) -> (B, Kv, G Sq, ...)
        x = x.reshape(B, Kv, G, Sq, -1).transpose(2, 3)
        return x.reshape(B, Kv, Sq * G, -1)

    qp, gp = pack(q), pack(dout)
    lp, dp_ = pack(lse[..., None])[..., 0], pack(delta[..., None])[..., 0]
    pos = torch.arange(G * Sq) // G

    def tile(qt, kt):
        rows = slice(qt * t, min(qt * t + t, G * Sq))
        keys = slice(kt * t, min(kt * t + t, Sk))
        m = vis[pos[rows]][:, keys]
        sc = torch.einsum("bkrd,bkjd->bkrj", qp[:, :, rows],
                          k[:, :, keys]) * scale
        p = torch.where(m, torch.exp(sc - lp[:, :, rows, None]), 0.0)
        dp = torch.einsum("bkrd,bkjd->bkrj", gp[:, :, rows], v[:, :, keys])
        ds = torch.where(m, p * (dp - dp_[:, :, rows, None]), 0.0)
        return rows, keys, p, ds

    dq, dk, dv = torch.zeros_like(qp), torch.zeros_like(k), \
        torch.zeros_like(v)
    for kt in range(plan.n_key_tiles):
        for qt in plan.query_tiles(kt):
            rows, keys, p, ds = tile(qt, kt)
            dv[:, :, keys] += torch.einsum("bkrj,bkrd->bkjd", p,
                                           gp[:, :, rows])
            dk[:, :, keys] += torch.einsum("bkrj,bkrd->bkjd", ds,
                                           qp[:, :, rows]) * scale
    for qt in range(plan.n_query_tiles):
        for kt in plan.key_tiles(qt):
            rows, keys, p, ds = tile(qt, kt)
            dq[:, :, rows] += torch.einsum("bkrj,bkjd->bkrd", ds,
                                           k[:, :, keys]) * scale
    dq = dq.reshape(B, Kv, Sq, G, hd).transpose(2, 3).reshape(B, H, Sq, hd)
    return dq, dk, dv


@pytest.mark.parametrize("G,Sq,Sk,causal,window", WALK_CASES)
def test_flash_bwd_tiled_model_matches_jax(G, Sq, Sk, causal, window):
    """The tiled model of the backward kernel's walk vs jax.grad of the
    JAX oracle (``flash_attention_ref`` over the repeated kv heads)."""
    B, Kv, hd = 2, 2, 16
    rng = np.random.default_rng(G * 1000 + Sq + Sk + window)
    q, dout = (rng.standard_normal((B, Kv * G, Sq, hd)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((B, Kv, Sk, hd)).astype(np.float32)
            for _ in range(2))

    def jf(q, k, v):
        out = flash_attention_ref(q, jnp.repeat(k, G, 1), jnp.repeat(v, G, 1),
                                  causal=causal, window=window)
        return jnp.sum(out * dout)

    jg = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tg = _tiled_bwd(*(_t(x) for x in (q, k, v, dout)), causal, window)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
