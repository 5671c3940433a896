"""The survey library's edge-deployment modules in the port vs the JAX
package, on the CPU: compression (every compressor's payload and wire
bytes), split inference and its cost model, quantization and pruning.

Parameters are the JAX init of reduced (float32, 2-layer) configs, bridged
into the port; inputs come from numpy seeds.  Quantized values, masks and
wire bytes are exact (both packages round half to even and pick the same
thresholds over the same stacked leaves); split-inference logits 1e-4
(the model tests' logit tolerance); dequantized values, scales and errors
1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.core import compression as JC  # noqa: E402
from repro.core import partition as JP  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.training import pruning as jprune  # noqa: E402
from repro.training import quantization as jquant  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import compression as TC  # noqa: E402
from repro_torch.core import partition as TP  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.training import pruning as tprune  # noqa: E402
from repro_torch.training import quantization as tquant  # noqa: E402

ARCHS = {"dense": "smollm-135m", "vlm": "paligemma-3b",
         "encdec": "whisper-small"}


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32))
                        if jnp.issubdtype(x.dtype, jnp.floating)
                        else np.asarray(x), tree)


def _tnp(tree):
    """A port tree of tensors as numpy (floating leaves as float32)."""
    if isinstance(tree, dict):
        return {k: _tnp(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tnp(v) for v in tree]
    t = tree.detach()
    return (t.float() if t.is_floating_point() else t).numpy()


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _leaves_close(a_tree, b_tree, tol=0.0):
    fa, ta = jax.tree_util.tree_flatten_with_path(a_tree)
    fb, tb = jax.tree_util.tree_flatten_with_path(b_tree)
    assert ta == tb
    for (path, a), (_, b) in zip(fa, fb):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype or tol, (path, a.dtype, b.dtype)
        np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                                   rtol=tol, atol=tol, err_msg=str(path))


@pytest.fixture(scope="module")
def models():
    out = {}
    for fam, arch in ARCHS.items():
        jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
        jp = JModel(jcfg).init(jax.random.PRNGKey(3))
        out[fam] = (jcfg, tcfg, jp, params_from_numpy(_host(jp), tcfg, "cpu"))
    return out


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("name", ["identity", "int8", "int4"])
def test_compressor_payload_and_wire_bytes(name):
    """Identity, int8 and int4: the payload (quantized values exact, the
    scales 1e-6), the decompressed tensor and the wire bytes, which must
    equal JAX's exactly (an odd element count for int4's packing)."""
    x = _np(0, (3, 7, 33), 2.0)
    x[0, 0, :5] = [0.5, -0.5, 1.5, 2.5, -2.5]     # halves: round to even
    jc = JC.COMPRESSORS[name]().compress(jnp.asarray(x))
    tc = TC.COMPRESSORS[name]().compress(_t(x))
    assert tc.wire_bytes == jc.wire_bytes and tc.method == jc.method
    _leaves_close(_tnp(tc.payload), _host(jc.payload), 1e-6)
    if "q" in jc.payload:
        assert np.array_equal(tc.payload["q"].numpy(),
                              np.asarray(jc.payload["q"]))
    out = TC.COMPRESSORS[name]().decompress(tc)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(JC.COMPRESSORS[name]().decompress(jc)),
        atol=1e-6)


def test_int4_packs_an_odd_count():
    x = _np(1, (5,))
    assert TC.Int4Quantizer().compress(_t(x)).wire_bytes == \
        JC.Int4Quantizer().compress(jnp.asarray(x)).wire_bytes == 3 + 4


@pytest.mark.parametrize("error_feedback", [False, True])
def test_topk_sparsifier_matches_jax(error_feedback):
    """Kept indices (as a set), values, the decompressed tensor and the
    wire bytes over four calls; with error feedback the residual carries
    between calls in both packages."""
    js = JC.TopKSparsifier(frac=0.15, error_feedback=error_feedback)
    ts = TC.TopKSparsifier(frac=0.15, error_feedback=error_feedback)
    for i in range(4):
        x = _np(10 + i % 2, (6, 40))
        jc, tc = js.compress(jnp.asarray(x)), ts.compress(_t(x))
        assert tc.wire_bytes == jc.wire_bytes
        assert sorted(tc.payload["idx"].tolist()) == \
            sorted(np.asarray(jc.payload["idx"]).tolist())
        np.testing.assert_allclose(ts.decompress(tc).numpy(),
                                   np.asarray(js.decompress(jc)), atol=1e-6)


def test_topk_logits_matches_jax():
    logits = _np(2, (3, 5, 100), 3.0)
    jc = JC.TopKLogits(k=10).compress(jnp.asarray(logits))
    tc = TC.TopKLogits(k=10).compress(_t(logits))
    assert tc.wire_bytes == jc.wire_bytes == 3 * 5 * 10 * 8
    np.testing.assert_array_equal(tc.payload["idx"].numpy(),
                                  np.asarray(jc.payload["idx"]))
    np.testing.assert_array_equal(
        TC.TopKLogits(k=10).decompress(tc).numpy(),
        np.asarray(JC.TopKLogits(k=10).decompress(jc)))


def test_entropy_and_relative_error_match_jax():
    x, y = _np(3, (4, 50)), _np(4, (4, 50))
    q = np.round(x * 10)
    assert TC.entropy_bits_estimate(_t(q)) == JC.entropy_bits_estimate(q)
    assert TC.relative_error(_t(x), _t(y)) == JC.relative_error(x, y)


# ------------------------------------------------------------ partition
def _split_batch(cfg, fam, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)}
    if fam == "vlm":
        b["embeds"] = _np(seed + 1, (2, cfg.num_image_tokens, cfg.d_model))
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: _t(v) for k, v in b.items()})


@pytest.mark.parametrize("fam", ["dense", "vlm"])
@pytest.mark.parametrize("name", ["identity", "int8", "int4"])
def test_split_inference_matches_jax(models, fam, name):
    """Split inference at k = 1 (the vlm prefix crosses the boundary with
    its prefix-LM mask on both sides), stage by stage: the edge's boundary
    activation (1e-5); JAX's boundary compressed by both packages (the
    same payload and wire bytes); the cloud's logits on that decompressed
    boundary (1e-4).  End to end, ``split_inference``'s wire bytes equal
    JAX's, its logits match JAX's for identity and int8 and, with
    identity, the unsplit forward (no softcap on either).  An int4
    boundary is held stage by stage only: a 1e-7 difference in the
    boundary can move an entry across a rounding edge of its 15 levels."""
    jcfg, tcfg, jp, tp = models[fam]
    jb, tb = _split_batch(jcfg, fam)
    embeds = tb.get("embeds")
    P = 0 if embeds is None else embeds.shape[1]
    jh = JP.edge_forward(jp, jb["tokens"], jcfg, 1, embeds=jb.get("embeds"))
    th = TP.edge_forward(tp, tb["tokens"], tcfg, 1, embeds=embeds)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5,
                               rtol=1e-5)
    jc = JC.COMPRESSORS[name]().compress(jh)
    tc = TC.COMPRESSORS[name]().compress(_t(np.asarray(jh)))
    assert tc.wire_bytes == jc.wire_bytes
    _leaves_close(_tnp(tc.payload), _host(jc.payload), 1e-7)
    jl = JP.cloud_forward(jp, JC.COMPRESSORS[name]().decompress(jc), jcfg, 1,
                          prefix_len=P)
    tl = TP.cloud_forward(tp, TC.COMPRESSORS[name]().decompress(tc), tcfg, 1,
                          prefix_len=P)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    tm = TModel(tcfg)
    tl, tw = TP.split_inference(tm, tp, tb, 1, TC.COMPRESSORS[name]())
    jl, jw = JP.split_inference(JModel(jcfg), jp, jb, 1,
                                JC.COMPRESSORS[name]())
    assert tw == jw
    if name != "int4":
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    if name == "identity":
        np.testing.assert_allclose(tl.numpy(), tm.forward(tp, tb)[0].numpy(),
                                   atol=1e-4, rtol=1e-4)


def test_split_inference_refuses_other_families(models):
    _, tcfg, _, tp = models["encdec"]
    with pytest.raises(ValueError, match="decoder-only"):
        TP.split_inference(TModel(tcfg), tp, {"tokens": None}, 1)


@pytest.mark.parametrize("arch", ["granite-8b", "paligemma-3b",
                                  "smollm-135m"])
def test_split_cost_model_matches_jax(arch):
    """best_split with explicit rates (both packages' defaults differ: the
    port's cloud rate is the H100's), and the port's default."""
    rates = dict(edge_flops_per_s=2e12, cloud_flops_per_s=3e14,
                 bandwidth_bytes_per_s=12.5e6, bytes_per_act=1.0)
    jk, jts = JP.SplitCostModel(**rates).best_split(jget(arch), 128)
    tk, tts = TP.SplitCostModel(**rates).best_split(tget(arch), 128)
    assert tk == jk
    np.testing.assert_allclose(tts, jts, rtol=1e-12)
    assert TP.SplitCostModel().cloud_flops_per_s == 989e12


# ------------------------------------------------------------ quantization
@pytest.mark.parametrize("fam", list(ARCHS))
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_matches_jax(models, fam, bits):
    """quantize_params over the stacked layout (the (L, d) norms quantized,
    the final norms not), its bytes, the dequantized tree and the error
    report."""
    jcfg, tcfg, jp, tp = models[fam]
    jq, tq = jquant.quantize_params(jp, bits), tquant.quantize_params(tp, bits)
    _leaves_close(_tnp(tq), _host(jq), 1e-7)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(_tnp(tq))[0],
            jax.tree_util.tree_flatten_with_path(_host(jq))[0]):
        if a.dtype == np.int8:
            assert np.array_equal(a, b), path
    assert tquant.quantized_bytes(tq) == jquant.quantized_bytes(jq)
    _leaves_close(_tnp(tquant.dequantize_params(tq)),
                  _host(jquant.dequantize_params(jq)), 1e-6)
    te, je = tquant.quantization_error(tp, tq), \
        jquant.quantization_error(jp, jq)
    for key in je:
        assert abs(te[key] - je[key]) <= 1e-6


def test_fake_quant_is_straight_through():
    w = _np(5, (6, 10))
    tw = _t(w).requires_grad_(True)
    out = tquant.fake_quant(tw, 4)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jquant.fake_quant(jnp.asarray(w),
                                                            4)), atol=1e-7)
    (g,) = torch.autograd.grad(out.sum(), tw)
    assert torch.equal(g, torch.ones_like(g))


# ------------------------------------------------------------ pruning
@pytest.mark.parametrize("fam", list(ARCHS))
def test_magnitude_masks_and_soft_update_match_jax(models, fam):
    """One threshold per stacked leaf (across every layer), the (L, d)
    norms masked too; apply_masks; the soft-mask reactivation (exact, it
    draws nothing); the sparsity report."""
    jcfg, tcfg, jp, tp = models[fam]
    jm, tm = jprune.magnitude_masks(jp, 0.5), tprune.magnitude_masks(tp, 0.5)
    _leaves_close(_tnp(tm), _host(jm))
    _leaves_close(params_to_numpy(tprune.apply_masks(tp, tm), tcfg),
                  _host(jprune.apply_masks(jp, jm)))
    js = jprune.soft_mask_update(jp, jm, 0.05)
    ts = tprune.soft_mask_update(tp, tm, 0.05)
    _leaves_close(_tnp(ts), _host(js))
    assert tprune.sparsity_report(ts) == jprune.sparsity_report(js)


@pytest.mark.parametrize("fam", ["dense", "vlm"])
def test_structured_ffn_prune_matches_jax(models, fam):
    """One keep for all layers, chosen over the stacked scores; the pruned
    model runs and matches JAX's pruned forward."""
    jcfg, tcfg, jp, tp = models[fam]
    jnew, jkeep = jprune.structured_ffn_prune(jp, jcfg, 0.3)
    tnew, tkeep = tprune.structured_ffn_prune(tp, tcfg, 0.3)
    assert tkeep == jkeep == 152
    _leaves_close(params_to_numpy(tnew, tcfg), _host(jnew))
    jb, tb = _split_batch(jcfg, fam, 4)
    np.testing.assert_allclose(
        TModel(tcfg).forward(tnew, tb)[0].numpy(),
        np.asarray(JModel(jcfg).forward(jnew, jb)[0]), atol=1e-4, rtol=1e-4)
