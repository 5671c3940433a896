"""The port's early exit (``core/early_exit.py``) vs the JAX package's, on
the CPU: exit logits from ``forward(collect_hidden=True)``, the exit
decision, and the LayerSkip loss with its gradients, for the dense family
and a recurrent one (mamba2).

Parameters are the JAX init of reduced (float32, 2-layer) configs, bridged
into the port; inputs come from numpy seeds.  Tolerances (float32, sums in
another order): hidden states and exit logits 1e-4 (the logits'
tolerance of the model tests), losses 1e-5, gradients rtol 1e-4 / atol
1e-5 (the training tests'); the exit decision is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.core import early_exit as JE  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import early_exit as TE  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.training import tree as T  # noqa: E402

ARCHS = {"dense": "smollm-135m", "ssm": "mamba2-370m"}


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


def _close(a, b, tol):
    np.testing.assert_allclose(a.detach().float().numpy(),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def models():
    out = {}
    for fam, arch in ARCHS.items():
        jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
        jp = JModel(jcfg).init(jax.random.PRNGKey(5))
        out[fam] = (jcfg, tcfg, jp, params_from_numpy(_host(jp), tcfg, "cpu"))
    return out


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[1, :4] = -1
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


@pytest.mark.parametrize("fam", list(ARCHS))
def test_exit_logits_match_jax(models, fam):
    jcfg, tcfg, jp, tp = models[fam]
    jb, tb = _batch(jcfg)
    jm, tm = JModel(jcfg), TModel(tcfg)
    _, _, jhs = jm.forward(jp, jb, collect_hidden=True)
    tl, _, ths = tm.forward(tp, tb, collect_hidden=True)
    assert tuple(ths.shape) == tuple(jhs.shape)
    _close(ths, jhs, 1e-4)
    assert torch.equal(tl, tm.forward(tp, tb)[0])
    layers = list(range(ths.shape[0]))
    _close(TE.exit_logits(tm, tp, ths, layers),
           JE.exit_logits(jm, jp, jhs, layers), 1e-4)


@pytest.mark.parametrize("estimator", ["max_prob", "entropy"])
def test_early_exit_decision_matches_jax(estimator):
    rng = np.random.default_rng(1)
    stack = (rng.standard_normal((3, 6, 32)) * 3).astype(np.float32)
    stack[1, :2] *= 8                  # confident middle exits for two rows
    for threshold in (0.2, 0.5, 0.9):
        ji, jc = JE.early_exit_decision(jnp.asarray(stack), threshold,
                                        estimator)
        ti, tc = TE.early_exit_decision(torch.from_numpy(stack), threshold,
                                        estimator)
        assert ti.tolist() == np.asarray(ji).tolist()
        assert torch.equal(tc, torch.from_numpy(np.array(jc)))


@pytest.mark.parametrize("fam", list(ARCHS))
def test_layerskip_loss_and_grads_match_jax(models, fam):
    jcfg, tcfg, jp, tp = models[fam]
    jb, tb = _batch(jcfg)
    jm, tm = JModel(jcfg), TModel(tcfg)
    exits = [0]
    (jl, jces), jg = jax.value_and_grad(
        lambda p: JE.layerskip_loss(jm, p, jb, exits), has_aux=True)(jp)
    train_p = T.replace(tp, [t.detach().requires_grad_(True)
                             for t in T.tensors(tp)])
    tl, tces = TE.layerskip_loss(tm, train_p, tb, exits)
    grads = torch.autograd.grad(tl, T.tensors(train_p))
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5
    _close(tces, jces, 1e-5)
    fa, ta = jax.tree_util.tree_flatten_with_path(
        params_to_numpy(T.replace(tp, list(grads)), tcfg))
    fb, tb_ = jax.tree_util.tree_flatten_with_path(_host(jg))
    assert ta == tb_
    for (path, a), (_, b) in zip(fa, fb):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   err_msg=str(path))
    # remat changes nothing
    tl2, _ = TE.layerskip_loss(tm, train_p, tb, exits, remat=True)
    assert torch.equal(tl.detach(), tl2.detach())
