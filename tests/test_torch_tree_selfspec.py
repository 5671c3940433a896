"""The port's tree and self speculation pieces vs the JAX package's.

``TreePlan`` / ``branching_for`` must give the same topology; the batched
``tree_accept`` must give each slot exactly what the JAX per-slot walk
gives from the same key, the port being handed the uniforms the JAX walk
draws (at T = 0 its result does not depend on them); the tree-masked
``extend_step``, ``partial_extend_step`` and ``SpecOps.commit_permute``
must agree with the JAX functions on bridged reduced parameters (float32,
2 layers), the JAX package running them per slot as its engine vmaps them.

Tolerances: logits atol 1e-4 (two layers of float32 matmuls summed in
another order), caches atol 1e-5; plans, acceptance and permutes exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.core import tree_speculation as JTS  # noqa: E402
from repro.core.self_speculative import (  # noqa: E402
    partial_extend_step as j_partial)
from repro.core.seq_state import SpecOps as JSpecOps  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import tree_speculation as TTS  # noqa: E402
from repro_torch.core.self_speculative import (  # noqa: E402
    partial_extend_step as t_partial)
from repro_torch.core.seq_state import SpecOps as TSpecOps  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402

LOGIT_TOL = 1e-4
PLANS = [(2, 1), (2, 4), (3, 3), (4, 2)]


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(t_out, j_out, tol=1e-5):
    np.testing.assert_allclose(t_out.detach().float().numpy(),
                               np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jget("granite-8b").reduced(), tget("granite-8b").reduced()
    jp = JModel(jcfg).init(jax.random.PRNGKey(3))
    host = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), jp)
    return (JModel(jcfg), TModel(tcfg), jp,
            params_from_numpy(host, tcfg, "cpu"))


# ------------------------------------------------------------ plan
@pytest.mark.parametrize("width,gamma", PLANS)
def test_tree_plan_and_branching_match_jax(width, gamma):
    assert TTS.branching_for(width, gamma) == JTS.branching_for(width, gamma)
    jp = JTS.TreePlan(JTS.branching_for(width, gamma))
    tp = TTS.TreePlan(TTS.branching_for(width, gamma))
    for name in ("branching", "depth", "n", "n_pad", "level_lo", "levels"):
        assert getattr(tp, name) == getattr(jp, name), name
    for name in ("parent", "depths", "mask"):
        np.testing.assert_array_equal(getattr(tp, name),
                                      np.asarray(getattr(jp, name)))


# ------------------------------------------------------------ acceptance
def _accept_case(plan, G, V, seed, temperature):
    """Per-slot logits and tokens; at T = 0 about half the nodes carry
    their parent's target argmax, so every acceptance depth occurs."""
    rng = np.random.default_rng(seed)
    tl = _np(seed, (G, plan.n_pad, V), 2.0)
    ql = _np(seed + 1, (G, plan.n_pad, V), 2.0)
    toks = rng.integers(0, V, (G, plan.n_pad)).astype(np.int32)
    if temperature == 0.0:
        for g in range(G):
            for c in range(1, plan.n):
                if rng.random() < 0.6:
                    toks[g, c] = tl[g, plan.parent[c]].argmax()
    return tl, ql, toks


def _jax_uniforms(key, plan):
    """The uniforms the JAX walk draws from ``key`` (tree_speculation.py
    ``tree_accept``: split, then (depth, kmax) and (depth + 1,))."""
    r_acc, r_res = jax.random.split(key)
    return (np.asarray(jax.random.uniform(
        r_acc, (plan.depth, max(plan.branching)))),
        np.asarray(jax.random.uniform(r_res, (plan.depth + 1,))))


@pytest.mark.parametrize("width,gamma", [(2, 4), (3, 3)])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_tree_accept_matches_jax(width, gamma, temperature):
    G, V = 6, 24
    jplan = JTS.TreePlan(JTS.branching_for(width, gamma))
    tplan = TTS.TreePlan(TTS.branching_for(width, gamma))
    depths = []
    for seed in range(3):
        tl, ql, toks = _accept_case(tplan, G, V, 10 * seed, temperature)
        keys = jax.random.split(jax.random.PRNGKey(seed), G)
        us = [_jax_uniforms(keys[g], jplan) for g in range(G)]
        u_acc = np.stack([u[0] for u in us])
        u_res = np.stack([u[1] for u in us])
        if temperature == 0.0:      # T = 0 must not read the uniforms
            u_acc, u_res = np.zeros_like(u_acc), np.zeros_like(u_res)
        n, em, path = TTS.tree_accept(_t(tl), _t(ql), _t(toks), tplan,
                                      _t(u_acc), _t(u_res),
                                      temperature=temperature)
        for g in range(G):
            jn, jem, jpath = JTS.tree_accept(
                keys[g], jnp.asarray(tl[g]), jnp.asarray(ql[g]),
                jnp.asarray(toks[g]), jplan, temperature=temperature)
            assert int(n[g]) == int(jn), (seed, g)
            assert em[g].tolist() == np.asarray(jem).tolist(), (seed, g)
            assert path[g].tolist() == np.asarray(jpath).tolist(), (seed, g)
            depths.append(int(jn))
    if temperature == 0.0:
        assert len(set(depths)) > 2          # several acceptance depths


# ------------------------------------------------------------ model entries
def _dense_caches(cfg, pos, S, seed):
    """Per-slot JAX caches (one (L, 1, S, Kv, hd) cache each, scalar pos)
    and the port's batched (L, B, S, Kv, hd) cache with pos (B,)."""
    B = len(pos)
    shape = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim)
    k, v = _np(seed, shape), _np(seed + 1, shape)
    j = [{"k": jnp.asarray(k[:, b:b + 1]), "v": jnp.asarray(v[:, b:b + 1]),
          "pos": jnp.asarray(p, jnp.int32)} for b, p in enumerate(pos)]
    t = {"k": _t(k), "v": _t(v),
         "pos": torch.as_tensor(pos, dtype=torch.int32)}
    return j, t


@pytest.mark.parametrize("span", ["one_shot", "level2", "clamped"])
def test_extend_step_block_mask_matches_jax(model, span):
    """The tree-masked extend, one row per slot at its own ``pos``:
    the one-shot verify (C == T), an incremental draft level (C > T),
    and a level whose writes and placed mask clamp at the cache end."""
    jm, tm, jp, tp = model
    plan = TTS.TreePlan(TTS.branching_for(2, 4))
    if span == "one_shot":
        lo, hi, pos, S = 0, plan.n_pad, [5, 19], 48
    else:
        lo, hi = plan.levels[2]
        pos, S = ([9, 30], 48) if span == "level2" else ([12, 46], 48)
    mask = plan.mask[lo:hi, :hi] if span != "one_shot" else plan.mask
    depths = plan.depths[lo:hi] - lo
    T = mask.shape[0]
    toks = np.random.default_rng(7).integers(0, tm.cfg.vocab_size,
                                             (len(pos), T)).astype(np.int32)
    jcs, tc = _dense_caches(tm.cfg, pos, S, seed=11)
    q_pos = tc["pos"].long()[:, None] + _t(depths).long()[None, :]
    tl, tc2 = tm.extend_step(tp, _t(toks), tc, block_mask=_t(mask),
                             q_positions=q_pos)
    for b, jc in enumerate(jcs):
        jl, jc2 = jm.extend_step(jp, jnp.asarray(toks[b:b + 1]), jc,
                                 block_mask=jnp.asarray(mask),
                                 q_positions=jc["pos"] + jnp.asarray(depths))
        _close(tl[b], jl[0], LOGIT_TOL)
        _close(tc2["k"][:, b], jc2["k"][:, 0])
        _close(tc2["v"][:, b], jc2["v"][:, 0])
    assert tc2["pos"].tolist() == [p + T for p in pos]


def test_partial_extend_step_matches_jax(model):
    """The self lane's shallow draft: the first k blocks + head, writing
    only cache layers [0, k), pos left where it was."""
    jm, tm, jp, tp = model
    k, pos, S = 1, [4, 17], 32
    toks = np.array([[3], [250]], np.int32)
    jcs, tc = _dense_caches(tm.cfg, pos, S, seed=21)
    v_before = tc["v"][k:].clone()
    tl, tc2 = t_partial(tp, _t(toks), tc, tm.cfg, k)
    for b, jc in enumerate(jcs):
        jl, jc2 = j_partial(jp, jnp.asarray(toks[b:b + 1]), jc, jm.cfg, k)
        _close(tl[b], jl[0], LOGIT_TOL)
        _close(tc2["k"][:, b], jc2["k"][:, 0])
        _close(tc2["v"][:, b], jc2["v"][:, 0])
    assert tc2["pos"].tolist() == pos
    assert torch.equal(tc2["v"][k:], v_before)


def test_commit_permute_matches_jax(model):
    """Row permutes of the accepted tree path, with the JAX index clip
    (``take(mode="clip")``) and the clamped write start exercised by a
    slot whose snapshot sits near the end of its cache."""
    jm, tm, _, _ = model
    S, T = 24, 5
    snap = np.array([3, 10, 21], np.int32)
    perm = np.array([[0, 1, 3, 7, 11], [0, 2, 5, 9, 13],
                     [0, 1, 4, 8, 12]], np.int32)
    counts = np.array([5, 2, 0], np.int32)
    jcs, tc = _dense_caches(tm.cfg, snap, S, seed=31)
    stacked = {"k": jnp.stack([c["k"] for c in jcs]),
               "v": jnp.stack([c["v"] for c in jcs]),
               "pos": jnp.asarray(snap)}
    jout = JSpecOps(jm, "dense").commit_permute(
        stacked, jnp.asarray(snap), jnp.asarray(perm), jnp.asarray(counts))
    tout = TSpecOps(tm, "dense").commit_permute(
        tc, _t(snap), _t(perm), _t(counts))
    for b in range(len(snap)):
        np.testing.assert_array_equal(tout["k"][:, b].numpy(),
                                      np.asarray(jout["k"][b][:, 0]))
        np.testing.assert_array_equal(tout["v"][:, b].numpy(),
                                      np.asarray(jout["v"][b][:, 0]))
    assert tout["pos"].tolist() == np.asarray(jout["pos"]).tolist()
