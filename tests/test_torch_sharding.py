"""The port's sharding rules, ``ShardedBlockPool`` and sharded ``PagedKV``
held against the JAX package's (no process group: pure host logic and
single-process pools).

* ``param_spec`` / ``cache_spec`` / ``paged_cache_spec`` / ``batch_spec``
  / ``kv_shard_ways`` / ``_balanced_factor`` equal JAX's as tuples on every
  leaf of the reduced smollm-135m, granite-8b, granite-moe-1b-a400m,
  granite-20b (one kv head) and olmoe-1b-7b trees (shapes from
  ``jax.eval_shape``), over duck-typed meshes at (2, 4), (2, 2), (1, 4)
  and (1, 1).
* The local config and attention split a placed cloud computes with, for
  query and kv heads that split alike, differently (one kv head, or kv
  heads that would straddle a rank's query heads) and a moe cloud's
  experts.
* ``ShardedBlockPool`` gives the same ids, counts and exceptions as JAX's
  under seeded random alloc/share/fork/free/can_alloc/trap sequences.
* ``PagedKV(data_shards=2, kv_ways=2)``, built directly in both packages
  without a mesh on bridged parameters, keeps the same tables, stats and
  pool contents through the same admits, ticks, retirements and swaps.
"""
from __future__ import annotations

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import paged_cache as jpc  # noqa: E402
from repro.core import seq_state as jss  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import paged_cache as tpc  # noqa: E402
from repro_torch.core import seq_state as tss  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402

ARCHS = ("smollm-135m", "granite-8b", "granite-moe-1b-a400m", "granite-20b",
         "olmoe-1b-7b")
MESHES = ((2, 4), (2, 2), (1, 4), (1, 1))


def _mesh(data, model):
    """A duck-typed mesh: the axis names and sizes the rules read."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": data, "model": model})


def _path(path) -> str:
    return jsh._path_str(path)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.fixture(scope="module")
def shapes():
    """Per arch: the JAX parameter, cache and paged-cache shape trees
    (``jax.eval_shape``: nothing is computed)."""
    out = {}
    for arch in ARCHS:
        cfg = jget(arch).reduced()
        m = JModel(cfg)
        out[arch] = (cfg, jax.eval_shape(m.init, jax.random.PRNGKey(0)),
                     jax.eval_shape(lambda: m.init_cache(4, 32)),
                     jax.eval_shape(lambda: m.init_paged_cache(18, 4, 4, 8)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dm", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_param_specs_match_jax(shapes, arch, dm):
    cfg, params, _, _ = shapes[arch]
    tcfg = tget(arch).reduced()
    mesh = _mesh(*dm)
    n = 0
    for path, leaf in _leaves(params):
        for c_j, c_t in ((cfg, tcfg), (None, None)):
            want = tuple(jsh.param_spec(path, leaf, mesh, c_j))
            got = tsh.param_spec(_path(path), leaf.shape, mesh, c_t)
            assert got == want, (_path(path), leaf.shape, got, want)
            n += 1
    assert n >= 20


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dm", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_cache_and_paged_specs_match_jax(shapes, arch, dm):
    cfg, _, cache, paged = shapes[arch]
    tcfg = tget(arch).reduced()
    mesh = _mesh(*dm)
    for path, leaf in _leaves(cache):
        want = tuple(jsh.cache_spec(path, leaf, mesh, cfg))
        assert tsh.cache_spec(_path(path), leaf.shape, mesh, tcfg) == want
    for ds in (1, dm[0]):
        for path, leaf in _leaves(paged):
            want = tuple(jsh.paged_cache_spec(path, leaf, mesh, cfg, ds))
            got = tsh.paged_cache_spec(_path(path), leaf.shape, mesh, tcfg,
                                       ds)
            assert got == want, (_path(path), ds, got, want)
    assert tsh.kv_shard_ways(mesh, tcfg) == jsh.kv_shard_ways(mesh, cfg)
    for shape in ((8, 3), (6,), (3, 5, 2), ()):
        assert tsh.batch_spec(shape, mesh) == \
            tuple(jsh.batch_spec(shape, mesh))


def test_spec_wrappers_cover_every_entry(shapes):
    """The dict wrappers (JAX's ``*_shardings``) give each entry its
    rule's spec."""
    cfg = tget("granite-8b").reduced()
    _, _, cache, paged = shapes["granite-8b"]
    mesh = _mesh(2, 2)
    dense = {k: torch.zeros(v.shape) for k, v in cache.items()}
    pool = {k: torch.zeros(v.shape) for k, v in paged.items()}
    assert tsh.cache_specs(dense, mesh, cfg, 4) == {
        k: tsh.cache_spec(k, v.shape, mesh, cfg, 4) for k, v in dense.items()}
    got = tsh.paged_cache_specs(pool, mesh, cfg, data_shards=2)
    assert got["k"] == (None, "data", None, "model", None)
    assert got["table"] == ("data", None) and got["pos"] == ()
    assert tsh.batch_specs({"tokens": torch.zeros(4, 8)}, mesh) == \
        {"tokens": ("data", None)}
    p = TModel(cfg).init(seed=0, device="cpu")
    assert set(tsh.replicated_specs(p).values()) == {()}


def test_recurrent_cache_specs_match_jax():
    """The recurrent rule (batch dim by the runtime B, then the largest
    dim over 'model'): mamba2's state at a runtime batch of 4."""
    cfg = jget("mamba2-370m").reduced()
    cache = jax.eval_shape(lambda: JModel(cfg).init_cache(4, 32))
    jcfg = cfg.replace()
    object.__setattr__(jcfg, "_runtime_batch", 4)
    tcfg = tget("mamba2-370m").reduced()
    for dm in MESHES:
        mesh = _mesh(*dm)
        for path, leaf in _leaves(cache):
            want = tuple(jsh.cache_spec(path, leaf, mesh, jcfg))
            assert tsh.cache_spec(_path(path), leaf.shape, mesh, tcfg,
                                  batch=4) == want


def test_kv_shard_ways_and_balanced_factor_match_jax():
    for arch in ARCHS + ("mamba2-370m",):
        for full in (False, True):
            jc, tc = jget(arch), tget(arch)
            if not full:
                jc, tc = jc.reduced(), tc.reduced()
            for m in (1, 2, 3, 4, 8):
                mesh = _mesh(2, m)
                assert tsh.kv_shard_ways(mesh, tc) == \
                    jsh.kv_shard_ways(mesh, jc)
    for rem in range(1, 65):
        for k in range(1, 4):
            assert tmesh._balanced_factor(rem, k) == \
                jmesh._balanced_factor(rem, k)


@pytest.mark.parametrize("arch,kv,dm,want", [
    ("granite-8b", None, (2, 2), (2, 2, True)),       # 4 / 4 heads, alike
    ("granite-20b", None, (2, 2), (2, 1, True)),      # MQA: queries split
    ("granite-20b", None, (1, 4), (1, 1, True)),
    ("granite-8b", 2, (1, 4), (4, 2, False)),         # 2 kv heads over 4
    ("granite-8b", None, (1, 3), (4, 4, True)),       # nothing splits
])
def test_local_cfg_of_each_head_split(arch, kv, dm, want):
    """(local query heads, local kv heads, attention on local heads) of a
    reduced cloud: kv heads that split as the queries do, one kv head
    (every rank its queries on the whole K/V), more kv heads that do not
    divide 'model' (the attention whole on every rank: ``wq`` / ``wo``
    gathered, no partial sum), and heads that do not divide it at all."""
    cfg = tget(arch).reduced()
    if kv is not None:
        cfg = cfg.replace(num_kv_heads=kv)
    mesh = _mesh(*dm)
    local, heads = tsh._local_cfg(cfg, tsh.block_specs(cfg, mesh), mesh)
    assert (local.num_heads, local.num_kv_heads, heads) == want
    assert local.head_dim == cfg.head_dim


def test_moe_cloud_experts_split_over_model():
    """olmoe's experts split over 'model' with no data split and a
    replicated router (JAX's rule); the forward computes on that split
    (``TensorParallel.gather_block`` keeps it)."""
    cfg = tget("olmoe-1b-7b").reduced()
    specs = tsh.block_specs(cfg, _mesh(2, 2))
    for k in ("moe/w_gate", "moe/w_up", "moe/w_down"):
        assert specs[k] == ("model", None, None)
        assert tsh._COMPUTE_SPLITS[k] == -3
    assert specs["moe/router"] == ()
    local, heads = tsh._local_cfg(cfg, specs, _mesh(2, 2))
    assert (local.num_experts, local.d_ff, heads) == \
        (cfg.num_experts, cfg.d_ff, True)


def test_params_specs_walk_the_port_tree():
    """``params_specs`` over the port's own parameters gives each tensor
    its JAX leaf's spec with the layer axis dropped."""
    cfg = tget("granite-8b").reduced()
    p = TModel(cfg).init(seed=0, device="cpu")
    specs = tsh.params_specs(p, _mesh(2, 2), cfg)
    assert specs["blocks.0.attn.wq"] == ("data", "model")
    assert specs["blocks.1.attn.wo"] == ("model", "data")
    assert specs["blocks.0.mlp.w_down"] == ("model", "data")
    assert specs["blocks.0.attn_norm"] == ("model",)
    assert specs["embed"] == ("model", None)
    assert specs["final_norm"] == ()


# ---------------------------------------------------------------- pools
def _pool_ops(seed, n=400):
    """A seeded random op sequence over 8 owners, 2 shards of 6 blocks."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = rng.choice(["alloc", "grow", "share", "fork", "free",
                           "can", "trap", "can_any"],
                          p=[.25, .1, .15, .15, .15, .1, .05, .05])
        ops.append((str(kind), int(rng.integers(8)), int(rng.integers(8)),
                    int(rng.integers(1, 4)), float(rng.random())))
    return ops


def _run_pool(pool, ops):
    log = []
    for kind, a, b, k, r in ops:
        try:
            if kind == "alloc":
                out = pool.alloc(a, k)
            elif kind == "grow":
                out = pool.grow_to(a, k * 4 + int(r * 8))
            elif kind == "share":
                src = pool.owned(b)
                out = pool.share(a, src[:1 + int(r * len(src))]) if src \
                    else None
            elif kind == "fork":
                mine = pool.owned(a)
                out = pool.fork(a, mine[int(r * len(mine))]) if mine \
                    else None
            elif kind == "free":
                out = sorted(pool.free(a))
            elif kind == "can":
                out = pool.can_alloc(k, owner=a)
            elif kind == "trap":
                out = pool.trap(a)
            else:
                out = pool.can_alloc(k)
            log.append((kind, out, pool.used, pool.peak_used,
                        [pool.owned(o) for o in range(8)]))
        except Exception as e:   # noqa: BLE001 — exceptions are compared
            log.append((kind, type(e).__name__, str(e)))
    return log


@pytest.mark.parametrize("seed", range(4))
def test_sharded_block_pool_matches_jax(seed):
    ops = _pool_ops(seed)

    def shard_of(slot):
        return slot // 4
    j = _run_pool(jpc.ShardedBlockPool(2, 6, 4, shard_of), ops)
    t = _run_pool(tpc.ShardedBlockPool(2, 6, 4, shard_of), ops)
    assert t == j
    kinds = {e[0] for e in j if len(e) == 3}
    assert "RuntimeError" in {e[1] for e in j if len(e) == 3}, kinds


def test_sharded_block_pool_refuses_cross_shard_share():
    p = tpc.ShardedBlockPool(2, 5, 4, shard_of=lambda s: s // 4)
    blocks = p.alloc(0, 1)
    with pytest.raises(RuntimeError, match="cross-shard"):
        p.share(4, blocks)
    assert p.trap(4) == 5 and p.usable() == 4
    new = p.alloc(4, 1)
    p.share(5, new)
    fork = p.fork(5, new[0])
    assert fork // 5 == 1 and p.refcount(new[0]) == 1


# ---------------------------------------------------------------- PagedKV
def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


def _state_of(side, st):
    tab = np.asarray(st.caches["table"])
    pos = np.asarray(st.caches["pos"])
    k = np.asarray(st.caches["k"], np.float32) if side == "j" else \
        st.caches["k"].float().numpy()
    return tab, pos, k, st.stats()


def test_sharded_paged_kv_matches_jax():
    """A 2 x 9 ShardedBlockPool (batch 4, slot 32, block 4, 17 blocks asked
    for) through admits with a shared prefix, a tick, a retirement, a
    swap-out and a swap-in into the other shard: the same tables, pos,
    stats and pool contents."""
    jcfg, tcfg = jget("smollm-135m").reduced(), tget("smollm-135m").reduced()
    jm, tm = JModel(jcfg), TModel(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(_host(jp), tcfg, "cpu")
    jl = jss.Lane(jm, "entropy", 0.0, layout="paged", block_size=4)
    tl = tss.Lane(tm, "entropy", 0.0, layout="paged", block_size=4)
    js = jss.PagedKV(jl, jp, 4, 32, 4, 17, data_shards=2, kv_ways=2)
    ts = tss.PagedKV(tl, tp, 4, 32, 4, 17, data_shards=2, kv_ways=2)
    assert type(ts.pool).__name__ == "ShardedBlockPool"
    assert (ts.pool.shards, ts.pool.per_shard) == (2, 9)
    rng = np.random.default_rng(3)
    base = rng.integers(0, tcfg.vocab_size, 11).astype(np.int32)
    other = rng.integers(0, tcfg.vocab_size, 7).astype(np.int32)
    prompts = {0: base, 1: base.copy(), 2: other, 3: base.copy()}
    snaps = []
    for st in (js, ts):
        for b, p in prompts.items():
            assert st.admit(b, p, p.size - 1 + 6)
        st.flush()
        st.prepare_tick([0, 1, 2, 3], np.array([6, 6, 6, 6]), 4)
        st.retire(2)
        h = st.swap_out(1)
        st.flush()
        assert st.swap_in(2, h)       # slot 2 lives on the other shard
        st.flush()
        snaps.append(st)
    jt, jpos, jk, jst = _state_of("j", js)
    tt, tpos, tk, tst = _state_of("t", ts)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tpos, jpos)
    assert tst == jst
    assert tst["kv_shards"] == 4 and tst["kv_capacity_blocks"] == 16
    assert tst["kv_prefix_hits"] >= 1
    np.testing.assert_allclose(tk, jk, atol=1e-5)
