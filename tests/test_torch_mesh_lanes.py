"""Every lane, layout, cloud and adaptation loop of the port's
``BatchedEngine`` on a (data 2, model 2) mesh of four CPU ranks (gloo, a
``FileStore`` rendezvous under ``tmp_path``): ONE spawn for the module
(``tests/torch_mesh_workers.py::lanes_worker``), held against the
unsharded port and the JAX package.

* The ``LANE_DRAINS`` on parameters bridged from JAX (reduced configs,
  f32, 8 prompts, 6 new tokens, ``SpeculativePolicy(-1.0)`` unless told):
  the linear lane on the dense layout with a one-kv-head edge (its K/V
  split on the head dim, gathered every step), the tree lane (width 2,
  dense), the self lane (exit layer 1), a mamba2-370m edge, a zamba2-2.7b
  edge (the hybrid state's shared-attention K/V), the tree lane drafted
  with the cloud's own weights (accepted trees, real commit paths), a
  ``distill`` loop behind ``ThresholdPolicy(-1.0)`` and a ``lora`` loop
  (batch 4, an update every 2 completions: the second wave runs on
  swapped weights), an olmoe-1b-7b cloud (4 experts over model 2) and a
  granite-20b cloud (4 query heads, 1 kv head: the query heads split,
  the K/V computed whole and cached split on the head dim; every request
  regenerated on it, ``ThresholdPolicy(-1.0)``), and a cloud of 6 query
  heads over 3 kv heads (a rank's query heads would straddle two kv
  groups: its attention runs whole on every rank).  Every rank's
  tokens, edge uncertainties and lane counters equal the unsharded
  port's; the tree lane's, the distill loop's and both clouds' tokens
  equal the JAX unsharded engine's; the loops' counts and last loss
  equal the unsharded port's, and the distill loop's JAX's (loss within
  2e-6: the teacher logits come from a tensor-parallel cloud).
* Per-rank K/V shapes and bytes against ``cache_specs`` and
  ``paged_cache_specs``; the one-kv-head cloud's ``kv_capacity_blocks``
  against JAX's ``PagedKV``.
* ``serve.py --mesh`` serves the tree lane, ``--adapt distill`` and a moe
  ``--cloud``.
"""
from __future__ import annotations

import math
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_mesh_workers as W  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import seq_state as jss  # noqa: E402
from repro.core.adaptation import AdaptationLoop as JLoop  # noqa: E402
from repro.core.policy import SpeculativePolicy as JSpec  # noqa: E402
from repro.core.policy import ThresholdPolicy as JThreshold  # noqa: E402
from repro.core.scheduler import BatchedEngine as JEngine  # noqa: E402
from repro.data import SyntheticLM  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.training.optimizer import AdamW as JAdamW  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402

MAX_NEW = 6


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


# the other clouds of ``LANE_DRAINS``: arch -> the seed of its JAX init
CLOUDS = {"olmoe-1b-7b": 2, "granite-20b": 3}


def _jax_drains(je, jc, jparams, prompts):
    """The JAX unsharded engine's tokens on the tree lane, the distill
    loop (with the loop's stats) and both other clouds: the same settings
    as their ``LANE_DRAINS`` entries."""
    def drain(cloud, **kw):
        cfg = jc if cloud == "cloud" else jget(cloud).reduced().replace(
            vocab_size=je.vocab_size)
        kw = {"batch_size": 8, "policy": JSpec(-1.0), **kw}
        eng = JEngine(JModel(je), JModel(cfg), temperature=0.0,
                      use_cache=False, **kw)
        traces = eng.serve_batch(jparams["edge"], jparams[cloud], prompts,
                                 MAX_NEW)
        return [t.tokens for t in traces], eng.stats()

    loop = JLoop(mode="distill", topk=4, opt=JAdamW(lr=1e-3, eps=1e-3),
                 **W.ADAPT)
    out = {"tree": drain("cloud", kv_layout="dense", spec_mode="tree",
                         spec_tree_width=2)[0],
           "distill": drain("cloud", batch_size=4, kv_layout="paged",
                            policy=JThreshold(-1.0), adaptation=loop)}
    out.update({"olmoe": drain("olmoe-1b-7b", kv_layout="paged")[0],
                "granite20b": drain("granite-20b", kv_layout="paged",
                                    policy=JThreshold(-1.0))[0]})
    return out


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    """JAX-initialized parameters for every edge and cloud; the four
    ranks spawn in a thread while the JAX unsharded engine's drains and
    the unsharded port's run here."""
    torch.set_num_threads(1)
    je = jget("smollm-135m").reduced()
    jc = jget("granite-8b").reduced().replace(vocab_size=je.vocab_size)
    cfgs = {"edge": je, "edge_kv1": je.replace(num_kv_heads=1),
            "mamba2": jget("mamba2-370m").reduced(),
            "zamba2": jget("zamba2-2.7b").reduced()}
    jparams = {k: JModel(c).init(jax.random.PRNGKey(0))
               for k, c in cfgs.items()}
    jparams["cloud"] = JModel(jc).init(jax.random.PRNGKey(1))
    for arch, seed in CLOUDS.items():
        jparams[arch] = JModel(jget(arch).reduced().replace(
            vocab_size=je.vocab_size)).init(jax.random.PRNGKey(seed))
    jparams["straddle"] = JModel(jc.replace(num_heads=6, num_kv_heads=3)
                                 ).init(jax.random.PRNGKey(4))
    synth = SyntheticLM(je.vocab_size)
    rng = np.random.default_rng(0)
    prompts = [synth.sample(rng, i % synth.n_domains, 8) for i in range(8)]
    payload = {k: _host(p) for k, p in jparams.items()}
    payload.update(prompts=prompts, max_new=MAX_NEW)
    box = {}

    def spawn():
        try:
            box["ranks"] = spawn_ranks(
                W.lanes_worker, 4, payload,
                store=str(tmp_path_factory.mktemp("lanes") / "store"),
                timeout=240)
        except Exception as e:   # noqa: BLE001 — re-raised below
            box["error"] = e

    th = threading.Thread(target=spawn)
    th.start()
    jax_drains = _jax_drains(je, jc, jparams, prompts)
    jcfg = jget("granite-20b").reduced().replace(vocab_size=je.vocab_size)
    jlane = jss.Lane(JModel(jcfg), "entropy", 0.0, layout="paged",
                     block_size=4)
    duck = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 2, "model": 2})
    jpool = jss.PagedKV(jlane, jparams["granite-20b"], 8, 32, 4,
                        kv_ways=jsh.kv_shard_ways(duck, jcfg)).stats()
    base = W.lane_drains(payload)
    th.join()
    if "error" in box:
        raise box["error"]
    return {"jax": jax_drains, "jax_pool": jpool, "base": base,
            "ranks": box["ranks"]}


@pytest.mark.parametrize("name", list(W.LANE_DRAINS))
def test_mesh_drain_matches_unsharded_port(lanes, name):
    toks, unc, st0 = lanes["base"][name]
    assert all(len(t) == MAX_NEW for t in toks)
    assert "mesh_devices" not in st0
    for r in lanes["ranks"]:
        got, got_unc, st = r["drains"][name]
        assert got == toks
        np.testing.assert_allclose(got_unc, unc, rtol=1e-5, atol=1e-6)
        assert st["spec_mode"] == st0["spec_mode"]
        assert st["spec_lanes"] == st0["spec_lanes"]
        assert st["kv_layout"] == st0["kv_layout"]
        assert st["mesh_devices"] == 4
        assert st["mesh_shape"] == {"data": 2, "model": 2}
        if "adaptation" in st0:
            _same_loop(st["adaptation"], st0["adaptation"], 0.0)


def _same_loop(got, want, loss_tol):
    """Two adaptation loops' stats agree: every count, and the last loss
    within ``loss_tol``."""
    keys = ("mode", "observed", "updates", "train_steps", "swaps",
            "store_size")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert abs(got["last_loss"] - want["last_loss"]) <= loss_tol


def test_drains_serve_the_asked_lanes_and_layouts(lanes):
    base = lanes["base"]
    assert {n: (base[n][2]["spec_mode"], base[n][2]["kv_layout"])
            for n in base} == {
        "dense": ("linear", "dense"), "tree": ("tree", "dense"),
        "self": ("self", "paged"), "mamba2": ("linear", "dense"),
        "zamba2": ("linear", "dense"), "twin": ("tree", "dense"),
        "distill": ("linear", "paged"), "lora": ("linear", "paged"),
        "olmoe": ("linear", "paged"), "granite20b": ("linear", "paged"),
        "straddle": ("linear", "paged")}
    # the twin's trees are the cloud's own greedy paths: every draft node
    # of the accepted path lands, so the commits move real rows
    twin = base["twin"][2]["spec_lanes"]["tree"]
    assert twin["accepted_tokens"] > 0


def test_tree_lane_matches_jax(lanes):
    assert lanes["base"]["tree"][0] == lanes["jax"]["tree"]
    for r in lanes["ranks"]:
        assert r["drains"]["tree"][0] == lanes["jax"]["tree"]


@pytest.mark.parametrize("name", ["distill", "lora"])
def test_adaptation_on_the_mesh_swaps_as_unsharded(lanes, name):
    """Each loop swapped mid-drain on every rank (the second wave served
    on the swapped weights), and the distill loop's tokens, counts and
    last loss are JAX's (the teacher logits of a tensor-parallel cloud
    differ in the last bits: 2e-6)."""
    want = lanes["base"][name][2]["adaptation"]
    assert want["swaps"] >= 1 and want["train_steps"] >= 1
    for r in lanes["ranks"]:
        _same_loop(r["drains"][name][2]["adaptation"], want, 2e-6)
        # every swap takes rank 0's weights
        assert r["drains"][name][2]["moved"]["broadcast/data,model"] > 0
    if name == "distill":
        jtoks, jst = lanes["jax"]["distill"]
        assert lanes["base"]["distill"][0] == jtoks
        _same_loop(want, jst["adaptation"], 2e-6)
        for r in lanes["ranks"]:
            assert r["drains"]["distill"][0] == jtoks
            _same_loop(r["drains"]["distill"][2]["adaptation"],
                       jst["adaptation"], 2e-6)


@pytest.mark.parametrize("name,moved", [("olmoe", "all_reduce/model"),
                                        ("granite20b", "all_gather/model")])
def test_moe_and_one_kv_head_clouds_match_jax(lanes, name, moved):
    """The olmoe cloud's experts sum over 'model' in every verify; the
    granite-20b cloud's pool gathers its head-dim halves every step."""
    want = lanes["jax"][name]
    assert lanes["base"][name][0] == want
    for r in lanes["ranks"]:
        toks, _, st = r["drains"][name]
        assert toks == want
        assert st["moved"].get(moved, 0) > 0


@pytest.mark.parametrize("name,split,rows", [("edge_hd", 4, True),
                                             ("cloud_heads", 3, False),
                                             ("cloud_hd", 4, False)])
def test_dense_state_per_rank_shape_follows_cache_specs(lanes, name, split,
                                                         rows):
    """The edge's one kv head splits on the head dim and its slots over
    'data'; the cloud's kv heads split over 'model' (granite-20b's one kv
    head: its head dim), and its group stays whole on every rank (the
    wave is gathered before the verify), where ``cache_spec`` would also
    split its rows."""
    for r in lanes["ranks"]:
        got = r["shapes"][name]
        spec = got["spec"]
        assert spec[split] == "model" and spec[1] == "data"
        want = tuple(n // 2 if ax == "model" or (ax == "data" and rows)
                     else n for n, ax in zip(got["whole"], spec))
        assert got["local"] == want
        glob, mine, whole = got["bytes"]
        assert glob == whole                    # every rank's part
        # this rank's f32 K and V, and its slots' int32 positions
        assert mine == 2 * 4 * math.prod(got["local"]) + 4 * got["local"][1]


def test_one_kv_head_cloud_pool_follows_paged_specs_and_jax(lanes):
    """granite-20b's cloud lane at (2, 2): each rank computes its 2 query
    heads on the whole K/V (one kv head), holds the head-dim half of
    every block of the pool ``paged_cache_specs`` places, and the pool's
    capacity is JAX's."""
    for r in lanes["ranks"]:
        got = r["uneven_pool"]
        assert got["heads"] == (2, 1, True) and got["gather"]
        assert got["spec"] == (None, None, None, None, "model")
        want = got["whole"][:4] + (got["whole"][4] // 2,)
        assert got["local"] == want
        st = got["stats"]
        assert st["kv_capacity_blocks"] == \
            lanes["jax_pool"]["kv_capacity_blocks"]
        assert st["kv_shards"] == lanes["jax_pool"]["kv_shards"] == 2


def test_serve_cli_mesh_tree_lane(lanes):
    reports = [r["serve"] for r in lanes["ranks"]]
    text, mode, shape = reports[0]
    assert "mesh: {'data': 2, 'model': 2} over 4 ranks" in text
    assert "spec: mode=tree" in text and "layout=dense" in text
    assert mode == "tree" and shape == {"data": 2, "model": 2}
    assert all(rep[0] == "" for rep in reports[1:])   # only rank 0 prints


def test_serve_cli_mesh_adapt_distill(lanes):
    text, st = lanes["ranks"][0]["serve_adapt"]
    assert "adapt: mode=distill" in text
    assert st["swaps"] >= 1 and st["last_loss"] is not None
    for r in lanes["ranks"][1:]:
        assert r["serve_adapt"][0] == ""               # only rank 0 prints
        _same_loop(r["serve_adapt"][1], st, 0.0)


def test_serve_cli_mesh_moe_cloud(lanes):
    text, mode, shape = lanes["ranks"][0]["serve_moe"]
    assert "mesh: {'data': 2, 'model': 2} over 4 ranks" in text
    assert "4 requests in" in text
    assert mode == "linear" and shape == {"data": 2, "model": 2}


def test_lane_collectives_moved_bytes(lanes):
    for r in lanes["ranks"]:
        moved = r["moved"]
        assert moved.get("all_gather/data", 0) > 0     # waves, ticks
        assert moved.get("all_gather/model", 0) > 0    # hd halves, vocab
        assert moved.get("all_reduce/model", 0) > 0    # local heads
