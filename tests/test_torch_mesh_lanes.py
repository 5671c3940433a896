"""Every lane and layout of the port's ``BatchedEngine`` on a (data 2,
model 2) mesh of four CPU ranks (gloo, a ``FileStore`` rendezvous under
``tmp_path``): ONE spawn for the module
(``tests/torch_mesh_workers.py::lanes_worker``), held against the
unsharded port and the JAX package.

* The ``LANE_DRAINS`` on parameters bridged from JAX (reduced configs,
  f32, 8 prompts, 6 new tokens, ``SpeculativePolicy(-1.0)``): the linear
  lane on the dense layout with a one-kv-head edge (its K/V split on the
  head dim, gathered every step), the tree lane (width 2, dense), the
  self lane (exit layer 1), a mamba2-370m edge, a zamba2-2.7b edge (the
  hybrid state's shared-attention K/V), and the tree lane drafted with
  the cloud's own weights (accepted trees, real commit paths).  Every
  rank's tokens, edge uncertainties and lane counters equal the
  unsharded port's; the tree lane's tokens equal the JAX unsharded
  engine's.
* One dense state's per-rank K/V shape and bytes against ``cache_specs``.
* The refusals that remain (adaptation, a moe cloud, uneven head
  splits) name ROADMAP A.8; ``serve.py --mesh`` serves the tree lane.
"""
from __future__ import annotations

import math
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_mesh_workers as W  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.policy import SpeculativePolicy as JSpec  # noqa: E402
from repro.core.scheduler import BatchedEngine as JEngine  # noqa: E402
from repro.data import SyntheticLM  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402

MAX_NEW = 6


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    """JAX-initialized parameters for every edge and the cloud; the four
    ranks spawn in a thread while the JAX tree-lane engine and the
    unsharded port's drains run here."""
    torch.set_num_threads(1)
    je = jget("smollm-135m").reduced()
    jc = jget("granite-8b").reduced().replace(vocab_size=je.vocab_size)
    cfgs = {"edge": je, "edge_kv1": je.replace(num_kv_heads=1),
            "mamba2": jget("mamba2-370m").reduced(),
            "zamba2": jget("zamba2-2.7b").reduced()}
    jparams = {k: JModel(c).init(jax.random.PRNGKey(0))
               for k, c in cfgs.items()}
    jparams["cloud"] = JModel(jc).init(jax.random.PRNGKey(1))
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
    eng = JEngine(JModel(je), JModel(jc), batch_size=8, temperature=0.0,
                  use_cache=False, policy=JSpec(-1.0), kv_layout="dense",
                  spec_mode="tree", spec_tree_width=2)
    jtree = [t.tokens for t in eng.serve_batch(jparams["edge"],
                                               jparams["cloud"], prompts,
                                               MAX_NEW)]
    base = W.lane_drains(payload)
    th.join()
    if "error" in box:
        raise box["error"]
    return {"jax_tree": jtree, "base": base, "ranks": box["ranks"]}


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


def test_drains_serve_the_asked_lanes_and_layouts(lanes):
    base = lanes["base"]
    assert {n: (base[n][2]["spec_mode"], base[n][2]["kv_layout"])
            for n in base} == {
        "dense": ("linear", "dense"), "tree": ("tree", "dense"),
        "self": ("self", "paged"), "mamba2": ("linear", "dense"),
        "zamba2": ("linear", "dense"), "twin": ("tree", "dense")}
    # the twin's trees are the cloud's own greedy paths: every draft node
    # of the accepted path lands, so the commits move real rows
    twin = base["twin"][2]["spec_lanes"]["tree"]
    assert twin["accepted_tokens"] > 0


def test_tree_lane_matches_jax(lanes):
    assert lanes["base"]["tree"][0] == lanes["jax_tree"]
    for r in lanes["ranks"]:
        assert r["drains"]["tree"][0] == lanes["jax_tree"]


@pytest.mark.parametrize("name,split,rows", [("edge_hd", 4, True),
                                             ("cloud_heads", 3, False)])
def test_dense_state_per_rank_shape_follows_cache_specs(lanes, name, split,
                                                         rows):
    """The edge's one kv head splits on the head dim and its slots over
    'data'; the cloud's kv heads split over 'model', and its group stays
    whole on every rank (the wave is gathered before the verify), where
    ``cache_spec`` would also split its rows."""
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


def test_remaining_refusals_name_roadmap_a8(lanes):
    for r in lanes["ranks"]:
        msgs = r["refused"]
        assert set(msgs) == {"adaptation", "moe_cloud", "uneven_heads"}
        assert all("A.8" in m for m in msgs.values())


def test_serve_cli_mesh_tree_lane(lanes):
    reports = [r["serve"] for r in lanes["ranks"]]
    text, mode, shape = reports[0]
    assert "mesh: {'data': 2, 'model': 2} over 4 ranks" in text
    assert "spec: mode=tree" in text and "layout=dense" in text
    assert mode == "tree" and shape == {"data": 2, "model": 2}
    assert all(rep[0] == "" for rep in reports[1:])   # only rank 0 prints


def test_lane_collectives_moved_bytes(lanes):
    for r in lanes["ranks"]:
        moved = r["moved"]
        assert moved.get("all_gather/data", 0) > 0     # waves, ticks
        assert moved.get("all_gather/model", 0) > 0    # hd halves, vocab
        assert moved.get("all_reduce/model", 0) > 0    # local heads
