"""Sharded serving of the port on a (data 2, model 2) mesh of four CPU
ranks (gloo, a ``FileStore`` rendezvous under ``tmp_path``): ONE spawn
for the module (``tests/torch_mesh_workers.py::serve_worker``), held
against the JAX package and the unsharded port.

* The JAX mesh test's drain (reduced smollm-135m edge, granite-8b cloud,
  8 prompts, 6 tokens, ``SpeculativePolicy(-1.0)``, paged) on parameters
  bridged from JAX: every rank's tokens equal the unsharded port's and the
  JAX unsharded engine's; ``kv_shards``, ``kv_capacity_blocks`` above the
  unsharded engine's, ``mesh_devices`` and ``mesh_shape``.
* An edge with one kv head (its pool split on the head dim, gathered per
  step) under a tight pool: prefix sharing, CoW and preemption per shard,
  the same tokens as the unsharded port.
* ``gather_wave`` / ``scatter_wave``: the identity off-mesh, a concat over
  dp, the identity at an odd G; the ``shard_map`` twin over both axes.
* ``moe_block_sharded`` on each data slice within 1e-5 of JAX's
  ``moe_block`` on that slice, and (in this process) of JAX's own
  ``moe_block_sharded`` on a one-device (1, 1) JAX mesh.
* ``serve.py --mesh data=2,model=2`` reports the mesh.
"""
from __future__ import annotations

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
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import runtime  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch.mesh import make_mesh, spawn_ranks  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Spawn the four ranks in a thread and, meanwhile, run the JAX and the
    unsharded port engines here."""
    torch.set_num_threads(1)
    je = jget("smollm-135m").reduced()
    jc = jget("granite-8b").reduced().replace(vocab_size=je.vocab_size)
    jep = JModel(je).init(jax.random.PRNGKey(0))
    jcp = JModel(jc).init(jax.random.PRNGKey(1))
    synth = SyntheticLM(je.vocab_size)
    rng = np.random.default_rng(0)
    prompts = [synth.sample(rng, i % synth.n_domains, 8) for i in range(8)]
    m_cfg = tget("granite-moe-1b-a400m").reduced()
    mj = JModel(jget("granite-moe-1b-a400m").reduced())
    mp = _host(jax.tree.map(lambda x: x[0],
                            mj.init(jax.random.PRNGKey(2))["blocks"]["moe"]))
    mx = np.random.default_rng(1).standard_normal(
        (2, 2, 8, m_cfg.d_model)).astype(np.float32)
    payload = {"edge": _host(jep), "cloud": _host(jcp), "prompts": prompts,
               "shared": W.shared_prompts(je.vocab_size), "moe_cfg": m_cfg,
               "moe_params": mp, "moe_x": mx}
    box = {}

    def spawn():
        try:
            box["ranks"] = spawn_ranks(
                W.serve_worker, 4, payload,
                store=str(tmp_path_factory.mktemp("mesh") / "store"),
                timeout=240)
        except Exception as e:   # noqa: BLE001 — re-raised below
            box["error"] = e

    th = threading.Thread(target=spawn)
    th.start()
    eng = JEngine(JModel(je), JModel(jc), batch_size=8, temperature=0.0,
                  use_cache=False, policy=JSpec(-1.0), kv_layout="paged")
    jtoks = [t.tokens for t in eng.serve_batch(jep, jcp, prompts, 6)]
    e_cfg, c_cfg = W.pair_cfgs()
    bridged = W.drain(params_from_numpy(payload["edge"], e_cfg, "cpu"),
                      params_from_numpy(payload["cloud"], c_cfg, "cpu"),
                      prompts, 6)
    hd = W.drain(*W.seeded_pair(edge_kv_heads=1), payload["shared"], 24,
                 edge_kv_heads=1, threshold=1.1, kv_blocks=40, kv_block_size=4)
    th.join()
    if "error" in box:
        raise box["error"]
    return {"jax": jtoks, "port": bridged, "hd": hd, "ranks": box["ranks"],
            "payload": payload}


def test_mesh_tokens_match_unsharded_port_and_jax(served):
    toks, _ = served["port"]
    assert toks == served["jax"]
    for r in served["ranks"]:
        assert r["bridged"][0] == toks


def test_mesh_kv_stats(served):
    _, st0 = served["port"]
    assert st0["kv_shards"] == 1 and "mesh_devices" not in st0
    for r in served["ranks"]:
        st = r["bridged"][1]
        assert st["kv_shards"] == 4 > 1         # 2 data shards x 2 kv ways
        assert st["kv_capacity_blocks"] > st0["kv_capacity_blocks"]
        assert st["mesh_devices"] == 4
        assert st["mesh_shape"] == {"data": 2, "model": 2}
    assert {tuple(r["coords"].values()) for r in served["ranks"]} == \
        {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_mesh_hd_split_edge_pool_with_preemption(served):
    toks, st0 = served["hd"]
    for r in served["ranks"]:
        got, st = r["hd_split"]
        assert got == toks
        assert st["kv_shards"] == 4 and st["kv_prefix_hits"] > 0
        assert st["preemptions"] > 0 and st["kv_swaps"] > 0
        assert st["kv_cow_forks"] > 0
    assert all(len(t) == 24 for t in toks)


def test_gather_wave_off_and_on_mesh(served):
    x = torch.arange(8, dtype=torch.int32).reshape(4, 2)
    assert runtime.gather_wave(x) is x            # identity off-mesh
    a, b = runtime.gather_wave(x, x + 1)
    assert a is x and runtime.scatter_wave(x) is x
    for r in served["ranks"]:
        y, y2, z_shape, s, sm = r["wave"]
        np.testing.assert_array_equal(sm, 2 * x.numpy())  # shard_map twin
        np.testing.assert_array_equal(y, x.numpy())      # concat over dp
        np.testing.assert_array_equal(y2, x.numpy() + 1)
        assert z_shape == (3, 2)                          # odd G: identity
        d = r["coords"]["data"]
        np.testing.assert_array_equal(s, x.numpy()[2 * d:2 * d + 2])


def test_moe_block_sharded_matches_jax_per_data_slice(served):
    pay = served["payload"]
    jcfg = jget("granite-moe-1b-a400m").reduced()
    jp = {k: jnp.asarray(v) for k, v in pay["moe_params"].items()}
    for r in served["ranks"]:
        d = r["coords"]["data"]
        want, _ = jmoe.moe_block(jp, jnp.asarray(pay["moe_x"][d]), jcfg)
        out, aux = r["moe"]
        np.testing.assert_allclose(out, np.asarray(want), atol=1e-5)
        assert np.isfinite(aux)
    auxes = {round(r["moe"][1], 6) for r in served["ranks"]}
    assert len(auxes) == 1                        # averaged over all axes


def test_moe_block_sharded_matches_jax_one_device_mesh(served):
    """Both packages' expert-parallel blocks on a one-position mesh (no
    process group here) and the plain block agree."""
    pay = served["payload"]
    jcfg = jget("granite-moe-1b-a400m").reduced()
    jp = {k: jnp.asarray(v) for k, v in pay["moe_params"].items()}
    x = pay["moe_x"][0]
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    want, jaux = jmoe.moe_block_sharded(jp, jnp.asarray(x), jcfg, jmesh,
                                        ("data",), "model")
    mesh = make_mesh((1, 1), ("data", "model"))
    tp = {k: torch.tensor(v) for k, v in pay["moe_params"].items()}
    got, aux = tmoe.moe_block_sharded(tp, torch.tensor(x),
                                      tget("granite-moe-1b-a400m").reduced(),
                                      mesh, ("data",), "model")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    plain, _ = tmoe.moe_block(tp, torch.tensor(x),
                              tget("granite-moe-1b-a400m").reduced())
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6)


def test_placement_drawn_leaf_by_leaf_equals_cut(served):
    assert all(r["placed_equal"] for r in served["ranks"])


def test_serve_cli_mesh(served):
    reports = [r["serve"] for r in served["ranks"]]
    text, shape, shards = reports[0]
    assert "mesh: {'data': 2, 'model': 2} over 4 ranks" in text
    assert "shards=" in text and "capacity_blocks=" in text
    assert shape == {"data": 2, "model": 2} and shards > 1
    assert all(rep[0] == "" for rep in reports[1:])   # only rank 0 prints


def test_collectives_moved_bytes(served):
    for r in served["ranks"]:
        moved = r["moved"]
        assert moved.get("all_gather/data", 0) > 0     # waves, FSDP
        assert moved.get("all_gather/model", 0) > 0    # edge blocks, vocab
        assert moved.get("all_reduce/model", 0) > 0    # row-parallel sums
