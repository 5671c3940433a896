"""Rank bodies for ``tests/test_torch_mesh_serving.py``: each runs in a
process spawned by ``repro_torch.launch.mesh.spawn_ranks`` (gloo on the
CPU, a ``FileStore`` rendezvous), imports only the port, and returns
numpy/python results to the parent, which holds them against the JAX
package and the unsharded port.  Not a test module (no ``test_`` prefix):
importing it must stay cheap and free of JAX."""
from __future__ import annotations

import io
import contextlib

import numpy as np
import torch


def pair_cfgs(edge_kv_heads=None, edge="smollm-135m"):
    """The reduced ``edge`` (smollm-135m by default) and granite-8b cloud
    on a shared vocabulary (``edge_kv_heads`` overrides the edge's kv-head
    count)."""
    from repro_torch.configs import get_config
    e = get_config(edge).reduced()
    c = get_config("granite-8b").reduced().replace(vocab_size=e.vocab_size)
    if edge_kv_heads is not None:
        e = e.replace(num_kv_heads=edge_kv_heads)
    return e, c


def engine(mesh=None, edge_kv_heads=None, threshold=-1.0,
           edge="smollm-135m", kv_layout="paged", **kw):
    """The batched engine over ``pair_cfgs`` (paged and linear unless
    told, greedy, no semantic cache)."""
    from repro_torch.core.policy import SpeculativePolicy
    from repro_torch.core.scheduler import BatchedEngine
    from repro_torch.models import Model
    e_cfg, c_cfg = pair_cfgs(edge_kv_heads, edge)
    return BatchedEngine(Model(e_cfg), Model(c_cfg), batch_size=8,
                         temperature=0.0, use_cache=False,
                         policy=SpeculativePolicy(threshold),
                         kv_layout=kv_layout, mesh=mesh, **kw)


def drain(ep, cp, prompts, max_new, **kw):
    """One ``serve_batch`` drain of ``engine(**kw)``: (tokens per request,
    stats)."""
    eng = engine(**kw)
    traces = eng.serve_batch(ep, cp, prompts, max_new)
    return [t.tokens for t in traces], eng.stats()


def shared_prompts(vocab, n=8, length=20, seed=5):
    """Prompts that share block-aligned prefixes in pairs, with two exact
    twins (a shared partial tail block: copy-on-write) on each shard's
    slots."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, 8) for _ in range(2)]
    out = [np.concatenate([heads[i % 2], rng.integers(0, vocab, length - 8)]
                          ).astype(np.int32) for i in range(n)]
    for i in (2, 6):
        out[i] = out[i - 2].copy()
    return out


def seeded_pair(edge_kv_heads=None):
    from repro_torch.models import Model
    e_cfg, c_cfg = pair_cfgs(edge_kv_heads)
    return (Model(e_cfg).init(seed=0, device="cpu"),
            Model(c_cfg).init(seed=1, device="cpu"))


def serve_worker(rank, payload):
    """Everything the mesh test module checks, on one (data 2, model 2)
    mesh of four ranks."""
    from repro_torch import runtime
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    mesh = make_host_mesh(2, 2)
    out = {"coords": mesh.coords}
    e_cfg, c_cfg = pair_cfgs()

    # ---- the JAX mesh test's drain, on bridged parameters
    ep = params_from_numpy(payload["edge"], e_cfg, "cpu")
    cp = params_from_numpy(payload["cloud"], c_cfg, "cpu")
    out["bridged"] = drain(ep, cp, payload["prompts"], 6, mesh=mesh)

    # ---- an hd-split edge pool (one kv head over model 2) under a tight
    # pool: prefix sharing, copy-on-write and preemption by swap per shard
    ep1, cp1 = seeded_pair(edge_kv_heads=1)
    out["hd_split"] = drain(ep1, cp1, payload["shared"], 24, mesh=mesh,
                            edge_kv_heads=1, threshold=1.1, kv_blocks=40,
                            kv_block_size=4)

    # ---- gather_wave / scatter_wave on local slices
    d = mesh.coords["data"]
    with runtime.mesh_context(mesh):
        x = torch.arange(8, dtype=torch.int32).reshape(4, 2)
        y, y2 = runtime.gather_wave(x[2 * d:2 * d + 2],
                                    x[2 * d:2 * d + 2].float() + 1, rows=4)
        z = runtime.gather_wave(torch.ones(3, 2), rows=3)
        s = runtime.scatter_wave(x)
        # shard_map twin: each rank doubles its (data, model) block
        sm = runtime.shard_map(lambda a: a * 2, mesh=mesh,
                               in_specs=(("data", "model"),),
                               out_specs=("data", "model"))(x)
    out["wave"] = (y.numpy(), y2.numpy(), tuple(z.shape), s.numpy(),
                   sm.numpy())

    # ---- expert parallelism on this rank's data slice
    m_cfg = payload["moe_cfg"]
    p = {k: torch.from_numpy(v) for k, v in payload["moe_params"].items()}
    xs = torch.from_numpy(payload["moe_x"][d])
    o, aux = moe.moe_block_sharded(p, xs, m_cfg, mesh, ("data",), "model")
    out["moe"] = (o.numpy(), float(aux))

    # ---- drawing a rank's blocks leaf by leaf equals cutting the whole
    from repro_torch.launch.sharding import init_placed, place_params
    from repro_torch.models import Model
    whole = place_params(Model(c_cfg).init(seed=1, device="cpu"), mesh)
    drawn = init_placed(Model(c_cfg), 1, mesh, "cpu")
    out["placed_equal"] = all(
        torch.equal(a, b) for a, b in zip(whole.parameters(),
                                          drawn.parameters()))

    # ---- the launcher's --mesh path (rank 0's report)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, st = serve.main(["--device", "cpu", "--reduced", "--requests",
                            "4", "--max-new", "4", "--prompt-len", "8",
                            "--mesh", "data=2,model=2", "--batch-size", "4"])
    out["serve"] = (buf.getvalue(), st["mesh_shape"], st["kv_shards"])
    out["moved"] = dict(mesh.moved)
    return out


# ---------------------------------------------------------------- lanes
# the lanes and layouts of ``tests/test_torch_mesh_lanes.py``: drain name
# -> (payload key of the bridged edge, ``engine`` keywords).  "twin" drafts
# trees with the cloud's own weights, so its drafts are accepted and the
# commits move real paths
LANE_DRAINS = {
    "dense": ("edge_kv1", dict(edge_kv_heads=1, kv_layout="dense")),
    "tree": ("edge", dict(kv_layout="dense", spec_mode="tree",
                          spec_tree_width=2)),
    "self": ("edge", dict(spec_mode="self", spec_exit_layer=1)),
    "mamba2": ("mamba2", dict(edge="mamba2-370m", kv_layout="auto")),
    "zamba2": ("zamba2", dict(edge="zamba2-2.7b", kv_layout="auto")),
    "twin": ("cloud", dict(edge="granite-8b", kv_layout="dense",
                           spec_mode="tree", spec_tree_width=2)),
}


def lane_drains(payload, mesh=None):
    """Every ``LANE_DRAINS`` drain on the payload's bridged parameters:
    name -> (tokens, the edge's uncertainty per request, stats)."""
    from repro_torch.bridge import params_from_numpy
    out = {}
    for name, (key, kw) in LANE_DRAINS.items():
        e_cfg, c_cfg = pair_cfgs(kw.get("edge_kv_heads"),
                                 kw.get("edge", "smollm-135m"))
        eng = engine(mesh=mesh, **kw)
        traces = eng.serve_batch(
            params_from_numpy(payload[key], e_cfg, "cpu"),
            params_from_numpy(payload["cloud"], c_cfg, "cpu"),
            payload["prompts"], payload["max_new"])
        out[name] = ([t.tokens for t in traces],
                     [t.uncertainty for t in traces], eng.stats())
    return out


def _dense_shapes(mesh):
    """Per-rank K/V of two dense states — the edge's head-dim split (one
    kv head) over 8 data-split slots, the cloud's kv-head split over a
    whole group — each beside the whole state's shape, its
    ``cache_specs`` entry and the bytes (global, this rank's, whole)."""
    from repro_torch import runtime
    from repro_torch.core.seq_state import stack_slot_caches
    from repro_torch.launch.sharding import (cache_specs, local_attention,
                                             place_params)
    from repro_torch.models import Model
    shapes = {}
    with runtime.mesh_context(mesh):
        for name, kv in (("edge_hd", 1), ("cloud_heads", None)):
            eng = engine(mesh=mesh, edge_kv_heads=kv, kv_layout="dense")
            e_cfg, c_cfg = pair_cfgs(kv)
            if name == "edge_hd":
                lane, cfg = eng.edge, e_cfg
                p = local_attention(Model(cfg).init(device="cpu"), mesh, cfg)
            else:
                lane, cfg = eng.cloud, c_cfg
                p = place_params(Model(cfg).init(device="cpu"), mesh)
            st = lane.make_state(p, 8, 24)
            whole = stack_slot_caches(Model(cfg), 8, 24, "meta")
            shapes[name] = {
                "local": tuple(st.caches["k"].shape),
                "whole": tuple(whole["k"].shape),
                "spec": cache_specs(whole, mesh, cfg, 8)["k"],
                "bytes": (st.capacity_bytes, st.stats()["kv_rank_bytes"],
                          sum(t.nbytes for t in whole.values()))}
    return shapes


def _refusals(mesh, prompt):
    """What the mesh still refuses (ROADMAP A.8): name -> the message."""
    from repro_torch.configs import get_config
    from repro_torch.core.adaptation import AdaptationLoop
    from repro_torch.core.scheduler import BatchedEngine
    from repro_torch.launch.sharding import place_params
    from repro_torch.models import Model
    e_cfg, c_cfg = pair_cfgs()
    m_cfg = get_config("granite-moe-1b-a400m").reduced().replace(
        vocab_size=e_cfg.vocab_size)

    def moe_cloud():
        eng = BatchedEngine(Model(e_cfg), Model(m_cfg), batch_size=8,
                            mesh=mesh)
        eng.serve_batch(Model(e_cfg).init(seed=0, device="cpu"),
                        Model(m_cfg).init(seed=1, device="cpu"), [prompt], 2)

    makers = {
        "adaptation": lambda: engine(mesh=mesh,
                                     adaptation=AdaptationLoop(mode="lora")),
        "moe_cloud": moe_cloud,
        "uneven_heads": lambda: place_params(
            Model(c_cfg.replace(num_kv_heads=1)).init(device="cpu"), mesh)}
    out = {}
    for name, make in makers.items():
        try:
            make()
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def lanes_worker(rank, payload):
    """The ``LANE_DRAINS``, the per-rank dense shapes, the refusals and
    ``serve.py --mesh`` on the tree lane, on one (data 2, model 2) mesh of
    four ranks."""
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    mesh = make_host_mesh(2, 2)
    out = {"coords": mesh.coords, "drains": lane_drains(payload, mesh),
           "shapes": _dense_shapes(mesh),
           "refused": _refusals(mesh, payload["prompts"][0])}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, st = serve.main(["--device", "cpu", "--reduced", "--requests",
                            "4", "--max-new", "4", "--prompt-len", "8",
                            "--mesh", "data=2,model=2", "--batch-size", "4",
                            "--spec-mode", "tree", "--kv-layout", "dense"])
    out["serve"] = (buf.getvalue(), st["spec_mode"], st["mesh_shape"])
    out["moved"] = dict(mesh.moved)
    return out
