"""Rank bodies for ``tests/test_torch_mesh_{serving,lanes,training}.py``:
each runs in a process spawned by ``repro_torch.launch.mesh.spawn_ranks``
(gloo on the CPU, a ``FileStore`` rendezvous), imports only the port, and
returns
numpy/python results to the parent, which holds them against the JAX
package and the unsharded port.  Not a test module (no ``test_`` prefix):
importing it must stay cheap and free of JAX."""
from __future__ import annotations

import io
import contextlib

import numpy as np
import torch


def pair_cfgs(edge_kv_heads=None, edge="smollm-135m", cloud="granite-8b",
              cloud_heads=None):
    """The reduced ``edge`` (smollm-135m by default) and ``cloud``
    (granite-8b by default) on a shared vocabulary (``edge_kv_heads``
    overrides the edge's kv-head count, ``cloud_heads`` the cloud's
    (query, kv) head counts)."""
    from repro_torch.configs import get_config
    e = get_config(edge).reduced()
    c = get_config(cloud).reduced().replace(vocab_size=e.vocab_size)
    if edge_kv_heads is not None:
        e = e.replace(num_kv_heads=edge_kv_heads)
    if cloud_heads is not None:
        c = c.replace(num_heads=cloud_heads[0], num_kv_heads=cloud_heads[1])
    return e, c


def engine(mesh=None, edge_kv_heads=None, threshold=-1.0,
           edge="smollm-135m", kv_layout="paged", cloud="granite-8b",
           cloud_heads=None, policy="speculative", adapt=None, batch_size=8,
           **kw):
    """The batched engine over ``pair_cfgs`` (paged and linear unless
    told, greedy, no semantic cache).  ``policy``: "speculative" or
    "threshold" at ``threshold``; ``adapt``: the keywords of a fresh
    ``AdaptationLoop`` (AdamW at lr 1e-3, eps 1e-3)."""
    from repro_torch.core.adaptation import AdaptationLoop
    from repro_torch.core.policy import SpeculativePolicy, ThresholdPolicy
    from repro_torch.core.scheduler import BatchedEngine
    from repro_torch.models import Model
    from repro_torch.training.optimizer import AdamW
    e_cfg, c_cfg = pair_cfgs(edge_kv_heads, edge, cloud, cloud_heads)
    pol = {"speculative": SpeculativePolicy,
           "threshold": ThresholdPolicy}[policy](threshold)
    loop = None if adapt is None else \
        AdaptationLoop(opt=AdamW(lr=1e-3, eps=1e-3), **adapt)
    return BatchedEngine(Model(e_cfg), Model(c_cfg), batch_size=batch_size,
                         temperature=0.0, use_cache=False, policy=pol,
                         kv_layout=kv_layout, mesh=mesh, adaptation=loop,
                         **kw)


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
# the lanes, layouts, clouds and adaptation loops of
# ``tests/test_torch_mesh_lanes.py``: drain name -> (payload key of the
# bridged edge, ``engine`` keywords; a "cloud" keyword names the cloud's
# arch and its payload key, granite-8b's is "cloud", unless "cloud_key"
# names another).  "twin" drafts trees
# with the cloud's own weights, so its drafts are accepted and the commits
# move real paths; "distill" and "lora" serve 8 requests through 4 slots
# with an update due every 2 completions, so the second wave runs on
# swapped edge weights; "olmoe" is a moe cloud (4 experts over model 2),
# "granite20b" a cloud of 4 query heads and 1 kv head that regenerates
# every request (its decode steps on the gathered head-dim halves),
# "straddle" one of 6 query heads over 3 kv heads (a rank's 3 query heads
# would span two kv groups: its attention runs whole on every rank)
ADAPT = dict(interval=2, batch_size=4, seq_len=16, min_records=1)
LANE_DRAINS = {
    "dense": ("edge_kv1", dict(edge_kv_heads=1, kv_layout="dense")),
    "tree": ("edge", dict(kv_layout="dense", spec_mode="tree",
                          spec_tree_width=2)),
    "self": ("edge", dict(spec_mode="self", spec_exit_layer=1)),
    "mamba2": ("mamba2", dict(edge="mamba2-370m", kv_layout="auto")),
    "zamba2": ("zamba2", dict(edge="zamba2-2.7b", kv_layout="auto")),
    "twin": ("cloud", dict(edge="granite-8b", kv_layout="dense",
                           spec_mode="tree", spec_tree_width=2)),
    "distill": ("edge", dict(policy="threshold", batch_size=4,
                             adapt=dict(mode="distill", topk=4, **ADAPT))),
    "lora": ("edge", dict(batch_size=4, adapt=dict(mode="lora", **ADAPT))),
    "olmoe": ("edge", dict(cloud="olmoe-1b-7b")),
    "granite20b": ("edge", dict(cloud="granite-20b", policy="threshold")),
    "straddle": ("edge", dict(cloud_heads=(6, 3), cloud_key="straddle")),
}


def lane_drains(payload, mesh=None):
    """Every ``LANE_DRAINS`` drain on the payload's bridged parameters:
    name -> (tokens, the edge's uncertainty per request, stats; on a mesh
    the stats also hold the bytes each collective moved in the drain,
    under "moved")."""
    from repro_torch.bridge import params_from_numpy
    out = {}
    for name, (key, kw) in LANE_DRAINS.items():
        kw = dict(kw)
        cloud_key = kw.pop("cloud_key", kw.get("cloud", "cloud"))
        e_cfg, c_cfg = pair_cfgs(kw.get("edge_kv_heads"),
                                 kw.get("edge", "smollm-135m"),
                                 kw.get("cloud", "granite-8b"),
                                 kw.get("cloud_heads"))
        eng = engine(mesh=mesh, **kw)
        before = dict(mesh.moved) if mesh is not None else {}
        traces = eng.serve_batch(
            params_from_numpy(payload[key], e_cfg, "cpu"),
            params_from_numpy(payload[cloud_key], c_cfg, "cpu"),
            payload["prompts"], payload["max_new"])
        st = eng.stats()
        if mesh is not None:
            st["moved"] = {k: n - before.get(k, 0)
                           for k, n in mesh.moved.items()
                           if n != before.get(k, 0)}
        out[name] = ([t.tokens for t in traces],
                     [t.uncertainty for t in traces], st)
    return out


def _dense_shapes(mesh):
    """Per-rank K/V of three dense states — the edge's head-dim split (one
    kv head) over 8 data-split slots, the cloud's kv-head split over a
    whole group, and a one-kv-head cloud's head-dim split (granite-20b)
    over a whole group — each beside the whole state's shape, its
    ``cache_specs`` entry and the bytes (global, this rank's, whole)."""
    from repro_torch import runtime
    from repro_torch.core.seq_state import stack_slot_caches
    from repro_torch.launch.sharding import (cache_specs, local_attention,
                                             place_params)
    from repro_torch.models import Model
    shapes = {}
    with runtime.mesh_context(mesh):
        for name, kv, cloud in (("edge_hd", 1, "granite-8b"),
                                ("cloud_heads", None, "granite-8b"),
                                ("cloud_hd", None, "granite-20b")):
            eng = engine(mesh=mesh, edge_kv_heads=kv, kv_layout="dense",
                         cloud=cloud)
            e_cfg, c_cfg = pair_cfgs(kv, cloud=cloud)
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


def _uneven_pool(mesh):
    """The granite-20b cloud lane's paged pool on this rank (8 slots of
    32 tokens, the default pool): the local K shape, the whole pool's and
    its ``paged_cache_specs`` entry, the stats, and the local config the
    placed blocks compute with."""
    from repro_torch.core.seq_state import Lane
    from repro_torch.launch.sharding import paged_cache_specs, place_params
    from repro_torch.models import Model, transformer
    _, cfg = pair_cfgs(cloud="granite-20b")
    p = place_params(Model(cfg).init(device="cpu"), mesh)
    lane = Lane(Model(cfg), "entropy", 0.0, layout="paged", block_size=4,
                mesh=mesh)
    st = lane.make_state(p, 8, 32)
    whole = transformer.init_paged_cache(cfg, st.pool.num_blocks, 4, 8,
                                         st.max_blocks, device="meta")
    return {"local": tuple(st.caches["k"].shape),
            "whole": tuple(whole["k"].shape),
            "spec": paged_cache_specs(whole, mesh, cfg)["k"],
            "stats": st.stats(), "gather": st.view.gather,
            "heads": (p.tp.cfg.num_heads, p.tp.cfg.num_kv_heads,
                      p.tp.attn_heads)}


def _serve_cli(*extra):
    """``serve.py --mesh data=2,model=2`` at reduced size with ``extra``
    flags: (rank 0's report, stats)."""
    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, st = serve.main(["--device", "cpu", "--reduced", "--requests",
                            "4", "--max-new", "4", "--prompt-len", "8",
                            "--mesh", "data=2,model=2", "--batch-size", "4",
                            *extra])
    return buf.getvalue(), st


def lanes_worker(rank, payload):
    """The ``LANE_DRAINS``, the per-rank dense shapes, the one-kv-head
    cloud's paged pool and ``serve.py --mesh`` on the tree lane, with
    ``--adapt distill`` and with a moe cloud, on one (data 2, model 2)
    mesh of four ranks."""
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    mesh = make_host_mesh(2, 2)
    out = {"coords": mesh.coords, "drains": lane_drains(payload, mesh),
           "shapes": _dense_shapes(mesh), "uneven_pool": _uneven_pool(mesh)}
    text, st = _serve_cli("--spec-mode", "tree", "--kv-layout", "dense")
    out["serve"] = (text, st["spec_mode"], st["mesh_shape"])
    text, st = _serve_cli("--adapt", "distill", "--adapt-interval", "2",
                          "--policy", "threshold", "--threshold", "-1",
                          "--batch-size", "2")
    out["serve_adapt"] = (text, st["adaptation"])
    text, st = _serve_cli("--cloud", "olmoe-1b-7b")
    out["serve_moe"] = (text, st["spec_mode"], st["mesh_shape"])
    out["moved"] = dict(mesh.moved)
    return out


# ---------------------------------------------------------------- training
# ``tests/test_torch_mesh_training.py``: the sharded train step on three
# meshes of the same four ranks, for a dense (smollm-135m at 9 query heads
# over 3 kv heads, whose attention then runs whole on every model rank), a
# moe (granite-moe-1b-a400m: clean head and expert splits), a vlm
# (paligemma-3b: one kv head, its K/V whole on every rank), an ssm
# (mamba2-370m: 8 SSD heads split over 'model'), an xlstm (xlstm-125m:
# every block whole on every rank), a hybrid (zamba2-2.7b: SSD heads and
# the shared block's heads split) and an encdec (whisper-small: encoder,
# decoder and cross-attention heads split) family, and a mamba2 of 6 SSD
# heads (``MAMBA6``), which split over model 2 and run whole at model 4
TRAIN_MESHES = ((2, 2), (4, 1), (1, 4))
MAMBA6 = "mamba2-370m/6-heads"
TRAIN_ARCHS = ("smollm-135m", "granite-moe-1b-a400m", "paligemma-3b",
               "mamba2-370m", "xlstm-125m", "zamba2-2.7b", "whisper-small",
               MAMBA6)
# the cases whose gathered parameters are also saved from the (2, 2) mesh
SAVED = ("smollm-135m", "zamba2-2.7b", "whisper-small")


def train_cfg(arch):
    """The reduced (float32) config a training case runs: smollm-135m at 9
    query over 3 kv heads, ``MAMBA6`` mamba2-370m at d_model 192 (di 384:
    6 SSD heads of 64)."""
    from repro_torch.configs import get_config
    c = get_config(arch.split("/")[0]).reduced()
    if arch == "smollm-135m":
        return c.replace(num_heads=9, num_kv_heads=3)
    return c.replace(d_model=192) if arch == MAMBA6 else c


def train_opt():
    """AdamW at eps 1e-3: Adam's first step divides each gradient element
    by its own magnitude, so at eps 1e-8 an element near zero whose last
    bits differ (sums taken in another order) moves its parameter by up to
    lr — 1.7e-3 apart between the unsharded port and JAX already; at 1e-3
    the update is a smooth function of the gradient."""
    from repro_torch.training.optimizer import AdamW
    return AdamW(lr=1e-2, eps=1e-3)


def _tensor_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def train_steps(params, cfg, batches, mesh=None):
    """AdamW steps of ``make_train_step`` (``mesh``: the sharded one) over
    numpy ``batches``: (params, [(loss, grad norm)])."""
    from repro_torch.models import Model
    from repro_torch.training.trainer import make_train_step
    opt = train_opt()
    st = opt.init(params, cfg)
    step = make_train_step(Model(cfg), opt, mesh=mesh, donate=False)
    hist = []
    for b in batches:
        params, st, m = step(params, st, _tensor_batch(b))
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return params, hist


def _rank0_gap(mesh, arrays):
    """max |x - rank 0's x| over a list of float32 arrays (one broadcast)."""
    flat = torch.cat([torch.from_numpy(np.ascontiguousarray(a)).reshape(-1)
                      for a in arrays])
    return float((flat - mesh.broadcast(flat)).abs().max())


def mamba_grads(params, cfg, batch, mesh):
    """The gradient the sharded step hands AdamW (``trainer.sharded_grads``)
    of layer 0's gated-norm weight and ``in_proj``, gathered whole: (norm
    (di,), in_proj (d, 2 di + 2 N + H)) float32 numpy."""
    from repro_torch.models import Model
    from repro_torch.training.trainer import sharded_grads
    _, grads = sharded_grads(Model(cfg), params, _tensor_batch(batch), mesh)
    specs = params.tp.leaf_specs(params)
    out = []
    for n in ("blocks.0.norm", "blocks.0.in_proj"):
        g = grads[n]
        for dim, ax in enumerate(specs[n]):
            if ax is not None:
                g = mesh.all_gather(g, ax, dim=dim)
        out.append(g.numpy())
    return tuple(out)


def train_worker(rank, payload):
    """Every case of ``tests/test_torch_mesh_training.py`` on four ranks:
    per mesh and arch, the two steps' losses and norms, rank 0's gathered
    parameters (the others' largest difference from them); mamba2's
    first-step gradients of its gated norm and ``in_proj`` at (2, 2) and
    (1, 4); at (2, 2) a batch that does not divide the data axes,
    ``save`` from the mesh, rank 0's counted cost of one granite-moe step
    and ``train_on_mesh`` of granite-moe and mamba2."""
    from repro_torch.bridge import params_from_numpy, params_to_numpy
    from repro_torch.launch.hlo_cost import measure
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import gather_params, place_params
    from repro_torch.models import Model
    from repro_torch.training import checkpoint
    from repro_torch.training import tree as T
    from repro_torch.training.trainer import make_train_step
    from torch.utils._pytree import tree_leaves
    torch.set_num_threads(1)
    out = {"runs": {}, "saved": {}, "grads": {}}
    for shape in TRAIN_MESHES:
        mesh = make_mesh(shape, ("data", "model"))
        for arch in TRAIN_ARCHS:
            cfg = train_cfg(arch)
            p = place_params(params_from_numpy(payload["params"][arch], cfg,
                                               "cpu"), mesh, cfg)
            if arch == "mamba2-370m" and shape != (4, 1):
                out["grads"][shape] = mamba_grads(
                    p, cfg, payload["batches"][arch][0], mesh)
            cases = [("even", payload["batches"][arch])]
            if shape == (2, 2) and arch == "smollm-135m":
                cases.append(("odd", payload["odd"]))
            for case, batches in cases:
                q, hist = train_steps(p, cfg, batches, mesh)
                full = params_to_numpy(gather_params(q), cfg)
                gap = _rank0_gap(mesh, tree_leaves(full))
                out["runs"][(shape, arch, case)] = (
                    hist, full if rank == 0 else None, gap)
                if shape == (2, 2) and arch in SAVED and \
                        case == ("odd" if arch == "smollm-135m" else "even"):
                    out["saved"][arch] = checkpoint.save(
                        payload["ckpt"][arch], q, step=2, cfg=cfg)
        if shape == (2, 2):
            cfg = train_cfg("granite-moe-1b-a400m")
            p = place_params(params_from_numpy(
                payload["params"]["granite-moe-1b-a400m"], cfg, "cpu"), mesh)
            opt = train_opt()
            step = make_train_step(Model(cfg), opt, mesh=mesh, donate=False)
            cost, _ = measure(step, p, opt.init(p, cfg), _tensor_batch(
                payload["batches"]["granite-moe-1b-a400m"][0]), mesh=mesh)
            out["cost"] = {k: cost[k] for k in ("flops", "moved", "calls")}
            out["leaf_shapes"] = [tuple(t.shape) for t in T.tensors(p)]
            out["cli"] = {arch: _train_cli(mesh, payload["cli_save"][arch],
                                           arch)
                          for arch in ("granite-moe-1b-a400m",
                                       "mamba2-370m")}
    return out


def _train_cli(mesh, save, arch):
    """``launch/train.train_on_mesh`` (the ``--mesh`` path below the
    mesh's construction) of ``arch`` at reduced size: (what this rank
    printed, the loss history, the whole and per-rank parameter
    counts)."""
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train.train_on_mesh(train.parse_args(
            ["--arch", arch, "--device", "cpu", "--reduced", "--steps", "3",
             "--batch", "4", "--seq", "16", "--save", save]), mesh)
    return (buf.getvalue(), res["history"], res["whole_params"],
            res["rank_params"])
