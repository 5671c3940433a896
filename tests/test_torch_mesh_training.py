"""Sharded training of the port (``train.py --mesh``), its dry run and its
cost counter, on the CPU.

ONE spawn of four gloo ranks (``tests/torch_mesh_workers.py::
train_worker``) runs the sharded train step at (data 2, model 2), (4, 1)
and (1, 4) on ``.reduced()`` float32 configs of every family whose
parameters are bridged from the JAX package's init: smollm-135m at 9
query heads over 3 kv heads (its attention whole on every model rank,
FSDP only), granite-moe-1b-a400m (heads, d_ff and experts split over
'model'), paligemma-3b (one kv head: queries split, K/V whole; the image
prefix), mamba2-370m (its 8 SSD heads split over 'model'; ``in_proj``
gathered whole over model 2 and whole on every rank at model 4, where its
width does not divide), xlstm-125m (every block whole on every rank),
zamba2-2.7b (SSD heads and the unstacked shared block's heads and d_ff
split), whisper-small (encoder, decoder and cross-attention heads split;
the audio frames' rows over the data axes) and a mamba2 of 6 SSD heads
(split at model 2, whole at model 4).  Two AdamW steps on global batches
of 8 rows (and, at (2, 2), of 3 rows, which do not divide the data axes)
must give every rank the unsharded port's and JAX's unsharded step's
losses, grad norms and parameters (gathered whole) within the tolerances
of ``tests/test_torch_training.py``: losses 1e-5, the grad norm 1e-6
relative, AdamW steps 1e-6 (AdamW at eps 1e-3,
``torch_mesh_workers.train_opt`` says why); every rank's gathered
parameters equal rank 0's.  mamba2's first gradient of its gated norm
and of ``in_proj``'s B and C columns through the SSD-head split equals
the unsharded port's.  ``save`` from the mesh writes the unsharded
``save``'s file (a dense, a hybrid and an encdec model), and the
shape-only mesh's per-rank flops and collective bytes equal what rank 0
counted.

Without a spawn: ``hlo_cost.cost_of``'s flops against JAX's
``analyze_hlo`` (exact), a production-mesh ``dryrun.run_one`` record and
the error a leaf without a gradient raises
(``tests/test_torch_mesh_dryrun.py`` dry-runs the other families).
"""
from __future__ import annotations

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_mesh_workers as W  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch.hlo_cost import analyze_hlo  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.training.optimizer import AdamW as JAdamW  # noqa: E402
from repro.training.trainer import make_train_step as jstep  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.hlo_cost import cost_of, measure  # noqa: E402
from repro_torch.launch.mesh import ShapeMesh, spawn_ranks  # noqa: E402
from repro_torch.launch.sharding import init_placed  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.training import checkpoint as tck  # noqa: E402
from repro_torch.training import tree as T  # noqa: E402
from repro_torch.training.trainer import make_train_step  # noqa: E402

LOSS_TOL, NORM_RTOL, PARAM_TOL = 1e-5, 1e-6, 1e-6
# against JAX, xLSTM is held where the unsharded port meets JAX: its
# exponential gates carry rounding differences of the two stacks to 6.7e-6
# of the grad norm and 2.7e-5 of a parameter after two steps
# (``tests/test_torch_training.py`` holds its gradients at rtol 1e-4, atol
# 1e-5); against the unsharded port every case is held at the tolerances
# above
JAX_TOLS = {"xlstm-125m": (LOSS_TOL, 1e-5, 1e-4)}
CASES = [(shape, arch) for shape in W.TRAIN_MESHES for arch in W.TRAIN_ARCHS]
# the JAX record's keys (``src/repro/launch/dryrun.py::run_one``)
JAX_RECORD = {"arch", "shape", "mesh", "step", "status", "devices",
              "lower_s", "compile_s", "flops_per_device", "bytes_per_device",
              "hlo_cost", "memory", "collectives"}


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


def _jcfg(arch):
    """``torch_mesh_workers.train_cfg``'s config in the JAX package."""
    c = jget(arch.split("/")[0]).reduced()
    if arch == "smollm-135m":
        return c.replace(num_heads=9, num_kv_heads=3)
    return c.replace(d_model=192) if arch == W.MAMBA6 else c


def _batches(cfg, B, n=2, seed=0):
    """``n`` global batches of ``B`` rows: 16 positions (the vlm's 4 image
    rows and 12 tokens; the encdec's 16 tokens beside its 16 frames), some
    labels ignored."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = 16 - cfg.num_image_tokens if cfg.family == "vlm" else 16
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, s)).astype(
                 np.int32)}
        b["labels"][0, :3] = -1
        if cfg.family == "vlm":
            b["embeds"] = rng.standard_normal(
                (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            b["frames"] = rng.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _jax_steps(arch, params, batches):
    jcfg = _jcfg(arch)
    opt = JAdamW(lr=W.train_opt().lr, eps=W.train_opt().eps)
    step = jstep(JModel(jcfg), opt, donate=False)
    st = opt.init(params)
    hist = []
    for b in batches:
        params, st, m = step(params, st, {k: jnp.asarray(v)
                                          for k, v in b.items()})
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return _host(params), hist


def _close(a_tree, b_tree, tol, what):
    fa, ta = jax.tree_util.tree_flatten_with_path(a_tree)
    fb, tb = jax.tree_util.tree_flatten_with_path(b_tree)
    assert ta == tb
    for (path, a), (_, b) in zip(fa, fb):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                   err_msg=f"{what} {path}")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Spawn the four ranks in a thread and, meanwhile, run JAX's and the
    unsharded port's steps here on the same parameters and batches."""
    torch.set_num_threads(1)
    params, batches, refs = {}, {}, {}
    for i, arch in enumerate(W.TRAIN_ARCHS):
        jcfg = _jcfg(arch)
        params[arch] = _host(JModel(jcfg).init(jax.random.PRNGKey(10 + i)))
        batches[arch] = _batches(jcfg, 8, seed=i)
    odd = _batches(_jcfg("smollm-135m"), 3, seed=9)
    tmp = tmp_path_factory.mktemp("mesh_train")
    payload = {"params": params, "batches": batches, "odd": odd,
               "ckpt": {a: str(tmp / f"mesh_{a}.npz") for a in W.SAVED},
               "cli_save": {a: str(tmp / f"cli_{a}.npz") for a in
                            ("granite-moe-1b-a400m", "mamba2-370m")}}
    box = {}

    def spawn():
        try:
            box["ranks"] = spawn_ranks(W.train_worker, 4, payload,
                                       store=str(tmp / "store"), timeout=300)
        except Exception as e:   # noqa: BLE001 — re-raised below
            box["error"] = e

    th = threading.Thread(target=spawn)
    th.start()
    for arch in W.TRAIN_ARCHS:
        cases = [("even", batches[arch])] + \
            ([("odd", odd)] if arch == "smollm-135m" else [])
        for case, bs in cases:
            jp, jh = _jax_steps(arch, jax.tree.map(jnp.asarray,
                                                   params[arch]), bs)
            cfg = W.train_cfg(arch)
            tp, th_ = W.train_steps(params_from_numpy(params[arch], cfg,
                                                      "cpu"), cfg, bs)
            refs[(arch, case)] = {"jax": (jp, jh),
                                  "port": (params_to_numpy(tp, cfg), th_)}
    refs["grads"] = _mamba_grads(params["mamba2-370m"],
                                 batches["mamba2-370m"][0])
    th.join()
    if "error" in box:
        raise box["error"]
    return {"ranks": box["ranks"], "refs": refs, "payload": payload,
            "tmp": tmp}


def _mamba_grads(params, batch):
    """Layer 0's gated-norm and ``in_proj`` gradients of the unsharded
    port's loss: (norm, in_proj) (``tests/test_torch_training.py`` holds
    the unsharded port's gradients against ``jax.grad``)."""
    cfg = W.train_cfg("mamba2-370m")
    p = params_from_numpy(params, cfg, "cpu")
    leaves = [t.detach().requires_grad_(True) for t in T.tensors(p)]
    tp_ = T.replace(p, leaves)
    loss = TModel(cfg).loss(tp_, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    g = dict(zip([n for n, _ in T.leaves(p)],
                 torch.autograd.grad(loss, leaves)))
    return g["blocks.0.norm"].numpy(), g["blocks.0.in_proj"].numpy()


def _check_run(trained, shape, arch, case):
    refs = trained["refs"][(arch, case)]
    tols = {"port": (LOSS_TOL, NORM_RTOL, PARAM_TOL),
            "jax": JAX_TOLS.get(arch, (LOSS_TOL, NORM_RTOL, PARAM_TOL))}
    for r, out in enumerate(trained["ranks"]):
        hist, full, gap = out["runs"][(shape, arch, case)]
        assert gap == 0.0, f"rank {r}'s gathered params differ from rank 0's"
        for who, (lt, nt, _) in tols.items():
            for (loss, norm), (rl, rn) in zip(hist, refs[who][1]):
                assert abs(loss - rl) <= lt, (who, loss, rl)
                assert abs(norm - rn) <= nt * rn, (who, norm, rn)
    full = trained["ranks"][0]["runs"][(shape, arch, case)][1]
    _close(full, refs["port"][0], tols["port"][2], "vs the unsharded port")
    _close(full, refs["jax"][0], tols["jax"][2], "vs JAX")


@pytest.mark.parametrize("shape,arch", CASES,
                         ids=[f"{s[0]}x{s[1]}-{a}" for s, a in CASES])
def test_sharded_step_matches_unsharded_port_and_jax(trained, shape, arch):
    _check_run(trained, shape, arch, "even")


def test_batch_that_does_not_divide_the_data_axes(trained):
    """3 rows over 2 data ranks: every data rank holds all of them, and the
    step still counts each row once."""
    _check_run(trained, (2, 2), "smollm-135m", "odd")


def test_save_from_the_mesh_writes_the_unsharded_file(trained):
    """Rank 0's gathered parameters saved by the unsharded ``save`` give
    the file ``save`` wrote from the mesh, key for key."""
    _check_saved(trained, "smollm-135m", "odd")


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "whisper-small"])
def test_save_from_the_mesh_of_a_hybrid_and_an_encdec(trained, arch):
    """As above for zamba2's unstacked shared block beside its (G, K)
    mamba stack, and whisper's encoder, decoder and top-level leaves."""
    _check_saved(trained, arch, "even")


def _check_saved(trained, arch, case):
    full = trained["ranks"][0]["runs"][((2, 2), arch, case)][1]
    cfg = W.train_cfg(arch)
    ref = trained["tmp"] / f"unsharded_{arch}.npz"
    tck.save(str(ref), params_from_numpy(full, cfg, "cpu"), step=2, cfg=cfg)
    a, b = np.load(trained["payload"]["ckpt"][arch]), np.load(ref)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert all(out["saved"][arch] is None for out in trained["ranks"])


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_mamba2_grads_through_the_ssd_head_split(trained, shape):
    """mamba2-370m's 8 SSD heads on 2 or 4 model ranks: the first step's
    gradient (before AdamW, summed over the mesh as the step sums it) of
    layer 0's gated-norm weight, whose sum of squares spans every rank's
    heads, and of ``in_proj`` — its B and C columns, which every model
    rank computes with, and the per-head z, x and dt columns — gathered
    whole, equals the unsharded port's."""
    cfg = W.train_cfg("mamba2-370m")
    di, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    bc = slice(2 * di, 2 * di + 2 * N)
    rn, rp = trained["refs"]["grads"]
    scale = max(1.0, float(np.abs(rp).max()))
    for r, out in enumerate(trained["ranks"]):
        norm, proj = out["grads"][shape]
        np.testing.assert_allclose(norm, rn, rtol=1e-5, atol=1e-6,
                                   err_msg=f"norm, rank {r}")
        np.testing.assert_allclose(proj[:, bc], rp[:, bc], rtol=1e-5,
                                   atol=1e-6 * scale,
                                   err_msg=f"in_proj B/C, rank {r}")
        np.testing.assert_allclose(proj, rp, rtol=1e-5, atol=1e-6 * scale,
                                   err_msg=f"in_proj, rank {r}")


def test_shape_mesh_counts_what_rank_0_counted(trained):
    """The dry run's stand-in: the same granite-moe step on a ``ShapeMesh``
    at rank 0's coordinates, on the meta device, counts rank 0's flops
    and each collective's bytes and calls."""
    real = trained["ranks"][0]["cost"]
    cfg = W.train_cfg("granite-moe-1b-a400m")
    mesh = ShapeMesh((2, 2), ("data", "model"), rank=0)
    p = init_placed(TModel(cfg), 0, mesh, "meta")
    assert [tuple(t.shape) for t in T.tensors(p)] == \
        trained["ranks"][0]["leaf_shapes"]
    b = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                        device="meta")
         for k, v in trained["payload"]["batches"][
             "granite-moe-1b-a400m"][0].items()}
    opt = W.train_opt()
    step = make_train_step(TModel(cfg), opt, mesh=mesh, donate=False)
    cost, _ = measure(step, p, opt.init(p, cfg), b, mesh=mesh)
    assert cost["flops"] == real["flops"] > 0
    assert cost["moved"] == real["moved"]
    assert cost["calls"] == real["calls"]
    assert {k.split("/")[0] for k in real["moved"]} >= {
        "all_gather", "reduce_scatter", "all_reduce"}


def test_train_on_mesh_trains_and_only_rank_0_speaks(trained):
    """``train.py --mesh``'s body on the (2, 2) host mesh: the loss falls,
    every rank logs the same history, only rank 0 prints, the parameter
    counts add up, and ``--save`` writes a checkpoint the unsharded
    ``restore`` reads."""
    cfg = _check_cli(trained, "granite-moe-1b-a400m")
    back, step = tck.restore(trained["payload"]["cli_save"][
        "granite-moe-1b-a400m"], TModel(cfg).init(device="cpu"))
    assert step == 3 and back.embed.shape == (cfg.vocab_size, cfg.d_model)


def test_train_on_mesh_trains_a_recurrent_family(trained):
    """The same for mamba2-370m, its SSD heads split over 'model': the
    loss falls, one history, rank 0 alone prints, and the checkpoint
    restores into the unsharded model's parameters."""
    cfg = _check_cli(trained, "mamba2-370m")
    back, step = tck.restore(trained["payload"]["cli_save"]["mamba2-370m"],
                             TModel(cfg).init(device="cpu"), cfg=cfg)
    di = cfg.ssm_expand * cfg.d_model
    assert step == 3 and back.blocks[1].in_proj.shape == (
        cfg.d_model, 2 * di + 2 * cfg.ssm_state + di // cfg.ssm_head_dim)


def _check_cli(trained, arch):
    outs = [r["cli"][arch] for r in trained["ranks"]]
    text, hist, whole, mine = outs[0]
    assert "steps in" in text and "mesh {'data': 2, 'model': 2}" in text
    assert all(o[0] == "" for o in outs[1:])
    assert all(o[1] == hist for o in outs) and hist[-1][1] < hist[0][1]
    cfg = tget(arch).reduced()
    assert whole == sum(p.numel() for p in
                        TModel(cfg).init(device="cpu").parameters())
    assert whole / 4 <= mine < whole
    return cfg


# ------------------------------------------------------------ no spawn
@pytest.mark.parametrize("arch,remat", [("smollm-135m", False),
                                        ("smollm-135m", True),
                                        ("granite-moe-1b-a400m", False)])
def test_cost_of_flops_equal_analyze_hlo(arch, remat):
    """The port's loss + gradient counted by ``cost_of`` against JAX's
    ``value_and_grad`` of the loss compiled on the CPU and read by
    ``analyze_hlo`` (batch 2, 64 tokens): the same flops, exactly."""
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    b = _batches(jcfg, 2, 1)[0]
    b = {k: np.concatenate([v, v, v, v], axis=1)[:, :64] for k, v in
         b.items()}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    hlo = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, remat=remat))).lower(jp).compile() \
        .as_text()
    tm = TModel(tcfg)
    tp = params_from_numpy(_host(jp), tcfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in b.items()}

    def step():
        p = T.replace(tp, [t.detach().requires_grad_(True)
                           for t in T.tensors(tp)])
        return torch.autograd.grad(tm.loss(p, tb, remat=remat),
                                   T.tensors(p))

    mine = cost_of(step)
    assert mine["flops"] == analyze_hlo(hlo)["flops"] > 0
    assert mine["bytes"] > 0 and mine["collective_bytes"] == 0


def test_dryrun_record_has_jax_keys(tmp_path):
    """smollm-135m x train_4k on rank 0 of the 256-rank single-pod mesh,
    on the meta device: a record with the JAX record's keys under
    ``tmp_path``, what a rank holds and moves."""
    rec = dryrun.run_one("smollm-135m", "train_4k", "single", verbose=False,
                         results_dir=str(tmp_path))
    disk = json.loads((tmp_path / "smollm-135m_train_4k_single.json")
                      .read_text())
    assert set(rec) == set(disk) == JAX_RECORD
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert rec["step"] == "train_step" and rec["flops_per_device"] > 0
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "generated_code_bytes"}
    assert rec["memory"]["generated_code_bytes"] is None
    assert rec["memory"]["temp_bytes"] > rec["memory"]["argument_bytes"] > 0
    coll = rec["collectives"]
    assert coll["count"] > 0 and coll["all-gather"] > 0
    assert coll["reduce-scatter"] > 0 and coll["all-reduce"] > 0
    assert rec["hlo_cost"]["collective_bytes"] == sum(
        v for k, v in coll.items() if k != "count")


def test_a_leaf_without_a_gradient_raises(monkeypatch):
    """Were the FSDP gather not differentiable, its leaves would get no
    gradient: on a mesh the step raises instead of stepping zeros."""
    cfg = W.train_cfg("smollm-135m")
    mesh = ShapeMesh((2, 2), ("data", "model"), rank=0)
    p = init_placed(TModel(cfg), 0, mesh, "meta")
    real = ShapeMesh.all_gather

    def fsdp_cut(self, x, axes, dim=0, grad="local"):
        if grad == "sum":                   # the FSDP weight gathers
            return self._gather(x.detach(), axes, dim)
        return real(self, x, axes, dim, grad=grad)

    monkeypatch.setattr(ShapeMesh, "all_gather", fsdp_cut)
    b = {k: torch.empty((4, 16), dtype=torch.int32, device="meta")
         for k in ("tokens", "labels")}
    opt = W.train_opt()
    step = make_train_step(TModel(cfg), opt, mesh=mesh, donate=False)
    with pytest.raises(RuntimeError, match="no gradient reached"):
        step(p, opt.init(p, cfg), b)
