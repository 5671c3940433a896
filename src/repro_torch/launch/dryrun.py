"""Production-mesh dry run on the meta device: the twin of the JAX
package's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

JAX lowers and compiles every (architecture x input shape) for the
256- and 512-chip production meshes on 512 fake host devices.  The port
runs one process per rank and has no partitioner, so it runs ONE rank's
step: the parameters drawn on the meta device and cut to rank 0's blocks
(``sharding.init_placed``), the step's collectives on a ``ShapeMesh`` at
rank 0's coordinates (``launch/mesh.py``), which returns meta tensors of
the shapes the real ones would give and counts their bytes.  No tensor
is allocated and no card, process group or JAX is needed.

Per run it records what one rank computes, holds and moves, with the JAX
record's keys (written to ``experiments/dryrun_torch/*.json``, or
``REPRO_TORCH_DRYRUN_DIR``; never to the JAX package's
``experiments/dryrun/``):

* ``flops_per_device`` / ``bytes_per_device`` and ``hlo_cost``:
  ``launch/hlo_cost.py`` over the step (flops exact; bytes an unfused
  upper bound);
* ``memory``: ``argument_bytes`` the rank's parameters, AdamW moments and
  batch rows (a serve step: its token rows and cache), ``output_bytes``
  the step's results, ``temp_bytes`` the saved-for-backward bytes of a
  train step's forward (``None`` for prefill and serve steps, which keep
  nothing for a backward), ``generated_code_bytes`` ``None`` (eager
  PyTorch generates no code);
* ``collectives``: bytes per JAX op name and ``count``, the collective
  calls;
* ``lower_s``: seconds to build the rank's inputs, ``compile_s``: seconds
  to run the step on the meta device.

The train step is ``training/trainer.make_train_step(mesh=...)`` with
remat, prefill ``Model.prefill`` and serve ``Model.decode_step`` on the
rank's rows (a dense cache whose kv heads do not split over 'model' is
cut on the head dim by ``cache_spec`` and all-gathered over 'model'
before the step).  Every family trains on the mesh; the prefill and
serve steps of the families whose cache has no placement in the port
(ssm, xlstm, hybrid, encdec: a placed recurrent or encoder-decoder model
serving on a mesh) are recorded ``skipped`` (ROADMAP A.8f), as is JAX's
one ``SKIPS`` entry.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Dict

import torch

from repro_torch.configs import LONG_DECODE_WINDOW, SHAPES, get_config, \
    list_archs
from repro_torch.configs.base import stub_input
from repro_torch.launch.hlo_cost import measure
from repro_torch.launch.mesh import make_shape_mesh
from repro_torch.launch.sharding import data_rows

RESULTS_DIR = os.environ.get(
    "REPRO_TORCH_DRYRUN_DIR",
    os.path.join(os.path.dirname(__file__), "..", "..", "..",
                 "experiments", "dryrun_torch"))

# (arch, shape) pairs skipped by design, as in the JAX package
SKIPS = {
    ("whisper-small", "long_500k"):
        "encoder-decoder with full cross-attention; no 512k decode use-case "
        "and no sliding-window variant implemented (DESIGN.md)",
}
# families whose prefill and serve steps run on a mesh (every family's
# train step does)
SERVE_FAMILIES = ("dense", "moe", "vlm")


def decode_window(cfg, shape_name: str) -> int:
    if shape_name == "long_500k" and cfg.family in ("dense", "moe", "vlm",
                                                    "hybrid"):
        return LONG_DECODE_WINDOW
    return 0


def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(t.nbytes for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def input_specs(arch: str, shape_name: str, mesh) -> Dict:
    """Meta stand-ins for every input of the rank's step: its placed
    parameters, and the global batch (train, prefill) or the rank's token
    rows and cache (serve)."""
    from repro_torch.launch.sharding import cache_specs, init_placed
    from repro_torch.models import Model
    from repro_torch.runtime import local_slice
    from repro_torch.training.optimizer import AdamW
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    model = Model(cfg)
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    f = getattr(torch, cfg.activ_dtype)
    params = init_placed(model, 0, mesh, meta)
    out = {"cfg": cfg, "model": model, "params": params, "kind": shape.kind}
    if shape.kind in ("train", "prefill"):
        s_text = S - cfg.num_image_tokens if cfg.family == "vlm" else S
        batch = {"tokens": torch.empty((B, s_text), dtype=torch.int32,
                                       device=meta)}
        if shape.kind == "train":
            batch["labels"] = torch.empty((B, s_text), dtype=torch.int32,
                                          device=meta)
            out["opt"] = AdamW()
            out["opt_state"] = out["opt"].init(params, cfg)
        key, rows = stub_input(cfg)
        if key is not None:            # vlm embeds, encdec frames
            batch[key] = torch.empty((B, rows, cfg.d_model), dtype=f,
                                     device=meta)
        out["batch"] = batch
    else:
        from repro_torch.launch.sharding import batch_spec
        whole = model.init_cache(B, S, device=meta)
        specs = cache_specs(whole, mesh, cfg, B)
        out["cache_specs"] = specs
        out["cache"] = {k: local_slice(v, specs[k], mesh)
                        for k, v in whole.items()}
        tok = torch.empty((B, 1), dtype=torch.int32, device=meta)
        out["token"] = local_slice(tok, batch_spec(tuple(tok.shape), mesh),
                                   mesh)
    return out


def build_step(spec: Dict, shape_name: str, mesh):
    """(the rank's step as a function of the spec's inputs, its name)."""
    from repro_torch.training.trainer import make_train_step
    model, cfg = spec["model"], spec["cfg"]
    if spec["kind"] == "train":
        step = make_train_step(model, spec["opt"], remat=True, mesh=mesh)
        return step, "train_step"
    if spec["kind"] == "prefill":
        S = SHAPES[shape_name].seq_len

        def prefill(params, batch):
            return model.prefill(params, data_rows(batch, mesh).local(batch),
                                 max_seq=S)
        return prefill, "prefill_step"
    window = decode_window(cfg, shape_name)
    local_kv = spec["params"].tp.cfg.num_kv_heads

    def serve(params, token, cache):
        cache = dict(cache)
        for k in ("k", "v"):
            kv_split = cache[k].shape[3] == local_kv
            for dim, ax in enumerate(spec["cache_specs"][k]):
                if ax == "model" and not (dim == 3 and kv_split):
                    cache[k] = mesh.all_gather(cache[k], "model", dim=dim)
        return model.decode_step(params, token, cache, window=window)
    return serve, "serve_step"


def run_one(arch: str, shape_name: str, mesh_kind: str,
            verbose: bool = True, results_dir: str = None) -> Dict:
    """Dry-run one (arch, shape, mesh) on rank 0 of the production mesh and
    write its record (module docstring)."""
    results_dir = results_dir or RESULTS_DIR
    cfg = get_config(arch)
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    reason = SKIPS.get((arch, shape_name))
    if reason is None and SHAPES[shape_name].kind != "train" and \
            cfg.family not in SERVE_FAMILIES:
        reason = (f"family {cfg.family!r} trains on a mesh but its cache "
                  "has no placement in the port, so a placed model does "
                  "not serve: ROADMAP A.8f")
    if reason is not None:
        rec = {**base, "status": "skipped", "reason": reason}
        _write(rec, results_dir)
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: skipped "
                  f"({reason})", flush=True)
        return rec
    mesh = make_shape_mesh(multi_pod=mesh_kind == "multi")
    t0 = time.time()
    spec = input_specs(arch, shape_name, mesh)
    step, step_name = build_step(spec, shape_name, mesh)
    if spec["kind"] == "train":
        b = spec["batch"]
        args = (spec["params"], spec["opt_state"], b)
        arg_bytes = (_nbytes(list(spec["params"].parameters()))
                     + _nbytes((spec["opt_state"].m, spec["opt_state"].v))
                     + _nbytes(data_rows(b, mesh).local(b)))
    elif spec["kind"] == "prefill":
        b = spec["batch"]
        args = (spec["params"], b)
        arg_bytes = (_nbytes(list(spec["params"].parameters()))
                     + _nbytes(data_rows(b, mesh).local(b)))
    else:
        args = (spec["params"], spec["token"], spec["cache"])
        arg_bytes = (_nbytes(list(spec["params"].parameters()))
                     + _nbytes((spec["token"], spec["cache"])))
    t_lower = time.time() - t0
    with torch.no_grad() if spec["kind"] != "train" else \
            contextlib.nullcontext():
        cost, out = measure(step, *args, mesh=mesh)
    t_compile = time.time() - t0 - t_lower
    if spec["kind"] == "train":
        params, state, metrics = out
        out_bytes = _nbytes(list(params.parameters())) + \
            _nbytes((state.m, state.v, metrics))
    else:
        out_bytes = _nbytes(out)
    coll = {k[len("coll_"):]: v for k, v in cost.items()
            if k.startswith("coll_")}
    coll["count"] = sum(cost["calls"].values())
    hc = {k: cost[k] for k in cost if k == "flops" or k == "bytes"
          or k == "collective_bytes" or k.startswith("coll_")}
    rec = {
        **base, "step": step_name, "status": "ok",
        "devices": int(mesh.size),
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "flops_per_device": cost["flops"],
        "bytes_per_device": cost["bytes"],
        "hlo_cost": hc,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": cost["saved_bytes"] if spec["kind"] == "train"
            else None,
            "generated_code_bytes": None,
        },
        "collectives": coll,
    }
    _write(rec, results_dir)
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: OK "
              f"(build {t_lower:.1f}s run {t_compile:.1f}s, "
              f"{rec['flops_per_device']:.4g} flops/dev, "
              f"{rec['bytes_per_device']:.4g} B/dev, coll "
              f"{cost['collective_bytes']:.4g} B/dev in {coll['count']} "
              f"calls)", flush=True)
    return rec


def _write(rec: Dict, results_dir: str):
    os.makedirs(results_dir, exist_ok=True)
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json"
    with open(os.path.join(results_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch in archs:
        for shape_name in shapes:
            for mk in meshes:
                out = os.path.join(RESULTS_DIR,
                                   f"{arch}_{shape_name}_{mk}.json")
                if args.skip_existing and os.path.exists(out):
                    print(f"[dryrun] skip existing {arch} {shape_name} {mk}")
                    continue
                try:
                    run_one(arch, shape_name, mk)
                except Exception as e:  # noqa: BLE001 — report, keep sweeping
                    failures.append((arch, shape_name, mk, repr(e)[:300]))
                    print(f"[dryrun] FAIL {arch} x {shape_name} x {mk}: "
                          f"{repr(e)[:300]}")
                    _write({"arch": arch, "shape": shape_name, "mesh": mk,
                            "status": "fail", "error": repr(e)[:1000]},
                           RESULTS_DIR)
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL DRY-RUNS OK")


if __name__ == "__main__":
    main()
