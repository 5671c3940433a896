#!/usr/bin/env python3
"""The SSD-scan backward's bf16 routes in training, side by side on one
card: does the tensor-core route move a trainer's gradients, or its loss,
more than another bf16 implementation of the same step does?

    PYTHONPATH=src python3 scripts/ssd_bwd_routes.py \
        [--arch zamba2-2.7b,mamba2-370m] [--steps 10]

For each arch (full config unless ``--reduced``, bfloat16, batch 8, seq
256, seed 0, the ``SyntheticLM`` batches and the AdamW schedule of
``launch/train.py``), three routes of the training step:

* ``mma``: the scan's backward on ``ssd_bwd_plan``'s route, the tensor
  cores;
* ``cuda_cores``: the plan forced onto the CUDA-core kernel, in bf16 (the
  kernel the trainers ran before the tensor-core route);
* ``plain``: ``attn_backend="plain"``, autograd of the plain scan (float32
  inside) and of the plain attention, with remat (the same bits as without;
  it keeps the plain scan's graph within the card's memory).

First one step's gradients on each route: per group of leaves (the leaf's
name without its layer index, e.g. ``mamba.A_log``) and pair of routes
(a, b): ``rel`` = ||a - b|| / ||b||, ``ratio`` = ||a|| / ||b||, ``proj``
= <a - b, b> / ||b||^2 (a steady bias along the gradient shows here) and
``signs``, the share of elements whose sign differs (AdamW's first update
is lr * sign(g)).  Then ``--steps`` trainer steps on each route from the
same seeds, the ``mma`` route twice, with the loss of every step (taken
before its update, as ``train`` logs it).

Prints one JSON line per arch; ``--out DIR`` also writes the per-leaf
table to ``DIR/ssd_bwd_routes_<arch>.json``.  ``--device cpu`` runs the same code
on the CPU, where every route is the plain scan (a check of the script).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ROUTES = ("mma", "cuda_cores", "plain")
PAIRS = (("mma", "cuda_cores"), ("mma", "plain"), ("cuda_cores", "plain"))


@contextlib.contextmanager
def scan_route(route):
    """Pin the scan backward's route: ``cuda_cores`` replaces the plan
    with the CUDA-core kernel's (its float32 plan, launched in bf16)."""
    import torch
    from repro_torch.kernels import ssd_scan as K
    if route != "cuda_cores":
        yield
        return
    plan = K.ssd_bwd_plan
    K.ssd_bwd_plan = lambda dtype, N, P, Q: plan(torch.float32, N, P, Q)
    try:
        yield
    finally:
        K.ssd_bwd_plan = plan


def loss_fn(model, route):
    plain = route == "plain"
    return lambda p, b: model.loss(p, b, remat=plain,
                                   attn_backend="plain" if plain else "auto")


def check_launches(route, dev):
    """The scan backward ran on ``route`` and nowhere else."""
    from repro_torch.kernels import ops
    c = ops.launch_counts()
    if dev.type != "cuda":
        return c
    n = c["ssd_chunk_scan_bwd"]
    want = 0 if route == "plain" else n
    ok = n > 0 if route != "plain" else n == 0
    if not ok or c.get(f"ssd_chunk_scan_bwd/{route}", 0) != want:
        raise SystemExit(f"route {route}: scan backward launches {c}")
    return c


def step_grads(model, params, batch, route, dev):
    """(loss, gradients) of one step on ``route``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.training import tree as T
    train_p = T.replace(params, [t.detach().requires_grad_(True)
                                 for t in T.tensors(params)])
    leaves = T.tensors(train_p)
    ops.reset_launch_counts()
    with scan_route(route), torch.enable_grad():
        loss = loss_fn(model, route)(train_p, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    check_launches(route, dev)
    return float(loss.detach()), [
        torch.zeros_like(t) if g is None else g.detach()
        for g, t in zip(grads, leaves)]


def group_of(name):
    return re.sub(r"\.\d+(?=\.|$)", "", name)


def compare(names, grads):
    """Per group and pair: rel, ratio, proj, signs (see the docstring);
    and per leaf the pairs' rel."""
    sums, per_leaf = {}, []
    for i, name in enumerate(names):
        g = {r: grads[r][i].float() for r in ROUTES}
        grp = sums.setdefault(group_of(name), {})
        row = {"leaf": name, "numel": g["mma"].numel()}
        for a, b in PAIRS:
            x, y = g[a], g[b]
            s = grp.setdefault(f"{a}-{b}", [0.0] * 6)
            d = x - y
            both = (x != 0) & (y != 0)
            parts = (float((d * d).sum()), float((y * y).sum()),
                     float((x * x).sum()), float((d * y).sum()),
                     float((both & (x.sign() != y.sign())).sum()),
                     float(both.sum()))
            for k, v in enumerate(parts):
                s[k] += v
            row[f"{a}-{b}"] = (parts[0] / parts[1]) ** 0.5 if parts[1] \
                else 0.0
        per_leaf.append(row)
    out = {}
    for grp, pairs in sums.items():
        out[grp] = {}
        for pair, (dd, yy, xx, dy, flips, n) in pairs.items():
            out[grp][pair] = {
                "rel": (dd / yy) ** 0.5 if yy else 0.0,
                "ratio": (xx / yy) ** 0.5 if yy else 0.0,
                "proj": dy / yy if yy else 0.0,
                "signs": flips / n if n else 0.0}
    return out, per_leaf


def trajectory(model, cfg, route, steps, dev):
    """The loss of each of ``steps`` trainer steps on ``route``."""
    import torch
    from repro_torch.data import batches
    from repro_torch.kernels import ops
    from repro_torch.training import AdamW, cosine_schedule, train
    params = model.init(seed=0, device=dev)
    opt = AdamW(lr=3e-4, schedule=cosine_schedule(steps // 10, steps))
    ops.reset_launch_counts()
    with scan_route(route):
        res = train(model, params, batches(cfg, 8, 256, device=dev),
                    steps=steps, opt=opt, loss_fn=loss_fn(model, route),
                    log_every=1, donate=True, log=lambda *_: None)
    check_launches(route, dev)
    del params, res["params"], res["opt_state"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return [loss for _, loss in res["history"]]


def run_arch(arch, steps, dev, reduced, out):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import batches
    from repro_torch.models import Model
    from repro_torch.training import tree as T
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(param_dtype="bfloat16", activ_dtype="bfloat16")
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    batch = next(batches(cfg, 8, 256, device=dev))
    names = [n for n, _ in T.leaves(params)]
    losses, grads = {}, {}
    for route in ROUTES:
        losses[route], grads[route] = step_grads(model, params, batch, route,
                                                 dev)
    norms = {r: float(sum(float(g.float().pow(2).sum()) for g in gs)) ** 0.5
             for r, gs in grads.items()}
    groups, per_leaf = compare(names, grads)
    del grads, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    traj = {}
    for label, route in (("mma", "mma"), ("mma again", "mma"),
                         ("cuda_cores", "cuda_cores"), ("plain", "plain")):
        traj[label] = trajectory(model, cfg, route, steps, dev)
    if out:
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / f"ssd_bwd_routes_{arch}.json").write_text(
            json.dumps({"arch": arch, "per_leaf": per_leaf}, indent=1))
    return {"arch": arch, "reduced": reduced, "device": str(dev),
            "step0_loss": losses, "step0_grad_norm": norms,
            "groups": groups, "losses": traj}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b,mamba2-370m")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--out", default=None,
                    help="directory for the per-leaf tables")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card (or --device cpu)")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        print(f"card: {card}", flush=True)
    for arch in args.arch.split(","):
        print(json.dumps(run_arch(arch, args.steps, dev, args.reduced,
                                  args.out)), flush=True)


if __name__ == "__main__":
    main()
