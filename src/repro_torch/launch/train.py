"""Training launcher (PyTorch port): the port of the JAX package's
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 100 --batch 8 --seq 128

Seeded random init (seed 0), AdamW with a cosine schedule (warm-up a tenth
of the steps) on the ``SyntheticLM`` stream of ``data/pipeline.batches``.
``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` trains on the CPU (``--reduced`` keeps that small).  ``--arch`` takes
every family the port has (dense, moe, vlm, ssm, xlstm, hybrid, encdec;
vlm batches carry the stub image ``embeds`` and take ``--seq`` rows in
all, encdec batches the stub audio ``frames``).  On CUDA the attention
runs the flash kernel forward and backward (prefix-LM for vlm, non-causal
over the encoder and the cross-attention for encdec), and the recurrent
families' chunked scan the SSD-scan kernel forward and backward.
``--remat`` recomputes each block in the backward (each group for the
hybrid), every family.  The step updates the parameters and the AdamW
moments in place (the port's buffer donation, ``train(donate=True)``), so
one copy of each lives on the card.
``--save PATH`` writes the trained params in the JAX layout.

``--mesh single|multi`` trains on ``make_production_mesh`` over the world's
ranks, one process per rank under ``torchrun`` (16 x 16 = 256 or 2 x 16 x
16 = 512 ranks; another world size raises ``Mesh``'s message):

    torchrun --nproc-per-node 4 ... -m repro_torch.launch.train \
        --arch granite-8b --mesh single

Each rank draws only its blocks (``sharding.init_placed``) and steps them
(``training/trainer.py``, ``mesh=``); every rank reads the same seeded
global batches (with the vlm ``embeds`` and the encdec ``frames``) and
takes its rows.  Every family trains on a mesh: the decoders' attention
and MLP, zamba2's shared block and whisper's encoder, decoder and
cross-attention split over 'model' by heads and d_ff, the mamba2 layers
(mamba2, zamba2) by SSD heads, xLSTM's blocks whole on every rank.  Only
rank 0 prints and writes ``--save``.  ``train_on_mesh`` is everything below the mesh's
construction, so tests and ``chip_smoke.py`` run it on a small host mesh.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data import batches
from repro_torch.models import Model
from repro_torch.training import AdamW, cosine_schedule, train
from repro_torch.training.checkpoint import save


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains; cuda needs a card and "
                         "raises without one")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none",
                    help="sharded training on the production mesh (256 or "
                         "512 ranks under torchrun)")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--save", default=None)
    return ap.parse_args(argv)


def main(argv=None):
    """Train; returns ``{"history", "params", "seconds", "steps",
    "tokens"}`` (seconds: the host clock around the loop, synchronized
    with the card)."""
    args = parse_args(argv)
    if args.mesh != "none":
        from repro_torch.launch.mesh import (init_distributed,
                                             make_production_mesh)
        dev = init_distributed(args.device)
        return train_on_mesh(args, make_production_mesh(
            multi_pod=args.mesh == "multi", device=dev))
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) needs a CUDA card; "
                           "pass --device cpu to train on the CPU")
    dev = torch.device(args.device)
    cfg = _config(args)
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    n = sum(p.numel() for p in params.parameters())
    print(f"{cfg.name}: {n / 1e6:.1f}M params "
          f"({'reduced' if args.reduced else 'full'}, {args.device})")
    opt = AdamW(lr=args.lr,
                schedule=cosine_schedule(args.steps // 10, args.steps))
    it = batches(cfg, args.batch, args.seq, device=dev)
    t0 = time.perf_counter()
    res = train(model, params, it, steps=args.steps, opt=opt,
                remat=args.remat, donate=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tokens = args.steps * args.batch * args.seq
    print(f"{args.steps} steps in {dt:.2f}s ({dt / args.steps * 1e3:.1f} "
          f"ms/step, {tokens / dt:.0f} tokens/s)")
    if args.save:
        save(args.save, res["params"], step=args.steps, cfg=cfg)
        print(f"saved to {args.save}")
    return {"history": res["history"], "params": res["params"],
            "seconds": dt, "steps": args.steps, "tokens": tokens}


def _config(args):
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def train_on_mesh(args, mesh, cfg=None):
    """``main``'s training on ``mesh`` (its ranks' process group joined,
    ``mesh.device`` this rank's device) of ``cfg`` (``--arch``'s by
    default; a caller may cut its depth): returns ``{"history", "params"
    (this rank's blocks), "seconds", "steps", "tokens", "whole_params",
    "rank_params"}``."""
    from repro_torch.launch.sharding import init_placed
    cfg = cfg or _config(args)
    dev = mesh.device
    rank0 = mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    model = Model(cfg)
    params = init_placed(model, 0, mesh, dev)
    specs = params.tp.leaf_specs(params)
    mine = sum(p.numel() for p in params.parameters())
    whole = sum(p.numel() * mesh.axis_size(tuple(a for a in specs[n] if a))
                for n, p in params.named_parameters())
    say(f"{cfg.name}: {whole / 1e6:.1f}M params, {mine / 1e6:.1f}M on a "
        f"rank ({'reduced' if args.reduced else 'full'}, {dev.type}), mesh "
        f"{mesh.shape}")
    opt = AdamW(lr=args.lr,
                schedule=cosine_schedule(args.steps // 10, args.steps))
    it = batches(cfg, args.batch, args.seq, device=dev)
    t0 = time.perf_counter()
    res = train(model, params, it, steps=args.steps, opt=opt,
                remat=args.remat, donate=True, mesh=mesh, log=say)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tokens = args.steps * args.batch * args.seq
    say(f"{args.steps} steps in {dt:.2f}s ({dt / args.steps * 1e3:.1f} "
        f"ms/step, {tokens / dt:.0f} tokens/s)")
    if args.save:
        save(args.save, res["params"], step=args.steps, cfg=cfg)
        say(f"saved to {args.save}")
    return {"history": res["history"], "params": res["params"],
            "seconds": dt, "steps": args.steps, "tokens": tokens,
            "whole_params": whole, "rank_params": mine}


if __name__ == "__main__":
    main()
