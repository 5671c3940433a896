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
``--save PATH`` writes the trained params in the JAX layout.  ``--mesh``
(sharded training) is not ported (ROADMAP A.8).
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
                    help="sharded training (not ported: ROADMAP A.8)")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--save", default=None)
    return ap.parse_args(argv)


def main(argv=None):
    """Train; returns ``{"history", "params", "seconds", "steps",
    "tokens"}`` (seconds: the host clock around the loop, synchronized
    with the card)."""
    args = parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError("--mesh (sharded training) is not ported "
                                  "yet: ROADMAP A.8")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) needs a CUDA card; "
                           "pass --device cpu to train on the CPU")
    dev = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
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


if __name__ == "__main__":
    main()
