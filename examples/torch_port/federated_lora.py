"""Federated adapter tuning (survey §3.4), PyTorch port: non-IID clients
fine-tune heterogeneous-rank LoRA adapters on a frozen base model; the
server aggregates with HETLoRA's rank-aware scheme.

    PYTHONPATH=src python examples/torch_port/federated_lora.py

The twin of ``examples/federated_lora.py``; it imports only
``repro_torch``.  ``--device`` defaults to ``cuda`` and raises without a
card.
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM, batches, dirichlet_clients
from repro_torch.data.pipeline import client_divergence
from repro_torch.launch import resolve_device
from repro_torch.models import Model
from repro_torch.models.model import cross_entropy
from repro_torch.training import AdamW, make_train_step
from repro_torch.training.lora import (hetlora_aggregate, init_lora,
                                       lora_loss_fn, lora_param_count,
                                       merge_lora)

N_CLIENTS = 3
RANKS = [2, 4, 8]


def main(argv=None):
    """Returns {"divergence", "client_losses", "adapters" (per client),
    "aggregate", "base_ce", "merged_ce"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("smollm-135m").reduced()
    model = Model(cfg)
    base = model.init(seed=0, device=dev)
    n_base = sum(p.numel() for p in base.parameters())

    mixtures = dirichlet_clients(N_CLIENTS, 4, alpha=0.2)
    div = client_divergence(mixtures)
    print(f"client divergence (mean pairwise TV): {div:.3f}")

    synth = SyntheticLM(cfg.vocab_size)
    client_adapters, losses = [], []
    for c in range(N_CLIENTS):
        ad = init_lora(10 + c, base, rank=RANKS[c])
        opt = AdamW(lr=3e-3, weight_decay=0.0)
        step = make_train_step(model, opt,
                               loss_fn=lora_loss_fn(model, base),
                               donate=False)
        st = opt.init(ad)
        it = batches(cfg, 4, 48, device=dev, domain_weights=mixtures[c],
                     seed=c, synth=synth)
        for _ in range(args.steps):
            ad, st, m = step(ad, st, next(it))
        losses.append(float(m["loss"]))
        n_ad = lora_param_count(ad)
        print(f"client {c}: rank={RANKS[c]} local loss {losses[-1]:.4f} "
              f"adapter params {n_ad} ({n_ad / n_base:.4%} of base — the "
              f"only bytes that cross the edge-cloud link)")
        client_adapters.append(ad)

    print("\n== HETLoRA rank-aware aggregation ==")
    agg = hetlora_aggregate(client_adapters, max_rank=max(RANKS))
    merged = merge_lora(base, agg)
    evalb = next(batches(cfg, 8, 48, device=dev, seed=77, synth=synth))
    with torch.no_grad():
        lg, _ = model.forward(merged, evalb)
        lg0, _ = model.forward(base, evalb)
    base_ce = float(cross_entropy(lg0[:, :-1], evalb["labels"][:, 1:]))
    merged_ce = float(cross_entropy(lg[:, :-1], evalb["labels"][:, 1:]))
    print(f"base CE   : {base_ce:.4f}")
    print(f"merged CE : {merged_ce:.4f}")
    return {"divergence": div, "client_losses": losses,
            "adapters": client_adapters, "aggregate": agg,
            "base_ce": base_ce, "merged_ce": merged_ce}


if __name__ == "__main__":
    main()
