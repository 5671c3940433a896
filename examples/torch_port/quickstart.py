"""Quickstart (PyTorch port): build an edge SLM + cloud LLM pair, run
collaborative (speculative) inference, and inspect the accounting.

    PYTHONPATH=src python examples/torch_port/quickstart.py [--device cpu]

The twin of ``examples/quickstart.py``; it imports only ``repro_torch``.
``--device`` defaults to ``cuda`` and raises without a card.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.speculative import SpecDecoder, autoregressive_baseline
from repro_torch.core.uncertainty import dirichlet_evidence
from repro_torch.launch import resolve_device
from repro_torch.models import Model


def main(argv=None, params=None):
    """Returns what it prints as a dict.  ``params`` (edge, cloud) replaces
    the seeded init (tests bridge the JAX package's parameters in)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = resolve_device(ap.parse_args(argv).device)
    # --- models: any two assigned architectures with a shared vocab ------
    edge_cfg = get_config("smollm-135m").reduced()
    cloud_cfg = get_config("granite-8b").reduced().replace(
        vocab_size=edge_cfg.vocab_size)
    edge, cloud = Model(edge_cfg), Model(cloud_cfg)
    if params is None:
        params = (edge.init(seed=0, device=dev), cloud.init(seed=1, device=dev))
    edge_params, cloud_params = params

    prompt = np.arange(12) % edge_cfg.vocab_size

    # --- cloud-only baseline vs edge-draft/cloud-verify ------------------
    base = autoregressive_baseline(cloud, cloud_params, prompt, 24,
                                   temperature=0.0)
    dec = SpecDecoder(edge, cloud, gamma=4, temperature=0.0)
    toks, stats = dec.generate(edge_params, cloud_params, prompt, 24)

    print("cloud-only tokens :", base)
    print("speculative tokens:", toks)
    print("identical (lossless):", toks == base)
    print("accounting:", stats.summary())
    print(f"-> {stats.tokens_per_target_pass:.2f} tokens per cloud pass "
          f"(cloud-only = 1.00)")

    # --- evidence-based uncertainty (survey §6) on the edge's next token
    lg, _ = edge.prefill(edge_params, {"tokens": torch.as_tensor(
        prompt[None, :], dtype=torch.int32, device=dev)})
    u = dirichlet_evidence(lg[0])
    print(f"edge uncertainty: epistemic={float(u['epistemic']):.3f} "
          f"aleatoric={float(u['aleatoric']):.3f}")
    return {"baseline": base, "speculative": toks, "lossless": toks == base,
            "accounting": stats.summary(),
            "epistemic": float(u["epistemic"]),
            "aleatoric": float(u["aleatoric"])}


if __name__ == "__main__":
    main()
