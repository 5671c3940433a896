"""Adapter-based modular training (survey §3.4), the port of the JAX
package's ``training/lora.py``.

LoRA adapters on selected dense matrices; federated aggregation, including
HETLoRA's rank-aware scheme (clients train heterogeneous ranks; the server
zero-pads and weights by each client's delta mass).

Adapters keep the JAX package's keys and shapes, so a JAX adapter pytree
bridges straight in: ``{path: {"A": (r, din), "B": (dout, r), "alpha":
()}}`` keyed by the JAX parameter path (``"blocks/attn/wq"``), a stacked
path carrying stacked adapters (A ``(L, r, din)``, B ``(L, dout, r)``).
``merge_lora`` maps each stacked path onto the port's per-block tensors
through ``bridge.jax_layout``.  A parameter module's ``cfg`` is read from
its ``cfg`` attribute (``Transformer``) or passed in.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.bridge import config_of, jax_layout
from repro_torch.training import tree as T

DEFAULT_TARGETS = (r".*attn/wq$", r".*attn/wk$", r".*attn/wv$", r".*attn/wo$")


def _shapes(params, cfg):
    """JAX path -> (stacked axes, port parameter names, JAX leaf shape)."""
    named = dict(params.named_parameters())
    return {path: (stack, names, stack + tuple(named[names[0]].shape))
            for path, (stack, names) in jax_layout(params, cfg).items()}


def target_paths(params, patterns: Sequence[str] = DEFAULT_TARGETS,
                 cfg=None) -> List[str]:
    """JAX paths of the matrices (rank >= 2 in the JAX layout) matching
    any of ``patterns``."""
    pats = [re.compile(p) for p in patterns]
    return [p for p, (_, _, shape) in _shapes(params, config_of(params, cfg))
            .items() if len(shape) >= 2 and any(r.match(p) for r in pats)]


def init_lora(seed: int, params, rank: int = 8,
              patterns: Sequence[str] = DEFAULT_TARGETS, alpha: float = 16.0,
              cfg=None) -> Dict:
    """Adapters for every matching matrix, float32 on the parameters'
    device: A ~ N(0, 1/din), B = 0 (so the first merge is the identity).
    Drawn from a ``torch.Generator`` seeded with ``seed`` — the JAX
    package's distributions, not its draws."""
    cfg = config_of(params, cfg)
    shapes = _shapes(params, cfg)
    dev = next(iter(params.parameters())).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    adapters = {}
    for path in target_paths(params, patterns, cfg):
        *lead, din, dout = shapes[path][2]
        lead = tuple(lead)
        A = torch.randn(lead + (rank, din), generator=gen, device=dev) \
            * (1.0 / np.sqrt(din))
        adapters[path] = {
            "A": A, "B": torch.zeros(lead + (dout, rank), device=dev),
            "alpha": torch.tensor(alpha, dtype=torch.float32, device=dev)}
    return adapters


def merge_lora(params, adapters: Dict, cfg=None):
    """A parameter tree with W + (alpha / r)·(B A)ᵀ folded into every
    adapted matrix (the others shared with ``params``), each in its
    parameter's dtype.  Differentiable in the adapters."""
    shapes = _shapes(params, config_of(params, cfg))
    named = dict(params.named_parameters())
    new = {}
    for path, ad in adapters.items():
        stack, names, _ = shapes[path]
        r = ad["A"].shape[-2]
        scale = ad["alpha"] / r
        if not stack:
            deltas = [(ad["B"] @ ad["A"]).T]
        else:
            d = torch.einsum("...or,...ri->...io", ad["B"], ad["A"])
            deltas = list(d.reshape((-1,) + d.shape[-2:]))
        for n, delta in zip(names, deltas):
            w = named[n]
            new[n] = (w.float() + scale * delta).to(w.dtype)
    return T.replace(params, [new.get(n, t) for n, t in T.leaves(params)])


def lora_loss_fn(model, base_params):
    """loss(adapters, batch): the model's loss on the base parameters with
    the adapters merged in, functionally, every step."""
    def loss(adapters, batch):
        return model.loss(merge_lora(base_params, adapters, model.cfg), batch)
    return loss


# ---------------------------------------------------------------- federated
def fedavg_adapters(client_adapters: List[Dict], weights=None) -> Dict:
    """Plain FedAvg over homogeneous-rank adapters."""
    n = len(client_adapters)
    w = np.asarray(weights if weights is not None else [1 / n] * n,
                   np.float32)
    w = w / w.sum()
    per = [T.tensors(c) for c in client_adapters]
    avg = [sum(float(wi) * x[i] for wi, x in zip(w, per))
           for i in range(len(per[0]))]
    return T.replace(client_adapters[0], avg)


def _product(a):
    """B A of one adapter, stacked or not: (dout, din) / (L, dout, din)."""
    return a["B"] @ a["A"] if a["A"].dim() == 2 else \
        torch.einsum("lor,lri->loi", a["B"], a["A"])


def hetlora_aggregate(client_adapters: List[Dict], max_rank: int) -> Dict:
    """HETLoRA (survey §3.4): clients hold heterogeneous ranks r_c <= R.
    Zero-pad every adapter to rank R, then weight each client by the
    Frobenius mass of its delta."""
    def pad(ad):
        out = {}
        for path, a in ad.items():
            A, B = a["A"], a["B"]
            pr = max_rank - A.shape[-2]
            if pr:
                A = torch.nn.functional.pad(A, (0, 0, 0, pr))
                B = torch.nn.functional.pad(B, (0, pr))
            out[path] = {"A": A, "B": B, "alpha": a["alpha"]}
        return out

    padded = [pad(c) for c in client_adapters]
    mass = [sum(float(torch.sum(torch.square(_product(a))))
                for a in c.values()) + 1e-8 for c in padded]
    w = np.asarray(mass, np.float32)
    w = w / w.sum()
    return {path: {"A": sum(float(wi) * c[path]["A"]
                            for wi, c in zip(w, padded)),
                   "B": sum(float(wi) * c[path]["B"]
                            for wi, c in zip(w, padded)),
                   "alpha": padded[0][path]["alpha"]}
            for path in padded[0]}


def lora_param_count(adapters: Dict) -> int:
    return int(sum(np.prod(a["A"].shape) + np.prod(a["B"].shape)
                   for a in adapters.values()))
