"""Quantization for efficient edge deployment (survey §3.1, Fig. 8a), the
port of the JAX package's ``training/quantization.py``.

* ``quantize_params`` / ``dequantize_params`` — per-channel symmetric int8
  PTQ of every floating leaf of rank >= 2 (embeddings included), with size
  accounting.
* ``fake_quant`` — straight-through-estimator QAT hook (LLM-QAT style).

The JAX package works on its parameter pytree, where each block's leaves
are stacked on L: its rank test takes in the (L, d) norms, and each scale
is per last-axis channel of the stacked leaf.  The port works on the same
tree (``bridge.jax_tree`` of a parameter module; a JAX-layout tree of
tensors passes through as it is), so a quantized tree is laid out and
valued as JAX's.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from repro_torch.bridge import jax_tree
from repro_torch.training import tree as T


def _map(fn, tree):
    """``tree`` (a JAX-layout tree of tensors) with ``fn`` applied to every
    leaf."""
    return T.replace(tree, [fn(t) for t in T.tensors(tree)])


def as_tree(params, cfg=None):
    """The JAX-layout tree of ``params`` (detached): ``bridge.jax_tree`` of a
    parameter module, or a tree of tensors as it is."""
    if isinstance(params, nn.Module):
        with torch.no_grad():
            return jax_tree(params, cfg)
    return params


def _quant_leaf(w, bits: int = 8):
    qmax = 2 ** (bits - 1) - 1
    scale = w.float().abs().amax(dim=-1, keepdim=True) / qmax
    scale = scale.clamp(min=1e-12)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    return {"q": q, "scale": scale}


def _is_quant(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "scale"}


def quantize_params(params, bits: int = 8, cfg=None):
    """The JAX-layout tree with every floating leaf of rank >= 2 replaced
    by ``{"q": int8, "scale": float32 (..., 1)}``; small vectors stay
    floating."""
    def q(w):
        if w.dim() >= 2 and w.is_floating_point():
            return _quant_leaf(w, bits)
        return w
    return _map(q, as_tree(params, cfg))


def dequantize_params(qparams, dtype=torch.float32):
    def dq(node):
        if _is_quant(node):
            return (node["q"].float() * node["scale"]).to(dtype)
        if isinstance(node, dict):
            return {k: dq(v) for k, v in node.items()}
        if isinstance(node, list):
            return [dq(v) for v in node]
        return node
    return dq(qparams)


def quantized_bytes(qparams) -> int:
    return int(sum(t.numel() * t.element_size()
                   for t in T.tensors(qparams)))


def fake_quant(w, bits: int = 8):
    """Straight-through fake quantization (QAT): forward = quantized,
    gradient = identity."""
    qmax = 2 ** (bits - 1) - 1
    scale = (w.abs().amax(dim=-1, keepdim=True) / qmax).clamp(min=1e-12)
    wq = torch.round(w / scale) * scale
    return w + (wq - w).detach()


def quantization_error(params, qparams, cfg=None) -> Dict[str, float]:
    """Relative error per leaf of the dequantized tree against ``params``:
    its mean and max."""
    deq = dequantize_params(qparams)
    errs = []
    for a, b in zip(T.tensors(as_tree(params, cfg)), T.tensors(deq)):
        a = a.detach().float().cpu().numpy()
        b = b.detach().float().cpu().numpy()
        errs.append(np.linalg.norm(a - b) / (np.linalg.norm(a) + 1e-12))
    return {"mean_rel_err": float(np.mean(errs)),
            "max_rel_err": float(np.max(errs))}
