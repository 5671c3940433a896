"""Pruning (survey §3.1, Fig. 8b), the port of the JAX package's
``training/pruning.py``: magnitude pruning with soft-mask reactivation (Li
et al.) and structured d_ff channel pruning (EfficientLLM-style).

Masks are computed over the JAX layout (``quantization.as_tree``: a
parameter module's ``bridge.jax_tree``, or a JAX-layout tree of tensors),
as the JAX package computes them: one magnitude threshold per STACKED leaf
(across every layer), every leaf of rank >= 2 there (the (L, d) norms
included), and one ``keep`` for all layers in ``structured_ffn_prune``.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.bridge import from_jax_tree
from repro_torch.models.transformer import Block, Transformer
from repro_torch.training import tree as T
from repro_torch.training.quantization import _map, as_tree


def _map2(fn, a, b):
    """``fn`` over the leaves of two trees of one structure, as a tree."""
    return T.replace(a, [fn(x, y) for x, y in zip(T.tensors(a),
                                                  T.tensors(b))])


def magnitude_masks(params, sparsity: float, cfg=None):
    """Unstructured per-leaf magnitude masks (True = keep), JAX layout."""
    def mask(w):
        if w.dim() < 2:
            return torch.ones(w.shape, dtype=torch.bool, device=w.device)
        k = int(w.numel() * sparsity)
        if k == 0:
            return torch.ones(w.shape, dtype=torch.bool, device=w.device)
        thresh = torch.sort(w.abs().reshape(-1)).values[k - 1]
        return w.abs() > thresh
    return _map(mask, as_tree(params, cfg))


def apply_masks(params, masks, cfg=None):
    """``params`` with the masked entries zeroed: a parameter module comes
    back as a module, a JAX-layout tree as a tree."""
    out = _map2(lambda w, m: w * m.to(w.dtype), as_tree(params, cfg), masks)
    return from_jax_tree(params, out, cfg) \
        if isinstance(params, nn.Module) else out


def soft_mask_update(params, masks, reactivate_frac: float = 0.01, rng=None,
                     cfg=None):
    """Soft-mask mechanism: reactivate the largest masked-out weights
    (they may have regrown during masked training).  Deterministic (``rng``
    is unused, as in the JAX package)."""
    def upd(w, m):
        if w.dim() < 2:
            return m
        masked = torch.where(m, float("-inf"), w.abs()).reshape(-1)
        k = max(1, int(w.numel() * reactivate_frac))
        thresh = torch.topk(masked, k).values[-1]
        return m | (w.abs() >= thresh.clamp(min=1e-12))
    return _map2(upd, as_tree(params, cfg), masks)


def structured_ffn_prune(params: Transformer, cfg, keep_frac: float):
    """Structured pruning of d_ff channels by combined gate + up + down
    importance over the stacked leaves, one ``keep`` for all layers.
    Returns (a new ``Transformer`` with physically smaller MLPs — the
    edge-deployable artifact — and keep); dense and vlm families."""
    if cfg.family not in ("dense", "vlm"):
        raise ValueError(f"structured FFN pruning needs a dense MLP, not "
                         f"family {cfg.family!r}")
    mlp = as_tree(params, cfg)["blocks"]["mlp"]
    w_up = mlp["w_up"]                              # (L, d, f)
    score = w_up.abs().sum(dim=1)                   # (L, f)
    if "w_gate" in mlp:
        score = score + mlp["w_gate"].abs().sum(dim=1)
    score = score + mlp["w_down"].abs().sum(dim=2)
    keep = max(8, int(w_up.shape[-1] * keep_frac) // 8 * 8)
    idx = torch.sort(torch.topk(score, keep, dim=-1).indices, dim=-1).values
    blocks = []
    for l, blk in enumerate(params.blocks):
        new = {k: v.detach()[idx[l]] if k == "w_down"
               else v.detach()[:, idx[l]] for k, v in blk.mlp.items()}
        blocks.append(Block(blk.attn_norm.detach(),
                            {k: v.detach() for k, v in blk.attn.items()},
                            blk.mlp_norm.detach(), mlp=new))
    head = None if params.lm_head is None else params.lm_head.detach()
    return Transformer(params.cfg, params.embed.detach(), blocks,
                       params.final_norm.detach(), head), keep


def sparsity_report(masks) -> Dict[str, float]:
    ms = T.tensors(masks)
    kept = sum(int(m.sum()) for m in ms)
    total = sum(m.numel() for m in ms)
    return {"kept_frac": kept / total, "pruned_frac": 1 - kept / total}
