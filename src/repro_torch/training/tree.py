"""Parameter trees for training: the port's parameter modules
(``Transformer``, ``ParamTree``) and plain nested containers of tensors
(LoRA adapters, optimizer moments) seen as an ordered list of leaves.

The JAX package maps functions over pytrees; the port's training code does
the same through two functions:

* ``leaves(tree)`` — ``[(name, tensor), ...]``: ``named_parameters()`` of
  a module, the ``/``-joined key paths of a dict / list / tuple tree.
* ``replace(tree, tensors)`` — a tree of the same structure holding
  ``tensors`` in ``leaves`` order.  A module is copied shallowly: no
  tensor is copied, the source tree is not touched.  A tensor that
  requires grad goes in as it is (a leaf to differentiate, or the output
  of a differentiable merge); any other is held as a frozen
  ``nn.Parameter``, like the serving parameters.
"""
from __future__ import annotations

import copy
from typing import Any, List, Sequence, Tuple

import torch
from torch import nn


def leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    out: List[Tuple[str, torch.Tensor]] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            out.append((prefix, node))
            return
        for k, v in items:
            walk(v, f"{prefix}/{k}" if prefix else str(k))

    walk(tree, "")
    return out


def tensors(tree) -> List[torch.Tensor]:
    return [t for _, t in leaves(tree)]


def _hold(t: torch.Tensor):
    return t if t.requires_grad else nn.Parameter(t, requires_grad=False)


def _replace_module(m: nn.Module, it):
    new = copy.copy(m)
    new.__dict__["_parameters"] = {
        k: None if v is None else _hold(next(it))
        for k, v in m._parameters.items()}
    new.__dict__["_modules"] = {
        k: None if c is None else _replace_module(c, it)
        for k, c in m._modules.items()}
    return new


def _replace_container(node, it):
    if isinstance(node, dict):
        return {k: _replace_container(v, it) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        vals = [_replace_container(v, it) for v in node]
        return type(node)(*vals) if hasattr(node, "_fields") \
            else type(node)(vals)
    return next(it)


def replace(tree, new: Sequence[torch.Tensor]) -> Any:
    it = iter(new)
    out = _replace_module(tree, it) if isinstance(tree, nn.Module) \
        else _replace_container(tree, it)
    if next(it, None) is not None:
        raise ValueError("more tensors than the tree has leaves")
    return out
