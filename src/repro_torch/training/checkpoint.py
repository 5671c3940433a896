"""Checkpointing: flat-key npz save/restore, the port of the JAX package's
``training/checkpoint.py``, file for file compatible with it.

Keys are the ``/``-joined paths of the tree with ``%``-escaping inside a
key (``_esc``), so a LoRA adapter keyed ``blocks/attn/wq`` saves as
``blocks%2Fattn%2Fwq/A``, as JAX saves it.  A parameter module (the port's
``Transformer`` or ``ParamTree``) is saved in the JAX layout through
``bridge.params_to_numpy`` — stacked leaves, float32 (numpy has no
bfloat16; JAX restores such a file as float32 leaves) — and restores
through ``bridge.params_from_numpy`` in the config's dtypes, so a
checkpoint written by either package restores in the other.  Plain trees
(dicts, lists, NamedTuples of tensors) save their leaves as they are and
restore into the structure, devices and dtypes of ``like``.

Parameters placed on a device mesh (``params.tp``, sharded training) save
from every rank at once: each leaf is all-gathered whole
(``launch/sharding.gather_params``) and rank 0 alone writes the file the
unsharded ``save`` writes.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
from torch import nn


def _esc(key: str) -> str:
    """Escape "/" (and the escape char itself) WITHIN a single key, so an
    adapter path key never collides with a nested spelling of the path."""
    return key.replace("%", "%25").replace("/", "%2F")


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):          # NamedTuple
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        k = _esc(str(k))
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def save(path: str, params: Any, step: int = 0, cfg=None):
    tp = getattr(params, "tp", None)
    if tp is not None:                      # every rank gathers, rank 0 writes
        from repro_torch.launch.sharding import gather_params
        params = gather_params(params)
        if tp.mesh.rank != 0:
            return
    if isinstance(params, nn.Module):
        from repro_torch.bridge import config_of, params_to_numpy
        params = params_to_numpy(params, config_of(params, cfg))
    arrays = {k: _host(v) for k, v in _flatten(params).items()}
    arrays["__step__"] = np.asarray(step)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def restore(path: str, like: Any, cfg=None):
    """Restore into the structure of ``like``; returns (tree, step)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    step = int(data["__step__"])
    if isinstance(like, nn.Module):
        from repro_torch.bridge import (config_of, params_from_numpy,
                                        params_to_numpy)
        cfg = config_of(like, cfg)
        shape = params_to_numpy(like, cfg)
        flat = _flatten(shape)
        tree = _unflatten(shape, {k: data[k] for k in flat})
        dev = next(iter(like.parameters())).device
        return params_from_numpy(tree, cfg, device=dev), step
    from repro_torch.training import tree as T
    keys = list(_flatten(like))
    new = [torch.from_numpy(np.array(data[k])).to(device=t.device,
                                                  dtype=t.dtype)
           for k, (_, t) in zip(keys, T.leaves(like))]
    return T.replace(like, new), step


def _unflatten(shape, flat, prefix=""):
    """``shape``'s nested structure with the leaf at each flat key."""
    if isinstance(shape, dict):
        return {k: _unflatten(v, flat, f"{prefix}/{_esc(k)}" if prefix
                              else _esc(k)) for k, v in shape.items()}
    if isinstance(shape, list):
        return [_unflatten(v, flat, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(shape)]
    return flat[prefix]
