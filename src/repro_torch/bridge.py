"""Parameter bridge between the JAX package's parameter pytree and the
port's modules, both ways.

``params_from_numpy`` takes a JAX parameter pytree given as nested dicts
(and, for xLSTM, lists) of numpy arrays and builds the port's parameters on
``device``:

* dense, moe and vlm: ``{"embed", "blocks", "final_norm", "lm_head"?}`` with
  every ``blocks`` leaf stacked on a leading layer axis ``L`` -> the
  port's ``Transformer``.  A tied config has no ``lm_head`` leaf; an
  untied one must carry it.  A moe block's ``moe`` sub-tree (``router``
  (L, d, E), ``w_gate``/``w_up`` (L, E, d, f), ``w_down`` (L, E, f, d))
  stands where a dense block's ``mlp`` does.
* ssm (mamba2): ``blocks`` stacked on ``L`` -> a ``ParamTree`` with one
  block per layer.
* xlstm: ``blocks`` is already a list of per-layer dicts, mLSTM and sLSTM
  mixed.
* hybrid (zamba2): ``mamba`` stacked on (G, K) -> one block per layer
  ``g * K + k``, beside the one ``shared`` attention+MLP block.
* encdec (whisper): ``encoder`` and ``decoder`` stacked on their layer
  counts -> the port's ``EncDec`` with one block per layer, beside
  ``enc_pos``, ``dec_pos``, ``embed``, ``enc_norm_w/b`` and
  ``final_norm_w/b``.

numpy has no bfloat16: the caller casts bfloat16 leaves to float32 before
``np.asarray`` (exact).  Each leaf gets the dtype the JAX package gives it:
``cfg.param_dtype``, except the leaves that JAX keeps in float32 whatever
the config says: the recurrent families' gate and norm leaves
(``ssm.F32_LEAVES``, ``xlstm.F32_LEAVES``) and the moe router.  Tests call
this; nothing on the serving path does.

``params_to_numpy`` is the inverse: it rebuilds the JAX pytree (stacked
leaves, float32 numpy arrays) from the port's parameters, so that
checkpoints are written in the JAX layout and updated parameters compare
leaf for leaf with JAX.  ``jax_layout`` names, for every JAX leaf path
(``"blocks/attn/wq"``), its stacked axes and the port parameters that fill
them; ``jax_ndims`` gives each port parameter the rank of its JAX leaf —
the rank AdamW's decay rule reads, and LoRA's target rule.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.models import encdec, hybrid, ssm, xlstm
from repro_torch.models.layers import ParamTree
from repro_torch.models.transformer import Block, Transformer, dtype_of

_F32_LEAVES = {"ssm": ssm.F32_LEAVES, "xlstm": xlstm.F32_LEAVES,
               "hybrid": ssm.F32_LEAVES, "moe": ("router",)}


def params_from_numpy(tree: Dict[str, Any], cfg, device="cuda"):
    dtype = dtype_of(cfg.param_dtype)
    keep_f32 = _F32_LEAVES.get(cfg.family, ())

    def t(x, name=""):
        dt = torch.float32 if name in keep_f32 else dtype
        return torch.from_numpy(np.array(x, np.float32)).to(device=device,
                                                            dtype=dt)

    def convert(d, index=()):
        """A sub-tree with every leaf at ``index`` of its stacked axes."""
        return {k: convert(v, index) if isinstance(v, dict)
                else t(np.asarray(v)[index], k) for k, v in d.items()}

    if cfg.family == "ssm":
        return ParamTree({"embed": t(tree["embed"]),
                          "blocks": [convert(tree["blocks"], (l,))
                                     for l in range(cfg.num_layers)],
                          "final_norm": t(tree["final_norm"])})
    if cfg.family == "xlstm":
        return ParamTree({"embed": t(tree["embed"]),
                          "blocks": [convert(b) for b in tree["blocks"]],
                          "final_norm": t(tree["final_norm"])})
    if cfg.family == "encdec":
        n = {"encoder": cfg.encoder_layers, "decoder": cfg.num_layers}
        return encdec.EncDec(cfg, {
            k: [convert(v, (l,)) for l in range(n[k])] if k in n
            else t(v) for k, v in tree.items()})
    if cfg.family == "hybrid":
        G, K = np.asarray(tree["mamba"]["A_log"]).shape[:2]
        return ParamTree({"embed": t(tree["embed"]),
                          "mamba": [convert(tree["mamba"], (g, k))
                                    for g in range(G) for k in range(K)],
                          "shared": convert(tree["shared"]),
                          "final_norm": t(tree["final_norm"])})

    blocks = tree["blocks"]
    n = np.asarray(blocks["attn_norm"]).shape[0]
    if n != cfg.num_layers:
        raise ValueError(f"pytree has {n} stacked layers, config "
                         f"{cfg.name} has {cfg.num_layers}")
    if cfg.tie_embeddings == ("lm_head" in tree):
        raise ValueError(f"tie_embeddings={cfg.tie_embeddings} but the "
                         f"pytree {'has' if 'lm_head' in tree else 'lacks'} "
                         "an lm_head")
    ffn = "moe" if cfg.family == "moe" else "mlp"
    layers = [Block(t(blocks["attn_norm"][l]),
                    {k: t(v[l]) for k, v in blocks["attn"].items()},
                    t(blocks["mlp_norm"][l]),
                    **{ffn: {k: t(v[l], k) for k, v in blocks[ffn].items()}})
              for l in range(n)]
    head = t(tree["lm_head"]) if "lm_head" in tree else None
    return Transformer(cfg, t(tree["embed"]), layers, t(tree["final_norm"]),
                       head)


def config_of(params, cfg=None):
    """``cfg`` if given, else the parameter module's own ``cfg`` (a
    ``Transformer`` carries one; a ``ParamTree`` does not)."""
    cfg = cfg if cfg is not None else getattr(params, "cfg", None)
    if cfg is None:
        raise ValueError("pass the parameters' cfg: the JAX layout of a "
                         "parameter module depends on its config")
    return cfg


def jax_layout(params, cfg) -> Dict[str, Tuple[Tuple[int, ...], List[str]]]:
    """JAX leaf path -> (its stacked axes, the port parameter names that
    fill them in row-major order).  dense, moe, vlm and ssm stack
    ``blocks`` on L; hybrid stacks ``mamba`` on (G, K); encdec stacks
    ``encoder`` and ``decoder`` on their layer counts; xLSTM's ``blocks``
    is a list, so its leaves are ``blocks/<i>/...`` and unstacked."""
    stacks = {"blocks": (cfg.num_layers,)}
    if cfg.family == "encdec":
        stacks = {"encoder": (cfg.encoder_layers,),
                  "decoder": (cfg.num_layers,)}
    elif cfg.family == "hybrid":
        stacks = {"mamba": tuple(hybrid._dims(cfg))}
    elif cfg.family == "xlstm":
        stacks = {}
    out: Dict[str, Tuple[Tuple[int, ...], List[str]]] = {}
    for name, _ in params.named_parameters():
        parts = name.split(".")
        if parts[0] in stacks:
            path = "/".join([parts[0]] + parts[2:])
            out.setdefault(path, (stacks[parts[0]], []))[1].append(name)
        else:
            out["/".join(parts)] = ((), [name])
    for path, (stack, names) in out.items():
        if len(names) != int(np.prod(stack)):
            raise ValueError(f"{path}: {len(names)} parameters for stacked "
                             f"axes {stack}")
    return out


def jax_ndims(params, cfg) -> Dict[str, int]:
    """Port parameter name -> the rank of the JAX leaf it belongs to."""
    named = dict(params.named_parameters())
    return {n: len(stack) + named[n].dim()
            for stack, names in jax_layout(params, cfg).values()
            for n in names}


def _layout_tree(params, cfg, leaf):
    """The JAX pytree of ``params`` with ``leaf(tensors, stack)`` at each
    path (its port parameters in row-major order, its stacked axes)."""
    named = dict(params.named_parameters())
    tree: Dict[str, Any] = {}
    for path, (stack, names) in jax_layout(params, cfg).items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf([named[n] for n in names], stack)
    if cfg.family == "xlstm":
        tree["blocks"] = [tree["blocks"][str(i)]
                          for i in range(len(tree["blocks"]))]
    return tree


def jax_tree(params, cfg=None) -> Dict[str, Any]:
    """The JAX parameter pytree of the port's ``params`` as tensors: nested
    dicts (and, for xLSTM, a list of blocks), stacked leaves stacked as JAX
    stacks them, on the parameters' device in their dtypes.  What a
    function of the JAX package computes over a stacked leaf (one
    threshold across every layer, a rank >= 2 test that takes in the
    (L, d) norms) the port computes over this tree."""
    return _layout_tree(params, config_of(params, cfg), lambda ts, stack: (
        torch.stack(ts).reshape(stack + ts[0].shape) if stack else ts[0]))


def from_jax_tree(params, tree, cfg=None):
    """``params`` (a parameter module) with every parameter taken from its
    slice of ``tree``, a JAX-layout tree of tensors shaped as
    ``jax_tree(params)``'s: the inverse of ``jax_tree``."""
    from repro_torch.training import tree as T
    cfg = config_of(params, cfg)
    new = {}
    for path, (stack, names) in jax_layout(params, cfg).items():
        leaf = tree
        for k in path.split("/"):
            leaf = leaf[int(k)] if isinstance(leaf, list) else leaf[k]
        parts = leaf.reshape((-1,) + tuple(leaf.shape[len(stack):])) \
            if stack else leaf[None]
        new.update(zip(names, parts))
    return T.replace(params, [new[n] for n, _ in T.leaves(params)])


def params_to_numpy(params, cfg) -> Dict[str, Any]:
    """The JAX parameter pytree of the port's ``params``: nested dicts (and,
    for xLSTM, a list of blocks) of float32 numpy arrays, stacked leaves
    stacked as JAX stacks them.  The inverse of ``params_from_numpy``."""
    def leaf(ts, stack):
        arrs = [t.detach().float().cpu().numpy() for t in ts]
        return np.stack(arrs).reshape(stack + arrs[0].shape) if stack \
            else arrs[0]

    return _layout_tree(params, cfg, leaf)
