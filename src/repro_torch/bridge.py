"""Parameter bridge: the JAX package's parameter pytree -> the port's module.

``params_from_numpy`` takes a JAX parameter pytree given as nested dicts
(and, for xLSTM, lists) of numpy arrays and builds the port's parameters on
``device``:

* dense and moe: ``{"embed", "blocks", "final_norm", "lm_head"?}`` with
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

numpy has no bfloat16: the caller casts bfloat16 leaves to float32 before
``np.asarray`` (exact).  Each leaf gets the dtype the JAX package gives it:
``cfg.param_dtype``, except the leaves that JAX keeps in float32 whatever
the config says: the recurrent families' gate and norm leaves
(``ssm.F32_LEAVES``, ``xlstm.F32_LEAVES``) and the moe router.  Tests call
this; nothing on the serving path does.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import ssm, xlstm
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
