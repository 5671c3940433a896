"""Parameter bridge: the JAX package's parameter pytree -> the port's module.

``params_from_numpy`` takes the JAX dense-transformer pytree given as nested
dicts of numpy arrays (``{"embed", "blocks", "final_norm", "lm_head"?}``,
with every ``blocks`` leaf stacked on a leading layer axis ``L``) and builds
the port's ``Transformer`` on ``device``.  numpy has no bfloat16: the caller
casts bfloat16 leaves to float32 before ``np.asarray`` (exact), and the
bridge casts every leaf to ``cfg.param_dtype``.  A tied config has no
``lm_head`` leaf; an untied one must carry it.  Tests call this; nothing on
the serving path does.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.transformer import Block, Transformer, dtype_of


def params_from_numpy(tree: Dict[str, Any], cfg, device="cuda") -> Transformer:
    dtype = dtype_of(cfg.param_dtype)

    def t(x):
        return torch.from_numpy(np.array(x, np.float32)).to(
            device=device, dtype=dtype)

    blocks = tree["blocks"]
    n = np.asarray(blocks["attn_norm"]).shape[0]
    if n != cfg.num_layers:
        raise ValueError(f"pytree has {n} stacked layers, config "
                         f"{cfg.name} has {cfg.num_layers}")
    if cfg.tie_embeddings == ("lm_head" in tree):
        raise ValueError(f"tie_embeddings={cfg.tie_embeddings} but the "
                         f"pytree {'has' if 'lm_head' in tree else 'lacks'} "
                         "an lm_head")
    layers = [Block(t(blocks["attn_norm"][l]),
                    {k: t(v[l]) for k, v in blocks["attn"].items()},
                    t(blocks["mlp_norm"][l]),
                    {k: t(v[l]) for k, v in blocks["mlp"].items()})
              for l in range(n)]
    head = t(tree["lm_head"]) if "lm_head" in tree else None
    return Transformer(cfg, t(tree["embed"]), layers, t(tree["final_norm"]),
                       head)
