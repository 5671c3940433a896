"""Early exit (survey §2.2.3 — LITE / LayerSkip / EE-LLM style), the
PyTorch twin of the JAX package's ``core/early_exit.py``.

Two pieces:
* inference: confidence-gated exit over per-layer hidden states (the shared
  LM head is applied at candidate exit layers; generation stops at the first
  layer whose confidence clears the threshold);
* training: LayerSkip-style auxiliary exit loss so intermediate layers
  produce usable logits (weight grows with depth).

Every family ``Model`` serves: the encdec head applies the decoder's final
layernorm (``final_norm_w/b``), every other family's its final rmsnorm,
and the vlm LayerSkip loss slices the image-prefix rows off, as in the
JAX package.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.uncertainty import get_estimator
from repro_torch.models import layers as L
from repro_torch.models.model import cross_entropy


def exit_logits(model, params, hidden_per_layer, layers: Sequence[int]):
    """hidden_per_layer: (L, B, S, d) from ``forward(collect_hidden=True)``.
    Applies the final norm (the encdec layernorm, else the rmsnorm) and the
    shared head (the untied ``lm_head`` where there is one, else the
    embedding) at each exit layer.  Returns (n_exits, B, S, V) f32."""
    head = getattr(params, "head", None)
    head = params.embed if head is None else head

    def norm(h):
        if model.cfg.family == "encdec":
            return L.layernorm(h, params.final_norm_w, params.final_norm_b)
        return L.rmsnorm(h, params.final_norm, model.cfg.norm_eps)

    return torch.stack([L.unembed(head, norm(hidden_per_layer[l]))
                        for l in layers])


def early_exit_decision(exit_logits_stack, threshold: float,
                        estimator: str = "max_prob"):
    """exit_logits_stack: (n_exits, B, V) at one decode position.
    Returns (chosen_exit_idx (B,), logits (B, V)): first exit whose
    confidence clears the threshold (the last exit always 'fires')."""
    u = get_estimator(estimator)(exit_logits_stack)        # (n_exits, B)
    ok = u < threshold
    ok[-1] = True
    idx = ok.to(torch.int8).argmax(dim=0)                  # first True
    chosen = torch.take_along_dim(exit_logits_stack, idx[None, :, None],
                                  dim=0)[0]
    return idx, chosen


def layerskip_loss(model, params, batch, exit_layers: Sequence[int],
                   final_weight: float = 1.0, **kw):
    """Training loss: final CE + depth-weighted auxiliary exit CE
    (LayerSkip's curriculum, static form).  ``kw`` goes to
    ``model.forward`` (``remat``, ``attn_backend``).  Returns (loss,
    per_exit_ce (n_exits,))."""
    logits, aux, hs = model.forward(params, batch, collect_hidden=True, **kw)
    logits, hs = model.text_rows(logits, batch), model.text_rows(hs, batch, 2)
    labels = batch["labels"]
    ce_final = cross_entropy(logits[:, :-1], labels[:, 1:])
    ex = exit_logits(model, params, hs, exit_layers)
    n_layers = model.cfg.num_layers
    ces = []
    loss = final_weight * ce_final + aux
    for i, l in enumerate(exit_layers):
        w = 0.3 * (l + 1) / n_layers                 # deeper exits weigh more
        ce = cross_entropy(ex[i][:, :-1], labels[:, 1:])
        ces.append(ce)
        loss = loss + w * ce
    return loss, torch.stack(ces) if ces else logits.new_zeros((0,))
