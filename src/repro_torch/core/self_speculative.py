"""Self-speculative decoding (survey §2.4.2 — Kangaroo / LayerSkip / SWIFT):
the shallow draft pass of the batched ``self`` lane.

No auxiliary draft model: the target's own shallow sub-network (first k
blocks + shared LM head) drafts, the full network verifies.  The draft
shares the target's KV cache — drafting writes layers [0, k) at the draft
positions and verification overwrites all layers, so no extra memory and no
separate-model resync.  The per-request ``SelfSpecDecoder`` of the JAX
package is a later slice of the port.
"""
from __future__ import annotations

from repro_torch.models import layers as L
from repro_torch.models import transformer as TR


def partial_extend_step(params, tokens, cache, cfg, k: int, *,
                        window: int = 0):
    """Run the first ``k`` blocks + final norm + head over a dense cache,
    writing layers [0, k) at [pos, pos+T) IN PLACE.  Returns (logits
    (B, T, V), cache); ``pos`` is NOT advanced — draft positions stay
    provisional until verification, and the caller manages them."""
    pos = cache["pos"]
    win = window or cfg.sliding_window
    h = L.embed(params.embed, tokens).to(TR.dtype_of(cfg.activ_dtype))
    for l, blk in enumerate(params.blocks[:k]):
        a, _, _ = L.extend_attention(
            blk.attn, L.rmsnorm(h, blk.attn_norm, cfg.norm_eps),
            cache["k"][l], cache["v"][l], pos, cfg, window=win)
        h = h + a
        h = h + TR._mlp(blk, h, cfg)
    return TR._logits(params, h, cfg), cache
