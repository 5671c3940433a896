"""Self-speculative decoding (survey §2.4.2 — Kangaroo / LayerSkip / SWIFT):
the shallow draft pass ``partial_extend_step`` that the batched ``self``
lane runs, and the per-request ``SelfSpecDecoder``.

No auxiliary draft model: the target's own shallow sub-network (first k
blocks + shared LM head) drafts, the full network verifies.  The draft
shares the target's KV cache — drafting writes layers [0, k) at the draft
positions and verification overwrites all layers, so no extra memory and no
separate-model resync.  Dense and moe decoders (a moe layer drafts through
its expert dispatch).
"""
from __future__ import annotations

import itertools
from typing import List

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as TR


def partial_extend_step(params, tokens, cache, cfg, k: int, *,
                        window: int = 0):
    """Run the first ``k`` blocks + final norm + head over a dense cache,
    writing layers [0, k) at [pos, pos+T) IN PLACE.  Returns (logits
    (B, T, V), cache); ``pos`` is NOT advanced — draft positions stay
    provisional until verification, and the caller manages them.
    Parameters placed on a mesh (``params.tp``, e.g. an edge attending its
    own heads through ``launch/sharding.local_attention``) run on their
    local heads, their partial outputs summed over 'model', as the full
    steps in ``models/transformer.py`` do."""
    pos = cache["pos"]
    win = window or cfg.sliding_window
    tp = TR._tp(params)
    cfg = TR._cfg(params, cfg)
    h = TR._tokens(params, tokens, cfg)
    for l, blk in enumerate(itertools.islice(TR._blocks(params), k)):
        a, _, _ = L.extend_attention(
            blk.attn, L.rmsnorm(h, blk.attn_norm, cfg.norm_eps),
            cache["k"][l], cache["v"][l], pos, cfg, window=win)
        h = h + TR._attn_sum(params, a)
        h = h + TR._mlp(blk, h, cfg, tp)
    return TR._logits(params, h, cfg), cache


class SelfSpecDecoder:
    """Draft with the first ``exit_layer`` blocks, verify with all blocks:
    one sequence (B = 1), a host round trip per draft token, the JAX
    package's reference loop.  Acceptance through ``speculative_sample``
    with draws from a ``torch.Generator``; ``attn_backend`` goes to the
    prefill and the verify extend."""

    def __init__(self, model, *, exit_layer: int, gamma: int = 4,
                 temperature: float = 1.0, attn_backend: str = "auto"):
        from repro_torch.core.speculative import FAMILIES_WITH_TREES
        if model.cfg.family not in FAMILIES_WITH_TREES:
            raise ValueError("self-speculation is implemented for "
                             "scan-stacked decoders, got family "
                             f"{model.cfg.family!r}")
        if not 0 < exit_layer < model.cfg.num_layers:
            raise ValueError(f"exit_layer {exit_layer} out of range "
                             f"(0, {model.cfg.num_layers})")
        self.model = model
        self.k = exit_layer
        self.gamma = gamma
        self.temperature = temperature
        self.attn_backend = attn_backend

    def generate(self, params, prompt, max_new: int, gen=None):
        """prompt: (S,) or (1, S) ints.  Returns (tokens list, SpecStats)."""
        from repro_torch.core.seq_state import next_tokens
        from repro_torch.core.speculative import (SpecStats, device_of,
                                                  generator_for, prompt_tensor,
                                                  speculative_sample)
        model, cfg, b = self.model, self.model.cfg, self.attn_backend
        dev = device_of(params)
        gen = generator_for(params, gen)
        prompt = prompt_tensor(prompt, dev)
        max_seq = prompt.shape[1] + max_new + self.gamma + 8
        _, cache = model.prefill(params, {"tokens": prompt[:, :-1]},
                                 max_seq=max_seq, attn_backend=b)
        stats = SpecStats()
        out: List[int] = []
        last = prompt[:, -1:]
        while len(out) < max_new:
            pos0 = cache["pos"]

            # ---- shallow drafting (sequential, one token at a time)
            draft_tokens, draft_logits = [], []
            tok, pos = last, pos0
            for _ in range(self.gamma):
                lg, cache = partial_extend_step(params, tok,
                                                {**cache, "pos": pos}, cfg,
                                                self.k)
                stats.draft_calls += 1
                lg = lg[:, -1]
                nxt = next_tokens(lg, self.temperature, gen)
                draft_logits.append(lg[0])
                draft_tokens.append(int(nxt[0]))
                tok = nxt[:, None]
                pos = pos + 1

            # ---- full-depth verification (overwrites all layers at pos0..)
            drafted = torch.as_tensor(draft_tokens, dtype=torch.int32,
                                      device=dev)
            ver_in = torch.cat([last, drafted[None, :]], dim=1)
            t_logits, cache = model.extend_step(
                params, ver_in, {**cache, "pos": pos0}, attn_backend=b)
            stats.target_passes += 1
            n_acc, next_tok = speculative_sample(
                gen, t_logits[0], torch.stack(draft_logits), drafted,
                temperature=self.temperature)
            out.extend(draft_tokens[:n_acc] + [next_tok])
            stats.rounds += 1
            stats.accepted.append(n_acc)
            cache = model.rewind(cache, int(pos0) + n_acc + 1)
            last = torch.full((1, 1), next_tok, dtype=torch.int32,
                              device=dev)
        stats.tokens_out = len(out)
        return out[:max_new], stats
