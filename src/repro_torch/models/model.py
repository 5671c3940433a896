"""Model facade over the ported families (the dense family in this slice).

    m = Model(cfg)
    params = m.init(seed=0)                       # on CUDA unless told
    logits, aux = m.forward(params, {"tokens": tokens})
    logits, cache = m.prefill(params, {"tokens": tokens}, max_seq=...)
    logits, cache = m.paged_decode_step(params, token, paged_cache)

Same entry points as the JAX package's ``Model``; parameters are the
``models.transformer.Transformer`` module.  Other families raise
``NotImplementedError`` naming their later slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


class Model:
    def __init__(self, cfg: ModelConfig):
        transformer.require_dense(cfg)
        self.cfg = cfg

    # ---------------------------------------------------------------- init
    def init(self, seed: int = 0, device="cuda"):
        """Seeded random parameters on ``device`` (CUDA by default; pass
        ``device="cpu"`` explicitly for the CPU)."""
        return transformer.init_params(self.cfg, seed, device)

    # ---------------------------------------------------------------- fwd
    def forward(self, params, batch: Dict, *, window: int = 0,
                attn_backend: str = "auto"):
        return transformer.forward(params, batch["tokens"], self.cfg,
                                   window=window, backend=attn_backend)

    def prefill(self, params, batch: Dict, *, max_seq: Optional[int] = None,
                window: int = 0, attn_backend: str = "auto"):
        return transformer.prefill(params, batch["tokens"], self.cfg,
                                   max_seq=max_seq, window=window,
                                   backend=attn_backend)

    def decode_step(self, params, token, cache, *, window: int = 0,
                    attn_backend: str = "auto"):
        """One decode step over a dense cache.  ``attn_backend``: "auto"
        (CUDA: the Hopper dense decode kernel; CPU: ``mha``), "kernel" or
        "plain"."""
        return transformer.decode_step(params, token, cache, self.cfg,
                                       window=window,
                                       attn_backend=attn_backend)

    def extend_step(self, params, tokens, cache, *, window: int = 0,
                    block_mask=None, q_positions=None,
                    attn_backend: str = "auto"):
        """Multi-token cached decode (chunked prefill, speculative verify).
        tokens (B,T) -> (logits (B,T,V), cache).  ``block_mask`` (T, C) and
        ``q_positions`` drive token trees (the Hopper tree-verify kernel on
        CUDA under ``attn_backend`` "auto" or "kernel")."""
        return transformer.extend_step(params, tokens, cache, self.cfg,
                                       window=window, block_mask=block_mask,
                                       q_positions=q_positions,
                                       attn_backend=attn_backend)

    # ---------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_seq: int, device="cuda"):
        return transformer.init_cache(self.cfg, batch_size, max_seq,
                                      device=device)

    @property
    def paged_kv(self) -> bool:
        """True: the dense family's cache pages (shared block pool + block
        tables, see ``core/paged_cache.py``)."""
        return True

    def init_paged_cache(self, num_blocks: int, block_size: int, batch: int,
                         max_blocks: int, device="cuda"):
        return transformer.init_paged_cache(self.cfg, num_blocks, block_size,
                                            batch, max_blocks, device=device)

    def paged_decode_step(self, params, token, cache, *,
                          attn_backend: str = "auto"):
        """One decode step over a paged cache. token (B,1) -> (logits (B,V),
        cache).  ``attn_backend``: "auto" (CUDA: the Hopper paged-decode
        kernel; CPU: its plain version), "kernel", "plain", or "gather"
        (the full block-table gather, a test oracle)."""
        return transformer.paged_decode_step(params, token, cache, self.cfg,
                                             attn_backend=attn_backend)

    def paged_extend_step(self, params, tokens, cache):
        """Multi-token cached decode over a paged cache. tokens (B,T) ->
        (logits (B,T,V), cache)."""
        return transformer.paged_extend_step(params, tokens, cache, self.cfg)

    @property
    def rewindable_cache(self) -> bool:
        """True: KV caches roll back by resetting ``pos``."""
        return True

    def rewind(self, cache, new_pos):
        pos = cache["pos"]
        return {**cache, "pos": torch.as_tensor(new_pos, dtype=torch.int32,
                                                device=pos.device)}
