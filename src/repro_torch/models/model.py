"""Model facade over the ported families: dense, moe, ssm (mamba2), xlstm
and hybrid (zamba2).

    m = Model(cfg)
    params = m.init(seed=0)                       # on CUDA unless told
    logits, aux = m.forward(params, {"tokens": tokens})
    loss = m.loss(params, {"tokens": tokens, "labels": labels})
    logits, cache = m.prefill(params, {"tokens": tokens}, max_seq=...)
    logits, cache = m.decode_step(params, token, cache)

Same entry points as the JAX package's ``Model``.  Parameters are the
``models.transformer.Transformer`` module for the dense and moe families
and a ``layers.ParamTree`` for the recurrent ones.  ``attn_backend``
("auto" | "kernel" | "plain") picks the kernels' or the plain path of
every entry that reaches a kernel.  The vlm and encdec families raise
``NotImplementedError`` naming their later slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, ssm, transformer, xlstm


def cross_entropy(logits, labels, ignore: int = -1):
    """logits (B, S, V) f32; labels (B, S) int.  Mean over the labels that
    are not ``ignore``."""
    mask = labels != ignore
    lab = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp(min=1)

FAMILIES = {"dense": transformer, "moe": transformer, "ssm": ssm,
            "xlstm": xlstm, "hybrid": hybrid}
# KV-cache decoders (``transformer``'s families): they page, rewind by
# ``pos`` and take token trees
KV_FAMILIES = transformer.FAMILIES


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet: the "
                "PyTorch port serves the dense, moe, ssm, xlstm and hybrid "
                "families; vlm and encdec are later slices")
        self.cfg = cfg
        self._mod = FAMILIES[cfg.family]
        # families with attention: a sliding window, a K/V cache to size
        self._attn = cfg.family in KV_FAMILIES + ("hybrid",)

    # ---------------------------------------------------------------- init
    def init(self, seed: int = 0, device="cuda"):
        """Seeded random parameters on ``device`` (CUDA by default; pass
        ``device="cpu"`` explicitly for the CPU)."""
        return self._mod.init_params(self.cfg, seed, device)

    # ---------------------------------------------------------------- fwd
    def forward(self, params, batch: Dict, *, window: int = 0,
                remat: bool = False, collect_hidden: bool = False,
                attn_backend: str = "auto"):
        """Teacher-forced pass: (logits (B, S, V) f32, aux loss), plus the
        per-layer hidden states (L, B, S, d) — per group for the hybrid,
        as the JAX package stacks them — if ``collect_hidden``.  Under
        grad it trains: on CUDA the flash and SSD-scan kernels run forward
        and backward (the serving-only kernels have no backward and raise).
        ``remat`` recomputes each block (each group for the hybrid) in the
        backward, every family."""
        kw = {"window": window} if self._attn else {}
        return self._mod.forward(params, batch["tokens"], self.cfg,
                                 backend=attn_backend, remat=remat,
                                 collect_hidden=collect_hidden, **kw)

    def loss(self, params, batch: Dict, *, window: int = 0,
             remat: bool = False, attn_backend: str = "auto"):
        """Next-token cross entropy of ``batch["labels"]`` (-1 ignored)
        plus the moe auxiliary loss, as the JAX package's ``Model.loss``."""
        logits, aux = self.forward(params, batch, window=window, remat=remat,
                                   attn_backend=attn_backend)[:2]
        return cross_entropy(logits[:, :-1, :], batch["labels"][:, 1:]) + aux

    def prefill(self, params, batch: Dict, *, max_seq: Optional[int] = None,
                window: int = 0, attn_backend: str = "auto"):
        kw = {"max_seq": max_seq, "window": window} if self._attn else {}
        return self._mod.prefill(params, batch["tokens"], self.cfg,
                                 backend=attn_backend, **kw)

    def decode_step(self, params, token, cache, *, window: int = 0,
                    attn_backend: str = "auto"):
        """One decode step.  ``attn_backend``: "auto" (CUDA: the Hopper
        dense decode kernel of every attention read; CPU: ``mha``), "kernel"
        or "plain".  The recurrent families' own step has no kernel."""
        if self._attn:
            return self._mod.decode_step(params, token, cache, self.cfg,
                                         window=window,
                                         attn_backend=attn_backend)
        return self._mod.decode_step(params, token, cache, self.cfg)

    def extend_step(self, params, tokens, cache, *, window: int = 0,
                    block_mask=None, q_positions=None,
                    attn_backend: str = "auto"):
        """Multi-token cached decode (chunked prefill, speculative verify).
        tokens (B,T) -> (logits (B,T,V), cache).  ``block_mask`` (T, C) and
        ``q_positions`` drive token trees (the Hopper tree-verify kernel on
        CUDA) and exist only for attention families: a recurrence is
        linear-order.  The recurrent families' extends run the SSD-scan
        kernel on CUDA."""
        cfg = self.cfg
        if cfg.family in KV_FAMILIES:
            return transformer.extend_step(params, tokens, cache, cfg,
                                           window=window,
                                           block_mask=block_mask,
                                           q_positions=q_positions,
                                           attn_backend=attn_backend)
        if block_mask is not None or q_positions is not None:
            raise ValueError(f"block_mask unsupported for family {cfg.family}")
        kw = {"window": window} if self._attn else {}
        return self._mod.extend_step(params, tokens, cache, cfg,
                                     backend=attn_backend, **kw)

    # ---------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_seq: int, device="cuda"):
        if self._attn:
            return self._mod.init_cache(self.cfg, batch_size, max_seq,
                                        device=device)
        return self._mod.init_cache(self.cfg, batch_size, device)

    @property
    def paged_kv(self) -> bool:
        """True if the cache is a pure self-attention KV cache that pages
        (shared block pool + block tables, see ``core/paged_cache.py``):
        the dense and moe families.  Recurrent state has no sequence axis
        to page."""
        return self.cfg.family in KV_FAMILIES

    def _require_paged(self):
        if not self.paged_kv:
            raise ValueError(f"paged KV cache unsupported for family "
                             f"{self.cfg.family!r} (KV-cache transformer "
                             "families only)")

    def init_paged_cache(self, num_blocks: int, block_size: int, batch: int,
                         max_blocks: int, device="cuda"):
        self._require_paged()
        return transformer.init_paged_cache(self.cfg, num_blocks, block_size,
                                            batch, max_blocks, device=device)

    def paged_decode_step(self, params, token, cache, *,
                          attn_backend: str = "auto"):
        """One decode step over a paged cache. token (B,1) -> (logits (B,V),
        cache).  ``attn_backend``: "auto" (CUDA: the Hopper paged-decode
        kernel; CPU: its plain version), "kernel", "plain", or "gather"
        (the full block-table gather, a test oracle)."""
        self._require_paged()
        return transformer.paged_decode_step(params, token, cache, self.cfg,
                                             attn_backend=attn_backend)

    def paged_extend_step(self, params, tokens, cache):
        """Multi-token cached decode over a paged cache. tokens (B,T) ->
        (logits (B,T,V), cache)."""
        self._require_paged()
        return transformer.paged_extend_step(params, tokens, cache, self.cfg)

    @property
    def rewindable_cache(self) -> bool:
        """True if the cache rolls back by resetting ``pos`` (KV caches);
        False for recurrent state, which rewinds by replaying the accepted
        prefix (``replay_step``)."""
        return self.cfg.family in KV_FAMILIES

    def rewind(self, cache, new_pos):
        assert self.rewindable_cache
        pos = cache["pos"]
        return {**cache, "pos": torch.as_tensor(new_pos, dtype=torch.int32,
                                                device=pos.device)}

    def replay_step(self, params, tokens, cache, count, *,
                    attn_backend: str = "auto"):
        """Recurrent-state rewind: re-advance ``cache`` through each slot's
        accepted prefix ``tokens[:, :count]`` of a padded draft tape
        (``count`` (B,) or () int32; 0 keeps a slot's cache) in one batched
        loop — the port of the JAX package's per-slot ``vmap``.  KV-cache
        families rewind via ``rewind`` instead."""
        if self.rewindable_cache:
            raise ValueError(f"replay_step is for recurrent-state families; "
                             f"{self.cfg.family!r} caches rewind via pos")
        count = torch.as_tensor(count, dtype=torch.int32,
                                device=tokens.device)
        kw = {"attn_backend": attn_backend} if self._attn else {}
        return self._mod.replay_step(params, tokens, cache, count, self.cfg,
                                     **kw)


# ---------------------------------------------------------------- batches
def example_batch(cfg: ModelConfig, batch: int, seq: int, gen=None,
                  with_labels: bool = True, device="cuda") -> Dict:
    """A random ``{"tokens", "labels"?}`` batch of int32 (batch, seq) on
    ``device``, drawn from the ``torch.Generator`` ``gen`` (seed 0 on
    ``device`` if None)."""
    device = torch.device(device)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                   generator=gen, device=device,
                                   dtype=torch.int32)}
    if with_labels:
        out["labels"] = torch.randint(0, cfg.vocab_size, (batch, seq),
                                      generator=gen, device=device,
                                      dtype=torch.int32)
    return out
