"""Model facade over the ported families: dense, moe, vlm (paligemma), ssm
(mamba2), xlstm, hybrid (zamba2) and encdec (whisper).

    m = Model(cfg)
    params = m.init(seed=0)                       # on CUDA unless told
    logits, aux = m.forward(params, {"tokens": tokens})
    loss = m.loss(params, {"tokens": tokens, "labels": labels})
    logits, cache = m.prefill(params, {"tokens": tokens}, max_seq=...)
    logits, cache = m.decode_step(params, token, cache)

Same entry points as the JAX package's ``Model``.  Parameters are the
``models.transformer.Transformer`` module for the dense, moe and vlm
families, ``models.encdec.EncDec`` for encdec and a ``layers.ParamTree``
for the recurrent ones.  ``attn_backend`` ("auto" | "kernel" | "plain")
picks the kernels' or the plain path of every entry that reaches a kernel.
``batch`` is a dict: {"tokens", "labels"?, "embeds"? (vlm stub, (B, P, d)),
"frames"? (encdec stub, (B, Se, d))}.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import (STUB_INPUTS, ModelConfig, stub_input,
                                      text_len)
from repro_torch.models import encdec, hybrid, ssm, transformer, xlstm


def nll_sum(logits, labels, ignore: int = -1):
    """(summed negative log-likelihood () f32, count () int64) of the
    labels (B, S) that are not ``ignore`` under logits (B, S, V) f32."""
    mask = labels != ignore
    lab = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab[..., None])[..., 0]
    return ((logz - gold) * mask).sum(), mask.sum()


def cross_entropy(logits, labels, ignore: int = -1):
    """logits (B, S, V) f32; labels (B, S) int.  Mean over the labels that
    are not ``ignore``."""
    nll, n = nll_sum(logits, labels, ignore)
    return nll / n.clamp(min=1)

FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "ssm": ssm, "xlstm": xlstm, "hybrid": hybrid, "encdec": encdec}
# KV-cache decoders (``transformer``'s families): they page, rewind by
# ``pos`` and take token trees
KV_FAMILIES = transformer.FAMILIES


def require_token_prompts(cfg, who: str) -> None:
    """Raise for a family whose prompts carry a stub input (vlm ``embeds``,
    encdec ``frames``): the serving engine prefills with tokens alone, as
    the JAX package's does (which fails there with a KeyError)."""
    if cfg.family in STUB_INPUTS:
        raise NotImplementedError(
            f"{who} cannot serve {cfg.name} (family {cfg.family!r}): the "
            "serving engine prefills with tokens alone and carries no "
            f"{STUB_INPUTS[cfg.family]!r}, as in the JAX package; the "
            "Model API (prefill, decode_step, extend_step) and the trainer "
            "serve this family")


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
        self.cfg = cfg
        self._mod = FAMILIES[cfg.family]
        # families with attention: a window keyword, a K/V cache to size
        self._attn = cfg.family in KV_FAMILIES + ("hybrid", "encdec")

    def _stub(self, batch: Dict) -> Dict:
        """The family's stub input as a keyword: ``embeds=`` (vlm),
        ``frames=`` (encdec), nothing otherwise."""
        key = STUB_INPUTS.get(self.cfg.family)
        return {key: batch[key]} if key else {}

    # ---------------------------------------------------------------- init
    def init(self, seed: int = 0, device="cuda", place=None):
        """Seeded random parameters on ``device`` (CUDA by default; pass
        ``device="cpu"`` explicitly for the CPU).  ``place`` (every
        family) cuts each leaf to a mesh rank's block as it is drawn:
        ``launch/sharding.init_placed``."""
        return self._mod.init_params(self.cfg, seed, device, place=place)

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
                                 collect_hidden=collect_hidden,
                                 **self._stub(batch), **kw)

    def loss(self, params, batch: Dict, *, window: int = 0,
             remat: bool = False, attn_backend: str = "auto"):
        """Next-token cross entropy of ``batch["labels"]`` (-1 ignored)
        plus the moe auxiliary loss, as the JAX package's ``Model.loss``;
        the vlm image-prefix rows carry no loss."""
        logits, aux = self.forward(params, batch, window=window, remat=remat,
                                   attn_backend=attn_backend)[:2]
        logits = self.text_rows(logits, batch)
        return cross_entropy(logits[:, :-1, :], batch["labels"][:, 1:]) + aux

    def text_rows(self, x, batch: Dict, dim: int = 1):
        """``x`` with the vlm image-prefix rows (the first P along ``dim``)
        sliced off; unchanged for every other family."""
        if self.cfg.family != "vlm":
            return x
        return x.narrow(dim, batch["embeds"].shape[1],
                        x.shape[dim] - batch["embeds"].shape[1])

    def prefill(self, params, batch: Dict, *, max_seq: Optional[int] = None,
                window: int = 0, attn_backend: str = "auto"):
        kw = {"max_seq": max_seq, "window": window} if self._attn else {}
        return self._mod.prefill(params, batch["tokens"], self.cfg,
                                 backend=attn_backend, **self._stub(batch),
                                 **kw)

    def decode_step(self, params, token, cache, *, window: int = 0,
                    attn_backend: str = "auto"):
        """One decode step.  ``attn_backend``: "auto" (CUDA: the Hopper
        dense decode kernel of every attention read; CPU: ``mha``), "kernel"
        or "plain".  The recurrent families' own step has no kernel; the
        encdec step's cross-attention reads the dense decode kernel too."""
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
        the dense, moe and vlm families.  Recurrent state has no sequence
        axis to page; encdec carries cross-attention K/V pinned to the
        encoder length."""
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

    def paged_extend_step(self, params, tokens, cache, *,
                          attn_backend: str = "auto"):
        """Multi-token cached decode over a paged cache. tokens (B,T) ->
        (logits (B,T,V), cache).  ``attn_backend`` reaches the vlm
        family's read (on CUDA the paged-decode kernel, one row per new
        token); the dense and moe families read through ``mha``."""
        self._require_paged()
        return transformer.paged_extend_step(params, tokens, cache, self.cfg,
                                             attn_backend=attn_backend)

    @property
    def kv_slabs(self) -> bool:
        """True if the cache carries attention K/V slabs ``k`` / ``v`` (a
        layer or group axis first, then the slot axis): every family but
        the pure recurrent ones (ssm, xlstm)."""
        return self._attn

    @property
    def rewindable_cache(self) -> bool:
        """True if the cache rolls back by resetting ``pos`` (KV caches);
        False for recurrent state, which rewinds by replaying the accepted
        prefix (``replay_step``)."""
        return self.cfg.family in KV_FAMILIES + ("encdec",)

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
    """A random ``{"tokens", "labels"?}`` batch of int32 (batch, s_text) on
    ``device`` plus the family's stub input in ``cfg.activ_dtype`` — vlm
    ``embeds`` (batch, num_image_tokens, d) with s_text = max(seq - P, 8),
    encdec ``frames`` (batch, encoder_seq, d), standard normal — as the
    JAX package's ``example_batch`` lays it out.  Drawn from the
    ``torch.Generator`` ``gen`` (seed 0 on ``device`` if None), tokens,
    labels, then the stub: the JAX package's distributions, not its
    draws."""
    device = torch.device(device)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
    s_text = text_len(cfg, seq)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, s_text),
                                   generator=gen, device=device,
                                   dtype=torch.int32)}
    if with_labels:
        out["labels"] = torch.randint(0, cfg.vocab_size, (batch, s_text),
                                      generator=gen, device=device,
                                      dtype=torch.int32)
    key, rows = stub_input(cfg)
    if key is not None:
        out[key] = torch.randn((batch, rows, cfg.d_model), generator=gen,
                               device=device) \
            .to(transformer.dtype_of(cfg.activ_dtype))
    return out
