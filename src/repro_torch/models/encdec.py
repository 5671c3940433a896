"""Whisper-style encoder-decoder (arXiv:2212.04356), the encdec family: the
port of the JAX package's ``models/encdec.py``.

The mel-spectrogram + conv feature extractor is a stub, as in the JAX
package: the encoder consumes precomputed frame embeddings (B, Se, d).
Learned positional embeddings, GELU MLPs, pre-LayerNorm blocks.

The parameters live in an ``EncDec`` module laid out as the JAX pytree:
``enc_pos`` (encoder_seq, d), ``dec_pos`` (max_position_embeddings, d),
``embed`` (V, d, the tied head), ``encoder`` and ``decoder`` (one block
per layer where JAX stacks them on L), ``enc_norm_w/b`` and
``final_norm_w/b``.  A block holds ``attn_norm_w/b``, ``attn`` {wq, wk, wv,
wo}, ``mlp_norm_w/b`` and ``mlp`` {w_up, w_down}; a decoder block also
``cross_norm_w/b`` and ``cross`` {wq, wk, wv, wo}.

Caches keep JAX's keys and shapes: ``k``/``v`` (L, B, max_seq, Kv, hd) for
the decoder's self-attention, ``ck``/``cv`` (L, B, Se, Kv, hd) for the
cross-attention over the encoder output, ``pos`` ().  K/V tensors are
written in place and every step returns a new ``pos``.  On CUDA the
encoder's non-causal attention, the decoder's causal attention and the
cross-attention of the prefill, extend and forward run the flash kernel
(forward and backward under grad), an extend's self-attention the
tree-verify kernel under a causal block mask, and a decode step's self-
and cross-attention the dense decode kernel.

The entry points take the keywords of the other attention families'
(``window``, ``attn_backend``/``backend``) so that ``Model`` dispatches
to every family alike; the family has no sliding window, and a nonzero
``window`` raises.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.layers import ParamTree
from repro_torch.models.transformer import dtype_of


# the JAX pytree's top-level keys, in its order
TOP = ("enc_pos", "dec_pos", "embed", "encoder", "decoder", "enc_norm_w",
       "enc_norm_b", "final_norm_w", "final_norm_b")


def _sorted(block):
    """A block dict with its keys sorted at every level, as the JAX
    package's stacked blocks hold them."""
    return {k: _sorted(v) if isinstance(v, dict) else v
            for k, v in sorted(block.items())}


class EncDec(ParamTree):
    """Parameters of a whisper-style encoder-decoder (module docstring),
    registered in the JAX pytree's order, one ``ParamTree`` per layer."""

    def __init__(self, cfg, tree):
        if cfg.family != "encdec":
            raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) "
                                      "is not an encoder-decoder")
        if set(tree) != set(TOP):
            raise ValueError(f"an encdec tree has the keys {TOP}, got "
                             f"{tuple(tree)}")
        for key, n in (("encoder", cfg.encoder_layers),
                       ("decoder", cfg.num_layers)):
            if len(tree[key]) != n:
                raise ValueError(f"{key}: {len(tree[key])} blocks, config "
                                 f"{cfg.name} has {n}")
        super().__init__({k: [_sorted(b) for b in tree[k]]
                          if k in ("encoder", "decoder") else tree[k]
                          for k in TOP})
        self.cfg = cfg

    @property
    def head(self) -> torch.Tensor:
        return self.embed


# ----------------------------------------------------------------- init
def init_params(cfg, seed: int = 0, device="cuda") -> EncDec:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (the JAX package's distributions, not its draws)."""
    dtype = dtype_of(cfg.param_dtype)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d = cfg.d_model

    def ones():
        return torch.ones(d, dtype=dtype, device=device)

    def zeros():
        return torch.zeros(d, dtype=dtype, device=device)

    def block(cross: bool):
        blk = {"attn_norm_w": ones(), "attn_norm_b": zeros(),
               "attn": L.init_attention(gen, cfg, dtype, device),
               "mlp_norm_w": ones(), "mlp_norm_b": zeros(),
               "mlp": L.init_mlp(gen, cfg, dtype, device)}
        if cross:
            blk.update(cross_norm_w=ones(), cross_norm_b=zeros(),
                       cross=L.init_attention(gen, cfg, dtype, device))
        return blk

    enc = [block(False) for _ in range(cfg.encoder_layers)]
    dec = [block(True) for _ in range(cfg.num_layers)]
    return EncDec(cfg, {
        "enc_pos": L.dense_init(gen, (cfg.encoder_seq, d), dtype=dtype,
                                device=device),
        "dec_pos": L.dense_init(gen, (cfg.max_position_embeddings, d),
                                dtype=dtype, device=device),
        "embed": L.init_embedding(gen, cfg.vocab_size, d, dtype, device),
        "encoder": enc, "decoder": dec,
        "enc_norm_w": ones(), "enc_norm_b": zeros(),
        "final_norm_w": ones(), "final_norm_b": zeros()})


def _no_window(window: int) -> None:
    if window:
        raise ValueError(f"the encdec family has no sliding window, got "
                         f"window={window}")


# ----------------------------------------------------------------- blocks
def _ln(h, p, name):
    return L.layernorm(h, p[f"{name}_w"], p[f"{name}_b"])


def _mlp(blk, h, cfg):
    return L.mlp_block(blk.mlp, _ln(h, blk, "mlp_norm"), cfg.mlp_activation)


def encode(params, frames, cfg, *, backend: str = "auto"):
    """frames: (B, Se, d) precomputed embeddings -> (B, Se, d): the encoder
    (non-causal attention) and its final layernorm."""
    Se = frames.shape[1]
    h = frames.to(dtype_of(cfg.activ_dtype)) + params.enc_pos[None, :Se]
    positions = torch.arange(Se, device=h.device)
    for blk in params.encoder:
        a, _ = L.attention_block(blk.attn, _ln(h, blk, "attn_norm"),
                                 positions, cfg, causal=False,
                                 backend=backend)
        h = h + a
        h = h + _mlp(blk, h, cfg)
    return _ln(h, params, "enc_norm")


def _dec_block(blk, h, positions, cfg, ck, cv, backend):
    a, kv = L.attention_block(blk.attn, _ln(h, blk, "attn_norm"), positions,
                              cfg, backend=backend)
    h = h + a
    h = h + L.cross_attention(blk.cross, _ln(h, blk, "cross_norm"), ck, cv,
                              cfg, backend=backend)
    return h + _mlp(blk, h, cfg), kv


def _logits(params, h):
    return L.unembed(params.embed, _ln(h, params, "final_norm"))


def _dec_embed(params, tokens, cfg, start):
    """Token embeddings plus the decoder positions [start, start + T):
    ``start`` an int or a () / (B,) tensor, clamped to [0, P - T] like
    ``lax.dynamic_slice_in_dim`` (P = max_position_embeddings)."""
    T = tokens.shape[1]
    h = L.embed(params.embed, tokens).to(dtype_of(cfg.activ_dtype))
    if isinstance(start, int):
        return h + params.dec_pos[None, start:start + T]
    first = start.long().clamp(0, params.dec_pos.shape[0] - T)
    idx = first[..., None] + torch.arange(T, device=h.device)
    pe = params.dec_pos[idx]
    return h + (pe[None] if pe.dim() == 2 else pe)


# ----------------------------------------------------------------- forward
def forward(params, tokens, cfg, *, frames, window: int = 0,
            backend: str = "auto", remat: bool = False,
            collect_hidden: bool = False):
    """Teacher-forced decoder logits.  tokens (B, Sd); frames (B, Se, d).
    Returns (logits (B, Sd, V) f32, aux 0.0) and, with ``collect_hidden``,
    the decoder layers' outputs (L, B, Sd, d).  ``remat`` recomputes each
    decoder block (its cross K/V included) in the backward, as JAX's
    ``jax.checkpoint`` of the scan body does."""
    L.check_backend(backend)
    _no_window(window)
    enc = encode(params, frames, cfg, backend=backend)
    h = _dec_embed(params, tokens, cfg, 0)
    positions = torch.arange(tokens.shape[1], device=h.device)

    def body(x, blk):
        ck, cv = L.cross_attention_kv(blk.cross, enc, cfg)
        return _dec_block(blk, x, positions, cfg, ck, cv, backend)[0]

    hidden = []
    for blk in params.decoder:
        h = checkpoint(body, h, blk, use_reentrant=False) if remat \
            else body(h, blk)
        if collect_hidden:
            hidden.append(h)
    out = (_logits(params, h), torch.zeros((), device=h.device))
    return out + (torch.stack(hidden),) if collect_hidden else out


# ----------------------------------------------------------------- cache
def init_cache(cfg, batch: int, max_seq: int, dtype=None, device="cuda"):
    dtype = dtype or dtype_of(cfg.param_dtype)
    Ld, Kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    self_shape = (Ld, batch, max_seq, Kv, hd)
    cross_shape = (Ld, batch, cfg.encoder_seq, Kv, hd)
    return {
        "k": torch.zeros(self_shape, dtype=dtype, device=device),
        "v": torch.zeros(self_shape, dtype=dtype, device=device),
        "ck": torch.zeros(cross_shape, dtype=dtype, device=device),
        "cv": torch.zeros(cross_shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def prefill(params, tokens, cfg, *, frames, max_seq: Optional[int] = None,
            window: int = 0, backend: str = "auto"):
    """Encode, run the decoder prompt, build the self- and cross-attention
    caches.  Returns (last-row logits (B, V), cache with the self K/V
    padded to ``max_seq`` entries)."""
    L.check_backend(backend)
    _no_window(window)
    if frames.shape[1] != cfg.encoder_seq:
        raise ValueError(f"frames hold {frames.shape[1]} rows; the cross "
                         f"cache of {cfg.name} holds encoder_seq = "
                         f"{cfg.encoder_seq}")
    enc = encode(params, frames, cfg, backend=backend)
    B, Sd = tokens.shape
    h = _dec_embed(params, tokens, cfg, 0)
    positions = torch.arange(Sd, device=h.device)
    cache = init_cache(cfg, B, max(max_seq or Sd, Sd), device=h.device)
    for l, blk in enumerate(params.decoder):
        ck, cv = L.cross_attention_kv(blk.cross, enc, cfg)
        h, (k, v) = _dec_block(blk, h, positions, cfg, ck, cv, backend)
        cache["k"][l, :, :Sd] = k
        cache["v"][l, :, :Sd] = v
        cache["ck"][l] = ck
        cache["cv"][l] = cv
    cache["pos"] = torch.full((), Sd, dtype=torch.int32, device=h.device)
    return _logits(params, h[:, -1, :]), cache


def _cached(params, tokens, cache, cfg, attend, backend):
    """The decoder over ``tokens`` at the cache's ``pos``: ``attend`` is the
    self-attention read (decode or extend), the cross-attention reads
    ``ck``/``cv``."""
    h = _dec_embed(params, tokens, cfg, cache["pos"])
    for l, blk in enumerate(params.decoder):
        a, _, _ = attend(blk.attn, _ln(h, blk, "attn_norm"), cache["k"][l],
                         cache["v"][l])
        h = h + a
        h = h + L.cross_attention(blk.cross, _ln(h, blk, "cross_norm"),
                                  cache["ck"][l], cache["cv"][l], cfg,
                                  backend=backend)
        h = h + _mlp(blk, h, cfg)
    return h


def extend_step(params, tokens, cache, cfg, *, window: int = 0,
                backend: str = "auto"):
    """Multi-token cached decode on the decoder side. tokens (B, T) ->
    (logits (B, T, V), cache).  On CUDA the self-attention reads the
    tree-verify kernel under a causal block mask."""
    L.check_backend(backend)
    _no_window(window)
    pos = cache["pos"]
    mask = L.kernel_extend_mask(tokens.shape[1], tokens, backend)
    h = _cached(params, tokens, cache, cfg,
                lambda p, x, ck, cv: L.extend_attention(
                    p, x, ck, cv, pos, cfg, block_mask=mask,
                    backend=backend), backend)
    return _logits(params, h), {**cache, "pos": pos + tokens.shape[1]}


def decode_step(params, token, cache, cfg, *, window: int = 0,
                attn_backend: str = "auto"):
    """One decode step. token (B, 1) -> (logits (B, V), cache)."""
    L.check_backend(attn_backend)
    _no_window(window)
    pos = cache["pos"]
    h = _cached(params, token, cache, cfg,
                lambda p, x, ck, cv: L.decode_attention(
                    p, x, ck, cv, pos, cfg, backend=attn_backend),
                attn_backend)
    return _logits(params, h[:, 0, :]), {**cache, "pos": pos + 1}
