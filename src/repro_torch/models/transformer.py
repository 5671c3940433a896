"""Decoder-only transformer, dense family.

The parameters live in an ``nn.Module`` per model (``Transformer``), laid
out as the JAX pytree: ``x @ w`` with ``w`` (in, out), one ``Block`` per
layer where JAX stacks them on ``L``; a Python loop over the layers stands
where JAX runs ``lax.scan``.  Caches are dicts of tensors shaped as the JAX
package's (``k``/``v`` with the layer axis first); K/V tensors are written
in place, and every step returns a NEW ``pos`` tensor.

The moe and vlm families are later slices of the port.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models import layers as L

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def require_dense(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the "
            "PyTorch port serves the dense family; moe, vlm, the recurrent "
            "families and encdec are later slices")


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One transformer layer: ``attn_norm``, ``attn`` {wq, wk, wv, wo},
    ``mlp_norm``, ``mlp`` {w_gate?, w_up, w_down}."""

    def __init__(self, attn_norm, attn, mlp_norm, mlp):
        super().__init__()
        self.attn_norm = _param(attn_norm)
        self.attn = nn.ParameterDict({k: _param(v) for k, v in attn.items()})
        self.mlp_norm = _param(mlp_norm)
        self.mlp = nn.ParameterDict({k: _param(v) for k, v in mlp.items()})


class Transformer(nn.Module):
    """Parameters of a dense decoder: ``embed`` (V, d), ``blocks``,
    ``final_norm`` and, when the head is untied, ``lm_head`` (V, d)."""

    def __init__(self, cfg, embed, blocks, final_norm, lm_head=None):
        super().__init__()
        require_dense(cfg)
        self.cfg = cfg
        self.embed = _param(embed)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = _param(final_norm)
        self.lm_head = None if lm_head is None else _param(lm_head)

    @property
    def head(self) -> torch.Tensor:
        return self.embed if self.lm_head is None else self.lm_head


# ----------------------------------------------------------------- init
def init_params(cfg, seed: int = 0, device="cuda") -> Transformer:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (same distributions as the JAX package's init, not the same draws)."""
    require_dense(cfg)
    dtype = dtype_of(cfg.param_dtype)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d = cfg.d_model
    blocks = [Block(torch.zeros(d, dtype=dtype, device=device),
                    L.init_attention(gen, cfg, dtype, device),
                    torch.zeros(d, dtype=dtype, device=device),
                    L.init_mlp(gen, cfg, dtype, device))
              for _ in range(cfg.num_layers)]
    embed = L.init_embedding(gen, cfg.vocab_size, d, dtype, device)
    head = None if cfg.tie_embeddings else \
        L.init_embedding(gen, cfg.vocab_size, d, dtype, device)
    return Transformer(cfg, embed, blocks,
                       torch.zeros(d, dtype=dtype, device=device), head)


# ----------------------------------------------------------------- blocks
def _mlp(blk, h, cfg):
    return L.mlp_block(blk.mlp, L.rmsnorm(h, blk.mlp_norm, cfg.norm_eps),
                       cfg.mlp_activation)


def _logits(params, h, cfg):
    logits = L.unembed(params.head, L.rmsnorm(h, params.final_norm,
                                              cfg.norm_eps))
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _layers(params, h, positions, cfg, window, backend, collect=None):
    """Full-sequence pass over every layer; yields each layer's (k, v)."""
    for blk in params.blocks:
        a, kv = L.attention_block(blk.attn,
                                  L.rmsnorm(h, blk.attn_norm, cfg.norm_eps),
                                  positions, cfg, window=window,
                                  backend=backend)
        h = h + a
        h = h + _mlp(blk, h, cfg)
        if collect is not None:
            collect.append(kv)
    return h


# ----------------------------------------------------------------- forward
def forward(params, tokens, cfg, *, window: int = 0, backend: str = "auto"):
    """Scoring forward pass.  tokens: (B, S) int.  Returns (logits
    (B, S, V) f32, aux_loss) — the dense family's aux loss is 0."""
    L.check_backend(backend)
    h = L.embed(params.embed, tokens).to(dtype_of(cfg.activ_dtype))
    positions = torch.arange(h.shape[1], device=h.device)
    h = _layers(params, h, positions, cfg, window or cfg.sliding_window,
                backend)
    return _logits(params, h, cfg), torch.zeros((), device=h.device)


# ----------------------------------------------------------------- cache
def init_cache(cfg, batch: int, max_seq: int, dtype=None, device="cuda"):
    dtype = dtype or dtype_of(cfg.param_dtype)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def init_paged_cache(cfg, num_blocks: int, block_size: int, batch: int,
                     max_blocks: int, dtype=None, device="cuda"):
    """Paged twin of ``init_cache``: ONE (num_blocks, block_size) K/V pool
    per layer shared by all ``batch`` sequences, a per-sequence block table
    (padded with the trap block 0) and per-sequence write positions."""
    dtype = dtype or dtype_of(cfg.param_dtype)
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "table": torch.zeros((batch, max_blocks), dtype=torch.int32,
                             device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def paged_decode_step(params, token, cache, cfg, *,
                      attn_backend: str = "auto"):
    """One decode step over a paged cache. token: (B, 1) int; cache as
    built by ``init_paged_cache``.  Returns (logits (B, V), cache).

    The attention read dispatches per ``attn_backend`` (see
    ``layers.paged_decode_attention_block``: the Hopper paged-decode kernel
    on CUDA); only ``"gather"`` keeps the general T=1 ``paged_extend_step``
    path, the parity oracle for tests."""
    L.check_backend(attn_backend)
    if attn_backend == "gather":
        logits, cache = paged_extend_step(params, token, cache, cfg)
        return logits[:, 0], cache
    h = L.embed(params.embed, token).to(dtype_of(cfg.activ_dtype))
    pos, table = cache["pos"], cache["table"]
    for l, blk in enumerate(params.blocks):
        a, _, _ = L.paged_decode_attention_block(
            blk.attn, L.rmsnorm(h, blk.attn_norm, cfg.norm_eps),
            cache["k"][l], cache["v"][l], table, pos, cfg,
            backend=attn_backend)
        h = h + a
        h = h + _mlp(blk, h, cfg)
    return _logits(params, h[:, 0, :], cfg), {**cache, "pos": pos + 1}


def paged_extend_step(params, tokens, cache, cfg):
    """Multi-token cached decode over a paged cache (speculative verify).
    tokens (B, T) -> (logits (B, T, V), cache)."""
    h = L.embed(params.embed, tokens).to(dtype_of(cfg.activ_dtype))
    pos, table = cache["pos"], cache["table"]
    for l, blk in enumerate(params.blocks):
        a, _, _ = L.paged_extend_attention(
            blk.attn, L.rmsnorm(h, blk.attn_norm, cfg.norm_eps),
            cache["k"][l], cache["v"][l], table, pos, cfg)
        h = h + a
        h = h + _mlp(blk, h, cfg)
    return _logits(params, h, cfg), {**cache,
                                     "pos": pos + tokens.shape[1]}


def prefill(params, tokens, cfg, *, max_seq: Optional[int] = None,
            window: int = 0, backend: str = "auto"):
    """Run the prompt, build the KV cache.  tokens (B, S).  Returns
    (last-token logits (B, V), cache padded to ``max_seq`` entries)."""
    L.check_backend(backend)
    h = L.embed(params.embed, tokens).to(dtype_of(cfg.activ_dtype))
    B, S = tokens.shape
    max_seq = max(max_seq or S, S)
    positions = torch.arange(S, device=h.device)
    kvs = []
    h = _layers(params, h, positions, cfg, window or cfg.sliding_window,
                backend, kvs)
    logits = _logits(params, h[:, -1, :], cfg)
    cache = init_cache(cfg, B, max_seq, device=h.device)
    for l, (k, v) in enumerate(kvs):
        cache["k"][l, :, :S] = k
        cache["v"][l, :, :S] = v
    cache["pos"] = torch.full((), S, dtype=torch.int32, device=h.device)
    return logits, cache


def _cached(params, tokens, cache, cfg, attend):
    h = L.embed(params.embed, tokens).to(dtype_of(cfg.activ_dtype))
    for l, blk in enumerate(params.blocks):
        a, _, _ = attend(blk.attn, L.rmsnorm(h, blk.attn_norm, cfg.norm_eps),
                         cache["k"][l], cache["v"][l])
        h = h + a
        h = h + _mlp(blk, h, cfg)
    return h


def extend_step(params, tokens, cache, cfg, *, window: int = 0):
    """Multi-token cached decode over a dense cache (pos () or (B,)).
    tokens (B,T) -> (logits (B,T,V), cache)."""
    pos = cache["pos"]
    win = window or cfg.sliding_window
    h = _cached(params, tokens, cache, cfg,
                lambda p, x, ck, cv: L.extend_attention(p, x, ck, cv, pos,
                                                        cfg, window=win))
    return _logits(params, h, cfg), {**cache, "pos": pos + tokens.shape[1]}


def decode_step(params, token, cache, cfg, *, window: int = 0):
    """One decode step over a dense cache (pos () or (B,)). token: (B, 1).
    Returns (logits (B,V), cache)."""
    pos = cache["pos"]
    win = window or cfg.sliding_window
    h = _cached(params, token, cache, cfg,
                lambda p, x, ck, cv: L.decode_attention(p, x, ck, cv, pos,
                                                        cfg, window=win))
    return _logits(params, h[:, 0, :], cfg), {**cache, "pos": pos + 1}
