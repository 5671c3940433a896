"""Decoder-only transformer, dense, moe and vlm families.

The parameters live in an ``nn.Module`` per model (``Transformer``), laid
out as the JAX pytree: ``x @ w`` with ``w`` (in, out), one ``Block`` per
layer where JAX stacks them on ``L``; a Python loop over the layers stands
where JAX runs ``lax.scan``.  Caches are dicts of tensors shaped as the JAX
package's (``k``/``v`` with the layer axis first); K/V tensors are written
in place, and every step returns a NEW ``pos`` tensor.

A moe layer carries a ``moe`` parameter dict (``router``, ``w_gate``,
``w_up``, ``w_down``; ``models/moe.py``) where a dense one carries ``mlp``,
and every entry point runs ``moe_apply`` in its place, as the JAX package
does; ``forward`` returns the layers' summed auxiliary loss.  The vlm
family is the dense decoder with a stub image prefix: ``forward`` and
``prefill`` take ``embeds`` (B, P, d), prepend it to the token embeddings
and attend over it bidirectionally (prefix-LM: ``prefix_len = P`` in every
block, the flash kernels' ``prefix_len`` on CUDA); the cached steps are
the dense ones, except that on CUDA its linear extends read through
kernels (``KERNEL_EXTENDS``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


FAMILIES = ("dense", "moe", "vlm")
# families whose linear extends (no block mask) read through kernels on
# CUDA: the tree-verify kernel under a causal (T, T) block mask, and the
# paged-decode kernel over one row per new token.  The dense and moe
# extends keep ``mha`` (ROADMAP A.10): the serving engine's chunked prefill
# extends them by up to a tick's tokens, whose (T, T) mask outgrows the
# tree kernel's shared memory.
KERNEL_EXTENDS = ("vlm",)


def require_dense(cfg) -> None:
    """Raise unless ``cfg`` is a dense, moe or vlm decoder, the families
    this module serves."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not a decoder-only "
            "transformer: this module serves the dense, moe and vlm "
            "families (the recurrent families and encdec have their own "
            "modules)")


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One transformer layer: ``attn_norm``, ``attn`` {wq, wk, wv, wo},
    ``mlp_norm`` and either ``mlp`` {w_gate?, w_up, w_down} (dense) or
    ``moe`` {router, w_gate, w_up, w_down} (moe; the other is None)."""

    def __init__(self, attn_norm, attn, mlp_norm, mlp=None, moe=None):
        super().__init__()
        if (mlp is None) == (moe is None):
            raise ValueError("a block carries exactly one of mlp and moe")
        self.attn_norm = _param(attn_norm)
        self.attn = nn.ParameterDict({k: _param(v) for k, v in attn.items()})
        self.mlp_norm = _param(mlp_norm)
        self.mlp = None if mlp is None else \
            nn.ParameterDict({k: _param(v) for k, v in mlp.items()})
        self.moe = None if moe is None else \
            nn.ParameterDict({k: _param(v) for k, v in moe.items()})


class Transformer(nn.Module):
    """Parameters of a dense, moe or vlm decoder: ``embed`` (V, d), ``blocks``,
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
    (same distributions as the JAX package's init, not the same draws; a
    moe router is float32 whatever ``cfg.param_dtype`` says, as there)."""
    require_dense(cfg)
    dtype = dtype_of(cfg.param_dtype)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d = cfg.d_model

    def ffn():
        if cfg.family == "moe":
            return {"moe": MOE.init_moe(gen, cfg, dtype, device)}
        return {"mlp": L.init_mlp(gen, cfg, dtype, device)}

    blocks = [Block(torch.zeros(d, dtype=dtype, device=device),
                    L.init_attention(gen, cfg, dtype, device),
                    torch.zeros(d, dtype=dtype, device=device), **ffn())
              for _ in range(cfg.num_layers)]
    embed = L.init_embedding(gen, cfg.vocab_size, d, dtype, device)
    head = None if cfg.tie_embeddings else \
        L.init_embedding(gen, cfg.vocab_size, d, dtype, device)
    return Transformer(cfg, embed, blocks,
                       torch.zeros(d, dtype=dtype, device=device), head)


# ----------------------------------------------------------------- blocks
def _ffn(blk, h, cfg):
    """The layer's feed-forward half on the normed residual: (out, aux
    loss) — ``moe_apply`` for a moe block, the MLP (aux 0) otherwise."""
    hn = L.rmsnorm(h, blk.mlp_norm, cfg.norm_eps)
    if blk.moe is not None:
        return MOE.moe_apply(blk.moe, hn, cfg)
    return L.mlp_block(blk.mlp, hn, cfg.mlp_activation), None


def _mlp(blk, h, cfg):
    return _ffn(blk, h, cfg)[0]


def _logits(params, h, cfg):
    logits = L.unembed(params.head, L.rmsnorm(h, params.final_norm,
                                              cfg.norm_eps))
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _block(blk, h, positions, cfg, window, backend, prefix_len=0):
    """One layer over the full sequence: (h, aux loss or None, (k, v))."""
    a, kv = L.attention_block(blk.attn,
                              L.rmsnorm(h, blk.attn_norm, cfg.norm_eps),
                              positions, cfg, window=window,
                              prefix_len=prefix_len, backend=backend)
    h = h + a
    m, a_l = _ffn(blk, h, cfg)
    return h + m, a_l, kv


def _layers(params, h, positions, cfg, window, backend, collect=None,
            remat: bool = False, hidden=None, prefix_len: int = 0):
    """Full-sequence pass over every layer; appends each layer's (k, v) to
    ``collect`` and its output to ``hidden``.  Returns (h, summed aux loss
    () f32).  ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
    activations — JAX's ``jax.checkpoint`` per block."""
    aux = torch.zeros((), device=h.device)
    for blk in params.blocks:
        if remat:
            h, a_l = checkpoint(
                lambda x, b=blk: _block(b, x, positions, cfg, window,
                                        backend, prefix_len)[:2], h,
                use_reentrant=False)
        else:
            h, a_l, kv = _block(blk, h, positions, cfg, window, backend,
                                prefix_len)
            if collect is not None:
                collect.append(kv)
        if hidden is not None:
            hidden.append(h)
        if a_l is not None:
            aux = aux + a_l
    return h, aux


def _embed(params, tokens, cfg, embeds):
    """Token embeddings in the activation dtype, the vlm ``embeds`` (B, P,
    d) prepended: (h, prefix_len)."""
    h = L.embed(params.embed, tokens).to(dtype_of(cfg.activ_dtype))
    if embeds is None:
        return h, 0
    return torch.cat([embeds.to(h.dtype), h], dim=1), embeds.shape[1]


# ----------------------------------------------------------------- forward
def forward(params, tokens, cfg, *, embeds=None, window: int = 0,
            backend: str = "auto", remat: bool = False,
            collect_hidden: bool = False):
    """Scoring / training forward pass.  tokens: (B, S_text) int; for vlm
    ``embeds`` (B, P, d) is prepended (prefix-LM attention over it).
    Returns (logits (B, S, V) f32 over all S = P + S_text rows, aux_loss) —
    the moe layers' summed load-balance loss, 0 for the dense family — and
    every layer's output (L, B, S, d) if ``collect_hidden``.  ``remat``:
    recompute each block in the backward."""
    L.check_backend(backend)
    h, prefix_len = _embed(params, tokens, cfg, embeds)
    positions = torch.arange(h.shape[1], device=h.device)
    hidden = [] if collect_hidden else None
    h, aux = _layers(params, h, positions, cfg, window or cfg.sliding_window,
                     backend, remat=remat, hidden=hidden,
                     prefix_len=prefix_len)
    out = (_logits(params, h, cfg), aux)
    return out + (torch.stack(hidden),) if collect_hidden else out


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
        logits, cache = paged_extend_step(params, token, cache, cfg,
                                          attn_backend="gather")
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


def paged_extend_step(params, tokens, cache, cfg, *,
                      attn_backend: str = "auto"):
    """Multi-token cached decode over a paged cache (speculative verify).
    tokens (B, T) -> (logits (B, T, V), cache).  ``attn_backend`` as in
    ``layers.paged_extend_attention`` for the ``KERNEL_EXTENDS`` families;
    the others read the table's gather through ``mha``."""
    L.check_backend(attn_backend)
    backend = attn_backend if cfg.family in KERNEL_EXTENDS else "plain"
    h = L.embed(params.embed, tokens).to(dtype_of(cfg.activ_dtype))
    pos, table = cache["pos"], cache["table"]
    for l, blk in enumerate(params.blocks):
        a, _, _ = L.paged_extend_attention(
            blk.attn, L.rmsnorm(h, blk.attn_norm, cfg.norm_eps),
            cache["k"][l], cache["v"][l], table, pos, cfg, backend=backend)
        h = h + a
        h = h + _mlp(blk, h, cfg)
    return _logits(params, h, cfg), {**cache,
                                     "pos": pos + tokens.shape[1]}


def prefill(params, tokens, cfg, *, max_seq: Optional[int] = None,
            embeds=None, window: int = 0, backend: str = "auto"):
    """Run the prompt, build the KV cache.  tokens (B, S_text); for vlm
    ``embeds`` (B, P, d) is prepended as in ``forward`` and the cache holds
    all S = P + S_text rows.  Returns (last-token logits (B, V), cache
    padded to ``max_seq`` entries)."""
    L.check_backend(backend)
    h, prefix_len = _embed(params, tokens, cfg, embeds)
    B, S = h.shape[:2]
    max_seq = max(max_seq or S, S)
    positions = torch.arange(S, device=h.device)
    kvs = []
    h, _ = _layers(params, h, positions, cfg, window or cfg.sliding_window,
                   backend, kvs, prefix_len=prefix_len)
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


def extend_step(params, tokens, cache, cfg, *, window: int = 0,
                block_mask=None, q_positions=None, attn_backend: str = "auto"):
    """Multi-token cached decode over a dense cache (pos () or (B,)).
    tokens (B,T) -> (logits (B,T,V), cache).  ``block_mask`` (T, C), C >= T,
    customizes intra-block attention (its last T columns are the new
    tokens, earlier columns cover tree rows already in the cache — see
    ``layers.extend_attention``; on CUDA the Hopper tree-verify kernel);
    ``q_positions`` ((T,) or (B,T)) overrides the RoPE positions.  A
    ``KERNEL_EXTENDS`` family's linear extend takes the tree-verify kernel
    too, under a causal block mask."""
    L.check_backend(attn_backend)
    pos = cache["pos"]
    win = window or cfg.sliding_window
    if block_mask is not None:
        block_mask = block_mask.bool().contiguous()
    elif q_positions is None and cfg.family in KERNEL_EXTENDS:
        block_mask = L.kernel_extend_mask(tokens.shape[1], tokens,
                                          attn_backend)
    h = _cached(params, tokens, cache, cfg,
                lambda p, x, ck, cv: L.extend_attention(
                    p, x, ck, cv, pos, cfg, window=win,
                    block_mask=block_mask, q_positions=q_positions,
                    backend=attn_backend))
    return _logits(params, h, cfg), {**cache, "pos": pos + tokens.shape[1]}


def decode_step(params, token, cache, cfg, *, window: int = 0,
                attn_backend: str = "auto"):
    """One decode step over a dense cache (pos () or (B,)). token: (B, 1).
    Returns (logits (B,V), cache).  ``attn_backend`` as in
    ``layers.decode_attention``: on CUDA the Hopper dense decode kernel."""
    L.check_backend(attn_backend)
    pos = cache["pos"]
    win = window or cfg.sliding_window
    h = _cached(params, token, cache, cfg,
                lambda p, x, ck, cv: L.decode_attention(
                    p, x, ck, cv, pos, cfg, window=win,
                    backend=attn_backend))
    return _logits(params, h[:, 0, :], cfg), {**cache, "pos": pos + 1}
