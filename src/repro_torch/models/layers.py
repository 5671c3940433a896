"""Shared neural-net layers (plain functions on tensors), and the
``ParamTree`` that holds the recurrent families' parameters.

Conventions, as in the JAX package's ``models/layers.py``:
  * weights are stored for ``x @ w`` with ``w`` shaped (in, out); a layer's
    parameters come as a dict-like (``nn.ParameterDict``) keyed like the
    JAX pytree (``p["wq"]`` ...);
  * activations run in ``cfg.activ_dtype``; softmax/normalization in f32;
  * attention layout: q (B, S, H, hd); kv (B, S, Kv, hd); GQA groups
    G = H/Kv with head ``h = kv*G + g``;
  * masked scores are -1e30, never -inf, so a fully masked row is uniform.

Where JAX returns a new cache array, the functions here write the caller's
cache tensors IN PLACE (and return them for symmetry); ``pos`` tensors are
never mutated, so a ``pos`` snapshot stays valid.  JAX's index semantics are
reproduced explicitly: dense cache writes clamp their start like
``lax.dynamic_update_slice``, and paged writes past the block table are
dropped like JAX's out-of-range scatter.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  paged_decode_attention_cuda,
                                                  paged_decode_attention_plain)
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.tree_attention import tree_verify_attention_cuda

NEG = -1e30
# attention read paths: "auto" runs the Hopper kernel on CUDA tensors and the
# plain version on CPU ones; "kernel" insists on the kernel (raises on CPU);
# "plain" forces the plain PyTorch path on any device (the parity oracle);
# "gather" is the paged decode's full block-table gather (transformer.py)
BACKENDS = ("auto", "kernel", "plain", "gather")


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; known: "
                         f"{' | '.join(BACKENDS)}")


class ParamTree(nn.Module):
    """Frozen parameters nested like the JAX pytree: built from a dict whose
    values are tensors, dicts (sub-trees) or lists of dicts (an
    ``nn.ModuleList`` of sub-trees, e.g. per-layer blocks).  ``p["name"]``
    and ``p.name`` read the same entry, so layer code indexes it as the JAX
    package indexes its dicts."""

    def __init__(self, tree):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(x) for x in val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key):
        return getattr(self, key)


# ----------------------------------------------------------------- init utils
def dense_init(gen, shape, scale: float = 1.0, dtype=torch.float32,
               device="cuda"):
    # fan_in is the next-to-last dim for matrices / batched matrices (E,d,f).
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    std = scale / np.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def init_embedding(gen, vocab: int, d: int, dtype, device="cuda"):
    # std 0.02, GPT-style; keeps tied-head logits O(1) at init for any vocab.
    return (torch.randn((vocab, d), generator=gen, device=device)
            * 0.02).to(dtype)


def init_attention(gen, cfg, dtype, device="cuda"):
    d, hd, H, Kv = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": dense_init(gen, (d, H * hd), dtype=dtype, device=device),
        "wk": dense_init(gen, (d, Kv * hd), dtype=dtype, device=device),
        "wv": dense_init(gen, (d, Kv * hd), dtype=dtype, device=device),
        "wo": dense_init(gen, (H * hd, d), dtype=dtype, device=device),
    }


def init_mlp(gen, cfg, dtype, device="cuda"):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_activation in ("silu", "geglu"):
        return {
            "w_gate": dense_init(gen, (d, f), dtype=dtype, device=device),
            "w_up": dense_init(gen, (d, f), dtype=dtype, device=device),
            "w_down": dense_init(gen, (f, d), dtype=dtype, device=device),
        }
    return {   # relu2 / gelu: single up projection
        "w_up": dense_init(gen, (d, f), dtype=dtype, device=device),
        "w_down": dense_init(gen, (f, d), dtype=dtype, device=device),
    }


# ----------------------------------------------------------------- norms
def rmsnorm(x, weight, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)


def layernorm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm with weight and bias, in f32 (the encdec family)."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


def groupnorm_heads(x, weight, eps: float = 1e-5):
    """Per-head group norm of the xLSTM cell outputs. x: (..., H, hd)."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float()).to(dt)


# ----------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float = 10_000.0):
    # float64 on the host, as the JAX package computes them
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _freqs_on(head_dim: int, theta: float, device: torch.device):
    """``rope_freqs`` as a float32 tensor on ``device``, made once: a host
    array copied to the card on every call would stall the stream (a copy
    from pageable memory waits for the queued work)."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (B, S, H, hd); positions: (S,) or (B, S) integer tensor.
    Split-half rotation in f32."""
    hd = x.shape[-1]
    freqs = _freqs_on(hd, float(theta), x.device)
    if positions.dim() == 1:
        ang = positions[:, None].float() * freqs[None, :]        # (S, hd/2)
        ang = ang[None, :, None, :]                               # (1,S,1,hd/2)
    else:
        ang = positions[..., None].float() * freqs                # (B,S,hd/2)
        ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention
def _attn_mask(q_pos, k_pos, *, causal: bool, window: int,
               prefix_len: int = 0):
    """Boolean mask (Sq, Sk): True = attend.  ``prefix_len`` (prefix-LM:
    the first keys are visible to every query) counts only under
    ``causal``."""
    m = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = k_pos[None, :] <= q_pos[:, None]
        if prefix_len:
            m = m | (k_pos[None, :] < prefix_len)
    if window:
        m = m & (k_pos[None, :] > q_pos[:, None] - window)
    return m


def mha(q, k, v, mask=None, softcap: float = 0.0):
    """q: (B,Sq,H,hd), k/v: (B,Sk,Kv,hd); ``mask`` broadcasts against the
    (B, Kv, G, Sq, Sk) scores.  Returns (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    qf = q.reshape(B, Sq, Kv, G, hd).float()
    scores = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) / math.sqrt(hd)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    if mask is not None:
        scores = torch.where(mask, scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def mha_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                prefix_len: int = 0, bq: int = 512, bk: int = 512):
    """Chunked attention with an online softmax over (bq, bk) blocks, the
    twin of the JAX package's ``mha_chunked``: memory O(bq * bk) per step
    instead of O(Sq * Sk).  Every block is computed, fully masked ones
    included, with the -1e30 fill.

    q: (B,Sq,H,hd); k/v: (B,Sk,Kv,hd).  Returns (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    bq, bk = min(bq, Sq), min(bk, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"Sq {Sq} / Sk {Sk} must divide by bq {bq} / bk {bk}")
    scale = 1.0 / math.sqrt(hd)
    qb = q.reshape(B, Sq // bq, bq, Kv, G, hd).float()
    kb = k.reshape(B, Sk // bk, bk, Kv, hd).float()
    vb = v.reshape(B, Sk // bk, bk, Kv, hd).float()
    ar_q = torch.arange(bq, device=q.device)
    ar_k = torch.arange(bk, device=q.device)
    outs = []
    for iq in range(Sq // bq):
        q_pos = iq * bq + ar_q
        m_run = torch.full((B, Kv, G, bq), NEG, device=q.device)
        l_run = torch.zeros((B, Kv, G, bq), device=q.device)
        acc = torch.zeros((B, Kv, G, bq, hd), device=q.device)
        for ik in range(Sk // bk):
            k_pos = ik * bk + ar_k
            s = torch.einsum("bqkgh,bskh->bkgqs", qb[:, iq], kb[:, ik]) * scale
            msk = torch.ones((bq, bk), dtype=torch.bool, device=q.device)
            if causal:
                msk = k_pos[None, :] <= q_pos[:, None]
                if prefix_len:
                    msk = msk | (k_pos[None, :] < prefix_len)
            if window:
                msk = msk & (k_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(msk, s, NEG)
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskh->bkgqh",
                                                        p, vb[:, ik])
            m_run = m_new
        outs.append(acc / l_run.clamp(min=1e-20)[..., None])
    out = torch.stack(outs, 1)                          # (B,nq,Kv,G,bq,hd)
    return out.movedim(-2, 2).reshape(B, Sq, H, hd).to(q.dtype)


# Sequence length from which the CPU / plain prefill attention runs
# ``mha_chunked`` instead of materializing the (S, S) scores: the JAX
# package's rule.  On CUDA the flash kernel runs at every length.
CHUNKED_ATTN_THRESHOLD = 8192


def _qkv(p, x, cfg):
    B, T, _ = x.shape
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return ((x @ p["wq"]).reshape(B, T, H, hd),
            (x @ p["wk"]).reshape(B, T, Kv, hd),
            (x @ p["wv"]).reshape(B, T, Kv, hd))


def use_kernel(backend: str, x) -> bool:
    """Whether an attention read runs a Hopper kernel: "kernel" always,
    "auto" on CUDA tensors."""
    return backend == "kernel" or (backend == "auto" and x.is_cuda)


def kernel_extend_mask(T: int, x, backend: str):
    """The block mask that sends a linear T-token extend through the
    tree-verify kernel on the kernel route: causal (T, T), so every cached
    key is visible to all T queries and each new key to itself and the
    queries after it — the causal mask.  None on the plain route, which
    reads ``mha`` under the causal mask as the JAX package does."""
    if not use_kernel(backend, x):
        return None
    return torch.ones((T, T), dtype=torch.bool, device=x.device).tril()


def attention_block(p, x, positions, cfg, *, causal: bool = True,
                    window: int = 0, prefix_len: int = 0,
                    backend: str = "auto"):
    """Full (prefill / train) attention. x: (B,S,d) -> (B,S,d), plus (k,v).
    ``prefix_len`` makes the first keys visible to every query under
    ``causal`` (prefix-LM: the vlm family's image prefix).

    On CUDA (``backend`` "auto" or "kernel") the scores never leave the
    chip: the Hopper flash kernel runs at every length on the projections
    as they lie — (B, H, S, hd) and (B, Kv, S, hd) views, GQA resolved in
    the kernel — and writes its output in (B, S, H, hd), so nothing is
    copied around it.  Under grad (training) the forward also keeps each
    row's log-sum-exp and the hand-written backward kernel gives dQ, dK
    and dV: training attention never leaves the kernels.  The CPU and
    ``backend="plain"`` materialize the (S, S) mask and run ``mha`` below
    ``CHUNKED_ATTN_THRESHOLD`` and run ``mha_chunked`` from it on, as the
    JAX package does."""
    B, S, d = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _qkv(p, x, cfg)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if use_kernel(backend, x):
        fn = flash_attention_kernel if backend == "kernel" \
            else ops.flash_attention
        out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=causal, window=window,
                 prefix_len=prefix_len).transpose(1, 2)
    elif S >= CHUNKED_ATTN_THRESHOLD:
        out = mha_chunked(q, k, v, causal=causal, window=window,
                          prefix_len=prefix_len)
    else:
        mask = _attn_mask(positions, positions, causal=causal,
                          window=window, prefix_len=prefix_len) \
            if causal or window else None
        out = mha(q, k, v, mask=mask)
    return out.reshape(B, S, H * hd) @ p["wo"], (k, v)


def _rows(pos, B: int):
    """Per-row positions (B,) int64 from a () or (B,) tensor."""
    pos = pos.long()
    return pos.expand(B) if pos.dim() == 0 else pos


def decode_attention(p, x, cache_k, cache_v, pos, cfg, *, window: int = 0,
                     backend: str = "auto"):
    """Single-token decode over a dense cache.  x: (B,1,d); cache_k/v:
    (B,Smax,Kv,hd), written in place at each row's ``pos`` (() or (B,);
    the start clamps to Smax-1 like ``lax.dynamic_update_slice``).

    The read dispatches on ``backend``: "auto" runs the Hopper dense decode
    kernel on CUDA tensors (the cache goes in as a strided view) and, on
    the CPU, ``mha`` over the cache as the JAX package does; "kernel"
    insists on the kernel; "plain" forces ``mha`` (the parity oracle).
    Returns (out (B,1,d), cache_k, cache_v).  With ``window`` > 0 only the
    last ``window`` cache entries are read (sliding-window decode)."""
    B = x.shape[0]
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Smax = cache_k.shape[1]
    q, k, v = _qkv(p, x, cfg)
    rows = _rows(pos, B)
    if cfg.use_rope:
        q = apply_rope(q, rows[:, None], cfg.rope_theta)
        k = apply_rope(k, rows[:, None], cfg.rope_theta)
    b = torch.arange(B, device=x.device)
    start = rows.clamp(0, Smax - 1)
    cache_k[b, start] = k[:, 0].to(cache_k.dtype)
    cache_v[b, start] = v[:, 0].to(cache_v.dtype)
    if use_kernel(backend, x):
        fn = decode_attention_cuda if backend == "kernel" \
            else ops.decode_attention
        out = fn(q[:, 0].reshape(B, Kv, H // Kv, hd),
                 cache_k.permute(0, 2, 1, 3), cache_v.permute(0, 2, 1, 3),
                 (rows + 1).to(torch.int32).contiguous(), window=window)
        out = out.reshape(B, 1, H * hd).to(x.dtype)
        return out @ p["wo"], cache_k, cache_v
    if window:
        first = (rows - (window - 1)).clamp(min=0)          # (B,)
        sl = first.clamp(max=Smax - window)[:, None] + \
            torch.arange(window, device=x.device)
        kk, vv = cache_k[b[:, None], sl], cache_v[b[:, None], sl]
        k_pos = first[:, None] + torch.arange(window, device=x.device)
    else:
        kk, vv = cache_k, cache_v
        k_pos = torch.arange(Smax, device=x.device)[None, :]
    mask = (k_pos <= rows[:, None])[:, None, None, None, :]  # bkgqs
    out = mha(q, kk, vv, mask=mask)
    return out.reshape(B, 1, H * hd) @ p["wo"], cache_k, cache_v


def extend_attention(p, x, cache_k, cache_v, pos, cfg, *, window: int = 0,
                     block_mask=None, q_positions=None,
                     backend: str = "auto"):
    """Multi-token cached decode (chunked prefill / speculative verify) over
    a dense cache.  x: (B,T,d); new k/v land in place at [pos, pos+T) per
    row (start clamped to Smax-T like ``lax.dynamic_update_slice``).

    By default attention is causal within the new block.  ``block_mask``
    (T, C) bool, C >= T, overrides that: its LAST T columns align with the
    new tokens, earlier columns cover tree rows already in the cache at
    [pos-(C-T), pos) (token trees drafted level by level; one-shot verify
    passes C == T).  ``q_positions`` ((T,) or (B, T)) overrides the RoPE
    positions (tree nodes use tree base + depth).  With a block mask the
    read dispatches on ``backend`` as ``decode_attention`` does: CUDA runs
    the Hopper tree-verify kernel over the cache as a strided view; the CPU
    and "plain" run ``mha`` under the placed mask, whose start clamps like
    ``lax.dynamic_update_slice`` as in the JAX package.
    Returns (out (B,T,d), cache_k, cache_v)."""
    B, T, _ = x.shape
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Smax = cache_k.shape[1]
    q, k, v = _qkv(p, x, cfg)
    rows = _rows(pos, B)
    if q_positions is None:
        q_pos = rows[:, None] + torch.arange(T, device=x.device)   # (B,T)
    else:
        q_pos = q_positions.long().expand(B, T)
    if cfg.use_rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    start = rows.clamp(0, Smax - T)
    idx = start[:, None] + torch.arange(T, device=x.device)
    b = torch.arange(B, device=x.device)[:, None]
    cache_k[b, idx] = k.to(cache_k.dtype)
    cache_v[b, idx] = v.to(cache_v.dtype)
    k_pos = torch.arange(Smax, device=x.device)
    if block_mask is None:
        mask = k_pos[None, None, :] <= q_pos[:, :, None]           # (B,T,S)
    elif use_kernel(backend, x):
        G = H // Kv
        fn = tree_verify_attention_cuda if backend == "kernel" \
            else ops.tree_verify_attention
        out = fn(q.view(B, T, Kv, G, hd).permute(0, 2, 3, 1, 4),
                 cache_k.permute(0, 2, 1, 3), cache_v.permute(0, 2, 1, 3),
                 rows.to(torch.int32).contiguous(), block_mask,
                 q_pos.to(torch.int32).contiguous(), window=window)
        out = out.permute(0, 3, 1, 2, 4).reshape(B, T, H * hd).to(x.dtype)
        return out @ p["wo"], cache_k, cache_v
    else:
        C = block_mask.shape[1]
        first = rows - (C - T)                     # tree rows start here
        at = first.clamp(0, Smax - C)              # the placed mask's start
        t = k_pos[None, :] - at[:, None]                            # (B,S)
        cols = block_mask.bool()[:, t.clamp(0, C - 1)].movedim(1, 0)
        placed = cols & ((t >= 0) & (t < C))[:, None, :]            # (B,T,S)
        mask = (k_pos[None, :] < first[:, None])[:, None, :] | placed
    if window:
        mask = mask & (k_pos[None, None, :] > q_pos[:, :, None] - window)
    out = mha(q, cache_k, cache_v, mask=mask[:, None, None])
    return out.reshape(B, T, H * hd) @ p["wo"], cache_k, cache_v


def paged_write(pool, table, q_pos, vals):
    """Write ``vals`` (B,T,Kv,hd) into ``pool`` (NB,bs,Kv,hd) IN PLACE at
    logical positions ``q_pos`` (B,T) through ``table`` (B,MB) int32.

    A position past the table is DROPPED, which is what the JAX package
    does (``take_along_axis`` fills the out-of-range block id with INT_MIN
    and the scatter then drops the write): the entry is redirected to its
    clamped target and writes back the value already there."""
    NB, bs = pool.shape[0], pool.shape[1]
    MB = table.shape[1]
    bi = q_pos // bs
    inside = bi < MB
    blk = table.long().gather(1, bi.clamp(max=MB - 1))
    flat = pool.view(NB * bs, *pool.shape[2:])
    idx = blk * bs + q_pos % bs
    new = torch.where(inside[..., None, None], vals.to(pool.dtype), flat[idx])
    flat[idx] = new
    return pool


def paged_extend_attention(p, x, k_pool, v_pool, table, pos, cfg, *,
                           backend: str = "auto"):
    """Cached decode through a paged KV pool (whole batch at once; T=1 is
    the single-token step, T>1 the speculative verify).

    x: (B,T,d); k_pool/v_pool: (NB, bs, Kv, hd) — ONE block pool shared by
    all sequences, written in place; table: (B, MB) int32 (logical position
    ``t`` of sequence ``b`` lives in block ``table[b, t // bs]`` at offset
    ``t % bs``); pos: (B,) per-sequence write position.  Attention is
    causal, windowed by ``cfg.sliding_window``.  On the kernel route
    (``backend`` "auto" on CUDA, or "kernel") the paged-decode kernel reads
    one row per new token — token t of sequence b over b's table up to its
    own position, which is the causal mask; otherwise the read gathers
    the whole table and runs ``mha``, as the JAX package does.
    Returns (out (B,T,d), k_pool, v_pool)."""
    B, T, _ = x.shape
    _, bs, Kv, hd = k_pool.shape
    H = cfg.num_heads
    q, k, v = _qkv(p, x, cfg)
    q_pos = pos.long()[:, None] + torch.arange(T, device=x.device)   # (B,T)
    if cfg.use_rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    paged_write(k_pool, table, q_pos, k)
    paged_write(v_pool, table, q_pos, v)
    if use_kernel(backend, x):
        fn = paged_decode_attention_cuda if backend == "kernel" \
            else ops.paged_decode_attention
        out = fn(q.reshape(B * T, Kv, H // Kv, hd), k_pool, v_pool,
                 table.repeat_interleave(T, 0),
                 (q_pos + 1).reshape(B * T).to(torch.int32),
                 window=cfg.sliding_window)
        out = out.reshape(B, T, H * hd).to(x.dtype)
        return out @ p["wo"], k_pool, v_pool
    tl = table.long()
    kk = k_pool[tl].reshape(B, -1, Kv, hd)
    vv = v_pool[tl].reshape(B, -1, Kv, hd)
    k_pos = torch.arange(kk.shape[1], device=x.device)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]                 # (B,T,S)
    if cfg.sliding_window:
        mask = mask & (k_pos[None, None, :] >
                       q_pos[:, :, None] - cfg.sliding_window)
    out = mha(q, kk, vv, mask=mask[:, None, None])
    return out.reshape(B, T, H * hd) @ p["wo"], k_pool, v_pool


def paged_decode_attention_block(p, x, k_pool, v_pool, table, pos, cfg, *,
                                 backend: str = "auto"):
    """Single-token decode through a paged KV pool WITHOUT materializing the
    block-table gather.

    Same write path as ``paged_extend_attention``; the read dispatches on
    ``backend``: "auto" runs the Hopper paged-decode kernel on CUDA tensors
    and its plain version on CPU ones, "kernel" insists on the kernel,
    "plain" forces the plain version (the parity oracle, like JAX's "ref").
    ``cfg.sliding_window`` runs the kernel's windowed variant.

    x: (B, 1, d); k_pool/v_pool: (NB, bs, Kv, hd); table: (B, MB) int32;
    pos: (B,) int32.  Returns (out (B, 1, d), k_pool, v_pool)."""
    B, T, _ = x.shape
    if T != 1:
        raise ValueError("paged_decode_attention_block is the T=1 path")
    _, bs, Kv, hd = k_pool.shape
    H = cfg.num_heads
    G = H // Kv
    q, k, v = _qkv(p, x, cfg)
    q_pos = pos.long()[:, None]                                      # (B, 1)
    if cfg.use_rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    paged_write(k_pool, table, q_pos, k)
    paged_write(v_pool, table, q_pos, v)
    qh = q[:, 0].reshape(B, Kv, G, hd)        # head h = kv*G + g, as mha
    length = (pos + 1).to(torch.int32)
    win = cfg.sliding_window
    if backend == "plain":
        out = paged_decode_attention_plain(qh, k_pool, v_pool, table, length,
                                           window=win)
    elif backend == "kernel":
        out = paged_decode_attention_cuda(qh, k_pool, v_pool, table, length,
                                          window=win)
    else:
        out = ops.paged_decode_attention(qh, k_pool, v_pool, table, length,
                                         window=win)
    out = out.reshape(B, 1, H * hd).to(x.dtype)
    return out @ p["wo"], k_pool, v_pool


def cross_attention_kv(p, enc, cfg):
    """Cross-attention k/v of the encoder output. enc: (B,Se,d) ->
    k, v (B,Se,Kv,hd)."""
    B, Se, _ = enc.shape
    Kv, hd = cfg.num_kv_heads, cfg.head_dim
    return ((enc @ p["wk"]).reshape(B, Se, Kv, hd),
            (enc @ p["wv"]).reshape(B, Se, Kv, hd))


def cross_attention(p, x, k, v, cfg, *, backend: str = "auto"):
    """x: (B,Sq,d) attends over the fixed k, v (B,Se,Kv,hd) with no mask
    (the encoder is fully visible).  On CUDA ("auto", "kernel") a
    one-token step with no gradient to carry (the decode step) runs the
    dense decode kernel over k, v as strided views with every row's length
    Se; any other call (prefill, extend, the teacher-forced forward, and
    under grad) runs the flash kernel non-causally on q (B,H,Sq,hd)
    against k, v (B,Kv,Se,hd) views — under grad its backward kernel gives
    dK and dV, which reach the cross projections and the encoder.  The CPU
    and "plain" run ``mha``, as the JAX package does."""
    B, Sq, _ = x.shape
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, Sq, H, hd)
    if not use_kernel(backend, x):
        out = mha(q, k, v, mask=None)
    elif Sq == 1 and not (torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad)):
        fn = decode_attention_cuda if backend == "kernel" \
            else ops.decode_attention
        Se = k.shape[1]
        length = torch.full((B,), Se, dtype=torch.int32, device=x.device)
        out = fn(q[:, 0].reshape(B, Kv, H // Kv, hd), k.permute(0, 2, 1, 3),
                 v.permute(0, 2, 1, 3), length).reshape(B, 1, H, hd)
    else:
        fn = flash_attention_kernel if backend == "kernel" \
            else ops.flash_attention
        out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=False).transpose(1, 2)
    return out.reshape(B, Sq, H * hd).to(x.dtype) @ p["wo"]


# ----------------------------------------------------------------- mlp
def mlp_block(p, x, activation: str):
    if activation == "silu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif activation == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    elif activation == "relu2":
        h = torch.square(F.relu(x @ p["w_up"]))
    elif activation == "gelu":
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    else:
        raise ValueError(activation)
    return h @ p["w_down"]


# ----------------------------------------------------------------- embeddings
def embed(table, tokens):
    return table[tokens.long()]


def unembed(table_or_head, h):
    """h: (..., d) -> logits (..., V) in f32 (the head is cast to f32 for
    the product, as the JAX package does)."""
    return h.float() @ table_or_head.float().T
