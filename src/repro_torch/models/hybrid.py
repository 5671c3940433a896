"""Zamba2-style hybrid (arXiv:2411.15242), the PyTorch twin of the JAX
package's ``models/hybrid.py``: a Mamba2 backbone plus ONE shared
attention+MLP block applied after every ``shared_attn_every`` mamba layers.
The shared block's weights are reused at each application, but each
application keeps its own K/V cache slab.

The JAX package stacks the mamba layers (G groups x K layers) for a nested
``lax.scan``; the port keeps them as a list (layer ``g * K + k``) and loops.
The shared block's prefill runs ``layers.attention_block`` (the Hopper
flash kernel on CUDA), its decode ``layers.decode_attention`` (the dense
decode kernel) and its extend ``layers.extend_attention``; the mamba2
layers run the SSD-scan kernel through ``ssm.mamba2_forward``.  Cache:
``{"mamba": [per-layer {"gla", "conv"}], "k", "v": (G, B, S, Kv, hd),
"pos"}`` — the mamba states are replaced by new tensors every step, the
K/V slabs are written in place as in ``transformer.py``.

Parameters placed on a device mesh (``launch/sharding.place_params``)
train through ``forward`` (the mamba layers on this rank's SSD heads, the
shared block tensor parallel); the cached entry points raise for them
(ROADMAP A.8f).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.ssm import _logits, embed_tokens
from repro_torch.models.transformer import _cfg, _tp, dtype_of


def _dims(cfg):
    K = cfg.shared_attn_every
    G = cfg.num_layers // K
    if G * K != cfg.num_layers:
        raise ValueError(f"num_layers {cfg.num_layers} is not a multiple of "
                         f"shared_attn_every {K}")
    return G, K


def init_params(cfg, seed: int = 0, device="cuda",
                place=None) -> L.ParamTree:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (the JAX package's distributions, not its draws).  ``place(path,
    tensor)`` cuts each leaf (``mamba/...``, ``shared/...``) to a mesh
    rank's block as it is drawn; on the meta device nothing is drawn."""
    _dims(cfg)
    dtype = dtype_of(cfg.param_dtype)
    device = torch.device(device)
    gen = L.seeded(seed, device)
    put = place or L.keep_whole
    d = cfg.d_model
    return L.ParamTree({
        "embed": put("embed", L.init_embedding(gen, cfg.vocab_size, d,
                                               dtype, device)),
        "mamba": [L.place_tree(put, "mamba",
                               S.init_mamba2(gen, cfg, dtype, device))
                  for _ in range(cfg.num_layers)],
        "shared": L.place_tree(put, "shared", {
            "attn_norm": torch.zeros((d,), dtype=dtype, device=device),
            "attn": L.init_attention(gen, cfg, dtype, device),
            "mlp_norm": torch.zeros((d,), dtype=dtype, device=device),
            "mlp": L.init_mlp(gen, cfg, dtype, device),
        }),
        "final_norm": put("final_norm", torch.zeros((d,), dtype=dtype,
                                                    device=device)),
    })


def _mlp(shared, h, cfg, tp=None):
    x = L.rmsnorm(h, shared["mlp_norm"], cfg.norm_eps)
    m = L.mlp_block(shared["mlp"], x if tp is None else tp.mlp_in(x),
                    cfg.mlp_activation)
    return m if tp is None else tp.reduce_mlp(m)


def _group(params, h, g, states, cfg, mamba_fn, attend, shared=None,
           tp=None):
    """Group ``g`` of the backbone: K mamba layers (``mamba_fn(p, h, layer
    state or None)``) then the shared block (``shared``, the parameters'
    by default), whose attention is ``attend(attn params, normed h, group
    index)``.  Under ``tp`` the shared block's attention and MLP run on
    this rank's heads and d_ff.  Returns (h, the mamba layers' new states,
    the attention's extra)."""
    _, K = _dims(cfg)
    shared = params.shared if shared is None else shared
    new = []
    for l in range(g * K, (g + 1) * K):
        out, st = mamba_fn(params.mamba[l], h,
                           None if states is None else states[l])
        h = h + out
        new.append(st)
    x = L.rmsnorm(h, shared["attn_norm"], cfg.norm_eps)
    a, extra = attend(shared["attn"], x if tp is None else tp.attn_in(x), g)
    h = h + (a if tp is None else tp.reduce_attn(a))
    return h + _mlp(shared, h, cfg, tp), new, extra


def _groups(params, h, states, cfg, mamba_fn, attend):
    """Every group in order (``_group``).  Returns (h, new mamba states,
    per-group attention extras)."""
    G, _ = _dims(cfg)
    new, extras = [], []
    for g in range(G):
        h, st, extra = _group(params, h, g, states, cfg, mamba_fn, attend)
        new += st
        extras.append(extra)
    return h, new, extras


def forward(params, tokens, cfg, *, window: int = 0, backend: str = "auto",
            remat: bool = False, collect_hidden: bool = False):
    """Scoring / training pass. tokens (B,S) -> (logits (B,S,V) f32, aux
    loss 0), and every group's output (G, B, S, d) if ``collect_hidden``
    (the JAX package stacks per group).  ``remat``: recompute each group
    in the backward.

    Parameters placed on a device mesh (``params.tp``): each mamba layer
    on this rank's SSD heads where they divide 'model'
    (``ssm.mamba2_forward``); the shared block's weights gathered once per
    forward (so the gradient of its G applications is reduce-scattered
    once) and its attention and MLP split over 'model' as a decoder
    block's are (``TensorParallel``)."""
    tp = _tp(params)
    cfg = _cfg(params, cfg)
    h = embed_tokens(params, tokens, cfg)
    positions = torch.arange(h.shape[1], device=h.device)
    win = window or cfg.sliding_window
    G, _ = _dims(cfg)
    shared = None if tp is None else \
        tp.gather_tree("shared", params.shared, tp.compute_split)

    def group(g):
        return lambda x: _group(
            params, x, g, None, cfg,
            lambda p, hh, st: S.mamba2_forward(p, hh, cfg, backend=backend,
                                               tp=tp, prefix="mamba"),
            lambda p, xx, gg: L.attention_block(
                p, xx, positions, cfg, window=win, backend=backend),
            shared, tp)[0]

    h, hs = S.run_layers([group(g) for g in range(G)], h, remat=remat,
                         collect_hidden=collect_hidden)
    out = (_logits(params, h, cfg), torch.zeros((), device=h.device))
    return out + (hs,) if collect_hidden else out


# ----------------------------------------------------------------- cache
def init_cache(cfg, batch: int, max_seq: int, dtype=None, device="cuda"):
    dtype = dtype or dtype_of(cfg.param_dtype)
    G, _ = _dims(cfg)
    kv_shape = (G, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {
        "mamba": [S.mamba2_init_cache(cfg, batch, device)
                  for _ in range(cfg.num_layers)],
        "k": torch.zeros(kv_shape, dtype=dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def prefill(params, tokens, cfg, *, max_seq=None, window: int = 0,
            backend: str = "auto"):
    """Run the prompt.  tokens (B,S).  Returns (last-token logits (B,V),
    cache with K/V padded to ``max_seq`` entries)."""
    L.require_unplaced(params, cfg, "prefill")
    h = L.embed(params.embed, tokens).to(dtype_of(cfg.activ_dtype))
    B, Sq = tokens.shape
    max_seq = max(max_seq or Sq, Sq)
    positions = torch.arange(Sq, device=h.device)
    win = window or cfg.sliding_window
    h, states, kvs = _groups(
        params, h, None, cfg,
        lambda p, hh, st: S.mamba2_forward(p, hh, cfg, backend=backend),
        lambda p, x, g: L.attention_block(p, x, positions, cfg, window=win,
                                          backend=backend))
    cache = init_cache(cfg, B, max_seq, device=h.device)
    for g, (k, v) in enumerate(kvs):
        cache["k"][g, :, :Sq] = k
        cache["v"][g, :, :Sq] = v
    cache["mamba"] = states
    cache["pos"] = torch.full((), Sq, dtype=torch.int32, device=h.device)
    return _logits(params, h[:, -1, :], cfg), cache


def extend_step(params, tokens, cache, cfg, *, window: int = 0,
                backend: str = "auto"):
    """Multi-token cached decode. tokens (B,T) -> (logits (B,T,V), cache);
    the K/V slabs are written in place."""
    L.require_unplaced(params, cfg, "extend_step")
    h = L.embed(params.embed, tokens).to(dtype_of(cfg.activ_dtype))
    pos = cache["pos"]
    win = window or cfg.sliding_window
    h, states, _ = _groups(
        params, h, cache["mamba"], cfg,
        lambda p, hh, st: S.mamba2_forward(p, hh, cfg, cache=st,
                                           backend=backend),
        lambda p, x, g: (L.extend_attention(p, x, cache["k"][g],
                                            cache["v"][g], pos, cfg,
                                            window=win)[0], None))
    return _logits(params, h, cfg), {**cache, "mamba": states,
                                     "pos": pos + tokens.shape[1]}


def decode_step(params, token, cache, cfg, *, window: int = 0,
                attn_backend: str = "auto"):
    """One decode step. token (B,1) -> (logits (B,V), cache); the shared
    block's read is ``layers.decode_attention`` (``attn_backend``)."""
    L.require_unplaced(params, cfg, "decode_step")
    h = L.embed(params.embed, token).to(dtype_of(cfg.activ_dtype))
    pos = cache["pos"]
    win = window or cfg.sliding_window
    h, states, _ = _groups(
        params, h, cache["mamba"], cfg,
        lambda p, hh, st: S.mamba2_step(p, hh, st, cfg),
        lambda p, x, g: (L.decode_attention(p, x, cache["k"][g],
                                            cache["v"][g], pos, cfg,
                                            window=win,
                                            backend=attn_backend)[0], None))
    return _logits(params, h[:, 0, :], cfg), {**cache, "mamba": states,
                                              "pos": pos + 1}


def replay_step(params, tokens, cache, count, cfg, *,
                attn_backend: str = "auto"):
    """Batched accepted-prefix replay for speculative rewind (see
    ``ssm.replay``).  Only the mamba states and ``pos`` are gated.  The K/V
    slabs always take the step's write: entries land at increasing
    positions while a slot is alive, and once ``t >= count`` its frozen
    ``pos`` makes dead steps overwrite the single entry AT ``pos`` — past
    the committed prefix, masked out of every read (``k_pos <= pos``), and
    rewritten by the next real decode."""
    def gate(take, new, old):
        return {**new, "mamba": S.tree_where(take, new["mamba"],
                                             old["mamba"]),
                "pos": torch.where(take, new["pos"], old["pos"])}

    return S.replay(lambda tok, c: decode_step(params, tok, c, cfg,
                                               attn_backend=attn_backend),
                    tokens, cache, count, gate)
