"""State-space sequence mixing (the PyTorch twin of the JAX package's
``models/ssm.py``): the chunked gated-linear-attention (GLA) engine shared
by Mamba2 (SSD) and xLSTM's mLSTM, the Mamba2 block, and the standalone
pure-Mamba2 model (family "ssm", e.g. ``mamba2-370m``).

Recurrence (per batch b, head h):
    S_t = a_t * S_{t-1} + i_t * k_t v_t^T          (N x P matrix state)
    n_t = a_t * n_{t-1} + i_t * k_t                (N normalizer, mLSTM only)
    y_t = q_t^T S_t        [mamba]      or     q_t^T S_t / max(|q_t^T n_t|, e^{-m_t})  [mlstm]

All math is done in log space with a running max stabilizer m_t; the
carried state is S~ = S * e^{-M}.  ``gla_chunked`` runs the chunked form
through ``kernels/ops.py``: the hand-written Hopper SSD-scan kernel on a
CUDA tensor, its plain PyTorch version on a CPU one.

Caches are functional: a step returns new state tensors and never writes
into its input, so a cache dict kept as a snapshot stays valid while the
speculative rounds advance past it.  Where the JAX package stacks the
layers' states on a leading ``L`` axis, the port keeps a list with one
entry per layer, each state tensor with the batch (slot) axis first.

Parameters placed on a device mesh (``launch/sharding.place_params``)
train through ``forward``: each mamba2 layer on this rank's SSD heads
where they divide 'model' (``mamba2_forward``'s ``tp``); the cached
entry points raise for them (ROADMAP A.8f).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import (ssd_chunk_scan_kernel,
                                          ssd_chunk_scan_plain)
from repro_torch.models import layers as L
from repro_torch.models.transformer import _tp, dtype_of

NEG = -1e30
# leaves the JAX package keeps in float32 whatever ``param_dtype`` says
F32_LEAVES = ("A_log", "dt_bias", "D")


class GLAState(NamedTuple):
    S: torch.Tensor     # (B, H, N, P)  stabilized matrix state
    n: torch.Tensor     # (B, H, N)     stabilized normalizer
    m: torch.Tensor     # (B, H)        running log-max


def init_gla_state(B: int, H: int, N: int, P: int,
                   device="cuda") -> GLAState:
    f32 = dict(dtype=torch.float32, device=device)
    return GLAState(S=torch.zeros((B, H, N, P), **f32),
                    n=torch.zeros((B, H, N), **f32),
                    m=torch.full((B, H), NEG, **f32))


# ------------------------------------------------------------- cache trees
def tree_map(fn, *trees):
    """Map ``fn`` over the tensors of identically structured cache trees
    (dicts, lists and named tuples of tensors)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    """The tensors of a cache tree, dict entries in sorted key order (as
    ``jax.tree.leaves`` flattens them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_where(pred, new, old):
    """Per-leaf ``torch.where`` over two identically shaped cache trees.
    ``pred`` is a () bool tensor, or (B,) with the batch (slot) axis first
    in every leaf — the recurrent families' rewind primitive: one call
    selects each slot's state at its own accepted count."""
    def sel(a, b):
        p = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
        return torch.where(p, a, b)
    return tree_map(sel, new, old)


# ------------------------------------------------------------- GLA engine
def gla_chunked(q, k, v, log_a, log_i, *, chunk: int,
                state: Optional[GLAState] = None, backend: str = "auto"):
    """q,k: (B,S,H,N) (any strides, last dim contiguous); v: (B,S,H,P);
    log_a/log_i: (B,S,H).  Returns (y_num (B,S,H,P), den (B,S,H), m
    (B,S,H), final GLAState), all f32; ``y_num``/``den`` are stabilized by
    e^{-m}.  ``backend``: "auto" (the Hopper kernel on CUDA tensors, the
    plain version on CPU ones), "kernel" or "plain"."""
    if backend == "plain":
        fn = ssd_chunk_scan_plain
    elif backend == "kernel":
        fn = ssd_chunk_scan_kernel
    else:
        fn = ops.ssd_chunk_scan
    y, den, m, st = fn(q, k, v, log_a.float(), log_i.float(), chunk=chunk,
                       state=state)
    return y, den, m, GLAState(*st)


def gla_step(q, k, v, log_a, log_i, state: GLAState):
    """Single decode step. q,k: (B,H,N); v: (B,H,P); log_a/log_i: (B,H)."""
    q, k, v = q.float(), k.float(), v.float()
    log_a, log_i = log_a.float(), log_i.float()
    St, nt, M = state
    m_new = torch.maximum(M + log_a, log_i)
    sc = torch.exp(torch.clamp(M + log_a - m_new, max=0.0))
    ic = torch.exp(log_i - m_new)
    S_new = sc[..., None, None] * St + ic[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = sc[..., None] * nt + ic[..., None] * k
    y = torch.einsum("bhn,bhnp->bhp", q, S_new)
    den = torch.einsum("bhn,bhn->bh", q, n_new)
    return y, den, m_new, GLAState(S_new, n_new, m_new)


# ------------------------------------------------------------- causal conv1d
def init_conv(gen, channels: int, width: int, dtype, device="cuda"):
    return {"w": L.dense_init(gen, (width, channels), scale=1.0, dtype=dtype,
                              device=device),
            "b": torch.zeros((channels,), dtype=dtype, device=device)}


def causal_conv(p, x, state=None):
    """Depthwise causal conv. x: (B,S,C) -> (B,S,C); returns (y, new_state).
    ``state``: (B, W-1, C) trailing inputs of the previous segment (zeros
    at sequence start)."""
    w = p["w"]                       # (W, C)
    W = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(W))
    y = y + p["b"]
    if W > 1:
        state = xp[:, -(W - 1):, :]   # last W-1 raw inputs
    else:
        state = x.new_zeros((x.shape[0], 0, x.shape[2]))
    return y, state


def causal_conv_step(p, x, state):
    """x: (B,1,C); state: (B,W-1,C). Returns (y (B,1,C), new_state).  Types
    promote as in the JAX package: a float32 slot state makes the step
    float32."""
    w, b = p["w"], p["b"]
    dt = torch.promote_types(state.dtype, x.dtype)
    window = torch.cat([state.to(dt), x.to(dt)], dim=1)      # (B, W, C)
    y = torch.einsum("bwc,wc->bc", window, w.to(dt)) + b
    return y[:, None, :], window[:, 1:, :]


# ----------------------------------------------------------------- Mamba2
def _mamba_dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    return di, N, P, di // P


def init_mamba2(gen, cfg, dtype, device="cuda"):
    d = cfg.d_model
    di, N, P, H = _mamba_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": L.dense_init(gen, (d, 2 * di + 2 * N + H), dtype=dtype,
                                device=device),
        "conv": init_conv(gen, di + 2 * N, cfg.conv_kernel, dtype, device),
        "A_log": torch.zeros((H,), **f32),          # A = -exp(A_log) = -1
        "dt_bias": torch.zeros((H,), **f32),
        "D": torch.ones((H,), **f32),
        "norm": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": L.dense_init(gen, (di, d), dtype=dtype, device=device),
    }


def _mamba_split(p, x, cfg):
    """(z, [x | B | C], dt) of the layer's input; di and H read off the
    weights (``norm`` is (di,)), so a rank's view of a layer on its SSD
    heads (``TensorParallel.mamba_view``) splits as a whole layer does."""
    di, N = p["norm"].shape[-1], cfg.ssm_state
    return torch.split(x @ p["in_proj"], [di, di + 2 * N,
                                          di // cfg.ssm_head_dim], dim=-1)


def _gates(p, dt):
    delta = F.softplus(dt.float() + p["dt_bias"])
    return -torch.exp(p["A_log"]) * delta, torch.log(delta + 1e-9)


def _gated_norm(y, w, cfg, tp):
    """The gated RMSNorm over the whole di.  On a rank's SSD heads (``tp``)
    ``y`` holds its heads' columns: the sum of squares is summed over
    'model' (``TensorParallel.ssd_sum``)."""
    if tp is None or not tp.ssd_heads:
        return L.rmsnorm(y, w, cfg.norm_eps)
    dt = y.dtype
    y = y.float()
    ss = tp.ssd_sum((y * y).sum(dim=-1, keepdim=True))
    di = y.shape[-1] * tp.mesh.shape["model"]
    y = y * torch.rsqrt(ss / di + cfg.norm_eps)
    return (y * (1.0 + w.float())).to(dt)


def mamba2_forward(p, x, cfg, cache=None, backend: str = "auto", tp=None,
                   prefix: str = "blocks"):
    """x: (B,S,d) -> (y (B,S,d), final GLA state + conv state).  ``cache``:
    optional {"gla": GLAState, "conv": (B,W-1,C)} to continue from a
    previous segment (chunked prefill / speculative extension).  B and C
    reach the scan as head-broadcast views (head stride 0).

    ``tp`` (a ``TensorParallel``; ``p`` this rank's blocks of the layer at
    JAX path ``prefix``): the layer runs on this rank's SSD heads where
    they divide 'model' — the scan on H/m heads, the gated norm's sum of
    squares and ``out_proj``'s partials summed over 'model', the input's
    gradient too — and whole on every rank otherwise
    (``TensorParallel.mamba_view``)."""
    if tp is not None:
        p, x = tp.mamba_view(prefix, p), tp.ssd_in(x)
    B, S, d = x.shape
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    di = p["norm"].shape[-1]
    H = di // P
    z, xbc, dt = _mamba_split(p, x, cfg)
    xbc, conv_state = causal_conv(p["conv"], xbc,
                                  state=None if cache is None
                                  else cache["conv"])
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    log_a, log_i = _gates(p, dt)                                 # (B,S,H)
    v = xs.reshape(B, S, H, P)
    k = Bm[:, :, None, :].expand(B, S, H, N)
    q = Cm[:, :, None, :].expand(B, S, H, N)
    y, _den, m, st = gla_chunked(q, k, v, log_a, log_i, chunk=cfg.ssm_chunk,
                                 state=None if cache is None
                                 else cache["gla"], backend=backend)
    y = y * torch.exp(m)[..., None]                              # un-stabilize
    y = y + p["D"][None, None, :, None] * v.float()
    y = y.reshape(B, S, di).to(x.dtype)
    y = y * F.silu(z)
    y = _gated_norm(y, p["norm"], cfg, tp) @ p["out_proj"]
    return (y if tp is None else tp.reduce_ssd(y)), {"gla": st,
                                                     "conv": conv_state}


def mamba2_init_cache(cfg, batch: int, device="cuda",
                      dtype=torch.float32):
    di, N, P, H = _mamba_dims(cfg)
    return {"gla": init_gla_state(batch, H, N, P, device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, di + 2 * N),
                                dtype=dtype, device=device)}


def mamba2_step(p, x, cache, cfg):
    """x: (B,1,d). Returns (y (B,1,d), new_cache)."""
    B = x.shape[0]
    di, N, P, H = _mamba_dims(cfg)
    z, xbc, dt = _mamba_split(p, x, cfg)
    xbc, conv_state = causal_conv_step(p["conv"], xbc, cache["conv"])
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    log_a, log_i = _gates(p, dt[:, 0])                           # (B,H)
    v = xs[:, 0].reshape(B, H, P)
    k = Bm[:, 0, None, :].expand(B, H, N)
    q = Cm[:, 0, None, :].expand(B, H, N)
    y, _den, m, st = gla_step(q, k, v, log_a, log_i, cache["gla"])
    y = y * torch.exp(m)[..., None] + p["D"][None, :, None] * v.float()
    y = y.reshape(B, 1, di).to(x.dtype)
    y = y * F.silu(z)
    y = L.rmsnorm(y, p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], {"gla": st, "conv": conv_state}


# ------------------------------------------------------- standalone model
# Pure-Mamba2 decoder (family "ssm"): embed + L mamba2 blocks + final norm.
# The cache is pure recurrent state — no sequence axis at all, so decode
# cost is O(1) in context length.
def init_params(cfg, seed: int = 0, device="cuda",
                place=None) -> L.ParamTree:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (the JAX package's distributions, not its draws).  ``place(path,
    tensor)`` cuts each leaf to a mesh rank's block as it is drawn
    (``launch/sharding.leaf_placer``); on the meta device nothing is
    drawn."""
    dtype = dtype_of(cfg.param_dtype)
    device = torch.device(device)
    gen = L.seeded(seed, device)
    put = place or L.keep_whole
    return L.ParamTree({
        "embed": put("embed", L.init_embedding(gen, cfg.vocab_size,
                                               cfg.d_model, dtype, device)),
        "blocks": [L.place_tree(put, "blocks",
                                init_mamba2(gen, cfg, dtype, device))
                   for _ in range(cfg.num_layers)],
        "final_norm": put("final_norm", torch.zeros(
            (cfg.d_model,), dtype=dtype, device=device)),
    })


def init_cache(cfg, batch: int, device="cuda"):
    return {"layers": [mamba2_init_cache(cfg, batch, device)
                       for _ in range(cfg.num_layers)],
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def embed_tokens(params, tokens, cfg):
    """Token embeddings in the activation dtype (a vocabulary-split table
    summed over 'model' when the parameters are placed on a mesh)."""
    tp = _tp(params)
    h = L.embed(params.embed, tokens) if tp is None else \
        tp.embed_lookup(params.embed, tokens)
    return h.to(dtype_of(cfg.activ_dtype))


def _logits(params, h, cfg):
    """Logits through the tied embedding (vocabulary-split when placed)."""
    hn = L.rmsnorm(h, params.final_norm, cfg.norm_eps)
    tp = _tp(params)
    return L.unembed(params.embed, hn) if tp is None else \
        tp.unembed(params.embed, hn)


def run_layers(fns, h, *, remat: bool = False, collect_hidden: bool = False):
    """Apply the residual-stream layers ``fns`` (each h -> h) in order.
    ``remat`` recomputes each one in the backward (``torch.utils.
    checkpoint``, non-reentrant) instead of keeping its activations — the
    JAX package's ``jax.checkpoint`` per block.  Returns (h, the stacked
    output of every layer (L, B, S, d) if ``collect_hidden`` else None)."""
    hs = []
    for fn in fns:
        h = checkpoint(fn, h, use_reentrant=False) if remat else fn(h)
        if collect_hidden:
            hs.append(h)
    return h, torch.stack(hs) if collect_hidden else None


def forward(params, tokens, cfg, *, backend: str = "auto",
            remat: bool = False, collect_hidden: bool = False):
    """Scoring / training pass. tokens (B,S) -> (logits (B,S,V) f32, aux
    loss 0), and every block's output (L, B, S, d) if ``collect_hidden``.
    ``remat``: recompute each block in the backward.  Parameters placed on
    a device mesh (``params.tp``) run each layer on this rank's SSD heads
    where they divide 'model' (``mamba2_forward``)."""
    tp = _tp(params)
    h = embed_tokens(params, tokens, cfg)
    h, hs = run_layers(
        [lambda x, p=p: x + mamba2_forward(p, x, cfg, backend=backend,
                                           tp=tp)[0]
         for p in params.blocks], h, remat=remat,
        collect_hidden=collect_hidden)
    out = (_logits(params, h, cfg), torch.zeros((), device=h.device))
    return out + (hs,) if collect_hidden else out


def _run_cached(params, tokens, states, cfg, block_fn):
    """Layer loop for prefill/extend/decode: ``block_fn`` maps (p, h,
    layer_state) -> (out, new_state); returns (final h, new states)."""
    L.require_unplaced(params, cfg, "a cached step")
    h = L.embed(params.embed, tokens).to(dtype_of(cfg.activ_dtype))
    new = []
    for p, st in zip(params.blocks, states):
        out, st = block_fn(p, h, st)
        h = h + out
        new.append(st)
    return h, new


def prefill(params, tokens, cfg, *, backend: str = "auto"):
    """Returns (last-token logits (B,V), cache with final recurrent state)."""
    B, S = tokens.shape
    h, states = _run_cached(
        params, tokens, init_cache(cfg, B, tokens.device)["layers"], cfg,
        lambda p, hh, st: mamba2_forward(p, hh, cfg, cache=st,
                                         backend=backend))
    return _logits(params, h[:, -1, :], cfg), {
        "layers": states,
        "pos": torch.full((), S, dtype=torch.int32, device=tokens.device)}


def extend_step(params, tokens, cache, cfg, *, backend: str = "auto"):
    """Multi-token cached decode. tokens (B,T) -> (logits (B,T,V), cache)."""
    h, states = _run_cached(
        params, tokens, cache["layers"], cfg,
        lambda p, hh, st: mamba2_forward(p, hh, cfg, cache=st,
                                         backend=backend))
    return _logits(params, h, cfg), {"layers": states,
                                     "pos": cache["pos"] + tokens.shape[1]}


def decode_step(params, token, cache, cfg):
    """One decode step. token (B,1) -> (logits (B,V), cache)."""
    h, states = _run_cached(params, token, cache["layers"], cfg,
                            lambda p, hh, st: mamba2_step(p, hh, st, cfg))
    return _logits(params, h[:, 0, :], cfg), {"layers": states,
                                              "pos": cache["pos"] + 1}


# ------------------------------------------------------- batched replay
def replay(step, tokens, cache, count, gate=tree_where):
    """The recurrent families' speculative rewind: re-advance ``cache``
    through each slot's accepted prefix of the PADDED draft tape ``tokens``
    (B, T) = [pending token, draft_0 .. draft_{T-2}], one batched decode
    ``step`` (token (B,1), cache) -> (logits, cache) per tape position.
    ``count`` (B,) int32 (or ()) says how many tape entries each slot
    commits; ``gate(take, new, old)`` keeps a slot's state once ``t >=
    count`` (``count == 0`` leaves the slot on ``cache``).  The port of the
    JAX package's ``vmap`` over slots of a ``tree_where``-gated scan."""
    for t in range(tokens.shape[1]):
        _, nxt = step(tokens[:, t:t + 1], cache)
        cache = gate(t < count, nxt, cache)
    return cache


def replay_step(params, tokens, cache, count, cfg):
    """Batched accepted-prefix replay for speculative rewind (family
    "ssm"); see ``replay``."""
    return replay(lambda tok, c: decode_step(params, tok, c, cfg), tokens,
                  cache, count)
