"""xLSTM (arXiv:2405.04517): alternating mLSTM and sLSTM blocks (the PyTorch
twin of the JAX package's ``models/xlstm.py``).

* mLSTM: matrix-memory LSTM with exponential input gating — a gated linear
  attention run by the chunked GLA engine of ``ssm.py`` (the Hopper
  SSD-scan kernel on CUDA) for prefill and extends, and its O(1)-state
  recurrent form for decode.
* sLSTM: scalar-memory LSTM with memory mixing (recurrent matrices) —
  inherently sequential: a Python loop over time where JAX runs
  ``lax.scan``.

d_ff = 0: blocks carry their own up/down projections (mLSTM proj factor 2,
sLSTM GLU factor 4/3).  ``blocks`` is a list of per-layer parameter trees,
mLSTM and sLSTM mixed; the cache's ``layers`` a list of per-layer states
(``GLAState`` or the sLSTM dict), batch axis first, updated functionally.
Parameters placed on a device mesh (``launch/sharding.place_params``)
train through ``forward`` (every block whole on every rank); the cached
entry points raise for them (ROADMAP A.8f).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.ssm import (GLAState, _logits, embed_tokens,
                                    gla_chunked, gla_step, init_gla_state,
                                    replay, run_layers)
from repro_torch.models.transformer import _tp, dtype_of

NEG = -1e30
# leaves the JAX package keeps in float32 whatever ``param_dtype`` says
F32_LEAVES = ("w_i", "w_f", "f_bias", "out_norm", "w_gates", "r_gates",
              "g_bias")


def is_slstm(cfg, layer: int) -> bool:
    k = cfg.xlstm_slstm_every
    return bool(k) and (layer % k == k - 1)


# ----------------------------------------------------------------- mLSTM
def _mlstm_dims(cfg):
    di = 2 * cfg.d_model
    H = cfg.num_heads
    return di, H, di // H


def init_mlstm(gen, cfg, dtype, device="cuda"):
    d = cfg.d_model
    di, H, hd = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)

    def dense(shape, dt=dtype):
        return L.dense_init(gen, shape, dtype=dt, device=device)
    return {
        "norm": torch.zeros((d,), dtype=dtype, device=device),
        "w_up": dense((d, 2 * di)),
        "w_q": dense((di, di)),
        "w_k": dense((di, di)),
        "w_v": dense((di, di)),
        "w_i": dense((di, H), torch.float32),
        "w_f": dense((di, H), torch.float32),
        "f_bias": torch.full((H,), 3.0, **f32),   # open forget gates at init
        "out_norm": torch.ones((H, hd), **f32),
        "w_down": dense((di, d)),
    }


def _mlstm_qkvif(p, xi, cfg):
    B, S, di = xi.shape
    _, H, hd = _mlstm_dims(cfg)
    q = (xi @ p["w_q"]).reshape(B, S, H, hd) / math.sqrt(hd)
    k = (xi @ p["w_k"]).reshape(B, S, H, hd)
    v = (xi @ p["w_v"]).reshape(B, S, H, hd)
    log_i = xi.float() @ p["w_i"]                                 # exp gate
    log_f = F.logsigmoid(xi.float() @ p["w_f"] + p["f_bias"])
    return q, k, v, log_i, log_f


def _mlstm_out(p, x, z, y, den, m, cfg):
    """Normalise the cell output (the mLSTM denominator), group-norm the
    heads, gate and project back onto the residual."""
    y = y / torch.maximum(den.abs(), torch.exp(-m))[..., None]
    y = L.groupnorm_heads(y, p["out_norm"], cfg.norm_eps)
    y = y.reshape(x.shape[0], x.shape[1], -1).to(x.dtype) * F.silu(z)
    return x + y @ p["w_down"]


def mlstm_forward(p, x, cfg, *, chunk: int = 0, state: GLAState = None,
                  backend: str = "auto"):
    """x: (B,S,d) -> (y, final GLAState)."""
    xn = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    xi, z = (xn @ p["w_up"]).chunk(2, dim=-1)
    q, k, v, log_i, log_f = _mlstm_qkvif(p, xi, cfg)
    y, den, m, st = gla_chunked(q, k, v, log_f, log_i,
                                chunk=chunk or cfg.ssm_chunk, state=state,
                                backend=backend)
    return _mlstm_out(p, x, z, y, den, m, cfg), st


def mlstm_init_cache(cfg, batch: int, device="cuda"):
    di, H, hd = _mlstm_dims(cfg)
    return init_gla_state(batch, H, hd, hd, device)


def mlstm_step(p, x, state: GLAState, cfg):
    """x: (B,1,d)."""
    xn = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    xi, z = (xn @ p["w_up"]).chunk(2, dim=-1)
    q, k, v, log_i, log_f = _mlstm_qkvif(p, xi, cfg)
    y, den, m, st = gla_step(q[:, 0], k[:, 0], v[:, 0], log_f[:, 0],
                             log_i[:, 0], state)
    return _mlstm_out(p, x, z, y, den, m, cfg), st


# ----------------------------------------------------------------- sLSTM
def init_slstm(gen, cfg, dtype, device="cuda"):
    d = cfg.d_model
    H = cfg.num_heads
    hd = d // H
    f = int(d * 4 / 3) // 8 * 8
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": torch.zeros((d,), dtype=dtype, device=device),
        "w_gates": L.dense_init(gen, (d, 4 * d), dtype=torch.float32,
                                device=device),
        "r_gates": L.dense_init(gen, (H, hd, 4 * hd), scale=1.0,
                                dtype=torch.float32, device=device),
        "g_bias": torch.cat([torch.zeros((d,), **f32),
                             torch.full((d,), 3.0, **f32),
                             torch.zeros((2 * d,), **f32)]),
        "out_norm": torch.ones((H, hd), **f32),
        "w_up": L.dense_init(gen, (d, 2 * f), dtype=dtype, device=device),
        "w_down": L.dense_init(gen, (f, d), dtype=dtype, device=device),
    }


def slstm_init_cache(cfg, batch: int, device="cuda"):
    H = cfg.num_heads
    hd = cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, H, hd), **f32),
            "n": torch.zeros((batch, H, hd), **f32),
            "h": torch.zeros((batch, H, hd), **f32),
            "m": torch.full((batch, H, hd), NEG, **f32)}


def _slstm_cell(p, xg, st, cfg):
    """One time step. xg: (B, 4d) pre-computed input gates; st: state dict."""
    B = xg.shape[0]
    H = cfg.num_heads
    hd = cfg.d_model // H
    rec = torch.einsum("bhi,hij->bhj", st["h"], p["r_gates"])     # (B,H,4hd)
    g = xg.reshape(B, H, 4 * hd) + rec + p["g_bias"].reshape(H, 4 * hd)
    zt, ft, it, ot = g.chunk(4, dim=-1)                          # (B,H,hd)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + st["m"], it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(log_f + st["m"] - m_new)
    c = f_p * st["c"] + i_p * zt
    n = f_p * st["n"] + i_p
    h = ot * c / torch.maximum(n.abs(), torch.ones_like(n))
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_out(p, x, hs, cfg):
    """Group-norm the hidden states, GLU up/down, residual."""
    B, S, d = x.shape
    y = L.groupnorm_heads(hs, p["out_norm"], cfg.norm_eps).reshape(B, S, d)
    g, u = (y.to(x.dtype) @ p["w_up"]).chunk(2, dim=-1)
    return x + (F.gelu(g, approximate="tanh") * u) @ p["w_down"]


def slstm_forward(p, x, cfg, state=None):
    """x: (B,S,d) -> (y, final_state). Sequential loop over time."""
    B, S, d = x.shape
    xn = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    xg = xn.float() @ p["w_gates"]                                # (B,S,4d)
    st = state or slstm_init_cache(cfg, B, x.device)
    if x.device.type == "meta":
        # the dry run computes nothing: the S steps' cells as one batch of
        # B * S rows have every step's forward products and bytes, and no
        # per-token loop to dispatch.  Their backward carries no gradient
        # from step to step (nor does the mLSTM's folded scan), so an
        # xlstm-125m train_4k step counts 3.5% fewer flops than the loops
        out = _slstm_cell(p, xg.reshape(B * S, -1), {
            k: v.repeat_interleave(S, 0) for k, v in st.items()}, cfg)
        out = {k: v.reshape((B, S) + v.shape[1:]) for k, v in out.items()}
        return _slstm_out(p, x, out["h"], cfg), \
            {k: v[:, -1] for k, v in out.items()}
    hs = []
    for t in range(S):
        st = _slstm_cell(p, xg[:, t], st, cfg)
        hs.append(st["h"])
    return _slstm_out(p, x, torch.stack(hs, dim=1), cfg), st


def slstm_step(p, x, state, cfg):
    xn = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    xg = (xn.float() @ p["w_gates"])[:, 0]
    st = _slstm_cell(p, xg, state, cfg)
    return _slstm_out(p, x, st["h"][:, None], cfg), st


# ----------------------------------------------------------------- model
def init_params(cfg, seed: int = 0, device="cuda",
                place=None) -> L.ParamTree:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (the JAX package's distributions, not its draws).  ``place(path,
    tensor)`` cuts each leaf (JAX path ``blocks/<l>/...``) to a mesh
    rank's block as it is drawn; on the meta device nothing is drawn."""
    dtype = dtype_of(cfg.param_dtype)
    device = torch.device(device)
    gen = L.seeded(seed, device)
    put = place or L.keep_whole
    blocks = [L.place_tree(put, f"blocks/{l}", (
        init_slstm if is_slstm(cfg, l) else init_mlstm)(
            gen, cfg, dtype, device)) for l in range(cfg.num_layers)]
    return L.ParamTree({
        "embed": put("embed", L.init_embedding(gen, cfg.vocab_size,
                                               cfg.d_model, dtype, device)),
        "blocks": blocks,
        "final_norm": put("final_norm", torch.zeros(
            (cfg.d_model,), dtype=dtype, device=device)),
    })


def init_cache(cfg, batch: int, device="cuda"):
    return {"layers": [(slstm_init_cache if is_slstm(cfg, l)
                        else mlstm_init_cache)(cfg, batch, device)
                       for l in range(cfg.num_layers)],
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _layers(params, h, states, cfg, backend):
    """Every block over a segment, from ``states`` (None: fresh)."""
    L.require_unplaced(params, cfg, "a cached step")
    new = []
    for l, p in enumerate(params.blocks):
        st = None if states is None else states[l]
        if is_slstm(cfg, l):
            h, st = slstm_forward(p, h, cfg, state=st)
        else:
            h, st = mlstm_forward(p, h, cfg, state=st, backend=backend)
        new.append(st)
    return h, new


def forward(params, tokens, cfg, *, backend: str = "auto",
            remat: bool = False, collect_hidden: bool = False):
    """Scoring / training pass. tokens (B,S) -> (logits (B,S,V) f32, aux
    loss 0), and every block's output (L, B, S, d) if ``collect_hidden``.
    ``remat``: recompute each m/sLSTM block in the backward.  sLSTM's
    per-token loop has no kernel: autograd sees it as it is.

    Parameters placed on a device mesh (``params.tp``) run every block
    whole on every rank: its leaves gathered over the axes that split them
    (``TensorParallel.gather_tree``; the data gathers reduce-scatter their
    gradient, the model gathers take this rank's block of it), the rows
    split over the data axes, the tied embedding split over the
    vocabulary."""
    tp = _tp(params)
    h = embed_tokens(params, tokens, cfg)

    def block(l, p):
        def view():
            return p if tp is None else tp.gather_tree(f"blocks/{l}", p)
        if is_slstm(cfg, l):
            return lambda x: slstm_forward(view(), x, cfg)[0]
        return lambda x: mlstm_forward(view(), x, cfg, backend=backend)[0]

    h, hs = run_layers([block(l, p) for l, p in enumerate(params.blocks)],
                       h, remat=remat, collect_hidden=collect_hidden)
    out = (_logits(params, h, cfg), torch.zeros((), device=h.device))
    return out + (hs,) if collect_hidden else out


def prefill(params, tokens, cfg, *, backend: str = "auto"):
    """Returns (last-token logits (B,V), cache with final recurrent states)."""
    h = L.embed(params.embed, tokens).to(dtype_of(cfg.activ_dtype))
    h, states = _layers(params, h, None, cfg, backend)
    return _logits(params, h[:, -1, :], cfg), {
        "layers": states,
        "pos": torch.full((), tokens.shape[1], dtype=torch.int32,
                          device=tokens.device)}


def extend_step(params, tokens, cache, cfg, *, backend: str = "auto"):
    """Multi-token cached decode: tokens (B,T). Returns (logits (B,T,V),
    cache)."""
    h = L.embed(params.embed, tokens).to(dtype_of(cfg.activ_dtype))
    h, states = _layers(params, h, cache["layers"], cfg, backend)
    return _logits(params, h, cfg), {"layers": states,
                                     "pos": cache["pos"] + tokens.shape[1]}


def decode_step(params, token, cache, cfg):
    L.require_unplaced(params, cfg, "a cached step")
    h = L.embed(params.embed, token).to(dtype_of(cfg.activ_dtype))
    new = []
    for l, (p, st) in enumerate(zip(params.blocks, cache["layers"])):
        step = slstm_step if is_slstm(cfg, l) else mlstm_step
        h, st = step(p, h, st, cfg)
        new.append(st)
    return _logits(params, h[:, 0, :], cfg), {"layers": new,
                                              "pos": cache["pos"] + 1}


def replay_step(params, tokens, cache, count, cfg):
    """Batched accepted-prefix replay for speculative rewind (see
    ``ssm.replay``)."""
    return replay(lambda tok, c: decode_step(params, tok, c, cfg), tokens,
                  cache, count)
