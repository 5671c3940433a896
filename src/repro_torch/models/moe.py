"""Mixture-of-Experts sublayer (olmoe / granite-moe), the twin of the JAX
package's ``models/moe.py``.

Sort-based capacity dispatch (megablox-style, memory O(T*k + E*C*d)): the
token-expert assignments are sorted by expert id with a STABLE sort, each
expert takes its first ``C`` assignments in that order into an (E, C, d)
buffer, the experts run as batched matrix products, and the outputs are
gathered back and weighted by the renormalized gates in float32.  An
assignment past an expert's capacity goes to the out-of-range slot
``E*C`` and is dropped.  The router and the combine run in float32
whatever the model's dtype; the router's weights are float32 too.

No Pallas kernel covers this sublayer in the JAX package, so the expert
products here are library matrix products.  On a device mesh
``moe_apply`` takes ``moe_block_sharded`` (expert parallelism: each model
rank runs its own slice of the experts on its tokens, one sum over the
model axis) from 4096 tokens on, as the JAX package does; a
tensor-parallel cloud's blocks take it at every token count
(``launch/sharding.TensorParallel.moe``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def init_moe(gen, cfg, dtype, device="cuda"):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": dense_init(gen, (d, E), dtype=torch.float32, device=device),
        "w_gate": dense_init(gen, (E, d, f), dtype=dtype, device=device),
        "w_up": dense_init(gen, (E, d, f), dtype=dtype, device=device),
        "w_down": dense_init(gen, (E, f, d), dtype=dtype, device=device),
    }


def capacity(tokens: int, cfg) -> int:
    """Per-expert capacity: the dropless ``C = T`` up to 4096 tokens (top-k
    indices are distinct per token, so one expert receives at most T
    assignments), the Switch-style capacity factor above that, rounded up
    to a multiple of 8."""
    if tokens <= 4096:
        return tokens
    c = int(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _route(p, xt, k: int):
    """f32 router: (probs (T, E), renormalized gates (T, k), expert ids
    (T, k)).  Ties in the top-k go to the lower expert index, as
    ``jax.lax.top_k`` orders them (a stable descending sort)."""
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    return probs, gate / gate.sum(-1, keepdim=True), idx


def _experts(p, h):
    """SwiGLU experts over a batch laid out (E, C, d) -> (E, C, d)."""
    act = F.silu(torch.bmm(h, p["w_gate"])) * torch.bmm(h, p["w_up"])
    return torch.bmm(act, p["w_down"])


def _counts(e_flat, E: int):
    """Assignments per expert, (E,) int64: ``bincount`` written as a
    ``scatter_add`` into E zeros (the same integers, and a static shape a
    meta-device trace can follow)."""
    return torch.zeros(E, dtype=torch.long, device=e_flat.device) \
        .scatter_add_(0, e_flat.long(), torch.ones_like(e_flat,
                                                        dtype=torch.long))


def _aux(probs, counts, T: int, cfg, rows=None):
    """Switch-style load-balance loss of the router probabilities (T, E)
    and the assignment counts (E,).  ``rows`` (``sharding.DataRows``, in
    training on a mesh): the tokens are this data rank's rows of a batch;
    the token count and the counts are the global batch's, so the data
    ranks' terms sum to the unsharded loss."""
    E, k = cfg.num_experts, cfg.top_k
    if rows is None:
        me, Tg = probs.mean(0), T
    else:
        Tg = T * rows.n_sets
        me, counts = probs.sum(0) / Tg, rows.total(counts)
    ce = counts.float() / (Tg * k)
    return cfg.router_aux_coef * E * (me * ce).sum()


def moe_block(p, x, cfg, rows=None):
    """x: (B, S, d) -> (out (B, S, d), aux_loss () f32).  ``rows``: see
    ``_aux``."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    probs, gate, expert_idx = _route(p, xt, k)

    # ---- dispatch: sort token-expert assignments by expert id (stable)
    C = capacity(T, cfg)
    e_flat = expert_idx.reshape(-1)                           # (T*k,)
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    counts = _counts(e_flat, E)
    # ---- load-balance auxiliary loss (Switch-style)
    aux = _aux(probs, counts, T, cfg, rows)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=x.device) - starts[sorted_e]
    keep = pos_in_e < C
    dest = torch.where(keep, sorted_e * C + pos_in_e, E * C)  # E*C: dropped
    src_tok = order // k
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = xt[src_tok]
    out_e = _experts(p, buf[:E * C].reshape(E, C, d)).reshape(E * C, d)

    # ---- combine in f32: each token sums its k weighted expert outputs
    # in ascending expert order (the order of the sorted slots)
    flat = torch.cat([out_e, out_e.new_zeros((1, d))])        # drop row = 0
    contrib = flat[dest].float() * gate.reshape(-1)[order][:, None]
    combined = _combine(contrib, order, T, k)
    return combined.reshape(B, S, d).to(x.dtype), aux


def _combine(contrib, order, T: int, k: int):
    """Each token's k weighted slot outputs summed in ascending expert
    order (the order of the sorted slots): (T*k, d) f32 -> (T, d)."""
    slot_of = torch.empty_like(order)
    slot_of[order] = torch.arange(T * k, device=order.device)
    return contrib[slot_of.reshape(T, k).sort(dim=-1).values].sum(1)


def moe_block_sharded(p, x, cfg, mesh, dp_axes, ep_axis: str, rows=None):
    """Expert-parallel MoE (the survey's MoE-based modular collaboration,
    §2.1.2, mapped to a device mesh): the twin of the JAX package's
    ``shard_map`` version, run on this rank's local view.

    Layout: ``x`` is this rank's tokens (sharded over ``dp_axes``,
    replicated over ``ep_axis``); the experts split over ``ep_axis`` (``p``
    holds all E experts, cut here to this rank's ``E / n_ep``, or already
    only those); the router is replicated.  Each rank routes its LOCAL
    tokens to its LOCAL experts with the capacity counted over its local
    tokens, and the partial outputs are summed over ``ep_axis``; the aux
    loss is averaged over ``dp_axes`` (it is the same on every rank of
    ``ep_axis``, whose tokens and router are the same, so JAX's mean over
    that axis too needs no collective here).  With no ``dp_axes`` the
    tokens are whole on every rank: the tensor-parallel cloud's
    ``TensorParallel.moe``, at any token count.

    In training (``rows``, a ``sharding.DataRows``: the tokens are this
    data rank's rows, whole over ``ep_axis``) the aux loss is the global
    batch's share of ``_aux``, and the gradients of the experts' input
    and of the gates are summed over ``ep_axis`` (each rank's holds only
    its experts' part; ``Mesh.copy_to``); the router's path is the same
    on every rank and needs no sum."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    n_ep = mesh.axis_size(ep_axis)
    E_local = E // n_ep
    lo = mesh.axis_index(ep_axis) * E_local
    T = B * S
    C = capacity(T, cfg)
    xt = x.reshape(T, d)
    probs, gate, expert_idx = _route(p, xt, k)

    e_flat = expert_idx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    counts = _counts(e_flat, E)
    aux = _aux(probs, counts, T, cfg, rows)
    if rows is None:
        aux = mesh.all_reduce(aux, tuple(dp_axes), op="mean")
    xt, gate = mesh.copy_to(xt, ep_axis), mesh.copy_to(gate, ep_axis)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=x.device) - starts[sorted_e]
    mine = (sorted_e >= lo) & (sorted_e < lo + E_local) & (pos_in_e < C)
    dest = torch.where(mine, (sorted_e - lo) * C + pos_in_e, E_local * C)
    src_tok = order // k
    local = {n: w if w.shape[0] == E_local else w[lo:lo + E_local]
             for n, w in p.items() if n != "router"}
    buf = torch.zeros((E_local * C + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = xt[src_tok]
    out_e = _experts(local, buf[:E_local * C].reshape(E_local, C, d))
    flat = torch.cat([out_e.reshape(E_local * C, d), out_e.new_zeros((1, d))])
    contrib = flat[dest].float() * gate.reshape(-1)[order][:, None]
    combined = mesh.all_reduce(_combine(contrib, order, T, k), ep_axis)
    return combined.reshape(B, S, d).to(x.dtype), aux


def moe_apply(p, x, cfg):
    """The serving and training entry: expert parallelism when a mesh
    context is active, the token count is large (train/prefill, >= 4096)
    and the experts divide the model axis; the sort-based dispatch
    otherwise."""
    from repro_torch import runtime
    mesh = runtime.current_mesh()
    if mesh is not None and x.shape[0] * x.shape[1] >= 4096 \
            and cfg.num_experts % mesh.shape[runtime.model_axis()] == 0:
        return moe_block_sharded(p, x, cfg, mesh, runtime.data_axes(),
                                 runtime.model_axis())
    return moe_block(p, x, cfg)


def moe_block_dense_fallback(p, x, cfg):
    """Every token through every expert (O(E) FLOPs): the numerical oracle
    for the sparse dispatch above.  Returns (out, 0.0)."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    probs, gate, expert_idx = _route(p, xt, cfg.top_k)
    act = F.silu(torch.einsum("td,edf->tef", xt, p["w_gate"]))
    act = act * torch.einsum("td,edf->tef", xt, p["w_up"])
    out_e = torch.einsum("tef,efd->ted", act, p["w_down"])    # (T, E, d)
    w = torch.zeros_like(probs).scatter(1, expert_idx, gate)
    out = torch.einsum("ted,te->td", out_e.float(), w)
    return out.reshape(B, S, d).to(x.dtype), torch.zeros((), device=x.device)
