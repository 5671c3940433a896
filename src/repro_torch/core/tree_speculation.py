"""Token-tree speculation (survey §2.4.4 — LLMCad / SpecInfer / Sequoia /
OPT-Tree style).

The draft expands a TREE of candidate continuations; the target verifies
every node in ONE pass under the tree's ancestor mask, then the longest
target-consistent root path is accepted by per-node rejection sampling.

Two forms, as in the JAX package:

* the per-request oracle path — ``TokenTree``, ``build_tree`` (greedy
  top-k expansion replaying each node's ancestor path on the draft),
  ``verify_tree`` (one tree-masked target extend, the Hopper tree-verify
  kernel on CUDA, and the acceptance walk on the host) and
  ``TreeSpecDecoder`` (B = 1, attention targets only);
* the pieces the batched ``tree`` lane runs on: the static ``TreePlan``
  topology, the default ``branching_for`` plan, the batched acceptance
  walk ``tree_accept`` and its sequential oracle ``tree_accept_ref``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class TokenTree:
    """Flattened tree.  Node 0 is the root token (the pending "last
    token"); nodes are topologically ordered (parent index < child
    index)."""
    tokens: np.ndarray          # (n,) int32
    parent: np.ndarray          # (n,) int32; parent[0] = -1
    draft_logp: np.ndarray      # (n, V) draft log-probs AT each node's
                                # position (the distribution the node's
                                # token was drawn from)

    @property
    def n(self) -> int:
        return len(self.tokens)

    def ancestors(self, i: int) -> List[int]:
        return _ancestor_indices(self.parent, i)

    def attention_mask(self) -> np.ndarray:
        """(n, n) bool: node i attends to j iff j is an ancestor of i (or
        i itself)."""
        m = np.zeros((self.n, self.n), bool)
        for i in range(self.n):
            m[i, self.ancestors(i)] = True
        return m

    def children(self, i: int) -> List[int]:
        return [j for j in range(self.n) if self.parent[j] == i]

    def depths(self) -> np.ndarray:
        d = np.zeros(self.n, np.int32)
        for i in range(1, self.n):
            d[i] = d[self.parent[i]] + 1
        return d


def _ancestor_indices(parent, i: int) -> List[int]:
    """Root-first path of node indices from the root to ``i``."""
    path = []
    while i != -1:
        path.append(i)
        i = int(parent[i])
    return path[::-1]


def _top_k(x, k: int):
    """Indices of the k largest entries of a 1-D tensor, ties to the lower
    index first (``jax.lax.top_k``'s order; a stable descending sort)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def build_tree(draft_model, draft_params, draft_cache, last_token: int,
               branching: Sequence[int], temperature: float = 1.0, *,
               attn_backend: str = "auto"):
    """Greedy top-k tree expansion (OPT-Tree style, static branching plan)
    for ONE sequence.

    branching: e.g. (3, 2, 1) — 3 children of the root, 2 of each of
    those, …  For each frontier node the draft cache is brought to hold the
    node's ancestor path by an extend from the round's start (a rewind of
    ``pos`` for a KV cache, a copy of the state for a recurrent one) and a
    decode step of the node itself; the node's children are the top
    ``width`` tokens of log_softmax(logits / max(T, 1e-6)) in float32.
    ``draft_cache`` keeps its ``pos`` (a KV cache's entries past it are
    scratch).  Returns (TokenTree, draft_calls)."""
    b = attn_backend
    dev = draft_cache["pos"].device
    tokens, parent = [int(last_token)], [-1]
    logps: List[Optional[np.ndarray]] = [None]
    frontier = [0]
    calls = 0
    for width in branching:
        new_frontier = []
        for node in frontier:
            path = [tokens[i] for i in _ancestor_indices(parent, node)]
            cache = dict(draft_cache)     # this round's start, every node
            if len(path) > 1:
                _, cache = draft_model.extend_step(
                    draft_params, torch.as_tensor([path[:-1]],
                                                  dtype=torch.int32,
                                                  device=dev),
                    cache, attn_backend=b)
                calls += 1
            lg, cache = draft_model.decode_step(
                draft_params, torch.full((1, 1), path[-1], dtype=torch.int32,
                                         device=dev), cache, attn_backend=b)
            calls += 1
            logp = torch.log_softmax(lg[0].float() / max(temperature, 1e-6),
                                     dim=-1)
            logp_h = logp.cpu().numpy()
            for t in _top_k(logp, width).tolist():
                tokens.append(int(t))
                parent.append(node)
                logps.append(logp_h)
                new_frontier.append(len(tokens) - 1)
        frontier = new_frontier
    V = logps[1].shape[0] if len(logps) > 1 else 1
    logp_arr = np.stack([np.zeros(V, np.float32) if lp is None else lp
                         for lp in logps])
    return TokenTree(np.asarray(tokens, np.int32),
                     np.asarray(parent, np.int32), logp_arr), calls


def verify_tree(target_model, target_params, target_cache, tree: TokenTree,
                rng: np.random.Generator, temperature: float = 1.0, *,
                attn_backend: str = "auto"):
    """One target extend over every tree node under the tree's ancestor
    mask, with RoPE positions ``pos + depth`` (on CUDA the Hopper
    tree-verify kernel at B = 1), then the acceptance walk on the host:
    from the root, accept one child per level by rejection sampling
    against the draft distribution it was drawn from (siblings tried in
    order, union-bound residual on total rejection), else resample and
    stop.  At T = 0 the walk draws nothing that matters: the one-hot
    target makes every comparison 0 or 1 and every residual one-hot.

    ``rng`` is the numpy generator of the walk's uniforms.  Returns
    (accepted tokens without the root, next token, new target cache,
    nodes verified)."""
    from repro_torch.core.speculative import _probs
    dev = target_cache["pos"].device
    mask = torch.as_tensor(tree.attention_mask(), device=dev)
    toks = torch.as_tensor(tree.tokens, dtype=torch.int32, device=dev)[None]
    q_pos = target_cache["pos"] + torch.as_tensor(tree.depths(), device=dev)
    t_logits, new_cache = target_model.extend_step(
        target_params, toks, target_cache, block_mask=mask,
        q_positions=q_pos, attn_backend=attn_backend)
    # per node: the one-hot of the first argmax at T = 0, else softmax
    probs = _probs(t_logits[0], temperature).cpu().numpy()    # (n, V)

    accepted: List[int] = []
    node = 0
    while True:
        p = probs[node]
        chosen = None
        q_total = np.zeros_like(p)
        for c in tree.children(node):
            q = np.exp(tree.draft_logp[c])
            q = q / q.sum()
            tok = int(tree.tokens[c])
            if rng.uniform() < min(1.0, p[tok] / max(q[tok], 1e-20)):
                chosen = c
                break
            q_total = np.maximum(q_total, q)   # union bound on tried branches
        if chosen is None:
            resid = np.clip(p - q_total, 0.0, None)
            if resid.sum() <= 0:
                resid = p
            resid = resid / resid.sum()
            return accepted, int(rng.choice(len(resid), p=resid)), \
                new_cache, tree.n
        accepted.append(int(tree.tokens[chosen]))
        node = chosen
        if not tree.children(node):
            return accepted, int(rng.choice(len(probs[node]),
                                            p=probs[node])), \
                new_cache, tree.n


class TreeSpecDecoder:
    """Tree-speculative decoding loop for ONE sequence (KV-cache targets
    only): per round, ``build_tree`` on the draft, ``verify_tree`` on the
    target, then both caches rewind to the round's start and replay the
    accepted linear path (the tree slots are discarded).  Random draws of
    the walk come from a numpy generator seeded from ``gen``."""

    def __init__(self, draft_model, target_model, *,
                 branching: Sequence[int] = (3, 2, 1),
                 temperature: float = 1.0, attn_backend: str = "auto"):
        if not target_model.rewindable_cache:
            raise ValueError("tree speculation needs an attention target "
                             "(a recurrence is linear-order)")
        self.draft, self.target = draft_model, target_model
        self.branching = tuple(branching)
        self.temperature = temperature
        self.attn_backend = attn_backend

    def generate(self, draft_params, target_params, prompt, max_new: int,
                 gen=None):
        """prompt: (S,) or (1, S) ints.  Returns (tokens list, stats dict:
        rounds, target_passes, draft_calls, nodes_verified,
        accepted_per_round)."""
        from repro_torch.core.speculative import (device_of, generator_for,
                                                  prompt_tensor)
        dev = device_of(target_params)
        gen = generator_for(target_params, gen)
        b = self.attn_backend
        prompt = prompt_tensor(prompt, dev)
        n_tree = 1 + int(np.sum(np.cumprod(self.branching)))
        max_seq = prompt.shape[1] + max_new + (max_new + 1) * n_tree + 8
        _, d_cache = self.draft.prefill(draft_params,
                                        {"tokens": prompt[:, :-1]},
                                        max_seq=max_seq, attn_backend=b)
        _, t_cache = self.target.prefill(target_params,
                                         {"tokens": prompt[:, :-1]},
                                         max_seq=max_seq, attn_backend=b)
        out: List[int] = []
        last = int(prompt[0, -1])
        stats = {"rounds": 0, "target_passes": 0, "draft_calls": 0,
                 "nodes_verified": 0, "accepted_per_round": []}
        while len(out) < max_new:
            seed = int(torch.randint(0, 2**31 - 1, (), generator=gen,
                                     device=gen.device))
            t_pos0 = int(t_cache["pos"])
            tree, calls = build_tree(self.draft, draft_params, d_cache, last,
                                     self.branching, self.temperature,
                                     attn_backend=b)
            stats["draft_calls"] += calls
            acc, nxt, t_cache, n_nodes = verify_tree(
                self.target, target_params, t_cache, tree,
                np.random.default_rng(seed), self.temperature,
                attn_backend=b)
            stats["rounds"] += 1
            stats["target_passes"] += 1
            stats["nodes_verified"] += n_nodes
            stats["accepted_per_round"].append(len(acc))
            out.extend(acc + [nxt])
            # both caches: rewind, then replay the accepted linear path so
            # the layout is linear again
            replay = torch.as_tensor([[last] + acc], dtype=torch.int32,
                                     device=dev)
            t_cache = self.target.rewind(t_cache, t_pos0)
            _, t_cache = self.target.extend_step(target_params, replay,
                                                 t_cache, attn_backend=b)
            stats["target_passes"] += 1
            if self.draft.rewindable_cache:
                d_cache = self.draft.rewind(d_cache, t_pos0)
            _, d_cache = self.draft.extend_step(draft_params, replay,
                                                d_cache, attn_backend=b)
            stats["draft_calls"] += 1
            last = nxt
        return out[:max_new], stats


class TreePlan:
    """Static packed topology for BATCHED tree speculation.

    A fixed branching plan makes every per-round shape static: node i's
    parent, depth and ancestor mask are numpy constants.  Nodes are
    level-contiguous (root = node 0, then every level-1 node, …), which
    makes the children of the level-``l`` node of rank ``r`` a pure
    arithmetic range — the acceptance walk needs no gather over a parent
    table.

    The packed width is pow2-padded (``n_pad``); pad nodes carry a
    self-only mask row (so their softmax rows stay finite) and are never
    visited by the walk.
    """

    def __init__(self, branching: Sequence[int]):
        branching = tuple(int(b) for b in branching)
        if not branching or any(b < 1 for b in branching):
            raise ValueError(f"bad branching plan {branching!r}")
        widths = np.cumprod(branching)               # level 1..D node counts
        self.branching = branching
        self.depth = len(branching)                  # accepted path <= depth
        self.n = 1 + int(widths.sum())
        self.n_pad = 1 << (self.n - 1).bit_length()
        # level_lo[l] = first node index of level l (level 0 = the root)
        self.level_lo = (0,) + tuple(1 + int(widths[:l].sum())
                                     for l in range(self.depth))
        # children of the rank-r node of level l:
        #   level_lo[l+1] + r*branching[l] + [0, branching[l])
        parent = np.full(self.n_pad, -1, np.int32)
        depths = np.zeros(self.n_pad, np.int32)
        for l in range(1, self.depth + 1):
            lo, w, k = self.level_lo[l], int(widths[l - 1]), branching[l - 1]
            for r in range(w):
                parent[lo + r] = self.level_lo[l - 1] + r // k
                depths[lo + r] = l
        self.parent = parent                         # pads: -1
        self.depths = depths                         # pads: 0
        mask = np.eye(self.n_pad, dtype=bool)        # pads: self-only rows
        for i in range(self.n):
            j = i
            while j != -1:
                mask[i, j] = True
                j = int(parent[j]) if j else -1
        self.mask = mask
        # draft expansion: level l's new nodes are [lo, hi) and their
        # parents are the previous level — one tree-masked extend over the
        # prefix [0, lo) yields every parent row's logits
        self.levels = tuple((self.level_lo[l],
                             self.level_lo[l] + int(widths[l - 1]))
                            for l in range(1, self.depth + 1))
        # children[l]: level l + 1's nodes grouped by parent, as (parent,
        # child nodes) in parent order — the top-k expansion's static
        # grouping, so a captured round walks no parent table
        self.children = tuple(
            tuple((p, tuple(c for c in range(lo, hi) if parent[c] == p))
                  for p in sorted({int(parent[c]) for c in range(lo, hi)}))
            for lo, hi in self.levels)


def branching_for(width: int, gamma: int) -> tuple:
    """Default branching plan for ``--spec-tree-width`` at draft depth
    ``gamma``: fan out wide at the root (where the draft is least certain),
    once more below it, then single chains — the Sequoia/OPT-Tree shape
    that keeps node count linear in depth."""
    width, gamma = max(int(width), 1), max(int(gamma), 1)
    return (width,) if gamma == 1 else (width, 2) + (1,) * (gamma - 2)


def _probs(logits, temperature: float):
    """softmax(l / T), or the tie-split one-hot of the maxima at T = 0."""
    logits = logits.float()
    if temperature == 0.0:
        p = (logits >= logits.amax(-1, keepdim=True)).float()
        return p / p.sum(-1, keepdim=True)
    return torch.softmax(logits / temperature, dim=-1)


def _sample(dist, u, temperature: float):
    """Inverse-CDF draw per row (as ``spec_verify``); at T = 0 the first
    maximum, whatever ``u`` is (the inverse CDF gives token 0 at u = 0)."""
    if temperature == 0.0:
        return dist.argmax(-1)
    cdf = torch.cumsum(dist, dim=-1)
    return (cdf < u[:, None]).sum(-1).clamp(max=dist.shape[-1] - 1)


def tree_accept(t_logits, q_logits, tokens, plan: TreePlan, u_acc, u_res, *,
                temperature: float = 1.0):
    """Packed-tree acceptance walk for a GROUP of slots: from the root,
    rejection-sample one child per level against the draft distribution it
    was drawn from (siblings tried in order, union-bound residual on total
    rejection), the batched twin of the JAX package's vmapped
    ``tree_accept``.

    t_logits/q_logits: (G, n_pad, V) target/draft logits per node (q at
    node c = its PARENT's draft logits, the distribution c's token was
    drawn from); tokens: (G, n_pad) int; u_acc (G, depth, max branching)
    and u_res (G, depth + 1) the uniforms, drawn by the caller (the JAX
    function draws the same shapes from its key).  At T = 0 the result does
    not depend on them: a child is accepted iff it carries a target
    maximum, and every resample or bonus token is the first maximum.

    Returns (n_acc (G,), emitted (G, depth+1), path (G, depth+1)) as int32:
    slot g emits ``emitted[g, :n_acc[g]+1]``, whose last entry is the
    resample/bonus token, and ``path[g, d]`` is its accepted node INDEX at
    depth d (``path[:, 0] = 0``; entries past ``n_acc`` are dead) — the
    permutation ``SpecOps.commit_permute`` relocates the K/V rows by."""
    G = tokens.shape[0]
    dev = t_logits.device
    D = plan.depth
    greedy = temperature == 0.0
    rows = torch.arange(G, device=dev)
    tokens = tokens.long()
    cur = torch.zeros((G,), dtype=torch.long, device=dev)
    alive = torch.ones((G,), dtype=torch.bool, device=dev)
    n_acc = torch.zeros((G,), dtype=torch.long, device=dev)
    emitted, path = [], [cur]
    for l in range(D):
        k = plan.branching[l]
        child0 = plan.level_lo[l + 1] + (cur - plan.level_lo[l]) * k
        p = _probs(t_logits[rows, cur], temperature)                # (G, V)
        chosen = torch.full((G,), -1, dtype=torch.long, device=dev)
        q_total = torch.zeros_like(p)
        for j in range(k):
            c = child0 + j
            tok_c = tokens[rows, c]
            q_c = _probs(q_logits[rows, c], temperature)
            ratio = p[rows, tok_c] / q_c[rows, tok_c].clamp(min=1e-20)
            u = torch.zeros_like(ratio) if greedy else u_acc[:, l, j]
            tried = chosen < 0
            acc_j = tried & (u < ratio.clamp(max=1.0))
            q_total = torch.where((tried & ~acc_j)[:, None],
                                  torch.maximum(q_total, q_c), q_total)
            chosen = torch.where(acc_j, c, chosen)
        resid = (p - q_total).clamp(min=0.0)
        tot = resid.sum(-1, keepdim=True)
        resid = torch.where(tot > 0, resid / tot.clamp(min=1e-20), p)
        hit = chosen >= 0
        safe = chosen.clamp(min=0)
        emit = torch.where(hit, tokens[rows, safe],
                           _sample(resid, u_res[:, l], temperature))
        emitted.append(torch.where(alive, emit, 0))
        n_acc = n_acc + (alive & hit).long()
        cur = torch.where(hit, safe, cur)
        path.append(cur)
        alive = alive & hit
    bonus = _sample(_probs(t_logits[rows, cur], temperature), u_res[:, D],
                    temperature)
    emitted.append(torch.where(alive, bonus, 0))
    return (n_acc.to(torch.int32), torch.stack(emitted, 1).to(torch.int32),
            torch.stack(path, 1).to(torch.int32))


def tree_accept_ref(t_logits, q_logits, tokens, plan: TreePlan, u_acc, u_res,
                    *, temperature: float = 1.0):
    """Sequential rejection-sampling oracle of ``tree_accept`` for ONE
    slot, the twin of the JAX package's ``tree_accept_ref``: python control
    flow over numpy arrays, with the uniforms given (u_acc (depth, max
    branching), u_res (depth + 1,)) where the JAX function draws them from
    its key.  At T = 0 it is the JAX oracle's tie-split walk, inverse-CDF
    draws included.  Returns (n_acc, emitted list of n_acc + 1 ints)."""
    t_logits = np.asarray(t_logits, np.float32)
    q_logits = np.asarray(q_logits, np.float32)
    tokens = np.asarray(tokens)
    u_acc, u_res = np.asarray(u_acc), np.asarray(u_res)
    V = t_logits.shape[-1]

    def probs(lg):
        if temperature == 0.0:
            p = (lg >= lg.max()).astype(np.float32)
            return p / p.sum()
        z = np.exp((lg - lg.max()) / temperature)
        return z / z.sum()

    def sample(dist, u):
        return min(int((np.cumsum(dist) < u).sum()), V - 1)

    cur, n_acc, emitted = 0, 0, []
    for l in range(plan.depth):
        k = plan.branching[l]
        child0 = plan.level_lo[l + 1] + (cur - plan.level_lo[l]) * k
        p = probs(t_logits[cur])
        chosen = None
        q_total = np.zeros(V, np.float32)
        for j in range(k):
            c = child0 + j
            q_c = probs(q_logits[c])
            tok = int(tokens[c])
            if u_acc[l, j] < min(1.0, p[tok] / max(q_c[tok], 1e-20)):
                chosen = c
                break
            q_total = np.maximum(q_total, q_c)
        if chosen is None:
            resid = np.clip(p - q_total, 0.0, None)
            resid = resid / resid.sum() if resid.sum() > 0 else p
            emitted.append(sample(resid, u_res[l]))
            return n_acc, emitted
        emitted.append(int(tokens[chosen]))
        n_acc += 1
        cur = chosen
    emitted.append(sample(probs(t_logits[cur]), u_res[plan.depth]))
    return n_acc, emitted
