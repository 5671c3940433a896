"""Token-tree speculation (survey §2.4.4 — LLMCad / SpecInfer / Sequoia /
OPT-Tree style), the pieces the batched ``tree`` lane runs on: the static
``TreePlan`` topology, the default ``branching_for`` plan and the batched
acceptance walk ``tree_accept``.

The draft expands a TREE of candidate continuations; the target verifies
every node in ONE pass under the tree's ancestor mask, then the longest
target-consistent root path is accepted by per-node rejection sampling.
The per-request ``TokenTree`` / ``TreeSpecDecoder`` oracle path of the JAX
package is a later slice of the port.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


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
