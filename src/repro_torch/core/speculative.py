"""Token-level mixture: speculative decoding (survey §2.4): the
per-request ``SpecDecoder`` and the batched linear, tree and self lanes.

Edge SLM drafts gamma tokens; cloud LLM verifies them in ONE parallel pass
(modified rejection sampling, Leviathan et al. / survey §2.4.1).  The
scheme is lossless: the output distribution equals sampling from the target
model alone.

KV caches roll back rejected tokens by resetting ``pos`` — stale entries
are masked out and later overwritten; recurrent state (ssm / xlstm /
hybrid) rolls back by a batched replay of each slot's accepted prefix from
the round's snapshot (``SpecOps.commit``).  The per-request
``SpecDecoder`` (B = 1, one host round trip per draft token) snapshots the
whole recurrent state instead and replays the accepted prefix with one
extend from it.

Invariant maintained by ``SpecDecoder.generate``: both caches contain
``sequence[:-1]``; ``sequence[-1]`` ("last token") is pending.
"""
from __future__ import annotations

from typing import List

import dataclasses

import numpy as np
import torch

from repro_torch.analysis import hot_path
from repro_torch.core.self_speculative import partial_extend_step
from repro_torch.core.seq_state import (SpecOps, host_pull, layout_for,
                                        next_tokens)
from repro_torch.core.tree_speculation import (TreePlan, branching_for,
                                               tree_accept)
from repro_torch.kernels import ops
from repro_torch.kernels.spec_verify import spec_verify_plain
from repro_torch.models.model import require_token_prompts

FAMILIES_WITH_TREES = ("dense", "moe", "vlm")


def _probs(logits, temperature: float):
    """softmax(l/T) with T=0 -> one-hot argmax (greedy)."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.nn.functional.one_hot(
            logits.argmax(-1), logits.shape[-1]).float()
    return torch.softmax(logits / temperature, dim=-1)


def speculative_sample(gen, target_logits, draft_logits, draft_tokens,
                       temperature: float = 1.0):
    """Modified rejection sampling over a gamma-token draft (one sequence;
    the twin of the JAX package's ``speculative_sample``, with the random
    numbers drawn from the ``torch.Generator`` ``gen``).

    target_logits: (gamma+1, V); draft_logits: (gamma, V); draft_tokens:
    (gamma,).  Returns (n_accepted, next_token) as Python ints: the emitted
    tokens are draft_tokens[:n_accepted] + [next_token]."""
    gamma = draft_tokens.shape[0]
    dev = target_logits.device
    p = _probs(target_logits, temperature)            # (gamma+1, V)
    q = _probs(draft_logits, temperature)             # (gamma, V)
    toks = draft_tokens.long()[:, None]
    ratio = p[:gamma].gather(1, toks)[:, 0] / \
        torch.clamp(q.gather(1, toks)[:, 0], min=1e-20)
    u = torch.rand((gamma,), generator=gen, device=dev)
    accept = u < torch.clamp(ratio, max=1.0)
    n_acc = int(torch.cumprod(accept.int(), 0).sum())
    q_pad = torch.cat([q, torch.zeros_like(q[:1])], dim=0)
    resid = torch.clamp(p[n_acc] - q_pad[n_acc], min=0.0)
    total = resid.sum()
    resid = resid / torch.clamp(total, min=1e-20) if total > 0 else p[n_acc]
    nxt = int(torch.multinomial(resid, 1, generator=gen)[0])
    return n_acc, nxt


def acceptance_rate_bound(p, q):
    """Theoretical per-token acceptance probability: 1 - TV(p, q) =
    sum min(p, q) over the last axis."""
    return torch.minimum(p, q).sum(-1)


@dataclasses.dataclass
class SpecStats:
    draft_calls: int = 0
    target_passes: int = 0
    replay_passes: int = 0
    rounds: int = 0
    accepted: List[int] = dataclasses.field(default_factory=list)
    tokens_out: int = 0

    @property
    def mean_accepted(self) -> float:
        return float(np.mean(self.accepted)) if self.accepted else 0.0

    @property
    def tokens_per_target_pass(self) -> float:
        tp = self.target_passes + self.replay_passes
        return self.tokens_out / tp if tp else 0.0

    def summary(self) -> dict:
        return {
            "rounds": self.rounds,
            "draft_calls": self.draft_calls,
            "target_passes": self.target_passes,
            "replay_passes": self.replay_passes,
            "mean_accepted": self.mean_accepted,
            "tokens_out": self.tokens_out,
            "tokens_per_target_pass": self.tokens_per_target_pass,
        }


class AdaptiveGamma:
    """PEARL/DISCO-style draft-length control: lengthen the draft when
    acceptance is high, shorten when the target keeps rejecting."""

    def __init__(self, gamma: int = 4, lo: int = 1, hi: int = 16,
                 up: float = 0.85, down: float = 0.4):
        self.gamma, self.lo, self.hi, self.up, self.down = \
            gamma, lo, hi, up, down

    def update(self, n_acc: int, gamma_used: int) -> int:
        rate = n_acc / max(gamma_used, 1)
        if rate >= self.up:
            self.gamma = min(self.gamma + 1, self.hi)
        elif rate <= self.down:
            self.gamma = max(self.gamma - 1, self.lo)
        return self.gamma


def device_of(params) -> torch.device:
    return next(params.parameters()).device


def generator_for(params, gen=None) -> torch.Generator:
    """``gen``, or a fresh generator seeded 0 on the parameters' device
    (the JAX loops' default ``PRNGKey(0)``)."""
    if gen is not None:
        return gen
    gen = torch.Generator(device=device_of(params))
    gen.manual_seed(0)
    return gen


def prompt_tensor(prompt, device) -> torch.Tensor:
    """A (S,) or (1, S) prompt as a (1, S) int32 tensor on ``device``."""
    t = torch.as_tensor(np.asarray(prompt, np.int32), device=device)
    return t.reshape(1, -1) if t.dim() == 1 else t


class SpecDecoder:
    """Edge-draft / cloud-verify decoding loop for ONE sequence (B = 1):
    a host round trip per draft token, the JAX package's reference loop.

    Each round snapshots both caches (``pos`` of a KV cache, the whole
    state of a recurrent one), drafts gamma tokens plus one aligning step,
    verifies them in ONE target extend, accepts through
    ``speculative_sample`` (one-hot argmax at T = 0, as the reference), and
    commits by rewinding ``pos`` or by replaying the accepted prefix from
    the snapshot.  Random draws come from a ``torch.Generator``.
    ``attn_backend`` goes to every model call ("auto": the Hopper kernels
    on CUDA tensors)."""

    def __init__(self, draft_model, target_model, *, gamma: int = 4,
                 temperature: float = 1.0, adaptive: bool = False,
                 attn_backend: str = "auto"):
        for m in (draft_model, target_model):
            require_token_prompts(m.cfg, "SpecDecoder")
        self.draft = draft_model
        self.target = target_model
        self.gamma = gamma
        self.temperature = temperature
        self.adaptive = AdaptiveGamma(gamma) if adaptive else None
        self.attn_backend = attn_backend

    def _snapshot(self, model, cache):
        if model.rewindable_cache:
            return int(cache["pos"])
        return dict(cache)        # recurrent steps build new state tensors

    def _extend(self, model, params, tokens, cache):
        return model.extend_step(params, tokens, cache,
                                 attn_backend=self.attn_backend)[1]

    def generate(self, draft_params, target_params, prompt, max_new: int,
                 gen=None):
        """prompt: (S,) or (1, S) ints.  Returns (tokens list, SpecStats)."""
        dev = device_of(target_params)
        gen = generator_for(target_params, gen)
        prompt = prompt_tensor(prompt, dev)
        if prompt.shape[0] != 1:
            raise ValueError("SpecDecoder operates on B=1 sequences")
        S = prompt.shape[1]
        max_seq = S + max_new + 2 * max(self.gamma, 16) + 8
        b = self.attn_backend
        _, d_cache = self.draft.prefill(draft_params,
                                        {"tokens": prompt[:, :-1]},
                                        max_seq=max_seq, attn_backend=b)
        _, t_cache = self.target.prefill(target_params,
                                         {"tokens": prompt[:, :-1]},
                                         max_seq=max_seq, attn_backend=b)
        stats = SpecStats()
        out: List[int] = []
        last = prompt[:, -1:]                          # pending token (1, 1)
        while len(out) < max_new:
            gamma = self.adaptive.gamma if self.adaptive else self.gamma
            d_snap = self._snapshot(self.draft, d_cache)
            t_snap = self._snapshot(self.target, t_cache)

            # ---- draft gamma tokens (+1 call to keep the cache aligned)
            draft_tokens, draft_logits = [], []
            tok = last
            for _ in range(gamma):
                lg, d_cache = self.draft.decode_step(draft_params, tok,
                                                     d_cache, attn_backend=b)
                stats.draft_calls += 1
                nxt = next_tokens(lg, self.temperature, gen)
                draft_logits.append(lg[0])
                draft_tokens.append(int(nxt[0]))
                tok = nxt[:, None]
            _, d_cache = self.draft.decode_step(draft_params, tok, d_cache,
                                                attn_backend=b)
            stats.draft_calls += 1

            # ---- verify in one target pass over [last, d_0..d_{gamma-1}]
            drafted = torch.as_tensor(draft_tokens, dtype=torch.int32,
                                      device=dev)
            ver_in = torch.cat([last, drafted[None, :]], dim=1)
            t_logits, t_cache = self.target.extend_step(
                target_params, ver_in, t_cache, attn_backend=b)
            stats.target_passes += 1
            n_acc, next_tok = speculative_sample(
                gen, t_logits[0], torch.stack(draft_logits), drafted,
                temperature=self.temperature)

            # ---- commit & resync
            out.extend(draft_tokens[:n_acc] + [next_tok])
            stats.rounds += 1
            stats.accepted.append(n_acc)
            if self.adaptive:
                self.adaptive.update(n_acc, gamma)
            acc = ver_in[:, :n_acc + 1]                # [last] + accepted
            if self.target.rewindable_cache:
                t_cache = self.target.rewind(t_cache, t_snap + n_acc + 1)
            else:
                t_cache = self._extend(self.target, target_params, acc,
                                       t_snap)
                stats.replay_passes += 1
            if self.draft.rewindable_cache:
                d_cache = self.draft.rewind(d_cache, d_snap + n_acc + 1)
            else:
                d_cache = self._extend(self.draft, draft_params, acc, d_snap)
                stats.replay_passes += 1
            last = torch.full((1, 1), next_tok, dtype=torch.int32,
                              device=dev)
        stats.tokens_out = len(out)
        return out[:max_new], stats


def autoregressive_baseline(model, params, prompt, max_new: int, gen=None,
                            temperature: float = 1.0,
                            attn_backend: str = "auto"):
    """Plain target-only decoding (B = 1, a host round trip per token) —
    the survey's cloud-only baseline.  Returns the token list."""
    require_token_prompts(model.cfg, "autoregressive_baseline")
    dev = device_of(params)
    gen = generator_for(params, gen)
    prompt = prompt_tensor(prompt, dev)
    _, cache = model.prefill(params, {"tokens": prompt[:, :-1]},
                             max_seq=prompt.shape[1] + max_new + 4,
                             attn_backend=attn_backend)
    tok = prompt[:, -1:]
    out = []
    for _ in range(max_new):
        lg, cache = model.decode_step(params, tok, cache,
                                      attn_backend=attn_backend)
        nxt = next_tokens(lg, temperature, gen)
        out.append(int(nxt[0]))
        tok = nxt[:, None]
    return out


class BatchedSpecDecoder:
    """Grouped edge-draft / cloud-verify decoding for the serving scheduler.

    Operates on a padded GROUP of requests with batched caches; every lane
    ends a round in ONE host pull.  ``mode`` picks the lane:

    * ``"linear"`` (default) — drafting is gamma+1 batched decode steps,
      verification ONE batched target extend, acceptance ONE call of the
      spec-verify kernel (its plain version on the CPU or under
      ``attn_backend="plain"``) with uniforms drawn from the caller's
      ``torch.Generator``, and the per-slot rewind a ``pos`` write.  Dense
      and paged layouts share the rounds through ``core.seq_state.SpecOps``;
      a paged caller must have grown each slot's block table to cover
      prompt + budget + one round of draft overdraft.
    * ``"tree"`` — each slot drafts a PACKED TOKEN TREE (static
      ``TreePlan``, pow2-padded width) level by level via top-k expansion,
      each level a rectangular tree-masked extend over only its new nodes;
      verification is ONE batched tree-masked target extend (the Hopper
      tree-verify kernel on CUDA) and ``tree_accept`` walks the longest
      target-consistent root path.  Both commits are row permutes
      (``SpecOps.commit_permute``).  Group states are always dense.
    * ``"self"`` — no second model: the draft model's OWN early-exit head
      (first ``exit_layer`` blocks + shared LM head,
      ``self_speculative.partial_extend_step``) drafts into the shared
      cache and the full depth verifies, overwriting the shallow K/V;
      acceptance through the spec-verify kernel as on the linear lane.
      One cache, one set of parameters; use ``generate_group_self``.

    ``counters`` accumulates totals across calls: member_rounds (verify
    passes), draft_tokens, verify_tokens, accepted_tokens and
    emitted_tokens.
    """

    def __init__(self, draft_model, target_model, *, gamma: int = 4,
                 temperature: float = 0.0, kv_layout: str = "dense",
                 mode: str = "linear", branching=None, exit_layer=None,
                 attn_backend: str = "auto"):
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if mode not in ("linear", "tree", "self"):
            raise ValueError(f"unknown speculation mode {mode!r}; "
                             "known: linear | tree | self")
        self.gamma = gamma
        self.temperature = temperature
        self.kv_layout = kv_layout
        self.mode = mode
        self.attn_backend = attn_backend
        self.counters = {"member_rounds": 0, "draft_tokens": 0,
                         "verify_tokens": 0, "accepted_tokens": 0,
                         "emitted_tokens": 0}
        if mode == "linear":
            self._dops = SpecOps(draft_model,
                                 layout_for(draft_model, kv_layout),
                                 attn_backend)
            self._tops = SpecOps(target_model,
                                 layout_for(target_model, kv_layout),
                                 attn_backend)
            self._per_round = (gamma, gamma + 1)
        elif mode == "tree":
            if not self.tree_supported(draft_model, target_model):
                raise ValueError(
                    "tree speculation needs dense-layout attention families "
                    f"on both models, got {draft_model.cfg.family!r} / "
                    f"{target_model.cfg.family!r}")
            # tree groups always run dense per-slot caches: block masks are
            # a dense-layout feature (paged extends stay linear-order)
            self._dops = SpecOps(draft_model, "dense", attn_backend)
            self._tops = SpecOps(target_model, "dense", attn_backend)
            self.plan = TreePlan(branching if branching is not None
                                 else branching_for(2, gamma))
            self._per_round = (self.plan.n - 1, self.plan.n_pad)
            self._plan_on = {}          # device -> (mask, depths) tensors
        else:                                            # self
            model = draft_model
            if not self.self_supported(model):
                raise ValueError(
                    "self-speculation needs a scan-stacked attention edge "
                    f"model, got family {model.cfg.family!r}")
            k = exit_layer if exit_layer is not None \
                else max(model.cfg.num_layers // 2, 1)
            if not 0 < k < model.cfg.num_layers:
                raise ValueError(f"exit_layer {k} out of range "
                                 f"(0, {model.cfg.num_layers})")
            self.exit_layer = k
            self.second_model_params = 0
            self._cfg = model.cfg
            self._tops = SpecOps(model, "dense", attn_backend)
            self._per_round = (gamma, gamma + 1)

    @staticmethod
    def tree_supported(draft_model, target_model) -> bool:
        return (draft_model.cfg.family in FAMILIES_WITH_TREES
                and target_model.cfg.family in FAMILIES_WITH_TREES)

    @staticmethod
    def self_supported(model) -> bool:
        return model.cfg.family in FAMILIES_WITH_TREES

    def _accept(self, t_logits, draft_lgs, draft_toks, gen):
        """Acceptance of a linear draft tape (linear and self lanes):
        uniforms from ``gen``, then the spec-verify kernel (its plain
        version under ``attn_backend="plain"``)."""
        G, gamma = draft_toks.shape
        u = torch.rand((2, G, gamma + 1), generator=gen,
                       device=t_logits.device)
        verify = spec_verify_plain if self.attn_backend == "plain" \
            else ops.spec_verify
        return verify(t_logits.float().contiguous(), draft_lgs.contiguous(),
                      draft_toks, u[0], u[1], temperature=self.temperature)

    def _round(self, draft_params, target_params, d_slots, t_slots, last,
               active, gen):
        """One draft/verify/commit round over the whole group (the linear
        and tree lanes).

        last: (G, 1, 1) pending tokens; active: (G,) bool — frozen slots
        keep their cache position and pending token.  Both caches contain
        sequence[:-1] on entry and exit."""
        if self.mode == "tree":
            return self._tree_round(draft_params, target_params, d_slots,
                                    t_slots, last, active, gen)
        gamma = self.gamma
        d_snap = self._dops.snapshot(d_slots)
        t_snap = self._tops.snapshot(t_slots)

        # ---- draft gamma tokens (+1 step so a fully-accepted draft's last
        # token is already in the cache when gamma+1 tokens commit)
        toks, lgs = [], []
        tok = last
        for _ in range(gamma + 1):
            lg, d_slots = self._dops.step(draft_params, tok, d_slots)
            nxt = next_tokens(lg, self.temperature, gen)
            toks.append(nxt)
            lgs.append(lg)
            tok = nxt[:, None, None]
        draft_toks = torch.stack(toks[:gamma], dim=1)          # (G, gamma)
        draft_lgs = torch.stack(lgs[:gamma], dim=1).float()    # (G, gamma, V)

        # ---- verify in one batched target pass over [last, d_0..d_{g-1}]
        ver_in = torch.cat([last[:, :, 0], draft_toks], dim=1)  # (G, g+1)
        t_logits, t_slots = self._tops.extend(target_params, ver_in, t_slots)
        n_acc, next_tok = self._accept(t_logits, draft_lgs, draft_toks, gen)

        # ---- per-slot rewind to the accepted prefix [last, d_0..]
        counts = torch.where(active, n_acc + 1, 0).to(torch.int32)
        d_slots = self._dops.commit(draft_params, d_slots, d_snap, ver_in,
                                    counts)
        t_slots = self._tops.commit(target_params, t_slots, t_snap, ver_in,
                                    counts)
        last = torch.where(active[:, None, None], next_tok[:, None, None],
                           last)
        return d_slots, t_slots, last, draft_toks, n_acc, next_tok

    def _plan_tensors(self, device):
        """The plan's (n_pad, n_pad) mask and (n_pad,) depths on
        ``device``, copied there once."""
        if device not in self._plan_on:
            self._plan_on[device] = (
                torch.as_tensor(self.plan.mask, device=device),
                torch.as_tensor(self.plan.depths, device=device))
        return self._plan_on[device]

    def _tree_round(self, draft_params, target_params, d_slots, t_slots,
                    last, active, gen):
        """One packed-tree draft/verify/commit round over the whole group.

        Drafting expands the static ``TreePlan`` level by level and
        INCREMENTALLY: each span (root, then each level) is one rectangular
        tree-masked extend over only that span's NEW nodes — the mask's
        earlier columns cover the tree rows previous spans already wrote —
        so a round forwards each of the ``n`` nodes once.  Parent-row
        logits feed top-k child selection, ties ordered like ``lax.top_k``
        (descending, lower index first: a stable sort).  Verification is
        one batched tree-masked target extend over all ``n_pad`` nodes and
        ``tree_accept`` walks the accepted root path.  Every node's row was
        written at RoPE position snap + depth, so BOTH commits are row
        permutes down to the contiguous prefix: no extra forward pass."""
        plan = self.plan
        G = last.shape[0]
        D = plan.depth
        dev = last.device
        mask, depths = self._plan_tensors(dev)
        d_snap = self._dops.snapshot(d_slots)
        t_snap = self._tops.snapshot(t_slots)

        # ---- draft: deterministic top-k tree expansion; node c's
        # acceptance distribution q is its PARENT's draft logits
        toks = torch.zeros((G, plan.n_pad), dtype=torch.int32, device=dev)
        toks[:, 0] = last[:, 0, 0]
        q_lgs = [None] * plan.n_pad
        spans = [(0, 1)] + list(plan.levels)     # contiguous: b_i == a_{i+1}
        for si, (a, b) in enumerate(spans):
            # extend ONLY nodes [a, b): mask rows a..b over all b tree
            # columns written so far; RoPE offset depths - a because the
            # cache pos already advanced to snap + a
            lgs, d_slots = self._dops.extend_tree(
                draft_params, toks[:, a:b], d_slots, mask[a:b, :b],
                depths[a:b] - a)
            if si + 1 == len(spans):
                break                            # deepest level: K/V only
            lo, hi = spans[si + 1]
            by_parent = {}
            for c in range(lo, hi):
                by_parent.setdefault(int(plan.parent[c]), []).append(c)
            for pnode, kids in sorted(by_parent.items()):
                plg = lgs[:, pnode - a].float()                  # (G, V)
                top = torch.sort(plg, dim=-1, descending=True,
                                 stable=True).indices[:, :len(kids)]
                for j, c in enumerate(kids):
                    toks[:, c] = top[:, j]
                    q_lgs[c] = plg
        zero = torch.zeros_like(q_lgs[plan.levels[0][0]])
        q_logits = torch.stack([zero if l is None else l for l in q_lgs],
                               dim=1)                           # (G,n_pad,V)

        # ---- verify: ONE batched tree-masked target extend
        t_lgs, t_slots = self._tops.extend_tree(target_params, toks, t_slots,
                                                mask, depths)
        kmax = max(plan.branching)
        u_acc = torch.rand((G, D, kmax), generator=gen, device=dev)
        u_res = torch.rand((G, D + 1), generator=gen, device=dev)
        n_acc, em, path = tree_accept(t_lgs, q_logits, toks, plan, u_acc,
                                      u_res, temperature=self.temperature)
        next_tok = em.gather(1, n_acc.long()[:, None])[:, 0]

        # ---- commit the accepted root path in both caches (row permutes)
        counts = torch.where(active, n_acc + 1, 0).to(torch.int32)
        d_slots = self._dops.commit_permute(d_slots, d_snap, path, counts)
        t_slots = self._tops.commit_permute(t_slots, t_snap, path, counts)
        last = torch.where(active[:, None, None], next_tok[:, None, None],
                           last)
        return d_slots, t_slots, last, em[:, :D], n_acc, next_tok

    def _self_round(self, params, slots, last, active, gen):
        """One self-speculative round: the model's first ``exit_layer``
        blocks + shared head draft a gamma-chain into the SHARED cache
        (shallow K/V at the draft positions, ``pos`` advanced by hand),
        then the full depth verifies from the snapshot — overwriting every
        layer's K/V at those positions — and the commit is the usual
        ``pos`` write."""
        gamma = self.gamma
        snap = self._tops.snapshot(slots)
        toks, lgs = [], []
        tok = last
        for _ in range(gamma):
            lg, slots = partial_extend_step(params, tok[:, :, 0], slots,
                                            self._cfg, self.exit_layer)
            lg = lg[:, 0]                                        # (G, V)
            slots = {**slots, "pos": slots["pos"] + 1}
            nxt = next_tokens(lg, self.temperature, gen)
            toks.append(nxt)
            lgs.append(lg)
            tok = nxt[:, None, None]
        draft_toks = torch.stack(toks, dim=1)                    # (G, gamma)
        draft_lgs = torch.stack(lgs, dim=1).float()              # (G,gamma,V)

        ver_in = torch.cat([last[:, :, 0], draft_toks], dim=1)
        slots = self._tops.reset(slots, snap)
        t_logits, slots = self._tops.extend(params, ver_in, slots)
        n_acc, next_tok = self._accept(t_logits, draft_lgs, draft_toks, gen)

        counts = torch.where(active, n_acc + 1, 0).to(torch.int32)
        slots = self._tops.commit(params, slots, snap, ver_in, counts)
        last = torch.where(active[:, None, None], next_tok[:, None, None],
                           last)
        return slots, last, draft_toks, n_acc, next_tok

    @hot_path
    def generate_group(self, draft_params, target_params, d_slots, t_slots,
                       last, max_news, gen):
        """Decode a prefilled group until every member has its tokens.

        last: (G, 1, 1) int32 on the device; max_news: per-slot budget (0
        for padding slots).  Returns (token lists, per-member stats dicts
        with rounds/accepted).  The linear and tree lanes share this loop:
        a tree round's tape is its emitted-path tokens, so the per-round
        emission is ``tape[i, :n_acc] + [next_tok]`` in both."""
        if self.mode == "self":
            raise ValueError("the self lane decodes one shared state: use "
                             "generate_group_self")
        G = last.shape[0]
        remaining = np.array(max_news, np.int64)    # host list, not a sync
        out: List[List[int]] = [[] for _ in range(G)]
        member_stats = [{"rounds": 0, "accepted": []} for _ in range(G)]
        while (remaining > 0).any():
            active = torch.as_tensor(remaining > 0, device=last.device)
            d_slots, t_slots, last, draft_toks, n_acc, next_tok = \
                self._round(draft_params, target_params, d_slots, t_slots,
                            last, active, gen)
            self._collect(remaining, draft_toks, n_acc, next_tok, out,
                          member_stats)
        return out, member_stats

    @hot_path
    def generate_group_self(self, params, slots, last, max_news, gen):
        """Self-speculative twin of ``generate_group``: ONE model, ONE
        batched dense cache (shallow draft and full-depth verify share
        it)."""
        if self.mode != "self":
            raise ValueError("generate_group_self serves the self lane")
        G = last.shape[0]
        remaining = np.array(max_news, np.int64)    # host list, not a sync
        out: List[List[int]] = [[] for _ in range(G)]
        member_stats = [{"rounds": 0, "accepted": []} for _ in range(G)]
        while (remaining > 0).any():
            active = torch.as_tensor(remaining > 0, device=last.device)
            slots, last, draft_toks, n_acc, next_tok = self._self_round(
                params, slots, last, active, gen)
            self._collect(remaining, draft_toks, n_acc, next_tok, out,
                          member_stats)
        return out, member_stats

    @hot_path
    def _collect(self, remaining, draft_toks, n_acc, next_tok, out,
                 member_stats):
        """Host half of a round: slice each active member's emission off
        the padded tape and accumulate the lane counters — fed by ONE
        batched pull of the round's device outputs."""
        dt, na, nt = host_pull(draft_toks, n_acc, next_tok)
        per_draft, per_verify = self._per_round
        for i in range(len(out)):
            if remaining[i] <= 0:
                continue
            emitted = [int(t) for t in dt[i, :int(na[i])]] + [int(nt[i])]
            take = min(len(emitted), int(remaining[i]))
            out[i].extend(emitted[:take])
            remaining[i] -= take
            member_stats[i]["rounds"] += 1
            member_stats[i]["accepted"].append(int(na[i]))
            c = self.counters
            c["member_rounds"] += 1
            c["draft_tokens"] += per_draft
            c["verify_tokens"] += per_verify
            c["accepted_tokens"] += int(na[i])
            c["emitted_tokens"] += take
