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

from repro_torch import runtime
from repro_torch.analysis import hot_path
from repro_torch.core.capture import capture
from repro_torch.core.self_speculative import partial_extend_step
from repro_torch.core.seq_state import (VIEW, SpecOps, host_pull,
                                        layout_for, next_tokens)
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
                 attn_backend: str = "auto", graphs: bool = True):
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
        # the lane's round captured per (shapes, buffers), ``self._graph``:
        # the twin of the JAX package's jitted ``_round_impl``,
        # ``_tree_round_impl`` or ``_self_round_impl``
        self.graphs = graphs
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
            self._graph = capture(
                self._linear_round,
                copy_argnames=("d_pos", "t_pos", "last", "active"),
                name="BatchedSpecDecoder.linear_round")
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
            self._graph = capture(
                self._tree_round,
                copy_argnames=("d_pos", "t_pos", "last", "active"),
                name="BatchedSpecDecoder.tree_round")
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
            self._graph = capture(
                self._self_body, copy_argnames=("pos", "last", "active"),
                name="BatchedSpecDecoder.self_round")

    @staticmethod
    def tree_supported(draft_model, target_model) -> bool:
        return (draft_model.cfg.family in FAMILIES_WITH_TREES
                and target_model.cfg.family in FAMILIES_WITH_TREES)

    @staticmethod
    def self_supported(model) -> bool:
        return model.cfg.family in FAMILIES_WITH_TREES

    @property
    def captures(self) -> int:
        """CUDA graphs the lane's round has captured."""
        return self._graph.captures

    @property
    def capture_seconds(self) -> float:
        """Host seconds those captures took (warm-ups included)."""
        return self._graph.capture_seconds

    def graph_rule(self, device=None) -> str:
        """How a round runs: "captured" (every lane and layout, a CUDA
        graph per key, ``core/capture.py``), or eager and why — a mesh's
        collectives run over gloo, which a graph cannot capture, the switch
        is off, or the tensors lie on the CPU, which has no graphs."""
        if runtime.current_mesh() is not None:
            return "eager (mesh)"
        if not self.graphs:
            return "eager (graphs=False)"
        if device is not None and torch.device(device).type != "cuda":
            return "eager (cpu: no graphs)"
        return "captured"

    def _accept(self, t_logits, draft_lgs, draft_toks, gen, rows=None):
        """Acceptance of a linear draft tape (linear and self lanes):
        uniforms from ``gen``, then the spec-verify kernel (its plain
        version under ``attn_backend="plain"``).  ``rows``: the wave's
        whole group size when the inputs are this rank's data slice of it —
        the uniforms are drawn for the whole group and cut to the slice."""
        G, gamma = draft_toks.shape
        u = torch.rand((2, G if rows is None else rows, gamma + 1),
                       generator=gen, device=t_logits.device)
        if rows is not None:
            u = runtime.scatter_wave(u.transpose(0, 1)).transpose(0, 1)
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
        sequence[:-1] on entry and exit.

        On a mesh the draft state is the edge's data-split local view:
        ``last`` is this rank's rows and ``active`` the whole group's.  The
        draft runs on the local rows, ``gather_wave`` hands every rank the
        whole draft tape (ONE collective) for the tensor-parallel cloud's
        verify of the whole wave, acceptance runs on the local rows
        (``scatter_wave`` of the verify logits) and one more gather brings
        every rank the wave's acceptances, which commit the replicated
        cloud state and the host pull.  Off-mesh the wave calls are the
        identity."""
        d_pools = {k: v for k, v in d_slots.items() if k != "pos"}
        t_pools = {k: v for k, v in t_slots.items() if k != "pos"}
        args = (draft_params, target_params, d_pools, d_slots["pos"],
                t_pools, t_slots["pos"], last, active, gen)
        captured = self.graph_rule() == "captured"
        if self.mode == "tree":
            run = self._graph if captured else self._tree_round
            return run(*args, *self._plan_tensors(last.device))
        run = self._graph if captured else self._linear_round
        return run(*args)

    def _linear_round(self, draft_params, target_params, d_pools, d_pos,
                      t_pools, t_pos, last, active, gen):
        """The linear lane's round (``_round``; what its graphs capture)."""
        d_slots = {**d_pools, "pos": d_pos}
        t_slots = {**t_pools, "pos": t_pos}
        gamma = self.gamma
        G = active.shape[0]
        view = d_slots.get(VIEW)
        d_snap = self._dops.snapshot(d_slots)
        t_snap = self._tops.snapshot(t_slots)

        # ---- draft gamma tokens (+1 step so a fully-accepted draft's last
        # token is already in the cache when gamma+1 tokens commit)
        toks, lgs = [], []
        tok = last
        for _ in range(gamma + 1):
            lg, d_slots = self._dops.step(draft_params, tok, d_slots)
            nxt = next_tokens(lg, self.temperature, gen, view)
            toks.append(nxt)
            lgs.append(lg)
            tok = nxt[:, None, None]
        draft_toks = torch.stack(toks[:gamma], dim=1)          # (G, gamma)
        draft_lgs = torch.stack(lgs[:gamma], dim=1).float()    # (G, gamma, V)

        # ---- verify in one batched target pass over [last, d_0..d_{g-1}].
        # On a mesh this is THE wave crossing: the edge's data-split draft
        # tape is all-gathered over the data axes, the tensor-parallel
        # cloud verifies the whole wave, and acceptance comes back to each
        # data slice
        ver_l = torch.cat([last[:, :, 0], draft_toks], dim=1)   # (G, g+1)
        ver_in, draft_all = runtime.gather_wave(ver_l, draft_toks, rows=G)
        t_logits, t_slots = self._tops.extend(target_params, ver_in, t_slots)
        split = ver_in is not ver_l         # the wave crossed the data axes
        n_acc_l, next_l = self._accept(
            runtime.scatter_wave(t_logits), draft_lgs, draft_toks, gen,
            rows=G if split else None)
        n_acc, next_tok = runtime.gather_wave(n_acc_l, next_l, rows=G)

        # ---- per-slot rewind to the accepted prefix [last, d_0..]
        counts = torch.where(active, n_acc + 1, 0).to(torch.int32)
        d_slots = self._dops.commit(draft_params, d_slots, d_snap, ver_l,
                                    runtime.scatter_wave(counts))
        t_slots = self._tops.commit(target_params, t_slots, t_snap, ver_in,
                                    counts)
        last = torch.where(runtime.scatter_wave(active)[:, None, None],
                           next_l[:, None, None], last)
        return d_slots, t_slots, last, draft_all, n_acc, next_tok

    def _plan_tensors(self, device):
        """The plan's (n_pad, n_pad) mask and (n_pad,) depths on
        ``device``, copied there once, outside any graph: the tree round
        takes them as addressed arguments."""
        if device not in self._plan_on:
            self._plan_on[device] = (
                torch.as_tensor(self.plan.mask, device=device),
                torch.as_tensor(self.plan.depths, device=device))
        return self._plan_on[device]

    def _tree_round(self, draft_params, target_params, d_pools, d_pos,
                    t_pools, t_pos, last, active, gen, mask, depths):
        """One packed-tree draft/verify/commit round over the whole group
        (``_round``; what its graphs capture).  ``mask`` and ``depths``:
        the plan's tensors (``_plan_tensors``).

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
        permutes down to the contiguous prefix: no extra forward pass.

        On a mesh (as ``_round``): the edge drafts the trees of this rank's
        rows, ONE ``gather_wave`` of the tree tokens hands the
        tensor-parallel cloud the whole wave, ``tree_accept`` walks the
        local rows against ``scatter_wave`` of the verify logits (the
        (G, n_pad, V) draft logits never cross), and ONE more gather
        brings every rank the wave's ``n_acc``, emitted tokens and paths:
        the edge commits its rows, the cloud the whole wave."""
        d_slots = {**d_pools, "pos": d_pos}
        t_slots = {**t_pools, "pos": t_pos}
        plan = self.plan
        G = active.shape[0]
        D = plan.depth
        dev = last.device
        d_snap = self._dops.snapshot(d_slots)
        t_snap = self._tops.snapshot(t_slots)

        # ---- draft: deterministic top-k tree expansion; node c's
        # acceptance distribution q is its PARENT's draft logits
        toks = torch.zeros((last.shape[0], plan.n_pad), dtype=torch.int32,
                           device=dev)
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
            for pnode, kids in plan.children[si]:
                plg = lgs[:, pnode - a].float()                  # (G, V)
                top = torch.sort(plg, dim=-1, descending=True,
                                 stable=True).indices[:, :len(kids)]
                for j, c in enumerate(kids):
                    toks[:, c] = top[:, j]
                    q_lgs[c] = plg
        zero = torch.zeros_like(q_lgs[plan.levels[0][0]])
        q_logits = torch.stack([zero if l is None else l for l in q_lgs],
                               dim=1)                           # (G,n_pad,V)

        # ---- verify: ONE batched tree-masked target extend of the wave
        toks_all = runtime.gather_wave(toks, rows=G)
        t_lgs, t_slots = self._tops.extend_tree(target_params, toks_all,
                                                t_slots, mask, depths)
        kmax = max(plan.branching)
        u_acc = torch.rand((G, D, kmax), generator=gen, device=dev)
        u_res = torch.rand((G, D + 1), generator=gen, device=dev)
        if toks_all is not toks:            # the wave crossed the data axes
            t_lgs, u_acc, u_res = (runtime.scatter_wave(x)
                                   for x in (t_lgs, u_acc, u_res))
        n_acc_l, em_l, path_l = tree_accept(
            t_lgs, q_logits, toks, plan, u_acc, u_res,
            temperature=self.temperature)
        n_acc, em, path = runtime.gather_wave(n_acc_l, em_l, path_l, rows=G)
        next_tok = em.gather(1, n_acc.long()[:, None])[:, 0]
        next_l = em_l.gather(1, n_acc_l.long()[:, None])[:, 0]

        # ---- commit the accepted root path in both caches (row permutes)
        counts = torch.where(active, n_acc + 1, 0).to(torch.int32)
        d_slots = self._dops.commit_permute(d_slots, d_snap, path_l,
                                            runtime.scatter_wave(counts))
        t_slots = self._tops.commit_permute(t_slots, t_snap, path, counts)
        last = torch.where(runtime.scatter_wave(active)[:, None, None],
                           next_l[:, None, None], last)
        return d_slots, t_slots, last, em[:, :D], n_acc, next_tok

    def _self_round(self, params, slots, last, active, gen):
        """One self-speculative round (``_self_body``): a CUDA graph per
        key under ``graph_rule() == "captured"``, with ``pos``, the pending
        tokens and ``active`` copied in."""
        run = self._graph if self.graph_rule() == "captured" \
            else self._self_body
        return run(params, {k: v for k, v in slots.items() if k != "pos"},
                   slots["pos"], last, active, gen)

    def _self_body(self, params, pools, pos, last, active, gen):
        """One self-speculative round: the model's first ``exit_layer``
        blocks + shared head draft a gamma-chain into the SHARED cache
        (shallow K/V at the draft positions, ``pos`` advanced by hand),
        then the full depth verifies from the snapshot — overwriting every
        layer's K/V at those positions — and the commit is the usual
        ``pos`` write.

        On a mesh there is no cloud: every rank drafts, verifies and
        commits its own rows of the data-split state (acceptance uniforms
        drawn for the whole group and cut to them), and ONE ``gather_wave``
        of (draft tape, ``n_acc``, next token) gives every rank the whole
        wave for the host pull.  (The JAX package gathers the verify input
        and verifies replicated; the tokens are the same.)"""
        slots = {**pools, "pos": pos}
        gamma = self.gamma
        G = active.shape[0]
        view = slots.get(VIEW)
        snap = self._tops.snapshot(slots)
        toks, lgs = [], []
        tok = last
        for _ in range(gamma):
            lg, slots = self._tops.run(slots, lambda c: partial_extend_step(
                params, tok[:, :, 0], c, self._cfg, self.exit_layer))
            lg = lg[:, 0]                                        # (G, V)
            slots = {**slots, "pos": slots["pos"] + 1}
            nxt = next_tokens(lg, self.temperature, gen, view)
            toks.append(nxt)
            lgs.append(lg)
            tok = nxt[:, None, None]
        draft_toks = torch.stack(toks, dim=1)                    # (G, gamma)
        draft_lgs = torch.stack(lgs, dim=1).float()              # (G,gamma,V)

        ver_in = torch.cat([last[:, :, 0], draft_toks], dim=1)
        slots = self._tops.reset(slots, snap)
        t_logits, slots = self._tops.extend(params, ver_in, slots)
        split = last.shape[0] != G          # this rank holds a data slice
        n_acc_l, next_l = self._accept(t_logits, draft_lgs, draft_toks, gen,
                                       rows=G if split else None)
        active_l = runtime.scatter_wave(active) if split else active

        counts = torch.where(active_l, n_acc_l + 1, 0).to(torch.int32)
        slots = self._tops.commit(params, slots, snap, ver_in, counts)
        last = torch.where(active_l[:, None, None], next_l[:, None, None],
                           last)
        draft_toks, n_acc, next_tok = runtime.gather_wave(
            draft_toks, n_acc_l, next_l, rows=G)
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
        last = runtime.scatter_wave(last)       # this rank's rows on a mesh
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
        last = runtime.scatter_wave(last)       # this rank's rows on a mesh
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
        # repro-lint: ok(R1, the round's one batched pull)
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
