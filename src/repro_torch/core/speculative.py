"""Token-level mixture: speculative decoding (survey §2.4), linear lane.

Edge SLM drafts gamma tokens; cloud LLM verifies them in ONE parallel pass
(modified rejection sampling, Leviathan et al. / survey §2.4.1).  The
scheme is lossless: the output distribution equals sampling from the target
model alone.

KV caches roll back rejected tokens by resetting ``pos`` — stale entries
are masked out and later overwritten.  The tree and self lanes, the
per-request ``SpecDecoder`` and the recurrent-state replay are later slices
of the port.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.analysis import hot_path
from repro_torch.core.seq_state import (SpecOps, host_pull, layout_for,
                                        next_tokens)
from repro_torch.kernels import ops
from repro_torch.kernels.spec_verify import spec_verify_plain


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


class BatchedSpecDecoder:
    """Grouped edge-draft / cloud-verify decoding for the serving scheduler
    (linear lane).

    Operates on a padded GROUP of requests with batched caches: drafting
    is gamma+1 batched decode steps, verification ONE batched target
    extend, acceptance ONE call of the spec-verify kernel (its plain
    version on the CPU or under ``attn_backend="plain"``) with uniforms
    drawn from the caller's ``torch.Generator``, and the per-slot rewind a
    ``pos`` write — one host pull per ROUND, per group.  Dense and paged
    layouts share the rounds through ``core.seq_state.SpecOps``; a paged
    caller must have grown each slot's block table to cover prompt +
    budget + one round of draft overdraft.

    ``counters`` accumulates totals across ``generate_group`` calls:
    member_rounds (verify passes), draft_tokens, verify_tokens,
    accepted_tokens and emitted_tokens.
    """

    def __init__(self, draft_model, target_model, *, gamma: int = 4,
                 temperature: float = 0.0, kv_layout: str = "dense",
                 mode: str = "linear", attn_backend: str = "auto"):
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if mode in ("tree", "self"):
            raise NotImplementedError(
                f"spec_mode {mode!r} is not ported yet: the tree and self "
                "speculation lanes are a later slice of the port")
        if mode != "linear":
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
        self._dops = SpecOps(draft_model, layout_for(draft_model, kv_layout),
                             attn_backend)
        self._tops = SpecOps(target_model,
                             layout_for(target_model, kv_layout),
                             attn_backend)
        self._per_round = (gamma, gamma + 1)

    def _verify(self, t_logits, draft_lgs, draft_toks, u_acc, u_res):
        if self.attn_backend == "plain":
            return spec_verify_plain(t_logits, draft_lgs, draft_toks, u_acc,
                                     u_res, temperature=self.temperature)
        return ops.spec_verify(t_logits, draft_lgs, draft_toks, u_acc, u_res,
                               temperature=self.temperature)

    def _round(self, draft_params, target_params, d_slots, t_slots, last,
               active, gen):
        """One draft/verify/commit round over the whole group.

        last: (G, 1, 1) pending tokens; active: (G,) bool — frozen slots
        keep their cache position and pending token.  Both caches contain
        sequence[:-1] on entry and exit."""
        gamma = self.gamma
        G = last.shape[0]
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
        u = torch.rand((2, G, gamma + 1), generator=gen, device=last.device)
        n_acc, next_tok = self._verify(t_logits.float().contiguous(),
                                       draft_lgs.contiguous(), draft_toks,
                                       u[0], u[1])

        # ---- per-slot rewind to the accepted prefix [last, d_0..]
        counts = torch.where(active, n_acc + 1, 0).to(torch.int32)
        d_slots = self._dops.commit(draft_params, d_slots, d_snap, ver_in,
                                    counts)
        t_slots = self._tops.commit(target_params, t_slots, t_snap, ver_in,
                                    counts)
        last = torch.where(active[:, None, None], next_tok[:, None, None],
                           last)
        return d_slots, t_slots, last, draft_toks, n_acc, next_tok

    @hot_path
    def generate_group(self, draft_params, target_params, d_slots, t_slots,
                       last, max_news, gen):
        """Decode a prefilled group until every member has its tokens.

        last: (G, 1, 1) int32 on the device; max_news: per-slot budget (0
        for padding slots).  Returns (token lists, per-member stats dicts
        with rounds/accepted)."""
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
