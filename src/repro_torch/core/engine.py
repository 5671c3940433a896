"""Task-level mixture orchestration (survey §2.3): the per-request
collaborative serving engine, the twin of the JAX package's
``core/engine.py``.  Per request it composes:

    1. semantic cache lookup (VELO)                     -> free
    2. edge-only generation + uncertainty check          -> cheap
    3. escalation:
       a. "speculative"  — token-level mixture (§2.4)
       b. "cloud"        — full cloud generation (task assignment)
       c. "skeleton"     — cloud drafts a skeleton prefix, edge completes
                           (cloud-to-edge skeleton, §2.4.3/PICE)

``CollaborativeEngine.serve`` runs one request through a one-slot
``BatchedEngine`` (the batched scheduler's decisions and device path).
``serve_reference`` is the original host-side loop — one model step and one
host round trip per decoded token — kept as the executable spec that the
scheduler is held against, and as the per-request baseline of a serving
benchmark.  Both share one semantic cache.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict

import numpy as np

from repro_torch.core.cache import embed_tokens_mean
from repro_torch.core.policy import ThresholdPolicy, resolve_policy
from repro_torch.core.scheduler import BatchedEngine, RequestTrace
from repro_torch.core.seq_state import next_tokens
from repro_torch.core.speculative import (SpecDecoder,
                                          autoregressive_baseline, device_of,
                                          generator_for, prompt_tensor)
from repro_torch.core.uncertainty import get_estimator


class CollaborativeEngine:
    """Single-request facade: ``serve`` over a batch-1 ``BatchedEngine``,
    ``serve_reference`` the per-token host loop.

    Constructor arguments are the JAX package's, plus ``attn_backend``
    ("auto": the Hopper kernels on CUDA tensors, their plain versions on
    the CPU; "plain" forces the plain versions), which both paths pass to
    every model call.  ``serve_reference`` honors only the threshold-family
    policies; any other policy is served there with the historical
    speculative@0.6 decisions and a ``RuntimeWarning``."""

    def __init__(self, edge_model, cloud_model, *, gamma: int = 4,
                 temperature: float = 0.0, escalate_threshold=None,
                 estimator: str = "entropy", escalation=None, policy=None,
                 use_cache: bool = True, cache_threshold: float = 0.95,
                 skeleton_len: int = 8, kv_layout: str = "auto",
                 kv_block_size: int = 32, kv_blocks=None,
                 attn_backend: str = "auto"):
        self.edge = edge_model
        self.cloud = cloud_model
        self.temperature = temperature
        self.attn_backend = attn_backend
        self.policy = resolve_policy(policy, escalation, escalate_threshold)
        if isinstance(self.policy, ThresholdPolicy):
            self.threshold = self.policy.threshold
            self.escalation = self.policy.action
        else:
            self.threshold, self.escalation = 0.6, "speculative"
        self.est = get_estimator(estimator)
        self.skeleton_len = skeleton_len
        self.spec = SpecDecoder(edge_model, cloud_model, gamma=gamma,
                                temperature=temperature,
                                attn_backend=attn_backend)
        self.batched = BatchedEngine(
            edge_model, cloud_model, batch_size=1, gamma=gamma,
            temperature=temperature, policy=self.policy,
            estimator=estimator, use_cache=use_cache,
            cache_threshold=cache_threshold, skeleton_len=skeleton_len,
            kv_layout=kv_layout, kv_block_size=kv_block_size,
            kv_blocks=kv_blocks, attn_backend=attn_backend)
        # one semantic cache: the reference and scheduler paths hit (and
        # warm) the same entries
        self.cache = self.batched.cache

    # ----------------------------------------------------------------
    def serve(self, edge_params, cloud_params, prompt, max_new: int
              ) -> RequestTrace:
        return self.batched.serve_batch(edge_params, cloud_params, [prompt],
                                        max_new)[0]

    # ----------------------------------------------------------------
    def _edge_generate(self, params, prompt, max_new):
        """Edge-only generation; returns (tokens, mean uncertainty,
        calls)."""
        prompt = prompt_tensor(prompt, device_of(params))
        _, cache = self.edge.prefill(params, {"tokens": prompt[:, :-1]},
                                     max_seq=prompt.shape[1] + max_new + 4,
                                     attn_backend=self.attn_backend)
        tok = prompt[:, -1:]
        gen = generator_for(params)
        out, us = [], []
        for _ in range(max_new):
            lg, cache = self.edge.decode_step(params, tok, cache,
                                              attn_backend=self.attn_backend)
            us.append(float(self.est(lg).mean()))
            nxt = next_tokens(lg, self.temperature, gen)
            out.append(int(nxt[0]))
            tok = nxt[:, None]
        return out, float(np.mean(us)), max_new

    # ----------------------------------------------------------------
    def serve_reference(self, edge_params, cloud_params, prompt,
                        max_new: int) -> RequestTrace:
        """The per-request loop (a host round trip per token) — the
        reference the batched scheduler is tested against."""
        if not isinstance(self.policy, ThresholdPolicy):
            warnings.warn(
                f"serve_reference cannot honor policy {self.policy.name!r} "
                "(its assign/decide/feedback hooks never fire here); "
                "serving with the historical speculative@0.6 decisions — "
                "use serve() / BatchedEngine for the real policy",
                RuntimeWarning, stacklevel=2)
        prompt = np.asarray(prompt, np.int32).reshape(-1)

        if self.cache is not None:
            key = embed_tokens_mean(self.edge, edge_params, prompt)
            hit = self.cache.lookup(key)
            if hit is not None:
                return RequestTrace("cache", tokens=list(hit))

        tokens, u, calls = self._edge_generate(edge_params, prompt, max_new)
        if u <= self.threshold:
            trace = RequestTrace("edge", edge_calls=calls, uncertainty=u,
                                 tokens=tokens)
        elif self.escalation == "speculative":
            toks, st = self.spec.generate(edge_params, cloud_params, prompt,
                                          max_new)
            trace = RequestTrace(
                "speculative", edge_calls=calls + st.draft_calls,
                cloud_passes=st.target_passes + st.replay_passes,
                uncertainty=u, tokens=toks)
        elif self.escalation == "skeleton":
            toks, ec, cp = self._skeleton_completion(edge_params,
                                                     cloud_params, prompt,
                                                     max_new)
            trace = RequestTrace("skeleton", edge_calls=calls + ec,
                                 cloud_passes=cp, uncertainty=u, tokens=toks)
        else:   # plain cloud fallback (task assignment)
            toks = autoregressive_baseline(self.cloud, cloud_params, prompt,
                                           max_new,
                                           temperature=self.temperature,
                                           attn_backend=self.attn_backend)
            trace = RequestTrace("cloud", edge_calls=calls,
                                 cloud_passes=max_new, uncertainty=u,
                                 tokens=toks)

        if self.cache is not None and trace.tokens is not None:
            self.cache.insert(key, trace.tokens)
        return trace

    # ----------------------------------------------------------------
    def _skeleton_completion(self, edge_params, cloud_params, prompt,
                             max_new: int):
        """Cloud-to-edge skeleton (PICE/CoGenesis): the cloud generates the
        first ``skeleton_len`` tokens; the edge completes the remainder
        conditioned on them."""
        k = min(self.skeleton_len, max_new)
        skel = autoregressive_baseline(self.cloud, cloud_params, prompt, k,
                                       temperature=self.temperature,
                                       attn_backend=self.attn_backend)
        ext = np.concatenate([np.asarray(prompt, np.int32),
                              np.asarray(skel, np.int32)])
        rest, _, ec = self._edge_generate(edge_params, ext, max_new - k)
        return skel + rest, ec, k

    # ----------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {"cache_hit_rate": self.cache.hit_rate if self.cache else 0.0,
                "policy": self.policy.name, **self.policy.stats()}
