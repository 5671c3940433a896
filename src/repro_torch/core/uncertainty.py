"""Uncertainty estimation for escalation decisions (survey §2.1, §2.2.1 and
the §6 "future prospects" advocating evidence-based estimators).

All estimators map logits (..., V) -> scalar uncertainty (...,) in [0, 1]-ish
range (higher = more uncertain).  Torch twins of the JAX package's
estimators, computed in float32.
"""
from __future__ import annotations

import math

import torch


def max_prob(logits):
    """1 - max softmax probability."""
    p = torch.softmax(logits.float(), dim=-1)
    return 1.0 - p.amax(dim=-1)


def entropy(logits, normalize: bool = True):
    """Shannon entropy of the softmax; optionally normalized by log V."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    h = -(lp.exp() * lp).sum(dim=-1)
    if normalize:
        h = h / math.log(logits.shape[-1])
    return h


def margin(logits):
    """1 - (p1 - p2): small top-2 margin = uncertain."""
    p = torch.softmax(logits.float(), dim=-1)
    top2 = torch.topk(p, 2, dim=-1).values
    return 1.0 - (top2[..., 0] - top2[..., 1])


def energy(logits, temperature: float = 1.0):
    """Negative free energy -T*logsumexp(l/T), squashed via sigmoid.
    Unlike softmax scores this preserves the raw evidential magnitude
    (survey §6: normalized probabilities obscure evidential strength)."""
    e = -temperature * torch.logsumexp(logits.float() / temperature, dim=-1)
    return torch.sigmoid(e)   # low evidence -> high energy -> near 1


def dirichlet_evidence(logits, clip: float = 10.0):
    """Evidence-based uncertainty (survey §6).

    alpha = 1 + exp(clip(logits)); S = sum(alpha).
      * epistemic (vacuity)  u_ep = V / S           (little total evidence)
      * aleatoric            u_al = E[H(p)] / log V  (conflicting evidence)
    Returns dict {"epistemic", "aleatoric", "total"}.
    """
    V = logits.shape[-1]
    alpha = 1.0 + torch.clamp(logits.float(), -clip, clip).exp()
    S = alpha.sum(dim=-1)
    u_ep = V / S
    # expected entropy of Categorical(p), p ~ Dir(alpha):
    # E[H] = -sum_k alpha_k/S * (digamma(alpha_k+1) - digamma(S+1))
    e_h = -(alpha / S[..., None] * (torch.digamma(alpha + 1.0)
                                     - torch.digamma(S[..., None] + 1.0))
            ).sum(dim=-1)
    u_al = e_h / math.log(V)
    return {"epistemic": u_ep, "aleatoric": u_al,
            "total": torch.clamp(u_ep + u_al, 0.0, 2.0) / 2.0}


ESTIMATORS = {
    "max_prob": max_prob,
    "entropy": entropy,
    "margin": margin,
    "energy": energy,
    "dirichlet": lambda l: dirichlet_evidence(l)["total"],
}


def get_estimator(name: str):
    if name not in ESTIMATORS:
        raise KeyError(f"unknown estimator {name!r}; known: {sorted(ESTIMATORS)}")
    return ESTIMATORS[name]


def get_batched_estimator(name: str):
    """Batched per-slot estimator for the serving scheduler.

    Returns ``fn: logits (B, ..., V) -> (B,) float32`` — one scalar per
    batch slot, computed on the logits' device so the decode loop can
    accumulate uncertainty without a per-token host sync.
    """
    est = get_estimator(name)

    def batched(logits):
        return est(logits.float()).reshape(logits.shape[0]).float()

    return batched
