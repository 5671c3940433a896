"""Task assignment / routing (survey §2.1, §2.2.1).

Three router families from the survey's taxonomy:

* ``ConfidenceRouter`` — trust/semantic-aware: escalate to the cloud model
  when edge uncertainty exceeds a threshold (Tabi / FS-GEN style).
* ``CascadeRouter`` — cost-aware cascades (FrugalGPT): try models in cost
  order, stop at the first confident one.
* ``UCBRouter`` / ``LinUCBRouter`` — reward- and cost-aware bandit routing
  (PerLLM / MixLLM / LLM-Bandit style): online learning of which model to
  use, optionally conditioned on query features.

Routers are host-side control plane (NumPy); the models they select are
PyTorch modules.  The estimators are the torch ones of ``core/uncertainty.py``,
so logits reach them through ``_uncertainty`` as tensors.  This mirrors production serving, where routing logic
lives outside the accelerator graph.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.uncertainty import get_estimator


@dataclasses.dataclass
class Route:
    model_idx: int
    uncertainty: float
    cost: float
    trace: list


def _uncertainty(est, logits) -> float:
    """Mean estimator output over ``logits`` (array or tensor)."""
    return float(est(torch.as_tensor(np.asarray(logits))).mean())


class ConfidenceRouter:
    """Route to cloud (idx 1) when edge (idx 0) uncertainty > threshold."""

    def __init__(self, threshold: float = 0.5, estimator: str = "entropy"):
        self.threshold = threshold
        self.est = get_estimator(estimator)

    def __call__(self, edge_logits) -> Route:
        u = _uncertainty(self.est, edge_logits)
        idx = 1 if u > self.threshold else 0
        return Route(idx, u, cost=0.0, trace=[("edge_unc", u)])


class CascadeRouter:
    """FrugalGPT-style cascade: models ordered by cost; escalate while the
    current model's confidence is below its acceptance threshold."""

    def __init__(self, costs: Sequence[float], thresholds: Sequence[float],
                 estimator: str = "max_prob"):
        assert len(costs) == len(thresholds)
        self.costs = list(costs)
        self.thresholds = list(thresholds)
        self.est = get_estimator(estimator)

    def route(self, u_fns: Sequence[Callable[[], float]]) -> Route:
        """Cascade over lazily-evaluated per-tier UNCERTAINTIES (the
        estimator already applied, or any other scalar the caller trusts):
        pay tier i's cost, stop at the first tier confident under its
        threshold (the last tier is unconditional).  This is the seam the
        serving ``CascadePolicy`` drives — tiers there are collaboration
        mechanisms, not just models."""
        spent, trace = 0.0, []
        for i, fn in enumerate(u_fns):
            spent += self.costs[i]
            u = float(fn())
            trace.append((i, u))
            if u <= self.thresholds[i] or i == len(u_fns) - 1:
                return Route(i, u, spent, trace)
        raise RuntimeError("unreachable")

    def run(self, score_fns: Sequence[Callable[[], np.ndarray]]) -> Route:
        """score_fns[i]() -> logits of model i (lazily evaluated: escalation
        is what costs money, so we only call what we route to)."""
        return self.route([
            lambda fn=fn: _uncertainty(self.est, fn())
            for fn in score_fns])


class UCBRouter:
    """Upper-confidence-bound bandit over K models (PerLLM's formulation:
    constrained multi-armed bandit with cost-adjusted reward)."""

    def __init__(self, n_models: int, cost_weight: float = 0.1, c: float = 1.4):
        self.n = np.zeros(n_models)
        self.mean = np.zeros(n_models)
        self.cost_weight = cost_weight
        self.c = c
        self.t = 0

    def select(self) -> int:
        self.t += 1
        if (self.n == 0).any():
            return int(np.argmin(self.n))
        ucb = self.mean + self.c * np.sqrt(np.log(self.t) / self.n)
        return int(np.argmax(ucb))

    def update(self, idx: int, quality: float, cost: float = 0.0):
        r = quality - self.cost_weight * cost
        self.n[idx] += 1
        self.mean[idx] += (r - self.mean[idx]) / self.n[idx]

    def regret(self, oracle_mean: Optional[np.ndarray] = None) -> float:
        m = oracle_mean if oracle_mean is not None else self.mean
        return float(self.t * np.max(m) - np.sum(self.n * self.mean))


class LinUCBRouter:
    """Contextual bandit (LinUCB): route on query features (uncertainty
    signals, length, domain one-hots) — MixLLM/CITER style."""

    def __init__(self, n_models: int, dim: int, alpha: float = 0.5,
                 cost_weight: float = 0.1):
        self.A = [np.eye(dim) for _ in range(n_models)]
        self.b = [np.zeros(dim) for _ in range(n_models)]
        self.alpha = alpha
        self.cost_weight = cost_weight

    def select(self, x: np.ndarray) -> int:
        scores = []
        for A, b in zip(self.A, self.b):
            Ainv = np.linalg.inv(A)
            theta = Ainv @ b
            scores.append(theta @ x + self.alpha * np.sqrt(x @ Ainv @ x))
        return int(np.argmax(scores))

    def update(self, idx: int, x: np.ndarray, quality: float, cost: float = 0.0):
        r = quality - self.cost_weight * cost
        self.A[idx] += np.outer(x, x)
        self.b[idx] += r * x


def capability_vector(logits_samples: List[np.ndarray], estimator: str = "entropy"
                      ) -> np.ndarray:
    """Learned model-capability representation (survey §2.1): summarize a
    model's behavior on probe queries as its mean/std uncertainty profile."""
    est = get_estimator(estimator)
    us = [_uncertainty(est, l) for l in logits_samples]
    return np.array([np.mean(us), np.std(us), np.min(us), np.max(us)])
