"""First-class collaboration policies over the batched scheduler.

The survey's core contribution is a taxonomy of edge-cloud collaboration —
task assignment, task division, and mixture-based collaboration at task and
token granularity — but the serving stack used to hardcode that choice as a
three-way ``escalation: str`` plus one scalar threshold.  This module turns
the collaboration-decision surface into a pluggable protocol,
``CollabPolicy``, with three batched scheduler-driven hooks:

  * ``assign(features) -> lane`` at ADMISSION (task assignment): route a
    request to ``"edge"`` (edge-only, accept whatever the SLM produces),
    ``"cloud"`` (cloud-only, skip the edge decode entirely), or
    ``"collab"`` (edge-first with a retirement-time decision).  ``features``
    carries prompt features, live load stats, and REAL deadline state from
    the scheduler's open-loop clock — ``at_ms`` / ``now_ms`` / ``wait_ms``
    (time already spent queueing) / ``slo_ms`` — so SLA-aware policies
    classify against actual latency pressure, not proxies (see
    ``BatchedEngine`` and ``deadline_classifier``).
  * ``decide(unc, steps, budget) -> actions`` per RETIREMENT WAVE (task- /
    token-granular escalation choice), VECTORIZED over the wave: per
    retiring request, ``"accept"`` the edge output, ``"cloud"``-regenerate
    (task assignment), ``"skeleton"``-divide (cloud plans a prefix, edge
    completes — task division), or ``"speculative"``-verify (token-level
    mixture).  Inputs are aligned arrays: normalized mean uncertainty,
    edge decode steps ACTUALLY spent (a stop-token hit retires a request
    early, so ``steps`` can be < ``budget``), and the generation budget.
  * ``feedback(action, quality, cost, features)`` after COMPLETION: the
    realized quality proxy and cloud-token cost of each finished request,
    plus the realized latencies (``ttft_ms`` / ``e2e_ms`` / ``slo_met``),
    closing the online-learning loop for bandit/budget policies.

Policies are host-side control plane (NumPy) exactly like the routers in
``core/routing.py`` they compose; the scheduler keeps every action GROUPED
and batched on device.  The legacy ``escalation=``/``escalate_threshold=``
kwargs survive one release as a deprecation shim (``resolve_policy``)
mapping onto the matching policy object.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from repro_torch.core.routing import CascadeRouter, LinUCBRouter, UCBRouter

#: admission-time lanes (task assignment)
LANES = ("edge", "cloud", "collab")
#: retirement-wave actions (escalation mechanisms, ``accept`` included)
ACTIONS = ("accept", "cloud", "skeleton", "speculative")
#: actions that involve the cloud (valid escalation targets)
ESCALATIONS = ("cloud", "skeleton", "speculative")


# ------------------------------------------------------------ trace metrics
def cloud_tokens(trace, gamma: int) -> int:
    """Cloud-side token cost of a finished request: autoregressive paths
    pay one token per pass; a speculative verify pass scores gamma drafts
    plus the bonus token."""
    if trace.path == "speculative":
        return int(trace.cloud_passes) * (gamma + 1)
    return int(trace.cloud_passes)


def trace_quality(trace, max_new: int) -> float:
    """Quality proxy in [0, 1] for a finished request: cloud-exact outputs
    (cloud regen, lossless speculative verify) score 1.0; edge-accepted
    output scores its confidence ``1 - u``; a skeleton split interpolates
    by the cloud's token share.  Cache replays carry no quality signal of
    their own (the entry may be edge- or cloud-origin) and score 1.0 by
    convention — the engine never feeds them back to a policy."""
    if trace.path in ("cloud", "speculative", "cache"):
        return 1.0
    u = min(max(float(trace.uncertainty), 0.0), 1.0)
    if trace.path == "skeleton":
        share = min(float(trace.cloud_passes) / max(max_new, 1), 1.0)
        return share + (1.0 - share) * (1.0 - u)
    return 1.0 - u


def _as1d(x) -> np.ndarray:
    return np.reshape(np.asarray(x, np.float64), (-1,))


# ---------------------------------------------------------------- protocol
class CollabPolicy:
    """Base collaboration policy: everything to the collaborative lane,
    decisions and learning left to subclasses (see the module docstring
    for the three hooks' contracts)."""

    name = "collab"

    def assign(self, features: Dict[str, Any]) -> str:
        """Admission-time lane for one request; default: collaborative.
        The scheduler calls this exactly ONCE per request, at its first
        admission attempt (a deferred request keeps its lane), so stateful
        policies may accrue per-request state here without deduping."""
        return "collab"

    def decide(self, unc, steps, budget) -> Sequence[str]:
        """Per-wave actions for the retiring requests (aligned arrays)."""
        raise NotImplementedError

    def feedback(self, action: str, quality: float, cost: float,
                 features: Optional[Dict[str, Any]] = None) -> None:
        """Completion feedback: realized quality proxy and cloud-token
        cost of one request that took ``action``."""

    def stats(self) -> Dict[str, Any]:
        return {}


class ThresholdPolicy(CollabPolicy):
    """The survey's confidence-gated task assignment: accept the edge
    output when mean uncertainty clears ``threshold``, else regenerate
    with the fixed escalation ``action`` (default: full cloud regen)."""

    name = "threshold"
    action = "cloud"

    def __init__(self, threshold: float = 0.6, action: Optional[str] = None):
        self.threshold = float(threshold)
        if action is not None:
            if action not in ESCALATIONS:
                raise ValueError(f"unknown escalation action {action!r}; "
                                 f"known: {' | '.join(ESCALATIONS)}")
            self.action = action

    def decide(self, unc, steps, budget):
        return ["accept" if u <= self.threshold else self.action
                for u in _as1d(unc)]


class SpeculativePolicy(ThresholdPolicy):
    """Threshold gate escalating into grouped speculative verification
    (token-level mixture, the legacy ``escalation="speculative"``).

    ``mode`` picks the decoder's speculation lane — the engine reads it at
    construction (see ``BatchedEngine`` / ``BatchedSpecDecoder``):

      * ``"linear"``: the classic gamma-token draft tape (default).
      * ``"tree"``: packed token-tree drafts, ``tree_width`` first-level
        branches, verified in one tree-masked cloud pass.
      * ``"self"``: self-speculative — the edge model's early-exit prefix
        (``exit_layer`` blocks, default half depth) drafts for its own
        full-depth verify; no second model involved.
    """

    name = "speculative"
    action = "speculative"

    def __init__(self, threshold: float = 0.6, *, mode: str = "linear",
                 tree_width: int = 2, exit_layer: Optional[int] = None):
        super().__init__(threshold)
        if mode not in ("linear", "tree", "self"):
            raise ValueError(f"unknown speculation mode {mode!r}; "
                             "known: linear | tree | self")
        self.spec_mode = mode
        self.spec_tree_width = int(tree_width)
        self.spec_exit_layer = exit_layer


class SkeletonPolicy(ThresholdPolicy):
    """Threshold gate escalating into skeleton task division (cloud plans
    the prefix, edge completes — the legacy ``escalation="skeleton"``)."""

    name = "skeleton"
    action = "skeleton"


class CascadePolicy(CollabPolicy):
    """FrugalGPT-style multi-tier cascade over collaboration mechanisms,
    cost-ordered through ``CascadeRouter``: try the cheapest tier first
    (accepting the already-paid edge output), escalate only while the
    tier's predicted residual uncertainty misses its acceptance threshold.
    Tier i's residual is modeled as ``unc * relief**i`` — each costlier
    mechanism folds in more cloud involvement and leaves less uncertainty
    (the last tier is unconditional).  Note tier i+1 is only REACHABLE for
    uncertainties above ``thresholds[i] / relief**i`` — keep each
    threshold below the previous tier's residual scale (the defaults keep
    all three tiers live on the estimators' [0, 1] range).
    """

    name = "cascade"

    def __init__(self, thresholds: Sequence[float] = (0.45, 0.25),
                 tiers: Sequence[str] = ("accept", "speculative", "cloud"),
                 costs: Sequence[float] = (0.0, 1.0, 4.0),
                 relief: float = 0.35):
        tiers = tuple(tiers)
        if not tiers or tiers[0] != "accept":
            raise ValueError("cascade tier 0 must be 'accept' (the edge "
                             "output is already paid for)")
        for t in tiers[1:]:
            if t not in ESCALATIONS:
                raise ValueError(f"unknown cascade tier {t!r}; known: "
                                 f"accept | {' | '.join(ESCALATIONS)}")
        if len(costs) != len(tiers):
            raise ValueError(f"{len(tiers)} tiers but {len(costs)} costs")
        if list(costs) != sorted(costs):
            raise ValueError(f"cascade tiers must be cost-ordered "
                             f"(ascending), got {list(costs)}")
        if len(thresholds) != len(tiers) - 1:
            raise ValueError(f"{len(tiers)} tiers need {len(tiers) - 1} "
                             f"thresholds (last tier is unconditional), "
                             f"got {len(thresholds)}")
        self.tiers = tiers
        self.relief = float(relief)
        self.router = CascadeRouter(costs=list(costs),
                                    thresholds=list(thresholds)
                                    + [float("inf")])
        self._tier_counts = [0] * len(tiers)
        self._cascade_cost = 0.0

    def decide(self, unc, steps, budget):
        acts = []
        for u in _as1d(unc):
            route = self.router.route(
                [lambda i=i, u=float(u): u * self.relief ** i
                 for i in range(len(self.tiers))])
            self._tier_counts[route.model_idx] += 1
            self._cascade_cost += route.cost
            acts.append(self.tiers[route.model_idx])
        return acts

    def stats(self):
        return {"policy_tier_counts": dict(zip(self.tiers,
                                               self._tier_counts)),
                "policy_cascade_cost": self._cascade_cost}


class BanditPolicy(CollabPolicy):
    """Online reward/cost-aware routing (PerLLM / MixLLM style): a bandit
    over escalation actions, learning from completion feedback — the first
    real wiring of ``core/routing.py``'s bandit routers into serving.

    ``kind="ucb"`` runs a context-free ``UCBRouter``; ``kind="linucb"``
    runs a contextual ``LinUCBRouter`` over per-request features
    ``[1, unc, steps, budget]`` (the capability signals available at
    decide time).  Reward is ``quality - cost_weight * cloud_token_share``
    per ``feedback``.  Arms selected in one wave are pulled before any of
    their rewards land, so cold-start spreads round-robin over arms with
    no pulls outstanding.
    """

    name = "bandit"

    def __init__(self, arms: Sequence[str] = ("accept", "speculative",
                                              "cloud"),
                 kind: str = "ucb", cost_weight: float = 0.3,
                 c: float = 0.5, alpha: float = 0.3):
        arms = tuple(arms)
        for a in arms:
            if a not in ACTIONS:
                raise ValueError(f"unknown bandit arm {a!r}; known: "
                                 f"{' | '.join(ACTIONS)}")
        if len(set(arms)) != len(arms) or not arms:
            raise ValueError(f"bandit arms must be distinct and non-empty, "
                             f"got {arms}")
        self.arms = arms
        self._arm_idx = {a: i for i, a in enumerate(arms)}
        self.kind = kind
        if kind == "ucb":
            self.router = UCBRouter(len(arms), cost_weight=cost_weight, c=c)
        elif kind == "linucb":
            self.router = LinUCBRouter(len(arms), dim=4, alpha=alpha,
                                       cost_weight=cost_weight)
        else:
            raise ValueError(f"unknown bandit kind {kind!r}; "
                             "known: ucb | linucb")
        self._pending = np.zeros(len(arms))   # selected, reward not landed
        self._landed = np.zeros(len(arms))    # rewards received per arm
        self._pulls = {a: 0 for a in arms}

    @staticmethod
    def _x(u, steps, budget) -> np.ndarray:
        return np.array([1.0, float(u), min(float(steps), 64.0) / 64.0,
                         min(float(budget), 64.0) / 64.0])

    def decide(self, unc, steps, budget):
        acts = []
        for u, s, m in zip(_as1d(unc), _as1d(steps), _as1d(budget)):
            # cold start (both kinds): round-robin by landed + OUTSTANDING
            # pulls until every arm has a landed reward — the routers' own
            # cold-start behavior cannot see mid-wave pending pulls (and
            # LinUCB's identical-score argmax would pile onto arm 0)
            if (self._landed == 0).any():
                i = int(np.argmin(self._landed + self._pending))
                if self.kind == "ucb":
                    self.router.t += 1      # keep the UCB clock honest
            elif self.kind == "ucb":
                i = self.router.select()
            else:
                i = self.router.select(self._x(u, s, m))
            self._pending[i] += 1
            self._pulls[self.arms[i]] += 1
            acts.append(self.arms[i])
        return acts

    def feedback(self, action, quality, cost, features=None):
        f = features or {}
        if f.get("lane", "collab") != "collab":
            return          # lane-assigned completion: no pull to reward
        i = self._arm_idx.get(action)
        if i is None:       # foreign action: not an arm
            return
        self._pending[i] = max(self._pending[i] - 1, 0.0)
        self._landed[i] += 1
        budget = max(float(f.get("budget", 1.0)), 1.0)
        share = float(cost) / budget
        if self.kind == "ucb":
            self.router.update(i, float(quality), share)
        else:
            self.router.update(i, self._x(f.get("unc", 0.0),
                                          f.get("steps", budget), budget),
                               float(quality), share)

    def stats(self):
        out: Dict[str, Any] = {"policy_pulls": dict(self._pulls)}
        if self.kind == "ucb":
            out["policy_arm_means"] = {a: float(self.router.mean[i])
                                       for a, i in self._arm_idx.items()}
        return out


class BudgetPolicy(CollabPolicy):
    """Per-request cloud-token budgeting with SLA classes: every admitted
    request accrues ``tokens_per_request`` (scaled by its SLA class's
    multiplier) into a shared cloud-token pool; an uncertain retirement
    escalates only while the pool can cover its generation budget, and
    DEGRADES to edge-accept once spent.  ``decide`` reserves the estimated
    spend so one wave cannot over-grant; ``feedback`` reconciles the
    reservation against the realized cloud-token cost (a speculative
    escalation can overdraw slightly — the pool carries the debt).
    Accrual relies on the scheduler's contract that ``assign`` runs once
    per request.

    ``classify`` maps the admission feature dict to an SLA class name; the
    scheduler feeds it REAL deadline state (``wait_ms`` / ``slo_ms`` from
    the open-loop clock), so ``deadline_classifier`` builds the common
    case: class by fraction of the TTFT SLO already burned queueing.
    """

    name = "budget"

    def __init__(self, threshold: float = 0.6,
                 tokens_per_request: float = 8.0, action: str = "cloud",
                 sla: Optional[Dict[str, float]] = None,
                 classify: Optional[Callable[[Dict[str, Any]], str]] = None):
        if action not in ESCALATIONS:
            raise ValueError(f"unknown escalation action {action!r}; "
                             f"known: {' | '.join(ESCALATIONS)}")
        self.threshold = float(threshold)
        self.action = action
        self.tokens_per_request = float(tokens_per_request)
        self.sla = dict(sla) if sla else {"standard": 1.0}
        self._classify = classify or (lambda feats: next(iter(self.sla)))
        self._pool = 0.0
        self._granted = 0
        self._degraded = 0
        self._class_counts: Dict[str, int] = {}

    def assign(self, features):
        cls = self._classify(features)
        self._class_counts[cls] = self._class_counts.get(cls, 0) + 1
        self._pool += self.tokens_per_request * float(self.sla.get(cls, 1.0))
        return "collab"

    def decide(self, unc, steps, budget):
        acts = []
        for u, m in zip(_as1d(unc), _as1d(budget)):
            if u <= self.threshold:
                acts.append("accept")
            elif self._pool >= m:
                self._pool -= m
                self._granted += 1
                acts.append(self.action)
            else:
                self._degraded += 1
                acts.append("accept")
        return acts

    def feedback(self, action, quality, cost, features=None):
        if action not in ESCALATIONS:
            return
        f = features or {}
        if "budget" not in f:
            return      # no estimate known: the reservation stands as spend
        self._pool += float(f["budget"]) - float(cost)  # est -> realized

    def stats(self):
        return {"policy_cloud_pool": self._pool,
                "policy_granted": self._granted,
                "policy_degraded": self._degraded,
                "policy_sla_classes": dict(self._class_counts)}


def deadline_classifier(boundaries: Dict[str, float]
                        ) -> Callable[[Dict[str, Any]], str]:
    """Build a ``BudgetPolicy`` SLA classifier keyed on REAL deadline
    pressure: ``boundaries`` maps class name -> max fraction of the TTFT
    SLO a request may already have burned queueing (``wait_ms / slo_ms``
    from the scheduler's open-loop clock) and the first boundary that
    covers the request wins, e.g. ``{"relaxed": 0.25, "standard": 0.5,
    "urgent": float("inf")}``.  With no SLO configured (or in closed-loop
    runs where ``wait_ms`` is 0) every request lands in the first class —
    the deadline feed degrades gracefully to the legacy behavior."""
    if not boundaries:
        raise ValueError("boundaries must name at least one SLA class")
    ordered = sorted(boundaries.items(), key=lambda kv: kv[1])

    def classify(feats: Dict[str, Any]) -> str:
        slo, wait = feats.get("slo_ms"), feats.get("wait_ms")
        if not slo or wait is None:
            return ordered[0][0]
        frac = float(wait) / float(slo)
        for name, bound in ordered:
            if frac <= bound:
                return name
        return ordered[-1][0]

    return classify


# ---------------------------------------------------------------- factories
POLICIES = {
    "threshold": ThresholdPolicy,
    "speculative": SpeculativePolicy,
    "skeleton": SkeletonPolicy,
    "cascade": CascadePolicy,
    "bandit": BanditPolicy,
    "budget": BudgetPolicy,
}

_LEGACY = {"cloud": ThresholdPolicy, "speculative": SpeculativePolicy,
           "skeleton": SkeletonPolicy}


def make_policy(name: str, **kwargs) -> CollabPolicy:
    """Build a shipped policy by name (the ``--policy`` CLI surface)."""
    if name not in POLICIES:
        raise KeyError(f"unknown policy {name!r}; known: "
                       f"{sorted(POLICIES)}")
    return POLICIES[name](**kwargs)


def policy_from_legacy(escalation: str, threshold: float) -> CollabPolicy:
    """Map the legacy ``escalation=`` mode string + threshold onto the
    equivalent policy object (byte-identical serving decisions)."""
    if escalation not in _LEGACY:
        raise ValueError(f"unknown escalation mode {escalation!r}; "
                         "known: speculative | cloud | skeleton")
    return _LEGACY[escalation](threshold=threshold)


def resolve_policy(policy, escalation: Optional[str] = None,
                   escalate_threshold: Optional[float] = None, *,
                   stacklevel: int = 3) -> CollabPolicy:
    """Engine-constructor shim: return ``policy`` (a ``CollabPolicy`` or a
    ``make_policy`` name), or map the DEPRECATED ``escalation=`` /
    ``escalate_threshold=`` kwargs onto the matching policy with a
    ``DeprecationWarning``.  No kwargs at all keeps the historical default
    (speculative verification at threshold 0.6)."""
    if policy is not None:
        if escalation is not None or escalate_threshold is not None:
            raise ValueError(
                "pass either policy= or the legacy escalation=/"
                "escalate_threshold= kwargs, not both")
        if isinstance(policy, str):
            return make_policy(policy)
        return policy
    if escalation is None and escalate_threshold is None:
        return SpeculativePolicy()
    warnings.warn(
        "escalation=/escalate_threshold= are deprecated and will be "
        "removed next release; pass policy= instead (e.g. "
        "policy=SpeculativePolicy(threshold=...)) — the legacy kwargs map "
        "onto the matching CollabPolicy",
        DeprecationWarning, stacklevel=stacklevel)
    return policy_from_legacy(
        "speculative" if escalation is None else escalation,
        0.6 if escalate_threshold is None else escalate_threshold)
