"""Open-loop arrival simulation + latency accounting for the serving stack.

The survey's task-assignment and budget/SLA policies (§2.3) are claims
about *latency and cost under real traffic*, but a benchmark that replays
a fixed request list back-to-back measures neither: every request "arrives"
the instant the engine is free, so queueing delay, time-to-first-token and
SLO attainment are all degenerate.  This module supplies the missing
harness pieces; ``core/scheduler.py::BatchedEngine`` consumes them:

  * ARRIVAL PROCESSES — ``poisson_arrivals`` (memoryless open-loop load),
    ``bursty_arrivals`` (on/off bursts at a peak rate around the same
    long-run average — the regime that actually exercises admission
    control and preemption), and ``trace_arrivals`` (replay recorded
    timestamps).  All return sorted arrival times in milliseconds,
    deterministic under a seed, to feed ``BatchedEngine.submit(at=...)``.

  * CLOCKS — the engine reads time through one small interface
    (``now / wait_until / on_steps / on_prefill``) so the same scheduler
    runs open-loop against either:

      - ``VirtualClock``: deterministic simulated time.  One batched
        decode-scan step costs ``step_ms``; one prefilled prompt token
        costs ``prefill_token_ms`` (default ``step_ms / 8`` — prefill is
        sequence-parallel, decode is not).  Thousands of virtual requests
        can be in flight against a CI-sized batch, and every latency
        number is reproducible bit-for-bit, so CI can assert on p99s.
      - ``WallClock``: real ``time.perf_counter`` time; ``wait_until``
        sleeps until the next arrival is due.  The modeled-cost hooks are
        no-ops — elapsed time IS the cost.

  * ROLLUP — ``latency_rollup`` turns the engine's per-request lifecycle
    events (submit / admit / first-token / retire timestamps plus swap and
    defer counts) into the serving headline numbers: p50/p99 TTFT (first
    token minus SUBMIT, so queueing delay counts) and TPOT (inter-token
    time after the first), SLO attainment, and goodput-under-SLO
    (completed requests meeting the TTFT SLO per second of makespan — the
    "goodput" of sarathi/vLLM-style serving papers).

Timestamps are tick-granular: the engine stamps first-token at the end of
the decode tick that emitted it, so a virtual-clock TTFT is resolved to
``tick_tokens * step_ms``.  Escalated requests re-stamp first-token at
their escalation's first step — the discarded edge stream never reached
the client, so counting it would flatter TTFT.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np


# ---------------------------------------------------------------- clocks
class VirtualClock:
    """Deterministic simulated clock (milliseconds).

    The engine charges modeled costs through ``on_steps`` (batched decode
    scan steps) and ``on_prefill`` (prompt tokens prefilled this tick);
    ``wait_until`` jumps over idle gaps to the next arrival.  ``step_ms``
    is the modeled cost of ONE decode-scan step over the whole batch —
    the natural time unit of the scheduler's tick loop.
    """

    def __init__(self, step_ms: float = 1.0,
                 prefill_token_ms: Optional[float] = None):
        if step_ms <= 0:
            raise ValueError(f"step_ms must be > 0, got {step_ms}")
        self.step_ms = float(step_ms)
        self.prefill_token_ms = (self.step_ms / 8.0
                                 if prefill_token_ms is None
                                 else float(prefill_token_ms))
        self._t = 0.0

    def now(self) -> float:
        return self._t

    def wait_until(self, t: float) -> None:
        self._t = max(self._t, float(t))

    def on_steps(self, n: int) -> None:
        self._t += n * self.step_ms

    def on_prefill(self, tokens: int) -> None:
        self._t += tokens * self.prefill_token_ms


class WallClock:
    """Real time (``time.perf_counter``, milliseconds since construction).

    Modeled-cost hooks are no-ops — real elapsed time is the cost; the
    step resolution ``step_ms`` is 0 (timestamps are already exact).
    ``wait_until`` sleeps, so open-loop arrival replay runs in real time.
    """

    step_ms = 0.0

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def wait_until(self, t: float) -> None:
        dt = float(t) - self.now()
        if dt > 0:
            time.sleep(dt / 1e3)

    def on_steps(self, n: int) -> None:
        pass

    def on_prefill(self, tokens: int) -> None:
        pass


# ---------------------------------------------------------------- arrivals
def poisson_arrivals(rate: float, n: int, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    """``n`` Poisson arrival times (ms) at ``rate`` requests/second:
    i.i.d. exponential inter-arrival gaps, deterministic under ``seed``."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0 req/s, got {rate}")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    rng = np.random.default_rng(seed)
    return start + np.cumsum(rng.exponential(1e3 / rate, size=n))


def bursty_arrivals(rate: float, n: int, seed: int = 0, burst: int = 8,
                    peak: float = 8.0, start: float = 0.0) -> np.ndarray:
    """``n`` on/off bursty arrival times (ms): bursts of ~``burst``
    requests (Poisson-sized) arrive at ``peak``x the mean rate, separated
    by idle gaps sized so the LONG-RUN average stays ``rate`` req/s.  The
    instantaneous overcommit is what stresses admission, chunked prefill
    and preemption; the mean rate keeps the workload comparable to
    ``poisson_arrivals`` at the same ``rate``."""
    if rate <= 0 or peak <= 1.0 or burst < 1:
        raise ValueError(f"need rate > 0, peak > 1, burst >= 1; got "
                         f"rate={rate} peak={peak} burst={burst}")
    rng = np.random.default_rng(seed)
    out, t = [], float(start)
    while len(out) < n:
        k = max(1, int(rng.poisson(burst)))
        served = min(k, n - len(out))
        for _ in range(served):
            t += rng.exponential(1e3 / (rate * peak))
            out.append(t)
        # the burst spent ~k/(rate*peak) s; the off-gap supplies the rest
        # of the k/rate s an average-rate process would have taken
        t += served * (1e3 / rate) * (1.0 - 1.0 / peak)
    return np.asarray(out, np.float64)


def trace_arrivals(times) -> np.ndarray:
    """Replay recorded arrival timestamps (ms): validated, sorted."""
    a = np.asarray(times, np.float64).reshape(-1)
    if a.size and not np.all(np.isfinite(a)):
        raise ValueError("trace arrival times must be finite")
    return np.sort(a)


# ---------------------------------------------------------------- replay
def replay(engine, edge_params, cloud_params, prompts, max_new, at):
    """Open-loop convenience: submit ``prompts`` at arrival times ``at``
    (ms, aligned), drain, return traces in submission order.  The engine's
    clock decides whether "time" is simulated or real."""
    if isinstance(max_new, int):
        max_new = [max_new] * len(prompts)
    at = np.asarray(at, np.float64).reshape(-1)
    if not (len(prompts) == len(max_new) == at.size):
        raise ValueError(f"{len(prompts)} prompts, {len(max_new)} budgets, "
                         f"{at.size} arrival times")
    rids = [engine.submit(p, m, at=float(t))
            for p, m, t in zip(prompts, max_new, at)]
    results = engine.run(edge_params, cloud_params)
    return [results[rid] for rid in rids]


# ---------------------------------------------------------------- rollup
def _pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if len(xs) \
        else 0.0


def latency_rollup(events: Dict[int, dict],
                   slo_ms: Optional[float] = None) -> Dict[str, Any]:
    """Roll per-request lifecycle events up into serving latency stats.

    ``events`` maps rid -> {submit_ms, admit_ms?, first_token_ms?,
    retire_ms?, tokens?, swaps?, defers?}.  TTFT counts from SUBMIT (so
    queueing delay is included); TPOT is the mean inter-token gap after
    the first token, defined only for requests that streamed >= 2 tokens
    (cache hits and instant replays carry no decode cadence).  Goodput is
    completed-requests-meeting-the-TTFT-SLO per second of makespan; with
    no SLO every completed request counts (goodput == throughput).
    """
    done = [e for e in events.values() if "retire_ms" in e]
    ttfts = [e["first_token_ms"] - e["submit_ms"] for e in done
             if "first_token_ms" in e]
    tpots = [(e["retire_ms"] - e["first_token_ms"]) / (e["tokens"] - 1)
             for e in done
             if e.get("tokens", 0) > 1 and "first_token_ms" in e
             and e["retire_ms"] > e["first_token_ms"]]
    out: Dict[str, Any] = {
        "requests": len(events),
        "completed": len(done),
        "ttft_p50_ms": _pct(ttfts, 50),
        "ttft_p99_ms": _pct(ttfts, 99),
        "ttft_mean_ms": float(np.mean(ttfts)) if ttfts else 0.0,
        "tpot_p50_ms": _pct(tpots, 50),
        "tpot_p99_ms": _pct(tpots, 99),
        "slo_ms": slo_ms,
        "swapped_requests": sum(1 for e in events.values()
                                if e.get("swaps", 0) > 0),
        "deferred_admissions": sum(e.get("defers", 0)
                                   for e in events.values()),
    }
    if done:
        makespan = (max(e["retire_ms"] for e in done)
                    - min(e["submit_ms"] for e in done))
        met = [e for e in done
               if slo_ms is None
               or ("first_token_ms" in e
                   and e["first_token_ms"] - e["submit_ms"] <= slo_ms)]
        out["makespan_ms"] = makespan
        out["slo_attainment"] = len(met) / len(done)
        out["goodput_slo"] = (len(met) / (makespan / 1e3) if makespan > 0
                              else float(len(met)))
    else:
        out["makespan_ms"] = 0.0
        out["slo_attainment"] = 0.0
        out["goodput_slo"] = 0.0
    return out
