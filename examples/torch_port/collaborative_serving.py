"""End-to-end collaborative serving driver (PyTorch port): batched requests
through the real serving path — ``BatchedEngine.serve_batch``, slot-based
admission into paged KV caches, one decode loop per tick, semantic cache
with intra-batch dedup, and uncertainty-gated grouped escalation — driven
by TWO pluggable ``CollabPolicy`` implementations side by side:

  * ``SpeculativePolicy`` — confidence gate into grouped speculative cloud
    verification (token-level mixture);
  * ``CascadePolicy`` — FrugalGPT-style cost-ordered cascade over
    collaboration tiers (accept -> speculative -> full cloud regen).

    PYTHONPATH=src python examples/torch_port/collaborative_serving.py

The twin of ``examples/collaborative_serving.py``; it imports only
``repro_torch``.  ``--device`` defaults to ``cuda`` and raises without a
card.
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.policy import (CascadePolicy, SpeculativePolicy,
                                     cloud_tokens)
from repro_torch.core.scheduler import BatchedEngine
from repro_torch.data import SyntheticLM
from repro_torch.launch import resolve_device
from repro_torch.models import Model

GAMMA, MAX_NEW = 4, 16


def main(argv=None):
    """Returns {policy label: (req/s, path mix, cloud tokens per request,
    engine stats, traces)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = resolve_device(ap.parse_args(argv).device)
    edge_cfg = get_config("smollm-135m").reduced()
    cloud_cfg = get_config("granite-8b").reduced().replace(
        vocab_size=edge_cfg.vocab_size)
    edge, cloud = Model(edge_cfg), Model(cloud_cfg)
    ep = edge.init(seed=0, device=dev)
    cp = cloud.init(seed=1, device=dev)

    synth = SyntheticLM(edge_cfg.vocab_size, n_domains=3)
    rng = np.random.default_rng(0)
    requests = [synth.sample(rng, i % 3, 12) for i in range(10)]
    requests += requests[:3]      # repeats -> cache hits (dedup/coalescing)

    summary = {}
    for label, policy in [
            ("speculative@0.55", SpeculativePolicy(threshold=0.55)),
            ("cascade", CascadePolicy(thresholds=(0.45, 0.25), relief=0.5))]:
        engine = BatchedEngine(edge, cloud, batch_size=8, gamma=GAMMA,
                               temperature=0.0, policy=policy,
                               cache_threshold=0.98, tick_tokens=8)
        t0 = time.time()
        traces = engine.serve_batch(ep, cp, requests, MAX_NEW)
        dt = time.time() - t0

        print(f"\n=== policy: {label} ===")
        paths = {}
        for i, tr in enumerate(traces):
            paths[tr.path] = paths.get(tr.path, 0) + 1
            print(f"req {i:2d}: path={tr.path:12s} unc={tr.uncertainty:.3f} "
                  f"edge={tr.edge_calls:3d} cloud={tr.cloud_passes:2d}")
        n = len(requests)
        ct = sum(cloud_tokens(tr, GAMMA) for tr in traces)
        stats = engine.stats()
        summary[label] = (n / dt, paths, ct / n, stats, traces)
        print(f"{n} requests in {dt:.1f}s ({n / dt:.2f} req/s); "
              f"path mix: {paths}")
        print(f"cloud tokens/request: {ct / n:.1f} "
              f"(cloud-only would be {MAX_NEW:.1f}); "
              f"cache hit rate: {stats['cache_hit_rate']:.2f}")
        print(f"kv: layout={stats['kv_layout']} "
              f"peak={stats['kv_peak_bytes'] / 1e6:.2f}MB "
              f"capacity={stats['kv_capacity_bytes'] / 1e6:.2f}MB")

    print("\n=== side by side ===")
    for label, (req_s, paths, ct, stats, _) in summary.items():
        extra = {k.removeprefix("policy_"): v for k, v in stats.items()
                 if k.startswith("policy_")}
        print(f"{label:18s} {req_s:5.2f} req/s  cloud tok/req {ct:5.1f}  "
              f"paths {paths} {extra or ''}")
    return summary


if __name__ == "__main__":
    main()
