"""Collaborative serving launcher (PyTorch port): edge SLM + cloud LLM behind
the batched continuous-batching scheduler, with the collaboration decision
surface picked by ``--policy`` (a ``core/policy.py::CollabPolicy``).

    PYTHONPATH=src python -m repro_torch.launch.serve --edge smollm-135m \
        --cloud granite-8b --requests 8

Same flags and defaults as the JAX package's ``repro.launch.serve``, plus
``--device`` (default ``cuda``: with no card it raises; ``--device cpu``
runs the plain PyTorch versions of the kernels on the CPU).  Not ported
yet: ``--mesh`` (sharded serving) is refused.

Serve-time adaptation (batched scheduler): ``--adapt distill|lora``
captures every completion's supervision triple (prompt, rejected edge
draft, cloud-corrected continuation, and in distill mode the cloud's
``--adapt-topk`` teacher logits, pulled with the token tape) into a
``FeedbackStore``; every ``--adapt-interval`` completions a
``core/adaptation.py::AdaptationLoop`` takes a step between scheduler ticks
(forward KD on the full edge params, or LoRA adapter-only on the frozen
base) and hot-swaps the edge weights.  On CUDA those steps run the flash
kernel's hand-written backward.  ``--adapt-checkpoint PATH`` saves the
learned artifact on exit (the LoRA adapters, or the distilled edge params
in the JAX layout), restored by ``training/checkpoint.restore`` in either
package.  Without ``--adapt`` serving is unchanged.

``--scheduler per-request`` runs the one-at-a-time reference loop
(``core/engine.py::CollaborativeEngine.serve_reference``: a host round
trip per token, batch-1 dense decode and batch-1 speculative verify on
the card) — the baseline the batched numbers are quoted against.  It
honors only the threshold-family policies and refuses ``--arrival``,
``--spec-mode tree|self`` and ``--mesh``, as the JAX launcher does.

On CUDA the default path runs three hand-written Hopper kernels: the paged
decode attention of every edge tick and draft step, the flash attention of
every prefill, and the fused spec-verify of every speculative round.
``--spec-mode tree`` drafts and verifies token trees through the
tree-verify kernel on dense side caches; ``--kv-layout dense`` decodes
through the dense decode kernel; ``--spec-mode self`` drafts with the
edge model's own first ``--spec-exit-layer`` blocks.  ``--edge`` also
takes the recurrent families — ``mamba2-370m``, ``xlstm-125m``,
``zamba2-2.7b`` — whose prefills and extends run the chunked SSD-scan
kernel; with them ``--kv-layout auto`` resolves to dense, a speculative
round rewinds the edge by a batched replay, and the tree and self lanes
fall back to linear.
Parameters are the port's own seeded random init (edge seed 0, cloud seed
1); random-init models are near-uniform, so the 0.6 entropy gate escalates
every request into speculative verification.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.adaptation import AdaptationLoop
from repro_torch.core.engine import CollaborativeEngine
from repro_torch.core.policy import (POLICIES, ThresholdPolicy, make_policy,
                                     policy_from_legacy)
from repro_torch.core.scheduler import BatchedEngine
from repro_torch.core.traffic import bursty_arrivals, poisson_arrivals, replay
from repro_torch.data import SyntheticLM
from repro_torch.models import Model
from repro_torch.models.model import require_token_prompts


def build_policy(args):
    """Construct the ``CollabPolicy`` named by ``--policy`` (or by the
    deprecated ``--escalation`` alias) from its CLI kwargs."""
    if args.escalation is not None:
        if args.policy is not None:
            raise SystemExit("pass --policy or --escalation, not both")
        pol = policy_from_legacy(args.escalation, args.threshold)
        print(f"--escalation is deprecated; use --policy {pol.name}")
        return pol
    name = args.policy or "speculative"
    if name in ("threshold", "speculative", "skeleton"):
        return make_policy(name, threshold=args.threshold)
    if name == "cascade":
        ts = tuple(float(t) for t in args.cascade_thresholds.split(","))
        return make_policy(name, thresholds=ts)
    if name == "bandit":
        return make_policy(name, kind=args.bandit_kind,
                           cost_weight=args.bandit_cost_weight)
    return make_policy(name, threshold=args.threshold,   # budget
                       tokens_per_request=args.budget_tokens)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the models run; cuda needs a card and "
                         "raises without one")
    ap.add_argument("--edge", default="smollm-135m")
    ap.add_argument("--cloud", default="granite-8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--policy", default=None, choices=sorted(POLICIES),
                    help="collaboration policy (CollabPolicy); default: "
                         "speculative")
    ap.add_argument("--threshold", type=float, default=0.6,
                    help="uncertainty gate (threshold-family and budget "
                         "policies)")
    ap.add_argument("--cascade-thresholds", default="0.45,0.25",
                    help="comma-separated per-tier acceptance thresholds "
                         "(cascade policy)")
    ap.add_argument("--bandit-kind", default="ucb",
                    choices=["ucb", "linucb"])
    ap.add_argument("--bandit-cost-weight", type=float, default=0.3,
                    help="reward = quality - w * cloud-token share")
    ap.add_argument("--budget-tokens", type=float, default=8.0,
                    help="cloud tokens accrued per admitted request "
                         "(budget policy)")
    ap.add_argument("--spec-mode", default=None,
                    choices=["linear", "tree", "self"],
                    help="speculation lane for grouped speculative "
                         "escalations: linear draft tape, packed token-tree "
                         "verify, or self-speculative early-exit drafting; "
                         "default: linear")
    ap.add_argument("--spec-tree-width", type=int, default=None,
                    help="first-level branches of the draft tree "
                         "(--spec-mode tree); default 2")
    ap.add_argument("--spec-exit-layer", type=int, default=None,
                    help="draft exit layer (--spec-mode self); default: "
                         "half the edge model's depth")
    ap.add_argument("--escalation", default=None,
                    choices=["speculative", "cloud", "skeleton"],
                    help="DEPRECATED: legacy mode name; use --policy")
    ap.add_argument("--scheduler", default="batched",
                    choices=["batched", "per-request"],
                    help="batched continuous-batching scheduler vs the "
                         "one-request-at-a-time reference loop")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="scheduler slots (batched scheduler only)")
    ap.add_argument("--tick-tokens", type=int, default=16,
                    help="decode steps per scheduler tick")
    ap.add_argument("--kv-layout", default="auto",
                    choices=["auto", "paged", "dense"],
                    help="KV cache layout: paged = shared block pool + "
                         "per-slot block tables; dense = slots padded to a "
                         "common slot_len (the parity oracle); auto = paged "
                         "where the model families support it")
    ap.add_argument("--kv-block-size", type=int, default=32,
                    help="tokens per KV block (paged layout)")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="total KV pool blocks incl. the trap block (paged "
                         "layout); a full pool preempts by swap. Default: "
                         "sized to the dense worst case")
    ap.add_argument("--arrival", default="none",
                    choices=["none", "poisson", "bursty"],
                    help="open-loop arrival process against a virtual "
                         "clock instead of all-at-t=0")
    ap.add_argument("--arrival-rate", type=float, default=50.0,
                    help="long-run average arrival rate, requests/second "
                         "of virtual time")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="TTFT SLO in (virtual) ms; enables SLO "
                         "attainment + goodput-under-SLO reporting")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="max prompt tokens prefilled per scheduler tick "
                         "(chunked prefill); 0 disables chunking, default "
                         "= --tick-tokens")
    ap.add_argument("--adapt", default=None, choices=["distill", "lora"],
                    help="serve-time adaptation (batched scheduler): "
                         "capture completion triples into a FeedbackStore "
                         "and hot-swap background-trained edge weights "
                         "(distill = forward KD on full params, lora = "
                         "adapter-only on the frozen base)")
    ap.add_argument("--adapt-interval", type=int, default=16,
                    help="take an adaptation update every this many "
                         "completions (0 = capture-only)")
    ap.add_argument("--adapt-topk", type=int, default=8,
                    help="teacher logits kept per cloud-generated token "
                         "(distill mode; rides the wave's existing host "
                         "pull)")
    ap.add_argument("--adapt-checkpoint", default=None, metavar="PATH",
                    help="persist the learned artifact on exit: the LoRA "
                         "adapters (--adapt lora) or the distilled edge "
                         "params (--adapt distill)")
    ap.add_argument("--mesh", default=None, metavar="AXES",
                    help="sharded serving over local devices (not ported: "
                         "the batched engine refuses it)")
    ap.add_argument("--reduced", action="store_true")
    return ap.parse_args(argv)


def check_scheduler_args(args, policy) -> None:
    """The per-request loop's refusals, as the JAX launcher's."""
    if args.scheduler == "batched":
        return
    if not isinstance(policy, ThresholdPolicy):
        # serve_reference cannot honor the assign/decide/feedback hooks, so
        # running it would serve speculative@0.6 under this policy's name
        raise SystemExit(
            f"--scheduler per-request only honors the threshold-family "
            f"policies; run --policy {policy.name} on --scheduler batched")
    if args.arrival != "none":
        raise SystemExit("--arrival needs --scheduler batched (the "
                         "per-request loop has no admission queue)")
    if args.mesh is not None:
        raise SystemExit("--mesh needs --scheduler batched (the "
                         "per-request loop is single-device)")
    if args.spec_mode not in (None, "linear"):
        raise SystemExit("--spec-mode tree/self needs --scheduler batched "
                         "(the per-request loop only drafts linear tapes)")
    if args.adapt is not None:
        raise SystemExit("--adapt needs --scheduler batched (capture rides "
                         "the batched scheduler's retirement path)")


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) needs a CUDA card; "
                           "pass --device cpu to run on the CPU")
    dev = torch.device(args.device)
    policy = build_policy(args)
    check_scheduler_args(args, policy)
    e_cfg = get_config(args.edge)
    c_cfg = get_config(args.cloud)
    for flag, cfg in (("--edge", e_cfg), ("--cloud", c_cfg)):
        require_token_prompts(cfg, f"launch/serve.py {flag}")
    if args.reduced:
        e_cfg, c_cfg = e_cfg.reduced(), c_cfg.reduced()
    # shared vocab required for token-level collaboration
    v = min(e_cfg.vocab_size, c_cfg.vocab_size)
    e_cfg, c_cfg = e_cfg.replace(vocab_size=v), c_cfg.replace(vocab_size=v)

    edge, cloud = Model(e_cfg), Model(c_cfg)
    ep = edge.init(seed=0, device=dev)
    cp = cloud.init(seed=1, device=dev)

    synth = SyntheticLM(v)
    rng = np.random.default_rng(0)
    prompts = [synth.sample(rng, i % synth.n_domains, args.prompt_len)
               for i in range(args.requests)]
    paths = {}

    t0 = time.perf_counter()
    if args.scheduler == "per-request":
        eng = CollaborativeEngine(edge, cloud, gamma=args.gamma,
                                  temperature=0.0, policy=policy)
        traces = [eng.serve_reference(ep, cp, p, args.max_new)
                  for p in prompts]
    else:
        adaptation = None if args.adapt is None else AdaptationLoop(
            mode=args.adapt, interval=args.adapt_interval,
            topk=args.adapt_topk)
        eng = BatchedEngine(edge, cloud, batch_size=args.batch_size,
                            gamma=args.gamma, temperature=0.0, policy=policy,
                            tick_tokens=args.tick_tokens,
                            kv_layout=args.kv_layout,
                            kv_block_size=args.kv_block_size,
                            kv_blocks=args.kv_blocks, slo_ms=args.slo_ms,
                            prefill_chunk=args.prefill_chunk,
                            spec_mode=args.spec_mode,
                            spec_tree_width=args.spec_tree_width,
                            spec_exit_layer=args.spec_exit_layer,
                            mesh=args.mesh, adaptation=adaptation)
        if args.arrival != "none":
            gen = (poisson_arrivals if args.arrival == "poisson"
                   else bursty_arrivals)
            at = gen(args.arrival_rate, args.requests, seed=0)
            traces = replay(eng, ep, cp, prompts, args.max_new, at)
        else:
            traces = eng.serve_batch(
                ep, cp, prompts, args.max_new,
                domains=[i % synth.n_domains for i in range(args.requests)])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    for i, tr in enumerate(traces):
        paths[tr.path] = paths.get(tr.path, 0) + 1
        print(f"req {i:3d} path={tr.path:12s} unc={tr.uncertainty:.3f} "
              f"edge_calls={tr.edge_calls} cloud_passes={tr.cloud_passes}")
    stats = eng.stats()

    toks = args.requests * args.max_new
    print(f"\n{args.requests} requests in {dt:.1f}s "
          f"({args.requests / dt:.2f} req/s, {toks / dt:.1f} tok/s); "
          f"paths: {paths}; cache hit rate {stats['cache_hit_rate']:.2f}")
    print(f"policy: {stats['policy']} "
          + " ".join(f"{k.removeprefix('policy_')}={v}"
                     for k, v in stats.items() if k.startswith("policy_")))
    if stats.get("spec_lanes") and any(
            c["member_rounds"] for c in stats["spec_lanes"].values()):
        print(f"spec: mode={stats['spec_mode']} "
              f"accept_rate={stats['spec_accept_rate']:.2f} "
              f"accepted_tokens_per_step="
              f"{stats['accepted_tokens_per_step']:.2f} "
              + " ".join(f"{m}[draft={c['draft_tokens']} "
                         f"verify={c['verify_tokens']} "
                         f"accepted={c['accepted_tokens']} "
                         f"emitted={c['emitted_tokens']} "
                         f"rounds={c['member_rounds']}]"
                         for m, c in stats["spec_lanes"].items()))
    if "kv_peak_bytes" in stats:
        print(f"kv: layout={stats['kv_layout']} "
              f"peak={stats['kv_peak_bytes'] / 1e6:.2f}MB "
              f"capacity={stats['kv_capacity_bytes'] / 1e6:.2f}MB"
              + (f" blocks_peak={stats['kv_blocks_peak']}"
                 if "kv_blocks_peak" in stats else ""))
        if stats.get("kv_prefix_hits") or stats.get("preemptions"):
            print(f"kv: prefix_hits={stats.get('kv_prefix_hits', 0)} "
                  f"shared_blocks={stats.get('kv_shared_blocks', 0)} "
                  f"cow_forks={stats.get('kv_cow_forks', 0)} "
                  f"preemptions={stats.get('preemptions', 0)} "
                  f"swaps={stats.get('kv_swaps', 0)}")
    if "ttft_p50_ms" in stats:
        unit = "virtual ms" if args.arrival != "none" else "ms"
        print(f"latency ({unit}): "
              f"ttft p50={stats['ttft_p50_ms']:.1f} "
              f"p99={stats['ttft_p99_ms']:.1f} "
              f"tpot p50={stats['tpot_p50_ms']:.2f} "
              f"p99={stats['tpot_p99_ms']:.2f} "
              f"makespan={stats['makespan_ms']:.0f} "
              f"(swapped={stats['swapped_requests']} "
              f"deferred={stats['deferred_admissions']})")
        if args.slo_ms is not None:
            print(f"slo: ttft<={args.slo_ms:.0f}ms "
                  f"attainment={stats['slo_attainment']:.2f} "
                  f"goodput={stats['goodput_slo']:.2f} req/s")
    if "adaptation" in stats:
        a = stats["adaptation"]
        loss = "n/a" if a["last_loss"] is None else f"{a['last_loss']:.4f}"
        print(f"adapt: mode={a['mode']} observed={a['observed']} "
              f"updates={a['updates']} steps={a['train_steps']} "
              f"swaps={a['swaps']} loss={loss} "
              f"store={a['store_size']}/{a['store_capacity']} "
              f"(evicted={a['store_evicted']})")
    if args.adapt_checkpoint is not None and "adaptation" in stats:
        from repro_torch.training import checkpoint
        artifact = adaptation.adapters if args.adapt == "lora" \
            else adaptation.latest
        if artifact is None:
            print(f"adapt: nothing learned yet — skipping checkpoint "
                  f"{args.adapt_checkpoint}")
        else:
            checkpoint.save(args.adapt_checkpoint, artifact,
                            step=adaptation.steps, cfg=adaptation.model.cfg)
            print(f"adapt: saved {args.adapt} artifact to "
                  f"{args.adapt_checkpoint} (restore via "
                  "training/checkpoint.restore)")
    return traces, stats


if __name__ == "__main__":
    main()
