#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Runs from the root of a checkout, imports the port from ``src/`` (never
JAX, never the JAX package), and fails (exit code 1, no result line) on
the first phase that fails:

1. build the port's CUDA kernels from the checkout's sources (one ``nvcc``
   per source, in parallel) and print the build time;
2. hold each kernel against its plain PyTorch version at the serving
   path's shapes, in float32 and bfloat16, with the tolerances printed, and
   time kernel, plain version and (flash only) the library yardstick
   ``F.scaled_dot_product_attention`` with CUDA events (median of 30 runs
   after warm-up);
3. serve the default path at full width — smollm-135m edge, granite-8b
   cloud, bfloat16, seeded random weights, 8 requests of 16 prompt tokens,
   24 new tokens, gamma 4, SpeculativePolicy(0.6), paged KV, linear lane,
   T = 0 — and check every request, the logits' finiteness and that every
   kernel's launch counter moved during that run;
4. serve the same engine at float32, full width, 2 layers per model, once
   on the kernels (``attn_backend="auto"``) and once on the plain versions
   (``"plain"``); the traces must agree, a divergence being excused (and
   reported) only where the plain model's top-2 logit gap is below 1e-4;
5. print the card's name and power limit, a ``{"kernels": [...]}`` line,
   and last the result line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"float32": 67e12,      # CUDA cores, no tensor cores
            "bfloat16": 989e12}    # dense tensor-core rate
GAP_TOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, reps: int = 30, warm: int = 5) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs (CUDA events
    around each call, after ``warm`` warm-up calls)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def bound_ms(nbytes: float, ops: float, dtype: str):
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the peak rate for the inputs' type."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# --------------------------------------------------------------- phase 1
def phase_build():
    from repro_torch.kernels.build import build_all
    t = time.perf_counter()
    libs = build_all()
    dt = time.perf_counter() - t
    print(f"[build] {len(libs)} kernel libraries in {dt:.1f}s: "
          + ", ".join(p.name for p in libs.values()), flush=True)


# --------------------------------------------------------------- phase 2
def _paged_inputs(dtype, gen):
    """Serving-path shapes of the paged decode: 8 slots, smollm-135m heads
    (Kv 3, G 3, hd 64), 32-token blocks, 3-block tables (slot_len 80)."""
    import torch
    B, Kv, G, hd, bs, MB = 8, 3, 3, 64, 32, 3
    NB = B * MB + 1
    dev = "cuda"
    q = torch.randn((B, Kv, G, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((NB, bs, Kv, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((NB, bs, Kv, hd), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(NB - 1, generator=gen, device=dev) + 1
    table = perm.reshape(B, MB).to(torch.int32).contiguous()
    length = torch.randint(15, 46, (B,), generator=gen, device=dev,
                           dtype=torch.int32)
    return q, kp, vp, table, length


def check_paged(gen):
    import torch
    from repro_torch.kernels import decode_attention as K
    rows = []
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, kp, vp, table, length = _paged_inputs(dtype, gen)
        for window in (0, 24):
            out = K.paged_decode_attention_cuda(q, kp, vp, table, length,
                                                window=window)
            ref = K.paged_decode_attention_plain(q, kp, vp, table, length,
                                                 window=window)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            print(f"[kernel] paged_decode_attention {str(dtype)[6:]} "
                  f"window={window}: max_abs_err={err:.3e} (tol {tol:g})",
                  flush=True)
            check(err <= tol, f"paged_decode_attention {dtype} window "
                              f"{window}: error {err} > {tol}")
            rows.append(err)
    # timing at the serving path's dtype (bfloat16, no window)
    q, kp, vp, table, length = _paged_inputs(torch.bfloat16, gen)
    ms = time_ms(lambda: K.paged_decode_attention_cuda(q, kp, vp, table,
                                                       length))
    plain = time_ms(lambda: K.paged_decode_attention_plain(q, kp, vp, table,
                                                           length))
    B, Kv, G, hd = q.shape
    n_pos = int(length.sum())
    el = 2
    nbytes = (2 * n_pos * Kv * hd * el + 2 * q.numel() * el
              + table.numel() * 4 + length.numel() * 4)
    ops = 4 * n_pos * Kv * G * hd
    bnd, by = bound_ms(nbytes, ops, "bfloat16")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:156",
            "max_abs_err": max(rows), "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": None}


def check_flash(gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K
    errs = []
    # serving-path prefill: one 16-entry bucket; edge (smollm) and cloud
    # (granite) heads, plus a ragged length the TPU kernel cannot take
    shapes = ((1, 9, 16, 64), (1, 32, 16, 128), (1, 32, 15, 128))
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for shape in shapes:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            for causal, window in ((True, 0), (True, 6), (False, 0)):
                out = K.flash_attention_cuda(q, k, v, causal=causal,
                                             window=window)
                ref = K.flash_attention_plain(q, k, v, causal=causal,
                                              window=window)
                torch.cuda.synchronize()
                err = max_err(out, ref)
                print(f"[kernel] flash_attention {str(dtype)[6:]} "
                      f"{tuple(shape)} causal={causal} window={window}: "
                      f"max_abs_err={err:.3e} (tol {tol:g})", flush=True)
                check(err <= tol, f"flash_attention {dtype} {shape} causal "
                                  f"{causal} window {window}: error {err}")
                errs.append(err)
    # timing: the cloud prefill (granite heads), bfloat16, causal
    B, H, S, hd = 1, 32, 16, 128
    q, k, v = (torch.randn((B, H, S, hd), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    ms = time_ms(lambda: K.flash_attention_cuda(q, k, v, causal=True))
    plain = time_ms(lambda: K.flash_attention_plain(q, k, v, causal=True))
    lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True))
    nbytes = 4 * B * H * S * hd * 2
    ops = 4 * B * H * hd * S * (S + 1) // 2
    bnd, by = bound_ms(nbytes, ops, "bfloat16")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:69",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib}


def _near_tie_rows(tl, dl, toks, u_acc, u_res, temperature, tol=1e-6):
    """Per group: True where the plain computation has a uniform within
    ``tol`` of an accept ratio or of a residual cdf entry."""
    import torch
    from repro_torch.kernels.spec_verify import _probs
    G, gamma, V = dl.shape
    ql = torch.cat([dl, torch.zeros((G, 1, V), device=dl.device)], 1)
    p, q = _probs(tl, temperature), _probs(ql, temperature)
    tk = torch.cat([toks.long(), torch.zeros((G, 1), dtype=torch.long,
                                             device=dl.device)], 1)
    ratio = (p.gather(2, tk[..., None])[..., 0]
             / q.gather(2, tk[..., None])[..., 0].clamp(min=1e-20)).clamp(
        max=1.0)
    bonus = (torch.arange(gamma + 1, device=dl.device) == gamma)[None, :,
                                                                  None]
    r = (p - torch.where(bonus, 0.0, 1.0) * q).clamp(min=0.0)
    tot = r.sum(-1, keepdim=True)
    r = torch.where(tot > 0, r / tot.clamp(min=1e-20), p)
    cdf = r.cumsum(-1)
    near_res = ((cdf - u_res[..., None]).abs() < tol).any(-1)
    near_acc = (ratio - u_acc).abs() < tol
    return (near_res | near_acc).any(-1)


def check_spec_verify(gen):
    import torch
    from repro_torch.kernels import spec_verify as K
    G, gamma, V = 8, 4, 49152
    R = gamma + 1
    dev = "cuda"
    worst = 0.0
    for temperature in (0.0, 1.0):
        tl = torch.randn((G, R, V), generator=gen, device=dev) * 3
        dl = torch.randn((G, gamma, V), generator=gen, device=dev) * 3
        if temperature == 0.0:
            # greedy drafts that agree with the target for the first k_g
            # positions: every n_acc from 0 to gamma occurs
            toks = dl.argmax(-1).to(torch.int32)
            for g in range(G):
                k = g % R
                toks[g, :k] = tl[g, :k].argmax(-1).to(torch.int32)
                dl[g, torch.arange(gamma), toks[g].long()] = 100.0
        else:
            toks = torch.randint(0, V, (G, gamma), generator=gen,
                                 device=dev, dtype=torch.int32)
            dl[torch.arange(G)[:, None], torch.arange(gamma)[None, :],
               toks.long()] += 4.0
            tl[:, :gamma][torch.arange(G)[:, None],
                          torch.arange(gamma)[None, :], toks.long()] += 4.0
        u = torch.rand((2, G, R), generator=gen, device=dev)
        args = (tl.contiguous(), dl.contiguous(), toks.contiguous(),
                u[0].contiguous(), u[1].contiguous())
        na, nt = K.spec_verify_cuda(*args, temperature=temperature)
        pna, pnt = K.spec_verify_plain(*args, temperature=temperature)
        torch.cuda.synchronize()
        bad = (na != pna) | (nt != pnt)
        if temperature == 0.0:
            check(not bool(bad.any()), f"spec_verify T=0: kernel "
                                       f"{na.tolist()}/{nt.tolist()} vs plain "
                                       f"{pna.tolist()}/{pnt.tolist()}")
            n_bad = 0
        else:
            near = _near_tie_rows(*args, temperature)
            check(not bool((bad & ~near).any()),
                  f"spec_verify T=1 disagrees away from near-ties: kernel "
                  f"{na.tolist()}/{nt.tolist()} vs plain "
                  f"{pna.tolist()}/{pnt.tolist()}")
            n_bad = int(bad.sum())
        print(f"[kernel] spec_verify T={temperature:g}: n_acc "
              f"{pna.tolist()}, mismatched groups {n_bad} (exact required "
              f"{'everywhere' if temperature == 0.0 else 'away from rows with |cdf-u|<1e-6'})",
              flush=True)
        worst = max(worst, float(n_bad))
    # timing at the serving path's shapes, T = 0 (the engine's setting)
    tl = torch.randn((G, R, V), generator=gen, device=dev)
    dl = torch.randn((G, gamma, V), generator=gen, device=dev)
    toks = dl.argmax(-1).to(torch.int32)
    u = torch.rand((2, G, R), generator=gen, device=dev)
    args = (tl, dl, toks, u[0].contiguous(), u[1].contiguous())
    ms = time_ms(lambda: K.spec_verify_cuda(*args, temperature=0.0))
    plain = time_ms(lambda: K.spec_verify_plain(*args, temperature=0.0))
    nbytes = (tl.numel() + dl.numel()) * 4 + toks.numel() * 4 \
        + 2 * G * R * 4 + 3 * G * R * 4
    ops = 8 * (tl.numel() + dl.numel())
    bnd, by = bound_ms(nbytes, ops, "float32")
    return {"name": "spec_verify", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spec_verify.cu",
            "replaces": "src/repro/kernels/spec_verify.py:60",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": None}


def phase_kernels():
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return [check_paged(gen), check_flash(gen), check_spec_verify(gen)]


# --------------------------------------------------------------- phase 3
def _configs(num_layers=None, dtype=None):
    from repro_torch.configs import get_config
    e, c = get_config("smollm-135m"), get_config("granite-8b")
    v = min(e.vocab_size, c.vocab_size)
    kw = {"vocab_size": v}
    if num_layers is not None:
        kw["num_layers"] = num_layers
    if dtype is not None:
        kw.update(param_dtype=dtype, activ_dtype=dtype)
    return e.replace(**kw), c.replace(**kw)


def _prompts(vocab: int, n: int = 8, length: int = 16):
    import numpy as np
    from repro_torch.data import SyntheticLM
    synth = SyntheticLM(vocab)
    rng = np.random.default_rng(0)
    return [synth.sample(rng, i % synth.n_domains, length) for i in range(n)]


def _engine(e_cfg, c_cfg, attn_backend="auto"):
    from repro_torch.core.policy import SpeculativePolicy
    from repro_torch.core.scheduler import BatchedEngine
    from repro_torch.models import Model
    return BatchedEngine(Model(e_cfg), Model(c_cfg), batch_size=8, gamma=4,
                         temperature=0.0, policy=SpeculativePolicy(0.6),
                         kv_layout="auto", attn_backend=attn_backend)


def phase_serve():
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    e_cfg, c_cfg = _configs()
    t = time.perf_counter()
    ep = Model(e_cfg).init(seed=0, device="cuda")
    cp = Model(c_cfg).init(seed=1, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in cp.parameters())
    print(f"[serve] init {e_cfg.name} + {c_cfg.name} ({n_params / 1e9:.2f}e9 "
          f"cloud params, {c_cfg.param_dtype}) in "
          f"{time.perf_counter() - t:.1f}s", flush=True)
    prompts = _prompts(e_cfg.vocab_size)
    # warm-up drain (library handles, allocator), not measured
    _engine(e_cfg, c_cfg).serve_batch(ep, cp, prompts[:2], 4)
    eng = _engine(e_cfg, c_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    traces = eng.serve_batch(ep, cp, prompts, 24)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = ops.launch_counts()
    stats = eng.stats()
    V = e_cfg.vocab_size
    for i, tr in enumerate(traces):
        check(tr.tokens is not None and len(tr.tokens) == 24,
              f"request {i}: {len(tr.tokens or [])} tokens, want 24")
        check(all(0 <= t < V for t in tr.tokens),
              f"request {i}: token outside [0, {V})")
    paths = {}
    for tr in traces:
        paths[tr.path] = paths.get(tr.path, 0) + 1
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the serving path")
    ticks = stats["ticks"]
    print(f"[serve] paths {paths}; {len(traces) / dt:.2f} req/s, "
          f"{24 * len(traces) / dt:.1f} tok/s, {dt:.2f}s; "
          f"{ticks} edge ticks at "
          f"{stats['tick_seconds'] / max(ticks, 1) * 1e3:.1f} ms/tick; "
          f"spec accept rate {stats['spec_accept_rate']:.3f}; "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches}", flush=True)
    # finiteness of the logits on the path: one more edge step and one
    # verify extend over the served tokens must give finite logits
    _check_finite(ep, cp, e_cfg, c_cfg, prompts, traces)
    phase_breakdown(ep, cp, e_cfg, c_cfg, prompts)
    del ep, cp
    torch.cuda.empty_cache()
    return launches


def _check_finite(ep, cp, e_cfg, c_cfg, prompts, traces):
    import torch
    from repro_torch.models import Model
    seq = torch.as_tensor([list(p) + tr.tokens
                           for p, tr in zip(prompts, traces)],
                          device="cuda")
    for params, cfg in ((ep, e_cfg), (cp, c_cfg)):
        logits, _ = Model(cfg).prefill(params, {"tokens": seq})
        check(bool(torch.isfinite(logits).all()),
              f"{cfg.name}: non-finite logits over the served sequences")
    print("[serve] logits finite over every served sequence", flush=True)


def _host_device_ms(fn, reps: int = 10):
    """(host ms to issue ``fn``, stream ms from a CUDA event before it to
    one after it) — medians over ``reps`` calls after one warm-up.  The
    host time is taken without a synchronise, so when the two are close
    the stream waited on the host: the call is bound by its launches, and
    the device's own busy time is less than the stream span."""
    import torch
    fn()
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        fn()
        b.record()
        host.append((time.perf_counter() - t) * 1e3)
        b.synchronize()
        dev.append(a.elapsed_time(b))
    return statistics.median(host), statistics.median(dev)


def phase_breakdown(ep, cp, e_cfg, c_cfg, prompts):
    """Where the full-width serving path's time goes: the pieces of one edge
    tick step and one speculative round, timed alone at the path's shapes,
    and a profiler pass over a whole drain for the device's busy share."""
    import torch
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    B, bs, MB, T = 8, 32, 3, 5
    dev = "cuda"
    rows = {}
    table = (torch.arange(B * MB, device=dev, dtype=torch.int32) + 1) \
        .reshape(B, MB)
    pos = torch.full((B,), 40, dtype=torch.int32, device=dev)
    for name, params, cfg in (("edge", ep, e_cfg), ("cloud", cp, c_cfg)):
        m = Model(cfg)
        cache = m.init_paged_cache(B * MB + 1, bs, B, MB, device=dev)
        cache = {**cache, "table": table, "pos": pos}
        tok = torch.ones((B, 1), dtype=torch.int32, device=dev)
        toks = torch.ones((B, T), dtype=torch.int32, device=dev)
        if name == "edge":
            rows["edge decode step (30 layers, B=8)"] = _host_device_ms(
                lambda: m.paged_decode_step(params, tok, cache))
        else:
            rows["cloud verify extend (36 layers, G=8, T=5)"] = \
                _host_device_ms(lambda: m.paged_extend_step(params, toks,
                                                            cache))
            x = torch.randn((B, T, cfg.d_model), device=dev).to(
                torch.bfloat16)
            blk = params.blocks[0]
            rows["cloud verify attention, one layer (gather + mha)"] = \
                _host_device_ms(lambda: L.paged_extend_attention(
                    blk.attn, x, cache["k"][0], cache["v"][0], table, pos,
                    cfg))
            rows["cloud f32 unembed (G=8, T=5)"] = _host_device_ms(
                lambda: L.unembed(params.head, x))
            one = torch.as_tensor(prompts[0][None, :16].astype("int32"),
                                  device=dev)
            rows["cloud prefill, one 16-token prompt"] = _host_device_ms(
                lambda: m.prefill(params, {"tokens": one}))
    for k, (h, d) in rows.items():
        print(f"[breakdown] {k}: host issue {h:.3f} ms, stream span "
              f"{d:.3f} ms", flush=True)
    # device busy share over a short drain (8 requests, 8 new tokens: one
    # edge tick and 8 speculative rounds), device activity only; the
    # profiler's own overhead lengthens the wall time, so the share is a
    # lower bound
    from torch.profiler import ProfilerActivity, profile
    eng = _engine(e_cfg, c_cfg)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.serve_batch(ep, cp, prompts, 8)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    evs = prof.key_averages()

    def self_dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(self_dev(e) for e in evs) / 1e3
    top = sorted(evs, key=self_dev, reverse=True)[:6]
    print(f"[breakdown] profiled drain: wall {wall:.0f} ms, device busy "
          f"{busy:.0f} ms ({busy / wall:.1%}); top device time: "
          + "; ".join(f"{e.key[:60]} {self_dev(e) / 1e3:.1f} ms"
                      for e in top), flush=True)


# --------------------------------------------------------------- phase 4
def phase_parity():
    import torch
    from repro_torch.models import Model
    from repro_torch.models import transformer
    e_cfg, c_cfg = _configs(num_layers=2, dtype="float32")
    ep = Model(e_cfg).init(seed=0, device="cuda")
    cp = Model(c_cfg).init(seed=1, device="cuda")
    prompts = _prompts(e_cfg.vocab_size)
    runs = {}
    for backend in ("auto", "plain"):
        runs[backend] = _engine(e_cfg, c_cfg, backend).serve_batch(
            ep, cp, prompts, 24)
    excused = 0
    for i, (a, b) in enumerate(zip(runs["auto"], runs["plain"])):
        if (a.tokens, a.path, a.edge_calls) == (b.tokens, b.path,
                                                b.edge_calls):
            continue
        check(a.path == b.path and a.tokens != b.tokens,
              f"request {i}: kernel run {a.path}/{a.edge_calls} vs plain "
              f"{b.path}/{b.edge_calls} with identical tokens")
        j = next(k for k, (x, y) in enumerate(zip(a.tokens, b.tokens))
                 if x != y)
        params, cfg = (ep, e_cfg) if b.path == "edge" else (cp, c_cfg)
        seq = torch.as_tensor([list(prompts[i]) + b.tokens[:j]],
                              device="cuda")
        logits, _ = transformer.forward(params, seq, cfg, backend="plain")
        top2 = logits[0, -1].topk(2).values
        gap = float(top2[0] - top2[1])
        print(f"[parity] request {i} diverges at token {j}: plain top-2 "
              f"gap {gap:.3e}", flush=True)
        check(gap < GAP_TOL, f"request {i}: divergence at token {j} with a "
                             f"top-2 gap {gap} >= {GAP_TOL}")
        excused += 1
    print(f"[parity] float32 2-layer full-width engine, kernels vs plain: "
          f"{len(prompts) - excused}/{len(prompts)} traces identical, "
          f"{excused} near-tie divergences", flush=True)
    del ep, cp
    torch.cuda.empty_cache()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e}); run from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        phase_build()
        kernels = phase_kernels()
        print(f"[time] build + kernel checks {time.perf_counter() - t0:.0f}s",
              flush=True)
        launches = phase_serve()
        print(f"[time] + serve and breakdown {time.perf_counter() - t0:.0f}s",
              flush=True)
        phase_parity()
        print(f"[time] + parity {time.perf_counter() - t0:.0f}s", flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for k in kernels:
        k["launches"] = launches[k["name"]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi unavailable ({smi.returncode})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
