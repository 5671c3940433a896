#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Runs from the root of a checkout, imports the port from ``src/`` (never
JAX, never the JAX package), and fails (exit code 1, no result line) on
the first phase that fails:

1. build the port's CUDA kernels from the checkout's sources (one ``nvcc``
   per source, in parallel), print the build time and the tensor-core
   instructions (``HGMMA``/``HMMA``, from ``cuobjdump -sass``) of the flash,
   tree, SSD-scan and flash-backward libraries, which must not be 0, and
   the registers and local (spill) bytes of each kernel of the two
   backward libraries (flash and SSD scan; ``cuobjdump -res-usage``);
2. hold each kernel against its plain PyTorch version at the serving
   paths' shapes, in float32 and bfloat16, with the tolerances printed, and
   time every kernel per call (CUDA events around one wrapper call, median
   of 30 runs after warm-up) and on the device alone (a CUDA graph of 20
   calls), beside its plain version and, for the attention kernels, the
   yardstick ``F.scaled_dot_product_attention`` timed in turns with it
   (paged decode: SDPA on the cache gathered beforehand, the gather not
   timed); the attention kernels also at zamba2's head dim 80 (dense
   decode timed there too), flash and tree verify also with GQA and
   through strided views; the long shapes held and timed too: a
   2048-token flash prompt, a 1024-position tree cache, 128-block paged
   tables and a dense cache of 4096 positions, and 2048-token mamba2 and
   xLSTM scans; spec verify timed at T = 0 and T = 1 and at zamba2's
   32000-entry vocabulary; the SSD scan also at each recurrent edge's
   prompt prefill, a front-padded three-chunk prompt and with carried
   random states; the per-request phase's shapes too: dense decode at
   batch 1 (smollm-135m and granite-8b heads) and tree verify at batch 1
   with the 16-node (3, 2, 1) token tree, and paged decode at
   granite-moe-1b-a400m's heads (Kv 8, G 2), and paged decode and flash
   at a model rank's heads of the ``[mesh]`` phase's granite-20b (Kv 1,
   G 24, hd 128) and olmoe-1b-7b (Kv 8, G 1) clouds, each held and
   timed; the
   flash backward (the port's own kernel, ``csrc/flash_attention_bwd.cu``)
   against autograd of the plain attention (dq, dk, dv and the forward's
   log-sum-exp against ``logsumexp`` of the plain scores, float32 and
   bfloat16, smollm-135m heads at S 64 and 256, granite-8b heads at S 128
   and 130, zamba2's hd 80 with G 1, a window, a ragged length, and a
   ``[mesh-train]`` rank's heads and rows of granite-8b, olmoe-1b-7b and
   zamba2-2.7b, also timed there), timed
   alone against SDPA's backward alone and, forward + backward, against
   SDPA's forward + backward at the training shape and at S 2048; the
   SSD-scan backward (``csrc/ssd_scan_bwd.cu``) against autograd of the
   plain scan through each caller's form of the outputs (float32 and
   bfloat16, the trainer's mamba2-370m, xlstm-125m and zamba2-2.7b shapes
   at batch 8 and seq 256, front-padded ragged lengths, 2048-token
   prompts, and a ``[mesh-train]`` rank's SSD heads and rows of
   mamba2-370m and zamba2-2.7b, whose forward is held and timed too),
   bit-identical across two runs, and timed alone against the plain
   autograd's backward alone (and, at the rank shapes, forward +
   backward through ``ops``); then the stub-input families' reads
   (``check_stub_family_shapes``): the flash forward and backward with
   ``prefix_len`` at paligemma-3b's prefill (8 heads on one kv head, hd
   256, 256 + 16 rows) and training shape (512 rows), non-causal at
   whisper-small's encoder (1500 frames) and cross attention (16 and 256
   decoder rows against 1500), and at a ``[mesh-train]`` rank's whisper
   heads (6 of 64, 4 rows: its encoder, causal decoder and cross
   attention), the dense decode at paligemma's decode
   shape and as whisper's 1500-row cross attention, the paged decode at
   paligemma's heads (also at its paged extend: one row per new token),
   and the tree verify at both families' 4-token linear extends (a causal
   block mask), each held against its plain version (float32 and
   bfloat16; each backward on its planned route and bit-identical over
   two runs) and timed against SDPA (given the same boolean mask) with
   bounds from the visible pairs;
3. serve seven paths at full width — granite-8b cloud, bfloat16, seeded
   random weights, 8 requests of 16 prompt tokens, 24 new tokens, gamma 4,
   SpeculativePolicy(0.6), T = 0: with the smollm-135m edge the default
   path (paged KV, linear lane), the tree lane (tree width 2, dense KV)
   and the self lane (paged serving, exit layer 15); with the
   granite-moe-1b-a400m edge (32 experts, top 8) and the recurrent edges
   mamba2-370m, xlstm-125m and zamba2-2.7b the linear lane (KV layout
   auto: paged for moe, dense for the recurrent edges; the moe, mamba2
   and zamba2 edges at the depth ``SERVE_DEPTH`` cuts) — and check every
   request, the logits' finiteness and that each kernel the path runs was
   launched during that path's run (counts reset just before it, read just
   after); every path's ticks (``Lane.chunk``) and rounds (linear, tree
   and self lanes, KV and recurrent states) run as CUDA graphs
   (``core/capture.py``; each path's ``graphs`` rules must read
   "captured"), and the launches count through the graphs' replays;
   after the linear path, ``[graphs]`` (``phase_graphs``): eager
   (``graphs=False``) against captured drains, float32 at cut depth
   (``PARITY_DEPTH``) on the paged linear path, the dense tick, T = 1,
   the tree and self lanes and the mamba2, xlstm and zamba2 edges (traces
   and launch counts identical, the path's kernels launched through the
   replays, a second identical drain capturing nothing), then at full
   width in turns eager, captured, captured, eager (ms per drain and
   tick, one round's host issue, stream span and device busy, the
   captures' seconds); then time the pieces of the smollm rounds and
   profile the linear and tree drains, and time one captured round of
   the moe and each recurrent path; after the smollm paths, the
   per-request phase with the
   same models: ``CollaborativeEngine.serve_reference`` (threshold -1)
   with each escalation and ``serve`` on two prompts, ``TreeSpecDecoder``
   (3, 2, 1) and ``SelfSpecDecoder`` (exit layer 15) on one, 8 new tokens
   each, its traces checked and its kernels' launches counted the same
   way; then the learning half at full width: serve-time adaptation
   (smollm-135m edge, granite-8b cloud, 3 drains of 8 new requests) with
   ``--adapt distill`` behind cloud escalation (teacher top-k captured)
   and ``--adapt lora`` on the speculative lane — at least one hot swap,
   a finite loss, a swapped tree with the serving params' names, shapes,
   dtypes and device, the backward kernel launched — and
   ``launch/train.py`` on smollm-135m (batch 8, seq 256, 30 steps; plain
   and ``--remat``), whose loss must fall and whose every backward launch
   must take the wgmma route; ``launch/train.py`` on granite-moe-1b-a400m,
   mamba2-370m, xlstm-125m and zamba2-2.7b (batch 8 — halved while it
   does not fit, the cut printed —, seq 256, 10 steps) and mamba2-370m
   with ``--remat``, then whisper-small (batch 8, seq 256) and
   paligemma-3b (batch 8, seq 512: 256 image rows + 256 text tokens),
   each loss falling and every scan and attention layer
   launching its forward and backward kernels in every step, every flash
   backward on its tensor-core route (``wgmma256`` at paligemma's hd 256,
   ``wgmma`` below it) and none on the CUDA cores; a profiled
   training step of smollm-135m, mamba2-370m and paligemma-3b; and one
   float32 train step through the kernels against
   the plain versions (2 layers, full width: smollm-135m, mamba2-370m,
   xlstm-125m); between serving and learning the stub-input families
   through the ``Model`` API at full width (bfloat16, batch 8, seeded
   random weights, random-normal stub inputs; the serving engine does not
   serve them): whisper-small (``[encdec]``: frames (8, 1500, 768)) and
   paligemma-3b (``[vlm]``: embeds (8, 256, 2048)) each prefill a
   16-token prompt, take 24 greedy decode steps and one 4-token extend,
   with ms per token, host issue against device busy, peak memory and
   exact launch counts (the flash kernel on every prefill read and the
   extend's cross attention, the dense decode kernel on every decode
   read, the tree-verify kernel on the extend's self attention under a
   causal block mask); paligemma also a text-only paged extend + 8 paged
   decode steps (the paged-decode kernel on every read) and split
   inference at k = 9 (identity bit-equal to the unsplit
   forward; an int8 boundary's wire bytes and logit error);
3c. ``[mesh]``: sharded serving on the one card — four ranks (processes,
   ``launch/mesh.spawn_ranks``) at (data 2, model 2) over gloo, the
   kernels built once above: the default path (smollm-135m edge at full
   depth, data parallel, its paged pool split per data shard and on the
   head dim over 'model'; granite-8b at full width cut to
   ``MESH_CLOUD_LAYERS`` layers, tensor parallel with FSDP; bf16, 8
   requests of 16 + 4 tokens, gamma 4, ``SpeculativePolicy(0.6)``) must
   serve every request with the same tokens on every rank, finite logits,
   the paged-decode, flash and spec-verify kernels launched on every rank,
   ``kv_shards`` 4 and ``mesh_shape`` {data 2, model 2}; it prints ms per
   tick and per round (host issue, stream span; rank 0's profiled device
   busy), the bytes each collective moved per round and the phase's
   seconds; then the tree lane (dense states: the edge's head-dim halves
   gathered every step, the cloud's kv-heads split) and the self lane on
   the same models, the granite-moe-1b-a400m edge with 4096-token
   prefills (``moe_block_sharded`` on every rank) and the mamba2-370m edge
   on data-split recurrent states (``MESH_LANES``: the linear cell's
   traffic, each launching on every rank the kernels its ``PATHS`` entry
   names, with the same tokens on every rank; ms per tick and round,
   bytes per collective per round, a rank's state bytes against the
   whole state's), the three ``MESH_EXTRA`` paths with the smollm-135m
   edge, whose escalations alternate between cloud regenerations (the
   cloud's paged decode at its local heads) and speculative rounds —
   serve-time adaptation (``--adapt distill``, 8 requests through 4
   slots, an update every 4 completions distilling the regenerations'
   teacher top-k: at least one swap, the same loop stats on every rank,
   the flash backward launched too), an olmoe-1b-7b cloud (64 experts
   over 'model') and a granite-20b cloud (48 query heads on one kv head:
   queries split, K/V whole, cache split on the head dim), both at full
   width cut to ``MESH_CLOUD_LAYERS`` layers, each with the same prints
   and checks, and a float32 run of the linear, tree, self,
   mamba2 and ``MESH_EXTRA`` paths (``PARITY_DEPTH``, full width) against
   the unsharded engine in this process — traces identical but for near
   ties (top-2 gap below 1e-4), the adaptation loop's counts equal and
   its last loss within 1e-4 relative, and a paged
   ``kv_capacity_blocks`` above the unsharded engine's;
3d. ``[mesh-train]``: sharded training on the one card — four ranks at
   (data 2, model 2) over gloo run ``launch/train.train_on_mesh`` (the
   ``train.py --mesh`` path below the mesh's construction) on granite-8b
   (heads split over 'model', FSDP over 'data'), olmoe-1b-7b (64 experts
   over 'model'), mamba2-370m (SSD heads over 'model'), xlstm-125m
   (blocks whole on every rank), zamba2-2.7b (SSD heads and the shared
   block's heads over 'model') and whisper-small (encoder, decoder and
   cross-attention heads over 'model'), each at full width cut to
   ``MESH_TRAIN_DEPTH``, bf16, batch 8, seq 256, 3 AdamW steps (2 for the
   four families beside the clouds): a finite
   loss and grad norm, the same on every rank, the flash forward and
   backward (attention) and the SSD scan's (mamba2 layers, mLSTM)
   launched on every rank; it prints ms per step (host issue, stream
   span; rank 0's profiled device busy), the bytes per collective per
   step and a rank's bytes of parameters and moments against the whole
   model's; then 2 float32 steps of each (1 for the four families beside
   the clouds) against the unsharded port's step in this process (for
   xLSTM and zamba2 the step taken over the two
   data ranks' row sets, whose grouping moves their float32 gradients on
   the card): every rank's gathered parameters within 1e-6 (absolute and
   relative; for those two, or within what the unsharded step moves
   between the batch whole and in two halves), losses and grad norms
   within 1e-5 relative;
   ``[dryrun]``: granite-8b, mamba2-370m, xlstm-125m, zamba2-2.7b and
   whisper-small x train_4k on rank 0 of the 256-rank single-pod mesh on
   the meta device (``launch/dryrun.py``), in a pool of three processes
   while the examples and parity phases run: flops, bytes and collective
   bytes per rank and the seconds each took; ``[examples]``:
   the four ``examples/torch_port`` scripts on the card, each in a fresh
   process, each exiting 0 with its invariant held;
4. serve each path again at float32, full width, cut depth (2 layers per
   model; xLSTM 4, zamba2 6 — one whole shared-attention group), plus the
   moe edge on the tree lane, the mamba2 path with chunked prefill and
   the per-request phase (self exit layer 1), once on the kernels
   (``attn_backend="auto"``) and once on the plain versions (``"plain"``);
   the traces must agree, a divergence being excused (and reported) only
   where the plain model's top-2 logit gap is below 1e-4; then whisper-small
   and paligemma-3b at float32, full width, 2 layers (and a 2-layer
   encoder): the Model-API run on the kernels against the plain versions
   teacher-forced on its tokens (logits within 1e-4) and one train step;
5. print the card's name and power limit, a ``{"kernels": [...]}`` line
   (launches summed over the seven served paths, the ``[graphs]``
   full-width drains, the per-request phase,
   the encdec and vlm paths, the two adaptation paths, the nine
   training runs and the mesh and mesh-train phases' four ranks; the flash
   backward's also per route) and last the
   result line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import collections
import itertools
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
T0 = time.perf_counter()           # the script's start, for lap()


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


def device_ms(fn, n: int = 20, reps: int = 10, stream=None) -> float:
    """Device time of one call of ``fn`` in ms, host launch cost excluded:
    ``n`` calls captured in a CUDA graph, CUDA events around each replay
    (median of ``reps`` replays after a warm-up), divided by ``n``.
    ``stream``: warm up and capture on it (an autograd backward runs on
    its forward's stream, so that forward must have run there)."""
    import torch
    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / n)
    del graph
    return statistics.median(ts)


def paired_ms(kernel, library, reps: int = 60, library_stream=None):
    """Per-call ms of ``kernel`` and ``library`` as ``time_ms`` measures
    them, but timed in turns (kernel, library, kernel, ...) so that both
    medians see the same host, and their device ms (``library``'s captured
    on ``library_stream``, see ``device_ms``)."""
    import torch
    for _ in range(5):
        kernel()
        library()
    torch.cuda.synchronize()
    ts = ([], [])
    for _ in range(reps):
        for fn, t in zip((kernel, library), ts):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            t.append(a.elapsed_time(b))
    return (statistics.median(ts[0]), device_ms(kernel),
            statistics.median(ts[1]), device_ms(library,
                                                stream=library_stream))


def bound_ms(nbytes: float, ops: float, dtype: str):
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the peak rate for the inputs' type."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def device_activity(prof):
    """(device busy ms, {kernel name: ms}) of a finished ``torch.profiler``
    run: the summed durations of its device events (kernels, copies,
    sets), read from the raw kineto results.  ``key_averages()`` first
    builds a Python event tree, which over a drain's 1e5-1e6 events takes
    tens of seconds to minutes of host time."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            by_name[e.name()] = by_name.get(e.name(), 0.0) \
                + e.duration_ns() / 1e6
    return sum(by_name.values()), by_name


def lap(label):
    """Print the seconds since the script started, after ``label``."""
    print(f"[time] {label} {time.perf_counter() - T0:.0f}s", flush=True)


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
    # the redesigned attention kernels, the flash backward and the SSD scan
    # must run their bf16 products on the tensor cores: count wgmma (HGMMA)
    # and mma.sync (HMMA) instructions
    from repro_torch.kernels.build import nvcc
    dump = Path(nvcc()).with_name("cuobjdump")
    for src in ("flash_attention.cu", "tree_verify_attention.cu",
                "ssd_scan.cu", "flash_attention_bwd.cu"):
        sass = subprocess.run([str(dump), "-sass", str(libs[src])],
                              capture_output=True, text=True, check=False)
        n_wg, n_mma = sass.stdout.count("HGMMA"), sass.stdout.count("HMMA")
        print(f"[build] {src}: {n_wg} HGMMA and {n_mma} HMMA instructions "
              f"(cuobjdump -sass)", flush=True)
        check(n_wg + n_mma > 0, f"{src}: no tensor-core instruction in its "
                                f"SASS (cuobjdump rc {sass.returncode})")
    # registers and local (spill) bytes of each backward kernel
    def demangle(names):
        filt = subprocess.run([str(dump.with_name("cu++filt"))],
                              input="\n".join(names), capture_output=True,
                              text=True, check=False)
        out = filt.stdout.splitlines()
        return out if len(out) == len(names) else names

    for src in ("flash_attention_bwd.cu", "ssd_scan_bwd.cu"):
        res = subprocess.run([str(dump), "-res-usage", str(libs[src])],
                             capture_output=True, text=True, check=False)
        for name, usage in _res_usage(res.stdout, demangle):
            print(f"[build] {src} {name}: {usage} (cuobjdump -res-usage)",
                  flush=True)


def _res_usage(text, demangle):
    """(kernel, "REG:n STACK:n SHARED:n LOCAL:n") pairs from ``cuobjdump
    -res-usage``, each name demangled (``demangle``: list of mangled names
    -> list of names) and cut to the kernel and its template arguments
    (``grads_tc_kernel<128>``)."""
    import re
    pairs, name = [], None
    for line in text.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
        elif name and "REG:" in line:
            pairs.append((name, " ".join(
                f for f in line.split()
                if f.split(":")[0] in ("REG", "STACK", "SHARED", "LOCAL"))))
            name = None
    out = []
    for full, (_, usage) in zip(demangle([n for n, _ in pairs]), pairs):
        k = re.search(r"\w+_kernel(<[^>]*>)?", full)
        out.append((k.group(0) if k else full, usage))
    return out


# --------------------------------------------------------------- phase 2
def _paged_inputs(dtype, gen, hd=64, MB=3, lengths=(15, 46), Kv=3, G=3):
    """Serving-path shapes of the paged decode: 8 slots, smollm-135m heads
    (Kv 3, G 3, hd 64), 32-token blocks, 3-block tables (slot_len 80),
    lengths 15-45; ``hd`` 80 checks a head dim that is not a multiple of
    32; ``MB`` and ``lengths`` make the long case; ``Kv`` and ``G`` other
    heads (granite-moe-1b-a400m: Kv 8, G 2)."""
    import torch
    B, bs = 8, 32
    NB = B * MB + 1
    dev = "cuda"
    q = torch.randn((B, Kv, G, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((NB, bs, Kv, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((NB, bs, Kv, hd), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(NB - 1, generator=gen, device=dev) + 1
    table = perm.reshape(B, MB).to(torch.int32).contiguous()
    length = torch.randint(*lengths, (B,), generator=gen, device=dev,
                           dtype=torch.int32)
    return q, kp, vp, table, length


# the long paged case: the serving heads over 128-block tables (4096
# positions), lengths 3968-4096 — the kernel splits the key range
PAGED_LONG = (128, (3968, 4097))
# the moe path's edge ticks: granite-moe-1b-a400m heads (Kv 8, G 2, hd 64)
PAGED_MOE = dict(MB=3, lengths=(15, 46), Kv=8, G=2)
# a model rank's attention heads (arch, Kv, G; hd 128) of the [mesh]
# phase's other clouds at model 2: granite-20b's 24 query heads on its one
# kv head (the K/V whole on every rank), olmoe-1b-7b's 8 query and 8 kv
# heads; paged decode (3-block tables) and flash (16-token prefills) are
# held and timed at both
MESH_LOCAL_HEADS = (("granite-20b", 1, 24), ("olmoe-1b-7b", 8, 1))


def paged_timing(K, gen, MB=3, lengths=(15, 46), Kv=3, G=3, hd=64):
    """Kernel, plain and yardstick times of the bf16 paged decode (no
    window), per call and on the device, with the bound.  The yardstick is
    SDPA on the cache gathered through the table beforehand (contiguous,
    GQA expanded, boolean length mask): the gather is not timed, so it is
    not a PyTorch call computing the paged read itself."""
    import torch
    import torch.nn.functional as F
    q, kp, vp, table, length = _paged_inputs(torch.bfloat16, gen, hd, MB,
                                             lengths, Kv, G)
    B, Kv, G, hd = q.shape
    bs = kp.shape[1]
    kk = kp[table.long()].reshape(B, MB * bs, Kv, hd).permute(0, 2, 1, 3)
    vv = vp[table.long()].reshape(B, MB * bs, Kv, hd).permute(0, 2, 1, 3)
    visible = (torch.arange(MB * bs, device="cuda")[None, :]
               < length.long()[:, None])[:, None, :]            # (B, 1, S)
    qq, kk, vv, m = _gqa_sdpa_inputs(q[:, :, :, None], kk, vv, visible)
    ms, dev, lib, lib_dev = paired_ms(
        lambda: K.paged_decode_attention_cuda(q, kp, vp, table, length),
        lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=m))
    plain = time_ms(lambda: K.paged_decode_attention_plain(q, kp, vp, table,
                                                           length))
    n_pos = int(length.sum())
    el = 2
    nbytes = (2 * n_pos * Kv * hd * el + 2 * q.numel() * el
              + table.numel() * 4 + length.numel() * 4)
    ops = 4 * n_pos * Kv * G * hd
    bnd, by = bound_ms(nbytes, ops, "bfloat16")
    print(f"[kernel] paged_decode_attention timing (B,Kv,G,hd,bs,MB)="
          f"{(B, Kv, G, hd, bs, MB)} lengths {lengths[0]}-{lengths[1] - 1} "
          f"bfloat16: {ms:.4f} ms per call, {dev:.5f} ms on the device; SDPA "
          f"on the gathered cache {lib:.4f} / {lib_dev:.5f} ms; plain "
          f"{plain:.4f} ms; bound {bnd:.6f} ms ({by})", flush=True)
    return {"ms": ms, "device_ms": dev, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "sdpa_gathered_ms": lib,
            "sdpa_gathered_device_ms": lib_dev}


def check_paged(gen):
    """Paged decode against its plain version at the serving shape (head
    dims 64 and 80), the moe path's heads, the long shape and the mesh
    clouds' local heads, float32 and bfloat16, windows 0 and 24; then
    timed at the serving, long, moe and local-head shapes in bfloat16."""
    import torch
    from repro_torch.kernels import decode_attention as K
    rows = []
    cases = [(hd, 3, (15, 46), 3, 3) for hd in (64, 80)] + \
        [(64, *PAGED_LONG, 3, 3), (64, *PAGED_MOE.values())] + \
        [(128, 3, (15, 46), kv, g) for _, kv, g in MESH_LOCAL_HEADS]
    for (dtype, tol), (hd, MB, lengths, Kv, G) in itertools.product(
            ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)), cases):
        q, kp, vp, table, length = _paged_inputs(dtype, gen, hd, MB, lengths,
                                                 Kv, G)
        for window in (0, 24):
            out = K.paged_decode_attention_cuda(q, kp, vp, table, length,
                                                window=window)
            ref = K.paged_decode_attention_plain(q, kp, vp, table, length,
                                                 window=window)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            print(f"[kernel] paged_decode_attention {str(dtype)[6:]} hd={hd} "
                  f"Kv={Kv} G={G} MB={MB} window={window}: "
                  f"max_abs_err={err:.3e} "
                  f"(tol {tol:g})", flush=True)
            check(err <= tol, f"paged_decode_attention {dtype} hd {hd} MB "
                              f"{MB} window {window}: error {err} > {tol}")
            rows.append(err)
    row = {"name": "paged_decode_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
           "replaces": "src/repro/kernels/decode_attention.py:156",
           "max_abs_err": max(rows), "library_ms": None}
    row.update(paged_timing(K, gen))
    row["long"] = {"shape": "(B,Kv,G,hd,bs,MB)=(8, 3, 3, 64, 32, "
                            f"{PAGED_LONG[0]})",
                   **paged_timing(K, gen, *PAGED_LONG)}
    row["moe"] = {"shape": "(B,Kv,G,hd,bs,MB)=(8, 8, 2, 64, 32, 3)",
                  **paged_timing(K, gen, **PAGED_MOE)}
    for arch, kv, g in MESH_LOCAL_HEADS:
        row[f"{arch} local"] = {
            "shape": f"(B,Kv,G,hd,bs,MB)=(8, {kv}, {g}, 128, 32, 3)",
            **paged_timing(K, gen, Kv=kv, G=g, hd=128)}
    return row


def _proj_view(shape, dtype, gen):
    """A (B, heads, S, hd) view of a projection stored (B, S, heads, hd),
    as the prefill attention hands it to the flash kernel."""
    import torch
    B, n, S, hd = shape
    x = torch.randn((B, S, n, hd), generator=gen, device="cuda")
    return x.to(dtype).transpose(1, 2)


# flash shapes (B, H, Kv, S, hd): the serving paths' prefills — smollm-135m
# and granite-8b heads over one 16-entry bucket, a ragged 15-token prompt,
# zamba2's shared attention (Kv = H, head dim 80) — and one long granite
# prompt; the second and the last are timed
FLASH_SERVING = ((1, 9, 3, 16, 64), (1, 32, 8, 16, 128), (1, 32, 8, 15, 128),
                 (1, 32, 32, 15, 80))
FLASH_LONG = (1, 32, 8, 2048, 128)


def _flash_timing(K, shape, gen):
    """Kernel, plain and SDPA times of one causal bf16 flash call at
    ``shape``, per call and on the device, with the bound."""
    import torch
    import torch.nn.functional as F
    B, H, Kv, S, hd = shape
    q = _proj_view((B, H, S, hd), torch.bfloat16, gen)
    k, v = (_proj_view((B, Kv, S, hd), torch.bfloat16, gen)
            for _ in range(2))
    # the library yardstick on the kernel's own inputs, GQA resolved by it
    ms, dev, lib, lib_dev = paired_ms(
        lambda: K.flash_attention_cuda(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True))
    plain = time_ms(lambda: K.flash_attention_plain(q, k, v, causal=True),
                    reps=10 if S > 1024 else 30)
    nbytes = 2 * (2 * B * H * S * hd + 2 * B * Kv * S * hd)
    ops = 4 * B * H * hd * S * (S + 1) // 2
    bnd, by = bound_ms(nbytes, ops, "bfloat16")
    print(f"[kernel] flash_attention timing (B,H,Kv,S,hd)={shape} bfloat16 "
          f"causal: {ms:.4f} ms per call, {dev:.4f} ms on the device; SDPA "
          f"{lib:.4f} / {lib_dev:.4f} ms; plain {plain:.4f} ms; bound "
          f"{bnd:.6f} ms ({by})", flush=True)
    return {"ms": ms, "device_ms": dev, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "library_ms": lib, "library_device_ms": lib_dev}


def check_flash(gen):
    """Flash prefill against its plain version: q, k, v as strided views
    of (B, S, heads, hd) projections, GQA resolved in the kernel, causal,
    windowed and full, float32 and bfloat16, at the serving shapes and one
    long prompt, and the mesh clouds' local heads; then timed at
    granite-8b's 16-token prefill, the long prompt and the local heads."""
    import torch
    from repro_torch.kernels import flash_attention as K
    errs = []
    local = [(1, kv * g, kv, 16, 128) for _, kv, g in MESH_LOCAL_HEADS]
    cases = [(sh, m) for sh in FLASH_SERVING + tuple(local)
             for m in ((True, 0), (True, 6), (False, 0))] + \
        [(FLASH_LONG, m) for m in ((True, 0), (True, 256))]
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for (B, H, Kv, S, hd), (causal, window) in cases:
            q = _proj_view((B, H, S, hd), dtype, gen)
            k, v = (_proj_view((B, Kv, S, hd), dtype, gen) for _ in range(2))
            out = K.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window)
            ref = K.flash_attention_plain(q, k, v, causal=causal,
                                          window=window)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            print(f"[kernel] flash_attention {str(dtype)[6:]} (B,H,Kv,S,hd)="
                  f"{(B, H, Kv, S, hd)} causal={causal} window={window}: "
                  f"max_abs_err={err:.3e} (tol {tol:g})", flush=True)
            check(err <= tol, f"flash_attention {dtype} {(B, H, Kv, S, hd)} "
                              f"causal {causal} window {window}: error {err}")
            errs.append(err)
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:69",
           "max_abs_err": max(errs)}
    row.update(_flash_timing(K, FLASH_SERVING[1], gen))
    row["long"] = {"shape": "(B,H,Kv,S,hd)=" + str(FLASH_LONG),
                   **_flash_timing(K, FLASH_LONG, gen)}
    for (arch, _, _), shape in zip(MESH_LOCAL_HEADS, local):
        row[f"{arch} local"] = {"shape": "(B,H,Kv,S,hd)=" + str(shape),
                                **_flash_timing(K, shape, gen)}
    return row


# flash backward cases (B, H, Kv, S, hd, window), all causal: smollm-135m
# heads at S 64 and at the training shape S 256, granite-8b heads (also at
# a ragged 130, whose packed rows straddle the tiles), zamba2's head dim 80
# with G 1, a window, a ragged length; the training shape and
# granite-8b heads at S 2048 are timed.  Tolerance on max |kernel - plain|
# over dq, dk, dv: BWD_TOL times max(1, max |plain|); the LSE against
# logsumexp of the plain scores: 1e-5 float32, 1e-3 bfloat16 (the tile's
# 2-ulp exp2), times max(1, max |LSE|)
FLASH_BWD_CASES = ((8, 9, 3, 64, 64, 0), (8, 9, 3, 256, 64, 0),
                   (2, 32, 8, 128, 128, 0), (2, 32, 32, 64, 80, 0),
                   (8, 9, 3, 256, 64, 64), (4, 9, 3, 100, 64, 0),
                   (2, 32, 8, 130, 128, 0))
FLASH_BWD_TRAIN = (8, 9, 3, 256, 64)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _attn_grads(fn, q, k, v, dout, causal=True, **kw):
    """(dq, dk, dv) of ``fn(q, k, v, causal=causal, **kw)`` for ``dout``."""
    import torch
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v, causal=causal, **kw)
    return torch.autograd.grad(out, (q, k, v), dout)


def _lse_ref(q, k, window):
    import torch
    S, hd = q.shape[2], q.shape[3]
    kk = k.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / hd ** 0.5
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = j <= i
    if window:
        mask = mask & (j > i - window)
    return torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)


def _flash_bwd_timing(K, shape, gen):
    """The backward kernel alone (on the forward's saved output and LSE)
    against SDPA's backward alone (``torch.autograd.grad`` of one SDPA
    forward, its graph retained), in turns, per call and on the device;
    forward + backward of the kernels (autograd through ``FlashAttention``)
    against SDPA forward + backward on the same inputs, in turns; bf16,
    causal; bounds of both."""
    import torch
    import torch.nn.functional as F
    B, H, Kv, S, hd = shape
    bf = torch.bfloat16
    q = _proj_view((B, H, S, hd), bf, gen)
    k, v = (_proj_view((B, Kv, S, hd), bf, gen) for _ in range(2))
    dout = _proj_view((B, H, S, hd), bf, gen)
    with torch.no_grad():
        out, lse = K.flash_attention_cuda(q, k, v, causal=True,
                                          return_lse=True)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    # SDPA's forward on the stream its backward is captured on
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        o_sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                                enable_gqa=True)
    torch.cuda.current_stream().wait_stream(side)
    ms, dev, lib, lib_dev = paired_ms(
        lambda: K.flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                           causal=True),
        lambda: torch.autograd.grad(o_sdpa, (qg, kg, vg), dout,
                                    retain_graph=True),
        library_stream=side)
    del o_sdpa

    def fwd_bwd():
        o = K.flash_attention_kernel(qg, kg, vg, causal=True)
        return torch.autograd.grad(o, (qg, kg, vg), dout)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                           enable_gqa=True)
        return torch.autograd.grad(o, (qg, kg, vg), dout)

    fb, fb_dev, fb_lib, fb_lib_dev = paired_ms(fwd_bwd, sdpa_fwd_bwd)
    plain = time_ms(lambda: _attn_grads(K.flash_attention_plain, q, k, v,
                                        dout), reps=5 if S > 1024 else 20)
    pairs = B * H * S * (S + 1) // 2          # visible (query, key) pairs
    nb = 2 * (4 * B * H * S * hd + 4 * B * Kv * S * hd) + 4 * B * H * S
    bnd, by = bound_ms(nb, 5 * 2 * pairs * hd, "bfloat16")
    fb_bnd, fb_by = bound_ms(2 * (4 * B * H * S * hd + 4 * B * Kv * S * hd),
                             7 * 2 * pairs * hd, "bfloat16")
    print(f"[kernel] flash_attention_bwd timing (B,H,Kv,S,hd)={shape} "
          f"bfloat16 causal: backward {ms:.4f} ms per call, {dev:.4f} ms on "
          f"the device, SDPA backward {lib:.4f} / {lib_dev:.4f} ms, bound "
          f"{bnd:.6f} ms ({by}); forward + backward {fb:.4f} / "
          f"{fb_dev:.4f} ms, SDPA forward + backward {fb_lib:.4f} / "
          f"{fb_lib_dev:.4f} ms, bound {fb_bnd:.6f} ms ({fb_by}); plain "
          f"forward + backward {plain:.4f} ms", flush=True)
    return {"ms": ms, "device_ms": dev, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "library_ms": lib, "library_device_ms": lib_dev,
            "fwd_bwd_ms": fb, "fwd_bwd_device_ms": fb_dev,
            "sdpa_fwd_bwd_ms": fb_lib, "sdpa_fwd_bwd_device_ms": fb_lib_dev,
            "fwd_bwd_bound_ms": fb_bnd}


def check_flash_bwd(gen):
    """The backward kernel (through ``ops.flash_attention`` under grad:
    the forward kernel with its LSE, then the backward kernel) against
    autograd of the plain version, float32 and bfloat16, on strided views;
    the LSE of both forward paths; then timed at the training shape, at
    S 2048 and at a rank's shapes of ``[mesh-train]`` against SDPA."""
    import torch
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ops
    errs = []
    cases = FLASH_BWD_CASES + tuple(sh + (0,) for _, sh in MESH_TRAIN_FLASH)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for B, H, Kv, S, hd, window in cases:
            q = _proj_view((B, H, S, hd), dtype, gen)
            k, v = (_proj_view((B, Kv, S, hd), dtype, gen) for _ in range(2))
            dout = _proj_view((B, H, S, hd), dtype, gen)
            got = _attn_grads(ops.flash_attention, q, k, v, dout,
                              window=window)
            ref = _attn_grads(K.flash_attention_plain, q, k, v, dout,
                              window=window)
            with torch.no_grad():
                _, lse = K.flash_attention_cuda(q, k, v, causal=True,
                                                window=window,
                                                return_lse=True)
            lref = _lse_ref(q, k, window)
            torch.cuda.synchronize()
            err = max(max_err(a, b) for a, b in zip(got, ref))
            scale = max(1.0, max(float(r.float().abs().max()) for r in ref))
            lerr = max_err(lse, lref)
            lscale = max(1.0, float(lref.abs().max()))
            print(f"[kernel] flash_attention_bwd {name} (B,H,Kv,S,hd)="
                  f"{(B, H, Kv, S, hd)} window={window}: max_abs_err "
                  f"{err:.3e} (tol {BWD_TOL[name]:g} x {scale:.2f}); LSE "
                  f"{lerr:.3e} (tol {LSE_TOL[name]:g} x {lscale:.2f})",
                  flush=True)
            check(err <= BWD_TOL[name] * scale,
                  f"flash_attention_bwd {name} {(B, H, Kv, S, hd)} window "
                  f"{window}: error {err}")
            check(lerr <= LSE_TOL[name] * lscale,
                  f"flash LSE {name} {(B, H, Kv, S, hd)}: error {lerr}")
            errs.append(err)
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/models/layers.py:192 (the gradient of "
                       "attention_block's jnp attention; no TPU kernel)",
           "max_abs_err": max(errs)}
    row.update(_flash_bwd_timing(K, FLASH_BWD_TRAIN, gen))
    row["long"] = {"shape": "(B,H,Kv,S,hd)=" + str(FLASH_LONG),
                   **_flash_bwd_timing(K, FLASH_LONG, gen)}
    for arch, shape in MESH_TRAIN_FLASH:
        row[f"{arch} train local"] = {"shape": "(B,H,Kv,S,hd)=" + str(shape),
                                      **_flash_bwd_timing(K, shape, gen)}
    return row


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
    row = {"name": "spec_verify", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/spec_verify.cu",
           "replaces": "src/repro/kernels/spec_verify.py:60",
           "max_abs_err": worst, "library_ms": None}
    row.update(spec_timing(K, gen))
    for key, V, temperature in SPEC_MORE:
        row[key] = spec_timing(K, gen, V, temperature)
    return row


# more spec-verify timings: T = 1 at the serving shape, and the hybrid
# path's 32000-entry vocabulary
SPEC_MORE = (("t1", 49152, 1.0), ("v32000", 32000, 0.0))


def spec_timing(K, gen, V=49152, temperature=0.0):
    """Kernel and plain time of spec verify at the serving shape (8 groups,
    gamma 4, granite's 49152-entry vocabulary, or ``V``), at T = 0 (the
    engine's setting) or ``temperature``, per call and on the device, with
    the bound: the logits, tokens and uniforms read once and (n_acc,
    next_token) written once."""
    import torch
    G, gamma = 8, 4
    R = gamma + 1
    dev = "cuda"
    tl = torch.randn((G, R, V), generator=gen, device=dev)
    dl = torch.randn((G, gamma, V), generator=gen, device=dev)
    toks = dl.argmax(-1).to(torch.int32)
    u = torch.rand((2, G, R), generator=gen, device=dev)
    args = (tl, dl, toks, u[0].contiguous(), u[1].contiguous())
    fn = lambda: K.spec_verify_cuda(*args, temperature=temperature)  # noqa: E731
    ms, dev_ms = time_ms(fn), device_ms(fn)
    plain = time_ms(lambda: K.spec_verify_plain(*args,
                                                temperature=temperature))
    nbytes = (tl.numel() + dl.numel()) * 4 + toks.numel() * 4 \
        + 2 * G * R * 4 + 2 * G * 4
    ops = 8 * (tl.numel() + dl.numel())
    bnd, by = bound_ms(nbytes, ops, "float32")
    print(f"[kernel] spec_verify timing (G,gamma,V)={(G, gamma, V)} "
          f"T={temperature:g}: {ms:.4f} ms per call, {dev_ms:.5f} ms on the "
          f"device; plain {plain:.4f} ms; bound {bnd:.6f} ms ({by})",
          flush=True)
    return {"shape": f"(G,gamma,V)={(G, gamma, V)} T={temperature:g}",
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by}


def _gqa_sdpa_inputs(q, k, v, visible):
    """The library yardstick's inputs, built before it is timed: queries
    (B, H, Nq, hd), K/V expanded over the GQA groups (B, H, S, hd) and the
    boolean mask (B, 1, Nq, S) of ``visible``."""
    B, Kv, G = q.shape[:3]
    hd = q.shape[-1]
    qq = q.reshape(B, Kv * G, -1, hd)
    kk = k.repeat_interleave(G, dim=1).contiguous()
    vv = v.repeat_interleave(G, dim=1).contiguous()
    return qq, kk, vv, visible[:, None].contiguous()


def _dense_view(shape, dtype, gen):
    """A (B, Kv, S, hd) view of a cache stored (B, S, Kv, hd), as the
    serving path hands it to the kernels."""
    import torch
    B, Kv, S, hd = shape
    x = torch.randn((B, S, Kv, hd), generator=gen, device="cuda")
    return x.to(dtype).permute(0, 2, 1, 3)


def check_decode(gen):
    """Dense decode at the edge ticks of the tree path (8 slots, smollm-135m
    heads: Kv 3, G 3, hd 64) and of the hybrid path (zamba2-2.7b's shared
    attention: Kv 32, G 1, hd 80), slot_len 80 (16 + 24 + 2 * 16 + 8),
    lengths 15-40, over a 4096-position cache (lengths 3968-4096, which the
    kernel splits), and at batch 1 with the per-request phase's heads
    (smollm-135m and granite-8b: Kv 8, G 4, hd 128) over its 64-entry
    caches; the cache read through strides as it lies.  Timed at the tree
    path's shape, then at the hybrid, long and batch-1 ones."""
    import torch
    from repro_torch.kernels import decode_attention as K
    errs = []
    for (dtype, tol), (Kv, G, hd, S, lengths, B) in itertools.product(
            ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)),
            ((32, 1, 80, 80, (15, 41), 8), (3, 3, 64, 80, (15, 41), 8),
             (3, 3, 64, 4096, (3968, 4097), 8)) + DECODE_B1):
        q = torch.randn((B, Kv, G, hd), generator=gen, device="cuda") \
            .to(dtype)
        k = _dense_view((B, Kv, S, hd), dtype, gen)
        v = _dense_view((B, Kv, S, hd), dtype, gen)
        length = torch.randint(*lengths, (B,), generator=gen, device="cuda",
                               dtype=torch.int32)
        for window in (0, 24):
            out = K.decode_attention_cuda(q, k, v, length, window=window)
            ref = K.decode_attention_plain(q, k, v, length, window=window)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            print(f"[kernel] decode_attention {str(dtype)[6:]} (B,Kv,G,hd,S)="
                  f"{(B, Kv, G, hd, S)} window={window}: "
                  f"max_abs_err={err:.3e} (tol {tol:g})", flush=True)
            check(err <= tol, f"decode_attention {dtype} window {window}: "
                              f"error {err} > {tol}")
            errs.append(err)
    row = {"name": "decode_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
           "replaces": "src/repro/kernels/decode_attention.py:76",
           "max_abs_err": max(errs)}
    row.update(decode_timing(K, gen))
    for key, shape in DECODE_MORE:
        row[key] = decode_timing(K, gen, *shape)
    for key, shape in zip(("b1_edge", "b1_cloud"), DECODE_B1):
        row[key] = decode_timing(K, gen, *shape)
    return row


# more dense-decode timings, (Kv, G, hd, S, lengths): the hybrid path's
# shared attention (zamba2-2.7b: Kv 32, G 1, hd 80) and a 4096-position
# cache with the tree path's heads, which the kernel splits
DECODE_MORE = (("hybrid", (32, 1, 80, 80, (15, 41))),
               ("long", (3, 3, 64, 4096, (3968, 4097))))
# the per-request phase's batch-1 steps, (Kv, G, hd, S, lengths, B): the
# smollm-135m edge and the granite-8b cloud over a 64-entry cache (a
# SpecDecoder's max_seq for 16-token prompts and 8 new tokens)
DECODE_B1 = ((3, 3, 64, 64, (15, 33), 1), (8, 4, 128, 64, (15, 33), 1))


def decode_timing(K, gen, Kv=3, G=3, hd=64, S=80, lengths=(15, 41), B=8):
    """Kernel, plain and SDPA times of the dense decode at the tree path's
    edge ticks (8 slots, smollm-135m heads, S 80, lengths 15-40, bf16, no
    window; or the heads, cache, lengths and batch given), per call
    (kernel and SDPA in turns) and on the device; SDPA over GQA-expanded
    K/V with the same boolean mask."""
    import torch
    import torch.nn.functional as F
    q = torch.randn((B, Kv, G, hd), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    k = _dense_view((B, Kv, S, hd), torch.bfloat16, gen)
    v = _dense_view((B, Kv, S, hd), torch.bfloat16, gen)
    length = torch.randint(*lengths, (B,), generator=gen, device="cuda",
                           dtype=torch.int32)
    visible = (torch.arange(S, device="cuda")[None, :]
               < length.long()[:, None])[:, None, :]          # (B, 1, S)
    qq, kk, vv, m = _gqa_sdpa_inputs(q[:, :, :, None], k, v, visible)
    ms, dev, lib, lib_dev = paired_ms(
        lambda: K.decode_attention_cuda(q, k, v, length),
        lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=m))
    plain = time_ms(lambda: K.decode_attention_plain(q, k, v, length))
    n_pos = int(length.clamp(max=S).sum())
    el = 2
    nbytes = (2 * n_pos * Kv * hd * el + 2 * q.numel() * el
              + length.numel() * 4)
    ops = 4 * n_pos * Kv * G * hd
    bnd, by = bound_ms(nbytes, ops, "bfloat16")
    print(f"[kernel] decode_attention timing (B,Kv,G,S,hd)="
          f"{(B, Kv, G, S, hd)} bfloat16: {ms:.4f} ms per call, {dev:.5f} ms "
          f"on the device; SDPA {lib:.4f} / {lib_dev:.5f} ms; plain "
          f"{plain:.4f} ms; bound {bnd:.6f} ms ({by})", flush=True)
    return {"shape": f"(B,Kv,G,S,hd)={(B, Kv, G, S, hd)}", "ms": ms,
            "device_ms": dev, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "library_ms": lib, "library_device_ms": lib_dev}


def _token_tree():
    """(ancestor mask, depths) of the per-request phase's tree: the
    16-node ``TokenTree`` of branching (3, 2, 1), nodes in the order
    ``build_tree`` appends them."""
    import numpy as np
    from repro_torch.core.tree_speculation import TokenTree
    parent = [-1] + [0] * 3 + [1 + i // 2 for i in range(6)] + \
        [4 + i for i in range(6)]
    tree = TokenTree(np.zeros(16, np.int32), np.asarray(parent, np.int32),
                     np.zeros((16, 1), np.float32))
    return tree.attention_mask(), tree.depths()


# the per-request tree verify: granite-8b heads at batch 1 over the
# 176-entry cache of a TreeSpecDecoder (16 + 8 + 9 * 16 + 8), tree base
# 15-39
TREE_B1 = (1, 8, 4, 176, 128)


def _tree_inputs(B, Kv, G, S, hd, lo, hi, dtype, gen, base=(16, 40),
                 tree=None):
    """Tree-verify inputs at one span of the 2-wide depth-4 plan (or of
    ``tree`` = (mask, depths)): queries for nodes [lo, hi), mask columns
    [0, hi), tree base drawn from ``base`` per slot (16-39: the prompt
    plus some decoded tokens), cache stored (B, S, Kv, hd)."""
    import torch
    from repro_torch.core.tree_speculation import TreePlan, branching_for
    if tree is None:
        plan = TreePlan(branching_for(2, 4))
        tree = (plan.mask, plan.depths)
    T = hi - lo
    q = torch.randn((B, T, Kv, G, hd), generator=gen, device="cuda") \
        .to(dtype).permute(0, 2, 3, 1, 4)
    k = _dense_view((B, Kv, S, hd), dtype, gen)
    v = _dense_view((B, Kv, S, hd), dtype, gen)
    base = torch.randint(*base, (B,), generator=gen, device="cuda",
                         dtype=torch.int32)
    mask = torch.as_tensor(tree[0][lo:hi, :hi], device="cuda").contiguous()
    depths = torch.as_tensor(tree[1][lo:hi], device="cuda")
    q_pos = (base[:, None] + depths).to(torch.int32).contiguous()
    return q, k, v, (base + lo).contiguous(), mask, q_pos


def _tree_visible(length, mask, S):
    """(B, N, S) bool: which keys each node sees (no window)."""
    import torch
    N, C = mask.shape
    base = length.long() - (C - N)
    k_pos = torch.arange(S, device=length.device)
    t = k_pos[None, :] - base[:, None]
    cols = mask[:, t.clamp(0, C - 1)].movedim(1, 0)
    return (k_pos[None, :] < base[:, None])[:, None, :] | (
        ((t >= 0) & (t < C))[:, None, :] & cols)


# the long tree case: 8 slots of granite-8b heads over a 1024-position
# cache whose tree starts at 984-1007 (the kernel splits the key range)
TREE_LONG_S, TREE_LONG_BASE = 1024, (984, 1008)


def _tree_timing(K, S, base, gen, B=8, tree=None, heads=(8, 4, 128)):
    """Kernel, plain and SDPA times of the cloud's one-shot verify (granite
    heads (Kv, G, hd), or ``heads``, bf16) of B slots over an S-position
    cache, per call and on the device; the 2-wide depth-4 plan, or
    ``tree`` = (mask, depths)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.tree_speculation import TreePlan, branching_for
    if tree is None:
        plan = TreePlan(branching_for(2, 4))
        tree = (plan.mask, plan.depths)
    Kv, G, hd = heads
    q, k, v, length, mask, q_pos = _tree_inputs(B, Kv, G, S, hd, 0,
                                                len(tree[1]), torch.bfloat16,
                                                gen, base, tree)
    visible = _tree_visible(length, mask, S)                  # (B, N, S)
    qq, kk, vv, m = _gqa_sdpa_inputs(q.contiguous(), k, v, visible)
    ms, dev, lib, lib_dev = paired_ms(
        lambda: K.tree_verify_attention_cuda(q, k, v, length, mask, q_pos),
        lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=m))
    plain = time_ms(lambda: K.tree_verify_attention_plain(q, k, v, length,
                                                          mask, q_pos))
    N, C = mask.shape
    el = 2
    rows_read = int((length.long() - (C - N) + C).clamp(max=S).sum())
    nbytes = (2 * rows_read * Kv * hd * el + 2 * q.numel() * el
              + mask.numel() + q_pos.numel() * 4 + length.numel() * 4)
    ops = 4 * int(visible.sum()) * Kv * G * hd
    bnd, by = bound_ms(nbytes, ops, "bfloat16")
    print(f"[kernel] tree_verify_attention timing (B,Kv,G,N,S,hd)="
          f"{(B, Kv, G, N, S, hd)} bfloat16: {ms:.4f} ms per call, "
          f"{dev:.4f} ms on the device; SDPA {lib:.4f} / {lib_dev:.4f} ms; "
          f"plain {plain:.4f} ms; bound {bnd:.6f} ms ({by})", flush=True)
    return {"ms": ms, "device_ms": dev, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "library_ms": lib, "library_device_ms": lib_dev}


def check_tree(gen):
    """Tree verify at the tree path's shapes: 8 slots, the 2-wide depth-4
    plan (16 padded nodes), slot_len 80; the edge's incremental draft
    levels (smollm-135m heads, Kv 3, G 3, hd 64) and both models' one-shot
    verify (granite-8b heads, Kv 8, G 4, hd 128); and a long cache
    (S 1024, granite heads, a draft level and the one-shot verify), where
    the key range is split across blocks; and at batch 1 the per-request
    phase's 16-node (3, 2, 1) token tree (granite-8b and smollm-135m
    heads, S 176).  Timed at the serving one-shot verify, the long one and
    the batch-1 one."""
    import torch
    from repro_torch.core.tree_speculation import TreePlan, branching_for
    from repro_torch.kernels import tree_attention as K
    plan = TreePlan(branching_for(2, 4))
    S = 80
    spans = [(0, 1)] + list(plan.levels)
    cases = [((8, 3, 3, S, 64), a, b, (16, 40)) for a, b in spans] + \
        [((8, 3, 3, S, 64), 0, plan.n_pad, (16, 40)),
         ((8, 4, 2, S, 80), 0, plan.n_pad, (16, 40)),
         ((8, 8, 4, S, 128), 0, plan.n_pad, (16, 40))] + \
        [((8, 8, 4, TREE_LONG_S, 128), a, b, TREE_LONG_BASE)
         for a, b in (plan.levels[-1], (0, plan.n_pad))]
    token_tree = _token_tree()
    b1 = [(TREE_B1, 0, 16, (15, 40), token_tree),
          ((1, 3, 3, 176, 64), 0, 16, (15, 40), token_tree)]
    errs = []
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for shape, lo, hi, base, tree in [c + (None,) for c in cases] + b1:
            args = _tree_inputs(*shape, lo, hi, dtype, gen, base, tree)
            for window in (0, 24):
                out = K.tree_verify_attention_cuda(*args, window=window)
                ref = K.tree_verify_attention_plain(*args, window=window)
                torch.cuda.synchronize()
                err = max_err(out, ref)
                print(f"[kernel] tree_verify_attention {str(dtype)[6:]} "
                      f"(B,Kv,G,S,hd)={shape} nodes [{lo},{hi}) "
                      f"window={window}: max_abs_err={err:.3e} (tol {tol:g})",
                      flush=True)
                check(err <= tol, f"tree_verify_attention {dtype} {shape} "
                                  f"[{lo},{hi}) window {window}: error {err}")
                errs.append(err)
    row = {"name": "tree_verify_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/tree_verify_attention.cu",
           "replaces": "src/repro/kernels/tree_attention.py:90",
           "max_abs_err": max(errs)}
    row.update(_tree_timing(K, S, (16, 40), gen))
    row["long"] = {"shape": f"(B,Kv,G,N,S,hd)=(8, 8, 4, 16, {TREE_LONG_S}, "
                            "128)", **_tree_timing(K, TREE_LONG_S,
                                                   TREE_LONG_BASE, gen)}
    row["b1_token_tree"] = {
        "shape": f"(B,Kv,G,N,S,hd)=(1, 8, 4, 16, {TREE_B1[3]}, 128) "
                 "TokenTree (3, 2, 1)",
        **_tree_timing(K, TREE_B1[3], (15, 40), gen, B=1, tree=token_tree)}
    return row


# the SSD scan at the serving paths' prompt prefills: (model, B, S, H, N, P,
# chunk, q/k head-broadcast); the first row is the timed one
SSD_ROWS = (("mamba2-370m", 1, 15, 32, 128, 64, 256, True),
            ("xlstm-125m", 1, 15, 4, 384, 384, 128, False),
            ("zamba2-2.7b", 1, 15, 80, 64, 64, 128, True))
# more shapes held against the plain version: a front-padded three-chunk
# prompt, and carried random states (a mamba2 verify extend of 8 slots, an
# xLSTM prefill chunk, a zamba2 two-chunk extend)
SSD_MORE = (("mamba2-370m S=600", 1, 600, 32, 128, 64, 256, True, False),
            ("mamba2-370m extend", 8, 5, 32, 128, 64, 256, True, True),
            ("xlstm-125m chunk", 1, 7, 4, 384, 384, 128, False, True),
            ("zamba2-2.7b extend", 2, 200, 80, 64, 64, 128, True, True))
# the long single prompts (B 1, S 2048): mamba2 (8 chunks of 256, 32 heads)
# and xLSTM's mLSTM (16 chunks of 128, 4 heads of 384 x 384)
SSD_LONG = (("mamba2-370m long", 1, 2048, 32, 128, 64, 256, True),
            ("xlstm-125m long", 1, 2048, 4, 384, 384, 128, False))
# a rank's scans in ``[mesh-train]`` (B / data 2, H / model 2, seq 256):
# mamba2's and zamba2's SSD heads split over 'model', held and timed
# forward here and backward in ``check_ssd_bwd``
SSD_MESH_TRAIN = (("mamba2-370m train local", 4, 256, 16, 128, 64, 256,
                   True),
                  ("zamba2-2.7b train local", 4, 256, 40, 64, 64, 128,
                   True))


def _ssd_inputs(B, S, H, N, P, dtype, gen, broadcast, carried):
    """Scan inputs as the paths make them: q, k (B, S, H, N) — a stride-0
    head view of one (B, S, 1, N) projection for mamba2 and zamba2 —, v,
    decays log_a = -softplus(x) and input gates log_i; a random carried
    state when asked."""
    import torch
    import torch.nn.functional as F

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    hq = 1 if broadcast else H
    q = rnd((B, S, hq, N)).to(dtype).expand(B, S, H, N)
    k = rnd((B, S, hq, N)).to(dtype).expand(B, S, H, N)
    v = rnd((B, S, H, P)).to(dtype)
    la, li = -F.softplus(rnd((B, S, H))), rnd((B, S, H), 0.5)
    st = (rnd((B, H, N, P)), rnd((B, H, N)), rnd((B, H))) if carried \
        else None
    return q, k, v, la, li, st


def _ssd_cost(B, S, H, N, P, chunk, el, broadcast, carried):
    """(bytes, operations) the scan needs: each input read once (a
    head-broadcast q/k counted once), each output written once; per real
    chunk row, the masked intra-chunk products, the carried-in term and the
    state update (front-pad rows excluded)."""
    Q = min(chunk, S)
    pad = (-S) % Q
    ops = 0
    for c in range((S + pad) // Q):
        r = Q - (pad if c == 0 else 0)
        ops += r * (r + 1) // 2 * (2 * N + 2 * P + 1) \
            + r * (4 * N * P + 4 * N + P)
    state = B * H * (N * P + N + 1) * 4
    nbytes = (2 * B * S * (1 if broadcast else H) * N * el
              + B * S * H * P * el + 2 * B * S * H * 4      # v, gates
              + B * S * H * (P + 2) * 4 + state              # y, den, m
              + (state if carried else 0))
    return nbytes, ops * B * H


def check_ssd(gen):
    """The chunked SSD / mLSTM scan against its plain version: y, den, m
    and the final state, float32 (atol = rtol = 1e-4, the JAX kernel
    sweep's) and bfloat16 inputs (2e-2); then kernel and plain time at each
    path's prefill shape in bfloat16.  No single PyTorch call computes
    this scan: no library yardstick."""
    import torch
    from repro_torch.kernels import ssd_scan as K
    worst = 0.0
    cases = [r + (False,) for r in SSD_ROWS + SSD_LONG + SSD_MESH_TRAIN] \
        + list(SSD_MORE)
    for (dtype, tol), case in itertools.product(
            ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)), cases):
        label, B, S, H, N, P, chunk, bc, carried = case
        q, k, v, la, li, st = _ssd_inputs(B, S, H, N, P, dtype, gen, bc,
                                          carried)
        out = K.ssd_chunk_scan_cuda(q, k, v, la, li, chunk=chunk, state=st)
        ref = K.ssd_chunk_scan_plain(q, k, v, la, li, chunk=chunk, state=st)
        torch.cuda.synchronize()
        err, ok = 0.0, True
        for a, b in zip(out[:3] + out[3], ref[:3] + ref[3]):
            d = (a - b).abs()
            err = max(err, float(d.max()))
            ok = ok and bool((d <= tol + tol * b.abs()).all())
        print(f"[kernel] ssd_chunk_scan {str(dtype)[6:]} {label} "
              f"(B,S,H,N,P,chunk)={(B, S, H, N, P, chunk)} carried={carried}"
              f": max_abs_err={err:.3e} (atol = rtol = {tol:g})", flush=True)
        check(ok, f"ssd_chunk_scan {dtype} {label}: error {err} beyond "
                  f"atol = rtol = {tol}")
        worst = max(worst, err)
    row = {"name": "ssd_chunk_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:78",
           "max_abs_err": worst, "library_ms": None}
    rows = [ssd_timing(K, case, gen) for case in SSD_ROWS]
    row.update(rows[0])
    row["other_prefills"] = rows[1:]
    row["long"] = [ssd_timing(K, case, gen) for case in SSD_LONG]
    for case in SSD_MESH_TRAIN:
        row[case[0]] = ssd_timing(K, case, gen)
    return row


def ssd_timing(K, case, gen):
    """Kernel and plain time of one bf16 scan (no carried state) at
    ``case`` = (label, B, S, H, N, P, chunk, q/k head-broadcast), per call
    and on the device, with the bound."""
    import torch
    label, B, S, H, N, P, chunk, bc = case
    q, k, v, la, li, _ = _ssd_inputs(B, S, H, N, P, torch.bfloat16, gen, bc,
                                     False)
    fn = lambda: K.ssd_chunk_scan_cuda(q, k, v, la, li,  # noqa: E731
                                       chunk=chunk)
    ms, dev = time_ms(fn, reps=10 if S > 1024 else 30), device_ms(fn)
    plain = time_ms(lambda: K.ssd_chunk_scan_plain(q, k, v, la, li,
                                                   chunk=chunk),
                    reps=10 if S > 1024 else 30)
    bnd, by = bound_ms(*_ssd_cost(B, S, H, N, P, chunk, 2, bc, False),
                       "bfloat16")
    print(f"[kernel] ssd_chunk_scan timing {label} (B,S,H,N,P,chunk)="
          f"{(B, S, H, N, P, chunk)} bfloat16: {ms:.4f} ms per call, "
          f"{dev:.5f} ms on the device; plain {plain:.4f} ms; bound "
          f"{bnd:.6f} ms ({by})", flush=True)
    return {"shape": f"{label} (B,S,H,N,P,chunk)={(B, S, H, N, P, chunk)}",
            "ms": ms, "device_ms": dev, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by}


# the SSD-scan backward (the port's own kernel, csrc/ssd_scan_bwd.cu) at the
# trainer's shapes (batch 8, seq 256: mamba2-370m, xlstm-125m, zamba2-2.7b),
# front-padded ragged lengths and the 2048-token prompts: (label, B, S, H,
# N, P, chunk, q/k head-broadcast, the caller's form of the outputs).  Held
# against autograd of the plain scan through that form, float32 and
# bfloat16: max |kernel - plain| over dq, dk, dv, dlog_a, dlog_i within
# BWD_TOL x max(1, max |plain|); the training rows and the long ones timed
SSD_BWD_TRAIN = (("mamba2-370m", 8, 256, 32, 128, 64, 256, True, "mamba"),
                 ("xlstm-125m", 8, 256, 4, 384, 384, 128, False, "mlstm"),
                 ("zamba2-2.7b", 8, 256, 80, 64, 64, 128, True, "mamba"))
SSD_BWD_MORE = (("mamba2-370m ragged", 2, 300, 32, 128, 64, 256, True,
                 "mamba"),
                ("xlstm-125m ragged", 2, 200, 4, 384, 384, 128, False,
                 "mlstm"))
SSD_BWD_LONG = (("mamba2-370m long", 1, 2048, 32, 128, 64, 256, True,
                 "mamba"),
                ("xlstm-125m long", 1, 2048, 4, 384, 384, 128, False,
                 "mlstm"))


def _ssd_form(y, den, m, form):
    """The callers' forms of the scan's outputs: mamba2's y * exp(m),
    mLSTM's y / max(|den|, exp(-m))."""
    import torch
    if form == "mamba":
        return y * torch.exp(m)[..., None]
    return y / torch.maximum(den.abs(), torch.exp(-m))[..., None]


def _ssd_leaves(case, dtype, gen):
    """The scan's inputs as leaves that require grad (q and k head-broadcast
    views where the model makes them), and the weights R of the scalar loss
    sum(R * form(y, den, m))."""
    import torch
    label, B, S, H, N, P, chunk, bc, form = case
    q, k, v, la, li, _ = _ssd_inputs(B, S, H, N, P, dtype, gen, bc, False)
    R = torch.randn((B, S, H, P), generator=gen, device="cuda")
    return [t.detach().requires_grad_(True) for t in (q, k, v, la, li)], R


def _ssd_loss(fn, leaves, R, chunk, form):
    y, den, m, _ = fn(*leaves, chunk=chunk)
    return (R * _ssd_form(y, den, m, form)).sum()


def _ssd_bwd_cost(B, S, H, N, P, chunk, el, broadcast, dden):
    """(bytes, operations) of the backward of a scan that started from a
    zero state, as the kernel is launched here (``fresh``): each input the
    result needs read once (q, k, v, the gates, the row log-max, dy, dden
    where the caller's form passes it, each chunk's carried-in log-max but
    the first's and the final one, the saved S~ of each chunk that carries a
    state in and its n~ where dden is passed), each output written once (dq,
    dk per head, dv, dlog_a, dlog_i); per real chunk row the masked
    intra-chunk products (scores, dy v^T, W^T dy, D^T q, D k: 6 N + 4 P per
    visible pair) and the carry products, k dS and v dS^T (4 N P) where a
    later chunk carries a gradient in, dy S~ and q^T (co o dy) (4 N P) where
    the chunk carries a state in."""
    Q = min(chunk, S)
    pad = (-S) % Q
    nc = (S + pad) // Q
    ops = 0
    for c in range(nc):
        r = Q - (pad if c == 0 else 0)
        ops += r * (r + 1) // 2 * (6 * N + 4 * P) \
            + r * ((4 if c + 1 < nc else 0) + (4 if c > 0 else 0)) * N * P
    hq = 1 if broadcast else H
    saved = (nc - 1) * (N * P + (N if dden else 0)) + nc
    nbytes = (2 * B * S * hq * N * el + B * S * H * P * el
              + 3 * B * S * H * 4 + B * H * saved * 4
              + B * S * H * (P + (1 if dden else 0)) * 4
              + 2 * B * S * H * N * el + B * S * H * P * el
              + 2 * B * S * H * 4)
    return nbytes, ops * B * H


def _ssd_bwd_split_ops(B, S, H, N, P, chunk):
    """Operations as the mma route runs them, its split products counted
    (a product with one float32 operand twice, with two three times):
    per visible pair the scores once (2 N), dy v^T twice in each of the
    two passes (8 P), W^T dy three times (6 P), D^T q and D k twice each
    (8 N); per chunk row the carry k dS and v dS^T twice each (8 N P,
    where a later chunk carries a gradient in), dy S~ and q^T (co o dy)
    three times each (12 N P, where the chunk carries a state in)."""
    Q = min(chunk, S)
    pad = (-S) % Q
    nc = (S + pad) // Q
    ops = 0
    for c in range(nc):
        r = Q - (pad if c == 0 else 0)
        ops += r * (r + 1) // 2 * (10 * N + 14 * P) \
            + r * ((8 if c + 1 < nc else 0) + (12 if c > 0 else 0)) * N * P
    return ops * B * H


def _ssd_bwd_timing(K, case, gen):
    """The backward kernel alone (on the forward's saved state) per call and
    on the device, the plain autograd's backward alone (its graph
    retained), bfloat16, with the bound."""
    import torch
    label, B, S, H, N, P, chunk, bc, form = case
    leaves, R = _ssd_leaves(case, torch.bfloat16, gen)
    q, k, v, la, li = (t.detach() for t in leaves)
    with torch.no_grad():
        y, den, m, fin, saved = K._forward(q, k, v, la, li, chunk, None,
                                           save=True)
    yl, dl = y.requires_grad_(True), den.requires_grad_(True)
    dy, dden = torch.autograd.grad(
        (R * _ssd_form(yl, dl, m, form)).sum(), (yl, dl), allow_unused=True)

    def bwd():
        return K.ssd_chunk_scan_bwd_cuda(q, k, v, la, li, m, saved, fin[2],
                                         dy, dden, chunk=chunk, fresh=True)

    reps = 10 if S > 1024 else 20
    ms, dev = time_ms(bwd, reps=reps), device_ms(bwd)
    loss = _ssd_loss(K.ssd_chunk_scan_plain, leaves, R, chunk, form)
    plain = time_ms(lambda: torch.autograd.grad(loss, leaves,
                                                retain_graph=True),
                    reps=reps, warm=2)
    del loss
    nbytes, ops = _ssd_bwd_cost(B, S, H, N, P, chunk, 2, bc,
                                dden is not None)
    bnd, by = bound_ms(nbytes, ops, "bfloat16")
    split = _ssd_bwd_split_ops(B, S, H, N, P, chunk)
    print(f"[kernel] ssd_chunk_scan_bwd timing {label} (B,S,H,N,P,chunk)="
          f"{(B, S, H, N, P, chunk)} bfloat16: {ms:.4f} ms per call, "
          f"{dev:.4f} ms on the device; plain autograd backward "
          f"{plain:.4f} ms; bound {bnd:.6f} ms ({by}; {nbytes / 1e6:.2f} MB, "
          f"{ops / 1e9:.3f} G operations counted once = "
          f"{ops / dev / 1e9:.1f} TFLOP/s, {split / 1e9:.3f} G as the mma "
          f"route runs them = {split / dev / 1e9:.1f} TFLOP/s)", flush=True)
    return {"shape": f"{label} (B,S,H,N,P,chunk)={(B, S, H, N, P, chunk)}",
            "ms": ms, "device_ms": dev, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by}


def check_ssd_bwd(gen):
    """The SSD-scan backward (through ``ops.ssd_chunk_scan`` under grad: the
    forward kernel with its chunk states saved, then the backward kernel on
    ``ssd_bwd_plan``'s route: ``mma`` for bfloat16, ``cuda_cores`` for
    float32) against autograd of the plain scan, both through the caller's
    form, float32 and bfloat16; each bf16 case bit-identical across two
    runs; then timed.  No single PyTorch call computes it: no library
    yardstick."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as K
    errs = []
    mesh_cases = tuple(c + ("mamba",) for c in SSD_MESH_TRAIN)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        want = "mma" if dtype == torch.bfloat16 else "cuda_cores"
        for case in SSD_BWD_TRAIN + SSD_BWD_MORE + SSD_BWD_LONG + mesh_cases:
            label, B, S, H, N, P, chunk, bc, form = case
            plan = K.ssd_bwd_plan(dtype, N, P, min(chunk, S))
            check(plan.route == want, f"ssd_chunk_scan_bwd {name} {label}: "
                                      f"plan {plan}")
            leaves, R = _ssd_leaves(case, dtype, gen)
            ops.reset_launch_counts()
            got = torch.autograd.grad(
                _ssd_loss(ops.ssd_chunk_scan, leaves, R, chunk, form),
                leaves)
            routes = ops.launch_counts()
            check(routes[f"ssd_chunk_scan_bwd/{want}"] == 1
                  and routes["ssd_chunk_scan_bwd"] == 1,
                  f"ssd_chunk_scan_bwd {name} {label}: launches {routes}")
            ref = torch.autograd.grad(
                _ssd_loss(K.ssd_chunk_scan_plain, leaves, R, chunk, form),
                leaves)
            torch.cuda.synchronize()
            rel = max(max_err(a, b) / max(1.0, float(b.float().abs().max()))
                      for a, b in zip(got, ref))
            err = max(max_err(a, b) for a, b in zip(got, ref))
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            print(f"[kernel] ssd_chunk_scan_bwd {name} {label} (B,S,H,N,P,"
                  f"chunk)={(B, S, H, N, P, chunk)} {form} form, route "
                  f"{plan.route} (rows {plan.rows}, stages {plan.stages}, "
                  f"{plan.smem} bytes of shared memory): max_abs_err "
                  f"{err:.3e}, relative to max(1, max |plain|) {rel:.3e} "
                  f"(tol {BWD_TOL[name]:g})", flush=True)
            check(finite and rel <= BWD_TOL[name],
                  f"ssd_chunk_scan_bwd {name} {label}: relative error {rel}")
            errs.append(err)
            if dtype == torch.bfloat16:
                again = torch.autograd.grad(
                    _ssd_loss(ops.ssd_chunk_scan, leaves, R, chunk, form),
                    leaves)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"ssd_chunk_scan_bwd {label}: two runs differ")
                print(f"[kernel] ssd_chunk_scan_bwd bfloat16 {label}: two "
                      f"runs bit-identical", flush=True)
    row = {"name": "ssd_chunk_scan_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
           "replaces": "src/repro/models/ssm.py:43 (the gradient of "
                       "gla_chunked's jnp scan; no TPU kernel)",
           "max_abs_err": max(errs), "library_ms": None}
    rows = [_ssd_bwd_timing(K, case, gen) for case in SSD_BWD_TRAIN]
    row.update(rows[0])
    row["other_training_shapes"] = rows[1:]
    row["long"] = [_ssd_bwd_timing(K, case, gen) for case in SSD_BWD_LONG]
    for case in mesh_cases:
        row[case[0]] = _ssd_bwd_timing(K, case, gen)
        row[case[0]]["fwd_bwd_ms"] = _ssd_fwd_bwd_ms(ops, case, gen)
    return row


def _ssd_fwd_bwd_ms(ops, case, gen):
    """Forward + backward of the scan through ``ops.ssd_chunk_scan`` under
    grad (the path a training step takes), bf16, per call."""
    import torch
    leaves, R = _ssd_leaves(case, torch.bfloat16, gen)
    label, chunk, form = case[0], case[6], case[8]
    ms = time_ms(lambda: torch.autograd.grad(
        _ssd_loss(ops.ssd_chunk_scan, leaves, R, chunk, form), leaves),
        reps=20)
    print(f"[kernel] ssd_chunk_scan forward + backward {label}: {ms:.4f} ms "
          "per call (bfloat16, through ops.ssd_chunk_scan under grad)",
          flush=True)
    return ms


def phase_kernels():
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = [check_paged(gen), check_flash(gen), check_spec_verify(gen),
            check_tree(gen), check_decode(gen), check_ssd(gen),
            check_flash_bwd(gen), check_ssd_bwd(gen)]
    check_stub_family_shapes(gen, {r["name"]: r for r in rows})
    return rows


# ------------------------------------------------------------- phase 2b
# The stub-input families' attention (paligemma-3b: vlm, whisper-small:
# encdec), (label, B, H, Kv, Sq, Sk, hd, causal, prefix): paligemma's
# prefill (8 heads on one kv head, hd 256, the 256-row image prefix and 16
# text tokens, prefix-LM), whisper's encoder over 1500 frames and its
# cross attention from a 16-token prompt (non-causal, Sq != Sk); the
# backward also at the trainers' shapes (paligemma seq 512, whisper's 256
# decoder rows against the encoder)
STUB_FLASH = (("prefix", 8, 8, 1, 272, 272, 256, True, 256),
              ("encoder", 8, 12, 12, 1500, 1500, 64, False, 0),
              ("cross", 8, 12, 12, 16, 1500, 64, False, 0))
STUB_FLASH_BWD = STUB_FLASH + (
    ("prefix_train", 8, 8, 1, 512, 512, 256, True, 256),
    ("cross_train", 8, 12, 12, 256, 1500, 64, False, 0))
# dense decode, (label, Kv, G, hd, S, lengths): whisper's cross attention
# (every row's length the 1500 encoder rows) and paligemma's decode over
# the 256 + 16-row prompt and 24 new tokens; paged decode at paligemma's
# heads over the serving shape's 3-block tables
STUB_DECODE = (("cross", 12, 1, 64, 1500, (1500, 1501)),
               ("vlm", 1, 8, 256, 320, (272, 301)))
PAGED_VLM = dict(MB=3, lengths=(15, 46), Kv=1, G=8, hd=256)
# the 4-token linear extends of the [encdec] and [vlm] paths on the
# tree-verify kernel under a causal (4, 4) block mask, (label, B, Kv, G, S,
# hd, length): whisper's decoder cache (16 prompt + 24 decoded of 48) and
# paligemma's (256 + 16 + 24 of 304)
STUB_EXTEND = (("encdec", 8, 12, 1, 48, 64, 40),
               ("vlm", 8, 1, 8, 304, 256, 296))
# the vlm paged extend of the 16-token prompt: one paged-decode row per new
# token, (B, T, bs, MB)
PAGED_VLM_EXTEND = (8, 16, 32, 2)


def _visible(Sq, Sk, causal, prefix):
    """(Sq, Sk) bool: key j visible to query i (the kernels' mask)."""
    import torch
    i = torch.arange(Sq, device="cuda")[:, None]
    j = torch.arange(Sk, device="cuda")[None, :]
    if not causal:
        return torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
    return (j <= i) | (j < prefix)


def _stub_flash_inputs(case, dtype, gen):
    _, B, H, Kv, Sq, Sk, hd, _, _ = case
    q, dout = (_proj_view((B, H, Sq, hd), dtype, gen) for _ in range(2))
    k, v = (_proj_view((B, Kv, Sk, hd), dtype, gen) for _ in range(2))
    return q, k, v, dout


def _stub_flash_timing(K, case, gen):
    """Forward (kernel against SDPA on the same inputs, SDPA given the
    same boolean mask where there is a prefix) and backward (the kernel
    alone against SDPA's backward alone, then forward + backward of both)
    at one stub-family shape, bf16; bounds from the visible pairs."""
    import torch
    import torch.nn.functional as F
    label, B, H, Kv, Sq, Sk, hd, causal, prefix = case
    q, k, v, dout = _stub_flash_inputs(case, torch.bfloat16, gen)
    vis = _visible(Sq, Sk, causal, prefix)
    mask = vis if causal else None
    kw = dict(causal=causal, prefix_len=prefix)
    pairs = int(vis.sum()) * B * H
    fwd_bytes = 2 * (2 * B * H * Sq * hd + 2 * B * Kv * Sk * hd)
    out = {"shape": f"(B,H,Kv,Sq,Sk,hd)={(B, H, Kv, Sq, Sk, hd)} causal="
                    f"{causal} prefix={prefix}"}
    ms, dev, lib, lib_dev = paired_ms(
        lambda: K.flash_attention_cuda(q, k, v, **kw),
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                               enable_gqa=True))
    plain = time_ms(lambda: K.flash_attention_plain(q, k, v, **kw), reps=10)
    bnd, by = bound_ms(fwd_bytes, 4 * pairs * hd, "bfloat16")
    out["forward"] = {"ms": ms, "device_ms": dev, "plain_ms": plain,
                      "bound_ms": bnd, "bound_by": by, "library_ms": lib,
                      "library_device_ms": lib_dev}
    with torch.no_grad():
        o, lse = K.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        o_sdpa = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                                enable_gqa=True)
    torch.cuda.current_stream().wait_stream(side)
    bms, bdev, blib, blib_dev = paired_ms(
        lambda: K.flash_attention_bwd_cuda(q, k, v, o, lse, dout, **kw),
        lambda: torch.autograd.grad(o_sdpa, (qg, kg, vg), dout,
                                    retain_graph=True),
        library_stream=side)
    del o_sdpa
    def sdpa(a, b, c, **_):
        return F.scaled_dot_product_attention(a, b, c, attn_mask=mask,
                                              enable_gqa=True)

    fb, fb_dev, fb_lib, fb_lib_dev = paired_ms(
        lambda: _attn_grads(K.flash_attention_kernel, qg, kg, vg, dout,
                            **kw),
        lambda: _attn_grads(sdpa, qg, kg, vg, dout))
    bplain = time_ms(lambda: _attn_grads(K.flash_attention_plain, q, k, v,
                                         dout, **kw), reps=5)
    nb = 2 * (4 * B * H * Sq * hd + 4 * B * Kv * Sk * hd) + 4 * B * H * Sq
    bbnd, bby = bound_ms(nb, 5 * 2 * pairs * hd, "bfloat16")
    out["backward"] = {"ms": bms, "device_ms": bdev, "plain_ms": bplain,
                       "bound_ms": bbnd, "bound_by": bby, "library_ms": blib,
                       "library_device_ms": blib_dev, "fwd_bwd_ms": fb,
                       "fwd_bwd_device_ms": fb_dev, "sdpa_fwd_bwd_ms": fb_lib,
                       "sdpa_fwd_bwd_device_ms": fb_lib_dev,
                       "route": K.flash_bwd_plan(torch.bfloat16, hd, H // Kv,
                                                 Sq, Sk, causal, 0,
                                                 prefix).route}
    f, b = out["forward"], out["backward"]
    print(f"[kernel] stub-family flash timing {label} {out['shape']} "
          f"bfloat16: forward {f['ms']:.4f} ms per call, {f['device_ms']:.4f}"
          f" ms on the device, SDPA {f['library_ms']:.4f} / "
          f"{f['library_device_ms']:.4f} ms, plain {f['plain_ms']:.4f} ms, "
          f"bound {f['bound_ms']:.6f} ms ({f['bound_by']}); backward "
          f"({b['route']}) {b['ms']:.4f} / {b['device_ms']:.4f} ms, SDPA "
          f"backward {b['library_ms']:.4f} / {b['library_device_ms']:.4f} ms,"
          f" bound {b['bound_ms']:.6f} ms ({b['bound_by']}); forward + "
          f"backward {fb:.4f} / {fb_dev:.4f} ms, SDPA {fb_lib:.4f} / "
          f"{fb_lib_dev:.4f} ms; plain forward + backward {bplain:.4f} ms",
          flush=True)
    return out


def check_stub_family_shapes(gen, rows):
    """The flash forward and backward with ``prefix_len``, non-causal with
    Sq != Sk and at hd 256, and the dense and paged decode at paligemma's
    heads and whisper's 1500-row cross attention, each against its plain
    version (float32 and bfloat16, the tolerances of the rows above) and
    timed; the timings go into the rows of ``flash_attention``,
    ``flash_attention_bwd``, ``decode_attention`` and
    ``paged_decode_attention``."""
    import torch
    from repro_torch.kernels import decode_attention as D
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ops
    ferr, berr = [], []
    for case in STUB_FLASH_BWD + MESH_TRAIN_STUB_FLASH:
        label, B, H, Kv, Sq, Sk, hd, causal, prefix = case
        kw = dict(causal=causal, prefix_len=prefix)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            name = str(dtype)[6:]
            q, k, v, dout = _stub_flash_inputs(case, dtype, gen)
            if case in STUB_FLASH + MESH_TRAIN_STUB_FLASH:
                err = max_err(K.flash_attention_cuda(q, k, v, **kw),
                              K.flash_attention_plain(q, k, v, **kw))
                print(f"[kernel] flash_attention {name} {label} (B,H,Kv,Sq,"
                      f"Sk,hd)={(B, H, Kv, Sq, Sk, hd)} causal={causal} "
                      f"prefix={prefix}: max_abs_err={err:.3e} (tol {tol:g})",
                      flush=True)
                check(err <= tol, f"flash_attention {name} {label}: error "
                                  f"{err}")
                ferr.append(err)
            got = _attn_grads(ops.flash_attention, q, k, v, dout, **kw)
            ref = _attn_grads(K.flash_attention_plain, q, k, v, dout, **kw)
            again = _attn_grads(ops.flash_attention, q, k, v, dout, **kw)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            err = max(max_err(a, b) for a, b in zip(got, ref))
            scale = max(1.0, max(float(r.float().abs().max()) for r in ref))
            route = K.flash_bwd_plan(dtype, hd, H // Kv, Sq, Sk, causal, 0,
                                     prefix).route
            print(f"[kernel] flash_attention_bwd {name} {label} (B,H,Kv,Sq,"
                  f"Sk,hd)={(B, H, Kv, Sq, Sk, hd)} causal={causal} prefix="
                  f"{prefix} ({route}): max_abs_err {err:.3e} (tol "
                  f"{BWD_TOL[name]:g} x {scale:.2f}); a second run "
                  f"{'bit-identical' if same else 'DIFFERS'}", flush=True)
            check(err <= BWD_TOL[name] * scale,
                  f"flash_attention_bwd {name} {label}: error {err}")
            check(same, f"flash_attention_bwd {name} {label}: two runs "
                        "differ")
            berr.append(err)
            del got, ref, again, q, k, v, dout
    for case in STUB_FLASH_BWD + MESH_TRAIN_STUB_FLASH:
        t = _stub_flash_timing(K, case, gen)
        if case in STUB_FLASH + MESH_TRAIN_STUB_FLASH:
            rows["flash_attention"][case[0]] = {"shape": t["shape"],
                                                **t["forward"]}
        rows["flash_attention_bwd"][case[0]] = {"shape": t["shape"],
                                                **t["backward"]}
    rows["flash_attention"]["max_abs_err"] = max(
        rows["flash_attention"]["max_abs_err"], *ferr)
    rows["flash_attention_bwd"]["max_abs_err"] = max(
        rows["flash_attention_bwd"]["max_abs_err"], *berr)
    derr = []
    for (dtype, tol), (label, Kv, G, hd, S, lengths) in itertools.product(
            ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)), STUB_DECODE):
        q = torch.randn((8, Kv, G, hd), generator=gen, device="cuda") \
            .to(dtype)
        k, v = (_dense_view((8, Kv, S, hd), dtype, gen) for _ in range(2))
        length = torch.randint(*lengths, (8,), generator=gen, device="cuda",
                               dtype=torch.int32)
        err = max_err(D.decode_attention_cuda(q, k, v, length),
                      D.decode_attention_plain(q, k, v, length))
        print(f"[kernel] decode_attention {str(dtype)[6:]} {label} (B,Kv,G,"
              f"hd,S)={(8, Kv, G, hd, S)}: max_abs_err={err:.3e} (tol "
              f"{tol:g})", flush=True)
        check(err <= tol, f"decode_attention {dtype} {label}: error {err}")
        derr.append(err)
    for label, (Kv, G, hd, S, lengths) in ((c[0], c[1:]) for c in
                                           STUB_DECODE):
        rows["decode_attention"][label] = decode_timing(D, gen, Kv, G, hd, S,
                                                        lengths)
    rows["decode_attention"]["max_abs_err"] = max(
        rows["decode_attention"]["max_abs_err"], *derr)
    perr = []
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, kp, vp, table, length = _paged_inputs(
            dtype, gen, PAGED_VLM["hd"], PAGED_VLM["MB"],
            PAGED_VLM["lengths"], PAGED_VLM["Kv"], PAGED_VLM["G"])
        err = max_err(D.paged_decode_attention_cuda(q, kp, vp, table, length),
                      D.paged_decode_attention_plain(q, kp, vp, table,
                                                     length))
        print(f"[kernel] paged_decode_attention {str(dtype)[6:]} vlm hd=256 "
              f"Kv=1 G=8 MB=3: max_abs_err={err:.3e} (tol {tol:g})",
              flush=True)
        check(err <= tol, f"paged_decode_attention {dtype} vlm: error {err}")
        perr.append(err)
        B, T, bs, MB = PAGED_VLM_EXTEND
        q, kp, vp, table, _ = _paged_inputs(dtype, gen, 256, MB, (1, 2), 1,
                                            8)
        q = torch.randn((B * T, 1, 8, 256), generator=gen,
                        device="cuda").to(dtype)
        table = table.repeat_interleave(T, 0)
        length = torch.arange(1, T + 1, dtype=torch.int32,
                              device="cuda").repeat(B)
        err = max_err(D.paged_decode_attention_cuda(q, kp, vp, table, length),
                      D.paged_decode_attention_plain(q, kp, vp, table,
                                                     length))
        print(f"[kernel] paged_decode_attention {str(dtype)[6:]} vlm paged "
              f"extend (B*T,Kv,G,hd,bs,MB)={(B * T, 1, 8, 256, bs, MB)}: "
              f"max_abs_err={err:.3e} (tol {tol:g})", flush=True)
        check(err <= tol, f"paged_decode_attention {dtype} vlm extend: "
                          f"error {err}")
        perr.append(err)
    rows["paged_decode_attention"]["vlm"] = {
        "shape": "(B,Kv,G,hd,bs,MB)=(8, 1, 8, 256, 32, 3)",
        **paged_timing(D, gen, **PAGED_VLM)}
    rows["paged_decode_attention"]["max_abs_err"] = max(
        rows["paged_decode_attention"]["max_abs_err"], *perr)
    check_stub_extends(gen, rows["tree_verify_attention"])


def check_stub_extends(gen, row):
    """The tree-verify kernel at the [encdec] and [vlm] paths' 4-token
    linear extends (``STUB_EXTEND``, a causal block mask) against its
    plain version, float32 and bfloat16, and timed; into ``row``."""
    import numpy as np
    import torch
    from repro_torch.kernels import tree_attention as K
    tree = (np.tril(np.ones((4, 4), bool)), np.arange(4))
    errs = []
    for (dtype, tol), (label, B, Kv, G, S, hd, n) in itertools.product(
            ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)), STUB_EXTEND):
        args = _tree_inputs(B, Kv, G, S, hd, 0, 4, dtype, gen, (n, n + 1),
                            tree)
        err = max_err(K.tree_verify_attention_cuda(*args),
                      K.tree_verify_attention_plain(*args))
        print(f"[kernel] tree_verify_attention {str(dtype)[6:]} {label} "
              f"linear extend (B,Kv,G,N,S,hd)={(B, Kv, G, 4, S, hd)}: "
              f"max_abs_err={err:.3e} (tol {tol:g})", flush=True)
        check(err <= tol, f"tree_verify_attention {dtype} {label} extend: "
                          f"error {err}")
        errs.append(err)
    for label, B, Kv, G, S, hd, n in STUB_EXTEND:
        row[f"{label}_extend"] = {
            "shape": f"(B,Kv,G,N,S,hd)={(B, Kv, G, 4, S, hd)} causal (4, 4)",
            **_tree_timing(K, S, (n, n + 1), gen, B=B, tree=tree,
                           heads=(Kv, G, hd))}
    row["max_abs_err"] = max(row["max_abs_err"], *errs)


# --------------------------------------------------------------- phase 3
def _configs(edge: str, num_layers=None, dtype=None, cloud="granite-8b"):
    """(edge, cloud) configs, granite-8b unless told, with the vocabulary
    cut to the smaller of the two, as the serve CLI does; ``num_layers``
    (edge layers, cloud layers) cuts depth."""
    from repro_torch.configs import get_config
    e, c = get_config(edge), get_config(cloud)
    kw = {"vocab_size": min(e.vocab_size, c.vocab_size)}
    if dtype is not None:
        kw.update(param_dtype=dtype, activ_dtype=dtype)
    e, c = e.replace(**kw), c.replace(**kw)
    if num_layers is not None:
        e, c = e.replace(num_layers=num_layers[0]), \
            c.replace(num_layers=num_layers[1])
    return e, c


def _prompts(vocab: int, n: int = 8, length: int = 16):
    import numpy as np
    from repro_torch.data import SyntheticLM
    synth = SyntheticLM(vocab)
    rng = np.random.default_rng(0)
    return [synth.sample(rng, i % synth.n_domains, length) for i in range(n)]


# the served paths: name, edge model, engine settings, the kernels the path
# must launch; the cloud is granite-8b throughout.  The recurrent edges
# resolve kv_layout "auto" to dense (the edge rewinds by batched replay)
RECURRENT_KERNELS = ("ssd_chunk_scan", "flash_attention", "spec_verify")
PATHS = (
    ("linear", "smollm-135m", {},
     ("paged_decode_attention", "flash_attention", "spec_verify")),
    ("tree", "smollm-135m", {"spec_mode": "tree", "spec_tree_width": 2,
                             "kv_layout": "dense"},
     ("tree_verify_attention", "decode_attention", "flash_attention")),
    ("self", "smollm-135m", {"spec_mode": "self", "spec_exit_layer": 15},
     ("paged_decode_attention", "flash_attention", "spec_verify")),
    ("moe", "granite-moe-1b-a400m", {},
     ("paged_decode_attention", "flash_attention", "spec_verify")),
    ("mamba2", "mamba2-370m", {}, RECURRENT_KERNELS),
    ("xlstm", "xlstm-125m", {}, RECURRENT_KERNELS),
    ("hybrid", "zamba2-2.7b", {}, RECURRENT_KERNELS + ("decode_attention",)),
)
# served depth where it is cut (edge layers; the granite-8b cloud keeps its
# 36): the moe, mamba2 and zamba2 edges at a quarter of their depth
# (zamba2 keeps two shared-attention groups of 6), for the script's time
SERVE_DEPTH = {"granite-moe-1b-a400m": 6, "mamba2-370m": 12,
               "zamba2-2.7b": 12}
# f32 parity depth per edge (edge layers, cloud layers): zamba2 keeps its
# own shared_attn_every = 6 (one group), xLSTM reaches its sLSTM block 3
PARITY_DEPTH = {"smollm-135m": (2, 2), "mamba2-370m": (2, 2),
                "xlstm-125m": (4, 2), "zamba2-2.7b": (6, 2),
                "granite-moe-1b-a400m": (2, 2)}
# the per-request phase: new tokens per request, and the kernels it must
# launch (serve_reference's prefills and batch-1 decode steps, the tree
# verify, and the one-slot BatchedEngine's paged ticks and spec verify)
PER_REQUEST_NEW = 8
# new tokens of each served path's drain (the kernel checks' serving
# shapes follow from it: slot_len 80, 3-block paged tables)
SERVE_NEW = 24
PER_REQUEST_KERNELS = ("flash_attention", "decode_attention",
                       "tree_verify_attention", "paged_decode_attention",
                       "spec_verify")


def _rules(graphs, e_cfg):
    """The ``stats()["graphs"]`` rules of an off-mesh engine on the card
    with graphs on or off: every tick, round and prefill captured, but a
    recurrent edge's prefill (exact length, eager)."""
    rule = "captured" if graphs else "eager (graphs=False)"
    rules = dict.fromkeys(("edge", "cloud", "spec", "edge prefill",
                           "cloud prefill"), rule)
    if graphs and e_cfg.family in ("ssm", "xlstm", "hybrid"):
        rules["edge prefill"] = "eager (recurrent prefill: exact length)"
    return rules


def _engine(e_cfg, c_cfg, attn_backend="auto", **kw):
    from repro_torch.core.policy import SpeculativePolicy
    from repro_torch.core.scheduler import BatchedEngine
    from repro_torch.models import Model
    kw = {"kv_layout": "auto", "batch_size": 8, "temperature": 0.0,
          "policy": SpeculativePolicy(0.6), **kw}
    return BatchedEngine(Model(e_cfg), Model(c_cfg), gamma=4,
                         attn_backend=attn_backend, **kw)


def _init(cfg, seed):
    import torch
    from repro_torch.models import Model
    t = time.perf_counter()
    params = Model(cfg).init(seed=seed, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    print(f"[serve] init {cfg.name} ({n / 1e9:.2f}e9 params, "
          f"{cfg.param_dtype}, vocab {cfg.vocab_size}) in "
          f"{time.perf_counter() - t:.1f}s", flush=True)
    return params


def phase_serve():
    import torch
    from repro_torch.kernels import ops
    total = dict.fromkeys(ops.launch_counts(), 0)
    ep = cp = e_cfg = c_cfg = None
    for name, edge, kw, kernels in PATHS:
        e_new, c_new = _configs(edge)
        if edge in SERVE_DEPTH:
            e_new = e_new.replace(num_layers=SERVE_DEPTH[edge])
        if e_new != e_cfg:
            ep = None
            torch.cuda.empty_cache()
            e_cfg, ep = e_new, _init(e_new, 0)
        if c_new != c_cfg:
            cp = None
            torch.cuda.empty_cache()
            c_cfg, cp = c_new, _init(c_new, 1)
        prompts = _prompts(e_cfg.vocab_size)
        V = e_cfg.vocab_size
        # warm-up drain (library handles, allocator), not measured
        _engine(e_cfg, c_cfg, **kw).serve_batch(ep, cp, prompts[:2], 2)
        eng = _engine(e_cfg, c_cfg, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t = time.perf_counter()
        traces = eng.serve_batch(ep, cp, prompts, SERVE_NEW)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches = ops.launch_counts()
        stats = eng.stats()
        check(stats["spec_mode"] == kw.get("spec_mode", "linear"),
              f"{name} path: engine served lane {stats['spec_mode']}")
        for i, tr in enumerate(traces):
            check(tr.tokens is not None and len(tr.tokens) == SERVE_NEW,
                  f"{name} request {i}: {len(tr.tokens or [])} tokens, "
                  f"want {SERVE_NEW}")
            check(all(0 <= t < V for t in tr.tokens),
                  f"{name} request {i}: token outside [0, {V})")
        for k in kernels:
            check(launches[k] > 0,
                  f"kernel {k} was not launched on the {name} path")
        check(stats["graphs"] == _rules(True, e_cfg),
              f"{name} path: graph rules {stats['graphs']}")
        for k, n in launches.items():
            total[k] += n
        paths = {}
        for tr in traces:
            paths[tr.path] = paths.get(tr.path, 0) + 1
        ticks = stats["ticks"]
        lane = stats["spec_lanes"][stats["spec_mode"]]
        print(f"[serve] {name} path ({e_cfg.num_layers}-layer {e_cfg.name} "
              f"edge, {stats['kv_layout']} KV): paths {paths}; "
              f"{len(traces) / dt:.2f} req/s, "
              f"{SERVE_NEW * len(traces) / dt:.1f} tok/s, {dt:.2f}s; "
              f"{ticks} edge ticks at "
              f"{stats['tick_seconds'] / max(ticks, 1) * 1e3:.1f} ms/tick; "
              f"{lane['member_rounds']} member rounds, accept rate "
              f"{stats['spec_accept_rate']:.3f}, "
              f"{stats['accepted_tokens_per_step']:.2f} tokens per verify; "
              f"cloud passes/request "
              f"{sum(tr.cloud_passes for tr in traces) / len(traces):.1f}; "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"graphs {stats['graphs']}, captures {stats['captures']} in "
              f"{stats['capture_seconds']:.2f}s; "
              f"launches {launches}", flush=True)
        # finiteness of the logits on the path: a prefill of every served
        # sequence through both models must give finite logits
        _check_finite(ep, cp, e_cfg, c_cfg, prompts, traces)
        lap(f"serve {name} path")
        if name == "linear":
            for k, n in phase_graphs(ep, cp, e_cfg, c_cfg, prompts).items():
                total[k] += n
            lap("graphs")
        if name == "self":            # the last path of the dense edge
            phase_breakdown(ep, cp, e_cfg, c_cfg, prompts)
            lap("breakdown")
            for k, n in phase_per_request(ep, cp, e_cfg, c_cfg,
                                          prompts).items():
                total[k] += n
            lap("per-request")
        if e_cfg.family != "dense":
            eng = _engine(e_cfg, c_cfg, **kw)
            h, d, busy = _round_ms(eng, ep, cp, prompts)
            print(f"[breakdown] one {name} round (G=8, "
                  f"{eng.spec.graph_rule('cuda')}): host issue "
                  f"{h:.3f} ms, stream span {d:.3f} ms, device busy "
                  f"{busy:.3f} ms", flush=True)
            lap(f"{name} round breakdown")
    del ep, cp
    torch.cuda.empty_cache()
    return total


# [graphs]: new tokens of the full-width drains (eager against captured)
# and of the float32 parity drains; the kernels a captured drain launches
# through its graphs' replays, per parity case (by the label's first
# word); the parity cases: label, edge, engine settings (at PARITY_DEPTH:
# the self lane drafts with the first of two layers)
GRAPHS_NEW = 8
GRAPHS_PARITY_NEW = 8
GRAPHS_KERNELS = {"paged": ("paged_decode_attention", "spec_verify",
                            "flash_attention"),
                  "dense": ("decode_attention", "spec_verify",
                            "flash_attention"),
                  "tree": ("tree_verify_attention", "decode_attention",
                           "flash_attention"),
                  "self": ("paged_decode_attention", "spec_verify",
                           "flash_attention"),
                  "mamba2": ("spec_verify", "flash_attention"),
                  "xlstm": ("spec_verify", "flash_attention"),
                  "hybrid": ("decode_attention", "spec_verify",
                             "flash_attention")}
# [graphs] lengths: drains of ever new prompt lengths on one engine per
# lane kind (paged linear; dense tree) at PARITY_DEPTH, f32, the longest
# first, GRAPHS_LENGTHS_NEW new tokens a drain; prompts past 17 tokens
# prefill chunked
GRAPHS_LENGTHS = tuple(range(40, 8, -2))
GRAPHS_LENGTHS_NEW = 4
GRAPHS_LENGTHS_ENGINES = (("paged", {}), ("tree", PATHS[1][2]))
GRAPHS_PARITY = (
    ("paged", "smollm-135m", {}),
    ("dense", "smollm-135m", {"kv_layout": "dense"}),
    ("paged T=1", "smollm-135m", {"temperature": 1.0}),
    ("tree", "smollm-135m", PATHS[1][2]),
    ("self", "smollm-135m", {**PATHS[2][2], "spec_exit_layer": 1}),
    ("mamba2", "mamba2-370m", {}),
    ("xlstm", "xlstm-125m", {}),
    ("hybrid", "zamba2-2.7b", {}),
)


def _graphs_drain(eng, ep, cp, prompts, max_new):
    """(traces, seconds, launch counts, stats) of one drain, the counts set
    to 0 just before it and read just after."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t = time.perf_counter()
    traces = eng.serve_batch(ep, cp, prompts, max_new)
    torch.cuda.synchronize()
    return traces, time.perf_counter() - t, ops.launch_counts(), eng.stats()


def _trace_key(traces):
    return [(t.path, t.tokens, t.edge_calls, t.cloud_passes,
             round(t.uncertainty, 6)) for t in traces]


def phase_graphs(ep, cp, e_cfg, c_cfg, prompts):
    """``[graphs]``: the compiled serving tick (``core/capture.py``).

    The semantic cache is off in every engine here, so that a repeated
    drain runs its ticks and rounds again.  Float32 parity at
    ``PARITY_DEPTH`` (TF32 off), the cases of ``GRAPHS_PARITY``: the
    linear path on paged KV, the dense tick (``kv_layout="dense"``), the
    paged path at T = 1, the tree and self lanes and the mamba2, xlstm
    and zamba2 edges' linear lane, each drained by an eager engine
    (``graphs=False``) and a captured one — tokens, paths, edge calls,
    cloud passes and uncertainties identical, the launch counts (through
    the replays) equal and the case's ``GRAPHS_KERNELS`` launched; a
    second identical drain of each captured engine captures nothing
    (``CaptureCounter``) and repeats its tokens.  Then at full width
    (``ep``/``cp``: the bf16 smollm-135m and granite-8b of the linear
    path), batch 8, ``GRAPHS_NEW`` new tokens: each engine warmed by one
    drain (the captured one's captures and their seconds printed), then
    eager, captured, captured, eager drains (ms per drain and per tick)
    and one round of each engine in the same turns (host issue, stream
    span, device busy).  Returns the launches of the full-width drains."""
    import torch
    from repro_torch.analysis.compile_guard import CaptureCounter
    from repro_torch.models import Model
    total = {}
    pe = pc = fep = fcp = None
    for label, edge, kw in GRAPHS_PARITY:
        e_new, c_new = _configs(edge, PARITY_DEPTH[edge], "float32")
        if e_new != pe:
            fep = None
            pe, fep = e_new, Model(e_new).init(seed=0, device="cuda")
        if c_new != pc:
            fcp = None
            pc, fcp = c_new, Model(c_new).init(seed=1, device="cuda")
        fprompts = _prompts(pe.vocab_size)
        kernels = GRAPHS_KERNELS[label.split()[0]]
        runs = {}
        for graphs in (False, True):
            eng = _engine(pe, pc, graphs=graphs, use_cache=False, **kw)
            with CaptureCounter() as cc:
                runs[graphs] = _graphs_drain(eng, fep, fcp, fprompts,
                                             GRAPHS_PARITY_NEW)
                if graphs:
                    check(cc.count > 0, f"[graphs] {label}: the warm drain "
                                        "captured nothing")
                    cc.reset()
                    again = _graphs_drain(eng, fep, fcp, fprompts,
                                          GRAPHS_PARITY_NEW)
                    check(cc.count == 0, f"[graphs] {label}: a second drain "
                          "of identical shape captured: "
                          + "; ".join(cc.events))
                    check(_trace_key(again[0]) == _trace_key(runs[True][0]),
                          f"[graphs] {label}: the second captured drain gave "
                          "other tokens")
            check(eng.stats()["graphs"] == _rules(graphs, pe),
                  f"[graphs] {label}: rules {eng.stats()['graphs']}")
            if graphs and label == "mamba2":
                _recurrent_prefill_capture(eng, fep, fprompts[0])
        eager, capt = runs[False], runs[True]
        same = _trace_key(eager[0]) == _trace_key(capt[0])
        check(same, f"[graphs] {label}: the captured drain's traces differ "
                    "from the eager drain's")
        check(eager[2] == capt[2], f"[graphs] {label}: launches through the "
              f"replays {capt[2]} differ from the eager drain's {eager[2]}")
        for k in kernels:
            check(capt[2][k] > 0, f"[graphs] {label}: kernel {k} was not "
                                  "launched through the replays")
        paths = collections.Counter(t.path for t in capt[0])
        print(f"[graphs] float32 parity, {label} ({pe.num_layers}-layer "
              f"{pe.name} + {pc.num_layers}-layer {pc.name}, {len(fprompts)} "
              f"requests, {GRAPHS_PARITY_NEW} new): captured == eager on "
              f"{len(fprompts)}/{len(fprompts)} traces (tokens, paths "
              f"{dict(paths)}, edge calls, cloud passes, uncertainty); "
              f"captures {capt[3]['captures']}, 0 on a second drain; "
              f"launches through the replays == eager: "
              + ", ".join(f"{k} {capt[2][k]}" for k in kernels), flush=True)
    del fep, fcp
    torch.cuda.empty_cache()
    lengths_graphs()
    torch.cuda.empty_cache()

    # ---- full width, bf16: eager, captured, captured, eager
    engines = {g: _engine(e_cfg, c_cfg, graphs=g, use_cache=False)
               for g in (False, True)}
    warm = {}
    for graphs in (False, True):
        with CaptureCounter() as cc:
            warm[graphs] = _graphs_drain(engines[graphs], ep, cp, prompts,
                                         GRAPHS_NEW)
            check((cc.count > 0) == graphs,
                  f"[graphs] warm drain (graphs={graphs}) captured "
                  f"{cc.count}")
    st = warm[True][3]
    print(f"[graphs] full width ({e_cfg.num_layers}-layer {e_cfg.name} + "
          f"{c_cfg.num_layers}-layer {c_cfg.name}, {e_cfg.param_dtype}, "
          f"batch 8, {GRAPHS_NEW} new): warm drains eager "
          f"{warm[False][1]:.3f} s, captured {warm[True][1]:.3f} s with "
          f"captures {st['captures']} taking {st['capture_seconds']:.3f} s; "
          "per function: " + "; ".join(
              f"{f.name} {f.captures} in {f.capture_seconds:.3f} s"
              for f in _functions(engines[True]) if f.captures), flush=True)
    _graph_pools(engines[True], {"edge": ep, "cloud": cp}, prompts[0])
    turns = []
    rounds = {g: warm[g][3]["spec_lanes"]["linear"]["member_rounds"]
              for g in (False, True)}
    with CaptureCounter() as cc:
        for graphs in (False, True, True, False):
            traces, dt, launches, st = _graphs_drain(
                engines[graphs], ep, cp, prompts, GRAPHS_NEW)
            done = st["spec_lanes"]["linear"]["member_rounds"]
            turns.append((graphs, traces, dt, launches, st,
                          done - rounds[graphs]))
            rounds[graphs] = done
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
        check(cc.count == 0, "[graphs] a full-width drain after the warm "
              "one captured: " + "; ".join(cc.events))
    for graphs, traces, dt, launches, st, n_rounds in turns:
        print(f"[graphs] full width {'captured' if graphs else 'eager'} "
              f"drain: {dt * 1e3:.1f} ms, {len(traces) / dt:.2f} req/s; "
              f"{st['ticks']} ticks at "
              f"{st['tick_seconds'] / max(st['ticks'], 1) * 1e3:.2f} "
              f"ms/tick; {n_rounds} member rounds; launches "
              + ", ".join(f"{k} {launches[k]}"
                          for k in GRAPHS_KERNELS["paged"]), flush=True)
        if graphs:
            for k in GRAPHS_KERNELS["paged"]:
                check(launches[k] > 0, f"[graphs] full width: kernel {k} "
                                       "was not launched through replays")
    same = sum(a == b for a, b in zip(_trace_key(turns[0][1]),
                                      _trace_key(turns[1][1])))
    print(f"[graphs] full width bf16: captured traces equal the eager "
          f"ones on {same}/{len(prompts)} requests", flush=True)
    for graphs in (False, True, True, False):
        h, d, busy = _round_ms(_engine(e_cfg, c_cfg, graphs=graphs), ep, cp,
                               prompts)
        print(f"[graphs] one linear round (G=8), "
              f"{'captured' if graphs else 'eager'}: host issue {h:.3f} ms, "
              f"stream span {d:.3f} ms, device busy {busy:.3f} ms",
              flush=True)
    for graphs in (False, True, True, False):
        for side, params in (("edge", ep), ("cloud", cp)):
            lane = getattr(engines[graphs], side)
            h, d, busy = _prefill_ms(lane, params, prompts[0])
            print(f"[graphs] one batch-1 prefill, {side} "
                  f"{lane.model.cfg.name} ({prompts[0].size - 1} entries "
                  f"in a bucket of 16, max_seq 32, "
                  f"{lane.prefill_rule('cuda')}): host issue {h:.3f} ms, "
                  f"stream span {d:.3f} ms, device busy {busy:.3f} ms",
                  flush=True)
    return total


def _functions(eng):
    """The captured functions of an engine: each lane's tick, prefill and
    extend (its dense side's too) and the speculative round."""
    seen = {}
    for lane in (eng.edge, eng.cloud, eng._spec_edge, eng._spec_cloud):
        for f in lane.captured_functions():
            seen[id(f)] = f
    seen[id(eng.spec._graph)] = eng.spec._graph
    return list(seen.values())


def _held_bytes(g) -> int:
    """Device bytes a captured graph keeps alive: its static inputs and the
    outputs it builds in its memory pool."""
    import torch
    return sum(t.nbytes for t in g.static_in) + sum(
        t.nbytes for t in g.plan if isinstance(t, torch.Tensor))


def _pool_bytes():
    """(reserved, allocated) bytes of the memory pool the graphs share
    (``capture.pool``), from the allocator's segments; None where this
    PyTorch does not name a segment's pool."""
    import torch
    from repro_torch.core.capture import pool
    segs = torch.cuda.memory_snapshot()
    if segs and "segment_pool_id" not in segs[0]:
        return None
    pid = tuple(pool(torch.device("cuda", torch.cuda.current_device())))
    mine = [x for x in segs if tuple(x["segment_pool_id"]) == pid]
    return (sum(x["total_size"] for x in mine),
            sum(x["allocated_size"] for x in mine))


def _graph_pools(eng, params, prompt):
    """``[graphs] pool``: the graphs' shared memory pool after the warm
    full-width drains (reserved: the largest capture's temporaries plus
    every graph's outputs; allocated: the outputs), what one graph of
    each captured function keeps alive (a prefill graph: the cache it
    builds, which every replay clones out), and what one prefill graph of
    each lane reserves in a private pool of its own, as every graph did
    before they shared one."""
    import torch
    got = _pool_bytes()
    print("[graphs] pool shared by every graph: " + (
        "not named by this PyTorch" if got is None else
        f"reserved {got[0]} B, allocated {got[1]} B; "
        f"torch.cuda.memory_reserved {torch.cuda.memory_reserved()} B"),
        flush=True)
    for f in _functions(eng):
        if not f.live_graphs:
            continue
        g = next(iter(f._graphs.values()))
        print(f"[graphs] pool {f.name}, first of {f.live_graphs} graphs "
              f"({f.captures} captured, {f.dropped} dropped): keeps alive "
              f"{_held_bytes(g)} B", flush=True)
    for side in ("edge", "cloud"):
        lane = getattr(eng, side)
        got = _private_pool_bytes(lane, params[side], prompt)
        print(f"[graphs] pool of its own, one {lane.model.cfg.name} prefill "
              f"graph ({prompt.size - 1} entries, max_seq 32): " + (
                  "not named by this PyTorch" if got is None else
                  f"reserved {got[0]} B, allocated {got[1]} B"), flush=True)


def _private_pool_bytes(lane, params, prompt, max_seq=32):
    """(reserved, allocated) bytes of the private memory pool of ONE
    capture of ``lane``'s prefill body (``torch.cuda.CUDAGraph`` with no
    shared pool), read from the allocator's segments while the graph
    lives; None where this PyTorch does not name a segment's pool.  Its
    launches (warm-up and capture) are taken back from the counts."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    entries = np.asarray(prompt, np.int32)[:-1]
    pad = 1 << (entries.size - 1).bit_length()
    toks = torch.zeros((1, pad), dtype=torch.int32, device="cuda")
    toks[0, :entries.size] = torch.as_tensor(entries, device="cuda")
    before = ops.launch_counts()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lane._prefill_body(params, toks, max_seq=max_seq)   # warm-up
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        g.capture_begin()
        out = lane._prefill_body(params, toks, max_seq=max_seq)
        g.capture_end()
    torch.cuda.synchronize()
    ops.add_launch_counts({k: before[k] - n
                           for k, n in ops.launch_counts().items()
                           if n != before[k]})
    segs = torch.cuda.memory_snapshot()
    got = None
    if not segs or "segment_pool_id" in segs[0]:
        pid = tuple(g.pool())
        mine = [x for x in segs if tuple(x["segment_pool_id"]) == pid]
        got = (sum(x["total_size"] for x in mine),
               sum(x["allocated_size"] for x in mine))
    del out, g
    torch.cuda.synchronize()
    return got


def _prefill_ms(lane, params, prompt, max_seq=32):
    """(host issue ms, stream span ms, device busy ms) of one batch-1
    admission prefill (``Lane.prefill``) as the paged linear path runs it,
    eager or captured as the lane's rule says; the device time is the
    profiler's per prefill over 2."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn = lambda: lane.prefill(params, prompt, max_seq)
    host, span = _host_device_ms(fn, reps=5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
    return host, span, device_activity(prof)[0] / 2


def _recurrent_prefill_capture(eng, params, prompt):
    """What capturing a recurrent lane's exact-length prefill would cost:
    one capture of ``Lane._prefill_body`` (its warm-up run included)
    against an eager prefill and a replay, at the parity depth."""
    import torch
    from repro_torch.core.capture import capture
    lane = eng.edge
    toks = torch.as_tensor(prompt[None, :-1], device="cuda")
    n = prompt.size - 1
    run = lambda: lane._prefill_body(params, toks, max_seq=n)
    run()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    eager = time.perf_counter() - t
    fn = capture(lane._prefill_body, static_argnames=("max_seq",),
                 copy_argnames=("tokens",), name="recurrent prefill probe")
    t = time.perf_counter()
    fn(params, toks, max_seq=n)
    torch.cuda.synchronize()
    took = time.perf_counter() - t
    t = time.perf_counter()
    fn(params, toks, max_seq=n)
    torch.cuda.synchronize()
    replay = time.perf_counter() - t
    print(f"[graphs] mamba2 recurrent prefill at exact length ({n} entries, "
          f"{lane.model.cfg.num_layers} layers, f32): eager "
          f"{eager * 1e3:.2f} ms; a capture {took * 1e3:.2f} ms (its "
          f"warm-up run included, {fn.capture_seconds * 1e3:.2f} ms by the "
          f"helper); a replay {replay * 1e3:.2f} ms; rule "
          f"{lane.prefill_rule('cuda')!r}", flush=True)


def lengths_graphs():
    """``[graphs] lengths``: the bounds of fault C.3.  One engine per lane
    kind at ``PARITY_DEPTH``, f32, serves drains of ever new prompt
    lengths (``GRAPHS_LENGTHS``, the longest first, each drain its own
    slot_len): after each drain every lane holds at most
    ``MAX_SPARE_STATES`` released states and ``MAX_SPARE_DETACHED``
    detached caches and every captured function at most ``MAX_GRAPHS``
    graphs; ``torch.cuda.memory_allocated()`` less what it was before the
    first drain (the drains' residue) is printed beside what the held
    buffers account for (spares, detached caches, the graphs' static
    buffers).  Then the residue after the last drain must be no higher
    than after the drain at which every lane's spare states first filled
    their bound, plus the slack that the graph bounds still allow past
    that drain: for each function, ``MAX_GRAPHS`` less the graphs it held
    then, times the most one of its graphs held."""
    import gc
    import torch
    from repro_torch.core.capture import MAX_GRAPHS
    from repro_torch.core.seq_state import (MAX_SPARE_DETACHED,
                                            MAX_SPARE_STATES)
    from repro_torch.models import Model
    from repro_torch.models.ssm import tree_leaves
    e_cfg, c_cfg = _configs("smollm-135m", PARITY_DEPTH["smollm-135m"],
                            "float32")
    ep = Model(e_cfg).init(seed=0, device="cuda")
    cp = Model(c_cfg).init(seed=1, device="cuda")

    def nbytes(tree):
        return sum(t.nbytes for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))

    for label, kw in GRAPHS_LENGTHS_ENGINES:
        eng = _engine(e_cfg, c_cfg, use_cache=False, **kw)
        lanes = list({id(x): x for x in (eng.edge, eng.cloud, eng._spec_edge,
                                         eng._spec_cloud)}.values())
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        rows, most = [], {}
        t = time.perf_counter()
        for d, n in enumerate(GRAPHS_LENGTHS):
            eng.serve_batch(ep, cp, _prompts(e_cfg.vocab_size, length=n),
                            GRAPHS_LENGTHS_NEW)
            torch.cuda.synchronize()
            fns = _functions(eng)
            for f in fns:
                for g in f._graphs.values():
                    most[f.name] = max(most.get(f.name, 0), _held_bytes(g))
            spares = [(x.spare_states, x.spare_detached) for x in lanes]
            live = {f.name: f.live_graphs for f in fns}
            held = sum(nbytes(b) for x in lanes
                       for pool in (x._spare, x._detached)
                       for _, b in pool._held.values()) + sum(
                _held_bytes(g) for f in fns for g in f._graphs.values())
            residue = torch.cuda.memory_allocated() - base
            rows.append((spares, live, residue))
            check(all(s <= MAX_SPARE_STATES and dt <= MAX_SPARE_DETACHED
                      for s, dt in spares) and
                  all(v <= MAX_GRAPHS for v in live.values()),
                  f"[graphs] lengths {label}: a bound broken after drain "
                  f"{d}: spares {spares}, graphs {live}")
            print(f"[graphs] lengths {label} drain {d} (prompts of {n}): "
                  f"spares (states, detached) per lane {spares}; graphs "
                  f"{sorted(live.values(), reverse=True)}; memory_allocated "
                  f"residue {residue} B, held by spares and graphs {held} B",
                  flush=True)
        full = [d for d, (sp, _, _) in enumerate(rows)
                if all(s == MAX_SPARE_STATES for s, _ in sp)]
        check(bool(full), f"[graphs] lengths {label}: the spare states never "
              "filled their bound")
        f0 = full[0]
        slack = sum((MAX_GRAPHS - rows[f0][1].get(k, 0)) * b
                    for k, b in most.items())
        last = rows[-1][2]
        check(last <= rows[f0][2] + slack,
              f"[graphs] lengths {label}: residue {last} B after the last "
              f"drain, above {rows[f0][2]} B + slack {slack} B")
        st = eng.stats()
        got = _pool_bytes()
        print(f"[graphs] lengths {label}: the graphs' shared pool "
              + ("not named by this PyTorch" if got is None else
                 f"reserved {got[0]} B, allocated {got[1]} B"), flush=True)
        print(f"[graphs] lengths {label}: {len(GRAPHS_LENGTHS)} drains in "
              f"{time.perf_counter() - t:.1f} s, captures {st['captures']} "
              f"in {st['capture_seconds']:.2f} s; spare states filled "
              f"their bound ({MAX_SPARE_STATES}) at drain {f0}, residue "
              f"{rows[f0][2]} B there and {last} B after the last drain "
              f"(slack the graph bounds allow: {slack} B); graphs held "
              f"at most {max(max(r[1].values()) for r in rows)} per "
              f"function (bound {MAX_GRAPHS}); dropped "
              + ", ".join(f"{f.name} {f.dropped}" for f in _functions(eng)
                          if f.dropped), flush=True)
        del eng
    lap("graphs lengths")


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


def _profile_drain(label, eng, ep, cp, prompts, max_new):
    """Device busy share of one drain, device activity only; the
    profiler's own overhead lengthens the wall time, so the share is a
    lower bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.serve_batch(ep, cp, prompts, max_new)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy, by_name = device_activity(prof)
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:6]
    rounds = eng.stats()["spec_lanes"][eng.spec_mode]["member_rounds"]
    print(f"[breakdown] profiled {label} drain ({len(prompts)} requests, "
          f"{max_new} new, {rounds} member rounds): wall {wall:.0f} ms, "
          f"device busy {busy:.0f} ms ({busy / wall:.1%}); top device time: "
          + "; ".join(f"{k[:60]} {ms:.1f} ms" for k, ms in top), flush=True)


def _round_ms(eng, ep, cp, prompts, cross_check=False):
    """(host issue ms, stream span ms, device busy ms) of ONE speculative
    round of ``eng``'s lane over the 8 prompts, on group states built as
    ``BatchedEngine._spec_escalate`` builds them.  The device time is the
    profiler's kernel time per round over 2 rounds.  ``cross_check``
    prints it beside the profiler's ``key_averages()`` sum of self device
    time over the same events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    G = len(prompts)
    need = [p.size - 1 + 24 + 20 for p in prompts]
    d_state = eng._spec_edge.make_state(ep, G, 80, need_tokens=need)
    states = [d_state]
    if eng.spec_mode != "self":
        states.append(eng._spec_cloud.make_state(cp, G, 80,
                                                 need_tokens=need))
    for st in states:
        for i, (p, n) in enumerate(zip(prompts, need)):
            st.admit(i, p, n)
        st.flush()
        st.prepare_tick(list(range(G)), [n - (p.size - 1) for p, n in
                                         zip(prompts, need)], 1 << 30)
    last = torch.as_tensor([[[int(p[-1])]] for p in prompts],
                           dtype=torch.int32, device="cuda")
    active = torch.ones((G,), dtype=torch.bool, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    caches = [st.caches for st in states]
    if eng.spec_mode == "self":
        fn = lambda: eng.spec._self_round(ep, caches[0], last, active, gen)
    else:
        fn = lambda: eng.spec._round(ep, cp, caches[0], caches[1], last,
                                     active, gen)
    host, span = _host_device_ms(fn, reps=3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
    busy = device_activity(prof)[0] / 2
    if cross_check:
        avg = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
                  for e in prof.key_averages()) / 1e3 / 2
        print(f"[breakdown] device busy per {eng.spec_mode} round: raw "
              f"device events {busy:.3f} ms, key_averages self device time "
              f"{avg:.3f} ms", flush=True)
    return host, span, busy


def phase_breakdown(ep, cp, e_cfg, c_cfg, prompts):
    """Where the full-width serving paths' time goes: the pieces of one
    edge tick step, one linear round and one tree round, timed alone at
    the paths' shapes, one captured round of each smollm path (linear,
    tree, self: host issue, stream span, device busy), and a profiler
    pass over a linear and a tree drain for the device's busy share."""
    import torch
    from repro_torch.core.tree_speculation import TreePlan, branching_for
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    B, bs, MB, T, S = 8, 32, 3, 5, 80
    dev = "cuda"
    plan = TreePlan(branching_for(2, 4))
    mask = torch.as_tensor(plan.mask, device=dev)
    depths = torch.as_tensor(plan.depths, device=dev)
    lo, hi = plan.levels[-2]                      # a draft level, C > T
    rows = {}
    table = (torch.arange(B * MB, device=dev, dtype=torch.int32) + 1) \
        .reshape(B, MB)
    pos = torch.full((B,), 40, dtype=torch.int32, device=dev)
    for name, params, cfg in (("edge", ep, e_cfg), ("cloud", cp, c_cfg)):
        m = Model(cfg)
        cache = m.init_paged_cache(B * MB + 1, bs, B, MB, device=dev)
        cache = {**cache, "table": table, "pos": pos}
        dense = {**m.init_cache(B, S, device=dev), "pos": pos}
        tok = torch.ones((B, 1), dtype=torch.int32, device=dev)
        toks = torch.ones((B, T), dtype=torch.int32, device=dev)
        tree_toks = torch.ones((B, plan.n_pad), dtype=torch.int32, device=dev)
        q_tree = pos.long()[:, None] + depths.long()[None, :]
        if name == "edge":
            rows["edge paged decode step (30 layers, B=8)"] = \
                _host_device_ms(lambda: m.paged_decode_step(params, tok,
                                                            cache))
            rows["edge dense decode step (30 layers, B=8)"] = \
                _host_device_ms(lambda: m.decode_step(params, tok, dense))
            rows[f"edge tree draft level (30 layers, G=8, nodes "
                 f"[{lo},{hi}))"] = _host_device_ms(
                lambda: m.extend_step(
                    params, tree_toks[:, lo:hi], dense,
                    block_mask=mask[lo:hi, :hi],
                    q_positions=pos.long()[:, None]
                    + (depths[lo:hi] - lo).long()[None, :]))
        else:
            rows["cloud verify extend (36 layers, G=8, T=5)"] = \
                _host_device_ms(lambda: m.paged_extend_step(params, toks,
                                                            cache))
            rows["cloud tree verify extend (36 layers, G=8, T=16)"] = \
                _host_device_ms(lambda: m.extend_step(
                    params, tree_toks, dense, block_mask=mask,
                    q_positions=q_tree))
            dt = params.embed.dtype
            x = torch.randn((B, T, cfg.d_model), device=dev).to(dt)
            xt = torch.randn((B, plan.n_pad, cfg.d_model), device=dev).to(dt)
            blk = params.blocks[0]
            rows["cloud verify attention, one layer (gather + mha)"] = \
                _host_device_ms(lambda: L.paged_extend_attention(
                    blk.attn, x, cache["k"][0], cache["v"][0], table, pos,
                    cfg))
            rows["cloud tree verify attention, one layer (kernel)"] = \
                _host_device_ms(lambda: L.extend_attention(
                    blk.attn, xt, dense["k"][0], dense["v"][0], pos, cfg,
                    block_mask=mask, q_positions=q_tree))
            rows["cloud f32 unembed (G=8, T=5)"] = _host_device_ms(
                lambda: L.unembed(params.head, x))
            one = torch.as_tensor(prompts[0][None, :16].astype("int32"),
                                  device=dev)
            rows["cloud prefill, one 16-token prompt"] = _host_device_ms(
                lambda: m.prefill(params, {"tokens": one}))
    for k, (h, d) in rows.items():
        print(f"[breakdown] {k}: host issue {h:.3f} ms, stream span "
              f"{d:.3f} ms", flush=True)
    for name, edge, kw, _ in PATHS:
        if edge != e_cfg.name:
            continue
        eng = _engine(e_cfg, c_cfg, **kw)
        h, d, busy = _round_ms(eng, ep, cp, prompts,
                               cross_check=name == "linear")
        print(f"[breakdown] one {name} round (G=8, "
              f"{eng.spec.graph_rule('cuda')}): host issue {h:.3f} ms, "
              f"stream span {d:.3f} ms, device busy {busy:.3f} ms",
              flush=True)
    # 8 requests, 4 new tokens: one edge tick and 4 speculative rounds
    for label, kw in (("linear", {}), ("tree", PATHS[1][2])):
        _profile_drain(label, _engine(e_cfg, c_cfg, **kw), ep, cp, prompts, 4)


def _per_request_runs(ep, cp, e_cfg, c_cfg, prompts, backend, exit_layer):
    """The per-request paths on two prompts: ``CollaborativeEngine``'s
    ``serve_reference`` with threshold -1 and each escalation (skeleton
    length 4), its ``serve`` (a one-slot ``BatchedEngine``) on fresh
    engines, and on the first prompt ``TreeSpecDecoder`` (3, 2, 1) and
    ``SelfSpecDecoder`` (``exit_layer``), all at T = 0 on ``backend``.
    Returns {name: [RequestTrace, ...]} and {name: seconds}."""
    import torch
    from repro_torch.core.engine import CollaborativeEngine
    from repro_torch.core.policy import policy_from_legacy
    from repro_torch.core.scheduler import RequestTrace
    from repro_torch.core.self_speculative import SelfSpecDecoder
    from repro_torch.core.tree_speculation import TreeSpecDecoder
    from repro_torch.models import Model
    edge, cloud = Model(e_cfg), Model(c_cfg)
    N = PER_REQUEST_NEW
    runs, secs = {}, {}

    def timed(name, fn):
        t = time.perf_counter()
        runs[name] = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t

    for esc in ("speculative", "skeleton", "cloud"):
        def engine():
            return CollaborativeEngine(
                edge, cloud, gamma=4, temperature=0.0, skeleton_len=4,
                policy=policy_from_legacy(esc, -1.0), attn_backend=backend)
        ref, one_slot = engine(), engine()
        timed(esc, lambda: [ref.serve_reference(ep, cp, p, N)
                            for p in prompts[:2]])
        timed(f"serve {esc}", lambda: [one_slot.serve(ep, cp, p, N)
                                       for p in prompts[:2]])

    def tree():
        toks, st = TreeSpecDecoder(edge, cloud, branching=(3, 2, 1),
                                   temperature=0.0,
                                   attn_backend=backend).generate(
            ep, cp, prompts[0], N)
        return [RequestTrace("tree", edge_calls=st["draft_calls"],
                             cloud_passes=st["target_passes"], tokens=toks)]

    def self_spec():
        toks, st = SelfSpecDecoder(edge, exit_layer=exit_layer, gamma=4,
                                   temperature=0.0,
                                   attn_backend=backend).generate(
            ep, prompts[0], N)
        return [RequestTrace("self", edge_calls=st.draft_calls,
                             tokens=toks)]

    timed("tree", tree)
    timed("self", self_spec)
    return runs, secs


def phase_per_request(ep, cp, e_cfg, c_cfg, prompts):
    """The per-request engine and decoders at full width (the dense edge
    and the granite-8b cloud, bfloat16): each run's traces checked, the
    logits finite over the served sequences, and the kernels of
    ``PER_REQUEST_KERNELS`` launched (counts reset just before, read just
    after).  Returns the launch counts."""
    import torch
    from repro_torch.kernels import ops
    V = e_cfg.vocab_size
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    runs, secs = _per_request_runs(ep, cp, e_cfg, c_cfg, prompts, "auto",
                                   exit_layer=15)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    for name, traces in runs.items():
        want = name.split()[-1]
        for i, tr in enumerate(traces):
            check(tr.path == want, f"per-request {name} request {i}: path "
                                   f"{tr.path}, want {want}")
            check(len(tr.tokens) == PER_REQUEST_NEW
                  and all(0 <= t < V for t in tr.tokens),
                  f"per-request {name} request {i}: tokens {tr.tokens}")
        print(f"[per-request] {name}: {len(traces)} request(s) of "
              f"{PER_REQUEST_NEW} new tokens in {secs[name]:.2f}s "
              f"({len(traces) * PER_REQUEST_NEW / secs[name]:.1f} tok/s); "
              f"edge calls {[tr.edge_calls for tr in traces]}, cloud passes "
              f"{[tr.cloud_passes for tr in traces]}", flush=True)
    for k in PER_REQUEST_KERNELS:
        check(launches[k] > 0,
              f"kernel {k} was not launched on the per-request phase")
    print(f"[per-request] launches {launches}", flush=True)
    _check_finite(ep, cp, e_cfg, c_cfg, prompts[:2], runs["speculative"])
    return launches


def _first_divergence(a_tokens, b_tokens) -> int:
    return next(k for k, (x, y) in enumerate(zip(a_tokens, b_tokens))
                if x != y)


def _top2_gap(prompt, tokens, params, cfg) -> float:
    """The plain model's top-2 logit gap at the token after ``prompt`` +
    ``tokens``."""
    import torch
    from repro_torch.models import Model
    seq = torch.as_tensor([list(prompt) + tokens], device="cuda")
    logits, _ = Model(cfg).forward(params, {"tokens": seq},
                                   attn_backend="plain")
    top2 = logits[0, -1].topk(2).values
    return float(top2[0] - top2[1])


def parity_per_request(ep, cp, e_cfg, c_cfg, prompts):
    """The per-request runs at float32 and cut depth, on the kernels and on
    the plain versions: identical traces, a divergence excused only where
    the model that chose the token has a plain top-2 gap below 1e-4 (the
    cloud's greedy output on the speculative, cloud and tree runs and the
    skeleton's first 4 tokens; the edge's after them and on the self
    run)."""
    runs = {b: _per_request_runs(ep, cp, e_cfg, c_cfg, prompts, b,
                                 exit_layer=1)[0]
            for b in ("auto", "plain")}
    same = excused = 0
    for name, traces in runs["auto"].items():
        for i, (a, b) in enumerate(zip(traces, runs["plain"][name])):
            if (a.tokens, a.path) == (b.tokens, b.path):
                same += 1
                continue
            check(a.path == b.path, f"per-request {name} request {i}: path "
                                    f"{a.path} vs plain {b.path}")
            j = _first_divergence(a.tokens, b.tokens)
            edge_chose = name == "self" or (name.endswith("skeleton")
                                            and j >= 4)
            params, cfg = (ep, e_cfg) if edge_chose else (cp, c_cfg)
            gap = _top2_gap(prompts[i], b.tokens[:j], params, cfg)
            print(f"[parity] per-request {name} request {i} diverges at "
                  f"token {j}: plain top-2 gap {gap:.3e}", flush=True)
            check(gap < GAP_TOL, f"per-request {name} request {i}: "
                                 f"divergence at token {j} with a top-2 gap "
                                 f"{gap} >= {GAP_TOL}")
            excused += 1
    print(f"[parity] per-request phase, float32 full-width "
          f"({e_cfg.num_layers}-layer {e_cfg.name} + {c_cfg.num_layers}-layer "
          f"granite-8b), kernels vs plain: {same}/{same + excused} traces "
          f"identical, {excused} near-tie divergences", flush=True)


# --------------------------------------------------------------- phase 3b
# the learning paths at full width: serve-time adaptation (smollm-135m
# edge, granite-8b cloud, bfloat16, batch 8, 16-token prompts, 24 new
# tokens, ADAPT_DRAINS drains) — distill behind cloud escalation (teacher
# top-k captured), lora on the default speculative lane — each with the
# kernels it must launch, then the offline trainer
ADAPT_PATHS = (
    ("adapt distill", "threshold",
     {"mode": "distill", "interval": 8, "topk": 8},
     ("paged_decode_attention", "flash_attention", "flash_attention_bwd")),
    ("adapt lora", "speculative", {"mode": "lora", "interval": 8},
     ("paged_decode_attention", "flash_attention", "spec_verify",
      "flash_attention_bwd")),
)
ADAPT_DRAINS = 3
TRAIN_ARGS = ["--arch", "smollm-135m", "--steps", "30", "--batch", "8",
              "--seq", "256"]


def _adapt_path(name, policy, akw, kernels, ep, cp, e_cfg, c_cfg, prompts):
    import math
    import torch
    from repro_torch.core.adaptation import AdaptationLoop
    from repro_torch.core.policy import make_policy
    from repro_torch.core.scheduler import BatchedEngine
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.training import tree as T
    loop = AdaptationLoop(**akw)
    eng = BatchedEngine(Model(e_cfg), Model(c_cfg), batch_size=8, gamma=4,
                        temperature=0.0,
                        policy=make_policy(policy, threshold=0.6),
                        adaptation=loop)
    V = e_cfg.vocab_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    for d in range(ADAPT_DRAINS):
        # new prompts each drain: repeats would be semantic-cache hits
        traces = eng.serve_batch(ep, cp, prompts[8 * d:8 * d + 8], 24)
        for i, tr in enumerate(traces):
            check(tr.tokens is not None and len(tr.tokens) == 24
                  and all(0 <= x < V for x in tr.tokens),
                  f"{name} drain {d} request {i}: bad tokens")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = ops.launch_counts()
    st = loop.stats()
    paths = {}
    for tr in traces:
        paths[tr.path] = paths.get(tr.path, 0) + 1
    check(st["swaps"] >= 1, f"{name}: no hot swap in {ADAPT_DRAINS} drains")
    check(st["last_loss"] is not None and math.isfinite(st["last_loss"]),
          f"{name}: last loss {st['last_loss']}")
    for k in kernels:
        check(launches[k] > 0, f"kernel {k} was not launched on the {name} "
                               "path")
    served = T.leaves(ep)
    swapped = T.leaves(loop.latest)
    check([n for n, _ in swapped] == [n for n, _ in served],
          f"{name}: the swapped tree differs from the serving tree")
    for (n, a), (_, b) in zip(swapped, served):
        check((a.shape, a.dtype, a.device) == (b.shape, b.dtype, b.device)
              and not a.requires_grad,
              f"{name}: swapped {n} is {a.shape} {a.dtype} {a.device}")
    if policy == "threshold":
        check(all(r.teacher_values is not None
                  for r in loop.store.records()),
              f"{name}: a cloud completion carried no teacher top-k")
    mem = torch.cuda.max_memory_allocated() / 2**30
    # one more update, timed: the batch from the store, the step, the merge
    def update():
        loop._pending = True
        loop.maybe_update(loop.current(ep))
    host, span = _host_device_ms(update, reps=3)
    print(f"[learn] {name} path (smollm-135m edge, granite-8b cloud, "
          f"{ADAPT_DRAINS} drains of 8 requests): "
          f"{ADAPT_DRAINS * 8 / dt:.2f} req/s over {dt:.2f}s; last drain's "
          f"paths {paths}; swaps "
          f"{st['swaps']}, train steps {st['train_steps']}, last loss "
          f"{st['last_loss']:.4f}, store {st['store_size']}; one update: "
          f"host issue {host:.1f} ms, stream span {span:.1f} ms; "
          f"max_memory_allocated {mem:.2f} GiB; launches {launches}",
          flush=True)
    return launches


def _train_runs():
    """``launch/train.py`` on full-width smollm-135m, plain and --remat."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import main as train_main
    out = []
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = train_main(TRAIN_ARGS + (["--remat"] if remat else []))
        launches = ops.launch_counts()
        h = res["history"]
        mem = torch.cuda.max_memory_allocated() / 2**30
        label = "--remat" if remat else "plain"
        check(h[-1][1] < h[0][1], f"trainer {label}: loss {h[0][1]} at step "
                                  f"{h[0][0]} -> {h[-1][1]} at {h[-1][0]}")
        for k in ("flash_attention", "flash_attention_bwd"):
            check(launches[k] > 0, f"kernel {k} was not launched by the "
                                   f"trainer ({label})")
        # bf16 smollm-135m (hd 64): every backward on the wgmma route
        check(launches["flash_attention_bwd/wgmma"]
              == launches["flash_attention_bwd"],
              f"trainer ({label}): backward routes {launches}")
        print(f"[learn] trainer {label} (smollm-135m, batch 8, seq 256, "
              f"{res['steps']} steps): loss {h[0][1]:.4f} -> {h[-1][1]:.4f}; "
              f"{res['seconds'] / res['steps'] * 1e3:.1f} ms/step, "
              f"{res['tokens'] / res['seconds']:.0f} tokens/s; "
              f"max_memory_allocated {mem:.2f} GiB; launches {launches}",
              flush=True)
        out.append(launches)
    return out


# the trainer on every other family the port serves, at full width: the
# moe, ssm, xlstm and hybrid families, batch 8, seq 256, FAMILY_STEPS steps
# (a batch that does not fit in the card's memory is halved until it does,
# and the cut printed), then mamba2-370m once more with --remat.  Each
# run's loss must fall, and every step must launch the scan kernel forward
# and backward once per scan layer (the forward twice with --remat), so no
# plain scan ran under grad, and the flash kernels once per attention layer
FAMILY_TRAIN = (("granite-moe-1b-a400m", False), ("mamba2-370m", False),
                ("xlstm-125m", False), ("zamba2-2.7b", False),
                ("mamba2-370m", True), ("whisper-small", False),
                ("paligemma-3b", False))
FAMILY_STEPS = 10
# rows per batch row where it is not 256: paligemma-3b's 256 image rows +
# 256 text tokens
FAMILY_SEQ = {"paligemma-3b": 512}


def _layer_counts(cfg):
    """(scan layers, attention reads) of one forward of ``cfg``."""
    from repro_torch.models.xlstm import is_slstm
    L = cfg.num_layers
    return {"dense": (0, L), "moe": (0, L), "vlm": (0, L), "ssm": (L, 0),
            "encdec": (0, cfg.encoder_layers + 2 * L),
            "xlstm": (sum(not is_slstm(cfg, l) for l in range(L)), 0),
            "hybrid": (L, L // max(1, cfg.shared_attn_every))}[cfg.family]


def _family_train_runs():
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_bwd_plan
    from repro_torch.launch.train import main as train_main
    out = []
    for arch, remat in FAMILY_TRAIN:
        batch = 8
        while True:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            try:
                res = train_main(["--arch", arch, "--steps",
                                  str(FAMILY_STEPS), "--batch", str(batch),
                                  "--seq", str(FAMILY_SEQ.get(arch, 256))]
                                 + (["--remat"] if remat else []))
                break
            except torch.cuda.OutOfMemoryError:
                check(batch > 1, f"trainer {arch}: batch 1 does not fit")
                print(f"[learn] trainer {arch}: batch {batch} does not fit "
                      f"in the card's memory; cut to {batch // 2}",
                      flush=True)
                batch //= 2
        launches = ops.launch_counts()
        mem = torch.cuda.max_memory_allocated() / 2**30
        h, steps = res["history"], res["steps"]
        cfg = get_config(arch)
        n_scan, n_attn = _layer_counts(cfg)
        fwd = 2 if remat else 1
        label = f"{arch}{' --remat' if remat else ''}"
        check(h[-1][1] < h[0][1], f"trainer {label}: loss {h[0][1]} at step "
                                  f"{h[0][0]} -> {h[-1][1]} at {h[-1][0]}")
        check(launches["ssd_chunk_scan"] == fwd * n_scan * steps
              and launches["ssd_chunk_scan_bwd"] == n_scan * steps,
              f"trainer {label}: scan launches {launches} for {n_scan} scan "
              f"layers x {steps} steps")
        # bf16 trainers: every scan backward on the tensor-core route
        check(launches["ssd_chunk_scan_bwd/mma"]
              == launches["ssd_chunk_scan_bwd"],
              f"trainer {label}: scan backward routes {launches}")
        check(launches["flash_attention"] == fwd * n_attn * steps
              and launches["flash_attention_bwd"] == n_attn * steps,
              f"trainer {label}: flash launches {launches} for {n_attn} "
              f"attention layers x {steps} steps")
        # bf16 trainers: every flash backward on its tensor-core route
        # (wgmma256 at paligemma's hd 256, wgmma below), none on the CUDA
        # cores
        route = flash_bwd_plan(torch.bfloat16, cfg.head_dim, 1, 1, 1, True,
                               0).route
        check(launches[f"flash_attention_bwd/{route}"]
              == launches["flash_attention_bwd"]
              and launches["flash_attention_bwd/cuda_cores"] == 0,
              f"trainer {label}: flash backward routes {launches}")
        print(f"[learn] trainer {label} (batch {batch}, seq "
              f"{FAMILY_SEQ.get(arch, 256)}, {steps} "
              f"steps): loss {h[0][1]:.4f} -> {h[-1][1]:.4f}; "
              f"{res['seconds'] / steps * 1e3:.1f} ms/step, "
              f"{res['tokens'] / res['seconds']:.0f} tokens/s; "
              f"max_memory_allocated {mem:.2f} GiB; launches {launches}",
              flush=True)
        del res
        out.append(launches)
    return out


# --------------------------------------------------------------- phase 3b
# The stub-input families through the Model API at full width, bfloat16,
# batch 8, seeded random weights and random-normal stub inputs (the
# serving engine prefills with tokens alone and does not serve them, as in
# the JAX package): a 16-token prompt, STUB_NEW greedy decode steps and one
# 4-token extend; for paligemma-3b also a text-only paged extend + 8 paged
# decode steps and split inference at k = 9 with an int8 boundary
STUB_NEW = 24
STUB_PROMPT = 16


def _step_breakdown(fn, reps=5):
    """(host issue ms, stream span ms, device busy ms) of one call of
    ``fn``: ``_host_device_ms``, then a profiler pass for the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    host, span = _host_device_ms(fn, reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return host, span, device_activity(prof)[0] / reps


def _stub_run(m, p, batch, label):
    """Prefill, STUB_NEW greedy decode steps and one 4-token extend of the
    last four tokens, each timed on the host clock around a synchronise;
    the logits are checked finite and shaped.  Returns (the greedy tokens
    (B, STUB_NEW), (prefill, decode, extend) seconds)."""
    import torch
    V = m.cfg.vocab_size
    B = batch["tokens"].shape[0]
    sync = torch.cuda.synchronize
    sync()
    t0 = time.perf_counter()
    lg, cache = m.prefill(p, batch, max_seq=batch["tokens"].shape[1]
                          + (m.cfg.num_image_tokens if "embeds" in batch
                             else 0) + STUB_NEW + 8)
    sync()
    t1 = time.perf_counter()
    toks = []
    for _ in range(STUB_NEW):
        check(lg.shape == (B, V) and bool(torch.isfinite(lg).all()),
              f"{label}: logits {tuple(lg.shape)} not finite (B, V)")
        tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
        toks.append(tok)
        lg, cache = m.decode_step(p, tok, cache)
    sync()
    t2 = time.perf_counter()
    ext, cache = m.extend_step(p, torch.cat(toks[-4:], 1), cache)
    sync()
    t3 = time.perf_counter()
    check(ext.shape == (B, 4, V) and bool(torch.isfinite(ext).all()),
          f"{label}: extend logits not finite (B, 4, V)")
    toks = torch.cat(toks, 1)
    check(bool(((toks >= 0) & (toks < V)).all()), f"{label}: bad token")
    return toks, (t1 - t0, t2 - t1, t3 - t2)


def _stub_family(arch, stub_shape):
    """One stub-input family's Model-API path at full width; returns the
    run's kernel launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    cfg = get_config(arch)
    m = Model(cfg)
    p = _init(cfg, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    B = 8
    key = "frames" if cfg.family == "encdec" else "embeds"
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, STUB_PROMPT),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32),
             key: torch.randn((B,) + stub_shape, generator=gen,
                              device="cuda").to(torch.bfloat16)}
    _stub_run(m, p, batch, arch)                  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    toks, (tp, td, te) = _stub_run(m, p, batch, arch)
    launches = ops.launch_counts()
    L = cfg.num_layers
    # the extend's self attention reads the tree-verify kernel under a
    # causal block mask
    if cfg.family == "encdec":
        # encoder + decoder self + cross (prefill), cross (extend); every
        # decode read, self and cross, on the dense decode kernel
        want = {"flash_attention": cfg.encoder_layers + 3 * L,
                "decode_attention": STUB_NEW * 2 * L,
                "tree_verify_attention": L}
    else:
        want = {"flash_attention": L, "decode_attention": STUB_NEW * L,
                "tree_verify_attention": L}
    for k, n in want.items():
        check(launches[k] == n, f"[{cfg.family}] {k}: {launches[k]} "
                                f"launches, want {n}")
    mem = torch.cuda.max_memory_allocated() / 2**30
    tok = toks[:, -1:]
    _, cache = m.prefill(p, batch, max_seq=400)
    host, span, busy = _step_breakdown(
        lambda: m.decode_step(p, tok, cache))
    print(f"[{cfg.family}] {arch} (batch {B}, {STUB_PROMPT}-token prompt, "
          f"{key} {tuple(batch[key].shape)}, bfloat16): prefill {tp * 1e3:.1f}"
          f" ms; {STUB_NEW} greedy decode steps {td / STUB_NEW * 1e3:.2f} ms "
          f"per step ({B * STUB_NEW / td:.0f} tokens/s, "
          f"{td / STUB_NEW / B * 1e3:.3f} ms per token); 4-token extend "
          f"{te * 1e3:.1f} ms; one decode step: host issue {host:.2f} ms, "
          f"stream span {span:.2f} ms, device busy {busy:.2f} ms; "
          f"max_memory_allocated {mem:.2f} GiB; launches {launches}",
          flush=True)
    if cfg.family == "vlm":
        launches = _vlm_paged_and_split(m, p, batch, launches)
    del p, cache
    torch.cuda.empty_cache()
    return launches


def _vlm_paged_and_split(m, p, batch, launches):
    """paligemma-3b: a text-only paged extend of the prompt and 8 paged
    decode steps (the paged-decode kernel at hd 256, Kv 1, G 8), then
    split inference at k = 9 — identity (bit-equal to the unsplit forward)
    and an int8 boundary (its wire bytes and logit error)."""
    import torch
    from repro_torch.core.compression import Int8Quantizer
    from repro_torch.core.partition import split_inference
    from repro_torch.kernels import ops
    cfg = m.cfg
    B, bs, MB = 8, 32, 2
    ops.reset_launch_counts()
    pc = m.init_paged_cache(B * MB + 1, bs, B, MB, device="cuda")
    pc["table"] = torch.arange(1, B * MB + 1, device="cuda",
                               dtype=torch.int32).reshape(B, MB)
    lg, pc = m.paged_extend_step(p, batch["tokens"], pc)
    lg = lg[:, -1]
    for _ in range(8):
        lg, pc = m.paged_decode_step(
            p, torch.argmax(lg, -1).to(torch.int32)[:, None], pc)
    torch.cuda.synchronize()
    paged = ops.launch_counts()
    # the extend reads one paged-decode row per new token: one launch a
    # layer, then one a layer for each decode step
    check(paged["paged_decode_attention"] == 9 * cfg.num_layers,
          f"[vlm] paged extend + decode launches {paged}")
    check(bool(torch.isfinite(lg).all()), "[vlm] paged logits not finite")
    ops.reset_launch_counts()
    full = m.forward(p, batch)[0]
    ident, w_id = split_inference(m, p, batch, 9)
    check(torch.equal(ident, full), "[vlm] identity split differs from the "
                                    "unsplit forward")
    del ident
    lg8, w8 = split_inference(m, p, batch, 9, Int8Quantizer())
    err = float((lg8 - full).abs().max())
    rel = float((lg8 - full).norm() / full.norm())
    split = ops.launch_counts()
    check(rel < 0.05, f"[vlm] int8 split relative logit error {rel}")
    check(split["flash_attention"] == 3 * cfg.num_layers,
          f"[vlm] split launches {split}")
    print(f"[vlm] paged: text-only extend of {STUB_PROMPT} tokens + 8 paged "
          f"decode steps, launches {paged}; split inference at k = 9: "
          f"identity bit-equal to the unsplit forward ({w_id} wire bytes), "
          f"int8 {w8} wire bytes, max |logit - unsplit| {err:.4f}, relative "
          f"error {rel:.5f}", flush=True)
    del full, lg8
    out = dict(launches)
    for d in (paged, split):
        for k, n in d.items():
            out[k] += n
    return out


def phase_stub_families(total):
    """The [encdec] and [vlm] paths (whisper-small, paligemma-3b); adds
    their launches to ``total``."""
    for arch, shape in (("whisper-small", (1500, 768)),
                        ("paligemma-3b", (256, 2048))):
        for k, n in _stub_family(arch, shape).items():
            total[k] += n


def _train_breakdown(arch="smollm-135m"):
    """Where a full-width training step of ``arch`` goes (its trainer's
    config, bfloat16, batch 8, seq 256 — paligemma-3b's 512 of
    ``FAMILY_SEQ`` —, AdamW): host issue against stream span of one step,
    and a profiler pass over 3 steps for the device's busy share and its
    top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import batches
    from repro_torch.models import Model
    from repro_torch.training import AdamW, make_train_step
    seq = FAMILY_SEQ.get(arch, 256)
    e_cfg = get_config(arch)
    m = Model(e_cfg)
    p = m.init(seed=0, device="cuda")
    opt = AdamW()
    state = [p, opt.init(p, e_cfg)]
    step = make_train_step(m, opt)
    batch = next(batches(e_cfg, 8, seq, device="cuda"))

    def one():
        state[0], state[1], _ = step(state[0], state[1], batch)

    host, span = _host_device_ms(one, reps=5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(3):
            one()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / 3
    busy, by_name = device_activity(prof)
    busy /= 3
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:8]
    print(f"[breakdown] one train step ({arch}, batch 8, seq {seq}): host "
          f"issue {host:.1f} ms, stream span {span:.1f} ms; profiled: wall "
          f"{wall:.1f} ms, device busy {busy:.1f} ms ({busy / wall:.1%}); "
          "top device time per step: "
          + "; ".join(f"{k[:50]} {ms / 3:.2f} ms" for k, ms in top),
          flush=True)


def _train_step_parity(arch="smollm-135m", cfg=None):
    """One train step at float32, full width, 2 layers: through the
    kernels (flash, or the SSD scan, forward and backward) against
    ``attn_backend="plain"`` (autograd through ``mha`` or the plain scan).
    Tolerances: loss 1e-5 and grad norm 1e-4 relative, the updated params
    1e-5 absolute — the step's AdamW takes eps = 1e-3 so that its first
    update g / (|g| + eps) is smooth in g (at 1e-8 it is sign(g), which
    float32 noise flips on gradients within rounding of zero)."""
    import torch
    from repro_torch.models import Model
    from repro_torch.models.model import example_batch
    from repro_torch.training import AdamW, make_train_step
    from repro_torch.training import tree as T
    e_cfg = cfg if cfg is not None else _configs(arch, (2, 2), "float32")[0]
    m = Model(e_cfg)
    p = m.init(seed=0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    batch = example_batch(e_cfg, 8, 64, gen, device="cuda")
    res = {}
    for backend in ("auto", "plain"):
        opt = AdamW(lr=1e-3, eps=1e-3)
        step = make_train_step(
            m, opt, donate=False,
            loss_fn=lambda pp, b, be=backend: m.loss(pp, b, attn_backend=be))
        res[backend] = step(p, opt.init(p, e_cfg), batch)
    (pk, _, mk), (pp, _, mp) = res["auto"], res["plain"]
    dl = abs(float(mk["loss"]) - float(mp["loss"]))
    dn = abs(float(mk["grad_norm"]) - float(mp["grad_norm"]))
    dp = max(max_err(a, b) for a, b in zip(T.tensors(pk), T.tensors(pp)))
    print(f"[parity] one train step, float32 full-width 2-layer {arch} "
          f"(batch 8, seq 64), kernels vs plain: loss "
          f"{float(mk['loss']):.6f} (diff {dl:.2e}), grad norm "
          f"{float(mk['grad_norm']):.4f} (diff {dn:.2e}), updated params max "
          f"diff {dp:.2e}", flush=True)
    check(dl <= 1e-5 * float(mp["loss"]), f"train-step loss diff {dl}")
    check(dn <= 1e-4 * float(mp["grad_norm"]), f"grad norm diff {dn}")
    check(dp <= 1e-5, f"updated params differ by {dp}")


def phase_learn(total):
    """The learning half on the card: both adaptation paths, the trainer
    (smollm-135m plain and --remat, then every other served family), and
    the float32 train-step parities; adds every path's launches to
    ``total``."""
    import torch
    e_cfg, c_cfg = _configs("smollm-135m")
    ep, cp = _init(e_cfg, 0), _init(c_cfg, 1)
    prompts = _prompts(e_cfg.vocab_size, 8 * ADAPT_DRAINS)
    for name, policy, akw, kernels in ADAPT_PATHS:
        for k, n in _adapt_path(name, policy, akw, kernels, ep, cp, e_cfg,
                                c_cfg, prompts).items():
            total[k] += n
        lap(name)
    del ep, cp
    torch.cuda.empty_cache()
    for launches in _train_runs():
        for k, n in launches.items():
            total[k] += n
    lap("trainer smollm-135m")
    for launches in _family_train_runs():
        for k, n in launches.items():
            total[k] += n
    lap("family trainers")
    for arch in ("smollm-135m", "mamba2-370m", "paligemma-3b"):
        torch.cuda.empty_cache()
        _train_breakdown(arch)
    lap("train-step breakdowns")
    torch.cuda.empty_cache()
    for arch in ("smollm-135m", "mamba2-370m", "xlstm-125m"):
        _train_step_parity(arch)


def _stub_parity(arch):
    """A stub-input family at float32, full width, 2 layers (and a 2-layer
    encoder), batch 8: the greedy run of ``_stub_run`` on the kernels,
    then the plain versions teacher-forced on the same tokens — every
    step's logits within 1e-4, every greedy token the plain argmax unless
    the plain top-2 gap is below GAP_TOL — and one train step's loss,
    gradient norm and updated parameters (``_train_step_parity``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import example_batch
    cfg = get_config(arch).replace(num_layers=2, param_dtype="float32",
                                   activ_dtype="float32")
    if cfg.family == "encdec":
        cfg = cfg.replace(encoder_layers=2)
    m = Model(cfg)
    p = m.init(seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = example_batch(cfg, 8, cfg.num_image_tokens + STUB_PROMPT, gen,
                          with_labels=False, device="cuda")
    steps = {}
    for backend in ("auto", "plain"):
        lg, cache = m.prefill(p, batch, max_seq=400, attn_backend=backend)
        out = [lg]
        toks = steps["auto"][1] if backend == "plain" else []
        for i in range(STUB_NEW):
            if backend == "auto":
                toks.append(torch.argmax(lg, -1).to(torch.int32)[:, None])
            lg, cache = m.decode_step(p, toks[i], cache,
                                      attn_backend=backend)
            out.append(lg)
        ext, _ = m.extend_step(p, torch.cat(toks[-4:], 1), cache,
                               attn_backend=backend)
        steps[backend] = (out + [ext[:, j] for j in range(4)], toks)
    err = max(max_err(a, b) for a, b in zip(steps["auto"][0],
                                             steps["plain"][0]))
    near = 0
    for i, tok in enumerate(steps["auto"][1]):
        pl = steps["plain"][0][i]
        same = torch.argmax(pl, -1).to(torch.int32) == tok[:, 0]
        if not bool(same.all()):
            top2 = pl[~same].topk(2, dim=-1).values
            gap = float((top2[:, 0] - top2[:, 1]).max())
            check(gap < GAP_TOL, f"{arch} parity: greedy token {i} differs "
                                 f"with a plain top-2 gap {gap}")
            near += int((~same).sum())
    print(f"[parity] {arch} float32 full-width 2-layer Model API (batch 8, "
          f"prefill + {STUB_NEW} greedy decode steps + a 4-token extend), "
          f"kernels vs plain teacher-forced: max |logit diff| {err:.2e}, "
          f"{near} near-tie token differences", flush=True)
    check(err <= 1e-4, f"{arch} parity: logits differ by {err}")
    del p, steps
    torch.cuda.empty_cache()
    _train_step_parity(arch, cfg)


# --------------------------------------------------------------- phase 3c
# Sharded serving on one card: four ranks (processes) at (data 2, model 2)
# over gloo, the ranks sharing the card.  The edges at full depth, the
# granite-8b cloud at full width cut to MESH_CLOUD_LAYERS layers (its FSDP
# gathers cross gloo every layer of every forward); the moe edge's prompts
# make one 4096-token prefill, which takes the expert-parallel branch; the
# float32 parity of each MESH_PARITY path at PARITY_DEPTH and
# MESH_PARITY_NEW new tokens against the unsharded engine in this process.
MESH_SHAPE = (2, 2)
MESH_CLOUD_LAYERS = 1
MESH_KERNELS = ("paged_decode_attention", "flash_attention", "spec_verify")
MESH_MOE = dict(n=4, prompt=4097, new=8)
MESH_PARITY_NEW = 4
# new tokens of each bf16 drain on the mesh (as many as its parity's)
MESH_NEW = 4
# the other lanes and layouts on the mesh, served as their ``PATHS`` entries
# (the same engine settings, the kernels each must launch on every rank):
# the tree lane on dense states, the self lane, the recurrent mamba2 edge
MESH_LANES = ("tree", "self", "mamba2")
MESH_PARITY = ("linear",) + MESH_LANES
# the paths that finish sharded serving, with the smollm-135m edge: name,
# cloud, engine settings (stateful objects made fresh per engine by
# ``_fresh_opts``), the kernels every rank must launch.  Each wave's
# escalations alternate between a cloud regeneration (the cloud's paged
# decode steps at its local heads) and speculative rounds.  Serve-time
# adaptation (``--adapt distill``, on the linear path's models: 8 requests
# through 4 slots and an update due every 4 completions, so the second
# wave serves on swapped weights; the update distills the regenerations'
# top-k teacher logits); a moe cloud (olmoe-1b-7b: its 64 experts over
# 'model') and a cloud whose one kv head does not divide 'model'
# (granite-20b: its 48 query heads split, its K/V computed whole on every
# rank and cached split on the head dim), both at full width cut to
# MESH_CLOUD_LAYERS layers.  Each drain serves MESH_NEW new tokens; each
# path has its float32 parity
MESH_EXTRA = (
    ("adapt distill", "granite-8b",
     {"batch_size": 4, "mixed": True,
      "adapt": {"mode": "distill", "interval": 4, "topk": 8}},
     MESH_KERNELS + ("flash_attention_bwd",)),
    ("olmoe cloud", "olmoe-1b-7b", {"mixed": True}, MESH_KERNELS),
    ("granite-20b cloud", "granite-20b", {"mixed": True}, MESH_KERNELS),
)


def _mixed_policy():
    """``ThresholdPolicy(-1)`` whose retirement waves send every other
    request to a cloud regeneration and the rest to speculative rounds."""
    from repro_torch.core.policy import ThresholdPolicy

    class Mixed(ThresholdPolicy):
        name = "mixed"

        def decide(self, unc, steps, budget):
            return ["cloud" if i % 2 == 0 else "speculative"
                    for i in range(len(unc))]
    return Mixed(-1.0)


def _fresh_opts(kw):
    """A ``MESH_EXTRA`` path's engine keywords with fresh stateful
    objects: its adaptation loop and its policy."""
    from repro_torch.core.adaptation import AdaptationLoop
    kw = dict(kw)
    if kw.pop("mixed", False):
        kw["policy"] = _mixed_policy()
    if "adapt" in kw:
        kw["adaptation"] = AdaptationLoop(**kw.pop("adapt"))
    return kw


def _mesh_drain(mesh, e_cfg, c_cfg, ep, cp, prompts, max_new,
                profile=False, **kw):
    """One timed drain on the mesh: (traces, stats, launches, per-tick and
    per-round host issue and stream span, per-round collective bytes,
    wall s).  ``profile``: rank 0 also sums its device activity over the
    drain (``torch.profiler``; its overhead lengthens the wall, so the
    busy share is a lower bound) into ``timing["busy_ms"]``, after a
    2-token warm-up drain on every rank that rank 0 runs in the
    profiler's warm-up step, which takes the profiler's start-up and the
    process's first tick."""
    import torch
    from repro_torch.core.policy import SpeculativePolicy
    from repro_torch.core.scheduler import BatchedEngine
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    opts = dict(batch_size=8, gamma=4, temperature=0.0,
                policy=SpeculativePolicy(0.6), kv_layout="auto")
    opts.update(kw)
    prof = None
    if profile:
        if mesh.rank == 0:
            from torch.profiler import ProfilerActivity, schedule
            prof = torch.profiler.profile(
                activities=[ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1))
            prof.__enter__()
        BatchedEngine(Model(e_cfg), Model(c_cfg), mesh=mesh,
                      **opts).serve_batch(ep, cp, prompts, 2)
        torch.cuda.synchronize()
        if prof is not None:
            prof.step()
    eng = BatchedEngine(Model(e_cfg), Model(c_cfg), mesh=mesh, **opts)
    timing = {"tick": [], "round": [], "round_bytes": []}

    def timed(fn, key):
        def run(*a, **k):
            before = dict(mesh.moved)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            h = time.perf_counter()
            t0.record()
            out = fn(*a, **k)
            t1.record()
            host = (time.perf_counter() - h) * 1e3
            t1.synchronize()
            timing[key].append((host, t0.elapsed_time(t1)))
            if key == "round":
                timing["round_bytes"].append(
                    {k: n - before.get(k, 0) for k, n in mesh.moved.items()
                     if n != before.get(k, 0)})
            return out
        return run

    eng.edge.chunk = timed(eng.edge.chunk, "tick")
    eng.spec._round = timed(eng.spec._round, "round")
    eng.spec._self_round = timed(eng.spec._self_round, "round")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t = time.perf_counter()
    traces = eng.serve_batch(ep, cp, prompts, max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if prof is not None:
        prof.__exit__(None, None, None)
        timing["busy_ms"] = device_activity(prof)[0]
    launches = ops.launch_counts()
    return traces, eng.stats(), launches, timing, wall


def _mesh_rank(rank, plan):
    """One rank of the [mesh] phase (a spawned process; imports only the
    port).  Returns its tokens, stats, launches and timings."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import init_placed
    from repro_torch.models import Model
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_host_mesh(*MESH_SHAPE, device=dev)
    out = {"rank": rank, "coords": mesh.coords, "backend": mesh.backend}
    t0 = time.perf_counter()

    def note(what):
        if rank == 0:
            print(f"[mesh] rank 0: {what} at {time.perf_counter() - t0:.1f}s",
                  flush=True)

    def pair(edge, layers=None, dtype=None, cloud="granite-8b"):
        e_cfg, c_cfg = _configs(edge, layers, dtype, cloud)
        if layers is None:
            c_cfg = c_cfg.replace(num_layers=MESH_CLOUD_LAYERS)
        ep = Model(e_cfg).init(seed=0, device=dev)
        cp = init_placed(Model(c_cfg), 1, mesh, dev)
        return e_cfg, c_cfg, ep, cp

    def drain(name, e_cfg, c_cfg, ep, cp, prompts, max_new, **kw):
        res = _mesh_drain(mesh, e_cfg, c_cfg, ep, cp, prompts, max_new,
                          **kw)
        note(f"{name} drain done ({res[4]:.1f}s)")
        return res

    def lane(name, e_cfg, c_cfg, ep, cp):
        prompts = _prompts(e_cfg.vocab_size)
        traces, st, launches, timing, wall = drain(
            name, e_cfg, c_cfg, ep, cp, prompts, MESH_NEW,
            **paths[name][2])
        out["lanes"][name] = {
            "tokens": [tr.tokens for tr in traces],
            "paths": [tr.path for tr in traces], "stats": st,
            "launches": launches, "timing": timing, "wall": wall}

    def extra(name, e_cfg, c_cfg, ep, cp):
        """A ``MESH_EXTRA`` drain: as ``lane``, plus what the path shows of
        itself on this rank (the loop's stats and teacher-carrying
        records, the cloud's local heads and experts)."""
        kw = _fresh_opts(extras[name][2])
        prompts = _prompts(e_cfg.vocab_size)
        traces, st, launches, timing, wall = drain(
            name, e_cfg, c_cfg, ep, cp, prompts, MESH_NEW, **kw)
        loop = kw.get("adaptation")
        blk = cp.blocks[0]
        out["lanes"][name] = {
            "tokens": [tr.tokens for tr in traces],
            "paths": [tr.path for tr in traces], "stats": st,
            "launches": launches, "timing": timing, "wall": wall,
            "teachers": None if loop is None else sum(
                r.teacher_values is not None for r in loop.store.records()),
            "heads": (cp.tp.cfg.num_heads, cp.tp.cfg.num_kv_heads,
                      cp.tp.attn_heads),
            "experts": None if blk.moe is None else
            tuple(blk.moe["w_up"].shape)}

    paths = {p[0]: p for p in PATHS}
    extras = {p[0]: p for p in MESH_EXTRA}
    out["lanes"] = {}
    # ---- the default path: paged KV, linear lane, bf16
    e_cfg, c_cfg, ep, cp = pair("smollm-135m")
    note("models built")
    out["params_gib"] = sum(p.numel() * p.element_size()
                            for p in cp.parameters()) / 2**30
    prompts = _prompts(e_cfg.vocab_size)
    traces, st, launches, timing, wall = drain(
        "linear", e_cfg, c_cfg, ep, cp, prompts, MESH_NEW, profile=True)
    seq = torch.as_tensor([list(p) + tr.tokens
                           for p, tr in zip(prompts, traces)], device=dev)
    finite = []
    for params, cfg in ((ep, e_cfg), (cp, c_cfg)):
        logits, _ = Model(cfg).prefill(params, {"tokens": seq})
        finite.append(bool(torch.isfinite(logits).all()))
    out["linear"] = {"tokens": [tr.tokens for tr in traces],
                     "paths": [tr.path for tr in traces], "stats": st,
                     "launches": launches, "timing": timing, "wall": wall,
                     "finite": finite, "vocab": e_cfg.vocab_size,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del traces
    # ---- the tree lane (dense states) and the self lane, same models
    for name in ("tree", "self"):
        lane(name, e_cfg, c_cfg, ep, cp)
    # ---- serve-time adaptation on the same models
    extra("adapt distill", e_cfg, c_cfg, ep, cp)
    del ep, cp
    torch.cuda.empty_cache()

    # ---- the moe edge: one 4096-token prefill per prompt (expert parallel)
    from repro_torch.core.policy import SpeculativePolicy
    e_cfg, c_cfg, ep, cp = pair("granite-moe-1b-a400m")
    note("moe models built")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, e_cfg.vocab_size, MESH_MOE["prompt"])
               .astype("int32") for _ in range(MESH_MOE["n"])]
    traces, st, launches, timing, wall = drain(
        "moe", e_cfg, c_cfg, ep, cp, prompts, MESH_MOE["new"],
        batch_size=MESH_MOE["n"], prefill_chunk=0,
        policy=SpeculativePolicy(1.1))
    out["moe"] = {"tokens": [tr.tokens for tr in traces], "stats": st,
                  "launches": launches, "wall": wall,
                  "expert_parallel_bytes":
                  mesh.moved.get("all_reduce/data", 0)}
    del ep, cp, traces
    torch.cuda.empty_cache()

    # ---- the recurrent edge: mamba2-370m on data-split recurrent states
    e_cfg, c_cfg, ep, cp = pair("mamba2-370m")
    note("mamba2 models built")
    lane("mamba2", e_cfg, c_cfg, ep, cp)
    del ep, cp
    torch.cuda.empty_cache()

    # ---- the moe cloud and the one-kv-head cloud
    for name, cloud, _, _ in MESH_EXTRA[1:]:
        e_cfg, c_cfg, ep, cp = pair("smollm-135m", cloud=cloud)
        note(f"{cloud} models built")
        extra(name, e_cfg, c_cfg, ep, cp)
        del ep, cp
        torch.cuda.empty_cache()

    # ---- float32 parity per path at PARITY_DEPTH, full width
    out["parity"] = {}
    runs = [(name, paths[name][1], "granite-8b", _parity_kw(paths[name][2]))
            for name in MESH_PARITY] + \
        [(name, "smollm-135m", cloud, kw) for name, cloud, kw, _ in MESH_EXTRA]
    for name, edge, cloud, kw in runs:
        e_cfg, c_cfg, ep, cp = pair(edge, PARITY_DEPTH[edge], "float32",
                                    cloud)
        prompts = _prompts(e_cfg.vocab_size)
        traces, st, launches, _, wall = drain(
            f"{name} parity", e_cfg, c_cfg, ep, cp, prompts,
            MESH_PARITY_NEW, **_fresh_opts(kw))
        out["parity"][name] = {"tokens": [tr.tokens for tr in traces],
                               "paths": [tr.path for tr in traces],
                               "stats": st, "launches": launches,
                               "wall": wall}
        del ep, cp
    out["moved"] = dict(mesh.moved)
    return out


def _parity_kw(kw):
    """A path's engine settings at ``PARITY_DEPTH``: the self lane drafts
    with the first of two layers."""
    return {**kw, "spec_exit_layer": 1} if "spec_exit_layer" in kw else kw


def _pct(xs, q=50):
    xs = sorted(xs)
    return xs[min(int(len(xs) * q / 100), len(xs) - 1)] if xs else 0.0


def phase_mesh(total):
    """[mesh]: sharded serving over four ranks on the one card (see
    ``MESH_*``); adds every rank's launches to ``total``."""
    import torch
    from repro_torch.launch.mesh import spawn_ranks
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    store = ROOT / "build" / f"mesh_store_{int(time.time() * 1e3)}"
    store.parent.mkdir(parents=True, exist_ok=True)
    print(f"[mesh] spawning {MESH_SHAPE[0] * MESH_SHAPE[1]} ranks at "
          f"(data {MESH_SHAPE[0]}, model {MESH_SHAPE[1]}) on one card; "
          f"cloud depth cut to {MESH_CLOUD_LAYERS} layers (full width)",
          flush=True)
    ranks = spawn_ranks(_mesh_rank, MESH_SHAPE[0] * MESH_SHAPE[1], None,
                        store=str(store), device="cuda", timeout=600)
    print(f"[mesh] backend {ranks[0]['backend']} (ranks share one card); "
          f"each rank holds {ranks[0]['params_gib']:.2f} GiB of the cloud's "
          f"bfloat16 blocks", flush=True)
    lin = [r["linear"] for r in ranks]
    V = lin[0]["vocab"]
    for r in ranks:
        L = r["linear"]
        check(L["tokens"] == lin[0]["tokens"],
              f"[mesh] rank {r['rank']} served other tokens than rank 0")
        check(all(len(t) == MESH_NEW and all(0 <= x < V for x in t)
                  for t in L["tokens"]), f"[mesh] rank {r['rank']}: a "
              f"request lacks its {MESH_NEW} tokens")
        check(all(L["finite"]), f"[mesh] rank {r['rank']}: non-finite "
              "logits over the served sequences")
        for k in MESH_KERNELS:
            check(L["launches"][k] > 0, f"[mesh] kernel {k} was not "
                  f"launched on rank {r['rank']} {r['coords']}")
        st = L["stats"]
        check(st["mesh_shape"] == {"data": 2, "model": 2},
              f"[mesh] mesh_shape {st['mesh_shape']}")
        check(st["kv_shards"] == 2 * 2, f"[mesh] kv_shards "
              f"{st['kv_shards']} != data_shards 2 x kv_ways 2")
        for k, n in L["launches"].items():
            total[k] += n
    st = lin[0]["stats"]
    tick = [t for r in lin for t in r["timing"]["tick"]]
    rnd = [t for r in lin for t in r["timing"]["round"]]
    print(f"[mesh] linear path (smollm-135m edge x {MESH_CLOUD_LAYERS}-layer "
          f"granite-8b, bf16): paths {_count_paths(lin[0]['paths'])}; "
          f"{st['ticks']} ticks, {len(lin[0]['timing']['round'])} rounds "
          f"on each rank; wall {lin[0]['wall']:.2f}s; kv_shards "
          f"{st['kv_shards']}, kv_capacity_blocks "
          f"{st['kv_capacity_blocks']}, mesh_devices {st['mesh_devices']}; "
          f"peak memory per rank "
          f"{max(r['peak_gib'] for r in lin):.2f} GiB", flush=True)
    print(f"[mesh] per tick (all ranks): host issue median "
          f"{_pct([h for h, _ in tick]):.1f} ms, stream span "
          f"{_pct([d for _, d in tick]):.1f} ms; per round: host issue "
          f"{_pct([h for h, _ in rnd]):.1f} ms, stream span "
          f"{_pct([d for _, d in rnd]):.1f} ms; launches per rank "
          + ", ".join(f"{k} {[r['launches'][k] for r in lin]}"
                      for k in MESH_KERNELS), flush=True)
    busy = lin[0]["timing"].get("busy_ms")
    n_rounds = len(lin[0]["timing"]["round"])
    print(f"[mesh] rank 0 device busy over the drain (profiled): "
          f"{busy:.1f} ms of {lin[0]['wall'] * 1e3:.0f} ms wall "
          f"({busy / (lin[0]['wall'] * 1e3):.1%}), about "
          f"{busy / max(n_rounds + st['ticks'], 1):.1f} ms per tick or "
          "round" if busy is not None else
          "[mesh] rank 0 device busy: not measured", flush=True)
    print("[mesh] bytes moved per round on rank 0 (median): "
          + _per_round_bytes(lin[0]["timing"])
          + "; whole phase on rank 0: "
          + "; ".join(f"{k} {n / 1e6:.1f} MB"
                      for k, n in sorted(ranks[0]["moved"].items())),
          flush=True)

    moe = [r["moe"] for r in ranks]
    for r, m in zip(ranks, moe):
        check(m["tokens"] == moe[0]["tokens"] and all(
            len(t) == MESH_MOE["new"] for t in m["tokens"]),
            f"[mesh] moe rank {r['rank']}: tokens differ or are missing")
        check(m["expert_parallel_bytes"] > 0, f"[mesh] moe rank "
              f"{r['rank']}: moe_block_sharded did not run")
        for k in ("paged_decode_attention", "flash_attention"):
            check(m["launches"][k] > 0, f"[mesh] moe: {k} not launched on "
                  f"rank {r['rank']}")
        for k, n in m["launches"].items():
            total[k] += n
    print(f"[mesh] moe edge (granite-moe-1b-a400m, {MESH_MOE['n']} prompts "
          f"of {MESH_MOE['prompt']} tokens, prefill_chunk 0): "
          f"moe_block_sharded on every rank ("
          f"{moe[0]['expert_parallel_bytes']} B of aux means), wall "
          f"{moe[0]['wall']:.2f}s", flush=True)

    paths = {p[0]: p for p in PATHS}
    for name in MESH_LANES:
        _mesh_lane_report(name, paths[name], ranks, total)
    for name, cloud, kw, kernels in MESH_EXTRA:
        _mesh_extra_report(name, cloud, kw, kernels, ranks, total)

    # ---- float32 parity against the unsharded engine in this process
    for name in MESH_PARITY:
        _mesh_parity(name, paths[name][1], _parity_kw(paths[name][2]),
                     ranks, total)
    for name, cloud, kw, _ in MESH_EXTRA:
        _mesh_parity(name, "smollm-135m", kw, ranks, total, cloud)
    print(f"[mesh] phase wall {time.perf_counter() - t_phase:.1f}s",
          flush=True)


# --------------------------------------------------------------- phase 3d
# Sharded training on the one card (``[mesh-train]``): four ranks at
# (data 2, model 2) over gloo, ``launch/train.train_on_mesh`` (the CLI's
# ``--mesh`` path below the mesh's construction) on granite-8b (32 query
# heads over 8 kv heads: heads split over 'model', FSDP over 'data'),
# olmoe-1b-7b (64 experts over 'model'), mamba2-370m (32 SSD heads over
# 'model'), xlstm-125m (every block whole on every rank), zamba2-2.7b (80
# SSD heads and the shared block's 32 attention heads over 'model') and
# whisper-small (12 heads of the encoder, decoder and cross attention over
# 'model'), each at full width cut to MESH_TRAIN_DEPTH, bf16, the trainer
# cell's batch 8 and seq 256, MESH_TRAIN_STEPS AdamW steps; then each at
# float32 for MESH_TRAIN_PARITY_STEPS steps against the unsharded port's
# step in this process (AdamW at eps 1e-3, as ``_train_step_parity`` says
# why): every rank's gathered parameters within MESH_TRAIN_TOL (absolute
# and relative, ``tests/test_torch_mesh_training.py``'s), losses and grad
# norms within 1e-5 relative.  The reference parameters reach the ranks
# through CUDA IPC (the spawn's arguments).  ``[dryrun]``: MESH_DRYRUN x
# train_4k on rank 0 of the 256-rank mesh, on the meta device, in a pool
# of three processes beside the examples and parity phases.
MESH_TRAIN = ("granite-8b", "olmoe-1b-7b", "mamba2-370m", "xlstm-125m",
              "zamba2-2.7b", "whisper-small")
# depth at full width: the clouds MESH_CLOUD_LAYERS layers, xLSTM 4 (one
# sLSTM block), zamba2 6 (one whole shared-attention group), whisper 2
# encoder and 2 decoder layers
MESH_TRAIN_DEPTH = {"mamba2-370m": 2, "xlstm-125m": 4, "zamba2-2.7b": 6,
                    "whisper-small": 2}
MESH_TRAIN_STEPS = {"granite-8b": 3, "olmoe-1b-7b": 3}
# the ssm, xlstm, hybrid and encdec models: 2 bf16 steps (3 took the
# whole script to 786 s of the 800 s it is allowed)
MESH_TRAIN_NEW_STEPS = 2
MESH_TRAIN_PARITY_STEPS = {"granite-8b": 2, "olmoe-1b-7b": 2}
# and 1 float32 parity step (2 took a run from ``git archive`` to 810 s)
MESH_TRAIN_NEW_PARITY_STEPS = 1
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 8, 256
MESH_TRAIN_TOL = 1e-6
# the kernels each family's train step must launch on every rank
MESH_TRAIN_KERNELS = {
    "flash": ("flash_attention", "flash_attention_bwd"),
    "ssd": ("ssd_chunk_scan", "ssd_chunk_scan_bwd")}
# the archs whose float32 reference takes the batch in the data ranks'
# row sets (``_mesh_train_refs``)
MESH_TRAIN_ROW_SETS = ("xlstm-125m", "zamba2-2.7b")
MESH_DRYRUN = ("granite-8b", "mamba2-370m", "xlstm-125m", "zamba2-2.7b",
               "whisper-small")
# a rank's flash shapes in that phase: (B / data, H / model, Kv / model,
# seq, hd), held and timed in phase 2
MESH_TRAIN_FLASH = (("granite-8b", (4, 16, 4, 256, 128)),
                    ("olmoe-1b-7b", (4, 8, 8, 256, 128)),
                    ("zamba2-2.7b", (4, 16, 16, 256, 80)))
# whisper-small's rank heads in that phase (12 / model 2, hd 64, B 8 / data
# 2): its non-causal encoder over the 1500 frames, its causal decoder and
# its cross attention, held and timed with the stub-family cases
MESH_TRAIN_STUB_FLASH = (
    ("whisper encoder train local", 4, 6, 6, 1500, 1500, 64, False, 0),
    ("whisper decoder train local", 4, 6, 6, 256, 256, 64, True, 0),
    ("whisper cross train local", 4, 6, 6, 256, 1500, 64, False, 0))


def _mesh_train_cfg(arch, dtype=None):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    depth = MESH_TRAIN_DEPTH.get(arch, MESH_CLOUD_LAYERS)
    cfg = cfg.replace(num_layers=depth, **(
        {"encoder_layers": depth} if cfg.encoder_layers else {}))
    return cfg if dtype is None else cfg.replace(param_dtype=dtype,
                                                 activ_dtype=dtype)


def _mesh_train_steps(arch, parity=False):
    table, new = (MESH_TRAIN_PARITY_STEPS, MESH_TRAIN_NEW_PARITY_STEPS) \
        if parity else (MESH_TRAIN_STEPS, MESH_TRAIN_NEW_STEPS)
    return table.get(arch, new)


def _mesh_train_kernels(arch):
    """The kernels ``arch``'s train step launches: the flash forward and
    backward (attention), the SSD scan's (mamba2 layers, mLSTM), both
    (the hybrid)."""
    fam = _mesh_train_cfg(arch).family
    kinds = {"ssm": ("ssd",), "xlstm": ("ssd",),
             "hybrid": ("ssd", "flash")}.get(fam, ("flash",))
    return tuple(k for kind in kinds for k in MESH_TRAIN_KERNELS[kind])


def _depth_label(cfg):
    return (f"{cfg.encoder_layers} encoder + {cfg.num_layers} decoder "
            "layers" if cfg.encoder_layers else f"{cfg.num_layers} layers")


def _parity_opt():
    from repro_torch.training import AdamW
    return AdamW(lr=1e-2, eps=1e-3)


def _mesh_train_rank(rank, archs, refs):
    """One rank of ``[mesh-train]`` (a spawned process; imports only the
    port): per arch the bf16 run's per-step timings, bytes, losses and
    launches and its state bytes, then the float32 steps against
    ``refs`` (the unsharded run's parameters, shared from the parent)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import batches
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import gather_params, init_placed
    from repro_torch.models import Model
    from repro_torch.training import trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_host_mesh(*MESH_SHAPE, device=dev)
    out = {"rank": rank, "coords": mesh.coords, "runs": {}, "parity": {}}
    real = trainer.make_train_step
    for arch in archs:
        steps = []

        def timed(*a, **k):
            step = real(*a, **k)

            def run(params, state, batch):
                before = dict(mesh.moved)
                prof = None
                if rank == 0 and len(steps) == 1:
                    prof = profile(activities=[ProfilerActivity.CUDA])
                    prof.__enter__()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                h = time.perf_counter()
                e0.record()
                params, state, m = step(params, state, batch)
                e1.record()
                host = (time.perf_counter() - h) * 1e3
                e1.synchronize()
                busy = None
                if prof is not None:
                    prof.__exit__(None, None, None)
                    busy = device_activity(prof)[0]
                steps.append({
                    "host": host, "span": e0.elapsed_time(e1), "busy": busy,
                    "bytes": {key: n - before.get(key, 0)
                              for key, n in mesh.moved.items()
                              if n != before.get(key, 0)},
                    "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])})
                return params, state, m
            return run

        trainer.make_train_step = timed
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        try:
            res = launch_train.train_on_mesh(launch_train.parse_args(
                ["--arch", arch, "--steps", str(_mesh_train_steps(arch)),
                 "--batch", str(MESH_TRAIN_BATCH), "--seq",
                 str(MESH_TRAIN_SEQ)]), mesh, _mesh_train_cfg(arch))
        finally:
            trainer.make_train_step = real
        wall = time.perf_counter() - t
        launches = ops.launch_counts()
        p = res["params"]
        n_local = sum(x.numel() for x in p.parameters())
        size = next(iter(p.parameters())).element_size()
        out["runs"][arch] = {
            "steps": steps, "launches": launches, "wall": wall,
            "rank_bytes": n_local * (size + 8),
            "whole_bytes": res["whole_params"] * (size + 8),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del res, p
        torch.cuda.empty_cache()

    for arch in archs:
        cfg = _mesh_train_cfg(arch, "float32")
        model = Model(cfg)
        p = init_placed(model, 0, mesh, dev)
        opt = _parity_opt()
        st = opt.init(p, cfg)
        step = trainer.make_train_step(model, opt, mesh=mesh)
        it = batches(cfg, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, device=dev)
        ops.reset_launch_counts()
        hist = []
        for _ in range(_mesh_train_steps(arch, parity=True)):
            p, st, m = step(p, st, next(it))
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        launches = ops.launch_counts()
        del st
        full = dict(gather_params(p).named_parameters())
        ref = refs[arch]
        err, excess = 0.0, 0.0
        for n, t in full.items():
            d = (t - ref[n]).abs()
            err = max(err, float(d.max()))
            excess = max(excess, float((d - MESH_TRAIN_TOL
                                        * (1 + ref[n].abs())).max()))
        out["parity"][arch] = {"hist": hist, "max_err": err,
                               "within": excess <= 0.0,
                               "launches": launches}
        del full, p
        torch.cuda.empty_cache()
    refs.clear()              # release the parent's shared tensors
    out["moved"] = dict(mesh.moved)
    return out


def _row_set_loss(model, sets):
    """``Model.loss`` of a batch evaluated over ``sets`` equal groups of
    its rows, as the data ranks hold them: each group's summed cross
    entropy over the whole batch's label count (the function is the
    same; the card's products then see the rows grouped as on the
    mesh).  For families without an auxiliary loss."""
    from repro_torch.models.model import nll_sum

    def loss(p, b):
        n = (b["labels"][:, 1:] != -1).sum().clamp(min=1)
        k = b["tokens"].shape[0] // sets
        total = 0.0
        for i in range(sets):
            part = {key: v[i * k:(i + 1) * k] for key, v in b.items()}
            logits = model.text_rows(model.forward(p, part)[0], part)
            total = total + nll_sum(logits[:, :-1],
                                    part["labels"][:, 1:])[0] / n
        return total
    return loss


def _mesh_train_refs():
    """The unsharded port's float32 steps of each ``MESH_TRAIN`` arch here:
    ({arch: {name: parameter}}, {arch: [(loss, grad norm)]}, {arch: (the
    whole-batch step's [(loss, grad norm)], the largest |parameter
    difference| between it and the row-set step)} where the reference
    took the row sets).  The reference takes the batch in the data ranks'
    row sets (``_row_set_loss``) for the families whose float32 gradients
    on the card move with the grouping of the rows (``MESH_TRAIN_ROW_SETS``:
    xLSTM's first-step grad norm 4.1e-6 and zamba2's 2.0e-6 apart between
    the batch whole and in two halves, both unsharded, as the parity line
    prints them); the rest (and the moe cloud, whose load-balance loss does
    not split over rows) the whole batch."""
    import torch
    from repro_torch.data import batches
    from repro_torch.models import Model
    from repro_torch.training import make_train_step
    refs, hists, whole = {}, {}, {}
    for arch in MESH_TRAIN:
        cfg = _mesh_train_cfg(arch, "float32")
        m = Model(cfg)
        kinds = ("rows", "whole") if arch in MESH_TRAIN_ROW_SETS \
            else ("whole",)
        for kind in kinds:
            p = m.init(seed=0, device="cuda")
            opt = _parity_opt()
            st = opt.init(p, cfg)
            step = make_train_step(m, opt, loss_fn=_row_set_loss(
                m, MESH_SHAPE[0]) if kind == "rows" else None)
            it = batches(cfg, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ,
                         device="cuda")
            hist = []
            for _ in range(_mesh_train_steps(arch, parity=True)):
                p, st, met = step(p, st, next(it))
                hist.append((float(met["loss"]), float(met["grad_norm"])))
            del st
            if kind == kinds[0]:
                hists[arch] = hist
                refs[arch] = {n: t.detach() for n, t in
                              p.named_parameters()}
            else:
                whole[arch] = (hist, max(
                    float((t - refs[arch][n]).abs().max())
                    for n, t in p.named_parameters()))
            del p
            torch.cuda.empty_cache()
    return refs, hists, whole


def phase_mesh_train(total):
    """[mesh-train] (see ``MESH_TRAIN``); adds every rank's launches to
    ``total``."""
    import torch
    from repro_torch.launch.mesh import spawn_ranks
    t_phase = time.perf_counter()
    refs, ref_hist, whole_hist = _mesh_train_refs()
    print(f"[mesh-train] unsharded float32 references "
          f"({[_mesh_train_steps(a, True) for a in MESH_TRAIN]} steps) in "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    store = ROOT / "build" / f"mesh_train_store_{int(time.time() * 1e3)}"
    store.parent.mkdir(parents=True, exist_ok=True)
    ranks = spawn_ranks(_mesh_train_rank, MESH_SHAPE[0] * MESH_SHAPE[1],
                        list(MESH_TRAIN), refs, store=str(store),
                        device="cuda", timeout=600)
    del refs
    torch.cuda.empty_cache()
    import math
    for arch in MESH_TRAIN:
        runs = [r["runs"][arch] for r in ranks]
        for r, run in zip(ranks, runs):
            for k in _mesh_train_kernels(arch):
                check(run["launches"][k] > 0, f"[mesh-train] {arch}: {k} "
                      f"was not launched on rank {r['rank']} {r['coords']}")
            check([(s["loss"], s["grad_norm"]) for s in run["steps"]]
                  == [(s["loss"], s["grad_norm"]) for s in runs[0]["steps"]],
                  f"[mesh-train] {arch}: rank {r['rank']}'s losses or grad "
                  "norms differ from rank 0's")
            check(all(math.isfinite(s["loss"]) and
                      math.isfinite(s["grad_norm"]) for s in run["steps"]),
                  f"[mesh-train] {arch}: a non-finite loss or grad norm on "
                  f"rank {r['rank']}")
            check(len(run["steps"]) == _mesh_train_steps(arch),
                  f"[mesh-train] {arch}: {len(run['steps'])} steps")
            for k, n in run["launches"].items():
                total[k] += n
        run = runs[0]
        st = run["steps"]
        later = [s for r in runs for s in r["steps"][1:]]
        per_step = {}
        for s in st[1:]:
            for k, n in s["bytes"].items():
                per_step.setdefault(k, []).append(n)
        print(f"[mesh-train] {arch} ({_depth_label(_mesh_train_cfg(arch))}, "
              f"full width, bf16, batch {MESH_TRAIN_BATCH}, seq "
              f"{MESH_TRAIN_SEQ},"
              f" mesh (data {MESH_SHAPE[0]}, model {MESH_SHAPE[1]})): loss "
              + " -> ".join(f"{s['loss']:.4f}" for s in st)
              + ", grad norm " + " -> ".join(f"{s['grad_norm']:.4f}"
                                             for s in st)
              + f" (every rank the same); wall {run['wall']:.2f}s; per step "
              f"after the first (all ranks, median): host issue "
              f"{_pct([s['host'] for s in later]):.1f} ms, stream span "
              f"{_pct([s['span'] for s in later]):.1f} ms; rank 0's device "
              f"busy in step 2 (profiled) {st[1]['busy']:.1f} ms; first "
              f"step {st[0]['span']:.1f} ms; launches per rank "
              + ", ".join(f"{k} {[r['launches'][k] for r in runs]}"
                          for k in _mesh_train_kernels(arch))
              + "; backward routes " + str(
                  {k: n for k, n in run["launches"].items()
                   if "_bwd/" in k and n})
              + f"; peak memory per rank "
              f"{max(r['peak_gib'] for r in runs):.2f} GiB", flush=True)
        print(f"[mesh-train] {arch} bytes per step on rank 0 (median of "
              f"steps 2-{len(st)}): " + "; ".join(
                  f"{k} {_pct(v) / 1e6:.3f} MB"
                  for k, v in sorted(per_step.items()))
              + f"; parameters + AdamW moments on a rank "
              f"{run['rank_bytes']} B of the whole model's "
              f"{run['whole_bytes']} B "
              f"({run['rank_bytes'] / run['whole_bytes']:.3f})", flush=True)
    for arch in MESH_TRAIN:
        ref = ref_hist[arch]
        pars = [r["parity"][arch] for r in ranks]
        regroup = whole_hist[arch][1] if arch in whole_hist else 0.0
        whole = "" if arch not in whole_hist else (
            "; the unsharded step over the whole batch at once: losses "
            f"{[round(l, 6) for l, _ in whole_hist[arch][0]]}, grad norms "
            f"{[round(n, 6) for _, n in whole_hist[arch][0]]}, its params "
            f"up to {regroup:.2e} from the row-set step's")
        print(f"[mesh-train] {arch} float32 parity "
              f"({_mesh_train_steps(arch, True)} steps, AdamW eps 1e-3) "
              "against the unsharded step"
              + (" over the data ranks' row sets"
                 if arch in MESH_TRAIN_ROW_SETS else "")
              + f": losses {[round(l, 6) for l, _ in pars[0]['hist']]} vs "
              f"{[round(l, 6) for l, _ in ref]}, grad norms "
              f"{[round(n, 6) for _, n in pars[0]['hist']]} vs "
              f"{[round(n, 6) for _, n in ref]}; gathered params max diff "
              f"per rank {[format(p['max_err'], '.2e') for p in pars]} (tol "
              f"{MESH_TRAIN_TOL:g} x (1 + |ref|))" + whole, flush=True)
        for r, par in zip(ranks, pars):
            for (l, n), (rl, rn) in zip(par["hist"], ref):
                check(abs(l - rl) <= 1e-5 * abs(rl)
                      and abs(n - rn) <= 1e-5 * rn,
                      f"[mesh-train] {arch} float32 rank {r['rank']}: loss "
                      f"{l} / grad norm {n} against the unsharded {rl} / "
                      f"{rn}")
            check(par["within"] or par["max_err"] <= regroup,
                  f"[mesh-train] {arch} float32 rank {r['rank']}: gathered "
                  f"params differ by {par['max_err']:.3e} (tol "
                  f"{MESH_TRAIN_TOL:g} x (1 + |ref|), or the {regroup:.3e} "
                  "the unsharded step moves by between two groupings of "
                  "the rows)")
            for k in _mesh_train_kernels(arch):
                check(par["launches"][k] > 0, f"[mesh-train] {arch} float32:"
                      f" {k} not launched on rank {r['rank']}")
            for k, n in par["launches"].items():
                total[k] += n
    print("[mesh-train] whole phase on rank 0: " + "; ".join(
        f"{k} {n / 1e6:.1f} MB" for k, n in sorted(ranks[0]["moved"].items())),
        flush=True)
    print(f"[mesh-train] phase wall {time.perf_counter() - t_phase:.1f}s",
          flush=True)


def _dryrun_one(arch):
    """One ``[dryrun]`` record (in a pool process): (record, seconds)."""
    from repro_torch.launch import dryrun
    t = time.perf_counter()
    rec = dryrun.run_one(arch, "train_4k", "single", verbose=False,
                         results_dir=str(ROOT / "build" / "dryrun_torch"))
    return rec, time.perf_counter() - t


def start_dryruns():
    """``MESH_DRYRUN`` x train_4k in a pool of processes (CPU and the meta
    device only), started now and read by ``report_dryruns``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(
        max_workers=3,               # beside the examples' four processes
        mp_context=multiprocessing.get_context("spawn"))
    return pool, time.perf_counter(), {a: pool.submit(_dryrun_one, a)
                                       for a in MESH_DRYRUN}


def report_dryruns(pending):
    """The ``[dryrun]`` lines of ``start_dryruns``' records; every record
    must be ok with flops and collective bytes."""
    pool, t0, futures = pending
    try:
        for arch, fut in futures.items():
            rec, sec = fut.result(timeout=600)
            check(rec["status"] == "ok" and rec["flops_per_device"] > 0 and
                  rec["hlo_cost"]["collective_bytes"] > 0, f"[dryrun] {rec}")
            print(f"[dryrun] {arch} x train_4k x single (rank 0 of "
                  f"{rec['devices']}, meta device): flops "
                  f"{rec['flops_per_device']:.6g}, bytes "
                  f"{rec['bytes_per_device']:.6g} (unfused upper bound), "
                  f"collective bytes "
                  f"{rec['hlo_cost']['collective_bytes']:.6g} in "
                  f"{rec['collectives']['count']} calls per rank; arguments "
                  f"{rec['memory']['argument_bytes']} B, saved for the "
                  f"backward {rec['memory']['temp_bytes']} B; {sec:.1f}s in "
                  "its process", flush=True)
        print(f"[dryrun] {len(futures)} records, "
              f"{time.perf_counter() - t0:.1f}s from their start", flush=True)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _per_round_bytes(timing):
    """Median bytes per round of each collective ("<op>/<axes>")."""
    per_round = {}
    for b in timing["round_bytes"]:
        for k, n in b.items():
            per_round.setdefault(k, []).append(n)
    return "; ".join(f"{k} {_pct(v) / 1e6:.3f} MB"
                     for k, v in sorted(per_round.items()))


def _mesh_lane_report(name, path, ranks, total, cloud="granite-8b"):
    """Check and print one ``MESH_LANES`` drain (or, with ``cloud``, a
    ``MESH_EXTRA`` one): every request served its ``MESH_NEW`` tokens, the same on every rank, with the kernels of its ``PATHS``
    entry launched on every rank; ms per tick and round, the bytes per
    collective per round, ``kv_capacity_blocks`` and this rank's state
    bytes against the whole state's (what the unsharded engine holds)."""
    _, edge, kw, kernels = path
    runs = [r["lanes"][name] for r in ranks]
    for r, run in zip(ranks, runs):
        check(run["tokens"] == runs[0]["tokens"],
              f"[mesh] {name}: rank {r['rank']} served other tokens than "
              "rank 0")
        check(all(len(t) == MESH_NEW for t in run["tokens"]),
              f"[mesh] {name}: rank {r['rank']}: a request lacks its "
              f"{MESH_NEW} tokens")
        check(run["stats"]["spec_mode"] == kw.get("spec_mode", "linear"),
              f"[mesh] {name}: served lane {run['stats']['spec_mode']}")
        for k in kernels:
            check(run["launches"][k] > 0, f"[mesh] {name}: kernel {k} was "
                  f"not launched on rank {r['rank']} {r['coords']}")
        for k, n in run["launches"].items():
            total[k] += n
    st, timing = runs[0]["stats"], runs[0]["timing"]
    tick = [t for run in runs for t in run["timing"]["tick"]]
    rnd = [t for run in runs for t in run["timing"]["round"]]
    rank_b = st.get("kv_rank_bytes",
                    st["kv_capacity_bytes"] // st.get("kv_shards", 1))
    print(f"[mesh] {name} lane ({edge} edge, {st['kv_layout']} KV, "
          f"{st['spec_mode']} lane, x {MESH_CLOUD_LAYERS}-layer {cloud}, "
          f"bf16): paths {_count_paths(runs[0]['paths'])}; {st['ticks']} "
          f"ticks, {len(timing['round'])} rounds on each rank; wall "
          f"{runs[0]['wall']:.2f}s; per tick median host issue "
          f"{_pct([h for h, _ in tick]):.1f} ms, stream span "
          f"{_pct([d for _, d in tick]):.1f} ms; per round host issue "
          f"{_pct([h for h, _ in rnd]):.1f} ms, stream span "
          f"{_pct([d for _, d in rnd]):.1f} ms; serving state per rank "
          f"{rank_b} B of {st['kv_capacity_bytes']} B (whole), "
          f"kv_capacity_blocks {st.get('kv_capacity_blocks', 'n/a')}, "
          f"escalation groups' peak {st.get('kv_group_peak_bytes', 0)} B "
          f"(whole); "
          f"launches per rank "
          + ", ".join(f"{k} {[run['launches'][k] for run in runs]}"
                      for k in kernels), flush=True)
    print(f"[mesh] {name} lane bytes moved per round on rank 0 (median): "
          + _per_round_bytes(timing), flush=True)


def _mesh_extra_report(name, cloud, kw, kernels, ranks, total):
    """``_mesh_lane_report`` of one ``MESH_EXTRA`` drain, plus what the
    path shows of itself: the adaptation loop's swaps, train steps, last
    loss and teacher-carrying records (the same on every rank, at least
    one swap), and the cloud's local heads and experts on a rank."""
    import math
    _mesh_lane_report(name, (name, "smollm-135m", kw, kernels), ranks,
                      total, cloud)
    runs = [r["lanes"][name] for r in ranks]
    run = runs[0]
    if "adapt" in kw:
        a = run["stats"]["adaptation"]
        for r, other in zip(ranks, runs):
            check(other["stats"]["adaptation"] == a, f"[mesh] {name}: rank "
                  f"{r['rank']}'s adaptation stats differ from rank 0's")
        check(a["swaps"] >= 1 and a["last_loss"] is not None
              and math.isfinite(a["last_loss"]) and run["teachers"] > 0,
              f"[mesh] {name}: swaps {a['swaps']}, last loss "
              f"{a['last_loss']}, {run['teachers']} records with teacher "
              "top-k")
        print(f"[mesh] {name}: swaps {a['swaps']}, train steps "
              f"{a['train_steps']}, last_loss {a['last_loss']:.4f}, "
              f"{run['teachers']} of {a['store_size']} records with teacher "
              f"top-k (every rank the same)", flush=True)
    else:
        print(f"[mesh] {name}: a rank computes (query heads, kv heads, on "
              f"its own heads) = {run['heads']}, experts (local E, d, f) = "
              f"{run['experts']}", flush=True)


def _mesh_parity(name, edge, kw, ranks, total, cloud="granite-8b"):
    """The float32 drain of one path on the mesh (every rank the same
    tokens) against the unsharded engine here, at ``PARITY_DEPTH``: traces
    identical but for near ties (the plain top-2 gap of the model that
    chose the token below ``GAP_TOL``); an adaptation loop's counts equal
    and its last loss within 1e-4 relative (the teacher logits of a
    tensor-parallel cloud differ in the last bits)."""
    import torch
    from repro_torch.models import Model
    par = [r["parity"][name] for r in ranks]
    for r, p in zip(ranks, par):
        check(p["tokens"] == par[0]["tokens"], f"[mesh] {name} parity: rank "
              f"{r['rank']} tokens differ from rank 0's")
        for k, n in p["launches"].items():
            total[k] += n
    e_cfg, c_cfg = _configs(edge, PARITY_DEPTH[edge], "float32", cloud)
    ep = Model(e_cfg).init(seed=0, device="cuda")
    cp = Model(c_cfg).init(seed=1, device="cuda")
    prompts = _prompts(e_cfg.vocab_size)
    eng = _engine(e_cfg, c_cfg, **_fresh_opts(kw))
    base = eng.serve_batch(ep, cp, prompts, MESH_PARITY_NEW)
    st0, st = eng.stats(), par[0]["stats"]
    if "adaptation" in st0:
        a, a0 = st["adaptation"], st0["adaptation"]
        keys = ("observed", "updates", "train_steps", "swaps", "store_size")
        check({k: a[k] for k in keys} == {k: a0[k] for k in keys}
              and a0["swaps"] >= 1 and abs(a["last_loss"] - a0["last_loss"])
              <= 1e-4 * max(1.0, abs(a0["last_loss"])),
              f"[mesh] {name} parity: adaptation {a} vs unsharded {a0}")
        print(f"[mesh] {name} float32 parity: swaps {a['swaps']} / "
              f"{a0['swaps']}, last_loss {a['last_loss']:.6f} vs unsharded "
              f"{a0['last_loss']:.6f}", flush=True)
    if "kv_capacity_blocks" in st0:
        check(st["kv_capacity_blocks"] > st0["kv_capacity_blocks"],
              f"[mesh] kv_capacity_blocks {st['kv_capacity_blocks']} not "
              f"above the unsharded {st0['kv_capacity_blocks']}")
    excused = 0
    for i, (a, b) in enumerate(zip(par[0]["tokens"], base)):
        if a == b.tokens:
            continue
        j = _first_divergence(a, b.tokens)
        # the model that chose the token: the edge for edge output and on
        # the self lane, else the cloud
        edge_chose = b.path == "edge" or name == "self"
        params, cfg = (ep, e_cfg) if edge_chose else (cp, c_cfg)
        gap = _top2_gap(prompts[i], b.tokens[:j], params, cfg)
        print(f"[mesh] {name} parity request {i} diverges at token {j}: "
              f"unsharded top-2 gap {gap:.3e}", flush=True)
        check(gap < GAP_TOL, f"[mesh] {name} parity request {i}: divergence "
                             f"at token {j} with a top-2 gap {gap} >= "
                             f"{GAP_TOL}")
        excused += 1
    print(f"[mesh] {name} float32 parity ({e_cfg.num_layers}-layer {edge} + "
          f"{c_cfg.num_layers}-layer {cloud}, full width, "
          f"{st['kv_layout']} KV, {st['spec_mode']} lane, "
          f"{MESH_PARITY_NEW} new): mesh vs unsharded "
          f"{len(base) - excused}/{len(base)} traces identical, {excused} "
          f"near-tie divergences; kv_capacity_bytes {st['kv_capacity_bytes']}"
          f" vs {st0['kv_capacity_bytes']}"
          + (f", kv_capacity_blocks {st['kv_capacity_blocks']} vs "
             f"{st0['kv_capacity_blocks']}" if "kv_capacity_blocks" in st0
             else ""), flush=True)
    del ep, cp
    torch.cuda.empty_cache()


def _count_paths(items):
    out = {}
    for x in items:
        out[x] = out.get(x, 0) + 1
    return out


# the examples' own checks, run by phase_examples in a fresh process each
EXAMPLE_RUNS = (
    ("quickstart", [], "out['lossless'] and len(out['speculative']) == 24"),
    ("collaborative_serving", [],
     "all(len(v[4]) == 13 and all(t.tokens for t in v[4]) "
     "for v in out.values())"),
    ("federated_lora", [],
     "all(a['A'].shape[-2] == 8 for a in out['aggregate'].values())"),
    ("train_distill", ["--steps", "40"],
     "out['teacher_history'][-1][1] < out['teacher_history'][0][1] "
     "and out['distill_losses'][-1] < out['distill_losses'][0]"),
)
_EXAMPLE_DRIVER = """
import importlib.util, json, sys, time
name, check = sys.argv[1], sys.argv[2]
spec = importlib.util.spec_from_file_location(name, sys.argv[3])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
t = time.perf_counter()
out = mod.main(sys.argv[4:])
assert eval(check), "invariant failed: " + check
print("EXAMPLE_OK", name, round(time.perf_counter() - t, 2))
"""


def phase_examples():
    """[examples]: the four port examples on the card, each a fresh process
    (its default ``--device cuda``), all four at once, each exiting 0 with
    its invariant held."""
    import os
    t_phase = time.perf_counter()
    # two host threads each: the four share the machine's cores
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "2"}
    logs = ROOT / "build" / "examples"
    logs.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, argv, inv in EXAMPLE_RUNS:
        with open(logs / f"{name}.out", "w") as fo, \
                open(logs / f"{name}.err", "w") as fe:
            procs.append((name, subprocess.Popen(
                [sys.executable, "-c", _EXAMPLE_DRIVER, name, inv,
                 str(ROOT / "examples" / "torch_port" / f"{name}.py"),
                 *argv], cwd=ROOT, env=env, stdout=fo, stderr=fe)))
    failed = []
    for name, p in procs:
        try:
            p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        out = (logs / f"{name}.out").read_text()
        err = (logs / f"{name}.err").read_text()
        last = [ln for ln in out.splitlines() if ln.strip()]
        if p.returncode != 0 or "EXAMPLE_OK" not in out:
            failed.append(f"{name} exited {p.returncode}: {err[-2000:]}")
            continue
        print(f"[examples] {name}: ok (main {last[-1].split()[-1]}s); "
              f"{' | '.join(last[-3:-1])[:300]}", flush=True)
    check(not failed, "[examples] " + "; ".join(failed))
    print(f"[examples] phase wall {time.perf_counter() - t_phase:.1f}s "
          "(the four at once)", flush=True)


# --------------------------------------------------------------- phase 4
def phase_parity():
    """Every served path at float32, full width, cut depth
    (``PARITY_DEPTH``), on the kernels and on the plain versions — plus the
    moe edge on the tree lane, the mamba2 path with ``prefill_chunk=8``,
    whose 15-entry prompts then prefill in two pieces, so the scan kernel
    carries a state on the served path, and the per-request phase."""
    import torch
    from repro_torch.models import Model
    paths = list(PATHS) + [("moe tree", "granite-moe-1b-a400m",
                            PATHS[1][2], ()),
                           ("mamba2 chunked", "mamba2-370m",
                            {"prefill_chunk": 8}, ())]
    ep = cp = e_cfg = c_cfg = None
    for name, edge, kw, _ in paths:
        e_new, c_new = _configs(edge, PARITY_DEPTH[edge], "float32")
        if e_new != e_cfg:
            e_cfg, ep = e_new, Model(e_new).init(seed=0, device="cuda")
        if c_new != c_cfg:
            c_cfg, cp = c_new, Model(c_new).init(seed=1, device="cuda")
        prompts = _prompts(e_cfg.vocab_size)
        if name == "self":
            kw = _parity_kw(kw)
            parity_per_request(ep, cp, e_cfg, c_cfg, prompts)
        runs = {}
        for backend in ("auto", "plain"):
            runs[backend] = _engine(e_cfg, c_cfg, backend, **kw).serve_batch(
                ep, cp, prompts, 24)
        excused = 0
        for i, (a, b) in enumerate(zip(runs["auto"], runs["plain"])):
            if (a.tokens, a.path, a.edge_calls) == (b.tokens, b.path,
                                                    b.edge_calls):
                continue
            check(a.path == b.path and a.tokens != b.tokens,
                  f"{name} request {i}: kernel run {a.path}/{a.edge_calls} "
                  f"vs plain {b.path}/{b.edge_calls} with identical tokens")
            j = _first_divergence(a.tokens, b.tokens)
            # the model that chose the diverging token: the edge for edge
            # output and on the self lane, else the cloud
            edge_chose = b.path == "edge" or name == "self"
            params, cfg = (ep, e_cfg) if edge_chose else (cp, c_cfg)
            gap = _top2_gap(prompts[i], b.tokens[:j], params, cfg)
            print(f"[parity] {name} request {i} diverges at token {j}: "
                  f"plain top-2 gap {gap:.3e}", flush=True)
            check(gap < GAP_TOL, f"{name} request {i}: divergence at token "
                                 f"{j} with a top-2 gap {gap} >= {GAP_TOL}")
            excused += 1
        print(f"[parity] {name} path, float32 full-width engine "
              f"({e_cfg.num_layers}-layer {edge} + {c_cfg.num_layers}-layer "
              f"granite-8b), kernels vs plain: "
              f"{len(prompts) - excused}/{len(prompts)} traces identical, "
              f"{excused} near-tie divergences", flush=True)
        lap(f"parity {name}")
    del ep, cp
    torch.cuda.empty_cache()
    for arch in ("whisper-small", "paligemma-3b"):
        _stub_parity(arch)


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
    dryruns = None
    try:
        phase_build()
        lap("build")
        kernels = phase_kernels()
        lap("build + kernel checks")
        launches = phase_serve()
        lap("+ serve and breakdown")
        phase_stub_families(launches)
        lap("+ encdec and vlm")
        phase_learn(launches)
        lap("+ adaptation and training")
        phase_mesh(launches)
        lap("+ mesh")
        phase_mesh_train(launches)
        lap("+ mesh-train")
        dryruns = start_dryruns()
        phase_examples()
        lap("+ examples")
        phase_parity()
        lap("+ parity")
        pending, dryruns = dryruns, None
        report_dryruns(pending)
        lap("+ dryrun")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if dryruns is not None:          # a phase failed: stop them
            dryruns[0].shutdown(wait=True, cancel_futures=True)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        routes = {key.split("/")[1]: n for key, n in launches.items()
                  if key.startswith(k["name"] + "/")}
        if routes:
            k["launches_by_route"] = routes
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
