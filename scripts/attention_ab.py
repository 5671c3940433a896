#!/usr/bin/env python3
"""Time the port's kernels of one checkout, so that two versions can be
compared on one card.

    python3 scripts/attention_ab.py [--src DIR] [--label NAME]
                                    [--kernels flash,tree,paged,ssd,decode,spec,bwd,ssdbwd]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``)
and times each selected kernel by ``chip_smoke.py``'s procedure — per call:
CUDA events around one wrapper call, median of 30; on the device: a CUDA
graph of 20 calls, events around each replay — on inputs that every
version of the wrappers takes:

* ``flash``: granite-8b's 32 heads with K/V given per query head
  (contiguous), a 16-token prefill and a 2048-token prompt, causal; held
  against the plain version once;
* ``tree``: the one-shot verify of 8 slots with granite-8b's heads, over
  the serving cache (S 80) and a 1024-position one; held likewise;
* ``paged``: the paged decode at the serving shape (8 slots, smollm-135m
  heads, 3-block tables) and the long one (128-block tables, lengths
  3968-4096), with SDPA on the pre-gathered cache as the yardstick;
* ``ssd``: the SSD scan at the three recurrent edges' 15-token prefills
  and the two long prompts (mamba2 and xLSTM, S 2048);
* ``decode``: the dense decode at the tree path's edge ticks, the hybrid
  path's shared attention (Kv 32, G 1, hd 80) and a 4096-position cache,
  each with SDPA;
* ``spec``: spec verify at the serving shape at T = 0 and T = 1, and at
  the hybrid path's 32000-entry vocabulary;
* ``bwd``: the flash backward alone at the training shape (smollm-135m
  heads, B 8, S 256) and at granite-8b's heads over S 2048, against
  SDPA's backward alone, with forward + backward against SDPA's
  (``chip_smoke._flash_bwd_timing``), then at the stub families'
  training shapes of ``chip_smoke.STUB_FLASH_BWD`` named in
  ``BWD_STUB`` — paligemma-3b's (8, 8, 1, 512, 256) with prefix 256, the
  whisper encoder and its cross attention — the same way with SDPA given
  the boolean mask (``chip_smoke._stub_flash_timing``), and the device ms
  of each of the backward's kernels (``torch.profiler``);
* ``ssdbwd``: the SSD-scan backward alone at the trainer's shapes
  (mamba2-370m, xlstm-125m, zamba2-2.7b at batch 8, seq 256) and the
  2048-token prompts, beside the plain autograd's backward alone
  (``chip_smoke._ssd_bwd_timing``).

The helpers are this checkout's ``chip_smoke.py``; only the kernel
modules come from ``DIR``.  Prints one JSON line, last (the timing
helpers print their own lines before it).  Compare two versions within
one run on the card, in turns: A, B, B, A.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts this checkout's src on the path)

ALL = ("flash", "tree", "paged", "ssd", "decode", "spec", "bwd", "ssdbwd")
# the stub families' backward shapes that ``bwd`` times (labels of
# chip_smoke.STUB_FLASH_BWD)
BWD_STUB = ("prefix_train", "encoder", "cross_train")


def _flash(res, gen):
    import torch
    from repro_torch.kernels import flash_attention as FK
    for name, S in (("serving", 16), ("long", 2048)):
        q, k, v = (torch.randn((1, 32, S, 128), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        err = cs.max_err(FK.flash_attention_cuda(q, k, v, causal=True),
                         FK.flash_attention_plain(q, k, v, causal=True))
        fn = functools.partial(FK.flash_attention_cuda, q, k, v, causal=True)
        ms, dev = cs.time_ms(fn), cs.device_ms(fn)
        res[f"flash_{name}"] = {"S": S, "ms": ms, "device_ms": dev,
                                "max_abs_err": err}


def _tree(res, gen):
    import torch
    from repro_torch.kernels import tree_attention as TK
    for name, S, base in (("serving", 80, (16, 40)),
                          ("long", cs.TREE_LONG_S, cs.TREE_LONG_BASE)):
        a = cs._tree_inputs(8, 8, 4, S, 128, 0, 16, torch.bfloat16, gen, base)
        err = cs.max_err(TK.tree_verify_attention_cuda(*a),
                         TK.tree_verify_attention_plain(*a))
        fn = functools.partial(TK.tree_verify_attention_cuda, *a)
        ms, dev = cs.time_ms(fn), cs.device_ms(fn)
        res[f"tree_{name}"] = {"S": S, "ms": ms, "device_ms": dev,
                               "max_abs_err": err}


def _paged(res, gen):
    from repro_torch.kernels import decode_attention as K
    res["paged_serving"] = cs.paged_timing(K, gen)
    res["paged_long"] = cs.paged_timing(K, gen, *cs.PAGED_LONG)


def _ssd(res, gen):
    from repro_torch.kernels import ssd_scan as K
    for case in cs.SSD_ROWS + cs.SSD_LONG:
        res[f"ssd {case[0]}"] = cs.ssd_timing(K, case, gen)


def _ssdbwd(res, gen):
    from repro_torch.kernels import ssd_scan as K
    for case in cs.SSD_BWD_TRAIN + cs.SSD_BWD_LONG:
        res[f"ssdbwd {case[0]}"] = cs._ssd_bwd_timing(K, case, gen)


def _decode(res, gen):
    from repro_torch.kernels import decode_attention as K
    res["decode_serving"] = cs.decode_timing(K, gen)
    for key, shape in cs.DECODE_MORE:
        res[f"decode_{key}"] = cs.decode_timing(K, gen, *shape)


def _spec(res, gen):
    from repro_torch.kernels import spec_verify as K
    res["spec_serving"] = cs.spec_timing(K, gen)
    for key, V, temperature in cs.SPEC_MORE:
        res[f"spec_{key}"] = cs.spec_timing(K, gen, V, temperature)


def kernel_split(fn, n: int = 5) -> dict:
    """Device ms per call of each CUDA kernel that ``fn`` launches, by
    kernel name (``torch.profiler`` over ``n`` calls after one warm-up)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            m = re.search(r"(\w+_kernel)(<[^>]*>)?", e.key)
            key = m.group(0) if m else e.key[:60]
            out[key] = out.get(key, 0.0) + t / 1e3 / n
    return out


def _bwd(res, gen):
    import torch
    from repro_torch.kernels import flash_attention as K
    for name, shape in (("train", cs.FLASH_BWD_TRAIN),
                        ("long", cs.FLASH_LONG)):
        row = cs._flash_bwd_timing(K, shape, gen)
        B, H, Kv, S, hd = shape
        q = cs._proj_view((B, H, S, hd), torch.bfloat16, gen)
        k, v = (cs._proj_view((B, Kv, S, hd), torch.bfloat16, gen)
                for _ in range(2))
        dout = cs._proj_view((B, H, S, hd), torch.bfloat16, gen)
        with torch.no_grad():
            out, lse = K.flash_attention_cuda(q, k, v, causal=True,
                                              return_lse=True)
        row["kernels_device_ms"] = kernel_split(
            lambda: K.flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                               causal=True))
        res[f"bwd_{name}"] = row
    for case in (c for c in cs.STUB_FLASH_BWD if c[0] in BWD_STUB):
        row = cs._stub_flash_timing(K, case, gen)
        kw = dict(causal=case[7], prefix_len=case[8])
        q, k, v, dout = cs._stub_flash_inputs(case, torch.bfloat16, gen)
        with torch.no_grad():
            out, lse = K.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        row["kernels_device_ms"] = kernel_split(
            lambda: K.flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                               **kw))
        res[f"bwd_{case[0]}"] = row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--kernels", default=",".join(ALL),
                    help="comma-separated subset of " + ",".join(ALL))
    args = ap.parse_args()
    kernels = [k for k in args.kernels.split(",") if k]
    unknown = sorted(set(kernels) - set(ALL))
    if unknown:
        ap.error(f"unknown kernels {unknown}; choose from {ALL}")
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        print(f"attention_ab: imported {repro_torch.__file__}, not from "
              f"{src}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    res = {"label": args.label, "device": torch.cuda.get_device_name(0)}
    steps = {"flash": _flash, "tree": _tree, "paged": _paged, "ssd": _ssd,
             "decode": _decode, "spec": _spec, "bwd": _bwd,
             "ssdbwd": _ssdbwd}
    for k in kernels:
        steps[k](res, gen)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
