#!/usr/bin/env python3
"""Time the flash-prefill and tree-verify kernels of one checkout, so that
two versions can be compared on one card.

    python3 scripts/attention_ab.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
holds each kernel against its plain version once, and times it by
``chip_smoke.py``'s procedure — per call: CUDA events around one wrapper
call, median of 30; on the device: a CUDA graph of 20 calls, events around
each replay — on inputs that every version of the wrappers takes: flash at
granite-8b's 32 heads with K/V given per query head (contiguous), at the
16-token prefill and a 2048-token prompt, causal; tree verify, the
one-shot verify of 8 slots with granite-8b's heads, over the serving
cache (S 80) and a 1024-position one.  Prints one JSON line.  Compare two
versions within one run on the card, in turns: A, B, B, A.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import tree_attention as TK
    if not Path(FK.__file__).resolve().is_relative_to(src):
        print(f"attention_ab: imported {FK.__file__}, not from {src}",
              file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    res = {"label": args.label, "device": torch.cuda.get_device_name(0)}
    for name, S in (("serving", 16), ("long", 2048)):
        q, k, v = (torch.randn((1, 32, S, 128), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        err = cs.max_err(FK.flash_attention_cuda(q, k, v, causal=True),
                         FK.flash_attention_plain(q, k, v, causal=True))
        fn = functools.partial(FK.flash_attention_cuda, q, k, v, causal=True)
        ms, dev = cs.time_ms(fn), cs.device_ms(fn)
        res[f"flash_{name}"] = {"S": S, "ms": ms, "device_ms": dev,
                                "max_abs_err": err}
    for name, S, base in (("serving", 80, (16, 40)),
                          ("long", cs.TREE_LONG_S, cs.TREE_LONG_BASE)):
        a = cs._tree_inputs(8, 8, 4, S, 128, 0, 16, torch.bfloat16, gen, base)
        err = cs.max_err(TK.tree_verify_attention_cuda(*a),
                         TK.tree_verify_attention_plain(*a))
        fn = functools.partial(TK.tree_verify_attention_cuda, *a)
        ms, dev = cs.time_ms(fn), cs.device_ms(fn)
        res[f"tree_{name}"] = {"S": S, "ms": ms, "device_ms": dev,
                               "max_abs_err": err}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
