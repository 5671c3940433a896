#!/usr/bin/env python3
"""Time variants of the flash backward's ``wgmma256`` kernel on one card,
to see what bounds it.

    python3 scripts/flash_bwd_variants.py [--reps 2] [--only NAME,...]

Each variant is ``csrc/flash_attention_bwd.cu`` with a few text
substitutions (``VARIANTS``): launch only the dK/dV or only the dQ
blocks, drop a product, stage the operand tiles with cp.async instead of
the Tensor Memory Accelerator, or keep only the loads of the dK/dV
blocks (on all of them, half of them, or with every block reading the
first sequence's rows, which L2 then holds).  Each is built with nvcc
under ``build/flash_bwd_variants/`` and timed on the device
(``chip_smoke.device_ms``: a CUDA graph of 20 calls) at paligemma-3b's
training shape, (B, H, Kv, S, hd) = (8, 8, 1, 512, 256) with prefix 256,
all variants in turns, ``--reps`` times.  A substitution whose pattern is
missing from the source fails the run.  Variants that skip work give
wrong gradients; only their time is read (each prints its largest
difference from ``full``).  Prints one line per variant and repetition,
the card's name and power limit, then one JSON object of device ms per
variant.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts this checkout's src on the path)

_LAUNCH = ("grads_kernel<<<dim3(Kv, B, n_kt + n_qt), kBlock, Smem::kBytes, "
           "s>>>(\n      a, m, n_kt, tma);")
_DKV_ONLY = (_LAUNCH, _LAUNCH.replace("n_kt + n_qt", "n_kt"))
_DQ_ONLY = (_LAUNCH, _LAUNCH.replace("n_kt + n_qt", "n_qt")
            .replace("a, m, n_kt, tma", "a, m, 0, tma"))
_HALF = (_LAUNCH, _LAUNCH.replace("dim3(Kv, B, n_kt + n_qt)",
                                  "dim3(Kv, (B + 1) / 2, n_kt)"))
_SCORES = ("    st_issue(st, ks, qs + 32 * wg * kTile);     // query rows 32 "
           "wg..\n    st_issue(dpt, vs, gs + 32 * wg * kTile);", "")
_UPDATES = ("    xy_issue(dv, pt, gs, wg);           // dV += P^T dO\n"
            "    xy_issue(dk, dst, qs, wg);          // dK += dS^T Q", "")
_CP_ASYNC = ("const bool tma = make_maps(a, B, Kv, &m);",
             "const bool tma = false && make_maps(a, B, Kv, &m);")
_ONE_SEQ = ("  const int kv = blockIdx.x, b = blockIdx.y, k0 = kt * kTile;",
            "  const int kv = blockIdx.x, b = 0, k0 = kt * kTile;")
_LOADS = [_DKV_ONLY, _SCORES, _UPDATES]
VARIANTS = {
    "full": [],
    "dkv_only": [_DKV_ONLY],
    "dq_only": [_DQ_ONLY],
    "dkv_no_scores": [_DKV_ONLY, _SCORES],
    "dkv_no_updates": [_DKV_ONLY, _UPDATES],
    "cp_async": [_CP_ASYNC],
    "dkv_loads_tma": _LOADS,
    "dkv_loads_cp_async": _LOADS + [_CP_ASYNC],
    "dkv_loads_cp_async_half": [_HALF, _SCORES, _UPDATES, _CP_ASYNC],
    "dkv_loads_cp_async_one_seq": _LOADS + [_CP_ASYNC, _ONE_SEQ],
}


def build(names):
    """Patch and compile each variant (one nvcc each, all at once)."""
    from repro_torch.kernels import build as B
    src = (B.CSRC / "flash_attention_bwd.cu").read_text()
    out = ROOT / "build" / "flash_bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: pattern not in the "
                                 f"source: {old[:60]!r}")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        so = out / f"{name}.so"
        procs[name] = so, subprocess.Popen(
            [B.nvcc(), *B.NVCC_FLAGS, f"-I{B.CSRC}", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} does not build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        fn = lib.repro_flash_attention_bwd
        fn.argtypes = [ctypes.c_char_p, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.repro_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        libs[name] = fn, err
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma-separated subset of " + ",".join(VARIANTS))
    args = ap.parse_args()
    names = [n for n in args.only.split(",") if n]
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}")
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as K
    libs = build(names)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    case = next(c for c in cs.STUB_FLASH_BWD if c[0] == "prefix_train")
    q, k, v, dout = cs._stub_flash_inputs(case, torch.bfloat16, gen)
    kw = dict(causal=case[7], prefix_len=case[8])
    with torch.no_grad():
        o, lse = K.flash_attention_cuda(q, k, v, return_lse=True, **kw)

    def bwd():
        return K.flash_attention_bwd_cuda(q, k, v, o, lse, dout, **kw)

    ref, res = None, {}
    for _ in range(args.reps):
        for name in names:
            K.BWD_KERNEL._fn, K.BWD_KERNEL._err = libs[name]
            g = bwd()
            torch.cuda.synchronize()
            ref = g if ref is None or name == "full" else ref
            diff = max(cs.max_err(a, b) for a, b in zip(g, ref))
            dev = cs.device_ms(bwd)
            res.setdefault(name, []).append(dev)
            print(f"[variant] {name}: {dev:.5f} ms on the device (max "
                  f"difference from full {diff:.2e})", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    print(smi.stdout.strip())
    print(json.dumps({"shape": case[1:], "device_ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
