"""Tiled online-softmax (flash) attention: the Hopper kernel's wrapper and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention`` (body ``_kernel``): q (B, H, S, hd) against k, v with a
``causal`` flag and a sliding ``window``.  The JAX contract has K/V already
expanded to H heads; both versions here also take K/V with Kv heads, H % Kv
== 0 (query head h reads kv head h // (H // Kv)), and the CUDA wrapper
takes q, k, v as strided views with a contiguous head dim, so the model
passes its (B, S, heads, hd) projections without a copy and gets the output
laid out like q.  The CUDA source is ``csrc/flash_attention.cu``; its
header comment says what bounds it on the H100 and how the design answers
that.  Unlike the TPU kernel it needs no ``S % block == 0``.
``flash_attention_plain`` mirrors the JAX oracle ``kernels/ref.py::
flash_attention_ref`` (masked scores at -1e30).
"""
from __future__ import annotations

import math
import struct

import torch

from repro_torch.kernels.build import F, P, PACKED, CudaKernel, raw_stream

NEG = -1e30

KERNEL = CudaKernel("flash_attention.cu", "repro_flash_attention",
                    [PACKED, F, P])
_ARGS = struct.Struct("22q")     # the C entry's packed int64 arguments

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, hd); k, v: (B, Kv, Sk, hd) with H % Kv == 0.  Returns
    (B, H, Sq, hd) in q's dtype."""
    Sq, hd = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    G = q.shape[1] // k.shape[1]
    if G > 1:
        k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = k_pos <= q_pos
    if window:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the Hopper kernel (same contract as the plain version; q, k,
    v may be strided views with a contiguous head dim, k and v with equal
    strides).  Returns a tensor laid out like ``q``.  Raises on anything
    the kernel does not take; never falls back."""
    B, H, Sq, hd = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, Kv, Sk, hd) or v.shape != k.shape or Kv == 0 \
            or H % Kv or hd > 256:
        raise ValueError(f"unsupported shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.stride(3) != 1 or k.stride(3) != 1 or k.stride() != v.stride():
        raise ValueError("flash_attention_cuda needs a contiguous head dim "
                         "and k, v with equal strides")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    KERNEL.launch(_ARGS.pack(_DTYPES[q.dtype], q.data_ptr(), *q.stride()[:3],
                             k.data_ptr(), v.data_ptr(), *k.stride()[:3],
                             out.data_ptr(), *out.stride()[:3], B, H, Kv, Sq,
                             Sk, hd, int(bool(causal)), int(window)),
                  1.0 / math.sqrt(hd), raw_stream(q))
    return out
