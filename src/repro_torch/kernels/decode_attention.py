"""Paged GQA decode attention: the Hopper kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py::
paged_decode_attention`` (body ``_paged_kernel``), the serving path's hot
loop: one query per sequence against a shared (NB, bs, Kv, hd) K/V block
pool read through a (B, MB) int32 block table.  The CUDA source is
``csrc/paged_decode_attention.cu``; its header comment says what bounds it
on the H100 and how the design answers that.  ``paged_decode_attention_plain``
mirrors the JAX oracle ``kernels/ref.py::paged_decode_attention_ref``: gather
the table into a contiguous cache, then masked dense attention with masked
scores at -1e30.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import F, I, P, CudaKernel

NEG = -1e30

KERNEL = CudaKernel("paged_decode_attention.cu", "repro_paged_decode_attention",
                    [I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, P])

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_attention_plain(q, k_pool, v_pool, table, length, *,
                                 window: int = 0):
    """q: (B, Kv, G, hd); k_pool/v_pool: (NB, bs, Kv, hd); table: (B, MB)
    int32; length: (B,) int32 valid cache entries.  ``window`` > 0 keeps
    only the trailing ``window`` valid positions.  Returns (B, Kv, G, hd)
    in q's dtype."""
    B, Kv, G, hd = q.shape
    kk = k_pool[table.long()].reshape(B, -1, Kv, hd).movedim(2, 1)
    vv = v_pool[table.long()].reshape(B, -1, Kv, hd).movedim(2, 1)
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), kk.float()) / math.sqrt(hd)
    k_pos = torch.arange(kk.shape[2], device=q.device)
    ln = length.long()[:, None]
    mask = k_pos[None, :] < ln
    if window:
        mask = mask & (k_pos[None, :] >= ln - window)
    s = torch.where(mask[:, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bksd->bkgd", p, vv.float()).to(q.dtype)


def paged_decode_attention_cuda(q, k_pool, v_pool, table, length, *,
                                window: int = 0):
    """Launch the Hopper kernel (same contract as the plain version).
    Raises on anything the kernel does not take; never falls back."""
    B, Kv, G, hd = q.shape
    NB, bs, Kv2, hd2 = k_pool.shape
    MB = table.shape[1]
    if not all(t.is_cuda and t.device == q.device
               for t in (q, k_pool, v_pool, table, length)):
        raise ValueError("paged_decode_attention_cuda needs every tensor on "
                         "one CUDA device")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"q/k_pool/v_pool must share float32 or bfloat16, "
                        f"got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if table.dtype != torch.int32 or length.dtype != torch.int32:
        raise TypeError("table and length must be int32")
    if (Kv2, hd2) != (Kv, hd) or v_pool.shape != k_pool.shape \
            or table.shape != (B, MB) or length.shape != (B,):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, "
                         f"table {tuple(table.shape)}, length "
                         f"{tuple(length.shape)}")
    if hd % 32 or hd > 256 or G * hd > 4096 or G * (hd + bs + 3) > 12288:
        raise ValueError(f"unsupported head shape G={G} hd={hd} bs={bs}")
    if not all(t.is_contiguous() for t in (q, k_pool, v_pool, table, length)):
        raise ValueError("paged_decode_attention_cuda needs contiguous inputs")
    ns = MB if not window else min(MB, (window + bs - 2) // bs + 1)
    out = torch.empty_like(q)
    KERNEL.launch(_DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
                  v_pool.data_ptr(), table.data_ptr(), length.data_ptr(),
                  out.data_ptr(), B, Kv, G, hd, bs, MB, ns, int(window),
                  1.0 / math.sqrt(hd),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out
