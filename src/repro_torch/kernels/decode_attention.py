"""GQA decode attention, paged and dense: the Hopper kernels' wrappers and
their plain PyTorch versions.

* Paged: replaces the Pallas TPU kernel ``src/repro/kernels/
  decode_attention.py::paged_decode_attention`` (body ``_paged_kernel``),
  the serving path's hot loop: one query per sequence against a shared
  (NB, bs, Kv, hd) K/V block pool read through a (B, MB) int32 block table.
  CUDA source ``csrc/paged_decode_attention.cu``.
  ``paged_decode_attention_plain`` mirrors the JAX oracle
  ``kernels/ref.py::paged_decode_attention_ref``: gather the table into a
  contiguous cache, then masked dense attention.
* Dense: replaces ``src/repro/kernels/decode_attention.py::
  decode_attention`` (body ``_kernel``): one query per sequence against its
  own (Kv, S, hd) cache — the dense layout's decode ticks.  CUDA source
  ``csrc/decode_attention.cu``; the wrapper takes K/V as strided views, so
  the serving cache's (B, S, Kv, hd) layout goes in without a copy, and any
  S (the TPU kernel's ``S % bs == 0`` is a tiling limit of that machine).
  ``decode_attention_plain`` mirrors ``kernels/ref.py::
  decode_attention_ref``.

Each CUDA source's header comment says what bounds it on the H100 and how
the design answers that.  Masked scores are -1e30, as in the JAX package.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import (F, I, L, P, CudaKernel, raw_stream,
                                      refuse_grad, sm_count)

NEG = -1e30

KERNEL = CudaKernel("paged_decode_attention.cu", "repro_paged_decode_attention",
                    [I] + [P] * 7 + [I] * 10 + [F, P])
DENSE_KERNEL = CudaKernel("decode_attention.cu", "repro_decode_attention",
                          [I] + [P] * 6 + [I] * 5 + [L] * 3 + [I] * 3
                          + [F, P])

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


# the decode kernels' split of the key range (csrc/paged_decode_attention.cu,
# csrc/decode_attention.cu)
PAGED_ROWS = 4             # query rows of a block: G goes in groups of 4
PAGED_MIN_ENTRIES = 8      # table entries a split walks at least
PAGED_MAX_ENTRIES = 4096   # the block's table slice in shared memory
DENSE_MIN_POSITIONS = 256  # cache positions a dense split walks at least


def _splits(blocks: int, ns: int, least: int, most: int, sms: int):
    """(nsplit, units per split) for ``ns`` walked units (table entries or
    positions) over ``blocks`` blocks a split: enough splits that the grid
    covers two blocks per SM, none walking fewer than ``least`` units (or
    more than ``most``)."""
    want = -(-2 * sms // blocks)
    nsplit = max(1, min(want, ns // least), -(-ns // most))
    eps = -(-ns // nsplit)
    return -(-ns // eps), eps


def paged_walk(MB: int, bs: int, window: int) -> int:
    """Table entries the kernel walks per sequence: all MB, or with a
    window the at most ``(window + bs - 2) // bs + 1`` blocks that can
    hold its positions (the JAX kernel's ``ns``)."""
    return MB if not window else min(MB, (window + bs - 2) // bs + 1)


def paged_splits(B: int, Kv: int, G: int, ns: int, sms: int = 132):
    """(nsplit, entries per split) for ``ns`` walked table entries: enough
    splits that the grid covers two blocks per SM, none walking fewer than
    ``PAGED_MIN_ENTRIES`` entries (or more than ``PAGED_MAX_ENTRIES``).
    From shapes only — the lengths stay on the device."""
    return _splits(B * Kv * -(-G // PAGED_ROWS), ns, PAGED_MIN_ENTRIES,
                   PAGED_MAX_ENTRIES, sms)


def dense_splits(B: int, Kv: int, G: int, S: int, window: int,
                 sms: int = 132):
    """(nsplit, positions per split) of the dense kernel over an S-position
    cache: it walks at most S positions, or ``window`` with a window, and
    splits them like the paged kernel, none walking fewer than
    ``DENSE_MIN_POSITIONS``.  From shapes only."""
    ns = min(S, window) if window else S
    return _splits(B * Kv * -(-G // PAGED_ROWS), max(ns, 1),
                   DENSE_MIN_POSITIONS, max(ns, 1), sms)


def paged_decode_attention_cuda(q, k_pool, v_pool, table, length, *,
                                window: int = 0):
    """Launch the Hopper kernel (same contract as the plain version).
    Raises on anything the kernel does not take (and under grad: it has no
    backward); never falls back."""
    refuse_grad("paged_decode_attention_cuda", q, k_pool, v_pool)
    B, Kv, G, hd = q.shape
    NB, bs, Kv2, hd2 = k_pool.shape
    MB = table.shape[1]
    dev = q.device
    if not (q.is_cuda and k_pool.device == dev and v_pool.device == dev
            and table.device == dev and length.device == dev):
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
    if hd > 256:
        raise ValueError(f"unsupported head dim {hd} (at most 256)")
    if not (q.is_contiguous() and k_pool.is_contiguous()
            and v_pool.is_contiguous() and table.is_contiguous()
            and length.is_contiguous()):
        raise ValueError("paged_decode_attention_cuda needs contiguous inputs")
    ns = paged_walk(MB, bs, window)
    nsplit, eps = paged_splits(B, Kv, G, ns, sm_count(dev))
    out = torch.empty_like(q)
    part = torch.empty((B * Kv * G * nsplit * (hd + 2),), dtype=torch.float32,
                       device=dev) if nsplit > 1 else None
    KERNEL.launch(_DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
                  v_pool.data_ptr(), table.data_ptr(), length.data_ptr(),
                  out.data_ptr(), part if part is None else part.data_ptr(),
                  B, Kv, G, hd, bs, MB, ns,
                  int(window), nsplit, eps, 1.0 / math.sqrt(hd),
                  raw_stream(q))
    return out


# ---------------------------------------------------------------- dense
def decode_attention_plain(q, k, v, length, *, window: int = 0):
    """q: (B, Kv, G, hd); k, v: (B, Kv, S, hd) (any strides); length: (B,)
    int32 — the query attends cache positions < length.  ``window`` > 0
    keeps only the trailing ``window`` of them.  Returns (B, Kv, G, hd) in
    q's dtype."""
    hd = q.shape[-1]
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k.float()) / math.sqrt(hd)
    k_pos = torch.arange(k.shape[2], device=q.device)
    ln = length.long()[:, None]
    mask = k_pos[None, :] < ln
    if window:
        mask = mask & (k_pos[None, :] >= ln - window)
    s = torch.where(mask[:, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bksd->bkgd", p, v.float()).to(q.dtype)


def decode_attention_cuda(q, k, v, length, *, window: int = 0):
    """Launch the Hopper dense decode kernel (same contract as the plain
    version; q contiguous, k and v views with the head dim contiguous and
    equal strides).  Raises on anything the kernel does not take (and under
    grad: it has no backward); never falls back."""
    refuse_grad("decode_attention_cuda", q, k, v)
    B, Kv, G, hd = q.shape
    S = k.shape[2]
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v, length)):
        raise ValueError("decode_attention_cuda needs every tensor on one "
                         "CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if length.dtype != torch.int32:
        raise TypeError("length must be int32")
    if k.shape != (B, Kv, S, hd) or v.shape != k.shape \
            or length.shape != (B,):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, length "
                         f"{tuple(length.shape)}")
    if hd > 256:
        raise ValueError(f"unsupported head dim {hd} (at most 256)")
    if not (q.is_contiguous() and length.is_contiguous()) \
            or k.stride() != v.stride() or k.stride(3) != 1:
        raise ValueError("decode_attention_cuda needs q and length "
                         "contiguous, and k, v with equal strides and a "
                         "contiguous head dim")
    nsplit, eps = dense_splits(B, Kv, G, S, window, sm_count(q.device))
    out = torch.empty_like(q)
    part = torch.empty((B * Kv * G * nsplit * (hd + 2),), dtype=torch.float32,
                       device=q.device) if nsplit > 1 else None
    sb, sh, ss, _ = k.stride()
    DENSE_KERNEL.launch(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), length.data_ptr(), out.data_ptr(),
                        part if part is None else part.data_ptr(), B, Kv, G,
                        hd, S, sb, sh, ss, int(window), nsplit, eps,
                        1.0 / math.sqrt(hd), raw_stream(q))
    return out
