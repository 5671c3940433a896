"""Token-tree verification attention: the Hopper kernel's wrapper and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/tree_attention.py::
tree_verify_attention`` (body ``_kernel``): N tree-node queries per sequence
over the committed cache prefix plus an (N, C) ancestor mask, C >= N, whose
last N columns are this call's new rows and whose first C - N columns cover
tree rows an earlier draft level already wrote.  Every tree draft level and
every tree verify of the ``tree`` speculation lane runs it
(``models/layers.py::extend_attention`` with a block mask).  The CUDA source
is ``csrc/tree_verify_attention.cu``; its header comment says what bounds it
on the H100 and how the design answers that.  Unlike the TPU kernel it pads
nothing (the ragged tail is masked), and it reads q, K, V and writes the
output through strides, so the serving cache goes in as a view.  When the
grid would leave most of the card idle and the cache is long, the kernel
splits each block's key range (``split_plan``) and combines the partial
softmaxes in a second pass of the same call.
``tree_verify_attention_plain`` mirrors the JAX oracle
``kernels/ref.py::tree_verify_attention_ref`` (masked scores at -1e30).
"""
from __future__ import annotations

import math
import struct

import torch

from repro_torch.kernels.build import (F, P, PACKED, CudaKernel, raw_stream,
                                      refuse_grad, sm_count)

NEG = -1e30
ROWS = 64           # query rows (G * N, packed) per block
KEYS = 64           # keys per tile of the bf16 kernel
MIN_SPLIT_TILES = 4

KERNEL = CudaKernel("tree_verify_attention.cu", "repro_tree_verify_attention",
                    [PACKED, F, P])
_ARGS = struct.Struct("29q")     # the C entry's packed int64 arguments

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def split_plan(blocks: int, key_tiles: int, n_sm: int) -> int:
    """Key-range splits per block of the tree kernel: 1 unless the grid of
    ``blocks`` fills under half of the ``n_sm`` SMs; then as many as fill
    one wave, keeping at least ``MIN_SPLIT_TILES`` of the ``key_tiles`` to
    each split (fewer would not pay for the combine pass)."""
    if 2 * blocks > n_sm:
        return 1
    return max(1, min(n_sm // blocks, key_tiles // MIN_SPLIT_TILES))


def tree_verify_attention_plain(q, k, v, length, tree_mask, q_pos, *,
                                window: int = 0):
    """q: (B, Kv, G, N, hd); k, v: (B, Kv, S, hd) — the cache AFTER this
    call's N rows were written at [length, length + N); length: (B,) valid
    entries BEFORE them; tree_mask: (N, C) bool, C >= N; q_pos: (B, N)
    per-node positions (tree base + depth) for the window.  Returns
    (B, Kv, G, N, hd) in q's dtype."""
    N, C = tree_mask.shape
    S, hd = k.shape[2], q.shape[-1]
    s = torch.einsum("bkgnd,bksd->bkgns", q.float(), k.float()) / \
        math.sqrt(hd)
    base = length.long() - (C - N)                                  # (B,)
    k_pos = torch.arange(S, device=q.device)
    in_cache = k_pos[None, :] < base[:, None]                       # (B, S)
    t = k_pos[None, :] - base[:, None]                              # (B, S)
    in_tree = (t >= 0) & (t < C)
    cols = tree_mask.bool()[:, t.clamp(0, C - 1)].movedim(1, 0)     # (B,N,S)
    mask = in_cache[:, None, :] | (in_tree[:, None, :] & cols)
    if window:
        mask = mask & (k_pos[None, None, :] > q_pos.long()[:, :, None] - window)
    s = torch.where(mask[:, None, None], s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgns,bksd->bkgnd", p, v.float()).to(q.dtype)


def tree_verify_attention_cuda(q, k, v, length, tree_mask, q_pos, *,
                               window: int = 0):
    """Launch the Hopper kernel (same contract as the plain version; q, k, v
    may be strided views with a contiguous head dim, k and v with equal
    strides).  Returns a tensor laid out like ``q``.  Raises on anything
    the kernel does not take (and under grad: it has no backward); never
    falls back."""
    refuse_grad("tree_verify_attention_cuda", q, k, v)
    B, Kv, G, N, hd = q.shape
    S = k.shape[2]
    C = tree_mask.shape[1]
    ts = (q, k, v, length, tree_mask, q_pos)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("tree_verify_attention_cuda needs every tensor on "
                         "one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if length.dtype != torch.int32 or q_pos.dtype != torch.int32 \
            or tree_mask.dtype != torch.bool:
        raise TypeError("length and q_pos must be int32, tree_mask bool")
    if k.shape != (B, Kv, S, hd) or v.shape != k.shape \
            or length.shape != (B,) or tree_mask.shape != (N, C) \
            or q_pos.shape != (B, N) or C < N:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, length "
                         f"{tuple(length.shape)}, mask "
                         f"{tuple(tree_mask.shape)}, q_pos "
                         f"{tuple(q_pos.shape)}")
    if hd > 256:
        raise ValueError(f"unsupported head dim {hd} (at most 256)")
    if q.stride(4) != 1 or k.stride(3) != 1 or k.stride() != v.stride() \
            or not all(t.is_contiguous() for t in (length, tree_mask,
                                                   q_pos)):
        raise ValueError("tree_verify_attention_cuda needs a contiguous head "
                         "dim, k and v with equal strides, and contiguous "
                         "length, mask and q_pos")
    out = torch.empty_like(q)
    splits = split_plan(B * Kv * -(-G * N // ROWS), -(-S // KEYS),
                        sm_count(q.get_device()))
    part = torch.empty(splits * B * Kv * G * N * (hd + 2),
                       dtype=torch.float32, device=q.device) \
        if splits > 1 else None
    KERNEL.launch(_ARGS.pack(_DTYPES[q.dtype], q.data_ptr(), *q.stride()[:4],
                             k.data_ptr(), v.data_ptr(), *k.stride()[:3],
                             length.data_ptr(), tree_mask.data_ptr(),
                             q_pos.data_ptr(), out.data_ptr(),
                             *out.stride()[:4],
                             0 if part is None else part.data_ptr(), B, Kv,
                             G, N, C, hd, S, int(window), splits),
                  1.0 / math.sqrt(hd), raw_stream(q))
    return out
