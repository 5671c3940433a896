"""Tiled online-softmax (flash) attention: the Hopper kernel's wrapper and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention`` (body ``_kernel``).  Same public contract: q, k, v
(B, H, S, hd) with the KV heads already expanded over GQA groups, a
``causal`` flag and a sliding ``window``.  The CUDA source is
``csrc/flash_attention.cu``; its header comment says what bounds it on the
H100 and how the design answers that.  Unlike the TPU kernel it needs no
``S % block == 0``.  ``flash_attention_plain`` mirrors the JAX oracle
``kernels/ref.py::flash_attention_ref`` (masked scores at -1e30).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import F, I, P, CudaKernel

NEG = -1e30

KERNEL = CudaKernel("flash_attention.cu", "repro_flash_attention",
                    [I, P, P, P, P, I, I, I, I, I, I, I, F, P])

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, hd); k, v: (B, H, Sk, hd).  Returns (B, H, Sq, hd) in
    q's dtype."""
    Sq, hd = q.shape[2], q.shape[3]
    Sk = k.shape[2]
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
    """Launch the Hopper kernel (same contract as the plain version).
    Raises on anything the kernel does not take; never falls back."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, H, Sk, hd) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hd % 32 or hd > 256:
        raise ValueError(f"unsupported head dim {hd} (a multiple of 32, "
                         "at most 256)")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs contiguous inputs")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    KERNEL.launch(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), B, H, Sq, Sk, hd, int(bool(causal)),
                  int(window), 1.0 / math.sqrt(hd),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out
