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

Gradients: ``flash_attention_cuda`` is a forward-only launch and raises
when grad mode is on and an input requires grad (ctypes hides it from
autograd, so it would detach the gradient silently).  ``flash_attention_
kernel`` is the CUDA entry the model calls: under grad it runs
``FlashAttention``, a ``torch.autograd.Function`` whose forward is the same
kernel writing each row's log-sum-exp as well and whose backward is the
hand-written ``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd_cuda``);
otherwise the forward-only launch.  The plain backward is autograd through
``flash_attention_plain``.
"""
from __future__ import annotations

import math
import struct

import torch

from repro_torch.kernels.build import (F, P, PACKED, CudaKernel, raw_stream,
                                      refuse_grad)

NEG = -1e30

KERNEL = CudaKernel("flash_attention.cu", "repro_flash_attention",
                    [PACKED, F, P])
BWD_KERNEL = CudaKernel("flash_attention_bwd.cu", "repro_flash_attention_bwd",
                        [PACKED, F, P])
_ARGS = struct.Struct("23q")     # the C entry's packed int64 arguments
_BWD_ARGS = struct.Struct("43q")

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


def _check(q, k, v):
    B, H, Sq, hd = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash attention needs q, k, v on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, Kv, Sk, hd) or v.shape != k.shape or Kv == 0 \
            or H % Kv or hd > 256:
        raise ValueError(f"unsupported shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         return_lse: bool = False):
    """Launch the Hopper kernel (same contract as the plain version; q, k,
    v may be strided views with a contiguous head dim, k and v with equal
    strides).  Returns a tensor laid out like ``q`` and, with
    ``return_lse``, each row's log-sum-exp of its scaled scores (B, H, Sq)
    float32.  Raises on anything the kernel does not take, and under grad
    (``flash_attention_kernel`` is the differentiable entry); never falls
    back."""
    refuse_grad("flash_attention_cuda", q, k, v)
    _check(q, k, v)
    B, H, Sq, hd = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    if q.stride(3) != 1 or k.stride(3) != 1 or k.stride() != v.stride():
        raise ValueError("flash_attention_cuda needs a contiguous head dim "
                         "and k, v with equal strides")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    KERNEL.launch(_ARGS.pack(_DTYPES[q.dtype], q.data_ptr(), *q.stride()[:3],
                             k.data_ptr(), v.data_ptr(), *k.stride()[:3],
                             out.data_ptr(), *out.stride()[:3], B, H, Kv, Sq,
                             Sk, hd, int(bool(causal)), int(window),
                             0 if lse is None else lse.data_ptr()),
                  1.0 / math.sqrt(hd), raw_stream(q))
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal: bool = True,
                             window: int = 0):
    """Launch the Hopper backward: (dq, dk, dv) of the attention whose
    forward gave ``out`` and ``lse`` (``flash_attention_cuda(...,
    return_lse=True)``) for the output gradient ``dout``.  q, out and dout
    (B, H, Sq, hd), k and v (B, Kv, Sk, hd) may be strided views with a
    contiguous head dim; dq, dk and dv come laid out like q, k and v.
    Raises on anything the kernel does not take; never falls back."""
    _check(q, k, v)
    B, H, Sq, hd = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous (B, H, Sq) float32 "
                         f"tensor on {q.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    ins = (q, k, v, out, dout)
    if any(t.stride(3) != 1 for t in ins):
        raise ValueError("flash_attention_bwd_cuda needs a contiguous head "
                         "dim on q, k, v, out and dout")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    args = [_DTYPES[q.dtype]]
    for t in ins + (dq, dk, dv):
        args += [t.data_ptr(), *t.stride()[:3]]
    args += [lse.data_ptr(), delta.data_ptr(), B, H, Kv, Sq, Sk, hd,
             int(bool(causal)), int(window)]
    BWD_KERNEL.launch(_BWD_ARGS.pack(*args), 1.0 / math.sqrt(hd),
                      raw_stream(q))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention on the card: the forward kernel with
    its log-sum-exp saved, the backward kernel for the gradients.  A
    ``dout`` whose head dim is not contiguous (an expanded gradient) is
    made contiguous before the backward launch."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(3) != 1:
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                              causal=ctx.causal,
                                              window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0):
    """The model's CUDA entry: ``FlashAttention`` (forward and backward
    kernels) when grad mode is on and an input requires grad, else the
    forward-only launch."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, bool(causal), int(window))
    return flash_attention_cuda(q, k, v, causal=causal, window=window)
