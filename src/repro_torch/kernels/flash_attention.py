"""Tiled online-softmax (flash) attention: the Hopper kernel's wrapper and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention`` (body ``_kernel``): q (B, H, S, hd) against k, v with a
``causal`` flag and a sliding ``window``; beyond it, a ``prefix_len`` makes
the first keys visible to every query under ``causal`` (prefix-LM, the
vlm family's image prefix: key k is visible to query q when ``k <= q or k
< prefix_len``, then ``k > q - window`` under a window — the JAX model's
``layers._attn_mask``), and a non-causal call may take Sq != Sk (cross
attention).  The JAX contract has K/V already
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

The backward has two routes, chosen by ``flash_bwd_plan`` from the dtype
and the head dim alone: ``wgmma`` (bfloat16 with hd <= 128 — every
attention family the port trains) runs its products on the tensor cores
over 64-row query tiles packed over a kv head's G query heads and 64-key
tiles; ``cuda_cores`` (float32, the exact parity path, and bfloat16 with
hd 144-256) runs them in float32 on the CUDA cores over 32-row per-head
query tiles and 32-key tiles.  The plan also gives the tiles each block
walks (the causal limit and the window bound them), as the kernels walk
them.  A route is never taken on a failure: the kernel raises.  The
``launch_counts`` of ``ops`` report the backward's launches per route.
"""
from __future__ import annotations

import functools
import math
import struct
from dataclasses import dataclass

import torch

from repro_torch.kernels.build import (F, P, PACKED, CudaKernel, raw_stream,
                                      refuse_grad)

NEG = -1e30

KERNEL = CudaKernel("flash_attention.cu", "repro_flash_attention",
                    [PACKED, F, P])
BWD_KERNEL = CudaKernel("flash_attention_bwd.cu", "repro_flash_attention_bwd",
                        [PACKED, F, P])
_ARGS = struct.Struct("24q")     # the C entry's packed int64 arguments
_BWD_ARGS = struct.Struct("45q")
BWD_ROUTES = ("cuda_cores", "wgmma")     # the C entry's route numbers
# launches of the backward kernel per route (BWD_KERNEL.launches counts all)
BWD_ROUTE_LAUNCHES = dict.fromkeys(BWD_ROUTES, 0)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          prefix_len: int = 0):
    """q: (B, H, Sq, hd); k, v: (B, Kv, Sk, hd) with H % Kv == 0.  Returns
    (B, H, Sq, hd) in q's dtype.  ``prefix_len`` counts only under
    ``causal``."""
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
        if prefix_len:
            mask = mask | (k_pos < prefix_len)
    if window:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


@dataclass(frozen=True)
class BwdPlan:
    """How the backward kernel tiles one call: ``route``, the rows of a
    query tile and the keys of a key tile (``tile``), and ``pack`` query
    heads per tile row set (a kv head's G heads on ``wgmma``, where packed
    row r is position r // G of head kv * G + r % G; 1 on ``cuda_cores``,
    whose query tiles belong to one head).  Tiles count per (kv head, or
    head on ``cuda_cores``, sequence).  ``prefix`` is the causal call's
    ``prefix_len`` (0 otherwise)."""
    route: str
    tile: int
    pack: int
    Sq: int
    Sk: int
    causal: bool
    window: int
    prefix: int = 0

    @property
    def n_query_tiles(self) -> int:
        return -(-self.pack * self.Sq // self.tile)

    @property
    def n_key_tiles(self) -> int:
        return -(-self.Sk // self.tile)

    def query_tiles(self, kt: int) -> range:
        """The query tiles that can see a key of key tile ``kt``: those
        its dK/dV block walks (on ``wgmma`` its two warpgroups taking
        alternate tiles)."""
        k0 = kt * self.tile
        k_last = min(k0 + self.tile, self.Sk) - 1
        p_begin = k0 if self.causal and k0 >= self.prefix else 0
        p_end = min(k_last + self.window, self.Sq) if self.window \
            else self.Sq
        if p_end <= p_begin:
            return range(0)
        return range(p_begin * self.pack // self.tile,
                     -(-p_end * self.pack // self.tile))

    def key_tiles(self, qt: int) -> range:
        """The key tiles that a row of query tile ``qt`` can see (the
        forward's bounds): a dQ block walks those of its rows (on
        ``wgmma`` two query tiles, the union of theirs)."""
        r0 = qt * self.tile
        p_first = r0 // self.pack
        p_last = (min(r0 + self.tile, self.pack * self.Sq) - 1) // self.pack
        k_begin = max(p_first - self.window + 1, 0) if self.window else 0
        k_end = max(min(p_last + 1, self.Sk), min(self.prefix, self.Sk)) \
            if self.causal else self.Sk
        first = k_begin // self.tile
        if k_end <= first * self.tile:
            return range(0)
        return range(first, -(-k_end // self.tile))


@functools.lru_cache(maxsize=256)
def flash_bwd_plan(dtype, hd: int, G: int, Sq: int, Sk: int, causal: bool,
                   window: int, prefix_len: int = 0) -> BwdPlan:
    """The backward's plan from shapes alone: the ``wgmma`` route for
    bfloat16 with hd <= 128, else ``cuda_cores``."""
    shape = (Sq, Sk, bool(causal), int(window),
             int(prefix_len) if causal else 0)
    if dtype == torch.bfloat16 and hd <= 128:
        return BwdPlan("wgmma", 64, G, *shape)
    return BwdPlan("cuda_cores", 32, 1, *shape)


def _check(q, k, v, prefix_len=0):
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
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         prefix_len: int = 0, return_lse: bool = False):
    """Launch the Hopper kernel (same contract as the plain version; q, k,
    v may be strided views with a contiguous head dim, k and v with equal
    strides).  Returns a tensor laid out like ``q`` and, with
    ``return_lse``, each row's log-sum-exp of its scaled scores (B, H, Sq)
    float32.  Raises on anything the kernel does not take, and under grad
    (``flash_attention_kernel`` is the differentiable entry); never falls
    back."""
    refuse_grad("flash_attention_cuda", q, k, v)
    _check(q, k, v, prefix_len)
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
                             0 if lse is None else lse.data_ptr(),
                             int(prefix_len) if causal else 0),
                  1.0 / math.sqrt(hd), raw_stream(q))
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal: bool = True,
                             window: int = 0, prefix_len: int = 0):
    """Launch the Hopper backward: (dq, dk, dv) of the attention whose
    forward gave ``out`` and ``lse`` (``flash_attention_cuda(...,
    return_lse=True)``) for the output gradient ``dout``.  q, out and dout
    (B, H, Sq, hd), k and v (B, Kv, Sk, hd) may be strided views with a
    contiguous head dim; dq, dk and dv come laid out like q, k and v.
    The route is ``flash_bwd_plan``'s.  Raises on anything the kernel does
    not take; never falls back."""
    _check(q, k, v, prefix_len)
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
    plan = flash_bwd_plan(q.dtype, hd, H // Kv, Sq, Sk, bool(causal),
                          int(window), int(prefix_len))
    route = plan.route
    args += [lse.data_ptr(), delta.data_ptr(), B, H, Kv, Sq, Sk, hd,
             int(bool(causal)), int(window), BWD_ROUTES.index(route),
             plan.prefix]
    BWD_KERNEL.launch(_BWD_ARGS.pack(*args), 1.0 / math.sqrt(hd),
                      raw_stream(q))
    BWD_ROUTE_LAUNCHES[route] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention on the card: the forward kernel with
    its log-sum-exp saved, the backward kernel for the gradients.  A
    ``dout`` whose head dim is not contiguous (an expanded gradient) is
    made contiguous before the backward launch."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len):
        out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                        prefix_len=prefix_len,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.prefix_len = causal, window, prefix_len
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(3) != 1:
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                              causal=ctx.causal,
                                              window=ctx.window,
                                              prefix_len=ctx.prefix_len)
        return dq, dk, dv, None, None, None


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0,
                           prefix_len: int = 0):
    """The model's CUDA entry: ``FlashAttention`` (forward and backward
    kernels) when grad mode is on and an input requires grad, else the
    forward-only launch."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, bool(causal), int(window),
                                    int(prefix_len))
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                prefix_len=prefix_len)
