"""Device dispatch for the port's kernels (the twin of the JAX package's
``kernels/ops.py``): a tensor on a CUDA device runs the hand-written Hopper
kernel, a tensor on the CPU runs the kernel's plain PyTorch version.  The
choice is made from where the tensor lies, nothing else: a CUDA kernel that
fails to build or launch raises.

Ported kernels (TPU kernel they replace):

* ``paged_decode_attention`` — ``src/repro/kernels/decode_attention.py::
  paged_decode_attention``
* ``flash_attention`` — ``src/repro/kernels/flash_attention.py::
  flash_attention``
* ``spec_verify`` — ``src/repro/kernels/spec_verify.py::spec_verify`` and
  ``spec_verify_batched`` (grouped)
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import spec_verify as _verify

KERNELS = {"paged_decode_attention": _dec.KERNEL,
           "flash_attention": _flash.KERNEL,
           "spec_verify": _verify.KERNEL}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def paged_decode_attention(q, k_pool, v_pool, table, length, *, window=0):
    if q.is_cuda:
        return _dec.paged_decode_attention_cuda(q, k_pool, v_pool, table,
                                                length, window=window)
    return _dec.paged_decode_attention_plain(q, k_pool, v_pool, table, length,
                                             window=window)


def flash_attention(q, k, v, *, causal=True, window=0):
    if q.is_cuda:
        return _flash.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window)
    return _flash.flash_attention_plain(q, k, v, causal=causal, window=window)


def spec_verify(target_logits, draft_logits, draft_tokens, u_acc, u_res, *,
                temperature=1.0):
    if target_logits.is_cuda:
        return _verify.spec_verify_cuda(target_logits, draft_logits,
                                        draft_tokens, u_acc, u_res,
                                        temperature=temperature)
    return _verify.spec_verify_plain(target_logits, draft_logits,
                                     draft_tokens, u_acc, u_res,
                                     temperature=temperature)
