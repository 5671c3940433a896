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
* ``tree_verify_attention`` — ``src/repro/kernels/tree_attention.py::
  tree_verify_attention``
* ``decode_attention`` — ``src/repro/kernels/decode_attention.py::
  decode_attention`` (dense caches)
* ``ssd_chunk_scan`` — ``src/repro/kernels/ssd_scan.py::ssd_chunk_scan``
  (the chunked SSD / mLSTM scan, with a carried state)

and two kernels of the port's own, with no TPU kernel behind them:
``flash_attention_bwd`` (the gradient of ``flash_attention``) and
``ssd_chunk_scan_bwd`` (the gradient of ``ssd_chunk_scan``).  Those two
scans are differentiable on both devices: on CUDA under grad they run the
forward and backward kernels (``flash_attention.FlashAttention``,
``ssd_scan.SSDChunkScan``), on the CPU autograd runs through the plain
version.  The other four kernels (the decode, tree-verify and
spec-verify kernels, serving only) have no backward and raise under grad
on CUDA.  ``launch_counts`` also reports the two backwards' launches per
route (``flash_attention_bwd/wgmma`` and ``.../cuda_cores``;
``ssd_chunk_scan_bwd/mma`` and ``.../cuda_cores``).
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import spec_verify as _verify
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import tree_attention as _tree

KERNELS = {"paged_decode_attention": _dec.KERNEL,
           "flash_attention": _flash.KERNEL,
           "spec_verify": _verify.KERNEL,
           "tree_verify_attention": _tree.KERNEL,
           "decode_attention": _dec.DENSE_KERNEL,
           "ssd_chunk_scan": _ssd.KERNEL,
           "flash_attention_bwd": _flash.BWD_KERNEL,
           "ssd_chunk_scan_bwd": _ssd.BWD_KERNEL}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
    for routes in (_flash.BWD_ROUTE_LAUNCHES, _ssd.BWD_ROUTE_LAUNCHES):
        for route in routes:
            routes[route] = 0


def launch_counts() -> dict:
    counts = {name: k.launches for name, k in KERNELS.items()}
    for route, n in _flash.BWD_ROUTE_LAUNCHES.items():
        counts[f"flash_attention_bwd/{route}"] = n
    for route, n in _ssd.BWD_ROUTE_LAUNCHES.items():
        counts[f"ssd_chunk_scan_bwd/{route}"] = n
    return counts


def paged_decode_attention(q, k_pool, v_pool, table, length, *, window=0):
    if q.is_cuda:
        return _dec.paged_decode_attention_cuda(q, k_pool, v_pool, table,
                                                length, window=window)
    return _dec.paged_decode_attention_plain(q, k_pool, v_pool, table, length,
                                             window=window)


def decode_attention(q, k, v, length, *, window=0):
    if q.is_cuda:
        return _dec.decode_attention_cuda(q, k, v, length, window=window)
    return _dec.decode_attention_plain(q, k, v, length, window=window)


def tree_verify_attention(q, k, v, length, tree_mask, q_pos, *, window=0):
    if q.is_cuda:
        return _tree.tree_verify_attention_cuda(q, k, v, length, tree_mask,
                                                q_pos, window=window)
    return _tree.tree_verify_attention_plain(q, k, v, length, tree_mask,
                                             q_pos, window=window)


def flash_attention(q, k, v, *, causal=True, window=0, prefix_len=0):
    if q.is_cuda:
        return _flash.flash_attention_kernel(q, k, v, causal=causal,
                                             window=window,
                                             prefix_len=prefix_len)
    return _flash.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        prefix_len=prefix_len)


def spec_verify(target_logits, draft_logits, draft_tokens, u_acc, u_res, *,
                temperature=1.0):
    if target_logits.is_cuda:
        return _verify.spec_verify_cuda(target_logits, draft_logits,
                                        draft_tokens, u_acc, u_res,
                                        temperature=temperature)
    return _verify.spec_verify_plain(target_logits, draft_logits,
                                     draft_tokens, u_acc, u_res,
                                     temperature=temperature)


def ssd_chunk_scan(q, k, v, log_a, log_i, *, chunk, state=None):
    if q.is_cuda:
        return _ssd.ssd_chunk_scan_kernel(q, k, v, log_a, log_i, chunk=chunk,
                                          state=state)
    return _ssd.ssd_chunk_scan_plain(q, k, v, log_a, log_i, chunk=chunk,
                                     state=state)
