"""Fused speculative verification: the Hopper kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/spec_verify.py::
spec_verify`` (body ``_kernel``) and its grouped form
``spec_verify_batched``.  In the port the serving engine's acceptance step
calls it directly, where the JAX engine runs a vmapped
``speculative_sample``.  The CUDA source is ``csrc/spec_verify.cu``; its
header comment says what bounds it on the H100 and how the design answers
that.

Contract (grouped): target_logits (G, gamma+1, V), draft_logits
(G, gamma, V), draft_tokens (G, gamma), and the uniforms u_acc, u_res
(G, gamma+1) drawn by the caller.  Returns (n_acc (G,), next_token (G,))
int32: the emitted tokens of group g are ``draft_tokens[g, :n_acc[g]] +
[next_token[g]]``.  At temperature 0 the next token is the first argmax of
the target row ``n_acc`` whatever the uniforms are (the inverse-CDF draw
would return token 0 for ``u_res == 0``); the accept test keeps the TPU
kernel's tie-split one-hots.  ``spec_verify_plain`` mirrors the JAX oracle
``kernels/ref.py::spec_verify_ref`` on the same uniforms.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import F, I, P, CudaKernel

KERNEL = CudaKernel("spec_verify.cu", "repro_spec_verify",
                    [P, P, P, P, P, P, P, P, I, I, I, F, P])


def _probs(logits, temperature: float):
    """softmax(l / T), or the tie-split one-hot of the maxima at T = 0."""
    if temperature == 0.0:
        p = (logits >= logits.amax(-1, keepdim=True)).float()
        return p / p.sum(-1, keepdim=True)
    return torch.softmax(logits / temperature, dim=-1)


def _finish(accept, resid_tok, argmax_tok, gamma: int, temperature: float):
    """Per-row flags/tokens (G, gamma+1) -> (n_acc, next_token)."""
    n_acc = torch.cumprod(accept[:, :gamma].int(), dim=1).sum(1)
    pick = argmax_tok if temperature == 0.0 else resid_tok
    nxt = pick.gather(1, n_acc.long()[:, None])[:, 0]
    return n_acc.int(), nxt.int()


def spec_verify_plain(target_logits, draft_logits, draft_tokens, u_acc, u_res,
                      *, temperature: float = 1.0):
    """Plain PyTorch version (see the module docstring for the contract)."""
    G, gamma, V = draft_logits.shape
    tl = target_logits.float()
    ql = torch.cat([draft_logits.float(),
                    torch.zeros((G, 1, V), device=tl.device)], dim=1)
    p = _probs(tl, temperature)
    q = _probs(ql, temperature)
    toks = torch.cat([draft_tokens.long(),
                      torch.zeros((G, 1), dtype=torch.long,
                                  device=tl.device)], dim=1)
    p_tok = p.gather(2, toks[..., None])[..., 0]
    q_tok = q.gather(2, toks[..., None])[..., 0]
    accept = u_acc < torch.clamp(p_tok / torch.clamp(q_tok, min=1e-20),
                                 max=1.0)
    bonus = (torch.arange(gamma + 1, device=tl.device) == gamma)[None, :, None]
    resid = torch.clamp(p - torch.where(bonus, 0.0, 1.0) * q, min=0.0)
    tot = resid.sum(-1, keepdim=True)
    resid = torch.where(tot > 0, resid / torch.clamp(tot, min=1e-20), p)
    cdf = torch.cumsum(resid, dim=-1)
    sel = (cdf < u_res[..., None]).sum(-1).clamp(max=V - 1)
    return _finish(accept, sel, tl.argmax(-1), gamma, temperature)


def spec_verify_cuda(target_logits, draft_logits, draft_tokens, u_acc, u_res,
                     *, temperature: float = 1.0):
    """Launch the Hopper kernel (same contract as the plain version).
    Raises on anything the kernel does not take; never falls back."""
    G, gamma, V = draft_logits.shape
    R = gamma + 1
    ts = (target_logits, draft_logits, draft_tokens, u_acc, u_res)
    if not all(t.is_cuda and t.device == target_logits.device for t in ts):
        raise ValueError("spec_verify_cuda needs every tensor on one CUDA "
                         "device")
    if target_logits.dtype != torch.float32 or draft_logits.dtype \
            != torch.float32 or u_acc.dtype != torch.float32 \
            or u_res.dtype != torch.float32 \
            or draft_tokens.dtype != torch.int32:
        raise TypeError("spec_verify_cuda takes float32 logits and uniforms "
                        "and int32 draft tokens")
    if target_logits.shape != (G, R, V) or draft_tokens.shape != (G, gamma) \
            or u_acc.shape != (G, R) or u_res.shape != (G, R):
        raise ValueError(f"shape mismatch: target {tuple(target_logits.shape)}"
                         f", draft {tuple(draft_logits.shape)}, tokens "
                         f"{tuple(draft_tokens.shape)}, uniforms "
                         f"{tuple(u_acc.shape)}/{tuple(u_res.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("spec_verify_cuda needs contiguous inputs")
    accept = torch.empty((G, R), dtype=torch.int32,
                         device=target_logits.device)
    resid_tok = torch.empty_like(accept)
    argmax_tok = torch.empty_like(accept)
    KERNEL.launch(target_logits.data_ptr(), draft_logits.data_ptr(),
                  draft_tokens.data_ptr(), u_acc.data_ptr(), u_res.data_ptr(),
                  accept.data_ptr(), resid_tok.data_ptr(),
                  argmax_tok.data_ptr(), G, gamma, V, float(temperature),
                  torch.cuda.current_stream(target_logits.device).cuda_stream)
    return _finish(accept, resid_tok, argmax_tok, gamma, temperature)
