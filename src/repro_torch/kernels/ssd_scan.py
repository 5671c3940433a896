"""Chunked gated-linear-attention (SSD / mLSTM) scan: the Hopper kernel's
wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py::
ssd_chunk_scan`` (body ``_kernel``).  The contract is that of the JAX
package's ``models/ssm.py::gla_chunked``, which is what the serving path
calls:

* q, k (B, S, H, N), v (B, S, H, P) in float32 or bfloat16 — any strides
  with the last dim contiguous, so mamba2's one ``B``/``C`` projection goes
  in as a head-broadcast view (head stride 0);
* log_a, log_i (B, S, H) float32 gates;
* an optional carried state ``(S (B, H, N, P), n (B, H, N), m (B, H))``,
  float32 (None: zeros and a log-max of -1e30);
* returns ``(y_num (B, S, H, P), den (B, S, H), m (B, S, H), (S, n, m))``
  in float32: outputs stabilised by exp(-m), and the final state.

The chunk length is ``Q = min(chunk, S)``; a ragged S is FRONT-padded to a
multiple of Q with k = v = 0 and log_i = -1e30, so the chunk boundaries,
and with them the stabiliser ``m``, are those of the JAX package (mLSTM's
denominator ``max(|den|, exp(-m))`` depends on them).  The TPU kernel
needs ``S % Q == 0`` and writes no final state; the CUDA kernel pads in
its own indexing and returns the state.  The CUDA source is
``csrc/ssd_scan.cu``; its header comment says what bounds it on the H100
and how the design answers that.  ``ssd_chunk_scan_plain`` mirrors
``gla_chunked`` operation for operation.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (I, L, P, CudaKernel, raw_stream,
                                      refuse_grad)

NEG = -1e30

KERNEL = CudaKernel("ssd_scan.cu", "repro_ssd_chunk_scan",
                    [I] + [P, L, L, L] * 5 + [P] * 9 + [I] * 7 + [P])

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CUMSUM_BLOCK = 16


def _running_sum(x):
    """Inclusive cumsum over the last dim, one float32 add at a time in
    order (``torch.cumsum`` on the CPU accumulates in double)."""
    out = x.clone()
    for i in range(1, x.shape[-1]):
        out[..., i] += out[..., i - 1]
    return out


def cumsum_blocked(x, dim: int):
    """Inclusive cumsum in the order the JAX package's ``jnp.cumsum`` takes
    on the CPU (XLA rewrites the scan into sequential 16-long blocks plus a
    cumsum, in the same order, of the block totals), so the log-decay sums
    and the stabiliser ``m`` built from them match the JAX package to the
    last bit, not only mathematically.  The CUDA kernel sums in this order
    too."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= CUMSUM_BLOCK:
        return _running_sum(x).movedim(-1, dim)
    pad = (-n) % CUMSUM_BLOCK
    inner = _running_sum(torch.nn.functional.pad(x, (0, pad)).reshape(
        *x.shape[:-1], -1, CUMSUM_BLOCK))
    done = cumsum_blocked(inner[..., -1], -1)          # totals, same order
    inner[..., 1:, :] += done[..., :-1, None]
    return inner.reshape(*x.shape[:-1], -1)[..., :n].movedim(-1, dim)


def ssd_chunk_scan_plain(q, k, v, log_a, log_i, *, chunk: int, state=None):
    """The chunked scan in plain PyTorch (see the module docstring)."""
    B, S, H, N = q.shape
    Pv = v.shape[-1]
    Q = min(chunk, S)
    q, k, v = q.float(), k.float(), v.float()
    log_a, log_i = log_a.float(), log_i.float()
    # front-pad to a chunk multiple: pad steps contribute nothing (k = v = 0,
    # log_i = -1e30 kill their state and normaliser terms); their finite
    # outputs are sliced off below
    pad = (-S) % Q
    if pad:
        def pf(x, fill=0.0):
            return torch.cat([x.new_full((B, pad) + x.shape[2:], fill), x], 1)
        q, k, v = pf(q), pf(k), pf(v)
        log_a, log_i = pf(log_a), pf(log_i, NEG)
    nc = (S + pad) // Q

    def to_chunks(x):                                  # (nc, B, Q, ...)
        return x.reshape((B, nc, Q) + x.shape[2:]).transpose(0, 1)

    qc, kc, vc = to_chunks(q), to_chunks(k), to_chunks(v)
    lac, lic = to_chunks(log_a), to_chunks(log_i)
    if state is None:
        St = q.new_zeros((B, H, N, Pv))
        nt = q.new_zeros((B, H, N))
        M = q.new_full((B, H), NEG)
    else:
        St, nt, M = (x.float() for x in state)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    ys, dens, ms = [], [], []
    for c in range(nc):
        q_c, k_c, v_c, la_c, li_c = qc[c], kc[c], vc[c], lac[c], lic[c]
        La = cumsum_blocked(la_c, 1)                    # (B, Q, H) inclusive
        w = torch.cummax(li_c - La, 1).values
        m = La + torch.maximum(M[:, None, :], w)        # per-row log max
        # ---- intra-chunk
        c_log = (La[:, :, None, :] - La[:, None, :, :]
                 + li_c[:, None, :, :] - m[:, :, None, :])    # (B, j, s, H)
        cmat = torch.where(tri[None, :, :, None], torch.exp(c_log), 0.0)
        scores = torch.einsum("bjhn,bshn->bjsh", q_c, k_c)
        y = torch.einsum("bjsh,bshp->bjhp", scores * cmat, v_c)
        den = (scores * cmat).sum(2)
        # ---- inter-chunk (carried-in state)
        coef = torch.exp(La + M[:, None, :] - m)
        y = y + torch.einsum("bjhn,bhnp->bjhp", q_c, St) * coef[..., None]
        den = den + torch.einsum("bjhn,bhn->bjh", q_c, nt) * coef
        # ---- carry update
        la_sum = La[:, -1, :]
        m_new = la_sum + torch.maximum(M, w[:, -1, :])
        z = torch.exp(la_sum[:, None, :] - La + li_c - m_new[:, None, :])
        s_scale = torch.exp(torch.clamp(la_sum + M - m_new, max=0.0))
        St = s_scale[..., None, None] * St + torch.einsum(
            "bshn,bshp,bsh->bhnp", k_c, v_c, z)
        nt = s_scale[..., None] * nt + torch.einsum("bshn,bsh->bhn", k_c, z)
        M = m_new
        ys.append(y)
        dens.append(den)
        ms.append(m)

    def from_chunks(xs):
        x = torch.stack(xs, 1)
        return x.reshape((B, nc * Q) + x.shape[3:])[:, pad:]

    return from_chunks(ys), from_chunks(dens), from_chunks(ms), (St, nt, M)


def ssd_chunk_scan_cuda(q, k, v, log_a, log_i, *, chunk: int, state=None):
    """Launch the Hopper kernel (same contract as the plain version).
    Raises on anything the kernel does not take (and under grad: the scan
    has no backward yet, so the recurrent families do not train on the
    card); never falls back."""
    refuse_grad("ssd_chunk_scan_cuda", q, k, v, log_a, log_i,
                *(state if state is not None else ()))
    B, S, H, N = q.shape
    Pv = v.shape[-1]
    ins = (q, k, v, log_a, log_i) + (tuple(state) if state is not None
                                     else ())
    if not all(t.is_cuda and t.device == q.device for t in ins):
        raise ValueError("ssd_chunk_scan_cuda needs every tensor on one CUDA "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if log_a.dtype != torch.float32 or log_i.dtype != torch.float32:
        raise TypeError("log_a and log_i must be float32")
    if k.shape != q.shape or v.shape != (B, S, H, Pv) \
            or log_a.shape != (B, S, H) or log_i.shape != (B, S, H):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, gates "
                         f"{tuple(log_a.shape)}/{tuple(log_i.shape)}")
    if S < 1 or chunk < 1:
        raise ValueError(f"need S >= 1 and chunk >= 1, got {S}, {chunk}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("ssd_chunk_scan_cuda needs q, k, v with a "
                         "contiguous last dim")
    if state is not None:
        S0, n0, m0 = state
        if S0.shape != (B, H, N, Pv) or n0.shape != (B, H, N) \
                or m0.shape != (B, H):
            raise ValueError(f"state shapes {tuple(S0.shape)}, "
                             f"{tuple(n0.shape)}, {tuple(m0.shape)} do not "
                             f"match (B, H, N, P) = {(B, H, N, Pv)}")
        if not all(t.dtype == torch.float32 and t.is_contiguous()
                   for t in state):
            raise ValueError("the carried state must be contiguous float32")
    Q = min(chunk, S)
    pad = (-S) % Q
    f32 = dict(dtype=torch.float32, device=q.device)
    y = torch.empty((B, S, H, Pv), **f32)
    den = torch.empty((B, S, H), **f32)
    m = torch.empty((B, S, H), **f32)
    S_out = torch.empty((B, H, N, Pv), **f32)
    n_out = torch.empty((B, H, N), **f32)
    m_out = torch.empty((B, H), **f32)

    def strided(t):
        return (t.data_ptr(), *t.stride()[:3])

    st = (None, None, None) if state is None else \
        tuple(t.data_ptr() for t in state)
    KERNEL.launch(_DTYPES[q.dtype], *strided(q), *strided(k), *strided(v),
                  *strided(log_a), *strided(log_i), *st, y.data_ptr(),
                  den.data_ptr(), m.data_ptr(), S_out.data_ptr(),
                  n_out.data_ptr(), m_out.data_ptr(), B, S, H, N, Pv, Q,
                  pad, raw_stream(q))
    return y, den, m, (S_out, n_out, m_out)
