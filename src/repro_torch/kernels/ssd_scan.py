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

The scan trains on the card: ``SSDChunkScan`` runs the forward kernel with
each chunk's carried-in state saved, and the port's own backward kernel
``csrc/ssd_scan_bwd.cu`` (no TPU kernel stands behind it: the JAX package
differentiates the jnp ``gla_chunked``).  ``ssd_chunk_scan_bwd_plain`` is
that kernel's model, a plain walk of the chunks in reverse; on the card the
kernel is held against autograd of ``ssd_chunk_scan_plain``.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels.build import (I, L, P, CudaKernel, raw_stream,
                                      refuse_grad)

NEG = -1e30

KERNEL = CudaKernel("ssd_scan.cu", "repro_ssd_chunk_scan",
                    [I] + [P, L, L, L] * 5 + [P] * 12 + [I] * 7 + [P])
BWD_KERNEL = CudaKernel("ssd_scan_bwd.cu", "repro_ssd_chunk_scan_bwd",
                        [I] + [P, L, L, L] * 5 + [P] * 5 + [I] + [P] * 11
                        + [I] * 7 + [P])
# the backward's shared-memory layouts as the launches use them: (route
# code, rows, N, Q) -> bytes; the card tests hold ``ssd_bwd_plan``'s host
# copy of them against it
BWD_SMEM = CudaKernel("ssd_scan_bwd.cu", "repro_ssd_chunk_scan_bwd_smem",
                      [I] * 4)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CUMSUM_BLOCK = 16

# The backward's routes (``ssd_bwd_plan``) and their launches since the last
# ``ops.reset_launch_counts``.
BWD_ROUTES = ("mma", "cuda_cores")
BWD_ROUTE_LAUNCHES = {route: 0 for route in BWD_ROUTES}
SMEM_LIMIT = 232448             # an H100 block's opt-in shared memory
_P_TILE = 64                    # value columns per block
_WARPS = 8
# the tensor-core route's two tilings, in the order the plan tries them:
# (rows, stages, largest N)
MMA_TILINGS = ((64, 2, 128), (32, 1, 384))


@dataclasses.dataclass(frozen=True)
class SSDBwdPlan:
    """The backward's route from shapes alone: ``mma`` (bf16 on the tensor
    cores, ``rows`` a row / key tile, ``stages`` buffers of the operand a
    tile loop streams: one of ``MMA_TILINGS``) or ``cuda_cores`` (float32
    FMAs; ``rows`` 32 or 16, ``stages`` 1); ``smem`` the dynamic shared
    memory of its main kernel, mirroring the layouts of
    ``csrc/ssd_scan_bwd.cu`` (``BWD_SMEM``)."""
    route: str
    rows: int
    stages: int
    smem: int

    def kind(self, dtype) -> int:
        """The C launcher's route code (``repro_ssd_chunk_scan_bwd``)."""
        if self.route == "cuda_cores":
            return _DTYPES[dtype]
        return 2 if self.rows == 64 else 3


def _mma_smem(N: int, Q: int, rows: int, stages: int) -> int:
    """``MmaLayout(N, Q, rows, stages, warps).bytes``, with the warps
    ``kMmaWarps<rows>``: 16 at 64 rows, 8 at 32."""
    warps = 16 if rows == 64 else 8
    wps = warps // (rows // 16)
    Np = -(-N // (16 * wps)) * 16 * wps
    nq = -(-Q // rows)
    return (Np * (_P_TILE + 4) * 4 + Np * 4
            + 2 * nq * rows * (_P_TILE + 8) * 2
            + (stages + 1) * rows * (Np + 8) * 2
            + stages * rows * (_P_TILE + 8) * 2
            + 4 * rows * (rows + 8) * 2
            + (7 * Q + Q // 8 + 32 + warps + rows * wps) * 4)


def _cuda_cores_smem(N: int, Q: int, rows: int) -> int:
    """``Layout(N, Q, rows).bytes`` of the CUDA-core kernel."""
    ldn, ldp = N | 1, _P_TILE + 1
    return (N * ldp * 4 + N * 4 + 3 * rows * ldn * 4 + 3 * rows * ldp * 4
            + 2 * rows * (rows + 1) * 4
            + (7 * Q + Q // 8 + 32 + _WARPS) * 4)


@functools.lru_cache(maxsize=256)
def ssd_bwd_plan(dtype, N: int, P: int, Q: int) -> SSDBwdPlan:
    """The backward's plan for state width N, value width P (the kernel
    takes it in 64-column tiles, each the same work) and chunk length Q:
    bf16 on the tensor cores, 64-row tiles with two stages where N <= 128,
    else 32-row tiles with one (N <= 384), the first that fits in shared
    memory; float32, and bf16 that fits neither, on the CUDA cores."""
    if dtype == torch.bfloat16:
        for rows, stages, max_n in MMA_TILINGS:
            smem = _mma_smem(N, Q, rows, stages)
            if N <= max_n and smem <= SMEM_LIMIT:
                return SSDBwdPlan("mma", rows, stages, smem)
    rows = 32 if _cuda_cores_smem(N, Q, 32) <= SMEM_LIMIT else 16
    return SSDBwdPlan("cuda_cores", rows, 1, _cuda_cores_smem(N, Q, rows))


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
    too.  On the meta device (the dry run), where nothing is summed, one
    ``torch.cumsum``: the order moves no flop and no byte the counters
    read, and the 16-long loop would dispatch an operator per add."""
    if x.device.type == "meta":
        return torch.cumsum(x, dim)
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


def ssd_chunk_scan_plain(q, k, v, log_a, log_i, *, chunk: int, state=None,
                         chunk_states: bool = False):
    """The chunked scan in plain PyTorch (see the module docstring).
    ``chunk_states``: also return each chunk's carried-in state ``(S
    (B, nc, H, N, P), n (B, nc, H, N), M (B, nc, H))``, what the backward
    (``ssd_chunk_scan_bwd_plain``) reads."""
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
    if q.device.type == "meta" and nc > 1 and not chunk_states:
        # the dry run computes nothing: every chunk as a batch row of a
        # one-chunk scan (each from a state of the carried-in state's
        # shape) has each chunk's forward products and bytes, and no
        # per-chunk loop to dispatch.  Its backward does not carry a
        # gradient from chunk to chunk, so it counts fewer products than
        # the loop's: a mamba2-370m train_4k step 1.4% fewer flops
        def fold(x):
            return x.reshape((B * nc, Q) + x.shape[2:])

        st = None if state is None else \
            tuple(x.float().repeat_interleave(nc, 0) for x in state)
        y, den, m, fin = ssd_chunk_scan_plain(
            fold(q), fold(k), fold(v), fold(log_a), fold(log_i), chunk=Q,
            state=st)

        def unfold(x):
            return x.reshape((B, nc * Q) + x.shape[2:])[:, pad:]
        return (unfold(y), unfold(den), unfold(m),
                tuple(x.reshape((B, nc) + x.shape[1:])[:, -1] for x in fin))

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
    ys, dens, ms, carried = [], [], [], []
    for c in range(nc):
        q_c, k_c, v_c, la_c, li_c = qc[c], kc[c], vc[c], lac[c], lic[c]
        carried.append((St, nt, M))
        La = cumsum_blocked(la_c, 1)                    # (B, Q, H) inclusive
        w = torch.cummax(li_c - La, 1).values
        m = La + torch.maximum(M[:, None, :], w)        # per-row log max
        # ---- intra-chunk
        c_log = (La[:, :, None, :] - La[:, None, :, :]
                 + li_c[:, None, :, :] - m[:, :, None, :])    # (B, j, s, H)
        # masked before the exp, not after: a masked (s > j) entry may be
        # +inf there (a pad row's m is -1e30), and autograd's 0 * inf
        # would turn every gradient NaN; the values are the same
        cmat = torch.exp(torch.where(tri[None, :, :, None], c_log, NEG))
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

    out = (from_chunks(ys), from_chunks(dens), from_chunks(ms), (St, nt, M))
    if chunk_states:
        out += (tuple(torch.stack(x, 1) for x in zip(*carried)),)
    return out


def ssd_chunk_scan_bwd_plain(q, k, v, log_a, log_i, m, chunk_states,
                             final_m, dy, dden, *, chunk: int):
    """Gradients ``(dq, dk, dv, dlog_a, dlog_i)`` (float32, shaped as the
    inputs; q and k per head, so a head-broadcast view's gradient is their
    sum over heads) of the scan whose forward gave the row log-max ``m``,
    ``chunk_states`` (``ssd_chunk_scan_plain(..., chunk_states=True)``) and
    the final log-max ``final_m``, for the gradients ``dy`` of ``y_num`` and
    ``dden`` of ``den`` (None: zero).  The stabilisers are held constant
    (``SSDChunkScan`` says why that is exact).  A plain walk of the chunks
    in reverse carrying dS (N, P) and dn (N): the model of the backward
    kernel ``csrc/ssd_scan_bwd.cu``, whose header gives the formulas."""
    B, S, H, N = q.shape
    Pv = v.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    q, k, v, dy = q.float(), k.float(), v.float(), dy.float()
    log_a, log_i, m = log_a.float(), log_i.float(), m.float()
    dden = torch.zeros_like(log_a) if dden is None else dden.float()

    def pf(x, fill=0.0):
        return torch.cat([x.new_full((B, pad) + x.shape[2:], fill), x], 1)

    if pad:
        q, k, v, dy, log_a, m, dden = (pf(x) for x in
                                       (q, k, v, dy, log_a, m, dden))
        log_i = pf(log_i, NEG)
    nc = (S + pad) // Q
    real = torch.arange(S + pad, device=q.device) >= pad

    def to_chunks(x):                                  # (nc, B, Q, ...)
        return x.reshape((B, nc, Q) + x.shape[2:]).transpose(0, 1)

    qc, kc, vc, dyc = (to_chunks(x) for x in (q, k, v, dy))
    lac, lic, mc, ddc = (to_chunks(x) for x in (log_a, log_i, m, dden))
    Sc, ncs, Mc = (x.float() for x in chunk_states)
    dS = q.new_zeros((B, H, N, Pv))          # the final state: no gradient
    dn = q.new_zeros((B, H, N))
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    grads = [None] * nc
    for c in reversed(range(nc)):
        q_c, k_c, v_c, dy_c = qc[c], kc[c], vc[c], dyc[c]
        li_c, m_c, dd_c = lic[c], mc[c], ddc[c]
        row = real[c * Q:(c + 1) * Q][None, :, None]          # (1, Q, 1)
        La = cumsum_blocked(lac[c], 1)
        M = Mc[:, c]
        m_new = Mc[:, c + 1] if c + 1 < nc else final_m.float()
        la_sum = La[:, -1]
        cmat = torch.where(tri[None, :, :, None] & row[..., None],
                           torch.exp(La[:, :, None] - La[:, None]
                                     + li_c[:, None] - m_c[:, :, None]), 0.0)
        coef = torch.where(row, torch.exp(La + M[:, None] - m_c), 0.0)
        z = torch.where(row, torch.exp(la_sum[:, None] - La + li_c
                                       - m_new[:, None]), 0.0)
        scale = torch.exp(torch.clamp(la_sum + M - m_new, max=0.0))
        W = torch.einsum("bjhn,bshn->bjsh", q_c, k_c) * cmat
        D = (torch.einsum("bjhp,bshp->bjsh", dy_c, v_c)
             + dd_c[:, :, None, :]) * cmat
        dv = torch.einsum("bjsh,bjhp->bshp", W, dy_c) + z[..., None] * \
            torch.einsum("bshn,bhnp->bshp", k_c, dS)
        dk = torch.einsum("bjsh,bjhn->bshn", D, q_c) + z[..., None] * (
            torch.einsum("bshp,bhnp->bshn", v_c, dS) + dn[:, None])
        dq = torch.einsum("bjsh,bshn->bjhn", D, k_c) + coef[..., None] * (
            torch.einsum("bjhp,bhnp->bjhn", dy_c, Sc[:, c])
            + dd_c[..., None] * ncs[:, c][:, None])
        dli = (k_c * dk).sum(-1)
        dLa = (q_c * dq).sum(-1) - dli
        if c + 1 < nc:           # the carry out scales with exp(la_sum)
            dLa[:, -1] += (dS * Sc[:, c + 1]).sum((-2, -1)) \
                + (dn * ncs[:, c + 1]).sum(-1)
        grads[c] = (dq, dk, dv, dLa.flip(1).cumsum(1).flip(1), dli)
        dS = scale[..., None, None] * dS + torch.einsum(
            "bjhn,bjhp->bhnp", q_c, coef[..., None] * dy_c)
        dn = scale[..., None] * dn + torch.einsum("bjhn,bjh->bhn", q_c,
                                                  coef * dd_c)
    return tuple(torch.cat(g, 1)[:, pad:] for g in zip(*grads))


def ssd_chunk_scan_cuda(q, k, v, log_a, log_i, *, chunk: int, state=None):
    """Launch the Hopper kernel (same contract as the plain version), the
    forward alone.  Raises on anything the kernel does not take, and under
    grad (a ctypes launch would detach the gradient: ``ssd_chunk_scan_kernel``
    is the differentiable entry); never falls back."""
    refuse_grad("ssd_chunk_scan_cuda", q, k, v, log_a, log_i,
                *(state if state is not None else ()))
    return _forward(q, k, v, log_a, log_i, chunk, state, save=False)[:4]


def _strided(t):
    return (t.data_ptr(), *t.stride()[:3])


def _forward(q, k, v, log_a, log_i, chunk, state, save):
    """The forward launch: ``(y, den, m, (S, n, M), saved)``, ``saved``
    each chunk's carried-in state ``(S (B, H, nc, P, N), n (B, H, nc, N), M
    (B, H, nc))`` when ``save``, else None."""
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
    nc = (S + pad) // Q
    saved = (torch.empty((B, H, nc, Pv, N), **f32),
             torch.empty((B, H, nc, N), **f32),
             torch.empty((B, H, nc), **f32)) if save else None
    st = (None, None, None) if state is None else \
        tuple(t.data_ptr() for t in state)
    sv = (None, None, None) if saved is None else \
        tuple(t.data_ptr() for t in saved)
    KERNEL.launch(_DTYPES[q.dtype], *_strided(q), *_strided(k),
                  *_strided(v), *_strided(log_a), *_strided(log_i), *st,
                  y.data_ptr(), den.data_ptr(), m.data_ptr(),
                  S_out.data_ptr(), n_out.data_ptr(), m_out.data_ptr(), *sv,
                  B, S, H, N, Pv, Q, pad, raw_stream(q))
    return y, den, m, (S_out, n_out, m_out), saved


def ssd_chunk_scan_bwd_cuda(q, k, v, log_a, log_i, m, saved, final_m, dy,
                            dden, *, chunk: int, fresh: bool):
    """Launch the Hopper backward: ``(dq, dk, dv, dlog_a, dlog_i)`` of the
    scan whose forward (``_forward(..., save=True)``) gave ``m``, ``saved``
    and the final log-max ``final_m``, for the gradients ``dy`` of y_num and
    ``dden`` of den (None: zero).  ``fresh``: the forward started from a
    zero state.  dq, dk, dv come dense in the input type (a head-broadcast
    q or k gets its per-head gradient), the gate gradients float32.  The
    route is ``ssd_bwd_plan``'s: a bf16 call that cannot take it raises.
    Raises on anything the kernel does not take; never falls back."""
    B, S, H, N = q.shape
    Pv = v.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    nc = (S + pad) // Q
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    dy = dy.float().contiguous()
    if dy.shape != (B, S, H, Pv):
        raise ValueError(f"dy {tuple(dy.shape)} does not match y "
                         f"{(B, S, H, Pv)}")
    if dden is not None:
        dden = dden.float().contiguous()
        if dden.shape != (B, S, H):
            raise ValueError(f"dden {tuple(dden.shape)} does not match den "
                             f"{(B, S, H)}")
    want = ((B, H, nc, Pv, N), (B, H, nc, N), (B, H, nc))
    if tuple(tuple(t.shape) for t in saved) != want or \
            m.shape != (B, S, H) or final_m.shape != (B, H) or not all(
                t.is_contiguous() and t.dtype == torch.float32
                and t.device == dev for t in (m, final_m) + tuple(saved)):
        raise ValueError("the saved forward state does not match the scan")
    plan = ssd_bwd_plan(q.dtype, N, Pv, Q)
    if plan.smem > SMEM_LIMIT:
        raise ValueError(f"ssd_chunk_scan_bwd: no route fits N {N}, chunk "
                         f"{Q} in a block's shared memory ({plan})")
    ntiles = -(-Pv // _P_TILE)
    # partials: every CUDA-core launch, and the mma route's P tiles
    parts = (torch.empty((ntiles, B, S, H, N), **f32),
             torch.empty((ntiles, B, S, H, N), **f32),
             torch.empty((ntiles, B, S, H), **f32),
             torch.empty((ntiles, B, S, H), **f32)) \
        if plan.route == "cuda_cores" or ntiles > 1 else (None,) * 4
    dq = torch.empty((B, S, H, N), dtype=q.dtype, device=dev)
    dk = torch.empty((B, S, H, N), dtype=q.dtype, device=dev)
    dv = torch.empty((B, S, H, Pv), dtype=q.dtype, device=dev)
    dla = torch.empty((B, S, H), **f32)
    dli = torch.empty((B, S, H), **f32)
    BWD_KERNEL.launch(plan.kind(q.dtype), *_strided(q), *_strided(k),
                      *_strided(v), *_strided(log_a), *_strided(log_i),
                      m.data_ptr(), *(t.data_ptr() for t in saved),
                      final_m.data_ptr(), int(bool(fresh)), dy.data_ptr(),
                      None if dden is None else dden.data_ptr(),
                      dv.data_ptr(),
                      *(None if t is None else t.data_ptr() for t in parts),
                      dq.data_ptr(), dk.data_ptr(), dla.data_ptr(),
                      dli.data_ptr(), B, S, H, N, Pv, Q, pad, raw_stream(q))
    BWD_ROUTE_LAUNCHES[plan.route] += 1
    return dq, dk, dv, dla, dli


class SSDChunkScan(torch.autograd.Function):
    """The differentiable scan on the card: the forward kernel with each
    chunk's carried-in state saved, the backward kernel for the gradients
    of q, k, v, log_a and log_i.  The row log-max ``m`` and the final state
    are not differentiable.

    Holding the stabilisers (m, the carried M and the next chunk's m_new)
    constant gives the exact gradient for both callers, because each uses
    the outputs only in a form that does not change with them: mamba2
    (``models/ssm.py::mamba2_forward``) takes ``y_num * exp(m)``, the
    unstabilised Y; mLSTM (``models/xlstm.py::_mlstm_out``) takes ``y_num /
    max(|den|, exp(-m))``, which equals Y / max(|D|, 1) for the
    unstabilised Y and D.  Inside the scan each stabilised quantity is its
    unstabilised one times exp(-constant), and the carry's clamp
    ``min(la_sum + M - m_new, 0)`` never binds (m_new >= la_sum + M).  The
    JAX package's autodiff takes the m path through max / cummax, where it
    cancels to rounding.  A carried-in state that requires grad is
    refused (``ssd_chunk_scan_kernel``): no training path passes one."""

    @staticmethod
    def forward(ctx, q, k, v, log_a, log_i, chunk, state):
        y, den, m, fin, saved = _forward(q, k, v, log_a, log_i, chunk,
                                         state, save=True)
        ctx.save_for_backward(q, k, v, log_a, log_i, m, *saved, fin[2])
        ctx.chunk, ctx.fresh = chunk, state is None
        ctx.mark_non_differentiable(m, *fin)
        return (y, den, m) + fin

    @staticmethod
    def backward(ctx, dy, dden, *_):
        q, k, v, log_a, log_i, m, S_c, n_c, M_c, final_m = ctx.saved_tensors
        grads = ssd_chunk_scan_bwd_cuda(q, k, v, log_a, log_i, m,
                                        (S_c, n_c, M_c), final_m, dy, dden,
                                        chunk=ctx.chunk, fresh=ctx.fresh)
        return grads + (None, None)


def ssd_chunk_scan_kernel(q, k, v, log_a, log_i, *, chunk: int, state=None):
    """The model's CUDA entry: ``SSDChunkScan`` (forward and backward
    kernels) when grad mode is on and q, k, v or a gate requires grad, else
    the forward-only launch.  A carried state that requires grad raises."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, log_a, log_i)):
        if state is not None and any(t.requires_grad for t in state):
            raise RuntimeError("ssd_chunk_scan: a carried-in state that "
                               "requires grad has no backward")
        y, den, m, *fin = SSDChunkScan.apply(q, k, v, log_a, log_i,
                                             int(chunk), state)
        return y, den, m, tuple(fin)
    return ssd_chunk_scan_cuda(q, k, v, log_a, log_i, chunk=chunk,
                               state=state)
