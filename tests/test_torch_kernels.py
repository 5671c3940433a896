"""The port's plain kernel versions vs the JAX package's Pallas kernels.

Each of the five ported kernels' plain PyTorch version (what the port runs
on the CPU) is held against the JAX Pallas kernel in interpret mode
(``repro.kernels.ops`` on the CPU) and against its jnp oracle
(``repro.kernels.ref``), on the sweeps of ``tests/test_kernels.py``.  Inputs
come from numpy seeds and are handed to both frameworks; the dense caches
reach the port as strided views of a (B, S, Kv, hd) array, the layout the
serving path hands the kernels.

Tolerances: float32 atol = rtol = 1e-5 (summation order differs between the
frameworks); bfloat16 2e-2 (one bf16 ulp at |x| ~ 2).  ``spec_verify`` is
exact at T = 0; at T > 0, with the JAX uniforms passed to the port, it is
exact except on rows where a uniform lies within 1e-6 of a cdf entry or an
accept ratio, which are counted and must stay a small minority.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_cuda, decode_attention_plain, dense_splits,
    paged_decode_attention_cuda, paged_decode_attention_plain, paged_splits,
    paged_walk)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.spec_verify import (  # noqa: E402
    spec_splits, spec_verify_cuda, spec_verify_plain)
from repro_torch.kernels.tree_attention import (  # noqa: E402
    KEYS, split_plan, tree_verify_attention_cuda, tree_verify_attention_plain)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(np.array(x)).to(getattr(torch, dtype)))


def _close(t_out, j_out, dtype):
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# ------------------------------------------------------------ flash attn
@pytest.mark.parametrize("B,H,S,hd", [(1, 1, 128, 64), (2, 3, 256, 64),
                                      (1, 2, 512, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_vs_pallas(B, H, S, hd, dtype):
    (jq, tq), (jk, tk), (jv, tv) = (_both(_np(i, (B, H, S, hd)), dtype)
                                    for i in range(3))
    out = flash_attention_plain(tq, tk, tv, causal=True)
    _close(out, jops.flash_attention(jq, jk, jv, causal=True, bq=64, bk=64),
           dtype)
    _close(out, jref.flash_attention_ref(jq, jk, jv, causal=True), dtype)
    assert out.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("window", [32, 128])
def test_flash_attention_plain_window(window):
    (jq, tq), (jk, tk), (jv, tv) = (_both(_np(i, (1, 2, 256, 64)), "float32")
                                    for i in range(3))
    out = flash_attention_plain(tq, tk, tv, causal=True, window=window)
    _close(out, jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                     bq=64, bk=64), "float32")


def test_flash_attention_plain_noncausal():
    (jq, tq), (jk, tk), (jv, tv) = (_both(_np(i, (1, 1, 128, 64)), "float32")
                                    for i in range(3))
    out = tops.flash_attention(tq, tk, tv, causal=False)   # CPU dispatch
    _close(out, jops.flash_attention(jq, jk, jv, causal=False, bq=64, bk=64),
           "float32")


@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 37),
                                           (False, 0)])
def test_flash_attention_plain_gqa(G, causal, window):
    """K/V with Kv = 2 heads for H = 2 G query heads (query head h reads kv
    head h // G), taken as strided views of (B, S, heads, hd) projections:
    the plain version matches itself on repeat_interleave'd K/V and the JAX
    kernel (interpret mode) on the expanded heads."""
    B, S, Kv, hd = 2, 96, 2, 64
    x = [_np(i, (B, S, n, hd)) for i, n in enumerate((Kv * G, Kv, Kv))]
    q, k, v = (torch.from_numpy(a).transpose(1, 2) for a in x)
    out = tops.flash_attention(q, k, v, causal=causal, window=window)
    kx, vx = (t.repeat_interleave(G, dim=1) for t in (k, v))
    torch.testing.assert_close(
        out, flash_attention_plain(q, kx, vx, causal=causal, window=window),
        atol=0, rtol=0)
    jq, jk, jv = (jnp.asarray(np.ascontiguousarray(t.numpy()))
                  for t in (q, kx, vx))
    _close(out, jops.flash_attention(jq, jk, jv, causal=causal,
                                     window=window, bq=32, bk=32), "float32")


# ------------------------------------------------------------ paged decode
def _paged_case(B, Kv, G, bs, MB, hd, dtype, lengths=None):
    NB = B * MB + 1
    q = _both(_np(0, (B, Kv, G, hd)), dtype)
    kp = _both(_np(1, (NB, bs, Kv, hd)), dtype)
    vp = _both(_np(2, (NB, bs, Kv, hd)), dtype)
    rng = np.random.default_rng(0)
    table = rng.permutation(np.arange(1, NB))[:B * MB].reshape(B, MB) \
        .astype(np.int32)
    if lengths is None:
        lengths = rng.integers(1, MB * bs + 1, B)
    length = np.asarray(lengths, np.int32)
    return (q, kp, vp, (jnp.asarray(table), torch.from_numpy(table)),
            (jnp.asarray(length), torch.from_numpy(length)))


@pytest.mark.parametrize("B,Kv,G,bs,MB,hd", [(1, 1, 1, 16, 4, 64),
                                             (3, 2, 4, 16, 8, 64),
                                             (2, 4, 2, 32, 4, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_plain_vs_pallas(B, Kv, G, bs, MB, hd, dtype):
    q, kp, vp, table, length = _paged_case(B, Kv, G, bs, MB, hd, dtype)
    out = paged_decode_attention_plain(q[1], kp[1], vp[1], table[1],
                                       length[1])
    _close(out, jops.paged_decode_attention(q[0], kp[0], vp[0], table[0],
                                            length[0]), dtype)
    _close(out, jref.paged_decode_attention_ref(q[0], kp[0], vp[0], table[0],
                                                length[0]), dtype)


@pytest.mark.parametrize("window", [4, 8, 11, 16, 48])
def test_paged_decode_plain_windowed(window):
    """Unaligned windows, lengths below the window and windows past the
    whole table, as in the JAX sweep."""
    B, Kv, G, bs, MB, hd = 4, 2, 4, 8, 6, 64
    q, kp, vp, table, length = _paged_case(B, Kv, G, bs, MB, hd, "float32",
                                           lengths=[3, 17, 30, MB * bs])
    out = tops.paged_decode_attention(q[1], kp[1], vp[1], table[1],
                                      length[1], window=window)
    _close(out, jops.paged_decode_attention(q[0], kp[0], vp[0], table[0],
                                            length[0], window=window),
           "float32")
    _close(out, jref.paged_decode_attention_ref(q[0], kp[0], vp[0], table[0],
                                                length[0], window=window),
           "float32")


def test_paged_split_plan():
    """The paged kernel's key split, from shapes only: one split at the
    serving shape (8 slots of smollm-135m heads over 3-entry tables), with
    a window, and wherever the grid already covers two blocks per SM; over
    a 128-entry table 11 splits of 12 entries (264 blocks on 132 SMs); no
    split walks fewer than 8 entries, or more than 4096."""
    assert (paged_walk(3, 32, 0), paged_walk(128, 32, 24),
            paged_walk(128, 32, 48), paged_walk(2, 32, 48)) == (3, 2, 3, 2)
    assert paged_splits(8, 3, 3, 3, 132) == (1, 3)
    assert paged_splits(8, 3, 3, 128, 132) == (11, 12)
    assert paged_splits(8, 3, 3, paged_walk(128, 32, 48), 132) == (1, 3)
    assert paged_splits(64, 8, 4, 128, 132) == (1, 128)
    assert paged_splits(1, 1, 1, 20, 132) == (2, 10)
    assert paged_splits(1000, 8, 4, 10000, 132) == (3, 3334)
    for B, Kv, G, ns in ((1, 1, 9, 1000), (2, 3, 4, 64), (5, 2, 1, 17)):
        nsplit, eps = paged_splits(B, Kv, G, ns, 132)
        assert (nsplit - 1) * eps < ns <= nsplit * eps
        assert nsplit == 1 or eps >= 8


def _paged_split_model(q, kp, vp, table, length, window, nsplit, eps):
    """A plain model of the paged kernel's split: the walked table entries
    (logical blocks sb, sb + 1, ... of each sequence, the index clamped to
    MB - 1) are cut into runs of ``eps``; each run makes an unnormalised
    partial (output, max, sum) over its visible positions — an empty run
    has max -1e30 and sum 0 — and the partials merge rescaled to the
    largest max."""
    B, Kv, G, hd = q.shape
    bs, MB = kp.shape[1], table.shape[1]
    ns = paged_walk(MB, bs, window)
    out = torch.zeros((B, Kv, G, hd))
    for b in range(B):
        n = int(length[b])
        sb = max(n - window, 0) // bs if window else 0
        lo = n - window if window else 0
        parts = []
        for sp in range(nsplit):
            e0, e1 = sp * eps, min(sp * eps + eps, ns)
            pos = [p for p in range((sb + e0) * bs, (sb + e1) * bs)
                   if lo <= p < n]
            if not pos:
                parts.append((torch.zeros((Kv, G, hd)),
                              torch.full((Kv, G, 1), -1e30),
                              torch.zeros((Kv, G, 1))))
                continue
            blk = table[b, [min(p // bs, MB - 1) for p in pos]].long()
            off = torch.as_tensor([p % bs for p in pos])
            kk, vv = kp[blk, off].float(), vp[blk, off].float()  # (n, Kv, hd)
            s = torch.einsum("kgd,nkd->kgn", q[b].float(), kk) / hd ** 0.5
            m = s.amax(-1, keepdim=True)
            e = torch.exp(s - m)
            parts.append((torch.einsum("kgn,nkd->kgd", e, vv), m,
                          e.sum(-1, keepdim=True)))
        M = torch.stack([m for _, m, _ in parts]).amax(0)
        den = sum(l * torch.exp(m - M) for _, m, l in parts)
        out[b] = sum(o * torch.exp(m - M) for o, m, _ in parts) \
            / den.clamp(min=1e-20)
    return out


@pytest.mark.parametrize("nsplit,eps", [(1, 12), (3, 4), (12, 1)])
@pytest.mark.parametrize("window", [0, 11])
def test_paged_split_combine_model(nsplit, eps, window):
    """Cutting the walked table into runs and merging the partial softmaxes
    gives the unsplit answer, empty runs (length 1, windows) included: the
    plain version and the JAX kernel (interpret mode), over 12-entry
    tables of 8-position blocks."""
    B, Kv, G, bs, MB, hd = 4, 2, 3, 8, 12, 32
    if window:
        nsplit, eps = -(-paged_walk(MB, bs, window) // eps), eps
    q, kp, vp, table, length = _paged_case(B, Kv, G, bs, MB, hd, "float32",
                                           lengths=[1, 8, 33, MB * bs])
    out = _paged_split_model(q[1], kp[1], vp[1], table[1], length[1],
                             window, nsplit, eps)
    _close(out, paged_decode_attention_plain(q[1], kp[1], vp[1], table[1],
                                             length[1], window=window)
           .numpy(), "float32")
    _close(out, jops.paged_decode_attention(q[0], kp[0], vp[0], table[0],
                                            length[0], window=window),
           "float32")


# ------------------------------------------------------------ dense decode
def _dense_kv(seed, B, Kv, S, hd, dtype):
    """One cache as a JAX (B, Kv, S, hd) array and a torch view of the same
    values stored (B, S, Kv, hd)."""
    x = _np(seed, (B, S, Kv, hd))
    return (jnp.asarray(np.moveaxis(x, 2, 1)).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 2, 1, 3))


@pytest.mark.parametrize("B,Kv,G,S,hd", [(1, 1, 1, 256, 64),
                                         (2, 2, 4, 512, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_vs_pallas(B, Kv, G, S, hd, dtype):
    jq, tq = _both(_np(0, (B, Kv, G, hd)), dtype)
    jk, tk = _dense_kv(1, B, Kv, S, hd, dtype)
    jv, tv = _dense_kv(2, B, Kv, S, hd, dtype)
    length = np.random.default_rng(0).integers(1, S + 1, B).astype(np.int32)
    out = decode_attention_plain(tq, tk, tv, _t(length))
    jl = jnp.asarray(length)
    _close(out, jops.decode_attention(jq, jk, jv, jl, bs=128), dtype)
    _close(out, jref.decode_attention_ref(jq, jk, jv, jl), dtype)
    assert out.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("window", [64, 300])
def test_decode_attention_plain_window(window):
    """Windows shorter and longer than a sequence, through the CPU
    dispatch."""
    jq, tq = _both(_np(0, (2, 2, 2, 64)), "float32")
    jk, tk = _dense_kv(1, 2, 2, 512, 64, "float32")
    jv, tv = _dense_kv(2, 2, 2, 512, 64, "float32")
    length = np.array([100, 512], np.int32)
    out = tops.decode_attention(tq, tk, tv, _t(length), window=window)
    _close(out, jops.decode_attention(jq, jk, jv, jnp.asarray(length),
                                      window=window, bs=128), "float32")


def test_dense_split_plan():
    """The dense kernel's key split, from shapes only: one split at both
    serving shapes (8 slots over an 80-position cache, smollm-135m heads
    and zamba2's Kv 32, G 1) and with a short window; over a 4096-position
    cache 11 splits of 373 positions for the smollm heads (264 blocks on
    132 SMs) and 2 for zamba2's 256 blocks; none walks fewer than 256
    positions."""
    assert dense_splits(8, 3, 3, 80, 0, 132) == (1, 80)
    assert dense_splits(8, 32, 1, 80, 0, 132) == (1, 80)
    assert dense_splits(8, 3, 3, 4096, 0, 132) == (11, 373)
    assert dense_splits(8, 32, 1, 4096, 0, 132) == (2, 2048)
    assert dense_splits(8, 3, 3, 4096, 64, 132) == (1, 64)
    assert dense_splits(8, 3, 3, 4096, 600, 132) == (2, 300)
    assert dense_splits(64, 8, 4, 4096, 0, 132) == (1, 4096)
    for B, Kv, G, S, w in ((1, 1, 9, 1000, 0), (2, 3, 4, 5000, 300),
                           (5, 2, 1, 17, 0), (1, 1, 1, 0, 0)):
        nsplit, eps = dense_splits(B, Kv, G, S, w, 132)
        ns = max(min(S, w) if w else S, 1)
        assert (nsplit - 1) * eps < ns <= nsplit * eps
        assert nsplit == 1 or eps >= 256


def _dense_split_model(q, k, v, length, window, nsplit, eps):
    """A plain model of the dense kernel's split: each sequence's visible
    range [lo, hi) (lo = max(length - window, 0), or 0 without a window;
    hi = min(length, S)) is cut at lo + s * eps; each run makes an
    unnormalised partial (output, max, sum) — an empty run has max -1e30
    and sum 0 — and the partials merge rescaled to the largest max."""
    B, Kv, G, hd = q.shape
    S = k.shape[2]
    out = torch.zeros((B, Kv, G, hd))
    for b in range(B):
        n = int(length[b])
        lo, hi = (max(n - window, 0) if window else 0), min(n, S)
        parts = []
        for sp in range(nsplit):
            a, e = min(lo + sp * eps, hi), min(lo + (sp + 1) * eps, hi)
            if a >= e:
                parts.append((torch.zeros((Kv, G, hd)),
                              torch.full((Kv, G, 1), -1e30),
                              torch.zeros((Kv, G, 1))))
                continue
            kk, vv = k[b, :, a:e].float(), v[b, :, a:e].float()
            s = torch.einsum("kgd,knd->kgn", q[b].float(), kk) / hd ** 0.5
            m = s.amax(-1, keepdim=True)
            ex = torch.exp(s - m)
            parts.append((torch.einsum("kgn,knd->kgd", ex, vv), m,
                          ex.sum(-1, keepdim=True)))
        M = torch.stack([m for _, m, _ in parts]).amax(0)
        den = sum(l * torch.exp(m - M) for _, m, l in parts)
        out[b] = sum(o * torch.exp(m - M) for o, m, _ in parts) \
            / den.clamp(min=1e-20)
    return out


@pytest.mark.parametrize("nsplit,eps", [(1, 128), (3, 43), (9, 15),
                                        (128, 1)])
@pytest.mark.parametrize("window", [0, 11, 40])
def test_dense_split_combine_model(nsplit, eps, window):
    """Cutting the visible range into runs and merging the partial
    softmaxes gives the unsplit answer, empty runs (length 1, windows)
    included: the plain version and the JAX kernel (interpret mode), over
    a 128-position cache read through the serving layout's strides."""
    B, Kv, G, S, hd = 4, 2, 3, 128, 32
    if window:
        nsplit = -(-min(S, window) // eps)
    jq, tq = _both(_np(0, (B, Kv, G, hd)), "float32")
    jk, tk = _dense_kv(1, B, Kv, S, hd, "float32")
    jv, tv = _dense_kv(2, B, Kv, S, hd, "float32")
    length = np.array([1, 8, 47, S], np.int32)
    out = _dense_split_model(tq, tk, tv, _t(length), window, nsplit, eps)
    _close(out, decode_attention_plain(tq, tk, tv, _t(length),
                                       window=window).numpy(), "float32")
    _close(out, jops.decode_attention(jq, jk, jv, jnp.asarray(length),
                                      window=window, bs=64), "float32")


# ------------------------------------------------------------ tree verify
def _plan():
    from repro_torch.core.tree_speculation import TreePlan, branching_for
    return TreePlan(branching_for(2, 4))


def _tree_case(B, Kv, G, N, S, hd, dtype, length, q_pos, seed=0):
    jq, tq = _both(_np(seed, (B, Kv, G, N, hd)), dtype)
    jk, tk = _dense_kv(seed + 1, B, Kv, S, hd, dtype)
    jv, tv = _dense_kv(seed + 2, B, Kv, S, hd, dtype)
    length = np.asarray(length, np.int32)
    q_pos = np.asarray(q_pos, np.int32)
    return ((jq, jk, jv, jnp.asarray(length), jnp.asarray(q_pos)),
            (tq, tk, tv, _t(length), _t(q_pos)))


@pytest.mark.parametrize("B,Kv,G,S,hd", [(1, 1, 1, 256, 64),
                                         (2, 2, 4, 160, 64),
                                         (1, 4, 2, 160, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_verify_attention_plain_vs_pallas(B, Kv, G, S, hd, dtype):
    """A real packed ancestor mask (pad rows self-only), per-sequence
    lengths, and S = 160, which the Pallas wrapper pads to its block."""
    plan = _plan()
    N = plan.n_pad
    length = np.random.default_rng(0).integers(1, S - N + 1, B)
    q_pos = length[:, None] + plan.depths[None, :]
    (jq, jk, jv, jl, jp), (tq, tk, tv, tl, tp) = _tree_case(
        B, Kv, G, N, S, hd, dtype, length, q_pos)
    mask = plan.mask
    out = tree_verify_attention_plain(tq, tk, tv, tl, _t(mask), tp)
    jm = jnp.asarray(mask)
    _close(out, jops.tree_verify_attention(jq, jk, jv, jl, jm, jp, bs=128),
           dtype)
    _close(out, jref.tree_verify_attention_ref(jq, jk, jv, jl, jm, jp),
           dtype)
    assert out.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("window", [8, 64])
def test_tree_verify_attention_plain_window(window):
    """A node at depth d sees the window a linear decode at position
    length + d would (through the CPU dispatch)."""
    plan = _plan()
    N = plan.n_pad
    length = np.array([100, 220], np.int32)
    q_pos = length[:, None] + plan.depths[None, :]
    (jq, jk, jv, jl, jp), (tq, tk, tv, tl, tp) = _tree_case(
        2, 2, 2, N, 256, 64, "float32", length, q_pos)
    out = tops.tree_verify_attention(tq, tk, tv, tl, _t(plan.mask), tp,
                                     window=window)
    _close(out, jops.tree_verify_attention(jq, jk, jv, jl,
                                           jnp.asarray(plan.mask), jp,
                                           window=window, bs=128), "float32")


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_verify_attention_plain_rectangular(level, dtype):
    """Rectangular (T, C) masks, C > T — an incremental draft level: the
    queries are level ``level``'s nodes and the mask's first C - T columns
    cover tree rows earlier levels wrote at [length - (C - T), length)."""
    plan = _plan()
    lo, hi = plan.levels[level]
    T, C = hi - lo, hi
    base = np.array([32, 100], np.int32)
    q_pos = base[:, None] + plan.depths[None, lo:hi]
    (jq, jk, jv, jl, jp), (tq, tk, tv, tl, tp) = _tree_case(
        2, 2, 2, T, 256, 64, dtype, base + lo, q_pos, seed=3)
    mask = np.ascontiguousarray(plan.mask[lo:hi, :hi])
    out = tree_verify_attention_plain(tq, tk, tv, tl, _t(mask), tp)
    _close(out, jops.tree_verify_attention(jq, jk, jv, jl, jnp.asarray(mask),
                                           jp, bs=128), dtype)


def test_tree_split_plan():
    """Splits only when the grid fills under half the SMs and each split
    keeps at least four key tiles: none at the serving shapes (8 slots of
    granite-8b or smollm-135m heads, an 80-position cache), two for 8 x 8
    blocks over a 1024-position cache on 132 SMs."""
    assert split_plan(8 * 8, -(-80 // KEYS), 132) == 1
    assert split_plan(8 * 3, -(-80 // KEYS), 132) == 1
    assert split_plan(8 * 8, -(-1024 // KEYS), 132) == 2
    assert split_plan(1, 16, 132) == 4
    assert split_plan(1, 1000, 132) == 132
    assert split_plan(67, 1000, 132) == 1
    assert split_plan(3, 3, 132) == 1


NEG_T = -1e30


def _split_combine(q, k, v, length, mask, q_pos, window, splits):
    """A plain model of the tree kernel's key split: per sequence, the key
    range [window start rounded down to a tile, base + C) in KEYS-key
    tiles is cut into ``splits`` runs of whole tiles; each run makes an
    unnormalised softmax partial (output, row max, row sum) and the
    partials are combined, rescaled to the largest max."""
    B, Kv, G, N, hd = q.shape
    S, C = k.shape[2], mask.shape[1]
    s = torch.einsum("bkgnd,bksd->bkgns", q.float(), k.float()) \
        / hd ** 0.5
    out = torch.zeros(q.shape, dtype=torch.float32)
    key = torch.arange(S)
    for b in range(B):
        base = int(length[b]) - (C - N)
        k_end = min(S, base + C)
        tree = (key - base).clamp(0, C - 1)
        vis = (key < k_end) & ((key < base)[None, :] | mask[:, tree])
        k_begin = 0
        if window:
            vis &= key[None, :] > q_pos[b].long()[:, None] - window
            k_begin = max(int(q_pos[b].min()) - window + 1, 0)
        k_first = k_begin // KEYS * KEYS
        n_all = max(-(-(k_end - k_first) // KEYS), 0)
        parts = []
        for sp in range(splits):
            lo = k_first + n_all * sp // splits * KEYS
            hi = min(k_first + n_all * (sp + 1) // splits * KEYS, k_end)
            sc = torch.where(vis[:, lo:hi], s[b, :, :, :, lo:hi], NEG_T)
            m = sc.amax(-1, keepdim=True) if hi > lo else \
                torch.full(sc.shape[:-1] + (1,), NEG_T)
            p = torch.where(vis[:, lo:hi], torch.exp(sc - m), 0.0)
            parts.append((p @ v[b, :, None, lo:hi].float(), m,
                          p.sum(-1, keepdim=True)))
        M = torch.stack([m for _, m, _ in parts]).amax(0)
        L = sum(l * torch.exp(m - M) for _, m, l in parts)
        out[b] = sum(o * torch.exp(m - M) for o, m, _ in parts) \
            / L.clamp(min=1e-20)
    return out.to(q.dtype)



@pytest.mark.parametrize("splits", [1, 2, 3, 5])
@pytest.mark.parametrize("window", [0, 150])
def test_tree_split_combine_model(splits, window):
    """Cutting each sequence's key range into whole-tile splits and
    combining the partial softmaxes gives the unsplit answer: the plain
    version and the JAX kernel (interpret mode), on the one-shot verify
    of the 2-wide depth-4 plan over a 400-position cache."""
    plan = _plan()
    N = plan.n_pad
    length = np.array([310, 381], np.int32)
    q_pos = length[:, None] + plan.depths[None, :]
    (jq, jk, jv, jl, jp), (tq, tk, tv, tl, tp) = _tree_case(
        2, 2, 2, N, 400, 64, "float32", length, q_pos, seed=5)
    mask = _t(plan.mask)
    out = _split_combine(tq, tk, tv, tl, mask, tp, window, splits)
    _close(out, tree_verify_attention_plain(tq, tk, tv, tl, mask, tp,
                                            window=window).numpy(),
           "float32")
    _close(out, jops.tree_verify_attention(jq, jk, jv, jl,
                                           jnp.asarray(plan.mask), jp,
                                           window=window, bs=128), "float32")


# ------------------------------------------------------------ spec verify
def _jax_uniforms(rng, gamma):
    """The uniforms the JAX kernel draws from ``rng`` (ref.py:92-94)."""
    r_acc, r_res = jax.random.split(rng)
    return (np.asarray(jax.random.uniform(r_acc, (gamma + 1,))),
            np.asarray(jax.random.uniform(r_res, (gamma + 1,))))


def _near_tie(tl, dl, toks, u_acc, u_res, temperature, tol=1e-6):
    """True if some uniform of this group lies within ``tol`` of a cdf
    entry or of an accept ratio (float64 recomputation)."""
    from repro_torch.kernels.spec_verify import _probs
    gamma, V = dl.shape
    p = _probs(torch.from_numpy(tl).double(), temperature)
    ql = np.concatenate([dl, np.zeros((1, V), np.float32)])
    q = _probs(torch.from_numpy(ql).double(), temperature)
    tk = torch.from_numpy(np.concatenate([toks, [0]]).astype(np.int64))
    ratio = (p.gather(1, tk[:, None])[:, 0]
             / q.gather(1, tk[:, None])[:, 0].clamp(min=1e-20)).clamp(max=1)
    r = (p - torch.cat([q[:gamma], torch.zeros_like(q[:1])])).clamp(min=0)
    tot = r.sum(-1, keepdim=True)
    r = torch.where(tot > 0, r / tot.clamp(min=1e-20), p)
    cdf = r.cumsum(-1).numpy()
    return bool((np.abs(cdf - u_res[:, None]) < tol).any()
                or (np.abs(ratio.numpy() - u_acc) < tol).any())


def _spec_case(gamma, V, seed=0):
    tl = _np(seed, (gamma + 1, V), 2.0)
    dl = tl[:gamma] + _np(seed + 1, (gamma, V))
    toks = np.random.default_rng(seed + 2).integers(0, V, gamma) \
        .astype(np.int32)
    return tl, dl, toks


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(tl, dl, toks, u_acc, u_res, temperature):
    n, t = spec_verify_plain(_t(tl)[None], _t(dl)[None], _t(toks)[None],
                             _t(u_acc)[None], _t(u_res)[None],
                             temperature=temperature)
    return int(n[0]), int(t[0])


@pytest.mark.parametrize("gamma,V", [(1, 64), (4, 1000), (8, 4096)])
@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.0])
def test_spec_verify_plain_vs_pallas(gamma, V, temperature):
    """Several seeds per case; exact agreement with the Pallas kernel and
    the oracle everywhere at T=0, and at T>0 on every group without a
    near-tie (those are counted; at most one in four may differ)."""
    near = 0
    for seed in range(8):
        tl, dl, toks = _spec_case(gamma, V, 10 * seed)
        rng = jax.random.PRNGKey(seed)
        u_acc, u_res = _jax_uniforms(rng, gamma)
        got = _port(tl, dl, toks, u_acc, u_res, temperature)
        for fn in (jops.spec_verify, jref.spec_verify_ref):
            n, t = fn(rng, jnp.asarray(tl), jnp.asarray(dl),
                      jnp.asarray(toks), temperature=temperature)
            want = (int(n), int(t))
            if got != want:
                tie = _near_tie(tl, dl, toks, u_acc, u_res, temperature)
                assert temperature > 0 and tie, (seed, got, want)
                near += 1
    assert near <= 4, f"{near} near-tie disagreements of 16 comparisons"


def test_spec_verify_plain_all_accept():
    tl = _np(0, (5, 128))
    toks = tl[:4].argmax(-1).astype(np.int32)
    u = np.full((5,), 0.5, np.float32)
    assert _port(tl, tl[:4], toks, u, u, 0.0) == (4, int(tl[4].argmax()))


def test_spec_verify_plain_greedy_ignores_uniforms():
    """At T=0 the next token is the target argmax whatever u_res is — even
    u_res == 0, where the inverse-CDF draw would return token 0."""
    tl, dl, toks = _spec_case(4, 1000)
    got = {_port(tl, dl, toks, np.full((5,), u, np.float32),
                 np.full((5,), u, np.float32), 0.0)
           for u in (0.0, 0.3, 0.999)}
    assert len(got) == 1
    n, t = got.pop()
    assert t == int(tl[n].argmax())


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_spec_verify_plain_batched_vs_pallas(temperature):
    """The grouped port call equals the JAX grouped kernel, member by
    member, with each member's JAX uniforms."""
    G, gamma, V = 3, 4, 256
    rngs = jax.random.split(jax.random.PRNGKey(7), G)
    tl = _np(0, (G, gamma + 1, V), 2.0)
    dl = tl[:, :gamma] + _np(1, (G, gamma, V))
    toks = np.random.default_rng(2).integers(0, V, (G, gamma)) \
        .astype(np.int32)
    us = [_jax_uniforms(rngs[g], gamma) for g in range(G)]
    u_acc = np.stack([u[0] for u in us])
    u_res = np.stack([u[1] for u in us])
    n_t, t_t = tops.spec_verify(_t(tl), _t(dl), _t(toks), _t(u_acc),
                                _t(u_res), temperature=temperature)
    n_j, t_j = jops.spec_verify_batched(rngs, jnp.asarray(tl),
                                        jnp.asarray(dl), jnp.asarray(toks),
                                        temperature=temperature)
    for g in range(G):
        if (int(n_t[g]), int(t_t[g])) != (int(n_j[g]), int(t_j[g])):
            assert temperature > 0 and _near_tie(
                tl[g], dl[g], toks[g], u_acc[g], u_res[g], temperature)


def test_spec_split_plan():
    """The spec-verify kernel's vocabulary split, from shapes only: 8 chunks
    of 6144 at the serving shape (40 rows: 320 blocks on 132 SMs) and of
    4000 at V 32000; one for a small vocabulary; enough that a chunk fits
    shared memory when the rows alone fill the card; chunks are multiples
    of 4 and cover V."""
    assert spec_splits(40, 49152, 132) == (8, 6144)
    assert spec_splits(40, 32000, 132) == (8, 4000)
    assert spec_splits(40, 1000, 132) == (1, 1000)
    assert spec_splits(320, 49152, 132) == (4, 12288)
    assert spec_splits(6, 257216, 132) == (8, 32152)
    assert spec_splits(18, 4099, 132) == (2, 2052)
    for rows, V in ((1, 64), (2, 5), (40, 49157), (900, 151936),
                    (40, 4097)):
        nsplit, chunk = spec_splits(rows, V, 132)
        assert 1 <= nsplit <= 8 and chunk % 4 == 0
        assert (nsplit - 1) * chunk < V <= nsplit * chunk


def _spec_split_model(tl, dl, toks, u_acc, u_res, temperature, nsplit):
    """A plain model of the spec-verify kernel's split of one group: each
    row's vocabulary is cut into ``nsplit`` chunks of a multiple of 4
    entries; each chunk reduces to (max, first argmax, tie count at T = 0 or
    sum of exp(x / T - max / T)) and the partials merge in chunk order; at
    T > 0 each chunk's residual (or p) mass gives its offset, and the
    chunks' counts of cdf entries below u_res (cdf unnormalised against
    u_res times the total) sum to the sample."""
    gamma, V = dl.shape
    T = temperature
    chunk = -(-(-(-V // nsplit)) // 4) * 4
    bounds = [(min(c * chunk, V), min(c * chunk + chunk, V))
              for c in range(nsplit)]

    def merge(a, b):
        M = max(a[0], b[0])
        i = a[1] if a[0] > b[0] else b[1] if b[0] > a[0] else min(a[1], b[1])
        if T == 0:
            z = (a[2] if a[0] == M else 0.0) + (b[2] if b[0] == M else 0.0)
        else:
            z = sum(x[2] * torch.exp(x[0] / T - M / T) if x[2] > 0 else 0.0
                    for x in (a, b))
        return M, i, z

    def reduce(x):
        total = (torch.tensor(-np.inf), 2 ** 31 - 1, 0.0)
        for c0, c1 in bounds:
            seg = x[c0:c1]
            if len(seg) == 0:
                continue
            m = seg.max()
            z = (seg >= m).float().sum() if T == 0 \
                else torch.exp(seg / T - m / T).sum()
            total = merge(total, (m, c0 + int(seg.argmax()), z))
        return total

    flags, picks = [], []
    for i in range(gamma + 1):
        bonus = i == gamma
        x = torch.from_numpy(tl[i])
        y = torch.zeros(V) if bonus else torch.from_numpy(dl[i])
        (pm, pi, pz), (qm, _, qz) = reduce(x), reduce(y)
        tok = 0 if bonus else int(toks[i])
        if T == 0:
            p_tok = 1.0 / pz if x[tok] >= pm else 0.0
            q_tok = 1.0 / qz if y[tok] >= qm else 0.0
            picks.append(pi)
        else:
            p = torch.exp(x / T - pm / T) / pz
            q = torch.zeros(V) if bonus else torch.exp(y / T - qm / T) / qz
            p_tok, q_tok = float(p[tok]), float(q[tok])
            r = torch.clamp(p - q, min=0.0)
            tot = sum(float(r[c0:c1].sum()) for c0, c1 in bounds)
            w = p if not tot > 0 else r
            thr = float(u_res[i]) * (1.0 if not tot > 0 else tot)
            off, below = 0.0, 0
            for c0, c1 in bounds:
                below += int(((off + torch.cumsum(w[c0:c1], 0)) < thr).sum())
                off += float(w[c0:c1].sum())
            picks.append(min(below, V - 1))
        ratio = float(p_tok) / max(float(q_tok), 1e-20)
        flags.append(not bonus and float(u_acc[i]) < min(ratio, 1.0))
    n = 0
    while n < gamma and flags[n]:
        n += 1
    return n, picks[n]


@pytest.mark.parametrize("nsplit", [1, 3, 8])
@pytest.mark.parametrize("gamma,V", [(4, 1000), (2, 4099)])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_spec_split_model_vs_pallas(nsplit, gamma, V, temperature):
    """The split model equals the plain version and the Pallas kernel
    (interpret mode) on the JAX uniforms: exactly at T = 0, and at T = 1 on
    every group without a near-tie (counted; at most one in four may
    differ).  V 4099 is divided by neither 3 nor 8 chunks."""
    near = 0
    for seed in range(4):
        tl, dl, toks = _spec_case(gamma, V, 10 * seed)
        rng = jax.random.PRNGKey(seed)
        u_acc, u_res = _jax_uniforms(rng, gamma)
        got = _spec_split_model(tl, dl, toks, u_acc, u_res, temperature,
                                nsplit)
        n, t = jops.spec_verify(rng, jnp.asarray(tl), jnp.asarray(dl),
                                jnp.asarray(toks), temperature=temperature)
        for want in (_port(tl, dl, toks, u_acc, u_res, temperature),
                     (int(n), int(t))):
            if got != want:
                tie = _near_tie(tl, dl, toks, u_acc, u_res, temperature)
                assert temperature > 0 and tie, (seed, got, want)
                near += 1
    assert near <= 2, f"{near} near-tie disagreements of 8 comparisons"


@pytest.mark.parametrize("nsplit", [3, 8])
def test_spec_split_model_ties_across_chunks(nsplit):
    """Exact ties at T = 0 on both sides of every chunk boundary: the tie
    counts (which set p[tok] and q[tok], so the accept test) and the first
    argmax combine across chunks, as in the plain version; n_acc as in the
    Pallas kernel (interpret mode), whose next token is an inverse-CDF draw
    among the tied maxima where the port's contract takes the first)."""
    gamma, V = 4, 1000
    chunk = -(-(-(-V // nsplit)) // 4) * 4
    edges = [c * chunk + d for c in range(1, nsplit) for d in (-1, 0)
             if c * chunk < V]
    for seed in range(4):
        tl, dl, toks = _spec_case(gamma, V, seed)
        for i in range(gamma + 1):
            tie = [edges[(seed + i + j) % len(edges)] for j in range(2)]
            tl[i, tie] = 20.0
            if i < gamma:
                dl[i, tie[: 1 + (seed + i) % 2]] = 20.0
                toks[i] = tie[(seed + i) % 2]
        u = np.full((gamma + 1,), 0.75, np.float32)   # between 1/2 and 1
        rng = jax.random.PRNGKey(seed)
        u_acc, u_res = _jax_uniforms(rng, gamma)
        got = _spec_split_model(tl, dl, toks, u, u, 0.0, nsplit)
        assert got == _port(tl, dl, toks, u, u, 0.0)
        assert got[1] == min(t for t in range(V) if tl[got[0], t] == 20.0)
        got = _spec_split_model(tl, dl, toks, u_acc, u_res, 0.0, nsplit)
        assert got == _port(tl, dl, toks, u_acc, u_res, 0.0)
        n, _ = jops.spec_verify(rng, jnp.asarray(tl), jnp.asarray(dl),
                                jnp.asarray(toks), temperature=0.0)
        assert got[0] == int(n)


# ------------------------------------------------------------ no fallback
def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never quietly runs the plain version: handed CPU
    tensors it raises (the dispatcher picks the plain version only because
    the tensor lies on the CPU)."""
    q = torch.zeros((1, 1, 16, 64))
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError):
        paged_decode_attention_cuda(
            torch.zeros((1, 1, 1, 64)), torch.zeros((2, 16, 1, 64)),
            torch.zeros((2, 16, 1, 64)), torch.ones((1, 1), dtype=torch.int32),
            torch.ones((1,), dtype=torch.int32))
    with pytest.raises(ValueError):
        spec_verify_cuda(torch.zeros((1, 2, 8)), torch.zeros((1, 1, 8)),
                         torch.zeros((1, 1), dtype=torch.int32),
                         torch.zeros((1, 2)), torch.zeros((1, 2)))
    kv = torch.zeros((1, 1, 16, 64))
    with pytest.raises(ValueError):
        decode_attention_cuda(torch.zeros((1, 1, 1, 64)), kv, kv,
                              torch.ones((1,), dtype=torch.int32))
    with pytest.raises(ValueError):
        tree_verify_attention_cuda(
            torch.zeros((1, 1, 1, 2, 64)), kv, kv,
            torch.ones((1,), dtype=torch.int32),
            torch.ones((2, 2), dtype=torch.bool),
            torch.ones((1, 2), dtype=torch.int32))


def test_serving_kernels_refuse_grad():
    """The four serving-only kernels (paged and dense decode, tree verify,
    spec verify) have no backward: under grad their wrappers raise before
    anything else (here on CPU tensors), rather than detach the gradient."""
    q = torch.zeros((1, 2, 1, 8), requires_grad=True)
    kv = torch.zeros((1, 4, 2, 8))
    length = torch.full((1,), 4, dtype=torch.int32)
    logits = torch.zeros((1, 3, 16), requires_grad=True)
    calls = {
        "paged_decode_attention_cuda": lambda: paged_decode_attention_cuda(
            q, kv, kv, torch.zeros((1, 1), dtype=torch.int32), length),
        "decode_attention_cuda": lambda: decode_attention_cuda(
            q, kv, kv, length),
        "tree_verify_attention_cuda": lambda: tree_verify_attention_cuda(
            q[:, :, None], kv, kv, length,
            torch.ones((1, 1), dtype=torch.bool),
            torch.zeros((1, 1), dtype=torch.int32)),
        "spec_verify_cuda": lambda: spec_verify_cuda(
            logits, logits.detach()[:, :2], torch.zeros((1, 2),
                                                        dtype=torch.int32),
            torch.zeros((1, 2)), torch.zeros((1,))),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call()
