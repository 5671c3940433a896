"""The port's plain kernel versions vs the JAX package's Pallas kernels.

Each of the three ported kernels' plain PyTorch version (what the port runs
on the CPU) is held against the JAX Pallas kernel in interpret mode
(``repro.kernels.ops`` on the CPU) and against its jnp oracle
(``repro.kernels.ref``), on the sweeps of ``tests/test_kernels.py``.  Inputs
come from numpy seeds and are handed to both frameworks.

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
    paged_decode_attention_cuda, paged_decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.spec_verify import (  # noqa: E402
    spec_verify_cuda, spec_verify_plain)

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
