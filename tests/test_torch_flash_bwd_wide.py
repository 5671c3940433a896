"""The flash backward's ``wgmma256`` route (bfloat16, 128 < hd <= 256:
paligemma-3b's hd 256) on the CPU: its plan, its walk against a
brute-force count of the visible tiles, and a float32 model of its tiled
arithmetic against ``jax.grad`` of the JAX model's attention.

The kernel (``csrc/flash_attention_bwd.cu``, namespace ``tc256``) runs
only on the card (``tests/test_torch_cuda.py`` holds it against the plain
autograd there).  Here ``_tiled_bwd_wide`` repeats what its blocks do, in
float32: the head dim padded to 256 with zeros; rows packed over the kv
head's G query heads into 64-row tiles, 64-key tiles; a dK/dV block per
key tile walking ``BwdPlan.query_tiles``, its two warpgroups forming
query rows [0, 32) and [32, 64) of S^T and dP^T, exact zeros where
masked, then each adding its head-dim half (columns [0, 128) or [128,
256)) of P^T dO and dS^T Q; a dQ block per query tile walking
``BwdPlan.key_tiles``, the warpgroups forming keys [0, 32) and [32, 64)
of S and dP, each adding its head-dim half of dS K.  The reference is
``jax.grad`` of ``repro.models.layers.mha`` under
``_attn_mask(prefix_len=)``, the attention the JAX package trains
through.  Tolerance: atol = rtol = 1e-5 (float32 sums over up to 256
columns and 130 keys in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.flash_attention import flash_bwd_plan  # noqa: E402

PAD = 256            # the route's padded head dim
HALF = PAD // 2      # a warpgroup's columns of dK, dV and dQ


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 144, "wgmma256"), (torch.bfloat16, 192, "wgmma256"),
    (torch.bfloat16, 256, "wgmma256"), (torch.bfloat16, 129, "wgmma256"),
    (torch.bfloat16, 128, "wgmma"), (torch.float32, 144, "cuda_cores"),
    (torch.float32, 192, "cuda_cores"), (torch.float32, 256, "cuda_cores")])
def test_flash_bwd_plan_routes_wide_heads(dtype, hd, route):
    """bfloat16 above hd 128 takes wgmma256 (64-row tiles packed over the
    G heads, 64-key tiles); float32 stays on the exact CUDA-core route at
    every head dim; hd 128 stays on wgmma."""
    for G, S, causal, window, prefix in ((8, 512, True, 0, 256),
                                         (1, 16, False, 0, 0),
                                         (3, 90, True, 17, 20)):
        plan = flash_bwd_plan(dtype, hd, G, S, S, causal, window, prefix)
        assert plan.route == route
        assert (plan.tile, plan.pack) == ((32, 1) if route == "cuda_cores"
                                          else (64, G))
        assert plan.prefix == (prefix if causal else 0)


def _visible(Sq, Sk, causal, window, prefix):
    """(Sq, Sk) bool, key j visible to query i: the kernels' mask."""
    i = np.arange(Sq)[:, None]
    j = np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis = (j <= i) | (j < prefix)
    if window:
        vis = vis & (j > i - window)
    return vis


# (G, Sq, Sk, causal, window, prefix): paligemma's 8 heads on one kv head
# over 256 image + 16 text rows and at the training shape, prefixes that
# end inside a tile (with G 3 straddling tiles), at a tile's edge and past
# S, a window with and without a prefix, G 1, and non-causal Sq != Sk (the
# whisper cross-attention form, cut to 150 keys); every row sees a key
WALKS = [(8, 272, 272, True, 0, 256), (8, 512, 512, True, 0, 256),
         (3, 100, 100, True, 0, 37), (8, 130, 130, True, 0, 64),
         (3, 90, 90, True, 0, 200), (8, 75, 75, True, 17, 20),
         (3, 70, 70, True, 23, 0), (1, 130, 130, True, 0, 0),
         (1, 16, 150, False, 0, 0), (8, 40, 72, False, 0, 0),
         (3, 64, 100, False, 30, 0)]


@pytest.mark.parametrize("G,Sq,Sk,causal,window,prefix", WALKS)
def test_wgmma256_plan_walks_every_visible_tile(G, Sq, Sk, causal, window,
                                                prefix):
    """Each dK/dV block walks exactly the packed query tiles that hold a
    (row, key) visible in its key tile, and each dQ block exactly the key
    tiles one of its rows sees: the walks' lengths equal the brute-force
    count, and each walk is a run of such tiles."""
    vis = _visible(Sq, Sk, causal, window, prefix)
    plan = flash_bwd_plan(torch.bfloat16, 256, G, Sq, Sk, causal, window,
                          prefix)
    assert plan.route == "wgmma256"
    t = plan.tile
    packed = np.repeat(vis, G, axis=0)            # row r: position r // G
    seen = np.array([[packed[qt * t:(qt + 1) * t, kt * t:(kt + 1) * t].any()
                      for kt in range(plan.n_key_tiles)]
                     for qt in range(plan.n_query_tiles)])
    assert seen.shape == (-(-G * Sq // 64), -(-Sk // 64))
    for kt in range(plan.n_key_tiles):
        walk = plan.query_tiles(kt)
        assert len(walk) == seen[:, kt].sum()
        assert all(seen[qt, kt] for qt in walk)
    for qt in range(plan.n_query_tiles):
        walk = plan.key_tiles(qt)
        assert len(walk) == seen[qt].sum() > 0
        assert all(seen[qt, kt] for kt in walk)
    assert sum(len(plan.query_tiles(kt)) for kt in range(plan.n_key_tiles)) \
        == sum(len(plan.key_tiles(qt)) for qt in range(plan.n_query_tiles)) \
        == seen.sum()


def _tiled_bwd_wide(q, k, v, dout, causal, window, prefix):
    """The wgmma256 route's arithmetic in float32 (see the module
    docstring): q, dout (B, H, Sq, hd), k, v (B, Kv, Sk, hd)."""
    B, H, Sq, hd = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    G = H // Kv
    plan = flash_bwd_plan(torch.bfloat16, hd, G, Sq, Sk, causal, window,
                          prefix)
    assert plan.route == "wgmma256" and plan.tile == 64
    t, scale, n_rows = plan.tile, hd ** -0.5, G * Sq
    vis = torch.from_numpy(_visible(Sq, Sk, causal, window, prefix))
    kk = k.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk) * scale
    lse = torch.logsumexp(s.masked_fill(~vis, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None])
                       * vis, v.repeat_interleave(G, dim=1))
    delta = (dout * out).sum(-1)

    def pad_rows(x, n):      # zero rows to n, zero columns to PAD
        return torch.nn.functional.pad(x, (0, PAD - hd, 0,
                                           n - x.shape[2]))

    def pack(x):             # (B, H, Sq, ...) -> (B, Kv, G Sq, ...)
        x = x.reshape(B, Kv, G, Sq, -1).transpose(2, 3)
        return x.reshape(B, Kv, Sq * G, -1)

    nq, nk = plan.n_query_tiles * t, plan.n_key_tiles * t
    qp, gp = pad_rows(pack(q), nq), pad_rows(pack(dout), nq)
    kp, vp = pad_rows(k, nk), pad_rows(v, nk)
    lp = torch.nn.functional.pad(pack(lse[..., None])[..., 0],
                                 (0, nq - n_rows))
    dp_ = torch.nn.functional.pad(pack(delta[..., None])[..., 0],
                                  (0, nq - n_rows))
    r = torch.arange(nq)
    j = torch.arange(nk)
    pos = (r // G).clamp(max=Sq - 1)
    visp = vis[pos][:, j.clamp(max=Sk - 1)] & (r < n_rows)[:, None] \
        & (j < Sk)[None, :]          # (packed rows, keys), pads masked

    def scores(rows, keys):
        """P and dS of rows x keys, exact zeros where masked."""
        sc = torch.einsum("bkrd,bkjd->bkrj", qp[:, :, rows],
                          kp[:, :, keys]) * scale
        dp = torch.einsum("bkrd,bkjd->bkrj", gp[:, :, rows], vp[:, :, keys])
        m = visp[rows][:, keys]
        p = torch.where(m, torch.exp(sc - lp[:, :, rows, None]), 0.0)
        return p, torch.where(m, p * (dp - dp_[:, :, rows, None]), 0.0)

    halves = (slice(0, HALF), slice(HALF, PAD))
    dq, dk, dv = (torch.zeros_like(x) for x in (qp, kp, vp))
    for kt in range(plan.n_key_tiles):
        keys = slice(kt * t, kt * t + t)
        for qt in plan.query_tiles(kt):
            # each warpgroup its 32 query rows of P^T and dS^T
            parts = [scores(slice(qt * t + 32 * w, qt * t + 32 * w + 32),
                            keys) for w in (0, 1)]
            p = torch.cat([x[0] for x in parts], dim=2)
            ds = torch.cat([x[1] for x in parts], dim=2)
            rows = slice(qt * t, qt * t + t)
            for c in halves:          # each warpgroup its head-dim half
                dv[..., keys, c] += torch.einsum("bkrj,bkrd->bkjd", p,
                                                 gp[:, :, rows, c])
                dk[..., keys, c] += torch.einsum("bkrj,bkrd->bkjd", ds,
                                                 qp[:, :, rows, c])
    for qt in range(plan.n_query_tiles):
        rows = slice(qt * t, qt * t + t)
        for kt in plan.key_tiles(qt):
            # each warpgroup its 32 keys of dS
            ds = torch.cat([scores(rows, slice(kt * t + 32 * w,
                                               kt * t + 32 * w + 32))[1]
                            for w in (0, 1)], dim=3)
            keys = slice(kt * t, kt * t + t)
            for c in halves:
                dq[..., rows, c] += torch.einsum("bkrj,bkjd->bkrd", ds,
                                                 kp[:, :, keys, c])
    dq = dq[:, :, :n_rows, :hd].reshape(B, Kv, Sq, G, hd).transpose(2, 3) \
        .reshape(B, H, Sq, hd) * scale
    return dq, dk[:, :, :Sk, :hd] * scale, dv[:, :, :Sk, :hd]


# (B, Kv, G, Sq, Sk, hd, causal, window, prefix): paligemma's heads (G 8
# on one kv head, hd 256) with a prefix at a tile's edge, inside a tile
# and past S; G 3 straddling tiles under a window and a prefix, with two
# sequences and two kv heads; G 1 causal; non-causal Sq != Sk; hd 192
# (the padded columns)
MODEL_CASES = [(1, 1, 8, 130, 130, 256, True, 0, 64),
               (1, 1, 8, 100, 100, 256, True, 0, 37),
               (1, 1, 8, 90, 90, 256, True, 0, 200),
               (2, 2, 3, 120, 120, 256, True, 40, 20),
               (1, 2, 1, 80, 80, 256, True, 0, 0),
               (1, 1, 8, 16, 130, 256, False, 0, 0),
               (1, 1, 3, 70, 70, 192, True, 0, 30)]


@pytest.mark.parametrize("B,Kv,G,Sq,Sk,hd,causal,window,prefix",
                         MODEL_CASES)
def test_wgmma256_tiled_model_matches_jax(B, Kv, G, Sq, Sk, hd, causal,
                                          window, prefix):
    """The tiled model of the wgmma256 walk vs jax.grad of the JAX
    model's ``mha`` under ``_attn_mask(prefix_len=)``."""
    H = Kv * G
    rng = np.random.default_rng(1000 * G + Sq + Sk + hd + window + prefix)
    q, dout = (rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, Kv, hd)).astype(np.float32)
            for _ in range(2))
    mask = JL._attn_mask(jnp.arange(Sq), jnp.arange(Sk), causal=causal,
                         window=window, prefix_len=prefix if causal else 0)

    def jf(q, k, v):
        return jnp.sum(JL.mha(q, k, v, mask=mask) * dout)

    jg = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    def bhsd(x):
        return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1,
                                                                 3)))

    tg = _tiled_bwd_wide(*(bhsd(x) for x in (q, k, v, dout)), causal,
                         window, prefix)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy().transpose(0, 2, 1, 3),
                                   np.asarray(b), atol=1e-5, rtol=1e-5)
