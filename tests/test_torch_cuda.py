"""The port's Hopper kernels vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one; the skip is decided inside the ``cuda`` fixture, never at import.  The
module imports only torch and numpy, so it runs on a machine without JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 atol 1e-5, bfloat16 2e-2 (kernel and plain version
differ in summation order; bfloat16 outputs round once); the SSD scan
atol = rtol = 1e-4 in float32 (the JAX kernel sweep's: chunked sums of up
to 256 products) and 2e-2 from bfloat16 inputs.  ``spec_verify``
is exact at T = 0; at T = 1 with shared uniforms it is exact on every
group without a near-tie (a uniform within 1e-6 of a cdf entry or an
accept ratio, recomputed in float64).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_cuda, decode_attention_plain, paged_decode_attention_cuda,
    paged_decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.spec_verify import (  # noqa: E402
    spec_verify_cuda, spec_verify_plain)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_chunk_scan_cuda, ssd_chunk_scan_plain)
from repro_torch.kernels.tree_attention import (  # noqa: E402
    tree_verify_attention_cuda, tree_verify_attention_plain)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(seed, shape, dev, dtype=torch.float32, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.as_tensor(x, dtype=torch.float32, device=dev).to(dtype)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("B,H,S,hd", [(1, 1, 128, 64), (2, 3, 256, 64),
                                      (1, 2, 512, 128), (1, 9, 16, 64),
                                      (1, 32, 15, 128), (1, 32, 15, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32),
                                           (False, 0)])
def test_flash_attention_kernel(cuda, B, H, S, hd, dtype, causal, window):
    q, k, v = (_rand(i, (B, H, S, hd), cuda, dtype) for i in range(3))
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    ref = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert _err(out, ref) <= TOL[dtype]


def _proj_view(seed, B, S, heads, hd, dev, dtype):
    """A (B, heads, S, hd) view of a projection stored (B, S, heads, hd),
    as ``layers.attention_block`` hands it to the kernel."""
    return _rand(seed, (B, S, heads, hd), dev, dtype).transpose(1, 2)


@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("S,hd,causal", [(15, 80, True), (16, 64, True),
                                         (16, 128, True), (200, 128, True),
                                         (200, 64, False),
                                         (2048, 128, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 37])
def test_flash_attention_kernel_gqa_views(cuda, G, S, hd, causal, dtype,
                                          window):
    """Kv = 2 kv heads of G query heads each, q/k/v as strided views of
    (B, S, heads, hd) projections: the kernel reads them in place and
    writes its output laid out like q."""
    B, Kv = 2 if S < 2048 else 1, 2
    q = _proj_view(0, B, S, Kv * G, hd, cuda, dtype)
    k = _proj_view(1, B, S, Kv, hd, cuda, dtype)
    v = _proj_view(2, B, S, Kv, hd, cuda, dtype)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    ref = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert out.stride() == q.stride()
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("B,Kv,G", [(1, 8, 4), (1, 16, 1), (8, 8, 4),
                                    (8, 32, 1)])
@pytest.mark.parametrize("window", [0, 5])
def test_flash_attention_kernel_short_prefill(cuda, B, Kv, G, window):
    """16-token prefills whose grids fill a small part (8 or 16 blocks),
    half (64 blocks) or more than the card: the kernel gives each block of
    a grid of at most a quarter of the SMs 16 rows, a larger one 64."""
    S, hd = 16, 128
    q = _proj_view(0, B, S, Kv * G, hd, cuda, torch.bfloat16)
    k = _proj_view(1, B, S, Kv, hd, cuda, torch.bfloat16)
    v = _proj_view(2, B, S, Kv, hd, cuda, torch.bfloat16)
    out = flash_attention_cuda(q, k, v, causal=True, window=window)
    ref = flash_attention_plain(q, k, v, causal=True, window=window)
    assert _err(out, ref) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_block_makes_no_copies(cuda, dtype):
    """On CUDA the prefill attention hands its projections to the flash
    kernel as views: no repeat_interleave and no contiguous copy of q, k or
    v (torch.profiler's operator counts), one kernel launch, and at float32
    the plain path's result."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    cfg = get_config("smollm-135m").replace(
        num_layers=1, vocab_size=512, param_dtype=str(dtype)[6:],
        activ_dtype=str(dtype)[6:])
    attn = Model(cfg).init(seed=0, device="cuda").blocks[0].attn
    x = _rand(0, (2, 16, cfg.d_model), cuda, dtype)
    pos = torch.arange(16, device=cuda)
    L.attention_block(attn, x, pos, cfg)                   # warm-up
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, _ = L.attention_block(attn, x, pos, cfg)
    names = {e.key: e.count for e in prof.key_averages()}
    for op in ("aten::repeat_interleave", "aten::contiguous", "aten::clone"):
        assert op not in names, f"{op} x{names[op]}"
    assert ops.launch_counts()["flash_attention"] == 1
    if dtype == torch.float32:
        ref, _ = L.attention_block(attn, x, pos, cfg, backend="plain")
        assert _err(out, ref) <= 1e-4


@pytest.mark.parametrize("B,Kv,G,bs,MB,hd", [(1, 1, 1, 16, 4, 64),
                                             (3, 2, 4, 16, 8, 64),
                                             (2, 4, 2, 32, 4, 128),
                                             (8, 3, 3, 32, 3, 64),
                                             (2, 4, 2, 32, 4, 80),
                                             (2, 2, 5, 16, 4, 64),
                                             (3, 1, 8, 32, 4, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 11, 48])
def test_paged_decode_kernel(cuda, B, Kv, G, bs, MB, hd, dtype, window):
    NB = B * MB + 1
    q = _rand(0, (B, Kv, G, hd), cuda, dtype)
    kp = _rand(1, (NB, bs, Kv, hd), cuda, dtype)
    vp = _rand(2, (NB, bs, Kv, hd), cuda, dtype)
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.permutation(np.arange(1, NB))[:B * MB]
                            .reshape(B, MB), dtype=torch.int32, device=cuda)
    length = torch.as_tensor(rng.integers(1, MB * bs + 1, B),
                             dtype=torch.int32, device=cuda)
    out = paged_decode_attention_cuda(q, kp, vp, table, length,
                                      window=window)
    ref = paged_decode_attention_plain(q, kp, vp, table, length,
                                       window=window)
    assert _err(out, ref) <= TOL[dtype]


def _boundary_lengths(bs, MB, eps):
    """Lengths on and beside the block and split boundaries of a table of
    MB blocks walked in splits of ``eps`` entries, and length 1."""
    edges = {1, bs - 1, bs, bs + 1, eps * bs - 1, eps * bs, eps * bs + 1,
             MB * bs - 1, MB * bs}
    return sorted(x for x in edges if 1 <= x <= MB * bs)


@pytest.mark.parametrize("Kv,G,bs,MB,hd", [(2, 3, 32, 128, 64),
                                          (1, 4, 16, 96, 128),
                                          (3, 3, 32, 64, 80),
                                          (1, 5, 32, 128, 64),
                                          (2, 8, 16, 64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 11, 48])
def test_paged_decode_kernel_split(cuda, Kv, G, bs, MB, hd, dtype, window):
    """Tables long enough that the kernel splits the key range: lengths on
    and beside the split and block boundaries, length 1 (every split but
    the first sees no key), against the plain version."""
    from repro_torch.kernels.decode_attention import paged_splits, paged_walk
    nsplit, eps = paged_splits(8, Kv, G, paged_walk(MB, bs, 0),
                               torch.cuda.get_device_properties(cuda)
                               .multi_processor_count)
    assert window or nsplit > 1
    lengths = _boundary_lengths(bs, MB, eps)
    B = len(lengths)
    NB = B * MB + 1
    q = _rand(0, (B, Kv, G, hd), cuda, dtype)
    kp = _rand(1, (NB, bs, Kv, hd), cuda, dtype)
    vp = _rand(2, (NB, bs, Kv, hd), cuda, dtype)
    rng = np.random.default_rng(1)
    table = torch.as_tensor(rng.permutation(np.arange(1, NB)).reshape(B, MB),
                            dtype=torch.int32, device=cuda)
    length = torch.as_tensor(lengths, dtype=torch.int32, device=cuda)
    out = paged_decode_attention_cuda(q, kp, vp, table, length,
                                      window=window)
    ref = paged_decode_attention_plain(q, kp, vp, table, length,
                                       window=window)
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("MB", [4, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 11, 48])
def test_paged_decode_kernel_masks_by_selection(cuda, MB, dtype, window):
    """The trap block, every table entry past a slot's length (pointing at
    the trap block, as the serving pool leaves them) and every position at
    or past the length are NaN in the kernel's pools; the plain version,
    which weights masked keys by zero, runs on the same pools with those
    entries zeroed.  Equal outputs show the kernel never multiplies a
    masked key by zero."""
    B, Kv, G, bs, hd = 6, 2, 3, 16, 64
    lengths = [1, 15, 16, 17, 40, MB * bs]
    NB = B * MB + 1
    q = _rand(0, (B, Kv, G, hd), cuda, dtype)
    kp = _rand(1, (NB, bs, Kv, hd), cuda, dtype)
    vp = _rand(2, (NB, bs, Kv, hd), cuda, dtype)
    table = torch.arange(1, NB, dtype=torch.int32, device=cuda).reshape(B, MB)
    nan = torch.zeros((NB, bs), dtype=torch.bool, device=cuda)
    nan[0] = True
    for b, n in enumerate(lengths):
        for i in range(MB):
            if i * bs >= n:
                table[b, i] = 0
            else:
                nan[table[b, i], max(n - i * bs, 0):] = True
    length = torch.as_tensor(lengths, dtype=torch.int32, device=cuda)
    kz, vz = (torch.where(nan[:, :, None, None], 0.0, x).to(dtype)
              for x in (kp, vp))
    kn, vn = (torch.where(nan[:, :, None, None], float("nan"), x).to(dtype)
              for x in (kp, vp))
    out = paged_decode_attention_cuda(q, kn, vn, table, length,
                                      window=window)
    ref = paged_decode_attention_plain(q, kz, vz, table, length,
                                       window=window)
    assert bool(torch.isfinite(out).all())
    assert _err(out, ref) <= TOL[dtype]


def _cache_view(seed, B, Kv, S, hd, dev, dtype):
    """A (B, Kv, S, hd) view of a cache stored (B, S, Kv, hd), the serving
    layout the kernels read through strides."""
    return _rand(seed, (B, S, Kv, hd), dev, dtype).permute(0, 2, 1, 3)


@pytest.mark.parametrize("B,Kv,G,S,hd", [(1, 1, 1, 256, 64),
                                         (2, 2, 4, 512, 64),
                                         (8, 3, 3, 80, 64),
                                         (8, 8, 4, 95, 128),
                                         (8, 32, 1, 45, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 11, 64])
def test_decode_attention_kernel(cuda, B, Kv, G, S, hd, dtype, window):
    q = _rand(0, (B, Kv, G, hd), cuda, dtype)
    k = _cache_view(1, B, Kv, S, hd, cuda, dtype)
    v = _cache_view(2, B, Kv, S, hd, cuda, dtype)
    length = torch.as_tensor(np.random.default_rng(0).integers(1, S + 3, B),
                             dtype=torch.int32, device=cuda)   # some > S
    out = decode_attention_cuda(q, k, v, length, window=window)
    ref = decode_attention_plain(q, k, v, length, window=window)
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("S", [80, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 11, 64])
def test_decode_attention_kernel_masks_by_selection(cuda, S, dtype, window):
    """Every cache position outside a slot's visible range (at or past its
    length, before the window) is NaN in the kernel's cache; the plain
    version, which weights masked keys by zero, runs on the same cache with
    those positions zeroed.  Equal outputs show the kernel never multiplies
    a masked key by zero."""
    B, Kv, G, hd = 6, 2, 3, 64
    lengths = [1, 15, 16, 17, 40, S]
    length = torch.as_tensor(lengths, dtype=torch.int32, device=cuda)
    pos = torch.arange(S, device=cuda)[None, :]
    ln = length.long()[:, None]
    masked = pos >= ln
    if window:
        masked |= pos < ln - window
    m = masked[:, None, :, None]             # broadcast over kv heads, hd
    q = _rand(0, (B, Kv, G, hd), cuda, dtype)
    k = _cache_view(1, B, Kv, S, hd, cuda, dtype)
    v = _cache_view(2, B, Kv, S, hd, cuda, dtype)
    kz, vz = (torch.where(m, 0.0, x.float()).to(dtype) for x in (k, v))
    kn, vn = (torch.where(m, float("nan"), x.float()).to(dtype)
              .permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
              for x in (k, v))
    out = decode_attention_cuda(q, kn, vn, length, window=window)
    ref = decode_attention_plain(q, kz, vz, length, window=window)
    assert bool(torch.isfinite(out).all())
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("Kv,G,hd", [(3, 3, 64), (32, 1, 80), (2, 8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 11, 600])
def test_decode_attention_kernel_split(cuda, Kv, G, hd, dtype, window):
    """A 4096-position cache, which the kernel splits (the split count
    from shapes alone): lengths on and beside the split boundaries, length
    1 (every split but the first sees no key) and lengths above S."""
    from repro_torch.kernels.decode_attention import dense_splits
    S = 4096
    nsplit, eps = dense_splits(8, Kv, G, S, window,
                               torch.cuda.get_device_properties(cuda)
                               .multi_processor_count)
    assert window == 11 or nsplit > 1
    edges = {1, eps - 1, eps, eps + 1, 2 * eps + 3, S - 1, S, S + 2}
    lengths = sorted(x for x in edges if x >= 1)
    B = len(lengths)
    q = _rand(0, (B, Kv, G, hd), cuda, dtype)
    k = _cache_view(1, B, Kv, S, hd, cuda, dtype)
    v = _cache_view(2, B, Kv, S, hd, cuda, dtype)
    length = torch.as_tensor(lengths, dtype=torch.int32, device=cuda)
    out = decode_attention_cuda(q, k, v, length, window=window)
    ref = decode_attention_plain(q, k, v, length, window=window)
    assert _err(out, ref) <= TOL[dtype]


def _plan():
    from repro_torch.core.tree_speculation import TreePlan, branching_for
    return TreePlan(branching_for(2, 4))


@pytest.mark.parametrize("B,Kv,G,S,hd", [(1, 1, 1, 256, 64),
                                         (2, 2, 4, 160, 64),
                                         (8, 3, 3, 90, 64),
                                         (8, 8, 4, 90, 128),
                                         (2, 2, 8, 100, 64),
                                         (2, 2, 4, 90, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 8])
def test_tree_verify_attention_kernel(cuda, B, Kv, G, S, hd, dtype, window):
    """The one-shot verify (C == N, pad rows self-only); G * N = 128 rows
    in the last case takes two blocks of query rows."""
    plan = _plan()
    N = plan.n_pad
    q = _rand(0, (B, N, Kv, G, hd), cuda, dtype).permute(0, 2, 3, 1, 4)
    k = _cache_view(1, B, Kv, S, hd, cuda, dtype)
    v = _cache_view(2, B, Kv, S, hd, cuda, dtype)
    rng = np.random.default_rng(0)
    length = torch.as_tensor(rng.integers(1, S - N + 1, B), dtype=torch.int32,
                             device=cuda)
    q_pos = (length[:, None] + torch.as_tensor(plan.depths, device=cuda)) \
        .to(torch.int32).contiguous()
    mask = torch.as_tensor(plan.mask, device=cuda)
    out = tree_verify_attention_cuda(q, k, v, length, mask, q_pos,
                                     window=window)
    ref = tree_verify_attention_plain(q, k, v, length, mask, q_pos,
                                      window=window)
    assert out.stride() == q.stride()
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("B,Kv,G,S,hd,n", [(8, 12, 1, 48, 64, 40),
                                           (8, 1, 8, 304, 256, 296),
                                           (2, 1, 8, 64, 256, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tree_verify_attention_kernel_linear_extend(cuda, B, Kv, G, S, hd, n,
                                                    dtype):
    """A 4-token linear extend as the encdec and vlm families run it on the
    card: a causal (4, 4) block mask over ``n`` cached rows (whisper's and
    paligemma's heads, hd 64 and 256)."""
    N = 4
    q = _rand(0, (B, N, Kv, G, hd), cuda, dtype).permute(0, 2, 3, 1, 4)
    k = _cache_view(1, B, Kv, S, hd, cuda, dtype)
    v = _cache_view(2, B, Kv, S, hd, cuda, dtype)
    length = torch.full((B,), n, dtype=torch.int32, device=cuda)
    q_pos = (length[:, None] + torch.arange(N, device=cuda)) \
        .to(torch.int32).contiguous()
    mask = torch.ones((N, N), dtype=torch.bool, device=cuda).tril()
    out = tree_verify_attention_cuda(q, k, v, length, mask, q_pos)
    ref = tree_verify_attention_plain(q, k, v, length, mask, q_pos)
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("level", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tree_verify_attention_kernel_levels(cuda, level, dtype):
    """Rectangular (T, C) masks of the incremental draft levels: the tree
    starts at ``length - (C - T)``."""
    plan = _plan()
    lo, hi = plan.levels[level]
    T, C = hi - lo, hi
    B, Kv, G, S, hd = 8, 3, 3, 70, 64
    base = torch.arange(B, dtype=torch.int32, device=cuda) * 5 + 3
    q = _rand(3, (B, T, Kv, G, hd), cuda, dtype).permute(0, 2, 3, 1, 4)
    k = _cache_view(4, B, Kv, S, hd, cuda, dtype)
    v = _cache_view(5, B, Kv, S, hd, cuda, dtype)
    mask = torch.as_tensor(plan.mask[lo:hi, :hi], device=cuda).contiguous()
    q_pos = (base[:, None] + torch.as_tensor(plan.depths[lo:hi],
                                             device=cuda)).to(torch.int32)
    length = base + lo
    out = tree_verify_attention_cuda(q, k, v, length, mask, q_pos)
    ref = tree_verify_attention_plain(q, k, v, length, mask, q_pos)
    assert _err(out, ref) <= TOL[dtype]


def _tree_span_case(S, Kv, G, hd, lo, hi, base, dev, dtype):
    """Queries for nodes [lo, hi) of the 2-wide depth-4 plan over a cache
    of S positions whose tree starts at ``base`` (B,)."""
    plan = _plan()
    B, T = base.shape[0], hi - lo
    q = _rand(3, (B, T, Kv, G, hd), dev, dtype).permute(0, 2, 3, 1, 4)
    k = _cache_view(4, B, Kv, S, hd, dev, dtype)
    v = _cache_view(5, B, Kv, S, hd, dev, dtype)
    mask = torch.as_tensor(plan.mask[lo:hi, :hi], device=dev).contiguous()
    q_pos = (base[:, None] + torch.as_tensor(plan.depths[lo:hi], device=dev)
             ).to(torch.int32).contiguous()
    return q, k, v, (base + lo).to(torch.int32).contiguous(), mask, q_pos


def _spans():
    plan = _plan()
    return [(0, 1)] + list(plan.levels) + [(0, plan.n_pad)]


@pytest.mark.parametrize("span", range(6))
@pytest.mark.parametrize("S", [80, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 100])
def test_tree_verify_attention_kernel_spans(cuda, span, S, dtype, window):
    """Every draft-level span and the one-shot verify, granite-8b's heads
    (Kv 8, G 4, hd 128) over 8 slots, at the serving cache (S 80, tree base
    16-39) and a long one (S 1024, base 960-999), where the key range is
    split across blocks."""
    from repro_torch.kernels.tree_attention import KEYS, ROWS, split_plan
    lo, hi = _spans()[span]
    B, Kv, G, hd = 8, 8, 4, 128
    rng = np.random.default_rng(span)
    lo_base, hi_base = (16, 40) if S == 80 else (960, 1000)
    base = torch.as_tensor(rng.integers(lo_base, hi_base, B),
                           dtype=torch.int32, device=cuda)
    args = _tree_span_case(S, Kv, G, hd, lo, hi, base, cuda, dtype)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = split_plan(B * Kv * -(-G * (hi - lo) // ROWS), -(-S // KEYS),
                        n_sm)
    assert (splits > 1) == (S == 1024 and n_sm >= 128)
    out = tree_verify_attention_cuda(*args, window=window)
    ref = tree_verify_attention_plain(*args, window=window)
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("G,gamma,V", [(1, 1, 64), (3, 4, 1000),
                                       (8, 4, 49152), (8, 4, 32000),
                                       (3, 4, 49157), (2, 8, 4099),
                                       (2, 2, 257216)])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_spec_verify_kernel(cuda, G, gamma, V, temperature):
    """The serving shapes (V 49152, and 32000 on the hybrid path), ragged
    vocabularies (rows not 16-byte aligned, a last chunk shorter than the
    rest), gamma 8, and a vocabulary too large to stage in shared memory."""
    tl = _rand(0, (G, gamma + 1, V), cuda, scale=2.0)
    dl = tl[:, :gamma] + _rand(1, (G, gamma, V), cuda)
    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(0, V, (G, gamma)), dtype=torch.int32,
                           device=cuda)
    toks[:, :1] = tl[:, :1].argmax(-1)          # some accepted prefixes
    u_acc, u_res = (torch.as_tensor(rng.random((G, gamma + 1)),
                                    dtype=torch.float32, device=cuda)
                    for _ in range(2))
    args = (tl, dl.contiguous(), toks, u_acc, u_res)
    n_k, t_k = spec_verify_cuda(*args, temperature=temperature)
    n_p, t_p = spec_verify_plain(*args, temperature=temperature)
    if temperature == 0.0:
        assert torch.equal(n_k, n_p) and torch.equal(t_k, t_p)
    else:
        bad = (n_k != n_p) | (t_k != t_p)
        assert not bool((bad & ~_near_tie_groups(*args, temperature)).any())


def _near_tie_groups(tl, dl, toks, u_acc, u_res, temperature, tol=1e-6):
    """Per group: True where, recomputed in float64, a uniform lies within
    ``tol`` of an accept ratio or of a residual cdf entry — where float32
    rounding may legitimately decide either way."""
    G, gamma, V = dl.shape
    f = torch.float64
    ql = torch.cat([dl.to(f), torch.zeros((G, 1, V), dtype=f,
                                          device=dl.device)], 1)
    p = torch.softmax(tl.to(f) / temperature, -1)
    q = torch.softmax(ql / temperature, -1)
    tk = torch.cat([toks.long(), torch.zeros((G, 1), dtype=torch.long,
                                             device=dl.device)], 1)[..., None]
    ratio = (p.gather(2, tk) / q.gather(2, tk).clamp(min=1e-20))[..., 0] \
        .clamp(max=1.0)
    bonus = (torch.arange(gamma + 1, device=dl.device) == gamma)[None, :,
                                                                  None]
    r = (p - torch.where(bonus, 0.0, 1.0) * q).clamp(min=0.0)
    tot = r.sum(-1, keepdim=True)
    cdf = torch.where(tot > 0, r / tot.clamp(min=1e-300), p).cumsum(-1)
    near = ((cdf - u_res.to(f)[..., None]).abs() < tol).any(-1) \
        | ((ratio - u_acc.to(f)).abs() < tol)
    return near.any(-1)


def _greedy_prefix_case(gamma, V, dev, seed=0):
    """gamma + 1 groups of greedy drafts: group g's first g draft tokens
    are the target's argmax (its draft logits peaked there), the rest the
    draft's own argmax, which the target does not share; so at T = 0 group
    g accepts exactly g tokens."""
    G = gamma + 1
    tl = _rand(seed, (G, gamma + 1, V), dev, scale=3.0)
    dl = _rand(seed + 1, (G, gamma, V), dev, scale=3.0)
    toks = dl.argmax(-1).to(torch.int32)
    t_max = tl[:, :gamma].argmax(-1).to(torch.int32)
    toks = torch.where(toks == t_max, (toks + 1) % V, toks)
    for g in range(G):
        toks[g, :g] = t_max[g, :g]
        dl[g, torch.arange(gamma), toks[g].long()] = 100.0
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.random((2, G, gamma + 1)), dtype=torch.float32,
                        device=dev)
    return tl, dl.contiguous(), toks, u[0].contiguous(), u[1].contiguous()


@pytest.mark.parametrize("gamma,V", [(4, 49152), (8, 32000), (3, 4099)])
def test_spec_verify_kernel_every_prefix(cuda, gamma, V):
    """Every n_acc from 0 to gamma occurs, at T = 0 exactly as the plain
    version, the next token the target argmax of row n_acc."""
    args = _greedy_prefix_case(gamma, V, cuda)
    n_k, t_k = spec_verify_cuda(*args, temperature=0.0)
    n_p, t_p = spec_verify_plain(*args, temperature=0.0)
    assert n_k.tolist() == list(range(gamma + 1))
    assert torch.equal(n_k, n_p) and torch.equal(t_k, t_p)
    rows = args[0][torch.arange(gamma + 1), n_k.long()]
    assert torch.equal(t_k.long(), rows.argmax(-1))


@pytest.mark.parametrize("V", [49152, 32000, 4099])
def test_spec_verify_kernel_ties_across_chunks(cuda, V):
    """Exact ties at T = 0 on both sides of the kernel's chunk boundaries:
    the tie counts (which set p[tok] and q[tok]) and the first argmax must
    combine across the blocks of a row's cluster."""
    from repro_torch.kernels.spec_verify import spec_splits
    G, gamma = 8, 4
    R = gamma + 1
    nsplit, chunk = spec_splits(G * R, V, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert nsplit > 1
    tl = _rand(0, (G, R, V), cuda)
    dl = _rand(1, (G, gamma, V), cuda)
    edges = [c * chunk + d for c in range(1, nsplit) for d in (-1, 0)]
    edges = [e for e in edges if 0 <= e < V]
    for g in range(G):
        # group g ties at a rotating pair of boundary entries (and, for odd
        # groups, one more in the last chunk)
        tie = [edges[(g + j) % len(edges)] for j in range(2)]
        if g % 2:
            tie.append(V - 1)
        tl[g, :, tie] = 10.0
        dl[g, :, tie[: 1 + g % 3]] = 10.0
    toks = torch.full((G, gamma), -1, dtype=torch.int32, device=cuda)
    for g in range(G):
        toks[g] = edges[g % len(edges)]          # sometimes a tied entry
    u = torch.as_tensor(np.random.default_rng(0).random((2, G, R)),
                        dtype=torch.float32, device=cuda)
    args = (tl, dl, toks, u[0].contiguous(), u[1].contiguous())
    n_k, t_k = spec_verify_cuda(*args, temperature=0.0)
    n_p, t_p = spec_verify_plain(*args, temperature=0.0)
    assert torch.equal(n_k, n_p) and torch.equal(t_k, t_p)


def test_spec_verify_kernel_graph_replays(cuda):
    """Three calls captured in one CUDA graph, replayed three times on new
    inputs each: every replay equals the plain version (the per-group
    arrival counters are back at 0 after every launch), and an eager call
    afterwards too."""
    gamma, V = 4, 49152
    static = [tuple(t.clone() for t in _greedy_prefix_case(gamma, V, cuda,
                                                           seed=s))
              for s in range(3)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in static:
            spec_verify_cuda(*a, temperature=0.0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [spec_verify_cuda(*a, temperature=0.0) for a in static]
    for rep in range(3):
        for j, a in enumerate(static):
            new = _greedy_prefix_case(gamma, V, cuda, seed=10 * rep + j)
            for dst, src in zip(a, new):
                dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        for a, (n_k, t_k) in zip(static, outs):
            n_p, t_p = spec_verify_plain(*a, temperature=0.0)
            assert torch.equal(n_k, n_p) and torch.equal(t_k, t_p)
    n_k, t_k = spec_verify_cuda(*static[0], temperature=0.0)
    n_p, t_p = spec_verify_plain(*static[0], temperature=0.0)
    assert torch.equal(n_k, n_p) and torch.equal(t_k, t_p)


def test_dispatch_counts_launches(cuda):
    """ops dispatch runs the kernel on CUDA tensors and counts it."""
    ops.reset_launch_counts()
    q = _rand(0, (1, 2, 16, 64), cuda)
    ops.flash_attention(q, q, q)
    length = torch.ones((1,), dtype=torch.int32, device=cuda)
    ops.decode_attention(q[:, :, :1].contiguous(), q, q, length)
    ops.tree_verify_attention(q[:, :, None, :2], q, q, length,
                              torch.eye(2, dtype=torch.bool, device=cuda),
                              torch.ones((1, 2), dtype=torch.int32,
                                         device=cuda))
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["decode_attention"],
            counts["tree_verify_attention"]) == (1, 1, 1)


# (B, S, H, N, P, chunk): the serving paths' prompt prefills (mamba2-370m,
# xLSTM-125m's mLSTM, zamba2-2.7b), a front-padded three-chunk case, the
# JAX sweep's shapes, a verify extend of 8 slots, the long single prompts
# (mamba2 and xLSTM, S 2048), a front-padded long xLSTM prompt, and value
# widths of 3, 8 and 9 64-column P tiles (the first one's last tile ragged)
SSD_SHAPES = [(1, 15, 32, 128, 64, 256), (1, 15, 4, 384, 384, 128),
              (1, 15, 80, 64, 64, 128), (1, 600, 32, 128, 64, 256),
              (2, 256, 3, 32, 64, 64), (1, 512, 1, 64, 64, 128),
              (8, 5, 32, 128, 64, 256), (1, 2048, 32, 128, 64, 256),
              (1, 2048, 4, 384, 384, 128), (1, 2000, 4, 384, 384, 128),
              (2, 300, 2, 64, 160, 128), (1, 200, 2, 64, 512, 128),
              (1, 70, 1, 32, 576, 64)]


def _ssd_inputs(B, S, H, N, P, dev, dtype, carried, broadcast):
    q = _rand(0, (B, S, 1 if broadcast else H, N), dev, dtype)
    k = _rand(1, (B, S, 1 if broadcast else H, N), dev, dtype)
    q, k = q.expand(B, S, H, N), k.expand(B, S, H, N)
    v = _rand(2, (B, S, H, P), dev, dtype)
    la = -torch.nn.functional.softplus(_rand(3, (B, S, H), dev))
    li = _rand(4, (B, S, H), dev, scale=0.5)
    st = None
    if carried:
        st = (_rand(5, (B, H, N, P), dev), _rand(6, (B, H, N), dev),
              _rand(7, (B, H), dev))
    return q, k, v, la, li, st


@pytest.mark.parametrize("B,S,H,N,P,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("carried", [False, True])
def test_ssd_chunk_scan_kernel(cuda, B, S, H, N, P, chunk, dtype, carried):
    """Outputs and the final state against the plain version; q and k go
    in as head-broadcast views (mamba2's layout) when there are 32 heads
    or more."""
    q, k, v, la, li, st = _ssd_inputs(B, S, H, N, P, cuda, dtype, carried,
                                      H >= 32)
    out = ssd_chunk_scan_cuda(q, k, v, la, li, chunk=chunk, state=st)
    ref = ssd_chunk_scan_plain(q, k, v, la, li, chunk=chunk, state=st)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(out[:3] + out[3], ref[:3] + ref[3]):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)


def test_ssd_dispatch_counts_launches(cuda):
    ops.reset_launch_counts()
    q, k, v, la, li, _ = _ssd_inputs(1, 15, 4, 16, 32, cuda, torch.float32,
                                     False, False)
    ops.ssd_chunk_scan(q, k, v, la, li, chunk=8)
    assert ops.launch_counts()["ssd_chunk_scan"] == 1


# ------------------------------------------------------------ slice 7
# batch-1 dense decode of the per-request loops: smollm-135m and granite-8b
# heads over the caches of serve_reference (28 entries) and SpecDecoder (64)
@pytest.mark.parametrize("Kv,G,hd", [(3, 3, 64), (8, 4, 128)])
@pytest.mark.parametrize("S", [28, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 11])
def test_decode_attention_kernel_batch1(cuda, Kv, G, hd, S, dtype, window):
    for n in (1, 15, S - 1, S):
        q = _rand(n, (1, Kv, G, hd), cuda, dtype)
        k = _cache_view(1, 1, Kv, S, hd, cuda, dtype)
        v = _cache_view(2, 1, Kv, S, hd, cuda, dtype)
        length = torch.full((1,), n, dtype=torch.int32, device=cuda)
        out = decode_attention_cuda(q, k, v, length, window=window)
        ref = decode_attention_plain(q, k, v, length, window=window)
        assert _err(out, ref) <= TOL[dtype], n


def _token_tree_mask():
    """(mask, depths) of the 16-node TokenTree of branching (3, 2, 1), in
    the order build_tree appends the nodes."""
    from repro_torch.core.tree_speculation import TokenTree
    parent = [-1] + [0] * 3 + [1 + i // 2 for i in range(6)] + \
        [4 + i for i in range(6)]
    tree = TokenTree(np.zeros(16, np.int32), np.asarray(parent, np.int32),
                     np.zeros((16, 1), np.float32))
    return tree.attention_mask(), tree.depths()


@pytest.mark.parametrize("Kv,G,hd", [(8, 4, 128), (3, 3, 64)])
@pytest.mark.parametrize("base", [15, 40, 160])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 8])
def test_tree_verify_attention_kernel_token_tree_batch1(cuda, Kv, G, hd,
                                                        base, dtype, window):
    """TreeSpecDecoder's verify: one sequence, the (3, 2, 1) token tree
    (16 nodes, C == N) over a 176-entry cache, RoPE positions base + depth."""
    mask, depths = _token_tree_mask()
    S, N = 176, 16
    q = _rand(0, (1, N, Kv, G, hd), cuda, dtype).permute(0, 2, 3, 1, 4)
    k = _cache_view(1, 1, Kv, S, hd, cuda, dtype)
    v = _cache_view(2, 1, Kv, S, hd, cuda, dtype)
    length = torch.full((1,), base, dtype=torch.int32, device=cuda)
    q_pos = (base + torch.as_tensor(depths, device=cuda))[None] \
        .to(torch.int32).contiguous()
    mask = torch.as_tensor(mask, device=cuda)
    out = tree_verify_attention_cuda(q, k, v, length, mask, q_pos,
                                     window=window)
    ref = tree_verify_attention_plain(q, k, v, length, mask, q_pos,
                                      window=window)
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 11])
def test_paged_decode_kernel_moe_heads(cuda, dtype, window):
    """granite-moe-1b-a400m's heads (Kv 8, G 2, hd 64) on the serving
    pool: 8 slots, 32-token blocks, 3-block tables."""
    B, Kv, G, bs, MB, hd = 8, 8, 2, 32, 3, 64
    NB = B * MB + 1
    q = _rand(0, (B, Kv, G, hd), cuda, dtype)
    kp = _rand(1, (NB, bs, Kv, hd), cuda, dtype)
    vp = _rand(2, (NB, bs, Kv, hd), cuda, dtype)
    rng = np.random.default_rng(2)
    table = torch.as_tensor(rng.permutation(np.arange(1, NB)).reshape(B, MB),
                            dtype=torch.int32, device=cuda)
    length = torch.as_tensor(rng.integers(1, MB * bs + 1, B),
                             dtype=torch.int32, device=cuda)
    out = paged_decode_attention_cuda(q, kp, vp, table, length,
                                      window=window)
    ref = paged_decode_attention_plain(q, kp, vp, table, length,
                                       window=window)
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("tokens", [1, 8, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_block_cuda_matches_cpu(cuda, tokens, dtype):
    """One full-width granite-moe-1b-a400m layer's MoE block (32 experts,
    top 8) on the card against its run on the CPU: the same dispatch,
    library products on both devices (bf16: 2e-2, f32: 1e-5)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import ParamTree
    cfg = get_config("granite-moe-1b-a400m").replace(
        param_dtype=str(dtype)[6:], activ_dtype=str(dtype)[6:])
    gen = torch.Generator(device="cpu").manual_seed(0)
    p_cpu = ParamTree(MOE.init_moe(gen, cfg, dtype, "cpu"))
    p_gpu = ParamTree({k: getattr(p_cpu, k).to(cuda)
                       for k in ("router", "w_gate", "w_up", "w_down")})
    x = _rand(3, (1, tokens, cfg.d_model), "cpu", dtype)
    out_c, aux_c = MOE.moe_block(p_cpu, x, cfg)
    out_g, aux_g = MOE.moe_block(p_gpu, x.to(cuda), cfg)
    assert out_g.is_cuda and out_g.dtype == dtype
    assert _err(out_g.cpu(), out_c) <= TOL[dtype]
    assert abs(float(aux_g) - float(aux_c)) <= 1e-5


def test_serve_reference_on_cuda_matches_plain(cuda):
    """CollaborativeEngine.serve_reference at reduced f32 with seeded port
    weights on the card: the kernels (flash prefill, batch-1 dense decode)
    against attn_backend="plain", for the speculative, skeleton and cloud
    outcomes, plus TreeSpecDecoder (the batch-1 tree verify kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import CollaborativeEngine
    from repro_torch.core.policy import policy_from_legacy
    from repro_torch.core.tree_speculation import TreeSpecDecoder
    from repro_torch.models import Model
    e = get_config("smollm-135m").reduced()
    c = get_config("granite-8b").reduced().replace(vocab_size=e.vocab_size)
    edge, cloud = Model(e), Model(c)
    ep, cp = edge.init(seed=0), cloud.init(seed=1)
    prompts = [np.random.default_rng(i).integers(0, e.vocab_size, 12)
               for i in range(2)]
    runs = {}
    for backend in ("auto", "plain"):
        ops.reset_launch_counts()
        out = []
        for esc in ("speculative", "skeleton", "cloud"):
            eng = CollaborativeEngine(edge, cloud, gamma=3, temperature=0.0,
                                      skeleton_len=4, attn_backend=backend,
                                      policy=policy_from_legacy(esc, -1.0))
            out += [(tr.path, tr.tokens, tr.edge_calls, tr.cloud_passes)
                    for tr in (eng.serve_reference(ep, cp, p, 8)
                               for p in prompts)]
        out.append(TreeSpecDecoder(edge, cloud, branching=(3, 2, 1),
                                   temperature=0.0,
                                   attn_backend=backend).generate(
            ep, cp, prompts[0], 6))
        runs[backend] = out, ops.launch_counts()
    assert runs["auto"][0] == runs["plain"][0]
    launched = runs["auto"][1]
    for k in ("flash_attention", "decode_attention", "tree_verify_attention"):
        assert launched[k] > 0 and runs["plain"][1][k] == 0, k


# ------------------------------------------------------ flash backward
# Gradients are held against autograd through ``flash_attention_plain`` on
# the same inputs.  Tolerance on max |kernel - plain| / max(1, max |plain|):
# float32 1e-4 (sums over up to 2 * 100 key and query rows in another
# order), bfloat16 2e-2 (the forward rounds its output, and the gradients,
# once to bfloat16).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rel_err(a, b):
    return _err(a, b) / max(1.0, float(b.float().abs().max()))


def _attn_grads(fn, q, k, v, dout, **kw):
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v, **kw)
    out.backward(dout)
    return out.detach(), q.grad, k.grad, v.grad


def _bwd_inputs(B, H, Kv, Sq, Sk, hd, dev, dtype):
    q = _proj_view(0, B, Sq, H, hd, dev, dtype)
    k = _proj_view(1, B, Sk, Kv, hd, dev, dtype)
    v = _proj_view(2, B, Sk, Kv, hd, dev, dtype)
    dout = _proj_view(3, B, Sq, H, hd, dev, dtype)
    return q, k, v, dout


# (B, H, Kv, Sq, Sk, hd): smollm-135m heads at the training shape's tiles,
# granite-8b heads, zamba2's hd 80 with G 1, a one-kv-head GQA, hd 256, a
# ragged length, and a cross-length (Sq != Sk) full attention
BWD_SHAPES = [(2, 9, 3, 64, 64, 64), (1, 32, 8, 40, 40, 128),
              (1, 4, 4, 33, 33, 80), (2, 4, 1, 100, 100, 32),
              (1, 2, 2, 70, 70, 256), (2, 6, 3, 97, 97, 64)]


@pytest.mark.parametrize("B,H,Kv,Sq,Sk,hd", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 17),
                                           (False, 0), (False, 9)])
def test_flash_attention_backward_kernel(cuda, B, H, Kv, Sq, Sk, hd, dtype,
                                         causal, window):
    """ops.flash_attention under grad: the forward kernel with its LSE and
    the backward kernel, on strided (B, S, heads, hd) views; dq, dk and dv
    come laid out like q, k and v and match the plain autograd."""
    from repro_torch.kernels.flash_attention import BWD_KERNEL
    q, k, v, dout = _bwd_inputs(B, H, Kv, Sq, Sk, hd, cuda, dtype)
    n0 = BWD_KERNEL.launches
    got = _attn_grads(ops.flash_attention, q, k, v, dout, causal=causal,
                      window=window)
    ref = _attn_grads(flash_attention_plain, q, k, v, dout, causal=causal,
                      window=window)
    assert BWD_KERNEL.launches == n0 + 1
    assert _err(got[0], ref[0]) <= TOL[dtype]
    for g, r, x in zip(got[1:], ref[1:], (q, k, v)):
        assert g.stride() == x.stride() and g.dtype == dtype
        assert _rel_err(g, r) <= BWD_TOL[dtype]


# (B, H, Kv, Sq, Sk, hd) of the wgmma route's walks: packed rows that
# straddle 64-row tiles and the causal and window bands — the training
# shape (G 3), granite-8b heads over a ragged S (G 4), one kv head of G 8,
# zamba2's hd 80 with G 1 —, Sq != Sk both ways, and hd 100, whose rows
# take the element copies (no 16-byte alignment)
BWD_WALK_SHAPES = [(8, 9, 3, 256, 256, 64), (2, 32, 8, 130, 130, 128),
                   (1, 8, 1, 75, 75, 64), (1, 4, 4, 150, 150, 80),
                   (1, 12, 4, 40, 72, 64), (1, 12, 4, 100, 72, 64),
                   (1, 4, 2, 70, 70, 100)]


@pytest.mark.parametrize("B,H,Kv,Sq,Sk,hd", BWD_WALK_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0), (False, 33)])
def test_flash_attention_backward_packed_tiles(cuda, B, H, Kv, Sq, Sk, hd,
                                               dtype, causal, window):
    """As test_flash_attention_backward_kernel, on the walks whose packed
    query tiles straddle positions and masks (every row sees a key)."""
    q, k, v, dout = _bwd_inputs(B, H, Kv, Sq, Sk, hd, cuda, dtype)
    got = _attn_grads(ops.flash_attention, q, k, v, dout, causal=causal,
                      window=window)
    ref = _attn_grads(flash_attention_plain, q, k, v, dout, causal=causal,
                      window=window)
    for g, r, x in zip(got[1:], ref[1:], (q, k, v)):
        assert g.stride() == x.stride() and g.dtype == dtype
        assert _rel_err(g, r) <= BWD_TOL[dtype]


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 80, "wgmma"),
    (torch.bfloat16, 128, "wgmma"), (torch.float32, 64, "cuda_cores"),
    (torch.float32, 128, "cuda_cores"), (torch.bfloat16, 256, "cuda_cores")])
def test_flash_attention_backward_route(cuda, dtype, hd, route):
    """bfloat16 with hd <= 128 launches the wgmma route, float32 and
    bfloat16 hd 256 the CUDA-core route: one launch, counted per route in
    ``ops.launch_counts()``."""
    q, k, v, dout = _bwd_inputs(1, 4, 2, 48, 48, hd, cuda, dtype)
    ops.reset_launch_counts()
    got = _attn_grads(ops.flash_attention, q, k, v, dout)
    ref = _attn_grads(flash_attention_plain, q, k, v, dout)
    counts = ops.launch_counts()
    other = {"wgmma": "cuda_cores", "cuda_cores": "wgmma"}[route]
    assert counts["flash_attention_bwd"] == 1
    assert counts[f"flash_attention_bwd/{route}"] == 1
    assert counts[f"flash_attention_bwd/{other}"] == 0
    for g, r in zip(got[1:], ref[1:]):
        assert _rel_err(g, r) <= BWD_TOL[dtype]


def test_flash_attention_backward_cross_length(cuda):
    """Sq != Sk, full attention (the kernels' ragged edges on both axes)."""
    q, k, v, dout = _bwd_inputs(1, 4, 2, 40, 72, 64, cuda, torch.float32)
    got = _attn_grads(ops.flash_attention, q, k, v, dout, causal=False)
    ref = _attn_grads(flash_attention_plain, q, k, v, dout, causal=False)
    for g, r in zip(got, ref):
        assert _rel_err(g, r) <= BWD_TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_is_deterministic(cuda, dtype):
    q, k, v, dout = _bwd_inputs(2, 9, 3, 256, 256, 64, cuda, dtype)
    a = _attn_grads(ops.flash_attention, q, k, v, dout)
    b = _attn_grads(ops.flash_attention, q, k, v, dout)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_attention_backward_expanded_dout(cuda):
    """A gradient that is an expanded scalar (out.sum()) reaches the
    kernel made contiguous."""
    q, k, v, _ = _bwd_inputs(1, 4, 2, 48, 48, 64, cuda, torch.float32)
    grads = []
    for fn in (ops.flash_attention, flash_attention_plain):
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        (fn(qq, kk, vv, causal=True) * 1.0).sum().backward()
        grads.append((qq.grad, kk.grad, vv.grad))
    for g, r in zip(*grads):
        assert _rel_err(g, r) <= BWD_TOL[torch.float32]


def test_flash_attention_backward_under_checkpoint(cuda):
    """torch.utils.checkpoint (use_reentrant=False) through the autograd
    Function recomputes the forward kernel and gives the same gradients."""
    from torch.utils.checkpoint import checkpoint
    q, k, v, dout = _bwd_inputs(2, 9, 3, 64, 64, 64, cuda, torch.bfloat16)
    w = _rand(4, (64, 64), cuda, torch.bfloat16, 0.1)

    def f(q, k, v):
        return ops.flash_attention(q @ w, k, v, causal=True)

    grads = []
    for remat in (False, True):
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = checkpoint(f, qq, kk, vv, use_reentrant=False) if remat \
            else f(qq, kk, vv)
        out.backward(dout)
        grads.append((qq.grad, kk.grad, vv.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 21),
                                           (False, 0)])
@pytest.mark.parametrize("H,Kv,S,hd", [(9, 3, 200, 64), (32, 8, 16, 128),
                                       (32, 32, 15, 80)])
def test_flash_attention_lse(cuda, dtype, causal, window, H, Kv, S, hd):
    """Both forward paths (float32 CUDA cores, bfloat16 wgmma tile with
    rows packed over the G heads) write each row's log-sum-exp of its
    scaled scores: logsumexp of the plain scores in float32 (atol 1e-5
    float32, 1e-3 bfloat16: the tile's exp2 is the 2-ulp approximation);
    the output equals the launch without LSE bit for bit."""
    B = 2
    q = _proj_view(0, B, S, H, hd, cuda, dtype)
    k = _proj_view(1, B, S, Kv, hd, cuda, dtype)
    v = _proj_view(2, B, S, Kv, hd, cuda, dtype)
    with torch.no_grad():
        out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                        return_lse=True)
        out0 = flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert torch.equal(out, out0)
    kk = k.float().repeat_interleave(H // Kv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / hd ** 0.5
    i = torch.arange(S, device=cuda)[:, None]
    j = torch.arange(S, device=cuda)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=cuda)
    if causal:
        mask = j <= i
    if window:
        mask = mask & (j > i - window)
    ref = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    assert _err(lse, ref) <= tol * max(1.0, float(ref.abs().max()))


def test_kernels_without_backward_raise_under_grad(cuda):
    """Every ctypes kernel without a backward raises under grad instead of
    silently detaching the gradient; under no_grad, and on tensors that do
    not require grad, it runs."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_cuda
    q = _rand(0, (1, 2, 1, 64), cuda).requires_grad_(True)
    kc = _rand(1, (1, 2, 8, 64), cuda)
    length = torch.full((1,), 8, dtype=torch.int32, device=cuda)
    pool = _rand(2, (2, 8, 2, 64), cuda)
    table = torch.ones((1, 1), dtype=torch.int32, device=cuda)
    qt = _rand(3, (1, 2, 1, 2, 64), cuda).requires_grad_(True)
    tl = _rand(4, (1, 3, 64), cuda).requires_grad_(True)
    dl = _rand(5, (1, 2, 64), cuda)
    toks = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    u = torch.full((1, 3), 0.5, device=cuda)
    sq = _rand(6, (1, 16, 2, 64), cuda).requires_grad_(True)
    sv = _rand(7, (1, 16, 2, 64), cuda)
    la = -torch.rand((1, 16, 2), device=cuda)
    calls = {
        "decode_attention_cuda": lambda: decode_attention_cuda(
            q, kc, kc, length),
        "paged_decode_attention_cuda": lambda: paged_decode_attention_cuda(
            q, pool, pool, table, length),
        "tree_verify_attention_cuda": lambda: tree_verify_attention_cuda(
            qt, kc, kc, length, torch.eye(2, dtype=torch.bool, device=cuda),
            torch.full((1, 2), 7, dtype=torch.int32, device=cuda)),
        "spec_verify_cuda": lambda: spec_verify_cuda(tl, dl, toks, u, u),
        "ssd_chunk_scan_cuda": lambda: ssd_chunk_scan_cuda(
            sq, sq, sv, la, torch.zeros_like(la), chunk=8),
        "flash_attention_cuda": lambda: flash_attention_cuda(q, kc, kc),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


@pytest.mark.parametrize("remat", [False, True])
def test_model_loss_trains_through_the_flash_kernels(cuda, remat):
    """Model.loss under grad on the card: every layer's attention runs the
    flash kernel forward and backward (never ``mha``), and the loss and
    gradients match ``attn_backend="plain"`` (autograd through ``mha``) at
    float32 (loss 1e-5, gradients 1e-4 of max(1, max |plain|))."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import example_batch
    from repro_torch.training import tree as T
    cfg = get_config("smollm-135m").replace(num_layers=2, vocab_size=512,
                                            param_dtype="float32",
                                            activ_dtype="float32")
    m = Model(cfg)
    p = m.init(seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = example_batch(cfg, 4, 48, gen, device="cuda")
    res = {}
    for backend in ("auto", "plain"):
        tp = T.replace(p, [t.detach().requires_grad_(True)
                           for t in T.tensors(p)])
        ops.reset_launch_counts()
        loss = m.loss(tp, batch, remat=remat and backend == "auto",
                      attn_backend=backend)
        grads = torch.autograd.grad(loss, T.tensors(tp))
        res[backend] = (loss.detach(), grads, ops.launch_counts())
    (lk, gk, ck), (lp, gp, cp) = res["auto"], res["plain"]
    L = cfg.num_layers
    assert ck["flash_attention"] == (2 * L if remat else L)
    assert ck["flash_attention_bwd"] == L
    assert cp["flash_attention"] == cp["flash_attention_bwd"] == 0
    assert abs(float(lk) - float(lp)) <= 1e-5 * float(lp)
    for a, b in zip(gk, gp):
        assert _rel_err(a, b) <= 1e-4


def test_adaptation_swaps_on_the_card(cuda):
    """A distill AdaptationLoop on the card (reduced pair, bfloat16): the
    update trains through the flash backward and swaps in a tree with the
    serving params' names, shapes, dtypes and device."""
    from repro_torch.configs import get_config
    from repro_torch.core.adaptation import AdaptationLoop
    from repro_torch.core.policy import ThresholdPolicy
    from repro_torch.core.scheduler import BatchedEngine
    from repro_torch.models import Model
    from repro_torch.training import tree as T
    e = get_config("smollm-135m").reduced().replace(param_dtype="bfloat16",
                                                    activ_dtype="bfloat16")
    c = get_config("granite-8b").reduced().replace(
        vocab_size=e.vocab_size, param_dtype="bfloat16",
        activ_dtype="bfloat16")
    em, cm = Model(e), Model(c)
    ep, cp = em.init(seed=0, device="cuda"), cm.init(seed=1, device="cuda")
    loop = AdaptationLoop(mode="distill", interval=4, batch_size=4,
                          seq_len=16, topk=4)
    eng = BatchedEngine(em, cm, batch_size=4, temperature=0.0,
                        policy=ThresholdPolicy(0.0), use_cache=False,
                        adaptation=loop)
    prompts = [np.arange(8, dtype=np.int32) * (i + 1) % e.vocab_size
               for i in range(4)]
    ops.reset_launch_counts()
    for _ in range(2):
        eng.serve_batch(ep, cp, prompts, 5)
    torch.cuda.synchronize()
    assert loop.swaps == 1 and ops.launch_counts()["flash_attention_bwd"] > 0
    assert np.isfinite(loop.stats()["last_loss"])
    for (n, a), (m_, b) in zip(T.leaves(loop.latest), T.leaves(ep)):
        assert n == m_ and (a.shape, a.dtype, a.device) == \
            (b.shape, b.dtype, b.device)


# ------------------------------------------------------------ slice 10
# the SSD-scan backward (csrc/ssd_scan_bwd.cu) against autograd of the plain
# scan, through each caller's form of the outputs: mamba2's y * exp(m),
# mLSTM's y / max(|den|, exp(-m)).  (B, S, H, N, P, chunk, q/k head-
# broadcast, form): the training shapes of mamba2-370m, xlstm-125m and
# zamba2-2.7b (batch 8, seq 256), front-padded ragged lengths (one with a
# partial 64-column P tile), and the 2048-token prompts.  Tolerance on each
# of dq, dk, dv, dlog_a, dlog_i: max |kernel - plain| <= SSD_BWD_TOL x
# max(1, max |plain|) (float32: sums in another order; bfloat16: the
# forward's split-bf16 products and the bf16 gradients' rounding)
SSD_BWD_SHAPES = [(8, 256, 32, 128, 64, 256, True, "mamba"),
                  (8, 256, 4, 384, 384, 128, False, "mlstm"),
                  (8, 256, 80, 64, 64, 128, True, "mamba"),
                  (2, 300, 4, 64, 96, 128, False, "mlstm"),
                  (2, 77, 3, 16, 64, 32, True, "mamba"),
                  (3, 40, 2, 32, 64, 64, False, "mlstm"),
                  (1, 2048, 32, 128, 64, 256, True, "mamba"),
                  (1, 2048, 4, 384, 384, 128, False, "mlstm")]
SSD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _ssd_bwd_case(B, S, H, N, P, bc, dev, dtype, seed=0):
    """Leaves (q, k as (B, S, 1 or H, N), v, log_a, log_i) and the weights
    R of the scalar loss sum(R * form(y, den, m))."""
    hq = 1 if bc else H
    leaves = (_rand(seed, (B, S, hq, N), dev, dtype),
              _rand(seed + 1, (B, S, hq, N), dev, dtype),
              _rand(seed + 2, (B, S, H, P), dev, dtype),
              -torch.nn.functional.softplus(_rand(seed + 3, (B, S, H), dev)),
              _rand(seed + 4, (B, S, H), dev, scale=0.5))
    return leaves, _rand(seed + 5, (B, S, H, P), dev)


def _ssd_form(y, den, m, form):
    if form == "mamba":
        return y * torch.exp(m)[..., None]
    return y / torch.maximum(den.abs(), torch.exp(-m))[..., None]


def _ssd_grads(fn, leaves, R, chunk, form):
    q, k, v, la, li = (t.detach().requires_grad_(True) for t in leaves)
    B, S, H, _ = v.shape
    N = q.shape[-1]
    y, den, m, _ = fn(q.expand(B, S, H, N), k.expand(B, S, H, N), v, la, li,
                      chunk=chunk)
    loss = (R * _ssd_form(y, den, m, form)).sum()
    return torch.autograd.grad(loss, (q, k, v, la, li))


@pytest.mark.parametrize("B,S,H,N,P,chunk,bc,form", SSD_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_scan_bwd_matches_plain_autograd(cuda, B, S, H, N, P,
                                                   chunk, bc, form, dtype):
    leaves, R = _ssd_bwd_case(B, S, H, N, P, bc, cuda, dtype)
    got = _ssd_grads(ops.ssd_chunk_scan, leaves, R, chunk, form)
    ref = _ssd_grads(ssd_chunk_scan_plain, leaves, R, chunk, form)
    for name, a, b in zip(("q", "k", "v", "log_a", "log_i"), got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= SSD_BWD_TOL[dtype], name


@pytest.mark.parametrize("B,S,H,N,P,chunk,bc,form", SSD_BWD_SHAPES[1:5])
def test_ssd_chunk_scan_bwd_is_deterministic(cuda, B, S, H, N, P, chunk, bc,
                                             form):
    """Two runs give the same bits: every sum over P tiles is taken in a
    fixed order, with no float atomics."""
    leaves, R = _ssd_bwd_case(B, S, H, N, P, bc, cuda, torch.bfloat16)
    a = _ssd_grads(ops.ssd_chunk_scan, leaves, R, chunk, form)
    b = _ssd_grads(ops.ssd_chunk_scan, leaves, R, chunk, form)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_ssd_forward_saves_the_chunk_states(cuda):
    """The training forward (states saved for the backward) gives the
    serving forward's outputs bit for bit, and its saved carried-in states
    are the plain scan's."""
    from repro_torch.kernels.ssd_scan import _forward
    B, S, H, N, P, chunk = 2, 300, 3, 32, 96, 64
    q, k, v, la, li, st = _ssd_inputs(B, S, H, N, P, cuda, torch.float32,
                                      True, False)
    y, den, m, fin, saved = _forward(q, k, v, la, li, chunk, st, save=True)
    out = ssd_chunk_scan_cuda(q, k, v, la, li, chunk=chunk, state=st)
    for a, b in zip((y, den, m) + fin, out[:3] + out[3]):
        assert torch.equal(a, b)
    ref = ssd_chunk_scan_plain(q, k, v, la, li, chunk=chunk, state=st,
                               chunk_states=True)[4]
    Sc, nc, Mc = saved
    for a, b in ((Sc.permute(0, 2, 1, 4, 3), ref[0]),
                 (nc.transpose(1, 2), ref[1]), (Mc.transpose(1, 2), ref[2])):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_ssd_bwd_counts_launches_and_never_runs_plain(cuda):
    """Under grad on the card the scan launches the forward and backward
    kernels once each per call; a carried-in state that requires grad
    raises."""
    leaves, R = _ssd_bwd_case(2, 40, 2, 16, 64, False, cuda, torch.float32)
    ops.reset_launch_counts()
    _ssd_grads(ops.ssd_chunk_scan, leaves, R, 16, "mlstm")
    c = ops.launch_counts()
    assert c["ssd_chunk_scan"] == 1 and c["ssd_chunk_scan_bwd"] == 1
    q, k, v, la, li = (t.requires_grad_(True) for t in leaves)
    st = (torch.zeros((2, 2, 16, 64), device=cuda, requires_grad=True),
          torch.zeros((2, 2, 16), device=cuda),
          torch.full((2, 2), -1e30, device=cuda))
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.ssd_chunk_scan(q, k, v, la, li, chunk=16, state=st)


@pytest.mark.parametrize("B,S,H,N,P,chunk,bc,form", SSD_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_runs_the_planned_route(cuda, B, S, H, N, P, chunk, bc,
                                        form, dtype):
    """Each backward launch takes ``ssd_bwd_plan``'s route: the tensor
    cores (``mma``) for bf16 at every shape here, the CUDA cores for
    float32; the route counter and the kernel's own counter agree."""
    from repro_torch.kernels.ssd_scan import ssd_bwd_plan
    want = "mma" if dtype == torch.bfloat16 else "cuda_cores"
    assert ssd_bwd_plan(dtype, N, P, min(chunk, S)).route == want
    leaves, R = _ssd_bwd_case(B, S, H, N, P, bc, cuda, dtype)
    ops.reset_launch_counts()
    _ssd_grads(ops.ssd_chunk_scan, leaves, R, chunk, form)
    c = ops.launch_counts()
    assert c["ssd_chunk_scan_bwd"] == c[f"ssd_chunk_scan_bwd/{want}"] == 1
    assert sum(c[f"ssd_chunk_scan_bwd/{r}"] for r in ("mma", "cuda_cores")) \
        == 1


# bf16 shapes whose plan is not the trainers': a chunk too long for the
# 64-row tiling (N 128, Q 512: 32-row tiles, one stage) and one too long
# for either (Q 1024: the CUDA cores, 32-row tiles; a state wider than 384,
# the other way past the tilings, is one the forward does not take in
# bf16), with the (route, rows) the plan must give; same tolerance as
# SSD_BWD_SHAPES
SSD_BWD_OTHER_ROUTES = [((2, 600, 2, 128, 64, 512, True, "mamba"),
                         ("mma", 32)),
                        ((1, 1100, 2, 128, 64, 1024, True, "mamba"),
                         ("cuda_cores", 32))]


@pytest.mark.parametrize("shape,route", SSD_BWD_OTHER_ROUTES)
def test_ssd_bwd_other_routes_match_plain_autograd(cuda, shape, route):
    """Every route the plan can give bf16 runs on the card and meets the
    tolerance: the two the trainers take are above, these the others."""
    from repro_torch.kernels.ssd_scan import ssd_bwd_plan
    B, S, H, N, P, chunk, bc, form = shape
    plan = ssd_bwd_plan(torch.bfloat16, N, P, min(chunk, S))
    assert (plan.route, plan.rows) == route
    leaves, R = _ssd_bwd_case(B, S, H, N, P, bc, cuda, torch.bfloat16)
    ops.reset_launch_counts()
    got = _ssd_grads(ops.ssd_chunk_scan, leaves, R, chunk, form)
    c = ops.launch_counts()
    assert c["ssd_chunk_scan_bwd"] == c[f"ssd_chunk_scan_bwd/{route[0]}"] \
        == 1
    ref = _ssd_grads(ssd_chunk_scan_plain, leaves, R, chunk, form)
    for name, a, b in zip(("q", "k", "v", "log_a", "log_i"), got, ref):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= SSD_BWD_TOL[torch.bfloat16], name


def test_ssd_bwd_plan_smem_is_the_launchers(cuda):
    """``ssd_bwd_plan``'s host copy of the shared-memory layouts gives the
    bytes the C launcher computes, for every tiling of each route over the
    state widths and chunk lengths the kernels take."""
    from repro_torch.kernels import ssd_scan as K
    smem = K.BWD_SMEM.load()
    for N in (16, 64, 96, 128, 256, 384, 448):
        for Q in (32, 64, 128, 256, 512):
            for rows, stages, _ in K.MMA_TILINGS:
                assert K._mma_smem(N, Q, rows, stages) == smem(
                    2 if rows == 64 else 3, rows, N, Q), (N, Q, rows)
            for rows in (32, 16):
                assert K._cuda_cores_smem(N, Q, rows) == smem(0, rows, N, Q)


# every family trains on the kernels: Model.loss and its gradients against
# attn_backend="plain" at float32 (reduced widths, 2 layers, a ragged 44
# tokens over chunks of 8: loss 1e-5, gradients 1e-4 of max(1, max
# |plain|)), remat the same bits as no remat, and the launches: the scan
# forward and backward once per scan layer (the forward twice with remat),
# the flash backward once per attention layer
TRAIN_FAMILIES = {"moe": "granite-moe-1b-a400m", "ssm": "mamba2-370m",
                  "xlstm": "xlstm-125m", "hybrid": "zamba2-2.7b"}


@pytest.mark.parametrize("family", list(TRAIN_FAMILIES))
def test_model_loss_trains_on_the_kernels(cuda, family):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import example_batch
    from repro_torch.models.xlstm import is_slstm
    from repro_torch.training import tree as T
    cfg = get_config(TRAIN_FAMILIES[family]).reduced().replace(
        param_dtype="float32", activ_dtype="float32")
    L = cfg.num_layers
    n_scan = {"moe": 0, "ssm": L, "hybrid": L,
              "xlstm": sum(not is_slstm(cfg, l) for l in range(L))}[family]
    n_attn = {"moe": L, "ssm": 0, "xlstm": 0,
              "hybrid": L // max(1, cfg.shared_attn_every)}[family]
    m = Model(cfg)
    p = m.init(seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = example_batch(cfg, 4, 44, gen, device="cuda")
    res = {}
    for backend, remat in (("auto", False), ("auto", True),
                           ("plain", False)):
        tp = T.replace(p, [t.detach().requires_grad_(True)
                           for t in T.tensors(p)])
        ops.reset_launch_counts()
        loss = m.loss(tp, batch, remat=remat, attn_backend=backend)
        grads = torch.autograd.grad(loss, T.tensors(tp))
        res[backend, remat] = (loss.detach(), grads, ops.launch_counts())
    (lk, gk, ck), (lr, gr, cr), (lp, gp, cp) = (
        res["auto", False], res["auto", True], res["plain", False])
    assert ck["ssd_chunk_scan"] == ck["ssd_chunk_scan_bwd"] == n_scan
    assert cr["ssd_chunk_scan"] == 2 * n_scan
    assert cr["ssd_chunk_scan_bwd"] == n_scan
    assert ck["flash_attention_bwd"] == cr["flash_attention_bwd"] == n_attn
    assert all(n == 0 for n in cp.values())
    assert abs(float(lk) - float(lp)) <= 1e-5 * float(lp)
    for a, b in zip(gk, gp):
        assert _rel_err(a, b) <= 1e-4
    assert torch.equal(lk, lr)
    for a, b in zip(gk, gr):
        assert torch.equal(a, b)


# ------------------------------------------- prefix-LM, cross attention
# The vlm family's prefix-LM mask (``prefix_len``: the first keys visible to
# every query under causal) and the encdec family's non-causal reads —
# the whisper encoder over 1500 frames and the decoder's cross attention,
# Sq != Sk — in both flash kernels, against the plain versions.  (B, H,
# Kv, S, hd, prefix, window): paligemma's heads (G 8 on one kv head, hd
# 256: the CUDA-core backward) over 256 image rows + 16 text rows,
# prefixes that end inside a tile with packed rows straddling it (G 3),
# past S, and under a window
PREFIX_SHAPES = [(1, 8, 1, 272, 256, 256, 0), (2, 9, 3, 100, 64, 37, 0),
                 (1, 4, 4, 150, 80, 64, 40), (2, 4, 2, 70, 128, 100, 0),
                 (1, 8, 1, 90, 64, 1, 0)]


@pytest.mark.parametrize("B,H,Kv,S,hd,prefix,window", PREFIX_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_prefix(cuda, B, H, Kv, S, hd, prefix, window,
                                dtype):
    """Forward (with and without the LSE) and backward with a prefix."""
    q, k, v, dout = _bwd_inputs(B, H, Kv, S, S, hd, cuda, dtype)
    kw = dict(causal=True, window=window, prefix_len=prefix)
    out = flash_attention_cuda(q, k, v, **kw)
    assert _err(out, flash_attention_plain(q, k, v, **kw)) <= TOL[dtype]
    got = _attn_grads(ops.flash_attention, q, k, v, dout, **kw)
    ref = _attn_grads(flash_attention_plain, q, k, v, dout, **kw)
    assert torch.equal(got[0], out)
    for g, r in zip(got[1:], ref[1:]):
        assert _rel_err(g, r) <= BWD_TOL[dtype]


def test_flash_attention_prefix_counts_only_under_causal(cuda):
    q, k, v, _ = _bwd_inputs(1, 4, 2, 64, 64, 64, cuda, torch.bfloat16)
    assert torch.equal(flash_attention_cuda(q, k, v, causal=False,
                                            prefix_len=20),
                       flash_attention_cuda(q, k, v, causal=False))
    with pytest.raises(ValueError, match="prefix_len"):
        flash_attention_cuda(q, k, v, prefix_len=-1)


# (B, H, Kv, Sq, Sk, hd): whisper-small's encoder (12 heads of 64 over 1500
# frames, no tile divides it) and its cross attention, 16 and 256 decoder
# rows against the 1500 encoder rows
CROSS_SHAPES = [(1, 12, 12, 1500, 1500, 64), (2, 12, 12, 16, 1500, 64),
                (1, 12, 12, 256, 1500, 64)]


@pytest.mark.parametrize("B,H,Kv,Sq,Sk,hd", CROSS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_whisper_shapes(cuda, B, H, Kv, Sq, Sk, hd, dtype):
    q, k, v, dout = _bwd_inputs(B, H, Kv, Sq, Sk, hd, cuda, dtype)
    got = _attn_grads(ops.flash_attention, q, k, v, dout, causal=False)
    ref = _attn_grads(flash_attention_plain, q, k, v, dout, causal=False)
    assert _err(got[0], ref[0]) <= TOL[dtype]
    for g, r in zip(got[1:], ref[1:]):
        assert _rel_err(g, r) <= BWD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_at_the_new_families_shapes(cuda, dtype):
    """Dense decode at paligemma's heads (Kv 1, G 8, hd 256) over ~300
    positions and as whisper's cross attention (Kv 12, G 1, hd 64, every
    row's length the 1500 encoder rows); paged decode at paligemma's
    heads."""
    for B, Kv, G, S, hd, lo, hi in ((8, 1, 8, 320, 256, 272, 301),
                                    (8, 12, 1, 1500, 64, 1500, 1501)):
        q = _rand(0, (B, Kv, G, hd), cuda, dtype)
        k, v = (_rand(i, (B, S, Kv, hd), cuda, dtype).permute(0, 2, 1, 3)
                for i in (1, 2))
        length = torch.randint(lo, hi, (B,), device=cuda, dtype=torch.int32)
        out = decode_attention_cuda(q, k, v, length)
        assert _err(out, decode_attention_plain(q, k, v, length)) \
            <= TOL[dtype]
    B, Kv, G, hd, bs, MB = 8, 1, 8, 256, 32, 10
    q = _rand(3, (B, Kv, G, hd), cuda, dtype)
    kp, vp = (_rand(i, (B * MB + 1, bs, Kv, hd), cuda, dtype)
              for i in (4, 5))
    table = (torch.randperm(B * MB, device=cuda) + 1).reshape(B, MB) \
        .to(torch.int32)
    length = torch.randint(272, 301, (B,), device=cuda, dtype=torch.int32)
    out = paged_decode_attention_cuda(q, kp, vp, table, length)
    ref = paged_decode_attention_plain(q, kp, vp, table, length)
    assert _err(out, ref) <= TOL[dtype]


NEW_FAMILIES = {"vlm": "paligemma-3b", "encdec": "whisper-small"}


def _f32_reduced(arch):
    from repro_torch.configs import get_config
    return get_config(arch).reduced().replace(param_dtype="float32",
                                              activ_dtype="float32")


@pytest.mark.parametrize("family", list(NEW_FAMILIES))
def test_new_families_greedy_traces_kernel_vs_plain(cuda, family):
    """Reduced float32 models on the card: prefill, 10 greedy decode steps
    and a 4-token extend give the same tokens and logits within 1e-4 on
    the kernels and on the plain versions; the kernel run launches the
    flash kernel (prefill and, for encdec, the extend's cross attention),
    the dense decode kernel (every decode read, self and cross) and the
    tree-verify kernel (the extend's self attention, under a causal block
    mask), the plain run none."""
    from repro_torch.models import Model
    from repro_torch.models.model import example_batch
    cfg = _f32_reduced(NEW_FAMILIES[family])
    m = Model(cfg)
    p = m.init(seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = example_batch(cfg, 2, 12, gen, with_labels=False, device="cuda")
    runs = {}
    for backend in ("auto", "plain"):
        ops.reset_launch_counts()
        lg, cache = m.prefill(p, batch, max_seq=32, attn_backend=backend)
        toks, logits = [], [lg]
        for _ in range(10):
            tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
            toks.append(tok)
            lg, cache = m.decode_step(p, tok, cache, attn_backend=backend)
            logits.append(lg)
        ext, cache = m.extend_step(p, torch.cat(toks[-4:], 1), cache,
                                   attn_backend=backend)
        runs[backend] = (torch.cat(toks, 1), logits + [ext],
                         ops.launch_counts())
    (tk, lk, ck), (tp, lp, cp) = runs["auto"], runs["plain"]
    assert torch.equal(tk, tp)
    for a, b in zip(lk, lp):
        assert _err(a, b) <= 1e-4
    L = cfg.num_layers
    enc = cfg.encoder_layers if family == "encdec" else 0
    assert ck["flash_attention"] == L + enc + (2 * L if enc else 0)
    assert ck["decode_attention"] == 10 * L * (2 if enc else 1)
    assert ck["tree_verify_attention"] == L
    assert all(n == 0 for n in cp.values())


@pytest.mark.parametrize("window", [0, 6])
def test_vlm_paged_extend_kernel_vs_plain(cuda, window):
    """The vlm paged extend at float32 (reduced): the paged-decode kernel,
    one row per new token, against the table's gather through ``mha`` —
    logits and pools within 1e-4 (a layer's K/V is projected from the
    layers before it), one launch per layer."""
    from repro_torch.models import Model
    cfg = _f32_reduced(NEW_FAMILIES["vlm"]).replace(sliding_window=window)
    m = Model(cfg)
    p = m.init(seed=0, device="cuda")
    B, bs, MB, T = 3, 8, 4, 5
    gen = torch.Generator(device="cuda").manual_seed(0)
    base = m.init_paged_cache(B * MB + 1, bs, B, MB, device="cuda")
    base["k"].normal_(generator=gen)
    base["v"].normal_(generator=gen)
    base["table"] = torch.randperm(B * MB, generator=gen, device="cuda") \
        .add_(1).to(torch.int32).reshape(B, MB)
    base["pos"] = torch.tensor([0, 9, 25], dtype=torch.int32, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                         device="cuda", dtype=torch.int32)
    runs = {}
    for backend in ("auto", "plain"):
        ops.reset_launch_counts()
        cache = {k: v.clone() for k, v in base.items()}
        lg, cache = m.paged_extend_step(p, toks, cache, attn_backend=backend)
        runs[backend] = (lg, cache, ops.launch_counts())
    (lk, ck, nk), (lp, cp, np_) = runs["auto"], runs["plain"]
    assert _err(lk, lp) <= 1e-4
    assert _err(ck["k"], cp["k"]) <= 1e-4 and _err(ck["v"], cp["v"]) <= 1e-4
    assert nk["paged_decode_attention"] == cfg.num_layers
    assert all(n == 0 for n in np_.values())


@pytest.mark.parametrize("family", list(NEW_FAMILIES))
@pytest.mark.parametrize("remat", [False, True])
def test_new_families_train_on_the_kernels(cuda, family, remat):
    """Model.loss under grad at float32 (reduced): every attention read —
    prefix-LM for vlm; the encoder, the decoder and the cross attention
    for encdec — runs the flash kernel forward and backward, and the loss
    and gradients match the plain path (loss 1e-5, gradients 1e-4 of
    max(1, max |plain|))."""
    from repro_torch.models import Model
    from repro_torch.models.model import example_batch
    from repro_torch.training import tree as T
    cfg = _f32_reduced(NEW_FAMILIES[family])
    m = Model(cfg)
    p = m.init(seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = example_batch(cfg, 4, 44, gen, device="cuda")
    res = {}
    for backend in ("auto", "plain"):
        tp = T.replace(p, [t.detach().requires_grad_(True)
                           for t in T.tensors(p)])
        ops.reset_launch_counts()
        loss = m.loss(tp, batch, remat=remat and backend == "auto",
                      attn_backend=backend)
        grads = torch.autograd.grad(loss, T.tensors(tp))
        res[backend] = (loss.detach(), grads, ops.launch_counts())
    (lk, gk, ck), (lp, gp, cp) = res["auto"], res["plain"]
    L = cfg.num_layers
    enc = cfg.encoder_layers if family == "encdec" else 0
    n_fwd = L + enc + (L if enc else 0)          # encdec: self + cross
    dec = 2 * L if enc else L                    # the rematerialized reads
    assert ck["flash_attention"] == n_fwd + (dec if remat else 0)
    assert ck["flash_attention_bwd"] == n_fwd
    assert all(n == 0 for n in cp.values())
    assert abs(float(lk) - float(lp)) <= 1e-5 * float(lp)
    for a, b in zip(gk, gp):
        assert _rel_err(a, b) <= 1e-4
