"""The port's Hopper kernels vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one; the skip is decided inside the ``cuda`` fixture, never at import.  The
module imports only torch and numpy, so it runs on a machine without JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 atol 1e-5, bfloat16 2e-2 (kernel and plain version
differ in summation order; bfloat16 outputs round once).  ``spec_verify``
is exact at T = 0; at T = 1 with shared uniforms it is exact on every
group without a near-tie (a uniform within 1e-6 of a cdf entry).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention_cuda, paged_decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.spec_verify import (  # noqa: E402
    spec_verify_cuda, spec_verify_plain)

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
                                      (1, 32, 15, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32),
                                           (False, 0)])
def test_flash_attention_kernel(cuda, B, H, S, hd, dtype, causal, window):
    q, k, v = (_rand(i, (B, H, S, hd), cuda, dtype) for i in range(3))
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    ref = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("B,Kv,G,bs,MB,hd", [(1, 1, 1, 16, 4, 64),
                                             (3, 2, 4, 16, 8, 64),
                                             (2, 4, 2, 32, 4, 128),
                                             (8, 3, 3, 32, 3, 64)])
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


@pytest.mark.parametrize("G,gamma,V", [(1, 1, 64), (3, 4, 1000),
                                       (8, 4, 49152)])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_spec_verify_kernel(cuda, G, gamma, V, temperature):
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
        assert int(((n_k != n_p) | (t_k != t_p)).sum()) <= max(1, G // 4)


def test_dispatch_counts_launches(cuda):
    """ops dispatch runs the kernel on CUDA tensors and counts it."""
    ops.reset_launch_counts()
    q = _rand(0, (1, 2, 16, 64), cuda)
    ops.flash_attention(q, q, q)
    assert ops.launch_counts()["flash_attention"] == 1
