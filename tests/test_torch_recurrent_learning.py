"""Learning paths of the recurrent families in the port vs the JAX package,
on the CPU, at reduced size.

* LoRA serve-time adaptation on a mamba2 edge, which has no attention
  matrices: the adapter tree is empty, so an update trains nothing, yet the
  loop counts the update, the step and the swap, and reports the loss, as
  JAX's does.  Both engines serve the JAX init (bridged into the port).
  Tolerance: the loss 1e-5 (float32 on the CPU, sums in another order).
* ``launch/train.py --save`` for each recurrent family: the file the port
  writes is the JAX package's checkpoint layout, which JAX's
  ``training/checkpoint.restore`` reads back exactly.
* the SSD-scan backward's route plan (``kernels/ssd_scan.py::
  ssd_bwd_plan``), which the CUDA launcher takes as it is: shapes alone
  decide it, so it is pinned here without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.core.adaptation import AdaptationLoop as JLoop  # noqa: E402
from repro.core.policy import ThresholdPolicy as JThreshold  # noqa: E402
from repro.core.scheduler import BatchedEngine as JEngine  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.adaptation import AdaptationLoop as TLoop  # noqa
from repro_torch.core.policy import ThresholdPolicy as TThreshold  # noqa
from repro_torch.core.scheduler import BatchedEngine as TEngine  # noqa
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.kernels.ssd_scan import SMEM_LIMIT  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_bwd_plan  # noqa: E402
from repro_torch.training import lora  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


def test_lora_on_a_mamba2_edge_matches_jax():
    """Two drains with interval 6: drain 1 marks an update due, drain 2
    takes it (an empty adapter tree) and serves on the swapped weights."""
    je = jget("mamba2-370m").reduced()
    jc = jget("granite-8b").reduced().replace(vocab_size=je.vocab_size)
    te = tget("mamba2-370m").reduced()
    tc = tget("granite-8b").reduced().replace(vocab_size=te.vocab_size)
    jep = JModel(je).init(jax.random.PRNGKey(0))
    jcp = JModel(jc).init(jax.random.PRNGKey(1))
    sides = {"j": (JEngine, JThreshold, JLoop, JModel(je), jep, JModel(jc),
                   jcp),
             "t": (TEngine, TThreshold, TLoop, TModel(te),
                   params_from_numpy(_host(jep), te, "cpu"), TModel(tc),
                   params_from_numpy(_host(jcp), tc, "cpu"))}
    assert lora.target_paths(sides["t"][4], cfg=te) == []
    prompts = [((np.arange(8) * 7 + 3 * i) % te.vocab_size).astype(np.int32)
               for i in range(6)]
    traces, loops = {}, {}
    for s, (Engine, Pol, Loop, edge, ep, cloud, cp) in sides.items():
        loops[s] = Loop(mode="lora", interval=6, batch_size=4, seq_len=16,
                        min_records=1)
        eng = Engine(edge, cloud, batch_size=4, temperature=0.0,
                     policy=Pol(1.1), use_cache=False, tick_tokens=4,
                     adaptation=loops[s])
        traces[s] = [[t.tokens for t in eng.serve_batch(ep, cp, prompts, 5)]
                     for _ in range(2)]
    assert traces["t"] == traces["j"]
    js, ts = loops["j"].stats(), loops["t"].stats()
    for key in ("observed", "updates", "train_steps", "swaps"):
        assert ts[key] == js[key], key
    assert (ts["updates"], ts["train_steps"], ts["swaps"]) == (1, 1, 1)
    assert np.isfinite(ts["last_loss"])
    assert abs(ts["last_loss"] - js["last_loss"]) <= 1e-5


@pytest.mark.parametrize("arch", ["mamba2-370m", "xlstm-125m",
                                  "zamba2-2.7b"])
def test_train_save_restores_in_jax(tmp_path, arch):
    """``launch/train.py --save`` on each recurrent family (reduced): JAX
    restores the file into its own init's structure, leaf for leaf equal
    to the port's trained parameters."""
    from repro_torch.launch import train
    path = tmp_path / "params.npz"
    out = train.main(["--device", "cpu", "--reduced", "--arch", arch,
                      "--steps", "2", "--batch", "2", "--seq", "32",
                      "--save", str(path)])
    like = JModel(jget(arch).reduced()).init(jax.random.PRNGKey(0))
    tree, step = jckpt.restore(str(path), like)
    assert step == 2
    got = jax.tree_util.tree_flatten_with_path(_host(tree))[0]
    want = jax.tree_util.tree_flatten_with_path(
        params_to_numpy(out["params"], tget(arch).reduced()))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and np.array_equal(a, b), str(p)


# (N, P, Q) of the trainers' scans (mamba2-370m, xlstm-125m, zamba2-2.7b at
# seq 256) and of the 2048-token prompts (mamba2, xLSTM), and what the
# plan must give each in bf16: (rows, stages)
SSD_BWD_PLANS = {(128, 64, 256): (64, 2), (384, 384, 128): (32, 1),
                 (64, 64, 128): (64, 2)}


@pytest.mark.parametrize("N,P,Q", list(SSD_BWD_PLANS))
def test_ssd_bwd_plan_routes(N, P, Q):
    """bf16 on the tensor cores (the S 2048 prompts have the trainers'
    chunk lengths, so the same plans), float32 on the CUDA cores, and
    each within a block's shared memory on an H100."""
    plan = ssd_bwd_plan(torch.bfloat16, N, P, Q)
    assert plan.route == "mma"
    assert (plan.rows, plan.stages) == SSD_BWD_PLANS[N, P, Q]
    assert plan.kind(torch.bfloat16) == (2 if plan.rows == 64 else 3)
    f32 = ssd_bwd_plan(torch.float32, N, P, Q)
    assert f32.route == "cuda_cores" and f32.kind(torch.float32) == 0
    assert f32.rows == (16 if N == 384 else 32)
    for p in (plan, f32):
        assert 0 < p.smem <= SMEM_LIMIT == 232448


def test_ssd_bwd_plan_falls_back_where_nothing_fits():
    """A state too wide for any tensor-core tile, or a chunk whose dy does
    not fit beside the tiles, takes the CUDA cores in bf16 too; the plan
    knows two tilings, 64 rows with two stages (N <= 128) and 32 rows with
    one (N <= 384), and takes the second where the first does not fit."""
    assert ssd_bwd_plan(torch.bfloat16, 512, 64, 128).route == "cuda_cores"
    assert ssd_bwd_plan(torch.bfloat16, 128, 64, 1024).route == "cuda_cores"
    assert ssd_bwd_plan(torch.bfloat16, 128, 64, 128).stages == 2
    wide = ssd_bwd_plan(torch.bfloat16, 256, 64, 128)
    assert (wide.route, wide.rows, wide.stages) == ("mma", 32, 1)
    long_chunk = ssd_bwd_plan(torch.bfloat16, 128, 64, 512)
    assert (long_chunk.route, long_chunk.rows, long_chunk.stages) == \
        ("mma", 32, 1)
    assert long_chunk.kind(torch.bfloat16) == 3
