"""xlstm-125m [xlstm] — sLSTM + mLSTM blocks, d_ff=0 [arXiv:2405.04517].

d_ff = 0: xLSTM blocks carry their own up/down projections and gating, so
there is no separate MLP sub-layer.  4 heads with kv=4 refers to the mLSTM
matrix-memory heads.  Every 4th block is an sLSTM block (recurrent,
memory-mixing); the rest are mLSTM (parallel, linear-attention form).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="xlstm",
    source="arXiv:2405.04517",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm_slstm_every=4,     # blocks 3, 7, 11 are sLSTM
    use_rope=False,
)
