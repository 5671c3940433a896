"""mamba2-370m [ssm] — pure Mamba2 (SSD) stack, no attention at all
[arXiv:2405.21060].

The standalone SSM family: 48 mamba2 blocks over the chunked GLA engine in
``models/ssm.py`` (the same blocks zamba2's hybrid backbone stacks, minus
the shared attention).  d_ff = 0: mamba2 blocks carry their own up/down
projections and gating, so there is no separate MLP sub-layer; num_heads = 0
because the SSD heads are ``ssm_expand * d_model / ssm_head_dim``, not
attention heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50288,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_kernel=4,
    use_rope=False,
)
