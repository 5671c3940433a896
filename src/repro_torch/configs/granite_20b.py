"""granite-20b [dense] — llama-arch (MQA, kv=1), code [arXiv:2405.04324]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    source="arXiv:2405.04324",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,          # multi-query attention
    d_ff=24576,
    vocab_size=49152,
    mlp_activation="silu",
)
