"""olmoe-1b-7b [moe] — 64 experts, top-8 [arXiv:2409.02060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    source="arXiv:2409.02060",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    top_k=8,
    mlp_activation="silu",
)
