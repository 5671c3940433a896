"""paligemma-3b [vlm] — SigLIP vision tower (stub) + gemma decoder
[arXiv:2407.07726].  The vision tower/projector is stubbed per the
assignment carve-out: input_specs provides (B, 256, d_model) patch
embeddings; the gemma-style decoder attends over [image prefix + text].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    source="arXiv:2407.07726",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    mlp_activation="geglu",
    num_image_tokens=256,
    logit_softcap=0.0,
)
