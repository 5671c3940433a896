"""whisper-small [audio] — enc-dec; conv/mel frontend is a stub: the encoder
consumes precomputed frame embeddings [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    source="arXiv:2212.04356",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    encoder_seq=1500,         # 30 s of audio at 50 Hz after the conv stub
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    mlp_activation="gelu",
    use_rope=False,           # learned positional embeddings
    max_position_embeddings=40960,   # covers decode_32k (long_500k is skipped)
)
