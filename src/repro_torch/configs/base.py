"""Unified model/run configuration for the repro framework.

One ``ModelConfig`` dataclass covers all architecture families assigned to
this paper (dense / moe / ssm-mamba2 / xlstm / hybrid / encdec-audio / vlm).
Every field not used by a family defaults to an inert value so configs stay
comparable.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str              # dense | moe | ssm | xlstm | hybrid | encdec | vlm
    source: str = ""                 # citation (arXiv id / hf model card)

    # transformer backbone
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0                # 0 -> d_model // num_heads
    mlp_activation: str = "silu"     # silu | relu2 | gelu | geglu
    use_rope: bool = True            # False -> learned positional embeddings
    max_position_embeddings: int = 1 << 20
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    logit_softcap: float = 0.0       # 0 -> disabled
    tie_embeddings: bool = True

    # attention variant (set per input shape for long-context decode)
    sliding_window: int = 0          # 0 -> full causal attention

    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM / xLSTM / Mamba2
    ssm_state: int = 0               # Mamba2 state size N
    ssm_head_dim: int = 64           # Mamba2 P (head dim of the SSD heads)
    ssm_expand: int = 2              # d_inner = ssm_expand * d_model
    ssm_chunk: int = 128             # SSD chunk length
    xlstm_slstm_every: int = 0       # xLSTM: every k-th block is sLSTM (0 = none)
    conv_kernel: int = 4             # Mamba2 depthwise conv width

    # hybrid (zamba2-style): one *shared* attention block applied periodically
    shared_attn_every: int = 0       # 0 -> no shared attention block

    # encoder-decoder (whisper-style); encoder consumes precomputed frame
    # embeddings (conv/mel frontend is a stub per the assignment carve-out).
    encoder_layers: int = 0
    encoder_seq: int = 0             # e.g. 1500 audio frames

    # vlm (paligemma-style); vision tower is a stub: patch embeddings are
    # provided directly as a (B, num_image_tokens, d_model) input.
    num_image_tokens: int = 0

    # numerics
    param_dtype: str = "bfloat16"
    activ_dtype: str = "bfloat16"

    # training-time extras used by the collaboration library
    early_exit_layers: Tuple[int, ...] = ()   # layers with auxiliary LM heads

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_decoder_only(self) -> bool:
        return self.family in ("dense", "moe", "ssm", "xlstm", "hybrid", "vlm")

    @property
    def has_attention(self) -> bool:
        return self.family not in ("ssm", "xlstm")

    @property
    def supports_long_decode(self) -> bool:
        """Sub-quadratic decode: native for ssm/hybrid, via sliding window
        for dense/moe/vlm.  encdec (whisper) is skipped (see DESIGN.md)."""
        return self.family != "encdec"

    def n_params(self) -> int:
        """Approximate parameter count (for MODEL_FLOPS = 6ND roofline)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm"):
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            ff_mult = 3 if self.mlp_activation in ("silu", "geglu") else 2
            mlp = ff_mult * d * self.d_ff
            return L * (attn + mlp) + emb
        if self.family == "moe":
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            mlp = 3 * d * self.d_ff * self.num_experts
            return L * (attn + mlp) + emb
        if self.family == "xlstm":   # mlstm/slstm blocks
            per = 8 * d * d          # projections + gates (approximate)
            return L * per + emb
        if self.family == "ssm":     # mamba2 blocks
            d_in = self.ssm_expand * d
            per = 2 * d * d_in + d_in * d + d_in * (2 * self.ssm_state)
            return L * per + emb
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            mamba = 2 * d * d_in + d_in * d + d_in * (2 * self.ssm_state)
            n_shared = L // max(self.shared_attn_every, 1) if self.shared_attn_every else 0
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            shared = attn + 3 * d * self.d_ff   # counted once: weights shared
            return L * mamba + (shared if n_shared else 0) + emb
        if self.family == "encdec":
            attn = 4 * d * d
            mlp = 2 * d * self.d_ff
            enc = self.encoder_layers * (attn + mlp)
            dec = L * (2 * attn + mlp)
            return enc + dec + emb
        raise ValueError(self.family)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.n_params()
        d, L = self.d_model, self.num_layers
        attn = d * self.head_dim * (self.num_heads + 2 * self.num_kv_heads) \
            + self.num_heads * self.head_dim * d
        mlp = 3 * d * self.d_ff * self.top_k
        return L * (attn + mlp) + self.vocab_size * d

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=256, <=4 experts,
        small vocab. Same family/block pattern so the code path is identical."""
        kw = dict(
            num_layers=2,
            d_model=min(self.d_model, 256),
            vocab_size=min(self.vocab_size, 512),
            max_position_embeddings=4096,
            param_dtype="float32",
            activ_dtype="float32",
        )
        if self.num_heads:
            nh = min(self.num_heads, 4)
            nkv = max(1, min(self.num_kv_heads, nh))
            while nh % nkv:
                nkv -= 1
            kw.update(num_heads=nh, num_kv_heads=nkv,
                      head_dim=min(self.d_model, 256) // nh)
        if self.d_ff:
            kw["d_ff"] = min(self.d_ff, 512)
        if self.num_experts:
            kw.update(num_experts=4, top_k=min(self.top_k, 2))
        if self.encoder_layers:
            kw.update(encoder_layers=2, encoder_seq=16)
        if self.num_image_tokens:
            kw["num_image_tokens"] = 4
        if self.shared_attn_every:
            kw["shared_attn_every"] = 2
        if self.xlstm_slstm_every:
            kw["xlstm_slstm_every"] = 2
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_chunk=8)
        if self.family in ("ssm", "xlstm"):
            kw["ssm_chunk"] = 8
        return self.replace(**kw)


# families whose model reads a stub input beside the tokens: the batch key
STUB_INPUTS = {"vlm": "embeds", "encdec": "frames"}


def stub_input(cfg: ModelConfig):
    """(batch key, rows) of the family's stub input: vlm ``embeds``
    (num_image_tokens rows), encdec ``frames`` (encoder_seq rows), each row
    d_model wide; (None, 0) for the other families."""
    key = STUB_INPUTS.get(cfg.family)
    rows = {"vlm": cfg.num_image_tokens,
            "encdec": cfg.encoder_seq}.get(cfg.family, 0)
    return key, rows


def text_len(cfg: ModelConfig, seq: int) -> int:
    """Text tokens of a ``seq``-row batch: vlm's max(seq - P, 8) (its P
    image rows come first), ``seq`` for every other family."""
    return max(seq - cfg.num_image_tokens, 8) if cfg.family == "vlm" \
        else seq


# ----------------------------------------------------------------------
# Assigned input shapes (global, before sharding).
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}

# Sliding window applied to full-attention archs for long-context decode
# (see DESIGN.md "Shape/decode skips").
LONG_DECODE_WINDOW = 4_096
