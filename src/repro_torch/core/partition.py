"""Computation offloading / split inference (survey §2.2.2), the port of
the JAX package's ``core/partition.py``.

Structural model partitioning: the edge device runs layers [0, k) and ships
the (optionally compressed) boundary activation to the cloud, which runs
layers [k, L).  Includes the survey's hybrid cost model for choosing the
branch point (Stammler et al. / Yang et al. style) and INT8 boundary
quantization (Li et al.).

Works for the decoder-only transformer families (dense, moe, vlm); the vlm
image prefix is prepended on the edge and keeps its prefix-LM attention on
both sides.  On CUDA every block's attention runs the flash kernel.  As in
the JAX package, the cloud's logits take no softcap.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.compression import Identity
from repro_torch.models import layers as L
from repro_torch.models import transformer as TR


def _blocks(h, blocks, cfg, prefix_len, backend):
    positions = torch.arange(h.shape[1], device=h.device)
    for blk in blocks:
        h = TR._block(blk, h, positions, cfg, cfg.sliding_window, backend,
                      prefix_len)[0]
    return h


def edge_forward(params, tokens, cfg, k: int, *, embeds=None,
                 backend: str = "auto"):
    """Embedding (the vlm ``embeds`` prepended) + blocks [0, k).  Returns
    the boundary activation (B, S, d)."""
    h, prefix_len = TR._embed(params, tokens, cfg, embeds)
    return _blocks(h, params.blocks[:k], cfg, prefix_len, backend)


def cloud_forward(params, boundary_h, cfg, k: int, *, prefix_len: int = 0,
                  backend: str = "auto"):
    """Blocks [k, L) + final norm + head on a (possibly decompressed)
    boundary activation.  Returns logits (B, S, V) f32."""
    h = boundary_h.to(TR.dtype_of(cfg.activ_dtype))
    h = _blocks(h, params.blocks[k:], cfg, prefix_len, backend)
    return L.unembed(params.head, L.rmsnorm(h, params.final_norm,
                                            cfg.norm_eps))


def split_inference(model, params, batch, k: int, compressor=None, *,
                    attn_backend: str = "auto"):
    """Full split pass.  Returns (logits, wire bytes across the boundary)."""
    cfg = model.cfg
    if cfg.family not in TR.FAMILIES:
        raise ValueError(f"split inference is implemented for the "
                         f"decoder-only transformer families, not "
                         f"{cfg.family!r}")
    compressor = compressor or Identity()
    embeds = batch.get("embeds")
    h = edge_forward(params, batch["tokens"], cfg, k, embeds=embeds,
                     backend=attn_backend)
    c = compressor.compress(h)
    h2 = compressor.decompress(c)
    prefix_len = embeds.shape[1] if embeds is not None else 0
    logits = cloud_forward(params, h2, cfg, k, prefix_len=prefix_len,
                           backend=attn_backend)
    return logits, c.wire_bytes


@dataclasses.dataclass
class SplitCostModel:
    """Survey §2.2.2 hybrid cost function: pick the branch point k minimizing
        T(k) = edge_flops(k)/edge_speed + wire_bytes(k)/bandwidth
             + cloud_flops(k)/cloud_speed
    """
    edge_flops_per_s: float = 2e12         # phone-class NPU
    cloud_flops_per_s: float = 989e12      # one H100 SXM, dense bf16 tensor
                                           # cores (NVIDIA data sheet)
    bandwidth_bytes_per_s: float = 12.5e6  # 100 Mb/s uplink
    bytes_per_act: float = 1.0             # int8 boundary

    def layer_flops(self, cfg, tokens: int) -> float:
        d, f = cfg.d_model, max(cfg.d_ff, cfg.d_model * 4)
        attn = 4 * d * d + 2 * tokens * d   # proj + score/value (amortized)
        mlp = (3 if cfg.mlp_activation in ("silu", "geglu") else 2) * d * f
        return 2.0 * tokens * (attn + mlp)

    def total_time(self, cfg, tokens: int, k: int) -> float:
        lf = self.layer_flops(cfg, tokens)
        wire = tokens * cfg.d_model * self.bytes_per_act
        return (k * lf / self.edge_flops_per_s
                + wire / self.bandwidth_bytes_per_s
                + (cfg.num_layers - k) * lf / self.cloud_flops_per_s)

    def best_split(self, cfg, tokens: int) -> Tuple[int, np.ndarray]:
        ts = np.array([self.total_time(cfg, tokens, k)
                       for k in range(cfg.num_layers + 1)])
        return int(np.argmin(ts)), ts
