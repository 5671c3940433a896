"""Communication optimization (survey §2.2.4), the port of the JAX package's
``core/compression.py``.

Everything that crosses the edge-cloud boundary (activations in split
inference, logits in verification, adapter deltas in federated tuning) goes
through a ``Compressor``.  Each compressor reports exact wire bytes — the
same numbers the JAX package reports for the same input — so the
benchmarks can trade fidelity against transfer cost.  Payloads are tensors
on the input's device; rounding is half to even in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Compressed:
    payload: dict
    wire_bytes: int
    method: str


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class Identity:
    name = "identity"

    def compress(self, x) -> Compressed:
        x = torch.as_tensor(x)
        return Compressed({"x": x}, _nbytes(x), self.name)

    def decompress(self, c: Compressed):
        return c.payload["x"]


class _SymmetricQuantizer:
    """Per-channel (last axis) symmetric quantization to ``qmax`` levels a
    side, held as int8; ``bits`` per value on the wire plus a float32
    scale per channel.  The scale and the division run in the input's
    dtype, as in the JAX package."""
    name = ""
    qmax = 0
    bits = 8

    def compress(self, x) -> Compressed:
        x = torch.as_tensor(x)
        scale = x.abs().amax(dim=-1, keepdim=True) / float(self.qmax)
        scale = scale.clamp(min=1e-12)
        q = torch.clamp(torch.round(x / scale), -self.qmax, self.qmax) \
            .to(torch.int8)
        wire = (q.numel() * self.bits + 7) // 8 + scale.numel() * 4
        return Compressed({"q": q, "scale": scale}, int(wire), self.name)

    def decompress(self, c: Compressed):
        return c.payload["q"].float() * c.payload["scale"]


class Int8Quantizer(_SymmetricQuantizer):
    """Per-channel symmetric int8 (survey: INT8 intermediate
    representations, Li et al. / Ye et al.).  axis=-1 channels."""
    name = "int8"
    qmax = 127


class Int4Quantizer(_SymmetricQuantizer):
    """Per-channel symmetric int4 (packed two per byte on the wire)."""
    name = "int4"
    qmax = 7
    bits = 4


class TopKSparsifier:
    """Keep the top-k fraction of entries by magnitude (EdgeShard-style
    'forward only inference-critical features'); optional error feedback
    (the dropped part is added to the next input)."""
    name = "topk"

    def __init__(self, frac: float = 0.1, error_feedback: bool = False):
        self.frac = frac
        self.error_feedback = error_feedback
        self._residual = None

    def compress(self, x) -> Compressed:
        x = torch.as_tensor(x)
        if self.error_feedback and self._residual is not None:
            x = x + self._residual
        flat = x.reshape(-1)
        k = max(1, int(flat.numel() * self.frac))
        idx = torch.topk(flat.abs(), k).indices
        vals = flat[idx]
        if self.error_feedback:
            kept = torch.zeros_like(flat).index_put((idx,), vals)
            self._residual = (flat - kept).reshape(x.shape)
        wire = k * (4 + 4)   # fp32 value + int32 index
        return Compressed({"idx": idx, "vals": vals, "shape": tuple(x.shape)},
                          int(wire), self.name)

    def decompress(self, c: Compressed):
        shape, idx = c.payload["shape"], c.payload["idx"]
        flat = torch.zeros(int(np.prod(shape)), dtype=torch.float32,
                           device=idx.device)
        return flat.index_put((idx,), c.payload["vals"].float()) \
            .reshape(shape)


class TopKLogits:
    """Transmit only the top-k logits — the standard trick for shipping
    verification distributions edge <-> cloud."""
    name = "topk_logits"

    def __init__(self, k: int = 64):
        self.k = k

    def compress(self, logits) -> Compressed:
        logits = torch.as_tensor(logits)
        vals, idx = torch.topk(logits, self.k, dim=-1)
        wire = int(np.prod(tuple(logits.shape[:-1]))) * self.k * (4 + 4)
        return Compressed({"idx": idx, "vals": vals, "V": logits.shape[-1]},
                          wire, self.name)

    def decompress(self, c: Compressed):
        """Reconstruct (..., V) with -1e30 outside the top-k (the mass
        outside the top-k is treated as zero)."""
        idx, vals = c.payload["idx"], c.payload["vals"]
        out = torch.full(tuple(idx.shape[:-1]) + (c.payload["V"],), -1e30,
                         dtype=torch.float32, device=idx.device)
        return out.scatter(-1, idx, vals.float())


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def entropy_bits_estimate(x, bins: int = 256) -> float:
    """Empirical entropy (bits/element) of a quantized tensor — the survey's
    entropy-compression bound: a lossless coder could reach this."""
    q = _host(x).reshape(-1)
    hist, _ = np.histogram(q, bins=bins)
    p = hist / max(hist.sum(), 1)
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def relative_error(x, y) -> float:
    x, y = _host(x).astype(np.float32), _host(y).astype(np.float32)
    return float(np.linalg.norm(x - y) / (np.linalg.norm(x) + 1e-12))


COMPRESSORS = {
    "identity": Identity,
    "int8": Int8Quantizer,
    "int4": Int4Quantizer,
    "topk": TopKSparsifier,
}
