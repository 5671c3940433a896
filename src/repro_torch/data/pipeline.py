"""Data pipeline: synthetic LM corpora + non-IID federated partitioning
(survey §4: LEAF/FedNLP-style heterogeneity without shipping datasets), the
port of the JAX package's ``data/pipeline.py``: the same numpy streams from
the same seeds, handed out as tensors on an explicit device.

The synthetic corpus is a mixture of per-"domain" Markov chains over the
vocabulary — learnable structure (a model CAN reduce loss below uniform) and
controllable inter-client divergence via Dirichlet mixing (FedNLP's split).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import stub_input, text_len


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    n_domains: int = 4
    order_vocab: int = 256     # active sub-vocabulary per domain
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.domain_vocab = [
            rng.choice(self.vocab_size, size=min(self.order_vocab,
                                                 self.vocab_size),
                       replace=False)
            for _ in range(self.n_domains)]
        # sparse per-domain bigram transition: each symbol -> few successors
        self.trans = []
        for d in range(self.n_domains):
            V = len(self.domain_vocab[d])
            succ = rng.integers(0, V, size=(V, 4))
            probs = rng.dirichlet(np.ones(4) * 0.5, size=V)
            self.trans.append((succ, probs))

    def sample(self, rng: np.random.Generator, domain: int, length: int
               ) -> np.ndarray:
        succ, probs = self.trans[domain]
        vocab = self.domain_vocab[domain]
        V = len(vocab)
        s = rng.integers(0, V)
        out = np.empty(length, np.int64)
        for i in range(length):
            out[i] = s
            s = succ[s, rng.choice(4, p=probs[s])]
        return vocab[out]


def batches(cfg, batch: int, seq: int, *, device, domain_weights=None,
            seed: int = 0, synth: Optional[SyntheticLM] = None
            ) -> Iterator[Dict]:
    """Infinite iterator of ``{"tokens", "labels"}`` (batch, s_text) int32
    tensors on ``device``, plus the family's stub input as float32
    standard normals drawn after the tokens: vlm ``embeds`` (batch,
    num_image_tokens, d) with s_text = max(seq - num_image_tokens, 8),
    encdec ``frames`` (batch, encoder_seq, d).  The JAX package's stream:
    same ``SyntheticLM``, same numpy draws in the same order."""
    synth = synth or SyntheticLM(cfg.vocab_size)
    rng = np.random.default_rng(seed)
    w = np.asarray(domain_weights if domain_weights is not None
                   else np.ones(synth.n_domains) / synth.n_domains)
    w = w / w.sum()
    s_text = text_len(cfg, seq)
    key, rows = stub_input(cfg)
    while True:
        toks = np.stack([synth.sample(rng, rng.choice(len(w), p=w), s_text)
                         for _ in range(batch)]).astype(np.int32)
        t = torch.from_numpy(toks).to(device)
        out = {"tokens": t, "labels": t}
        if key is not None:
            x = rng.standard_normal((batch, rows, cfg.d_model))
            out[key] = torch.from_numpy(x.astype(np.float32)).to(device)
        yield out


def dirichlet_clients(n_clients: int, n_domains: int, alpha: float = 0.3,
                      seed: int = 0) -> List[np.ndarray]:
    """FedNLP-style non-IID client mixtures: each client's domain weights
    ~ Dirichlet(alpha).  Small alpha = more skew."""
    rng = np.random.default_rng(seed)
    return [rng.dirichlet(np.ones(n_domains) * alpha)
            for _ in range(n_clients)]


def client_divergence(weights: List[np.ndarray]) -> float:
    """Mean pairwise total-variation distance between client mixtures."""
    n = len(weights)
    tv = [0.5 * np.abs(weights[i] - weights[j]).sum()
          for i in range(n) for j in range(i + 1, n)]
    return float(np.mean(tv)) if tv else 0.0
