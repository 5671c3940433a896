"""Data pipeline: synthetic LM corpora (survey §4: LEAF/FedNLP-style
heterogeneity without shipping datasets).  The serving slice needs only the
corpus itself; the training-side iterators and federated partitioning wait
for the learning slice.

The synthetic corpus is a mixture of per-"domain" Markov chains over the
vocabulary — learnable structure (a model CAN reduce loss below uniform) and
controllable inter-client divergence via Dirichlet mixing (FedNLP's split).
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
