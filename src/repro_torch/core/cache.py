"""Semantic response cache (survey §2.3.2 — VELO-style vector-database
cache at the edge).

Requests are keyed by an embedding; a hit (cosine similarity above a
threshold) returns the cached cloud response without a cloud call.  History
store doubles as the retrieval substrate for the Hybrid-RACA-style
historical-enhancement path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class CacheEntry:
    key: np.ndarray
    value: Any
    hits: int = 0


class SemanticCache:
    def __init__(self, capacity: int = 1024, threshold: float = 0.9):
        self.capacity = capacity
        self.threshold = threshold
        self.entries: List[CacheEntry] = []
        self.lookups = 0
        self.hits = 0

    @staticmethod
    def _norm(v: np.ndarray) -> np.ndarray:
        v = np.asarray(v, np.float32).reshape(-1)
        return v / (np.linalg.norm(v) + 1e-12)

    def lookup(self, key: np.ndarray) -> Optional[Any]:
        return self.lookup_batch(np.asarray(key, np.float32).reshape(1, -1))[0]

    def lookup_batch(self, keys: np.ndarray) -> List[Optional[Any]]:
        """Vectorized lookup: one (N, D) @ (D, E) similarity matmul for N
        query keys against all E entries (the scheduler admits a whole batch
        of requests per tick, so per-key matmuls would scale as N*E)."""
        keys = np.asarray(keys, np.float32)
        if keys.ndim == 1:
            keys = keys.reshape(1, -1)
        n = keys.shape[0]
        self.lookups += n
        if not self.entries:
            return [None] * n
        norms = np.linalg.norm(keys, axis=1, keepdims=True) + 1e-12
        q = keys / norms                                   # (N, D)
        mat = np.stack([e.key for e in self.entries])      # (E, D)
        sims = q @ mat.T                                   # (N, E)
        best = np.argmax(sims, axis=1)
        out: List[Optional[Any]] = []
        for row, i in enumerate(best):
            if sims[row, i] >= self.threshold:
                self.hits += 1
                self.entries[int(i)].hits += 1
                out.append(self.entries[int(i)].value)
            else:
                out.append(None)
        return out

    def insert(self, key: np.ndarray, value: Any):
        if len(self.entries) >= self.capacity:
            # evict the least-hit entry (VELO uses utility-aware eviction)
            self.entries.pop(int(np.argmin([e.hits for e in self.entries])))
        self.entries.append(CacheEntry(self._norm(key), value))

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


def embed_tokens_mean(model, params, tokens) -> np.ndarray:
    """Cheap request embedding: mean of the model's token embeddings.
    The pull to host is explicit — the cache index lives host-side."""
    emb = params.embed
    idx = torch.as_tensor(np.asarray(tokens, np.int64), device=emb.device)
    v = emb[idx].mean(dim=-2)
    return v.float().cpu().numpy().astype(np.float32)
