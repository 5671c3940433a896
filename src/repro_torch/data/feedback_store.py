"""Serve-time feedback capture: the training side of the serving loop, the
port's own copy of the JAX package's ``data/feedback_store.py`` (numpy
only, the same records, batches and sampling).

Every completed request that involved the cloud already produced a
supervision triple — the prompt, the edge draft the policy rejected (or
accepted), and the cloud-corrected continuation — and the cloud-regen
paths even paid for full teacher logits along the way.  ``FeedbackStore``
is the bounded ring buffer those triples retire into: the scheduler's
``_finish`` path appends ONE host-resident record per completion (all
fields come off the wave's single batched host pull — capture never adds
a sync), and ``core/adaptation.py`` periodically assembles padded
``{"tokens", "labels"}`` batches from it, following the
``data/pipeline.py::batches`` conventions, to take background
distillation / LoRA steps.

Records carry a ``domain`` tag (caller-assigned workload domain, e.g. the
``SyntheticLM`` chain a prompt was sampled from) and an ``sla`` tag
(realized deadline outcome: ``"met"`` / ``"missed"`` / ``"none"`` when no
SLO is configured), so adaptation can be sliced per domain or per SLA
class.  The buffer is bounded: once ``capacity`` records are held, each
append evicts the oldest (``evicted`` counts them).

Teacher supervision is stored SPARSE — per generated position, the
top-k logit values and their vocab indices, exactly what the cloud
decode emitted — and scattered to a dense ``(B, S, V)`` array plus a
position mask only at batch-assembly time (``kd_mask`` feeds
``training/distillation.kd_loss``; positions without teacher data carry
zero KL weight).  Batches are numpy arrays; the caller moves them to its
device.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: logit fill for vocab entries outside the stored top-k: small enough to
#: carry ~zero probability mass after the KD temperature softmax, large
#: enough to keep `exp` finite (no -inf -> nan under log_softmax)
TOPK_FILL = -30.0


@dataclasses.dataclass
class FeedbackTriple:
    """One completion's supervision record (all host-resident numpy)."""
    prompt: np.ndarray                      # (P,) int32 prompt tokens
    tokens: np.ndarray                      # (C,) int32 corrected continuation
    draft: Optional[np.ndarray] = None      # (D,) int32 edge draft (may = tokens)
    teacher_values: Optional[np.ndarray] = None   # (C', k) f32 top-k logits
    teacher_indices: Optional[np.ndarray] = None  # (C', k) int32 vocab ids
    domain: Optional[int] = None            # workload domain tag
    sla: str = "none"                       # met | missed | none
    path: str = "edge"                      # serving path that produced it


class FeedbackStore:
    """Bounded ring buffer of ``FeedbackTriple`` records with padded-batch
    assembly (see the module docstring)."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self.added = 0
        self.evicted = 0
        self._domain_counts: Dict[str, int] = {}
        self._sla_counts: Dict[str, int] = {}
        self._path_counts: Dict[str, int] = {}

    # ------------------------------------------------------------ capture
    def add(self, prompt, tokens, *, draft=None, teacher_topk=None,
            domain: Optional[int] = None, sla: str = "none",
            path: str = "edge") -> None:
        """Append one completion.  ``teacher_topk`` is an optional
        ``(values, indices)`` pair of per-generated-position top-k arrays
        (shape ``(C', k)``) as emitted by the cloud decode scan."""
        tv = ti = None
        if teacher_topk is not None:
            tv = np.asarray(teacher_topk[0], np.float32)
            ti = np.asarray(teacher_topk[1], np.int32)
        if len(self._buf) == self.capacity:
            self.evicted += 1
        self._buf.append(FeedbackTriple(
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            tokens=np.asarray(tokens, np.int32).reshape(-1),
            draft=None if draft is None
            else np.asarray(draft, np.int32).reshape(-1),
            teacher_values=tv, teacher_indices=ti,
            domain=domain, sla=sla, path=path))
        self.added += 1
        key = "untagged" if domain is None else str(domain)
        self._domain_counts[key] = self._domain_counts.get(key, 0) + 1
        self._sla_counts[sla] = self._sla_counts.get(sla, 0) + 1
        self._path_counts[path] = self._path_counts.get(path, 0) + 1

    def __len__(self) -> int:
        return len(self._buf)

    def records(self) -> List[FeedbackTriple]:
        """Current ring contents, oldest first."""
        return list(self._buf)

    def stats(self) -> Dict[str, object]:
        return {"size": len(self._buf), "capacity": self.capacity,
                "added": self.added, "evicted": self.evicted,
                "by_domain": dict(self._domain_counts),
                "by_sla": dict(self._sla_counts),
                "by_path": dict(self._path_counts)}

    # ------------------------------------------------------------ batches
    def sample_batch(self, rng: np.random.Generator, batch: int, seq: int,
                     vocab_size: int, *, topk: int = 0,
                     domains: Optional[Sequence[int]] = None) -> Dict:
        """Assemble a padded training batch (``data/pipeline.py`` shapes):
        ``tokens``/``labels`` are ``(batch, seq)`` int32 with labels -1 on
        prompt and pad positions (only the corrected continuation is
        supervised — ``models.model.cross_entropy`` ignores -1).  With
        ``topk > 0`` the batch also carries ``teacher_logits`` (``(batch,
        seq, vocab)`` f32, stored top-k scattered, ``TOPK_FILL``
        elsewhere) and ``kd_mask`` (``(batch, seq)`` bool, True exactly
        where teacher data exists) for ``kd_loss``.  Sampling is uniform
        WITH replacement so the batch shape is fixed regardless of ring
        occupancy (the train step sees one shape).  ``domains``
        optionally restricts sampling to the tagged subset (falls back to
        the whole ring when the subset is empty)."""
        if not self._buf:
            raise ValueError("feedback store is empty")
        pool = list(self._buf)
        if domains is not None:
            sub = [r for r in pool if r.domain in set(domains)]
            pool = sub or pool
        picks = [pool[i] for i in rng.integers(0, len(pool), size=batch)]
        toks = np.zeros((batch, seq), np.int32)
        labels = np.full((batch, seq), -1, np.int32)
        out: Dict = {}
        if topk:
            teacher = np.full((batch, seq, vocab_size), TOPK_FILL,
                              np.float32)
            kd_mask = np.zeros((batch, seq), bool)
        for b, r in enumerate(picks):
            full = np.concatenate([r.prompt, r.tokens])[:seq]
            toks[b, :full.size] = full
            P = min(r.prompt.size, seq)
            labels[b, P:full.size] = full[P:]
            if topk and r.teacher_values is not None:
                # generated token j was scored at teacher-forced position
                # P-1+j (the prefix up to and including position P-2+j)
                k = min(topk, r.teacher_values.shape[1])
                for j in range(min(r.teacher_values.shape[0],
                                   r.tokens.size)):
                    pos = r.prompt.size - 1 + j
                    if pos >= seq:
                        break
                    teacher[b, pos, r.teacher_indices[j, :k]] = \
                        r.teacher_values[j, :k]
                    kd_mask[b, pos] = True
        out["tokens"] = toks
        out["labels"] = labels
        if topk:
            out["teacher_logits"] = teacher
            out["kd_mask"] = kd_mask
        return out
