"""Online adaptation: background distillation/LoRA over serve-time
feedback, hot-swapped into live serving between scheduler ticks — the port
of the JAX package's ``core/adaptation.py``, where the serving and the
training halves of the system meet (survey §3: collaborative *inference
and learning*).

1. **Capture** — ``BatchedEngine._finish`` calls ``observe`` once per
   completion with the supervision triple (prompt, discarded edge draft,
   cloud-corrected continuation) plus the cloud's top-k teacher logits
   when the wave already paid for the cloud pass (``capture_topk`` tells
   the scheduler how many to keep; they ride the wave's one batched host
   pull).  Records land in a bounded ``data/feedback_store.FeedbackStore``
   with domain/SLA tags.

2. **Train** — every ``interval`` observations, ``maybe_update`` (called
   by the drain loop BETWEEN ticks) assembles a fixed-shape padded batch
   from the store and takes steps built on ``training/trainer.
   make_train_step`` + ``training/optimizer.AdamW``:

   * ``mode="distill"`` — forward KD on the full edge params
     (``training/distillation.kd_loss`` from the stored sparse teacher
     top-k, ``kd_mask`` confining the KL to captured positions).
   * ``mode="lora"`` — adapter-only updates (``training/lora.
     lora_loss_fn``) against the FROZEN base params taken at the first
     update; the swap value is ``merge_lora(base, adapters)``.

   The step trains on a copy whose leaves require grad; on CUDA its
   attention runs the flash kernel forward and backward.  Metrics stay on
   the device until ``stats``.

3. **Swap** — the new weights go back as a tensor tree with the serving
   params' structure, shapes, dtypes and device (AdamW and ``merge_lora``
   cast back to each parameter's dtype), built from new tensors
   (``donate=False``): the serving params are never written, so the work
   queued before the swap reads the old weights.  On a device mesh every
   rank trains on the same store from the same seed; the swap then takes
   rank 0's weights bit for bit (one broadcast per dtype), since a
   backward that sums with atomics may round differently on each rank,
   and ranks that served different weights would decide differently.

``interval=0`` is capture-only: the store fills but ``maybe_update``
never fires.  Sampling uses numpy's ``default_rng(seed)``, as JAX's does,
so both packages draw the same batches from the same store.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.data.feedback_store import FeedbackStore

MODES = ("distill", "lora")


class AdaptationLoop:
    """Serve-time adaptation driver (see the module docstring).

    Args:
        store: the ``FeedbackStore`` to fill/train from (fresh if None).
        mode: ``"distill"`` (full-param forward KD) or ``"lora"``
            (adapter-only on frozen base params).
        interval: take an update every this many observations (0 =
            capture-only, never update).
        batch_size / seq_len: fixed training-batch shape.
        topk: teacher logits kept per captured cloud position; also what
            the scheduler reads as ``capture_topk``.  ``topk=0`` disables
            teacher capture (lora mode trains on CE alone).
        steps_per_update: steps taken per due update.
        opt: ``training/optimizer.AdamW`` (default lr=1e-3 instance).
        lora_rank: adapter rank (lora mode).
        alpha / kd_temperature: ``kd_loss`` mixing knobs (distill mode).
        min_records: updates are skipped until the store holds this many.
        seed: the batch sampler's numpy seed and the adapters' init seed.
    """

    def __init__(self, store: Optional[FeedbackStore] = None, *,
                 mode: str = "distill", interval: int = 64,
                 batch_size: int = 8, seq_len: int = 64, topk: int = 8,
                 steps_per_update: int = 1, opt=None, lora_rank: int = 8,
                 alpha: float = 0.5, kd_temperature: float = 2.0,
                 min_records: int = 1, seed: int = 0):
        if mode not in MODES:
            raise ValueError(f"unknown adaptation mode {mode!r}; "
                             f"known: {' | '.join(MODES)}")
        if interval < 0:
            raise ValueError(f"interval must be >= 0, got {interval}")
        self.store = store if store is not None else FeedbackStore()
        self.mode = mode
        self.interval = interval
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.topk = topk
        self.steps_per_update = steps_per_update
        self.lora_rank = lora_rank
        self.alpha = alpha
        self.kd_temperature = kd_temperature
        self.min_records = min_records
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        if opt is None:
            from repro_torch.training.optimizer import AdamW
            opt = AdamW(lr=1e-3)
        self.opt = opt
        self.model = None
        self.mesh = None
        self._train_step = None
        self._opt_state = None
        self._base = None           # frozen base params (lora mode)
        self.adapters = None        # live adapter tree (lora mode)
        self._pending = False
        self.observed = 0
        self.updates = 0
        self.steps = 0
        self.swaps = 0
        self.latest = None          # most recent hot-swapped edge weights
        self._last_loss = None      # device scalar; read in stats()

    # ------------------------------------------------------------ capture
    @property
    def capture_topk(self) -> int:
        """Top-k teacher logits the scheduler should emit on cloud passes
        (0 = none).  Distill mode needs them; lora mode trains on the
        corrected tokens alone, so capture stays free there."""
        return self.topk if self.mode == "distill" else 0

    def bind(self, model, mesh=None) -> None:
        """Attach the edge model whose params the loop trains, and the
        device mesh it serves on, if any (the engine calls this at
        construction)."""
        self.model = model
        self.mesh = mesh

    def current(self, params):
        """The latest adapted edge weights, or ``params`` unchanged when
        no update has landed yet: every drain starts from this, so
        adaptation PERSISTS across drains."""
        return params if self.latest is None else self.latest

    def observe(self, *, prompt, tokens, draft=None, teacher_topk=None,
                domain=None, sla="none", path="edge") -> None:
        """Record one completion (host data only: what the wave's batched
        pull already fetched) and mark an update pending every
        ``interval`` observations."""
        self.store.add(prompt, tokens, draft=draft,
                       teacher_topk=teacher_topk, domain=domain, sla=sla,
                       path=path)
        self.observed += 1
        if self.interval and self.observed % self.interval == 0:
            self._pending = True

    # ------------------------------------------------------------ training
    def _build(self, params):
        from repro_torch.training.trainer import make_train_step
        if self.mode == "lora":
            from repro_torch.training.lora import init_lora, lora_loss_fn
            # the CURRENT serving params are the frozen base (never
            # written: the steps update the adapters only); B's zero init
            # makes the first merge the identity
            self._base = params
            self.adapters = init_lora(self.seed, params, rank=self.lora_rank,
                                      cfg=self.model.cfg)
            loss = lora_loss_fn(self.model, self._base)
        else:
            from repro_torch.training.distillation import kd_loss
            model, alpha, temp = self.model, self.alpha, self.kd_temperature

            def loss(p, b):
                return kd_loss(model, p, b, b["teacher_logits"],
                               alpha=alpha, temperature=temp,
                               kd_mask=b["kd_mask"])
        # donate=False: serving still reads the live params until the swap
        self._train_step = make_train_step(self.model, self.opt,
                                           loss_fn=loss, donate=False)
        self._opt_state = self.opt.init(
            self.adapters if self.mode == "lora" else params, self.model.cfg)

    def _batch(self, device) -> Dict[str, torch.Tensor]:
        b = self.store.sample_batch(self._rng, self.batch_size, self.seq_len,
                                    self.model.cfg.vocab_size,
                                    topk=self.capture_topk)
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    def maybe_update(self, params):
        """Offered the live edge params between ticks; returns the
        hot-swap replacement (same structure/shapes/dtypes/device) when an
        update is due, else None.  Nothing here waits for the device: the
        batches upload and the steps are queued behind the serving work."""
        if not self._pending or self.model is None:
            return None
        self._pending = False
        if len(self.store) < max(self.min_records, 1):
            return None
        if self._train_step is None:
            self._build(params)
        device = next(iter(params.parameters())).device
        target = self.adapters if self.mode == "lora" else params
        for _ in range(self.steps_per_update):
            target, self._opt_state, metrics = self._train_step(
                target, self._opt_state, self._batch(device))
            self.steps += 1
            self._last_loss = metrics["loss"]
        self.updates += 1
        self.swaps += 1
        if self.mode == "lora":
            from repro_torch.training.lora import merge_lora
            self.adapters = target
            with torch.no_grad():
                self.latest = merge_lora(self._base, self.adapters,
                                         self.model.cfg)
        else:
            self.latest = target
        if self.mesh is not None:
            self.latest = _rank0_copy(self.latest, self.mesh)
        return self.latest

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, Any]:
        return {"mode": self.mode, "interval": self.interval,
                "observed": self.observed, "updates": self.updates,
                "train_steps": self.steps, "swaps": self.swaps,
                "last_loss": None if self._last_loss is None
                else float(self._last_loss),
                **{f"store_{k}": v for k, v in self.store.stats().items()}}


def _rank0_copy(params, mesh):
    """``params`` with every tensor replaced by rank 0's copy: one
    broadcast of the tensors of each dtype, flattened together."""
    from repro_torch.training import tree as T
    ts = T.tensors(params)
    out = list(ts)
    for dtype in dict.fromkeys(t.dtype for t in ts):
        idx = [i for i, t in enumerate(ts) if t.dtype == dtype]
        flat = mesh.broadcast(torch.cat([ts[i].detach().reshape(-1)
                                         for i in idx]))
        for i, part in zip(idx, flat.split([ts[i].numel() for i in idx])):
            out[i] = part.view_as(ts[i])
    return T.replace(params, out)
