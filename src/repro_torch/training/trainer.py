"""Training loop substrate: the train-step builder and the host loop, the
port of the JAX package's ``training/trainer.py``.

A step is functional, as JAX's jitted step is: ``step(params, opt_state,
batch) -> (params, opt_state, {"loss", "grad_norm"})``.  It differentiates
a copy of the parameter tree whose leaves require grad (the serving
parameters never do) with ``torch.autograd.grad``, and hands the gradients
to the optimizer.  Everything it returns stays on the device: the step
makes no host pull.  On CUDA the attention of the loss runs the flash
kernel forward and backward (``kernels/flash_attention.FlashAttention``).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.training import tree as T
from repro_torch.training.optimizer import AdamW, AdamWState


def make_train_step(model, opt: AdamW, *, loss_fn: Optional[Callable] = None,
                    remat: bool = False, donate: bool = True):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``loss_fn(params, batch)`` overrides the model's
    cross-entropy loss (distillation, LoRA).  ``donate``: update the
    parameters and moments in place (the caller's tensors then hold the
    new values) — JAX's buffer donation; ``donate=False`` leaves them
    untouched and returns new tensors."""
    _loss = loss_fn or (lambda p, b: model.loss(p, b, remat=remat))

    def step(params, opt_state: AdamWState, batch):
        train_p = T.replace(params, [t.detach().requires_grad_(True)
                                     for t in T.tensors(params)])
        leaves = T.tensors(train_p)
        if not leaves:
            # an empty tree (LoRA on an edge with no attention matrices):
            # JAX's update of it moves nothing, counts the step and reports
            # sqrt of an empty sum, 0
            with torch.no_grad():
                loss = _loss(params, batch)
            gnorm = loss.new_zeros((), dtype=torch.float32)
            return params, opt_state._replace(step=opt_state.step + 1), {
                "loss": loss, "grad_norm": gnorm}
        with torch.enable_grad():
            loss = _loss(train_p, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, leaves)]
        params, opt_state, gnorm = opt.update(grads, opt_state, params,
                                              inplace=donate)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def train(model, params, data_iter, *, steps: int, opt: Optional[AdamW] = None,
          loss_fn=None, remat: bool = False, log_every: int = 10,
          donate: bool = False, log: Callable = print) -> Dict:
    """Host training loop.  ``donate=True`` updates ``params`` in place.
    Returns ``{"params", "opt_state", "history"}``, history a list of
    (step, loss) at every ``log_every``-th step and the last; the loss is
    pulled to the host only there."""
    opt = opt or AdamW()
    opt_state = opt.init(params, getattr(model, "cfg", None))
    step_fn = make_train_step(model, opt, loss_fn=loss_fn, remat=remat,
                              donate=donate)
    history = []
    t0 = time.time()
    for i in range(steps):
        batch = next(data_iter)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            loss = float(metrics["loss"])
            history.append((i, loss))
            log(f"step {i:5d}  loss {loss:.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
                f"{(time.time() - t0):.1f}s")
    return {"params": params, "opt_state": opt_state, "history": history}
