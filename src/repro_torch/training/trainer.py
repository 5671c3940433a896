"""Training loop substrate: the train-step builder and the host loop, the
port of the JAX package's ``training/trainer.py``.

A step is functional, as JAX's jitted step is: ``step(params, opt_state,
batch) -> (params, opt_state, {"loss", "grad_norm"})``.  It differentiates
a copy of the parameter tree whose leaves require grad (the serving
parameters never do) with ``torch.autograd.grad``, and hands the gradients
to the optimizer.  Everything it returns stays on the device: the step
makes no host pull.  On CUDA the attention of the loss runs the flash
kernel forward and backward (``kernels/flash_attention.FlashAttention``).

On a device mesh (``mesh=``; every family, parameters placed by
``launch/sharding.place_params`` or ``init_placed``) each rank steps its
own blocks.  It takes its rows of the global batch
(``sharding.DataRows``); its loss term is its rows' summed cross entropy
over the global batch's label count plus its share of the moe
load-balance loss, so the data ranks' terms sum to the unsharded loss
(rows whole on every data rank, a batch that does not divide the data
axes, count on the first data rank only).  The backward runs through the
differentiable collectives (``launch/mesh.py``); then each gradient is
summed over the axes ``TensorParallel.grad_axes`` names, the global norm
is the whole model's (each leaf's squared norm counted once, one sum
over the mesh), and AdamW steps every rank's blocks, its moments beside
them.  The loss and the norm it returns are the unsharded step's, the
same on every rank.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.training import tree as T
from repro_torch.training.optimizer import AdamW, AdamWState


def make_train_step(model, opt: AdamW, *, loss_fn: Optional[Callable] = None,
                    remat: bool = False, donate: bool = True, mesh=None):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``loss_fn(params, batch)`` overrides the model's
    cross-entropy loss (distillation, LoRA).  ``donate``: update the
    parameters and moments in place (the caller's tensors then hold the
    new values) — JAX's buffer donation; ``donate=False`` leaves them
    untouched and returns new tensors.  ``mesh``: the sharded step (module
    docstring); ``batch`` is then the global batch, the same on every
    rank."""
    if mesh is not None:
        if loss_fn is not None:
            raise NotImplementedError("a loss_fn on a device mesh (sharded "
                                      "distillation or LoRA) is not ported")
        return _sharded_step(model, opt, mesh, remat, donate)
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


def _sharded_step(model, opt: AdamW, mesh, remat: bool, donate: bool):
    from repro_torch.launch.sharding import batch_axes
    plan = {}

    def step(params, opt_state: AdamWState, batch):
        if not plan:
            plan.update(_plan(params, mesh))
        part, grads = _local_grads(model, params, batch, mesh, remat,
                                   plan["names"])
        grads = _sum_grads(grads, plan["names"], plan["axes"], mesh)
        params, opt_state, gnorm = opt.update(
            grads, opt_state, params, inplace=donate,
            norm_sq=lambda sq: mesh.all_reduce((sq * plan["owns"]).sum(),
                                               mesh.axis_names))
        loss = mesh.all_reduce(part.detach(), batch_axes(mesh))
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def _plan(params, mesh) -> Dict:
    """The leaves' names, the axes their gradients are summed over and
    whether this rank's copy counts in the whole model's norm."""
    tp = params.tp
    if tp.mesh is not mesh:
        raise ValueError("the parameters are placed on another mesh")
    names = [n for n, _ in T.leaves(params)]
    owns = tp.owns(params)
    return {"names": names, "axes": tp.grad_axes(params),
            "owns": torch.tensor([float(owns[n]) for n in names],
                                 device=mesh.device)}


def _local_grads(model, params, batch, mesh, remat, names):
    """(this rank's term of the global loss, its gradient of every leaf):
    its rows' summed cross entropy over the global batch's label count
    plus its share of the moe load-balance loss (module docstring).  A
    leaf the loss reads that no gradient reaches raises."""
    from repro_torch.launch.sharding import data_rows
    from repro_torch.models.model import nll_sum
    if params.tp.mesh is not mesh:
        raise ValueError("the parameters are placed on another mesh")
    rows = data_rows(batch, mesh)
    train_p = T.replace(params, [t.detach().requires_grad_(True)
                                 for t in T.tensors(params)])
    leaves = T.tensors(train_p)
    with params.tp.training(rows), torch.enable_grad():
        local = rows.local(batch)
        logits, aux = model.forward(train_p, local, remat=remat)[:2]
        logits = model.text_rows(logits, local)
        nll, n = nll_sum(logits[:, :-1, :], local["labels"][:, 1:])
        part = nll / rows.total(n).clamp(min=1) + aux
        if rows.weight != 1.0:
            part = part * rows.weight
        grads = torch.autograd.grad(part, leaves, allow_unused=True)
    missing = [n for n, g in zip(names, grads) if g is None]
    if missing:
        raise RuntimeError(
            f"no gradient reached {len(missing)} leaves the loss reads on "
            f"a device mesh ({', '.join(missing[:4])}, ...): a collective "
            "on their path is not differentiable")
    return part, list(grads)


def sharded_grads(model, params, batch, mesh, remat: bool = False):
    """The gradient the sharded step hands AdamW: this rank's block of
    every leaf's gradient of the global loss (summed over its
    ``TensorParallel.grad_axes``), by parameter name; and the global
    loss."""
    from repro_torch.launch.sharding import batch_axes
    plan = _plan(params, mesh)
    part, grads = _local_grads(model, params, batch, mesh, remat,
                               plan["names"])
    grads = _sum_grads(grads, plan["names"], plan["axes"], mesh)
    return (mesh.all_reduce(part.detach(), batch_axes(mesh)),
            dict(zip(plan["names"], grads)))


def _sum_grads(grads, names, axes, mesh):
    """Each gradient summed over its ``TensorParallel.grad_axes`` groups:
    the gradients with the same groups and dtype travel flattened
    together, one all-reduce per group."""
    buckets = {}
    for i, n in enumerate(names):
        if axes[n]:
            buckets.setdefault((axes[n], grads[i].dtype), []).append(i)
    for (groups, _), idx in buckets.items():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        for g in groups:
            flat = mesh.all_reduce(flat, g)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            grads[i] = part.view_as(grads[i])
    return grads


def train(model, params, data_iter, *, steps: int, opt: Optional[AdamW] = None,
          loss_fn=None, remat: bool = False, log_every: int = 10,
          donate: bool = False, log: Callable = print, mesh=None) -> Dict:
    """Host training loop.  ``donate=True`` updates ``params`` in place.
    Returns ``{"params", "opt_state", "history"}``, history a list of
    (step, loss) at every ``log_every``-th step and the last; the loss is
    pulled to the host only there.  ``mesh``: the sharded step on placed
    parameters (``make_train_step``); ``data_iter`` yields global
    batches."""
    opt = opt or AdamW()
    opt_state = opt.init(params, getattr(model, "cfg", None))
    step_fn = make_train_step(model, opt, loss_fn=loss_fn, remat=remat,
                              donate=donate, mesh=mesh)
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
