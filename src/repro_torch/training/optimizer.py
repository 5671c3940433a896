"""AdamW and a cosine schedule, written out as the JAX package's
``training/optimizer.py`` writes them (not ``torch.optim.AdamW``, whose
bias correction and decay order differ).

The state mirrors the parameters: float32 moments ``m`` and ``v`` (one per
leaf of ``training/tree.leaves``, whatever the parameter's dtype), the
step count, and the decay mask.  Updates clip the gradients by their
global norm, step in float32 and cast each parameter back to its dtype.

Decay: JAX decays every leaf of rank >= 2 in ITS layout, where each
block's norms are stacked ``(L, d)`` — decayed — and the final norm
``(d,)`` is not.  The port keeps one ``(d,)`` norm per block, so the mask
follows the rank of the JAX leaf (``bridge.jax_ndims``), not the port
tensor's: for a parameter module pass ``cfg`` to ``init``; a plain tree
of tensors (LoRA adapters) already has the JAX ranks.

All of ``update`` stays on the device: the global norm, the clip scale
and the new parameters are tensors; the step and the learning rate are
host numbers, so no value is pulled to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.training import tree as T


class AdamWState(NamedTuple):
    m: List[torch.Tensor]
    v: List[torch.Tensor]
    step: int
    decay: Tuple[bool, ...]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: Optional[Callable] = None     # step -> lr multiplier

    def init(self, params, cfg=None) -> AdamWState:
        named = T.leaves(params)
        if isinstance(params, nn.Module):
            from repro_torch.bridge import config_of, jax_ndims
            ranks = jax_ndims(params, config_of(params, cfg))
            decay = tuple(ranks[n] >= 2 for n, _ in named)
        else:
            decay = tuple(t.dim() >= 2 for _, t in named)
        zeros = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                 for _, t in named]
        return AdamWState(zeros, [z.clone() for z in zeros], 0, decay)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, *,
               inplace: bool = False):
        """One step: ``grads`` in ``tree.leaves(params)`` order.  Returns
        (new params, new state, global grad norm () f32).  ``inplace``
        writes the new parameters and moments into the given tensors (the
        port's buffer donation) and returns ``params`` itself; otherwise
        everything returned is new and the inputs stay valid."""
        step = state.step + 1
        ps = T.tensors(params)
        g32 = [g.float() for g in grads]
        gnorm = torch.stack(torch._foreach_norm(g32)).square().sum().sqrt()
        if self.grad_clip:
            scale = torch.clamp(self.grad_clip / gnorm.clamp(min=1e-9),
                                max=1.0)
            g32 = torch._foreach_mul(g32, scale)
        lr = self.lr * (float(self.schedule(step)) if self.schedule else 1.0)
        if inplace:
            m, v = state.m, state.v
            torch._foreach_mul_(m, self.b1)
            torch._foreach_mul_(v, self.b2)
        else:
            m = torch._foreach_mul(state.m, self.b1)
            v = torch._foreach_mul(state.v, self.b2)
        torch._foreach_add_(m, g32, alpha=1 - self.b1)
        torch._foreach_addcmul_(v, g32, g32, value=1 - self.b2)
        mh = torch._foreach_div(m, 1 - self.b1 ** step)
        den = torch._foreach_sqrt(torch._foreach_div(v, 1 - self.b2 ** step))
        torch._foreach_add_(den, self.eps)
        delta = torch._foreach_div(mh, den)
        p32 = [p.float() for p in ps]
        if self.weight_decay:
            idx = [i for i, d in enumerate(state.decay) if d]
            if idx:
                torch._foreach_add_([delta[i] for i in idx],
                                    [p32[i] for i in idx],
                                    alpha=self.weight_decay)
        new = torch._foreach_add(p32, delta, alpha=-lr)
        new = [n.to(p.dtype) for n, p in zip(new, ps)]
        if inplace:
            torch._foreach_copy_(ps, new)
            out = params
        else:
            out = T.replace(params, new)
        return out, AdamWState(m, v, step, state.decay), gnorm


def cosine_schedule(warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up over ``warmup`` steps, then a cosine from 1 to
    ``floor`` at ``total``: step -> learning-rate multiplier."""
    def fn(step):
        warm = min(step / max(warmup, 1), 1.0)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return warm * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi
                                                                 * prog)))
    return fn
