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
host numbers, so no value is pulled to the host.  It walks the leaves in
groups of at most ``GROUP_ELEMS`` elements, so its float32 temporaries
(the cast gradients, the bias-corrected moments, the step) exist for one
group at a time: a 2.3e9-parameter model's update fits beside its
moments on one 80 GB card.  Every element's arithmetic is the same as in
one pass over all leaves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.training import tree as T

GROUP_ELEMS = 1 << 26      # elements of the leaves updated together


def _groups(tensors, cap: int):
    """Consecutive index groups of ``tensors`` holding at most ``cap``
    elements each (a larger leaf alone)."""
    out, cur, n = [], [], 0
    for i, t in enumerate(tensors):
        if cur and n + t.numel() > cap:
            out.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += t.numel()
    return out + [cur] if cur else out


def _sq_norms(tensors) -> torch.Tensor:
    """Each tensor's squared L2 norm, (n,) f32: ``_foreach_norm`` on CUDA;
    on the CPU, whose ``_foreach_norm`` and ``linalg.vector_norm`` sum a
    large tensor's squares with a relative error near 1e-5, a cascade
    ``sum`` of the squares (1e-8, as the JAX package's)."""
    if tensors[0].is_cuda:
        return torch.stack(torch._foreach_norm(
            [t.float() for t in tensors])).square()
    return torch.stack([t.float().square().sum() for t in tensors])


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
               inplace: bool = False, norm_sq: Optional[Callable] = None):
        """One step: ``grads`` in ``tree.leaves(params)`` order.  Returns
        (new params, new state, global grad norm () f32).  ``inplace``
        writes the new parameters and moments into the given tensors (the
        port's buffer donation) and returns ``params`` itself; otherwise
        everything returned is new and the inputs stay valid.
        ``norm_sq(sq)`` maps the leaves' squared norms (n,) f32 to the
        squared global norm (their sum by default; on a device mesh the
        whole model's, ``training/trainer.py``); the clip scale and the
        decay mask stay per leaf."""
        step = state.step + 1
        ps = T.tensors(params)
        groups = _groups(ps, GROUP_ELEMS)
        sq = torch.cat([_sq_norms([grads[i] for i in idx]) for idx in groups])
        gnorm = (sq.sum() if norm_sq is None else norm_sq(sq)).sqrt()
        scale = torch.clamp(self.grad_clip / gnorm.clamp(min=1e-9),
                            max=1.0) if self.grad_clip else None
        lr = self.lr * (float(self.schedule(step)) if self.schedule else 1.0)
        m_all, v_all, new_all = [None] * len(ps), [None] * len(ps), []
        for idx in groups:
            g32 = [grads[i].float() for i in idx]
            if scale is not None:
                g32 = torch._foreach_mul(g32, scale)
            m = [state.m[i] for i in idx]
            v = [state.v[i] for i in idx]
            if inplace:
                torch._foreach_mul_(m, self.b1)
                torch._foreach_mul_(v, self.b2)
            else:
                m = torch._foreach_mul(m, self.b1)
                v = torch._foreach_mul(v, self.b2)
            torch._foreach_add_(m, g32, alpha=1 - self.b1)
            torch._foreach_addcmul_(v, g32, g32, value=1 - self.b2)
            del g32
            mh = torch._foreach_div(m, 1 - self.b1 ** step)
            den = torch._foreach_sqrt(torch._foreach_div(v,
                                                         1 - self.b2 ** step))
            torch._foreach_add_(den, self.eps)
            delta = torch._foreach_div(mh, den)
            del mh, den
            p32 = [ps[i].float() for i in idx]
            if self.weight_decay:
                dec = [j for j, i in enumerate(idx) if state.decay[i]]
                if dec:
                    torch._foreach_add_([delta[j] for j in dec],
                                        [p32[j] for j in dec],
                                        alpha=self.weight_decay)
            new = torch._foreach_add(p32, delta, alpha=-lr)
            del p32, delta
            new = [n.to(ps[i].dtype) for n, i in zip(new, idx)]
            if inplace:
                torch._foreach_copy_([ps[i] for i in idx], new)
            else:
                new_all += new
            for j, i in enumerate(idx):
                m_all[i], v_all[i] = m[j], v[j]
        out = params if inplace else T.replace(params, new_all)
        m, v = m_all, v_all
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
