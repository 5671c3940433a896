"""Collaborative training: the distillation family (survey §3.2, §3.5), the
port of the JAX package's ``training/distillation.py``.

* ``kd_loss`` — forward KD (cloud LLM teaches edge SLM): CE + T^2·KL(p_t‖p_s).
* ``reverse_kd_loss`` — mode-seeking KL(p_s‖p_t) (MiniLLM-style).
* ``distillspec_data`` — DistillSpec: self-sampled target sequences as the
  distillation corpus, which raises speculative acceptance (acceptance =
  1 - TV(p, q), and KD on on-policy data minimizes it).
* ``logit_delta_guidance`` — SLM-guided LLM adaptation (the emulator of
  Mitchell et al., survey §3.5.2): apply (logits_slm_ft - logits_slm_base)
  to the LLM.

For the vlm family the image-prefix rows carry no loss in ``kd_loss`` and
``reverse_kd_loss``, and ``teacher_logits_fn`` returns the text rows only,
as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.model import cross_entropy


def kl_divergence(teacher_logits, student_logits, temperature: float = 1.0,
                  mask=None):
    """KL(teacher || student), mean over positions.  Inputs (..., V).
    ``mask`` (broadcastable to the position dims) restricts the mean to the
    positions that carry teacher supervision (serve-time capture stores
    teacher logits only at generated positions)."""
    t = F.log_softmax(teacher_logits.float() / temperature, -1)
    s = F.log_softmax(student_logits.float() / temperature, -1)
    kl = torch.sum(torch.exp(t) * (t - s), dim=-1)
    if mask is None:
        return kl.mean()
    m = mask.to(kl.dtype)
    return torch.sum(kl * m) / torch.sum(m).clamp(min=1.0)


def kd_loss(student_model, student_params, batch, teacher_logits, *,
            alpha: float = 0.5, temperature: float = 2.0, kd_mask=None):
    """alpha·CE(labels) + (1-alpha)·T²·KL(teacher‖student) + the student's
    aux loss.  ``kd_mask`` ((B, S) bool) marks the positions with real
    teacher logits; None averages over every position."""
    logits, aux = student_model.forward(student_params, batch)[:2]
    logits = student_model.text_rows(logits, batch)
    ce = cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    kl = kl_divergence(teacher_logits[:, :-1], logits[:, :-1], temperature,
                       mask=None if kd_mask is None else kd_mask[:, :-1])
    return alpha * ce + (1 - alpha) * (temperature ** 2) * kl + aux


def reverse_kd_loss(student_model, student_params, batch, teacher_logits, *,
                    temperature: float = 1.0):
    """KL(student || teacher): mode-seeking, the gradient flows through the
    student distribution (MiniLLM)."""
    logits, aux = student_model.forward(student_params, batch)[:2]
    logits = student_model.text_rows(logits, batch)
    s = F.log_softmax(logits[:, :-1].float() / temperature, -1)
    t = F.log_softmax(teacher_logits[:, :-1].float() / temperature, -1)
    return torch.mean(torch.sum(torch.exp(s) * (s - t), dim=-1)) + aux


@torch.no_grad()
def distillspec_data(target_model, target_params, prompts, max_new: int,
                     gen: torch.Generator, temperature: float = 1.0):
    """Sample on-policy sequences from the TARGET (the DistillSpec corpus).
    prompts: (B, S) int tensor on the target's device; ``gen`` a
    ``torch.Generator`` there.  Returns (B, S + max_new) int32 tokens."""
    tokens = prompts.to(torch.int32)
    _, cache = target_model.prefill(target_params,
                                    {"tokens": tokens[:, :-1]},
                                    max_seq=tokens.shape[1] + max_new + 2)
    tok = tokens[:, -1:]
    outs = [tokens]
    for _ in range(max_new):
        lg, cache = target_model.decode_step(target_params, tok, cache)
        if temperature == 0.0:
            nxt = torch.argmax(lg, -1)
        else:
            probs = torch.softmax(lg.float() / temperature, -1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        tok = nxt.to(torch.int32)[:, None]
        outs.append(tok)
    return torch.cat(outs, dim=1)


def teacher_logits_fn(teacher_model, teacher_params):
    """The frozen teacher's forward for KD: batch -> logits (text rows
    only for vlm), no graph."""
    @torch.no_grad()
    def fn(batch):
        return teacher_model.text_rows(
            teacher_model.forward(teacher_params, batch)[0], batch)
    return fn


def logit_delta_guidance(llm_logits, slm_ft_logits, slm_base_logits,
                         beta: float = 1.0):
    """Emulated fine-tuning (survey §3.5.2): LLM + beta·(SLM_ft - SLM_base),
    over a shared vocabulary, in float32."""
    return llm_logits.float() + beta * (slm_ft_logits.float()
                                        - slm_base_logits.float())


def acceptance_estimate(draft_logits, target_logits,
                        temperature: float = 1.0):
    """Expected speculative acceptance 1 - TV(p, q) per position, the mean
    over positions — the metric DistillSpec optimizes.  Inputs (..., V)."""
    p = torch.softmax(target_logits.float() / temperature, -1)
    q = torch.softmax(draft_logits.float() / temperature, -1)
    return torch.mean(torch.sum(torch.minimum(p, q), dim=-1))
