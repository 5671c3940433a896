"""Collaborative training driver (PyTorch port): train a ~100M-class cloud
teacher for a few hundred steps, then distill an edge student with
DistillSpec-style KD and show the speculative-acceptance uplift.

    PYTHONPATH=src python examples/torch_port/train_distill.py [--steps 200]

The twin of ``examples/train_distill.py``; it imports only
``repro_torch``.  ``--device`` defaults to ``cuda`` and raises without a
card.
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.data import batches
from repro_torch.launch import resolve_device
from repro_torch.models import Model
from repro_torch.models.model import cross_entropy
from repro_torch.training import (AdamW, cosine_schedule, make_train_step,
                                  train)
from repro_torch.training.distillation import (acceptance_estimate, kd_loss,
                                               teacher_logits_fn)


def main(argv=None):
    """Returns {"teacher_history", "distill_losses", "acceptance_before",
    "acceptance_after", "student_ce"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # teacher: the reduced smollm family stands in for the ~100M cloud model
    t_cfg = get_config("smollm-135m").reduced()
    teacher_m = Model(t_cfg)
    print("== train teacher ==")
    res = train(teacher_m, teacher_m.init(seed=0, device=dev),
                batches(t_cfg, args.batch, args.seq, device=dev),
                steps=args.steps,
                opt=AdamW(lr=2e-3, schedule=cosine_schedule(20, args.steps)),
                log_every=max(args.steps // 8, 1))
    teacher = res["params"]

    # student: a 2-layer edge SLM
    s_cfg = t_cfg.replace(num_layers=2)
    student_m = Model(s_cfg)
    student = student_m.init(seed=1, device=dev)
    tlf = teacher_logits_fn(teacher_m, teacher)

    evalb = next(batches(t_cfg, args.batch, args.seq, device=dev, seed=999))
    with torch.no_grad():
        before = float(acceptance_estimate(
            student_m.forward(student, evalb)[0], tlf(evalb)))

    print("== distill student (forward KD on teacher logits) ==")
    opt = AdamW(lr=2e-3)
    step = make_train_step(
        student_m, opt,
        loss_fn=lambda p, b: kd_loss(student_m, p, b, tlf(b), alpha=0.3),
        donate=False)
    st = opt.init(student)
    it = batches(t_cfg, args.batch, args.seq, device=dev)
    losses = []
    for i in range(max(args.steps // 2, 1)):
        student, st, m = step(student, st, next(it))
        losses.append(float(m["loss"]))
        if i % max(args.steps // 8, 1) == 0:
            print(f"  distill step {i}: loss {losses[-1]:.4f}")

    with torch.no_grad():
        lg, _ = student_m.forward(student, evalb)
        after = float(acceptance_estimate(lg, tlf(evalb)))
    ce = float(cross_entropy(lg[:, :-1], evalb["labels"][:, 1:]))
    print(f"\nstudent eval CE: {ce:.4f}")
    print(f"expected speculative acceptance (1 - TV): {before:.3f} -> "
          f"{after:.3f}")
    print("(DistillSpec: higher acceptance = more tokens per cloud pass)")
    return {"teacher_history": res["history"], "distill_losses": losses,
            "acceptance_before": before, "acceptance_after": after,
            "student_ce": ce}


if __name__ == "__main__":
    main()
