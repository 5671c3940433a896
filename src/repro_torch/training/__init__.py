from repro_torch.training.optimizer import AdamW, cosine_schedule  # noqa: F401
from repro_torch.training.trainer import make_train_step, train  # noqa: F401
