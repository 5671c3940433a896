"""Entry points of the port: ``serve``, ``train`` and the mesh helpers
(``mesh``, ``sharding``)."""
from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """The device a ``--device`` flag names; ``cuda`` (every entry point's
    default) raises without a card instead of falling back to the CPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) needs a CUDA card; "
                           "pass --device cpu to run on the CPU")
    return torch.device(name)
