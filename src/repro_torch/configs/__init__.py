"""Config registry: ``get_config(arch_id)`` for every assigned architecture."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    LONG_DECODE_WINDOW,
    SHAPES,
    InputShape,
    ModelConfig,
)

_MODULES = {
    "mamba2-370m": "mamba2_370m",
    "xlstm-125m": "xlstm_125m",
    "whisper-small": "whisper_small",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-20b": "granite_20b",
    "paligemma-3b": "paligemma_3b",
    "smollm-135m": "smollm_135m",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "nemotron-4-15b": "nemotron_4_15b",
    "zamba2-2.7b": "zamba2_2_7b",
    "granite-8b": "granite_8b",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in _MODULES}
