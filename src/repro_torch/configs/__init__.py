"""Architecture configs: one module per assigned architecture.

``get(arch_id)`` returns the full published config; ``get_smoke(arch_id)``
returns a reduced same-family config for CPU smoke tests.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ModelConfig, ShapeSpec, SHAPES

ARCH_IDS: List[str] = [
    "granite-20b",
    "qwen3-14b",
    "qwen2-7b",
    "olmo-1b",
    "grok-1-314b",
    "qwen2-moe-a2.7b",
    "whisper-small",
    "jamba-1.5-large-398b",
    "mamba2-1.3b",
    "llava-next-34b",
]

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[arch_id]}")
    return mod.CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[arch_id]}")
    return mod.SMOKE


__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "ARCH_IDS", "get",
           "get_smoke"]
