"""Architecture registry: ``get_config(name)`` / ``get_reduced(name)``."""
from __future__ import annotations

import importlib

from repro_torch.configs.shapes import (  # noqa: F401
    SHAPES, ShapeSpec, batch_specs, cache_specs, cell_applicability,
    concrete_batch,
)

ARCHS = {
    "gemma2-9b": "gemma2_9b",
    "llama3-405b": "llama3_405b",
    "yi-6b": "yi_6b",
    "gemma3-4b": "gemma3_4b",
    "mixtral-8x22b": "mixtral_8x22b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "whisper-medium": "whisper_medium",
    "zamba2-1.2b": "zamba2_1_2b",
}


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")


def get_config(name: str):
    return _module(name).CONFIG


def get_reduced(name: str):
    return _module(name).REDUCED


def all_arch_names():
    return list(ARCHS)
