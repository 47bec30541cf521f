"""Architecture registry: ``--arch <id>`` resolution."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

_MODULES = {
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "rwkv6-3b": "rwkv6_3b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen3-8b": "qwen3_8b",
    "gemma3-12b": "gemma3_12b",
    "qwen3-32b": "qwen3_32b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "hubert-xlarge": "hubert_xlarge",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
