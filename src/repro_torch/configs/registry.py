"""Architecture registry: ``--arch <id>`` resolution + input specs.

``batch_input_specs``, ``decode_input_specs``, ``param_specs`` and
``cache_specs`` return meta tensors standing in for every input of a
step: shapes and dtypes, no storage (the dry-run pattern).
"""

from __future__ import annotations

import importlib
from typing import Dict

import torch

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


# ---------------------------------------------------------------------------
# Input specs: meta tensors (shapes and dtypes, no storage) standing in for
# every input of a step, as the JAX package's ShapeDtypeStructs do
# ---------------------------------------------------------------------------

_META = torch.device("meta")


def batch_input_specs(cfg: ModelConfig, batch: int, seq: int):
    """Training-batch meta tensors for one step."""
    if cfg.input_kind == "tokens":
        x = torch.empty((batch, seq), dtype=torch.int32, device=_META)
    else:
        x = torch.empty((batch, seq, cfg.d_model), dtype=torch.bfloat16,
                        device=_META)
    labels = torch.empty((batch, seq), dtype=torch.int32, device=_META)
    return {"x": x, "labels": labels}


def decode_input_specs(cfg: ModelConfig, batch: int):
    if cfg.input_kind == "tokens":
        return {"token": torch.empty((batch,), dtype=torch.int32,
                                     device=_META)}
    # embeds-input backbones decode from frontend-embedded vectors
    return {"token": torch.empty((batch, cfg.d_model), dtype=torch.bfloat16,
                                 device=_META)}


def param_specs(cfg: ModelConfig):
    """Parameter meta tensors: ``model.init`` on the meta device from a
    seeded CPU generator (no allocation)."""
    from repro_torch.models.api import get_model
    gen = torch.Generator().manual_seed(0)
    return get_model(cfg).init(gen, cfg, _META)


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int):
    from repro_torch.models.api import get_model
    return get_model(cfg).init_cache(cfg, batch, max_seq, _META)
