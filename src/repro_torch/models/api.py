"""Family dispatch: one functional interface over all assigned families."""

from __future__ import annotations

from types import ModuleType

from repro_torch.models.config import ModelConfig


def get_model(cfg: ModelConfig) -> ModuleType:
    from repro_torch.models import moe, rglru, rwkv6, transformer
    return {
        "dense": transformer,
        "vlm": transformer,
        "audio": transformer,
        "moe": moe,
        "ssm": rwkv6,
        "hybrid": rglru,
    }[cfg.family]
