"""Family dispatch: one functional interface over the ported families."""

from __future__ import annotations

from types import ModuleType

from repro_torch.models.config import ModelConfig

# families whose model module is not ported yet -> the ROADMAP item
# (Queue 1) that ports it
_TO_PORT = {
    "moe": "Queue 1 item 7 (models/moe.py)",
}


def get_model(cfg: ModelConfig) -> ModuleType:
    if cfg.family in _TO_PORT:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP {_TO_PORT[cfg.family]})")
    from repro_torch.models import rglru, rwkv6, transformer
    return {
        "dense": transformer,
        "vlm": transformer,
        "audio": transformer,
        "ssm": rwkv6,
        "hybrid": rglru,
    }[cfg.family]
