"""Family dispatch: one functional interface over the ported families."""

from __future__ import annotations

from types import ModuleType

from repro_torch.models.config import ModelConfig

# families whose model module is not ported yet -> the ROADMAP item
# (Queue 1) that ports it
_TO_PORT = {
    "moe": "Queue 1 item 7 (models/moe.py)",
    "ssm": "Queue 1 item 5 (models/rwkv6.py)",
    "hybrid": "Queue 1 item 6 (models/rglru.py)",
}


def get_model(cfg: ModelConfig) -> ModuleType:
    if cfg.family in _TO_PORT:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP {_TO_PORT[cfg.family]})")
    from repro_torch.models import transformer
    return {
        "dense": transformer,
        "vlm": transformer,
        "audio": transformer,
    }[cfg.family]
