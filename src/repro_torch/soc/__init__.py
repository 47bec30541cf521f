from repro_torch.soc.device import Device, MemoryLevel, SoC
from repro_torch.soc.carfield import carfield_soc

__all__ = ["Device", "MemoryLevel", "SoC", "carfield_soc"]
