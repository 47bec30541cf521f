"""Platform model of a heterogeneous SoC (Fig. 1b / Fig. 5 of the paper).

A :class:`Device` is any execution module able to run a DNN kernel (host CPU
or accelerator cluster).  Each device carries the paper's analytical-model
parameters: ``alpha`` — time per arithmetic operation (inverse of peak
ops/cycle, §3.1 Eq. 2) — plus its private L1 scratchpad size and DMA
bandwidth.  The :class:`SoC` adds the shared L2 scratchpad, the L3 (off-chip)
memory, the system DMA used for L2<->L3 transfers, and the mailbox/interrupt
dispatch latency that the asynchronous runtime pays per task (§3.3).

All times are in cycles; all sizes in bytes; bandwidths in bytes/cycle.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class MemoryLevel:
    name: str
    size: int                      # bytes (L3 may be effectively unbounded)
    bandwidth: float               # bytes / cycle into or out of this level


@dataclasses.dataclass(frozen=True)
class Device:
    name: str
    alpha: float                   # cycles per arithmetic op (1/peak)
    l1: MemoryLevel                # private scratchpad
    dma_bandwidth: float           # L2 <-> L1 DMA, bytes/cycle
    is_host: bool = False
    # bytes/cycle this device can memcpy for helper ops (slice / concat);
    # helpers always run on the host in the paper's runtime.
    copy_bandwidth: float = 8.0


@dataclasses.dataclass(frozen=True)
class SoC:
    name: str
    devices: Dict[str, Device]
    l2: MemoryLevel
    l3: MemoryLevel
    dma_l3_bandwidth: float        # system DMA, L2 <-> L3, bytes/cycle
    mailbox_latency: float = 200.0  # host->device task dispatch, cycles
    freq_mhz: float = 50.0         # Carfield FPGA clock in the paper

    @property
    def host(self) -> Device:
        for d in self.devices.values():
            if d.is_host:
                return d
        raise ValueError("SoC has no host device")

    @property
    def accelerators(self) -> List[Device]:
        return [d for d in self.devices.values() if not d.is_host]

    def device(self, name: str) -> Device:
        return self.devices[name]

    def cycles_to_ms(self, cycles: float) -> float:
        return cycles / (self.freq_mhz * 1e3)
