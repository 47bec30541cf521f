"""Carfield HSoC platform preset (paper §4, Fig. 5) with its kernel catalogue.

Configuration used in the paper's experiments:
  * host: Cheshire dual-core RV64GCH CPU,
  * PULP cluster: 8x RI5CY RV32 cores with FP16 SIMD, 256 KiB L1 + DMA,
  * Spatz cluster: 2x RVV vector units (VLEN=512, FP16 sdotp), 128 KiB L1 + DMA,
  * 1 MiB shared L2 scratchpad (128-bit data path), DRAM L3 behind a system
    DMA on a 64-bit AXI4 bus, 50 MHz FPGA clock, FP16 data.

Calibration.  ``alpha`` is cycles-per-arithmetic-op at the device's nominal
sustained rate; ``eta`` is the per-pattern kernel efficiency (it absorbs the
short-vector / small-geometry stalls of batch-1 edge inference), ``delta``
the fixed per-invocation overhead (task descriptor, mailbox, L1 DMA setup).
The products are fitted to the paper's measured Table-2 landing zones:

    effective cycles/op        host(TVM)   Spatz      PULP
    dense (batch-1 GEMV)         ~9.3       ~1.86      ~3.6
    conv2d (im2col GEMM)         ~7.7       ~0.86      ~1.85
    dwconv2d (short vectors)     ~10        ~6.0       ~2.2

e.g. MLPerf-Tiny AutoEncoder on MATCH = 0.54 Mops x 1.86 + L1-DMA ~= 1.0 M
cycles = the paper's 20.1 ms at 50 MHz.  Host slice/concat helpers copy at
~0.22 B/cycle (scalar per-element fp16 copies, ~9 cycles/element) — this is
what makes row-tiling unprofitable for the depthwise-dominated DS-CNN and
MobileNet (Table 2) while remaining profitable for ResNet-class layers.
"""

from __future__ import annotations

from typing import List

from repro_torch.core.patterns import Pattern, chain, wildcard
from repro_torch.soc.device import Device, MemoryLevel, SoC

KiB = 1024
MiB = 1024 * KiB

HOST, PULP, SPATZ = "host", "pulp", "spatz"


def carfield_soc() -> SoC:
    host = Device(
        name=HOST, alpha=2.0,
        l1=MemoryLevel("host_l1", 64 * KiB, 8.0),
        dma_bandwidth=8.0, is_host=True, copy_bandwidth=0.22)
    pulp = Device(
        name=PULP, alpha=1.2,            # 8 RI5CY cores, fp16 SIMD sustained
        l1=MemoryLevel("pulp_l1", 256 * KiB, 16.0),
        dma_bandwidth=8.0)
    spatz = Device(
        name=SPATZ, alpha=0.6,           # 2 RVVUs, VLEN=512 fp16 + sdotp
        l1=MemoryLevel("spatz_l1", 128 * KiB, 16.0),
        dma_bandwidth=8.0)
    return SoC(
        name="carfield",
        devices={HOST: host, PULP: pulp, SPATZ: spatz},
        l2=MemoryLevel("l2", 1 * MiB, 16.0),     # 128-bit per cycle
        l3=MemoryLevel("l3", 128 * MiB, 8.0),    # 64-bit AXI DRAM
        dma_l3_bandwidth=8.0,
        mailbox_latency=200.0,
        freq_mhz=50.0)


# Per-device fused-pattern efficiencies.  Chains share the anchor op's eta
# (fusing the cheap epilogue into the kernel is what the eta measures).
_PULP = {
    "conv2d": 0.65, "dwconv2d": 0.55, "dense": 0.33,
    "matmul": 0.33, "batch_matmul": 0.30,
    "add": 0.50, "avg_pool2d": 0.50, "max_pool2d": 0.50,
}
_SPATZ = {
    "conv2d": 0.70, "dwconv2d": 0.10, "dense": 0.33,
    "matmul": 0.33, "batch_matmul": 0.30,
    "add": 0.50, "avg_pool2d": 0.40, "max_pool2d": 0.40,
}
# host TVM kernels: per-op-type single patterns beat the generic wildcard
_HOST = {
    "conv2d": 0.26, "dwconv2d": 0.20, "dense": 0.215,
    "matmul": 0.215, "batch_matmul": 0.10,
}

_EPILOGUES = {
    "conv2d": [["relu"], ["bias_add"], ["bias_add", "relu"], ["add"],
               ["add", "relu"], ["bias_add", "add", "relu"]],
    "dwconv2d": [["relu"], ["bias_add"], ["bias_add", "relu"]],
    "dense": [["relu"], ["bias_add"], ["bias_add", "relu"]],
    "matmul": [],
    "batch_matmul": [],
    "add": [["relu"]],
    "avg_pool2d": [],
    "max_pool2d": [],
}

D_ACC = 1500.0      # per-invocation overhead on an accelerator (cycles)
D_HOST = 300.0


def _device_patterns(dev: str, etas) -> List[Pattern]:
    ps: List[Pattern] = []
    for anchor, eta in etas.items():
        ps.append(chain(dev, f"{dev}_{anchor}", [anchor], eta, D_ACC))
        for epi in _EPILOGUES.get(anchor, []):
            name = f"{dev}_{anchor}_" + "_".join(epi)
            ps.append(chain(dev, name, [anchor] + epi, eta, D_ACC))
    return ps


def carfield_patterns() -> List[Pattern]:
    """Kernel/pattern catalogue shared by all evaluated toolchains (§4)."""
    ps: List[Pattern] = []
    ps += _device_patterns(PULP, _PULP)
    ps += _device_patterns(SPATZ, _SPATZ)
    # host TVM kernels (fused epilogues too) + the completeness wildcard
    for anchor, eta in _HOST.items():
        ps.append(chain(HOST, f"host_{anchor}", [anchor], eta, D_HOST))
        for epi in _EPILOGUES.get(anchor, []):
            name = f"host_{anchor}_" + "_".join(epi)
            ps.append(chain(HOST, name, [anchor] + epi, eta, D_HOST))
    ps.append(wildcard(HOST, eta=0.25, delta=D_HOST))
    return ps
