"""Synthetic SoC presets + model builders for contention studies.

Shared by ``tests/test_retile_contention.py`` and
``benchmarks.multi_tenant.run_forced_contention`` so the forced-contention
scenario (devices, etas, L2 size, model shapes) cannot silently diverge
between the test that proves the claim and the benchmark that reports it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.core.ir import Graph
from repro_torch.core.patterns import Pattern, chain, wildcard
from repro_torch.soc.device import Device, MemoryLevel, SoC

KiB = 1024


def dense_chain(name: str, widths: Sequence[int]) -> Graph:
    """A dense+relu chain ``widths[0] -> widths[1] -> ...`` (fp16)."""
    g = Graph(name)
    x = g.add_input("x", (1, widths[0]), "float16")
    cin = widths[0]
    for i, cout in enumerate(widths[1:]):
        w = g.add_param(f"l{i}_w", (cin, cout), "float16")
        x = g.add_op("dense", [x, w], name=f"l{i}")
        x = g.add_op("relu", [x], name=f"l{i}_r")
        cin = cout
    g.mark_output(x)
    return g


def two_acc_soc(l2_kib: int, dma_l3_bw: float
                ) -> Tuple[SoC, List[Pattern]]:
    """Host + two accelerators that both prefer the same kernels (acc0 is
    the faster one) — the HaX-CoNN-style contention scenario where every
    tenant's compile-alone tiling piles onto the same devices."""
    host = Device("host", 2.0, MemoryLevel("hl1", 32 * KiB, 8.0), 8.0,
                  is_host=True, copy_bandwidth=1.0)
    acc0 = Device("acc0", 0.5, MemoryLevel("al1", 64 * KiB, 16.0), 8.0)
    acc1 = Device("acc1", 0.5, MemoryLevel("bl1", 64 * KiB, 16.0), 8.0)
    pats = [chain("acc0", "a_d", ["dense"], 0.60, 200.0),
            chain("acc0", "a_dr", ["dense", "relu"], 0.60, 200.0),
            chain("acc1", "b_d", ["dense"], 0.45, 200.0),
            chain("acc1", "b_dr", ["dense", "relu"], 0.45, 200.0),
            wildcard("host", eta=0.2, delta=100.0)]
    soc = SoC("tiny2acc", {"host": host, "acc0": acc0, "acc1": acc1},
              l2=MemoryLevel("l2", l2_kib * KiB, 16.0),
              l3=MemoryLevel("l3", 64 * 1024 * KiB, 8.0),
              dma_l3_bandwidth=dma_l3_bw, mailbox_latency=100.0,
              freq_mhz=50.0)
    return soc, pats


def gelu_chain(name: str, widths: Sequence[int]) -> Graph:
    """A dense+gelu chain — the DSP-leaning twin of :func:`dense_chain`
    on :func:`hetero_soc` (the NPU there has no gelu kernel)."""
    g = Graph(name)
    x = g.add_input("x", (1, widths[0]), "float16")
    cin = widths[0]
    for i, cout in enumerate(widths[1:]):
        w = g.add_param(f"l{i}_w", (cin, cout), "float16")
        x = g.add_op("dense", [x, w], name=f"l{i}")
        x = g.add_op("gelu", [x], name=f"l{i}_g")
        cin = cout
    g.mark_output(x)
    return g


def hetero_soc(l2_kib: int, dma_l3_bw: float
               ) -> Tuple[SoC, List[Pattern]]:
    """Host + two *specialized* accelerators: the NPU runs dense/relu
    chains fast and has no gelu kernel; the DSP fuses dense+gelu fast
    but is weak at bare dense.  Dense+relu tenants are NPU-dominant,
    dense+gelu tenants DSP-dominant — the split-affinity mix the
    decomposed solver clusters on (``two_acc_soc`` is symmetric, so
    every tenant there shares one dominant device)."""
    host = Device("host", 2.0, MemoryLevel("hl1", 32 * KiB, 8.0), 8.0,
                  is_host=True, copy_bandwidth=1.0)
    npu = Device("npu", 0.5, MemoryLevel("nl1", 64 * KiB, 16.0), 8.0)
    dsp = Device("dsp", 0.5, MemoryLevel("dl1", 64 * KiB, 16.0), 8.0)
    pats = [chain("npu", "n_d", ["dense"], 0.60, 200.0),
            chain("npu", "n_dr", ["dense", "relu"], 0.60, 200.0),
            chain("dsp", "d_d", ["dense"], 0.30, 200.0),
            chain("dsp", "d_dg", ["dense", "gelu"], 0.60, 200.0),
            chain("dsp", "d_g", ["gelu"], 0.60, 150.0),
            wildcard("host", eta=0.2, delta=100.0)]
    soc = SoC("tinyhet", {"host": host, "npu": npu, "dsp": dsp},
              l2=MemoryLevel("l2", l2_kib * KiB, 16.0),
              l3=MemoryLevel("l3", 64 * 1024 * KiB, 8.0),
              dma_l3_bandwidth=dma_l3_bw, mailbox_latency=100.0,
              freq_mhz=50.0)
    return soc, pats


def hetero_setup(n_tenants: int = 4, widths: Sequence[int] = (64,) * 4,
                 l2_kib: int = 96, dma_l3_bw: float = 12.0):
    """Alternating dense/gelu tenants on :func:`hetero_soc` — the
    smallest mix whose affinity clustering is non-degenerate."""
    soc, pats = hetero_soc(l2_kib, dma_l3_bw)
    graphs = []
    for i in range(n_tenants):
        mk = dense_chain if i % 2 == 0 else gelu_chain
        graphs.append(mk(f"t{i}", list(widths)))
    return soc, pats, graphs


# the forced-contention preset: a shared L2 that holds only ~3 of the
# 18 KiB weight tensors cycled by two 7-layer tenants
FORCED_L2_KIB = 56
FORCED_DMA_BW = 12.0
FORCED_WIDTHS = [96] * 8


def forced_contention_setup():
    soc, pats = two_acc_soc(FORCED_L2_KIB, FORCED_DMA_BW)
    graphs = [dense_chain("a", FORCED_WIDTHS),
              dense_chain("b", FORCED_WIDTHS)]
    return soc, pats, graphs
