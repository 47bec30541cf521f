"""Device-level mapping: LOMA-style L1<->L2 loop tiling & ordering (§3.2).

Operators assigned to an accelerator frequently cannot place all working
data in the device's L1 scratchpad, so an additional tiling level between
L1 and L2 is applied.  Following ZigZag-LOMA we enumerate loop *orders* and
*tile factors*, evaluate each with an analytical cost model (compute cycles
vs. DMA traffic per memory level), keep only candidates whose L1 footprint
fits (with double buffering), and return the cheapest mapping.  The refined
per-node latency (compute + L2<->L1 DMA, serialized per the paper's current
model) feeds the global scheduler.

Loop nest model for a fused chain supernode over a tile segment:
    for s in range(Fs):         # spatial sub-tiles (rows / neurons)
      for k in range(Fk):       # output-channel / neuron blocks
        load inputs/weights as dictated by the loop order; compute; store
Two canonical orders:
  * "ws" (weight-stationary, k outer):  weights streamed once, activations
    reloaded per k-block:   traffic = W + Fk * I + O
  * "os" (output-stationary, s outer):  activations streamed once, weights
    reloaded per s-block:   traffic = I + Fs * W + O
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.ir import Graph, op_arith
from repro_torch.core.rewrite import Supernode
from repro_torch.soc.device import Device, SoC

_FACTORS = (1, 2, 4, 8, 16, 32, 64)


@dataclasses.dataclass(frozen=True)
class Mapping:
    order: str                 # "ws" | "os"
    f_spatial: int
    f_channel: int
    l1_footprint: int
    compute_cycles: float
    dma_cycles: float

    @property
    def latency(self) -> float:
        # DMA serialized with compute in the paper's current model (§3.2).
        return self.compute_cycles + self.dma_cycles


def _chain_bytes(g: Graph, sn: Supernode) -> Tuple[float, float, float]:
    """(input, weight, output) bytes touched by this supernode's segment.

    Row-tiled chains (conv family) read a row slice of the input but the
    *full* weights; neuron-tiled chains (dense/matmul, tiled on the output
    feature axis) read the full input but only their *weight column slice*
    (the tiling folds into the offline weight layout, §4)."""
    from repro_torch.core.ir import tile_axis
    frac = sn.tiles / sn.T
    head = g.ops[sn.op_names[0]]
    tail = g.ops[sn.op_names[-1]]
    ax = tile_axis(g, head)
    out_rank = len(g.tensors[head.output].shape)
    neuron = ax is not None and ax == out_rank - 1
    in_b = sum(t.bytes for t in g.act_inputs(head)) * (1.0 if neuron else frac)
    w_b = 0.0
    for name in sn.op_names:
        w_b += sum(t.bytes for t in g.param_tensors(g.ops[name]))
    if neuron:
        w_b *= frac
    out_b = g.tensors[tail.output].bytes * frac
    return in_b, w_b, out_b


def map_supernode(g: Graph, sn: Supernode, soc: SoC,
                  eta: Optional[float] = None) -> Mapping:
    """Pick the cheapest (order, tile factors) for a supernode on its device."""
    dev = soc.device(sn.device)
    eta = eta if eta is not None else sn.match.pattern.eta
    arith = sum(op_arith(g, g.ops[name]) for name in sn.op_names) \
        * sn.tiles / sn.T
    compute = arith * dev.alpha / eta
    in_b, w_b, out_b = _chain_bytes(g, sn)
    l1_budget = dev.l1.size * 0.5          # double buffering
    best: Optional[Mapping] = None
    for fs in _FACTORS:
        if fs > max(sn.tiles, 1):
            continue
        for fk in _FACTORS:
            foot = in_b / fs + w_b / fk + out_b / (fs * fk)
            if foot > l1_budget:
                continue
            for order in ("ws", "os"):
                if order == "ws":
                    traffic = w_b + fk * in_b + out_b
                else:
                    traffic = in_b + fs * w_b + out_b
                dma = traffic / dev.dma_bandwidth
                cand = Mapping(order, fs, fk, int(foot), compute, dma)
                if best is None or cand.latency < best.latency:
                    best = cand
    if best is None:
        # even the finest tiling does not fit: stream at worst-case reload
        fs, fk = _FACTORS[-1], _FACTORS[-1]
        traffic = in_b * fk + w_b * fs + out_b
        best = Mapping("os", fs, fk, int(dev.l1.size),
                       compute, traffic / dev.dma_bandwidth)
    return best


def refine_latency(g: Graph, sn: Supernode, soc: SoC) -> float:
    """Refined node latency = mapped compute+DMA + fixed invocation cost."""
    m = map_supernode(g, sn, soc)
    return m.latency + sn.match.pattern.delta


def refined_tile_slope(g: Graph, op_names, device: str, eta: float, T: int,
                       soc: SoC, dma_scale: float = 1.0) -> float:
    """Per-tile refined latency (cycles/tile) for a fused chain at full
    coverage — the ZigZag-informed slope the stage-1 CP prices Eq. (2) with.
    Stays linear in the tile count, which keeps the CP tractable (§3.1).

    ``dma_scale`` >= 1 inflates the traffic term only: in a multi-tenant
    co-compile the shared memory system carries the co-residents' traffic
    too, so effective DMA bandwidth shrinks while compute is unaffected —
    the mapping choice then re-balances toward lower-traffic tilings."""
    from repro_torch.core.ir import tile_axis
    dev = soc.device(device)
    arith = sum(op_arith(g, g.ops[n]) for n in op_names)
    compute = arith * dev.alpha / eta
    head = g.ops[op_names[0]]
    tail = g.ops[op_names[-1]]
    in_b = float(sum(t.bytes for t in g.act_inputs(head)))
    w_b = float(sum(sum(t.bytes for t in g.param_tensors(g.ops[n]))
                    for n in op_names))
    out_b = float(g.tensors[tail.output].bytes)
    l1_budget = dev.l1.size * 0.5
    best = None
    for fs in _FACTORS:
        for fk in _FACTORS:
            foot = in_b / fs + w_b / fk + out_b / (fs * fk)
            if foot > l1_budget:
                continue
            for order in ("ws", "os"):
                traffic = (w_b + fk * in_b + out_b) if order == "ws" \
                    else (in_b + fs * w_b + out_b)
                lat = compute + dma_scale * traffic / dev.dma_bandwidth
                if best is None or lat < best:
                    best = lat
    if best is None:
        traffic = in_b * _FACTORS[-1] + w_b * _FACTORS[-1] + out_b
        best = compute + dma_scale * traffic / dev.dma_bandwidth
    return best / T
