"""Memory planning: 2-D bin packing (time x address) over L2/L3 (§3.2).

Tensor lifetimes induce temporal occupancy intervals in the 1 MiB shared L2
scratchpad; the planner chooses per-tensor strategies —
  (i)   *static*: persistent L2 residence,
  (ii)  *dynamic with swap*: evict an intermediate to L3 after production and
        reload it before its next use,
  (iii) *planned loading*: stream a parameter tensor from L3 on demand —
and assigns concrete addresses with a first-fit free-list allocator.  DMA
transfers created by (ii)/(iii) are returned to the scheduler, which
serializes them on the system DMA engine and accounts for them in the
makespan (the paper's current model does not overlap DMA with compute).

The resulting plan is a set of ``(tensor, address, size, t_alloc, t_free)``
rectangles; :func:`validate_plan` asserts the packing is overlap-free, which
is property-tested.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

ALIGN = 64


@dataclasses.dataclass
class Allocation:
    tensor: str
    addr: int
    size: int
    t_alloc: float
    t_free: float = float("inf")
    level: str = "l2"
    strategy: str = "dynamic"     # "static" | "dynamic" | "planned"
    owner: int = 0                # tenant id (0 for single-model plans)


@dataclasses.dataclass
class SwapOp:
    tensor: str
    direction: str                # "out" (L2->L3) | "in" (L3->L2)
    bytes: int
    time: float                   # scheduler fills the actual DMA window


class L2Allocator:
    """First-fit free-list allocator with full rectangle logging."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._free: List[Tuple[int, int]] = [(0, capacity)]  # (addr, size)
        self.live: Dict[str, Allocation] = {}
        self.history: List[Allocation] = []
        self.peak = 0
        self._used = 0
        # capacity-forced swap-outs; incremented by the scheduler each time
        # it evicts a victim to satisfy a reservation (the contention metric
        # the multi-tenant benchmark reports)
        self.evictions = 0

    def used(self) -> int:
        return self._used

    def can_fit(self, size: int) -> bool:
        size = _align(size)
        return any(s >= size for _, s in self._free)

    def alloc(self, tensor: str, size: int, now: float,
              strategy: str = "dynamic") -> Optional[Allocation]:
        size = _align(size)
        for i, (addr, s) in enumerate(self._free):
            if s >= size:
                if s == size:
                    self._free.pop(i)
                else:
                    self._free[i] = (addr + size, s - size)
                a = Allocation(tensor, addr, size, now, strategy=strategy)
                self.live[tensor] = a
                self._used += size
                self.peak = max(self.peak, self._used)
                return a
        return None

    def free(self, tensor: str, now: float) -> None:
        a = self.live.pop(tensor, None)
        if a is None:
            return
        a.t_free = now
        self.history.append(a)
        self._used -= a.size
        self._insert_free(a.addr, a.size)

    def _insert_free(self, addr: int, size: int) -> None:
        self._free.append((addr, size))
        self._free.sort()
        merged: List[Tuple[int, int]] = []
        for a, s in self._free:
            if merged and merged[-1][0] + merged[-1][1] == a:
                merged[-1] = (merged[-1][0], merged[-1][1] + s)
            else:
                merged.append((a, s))
        self._free = merged

    def eviction_candidates(self, protect: set) -> List[str]:
        return [t for t, a in self.live.items()
                if t not in protect and a.strategy != "static"]

    def segments_assuming_freed(self, victims: List[str]
                                ) -> List[Tuple[int, int]]:
        """Free list that *would* result from freeing ``victims`` (no
        mutation) — used for transactional feasibility checks."""
        segs = list(self._free)
        for v in victims:
            a = self.live.get(v)
            if a is not None:
                segs.append((a.addr, a.size))
        segs.sort()
        merged: List[Tuple[int, int]] = []
        for addr, s in segs:
            if merged and merged[-1][0] + merged[-1][1] == addr:
                merged[-1] = (merged[-1][0], merged[-1][1] + s)
            else:
                merged.append((addr, s))
        return merged

    @staticmethod
    def fits_all(segments: List[Tuple[int, int]], sizes: List[int]) -> bool:
        """First-fit simulation: can all ``sizes`` be placed into the given
        free segments (allocated in order)?"""
        segs = [list(s) for s in segments]
        for size in sizes:
            size = _align(size)
            for seg in segs:
                if seg[1] >= size:
                    seg[0] += size
                    seg[1] -= size
                    break
            else:
                return False
        return True

    def finish(self, now: float) -> None:
        for t in list(self.live):
            self.free(t, now)


class SharedL2Allocator(L2Allocator):
    """Multi-tenant first-fit allocator over ONE shared L2 scratchpad.

    Each tenant (co-scheduled model) gets a soft byte *budget*; any tenant
    may temporarily exceed it when free space exists, but under contention
    the eviction order is aware of budgets: victims are drawn first from
    tenants that are over budget (excluding the requester), largest-first,
    so one memory-hungry model cannot starve its co-residents (cf. the
    contention-aware policies of Dagli & Belviranli, arXiv:2308.05869).
    """

    def __init__(self, capacity: int, budgets: List[int]) -> None:
        super().__init__(capacity)
        self.budgets = list(budgets)
        self.used_by = [0] * len(self.budgets)

    def alloc(self, tensor: str, size: int, now: float,
              strategy: str = "dynamic", owner: int = 0
              ) -> Optional[Allocation]:
        a = super().alloc(tensor, size, now, strategy)
        if a is not None:
            a.owner = owner
            self.used_by[owner] += a.size
        return a

    def free(self, tensor: str, now: float) -> None:
        a = self.live.get(tensor)
        if a is not None:
            self.used_by[a.owner] -= a.size
        super().free(tensor, now)

    def over_budget(self, owner: int) -> int:
        return self.used_by[owner] - self.budgets[owner]

    def eviction_candidates(self, protect: set,
                            requester: Optional[int] = None) -> List[str]:
        cands = super().eviction_candidates(protect)
        if requester is None:
            return cands

        def key(t: str):
            a = self.live[t]
            foreign_over = (a.owner != requester
                            and self.over_budget(a.owner) > 0)
            return (0 if foreign_over else 1, -a.size, t)

        return sorted(cands, key=key)


def _align(size: int) -> int:
    return (max(int(size), 1) + ALIGN - 1) // ALIGN * ALIGN


@dataclasses.dataclass
class AllocEvent:
    """One tensor residency interval in L2 (before address assignment)."""
    tensor: str
    size: int
    t_alloc: float
    t_free: float
    strategy: str


def assign_addresses(events: List[AllocEvent], capacity: int
                     ) -> List[Allocation]:
    """Offline 2-D packing: given residency rectangles (size x [t_alloc,
    t_free)), assign concrete L2 addresses with time-aware first-fit (the
    classic offline dynamic-storage-allocation greedy, cf. TelaMalloc).
    Raises if a rectangle cannot be placed."""
    placed: List[Allocation] = []
    for e in sorted(events, key=lambda e: (e.t_alloc, -e.size)):
        size = _align(e.size)
        blockers = sorted(
            (a for a in placed
             if a.t_alloc < e.t_free and e.t_alloc < a.t_free),
            key=lambda a: a.addr)
        addr = 0
        for b in blockers:
            if addr + size <= b.addr:
                break
            addr = max(addr, b.addr + b.size)
        if addr + size > capacity:
            raise MemoryError(
                f"L2 packing failed for {e.tensor} ({size} B at t="
                f"{e.t_alloc:.0f}; capacity {capacity} B)")
        placed.append(Allocation(e.tensor, addr, size, e.t_alloc, e.t_free,
                                 strategy=e.strategy))
    return placed


@dataclasses.dataclass
class MemoryPlan:
    capacity: int
    allocations: List[Allocation]
    swaps: List[SwapOp]
    peak: int
    evictions: int = 0            # capacity-forced swap-outs (L2 -> L3)

    def static_tensors(self) -> List[str]:
        return [a.tensor for a in self.allocations if a.strategy == "static"]


def validate_plan(plan: MemoryPlan) -> List[str]:
    """Returns a list of violations (empty == valid packing).

    A thin shim over the static plan analyzer's PA005 aliasing rule
    (:func:`repro.analysis.analyze_memory`): a sweep-line over the
    allocation rectangles flags address overlap between concurrently-live
    allocations and out-of-L2-range placements.  Historically this
    checker used strict inequalities for the time overlap while the
    schedule validators allowed ``1e-6`` slack; all three now share the
    analyzer's single ``TIME_EPS``."""
    from repro_torch.analysis import analyze_errors
    return [str(d) for d in analyze_errors(plan)]
