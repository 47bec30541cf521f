"""Static race/hazard analyzer over emitted execution plans.

Runs linter-style rules (``PA001``..``PA008``, see
:mod:`repro.analysis.diagnostics`) against a single-model
``ExecutionPlan``, a multi-tenant ``MultiExecutionPlan``, or a bare
``MemoryPlan``.  The analyzer is deliberately *duck-typed* — it reads
only plain plan attributes (``nodes``, ``dmas``, ``memory``,
``tenants``, ``budgets``, ...) and never imports the scheduler, so
``core.schedule`` / ``core.memplan`` can call it from their legacy
validator shims without an import cycle.

Why a static pass at all: the analytic simulator produces correct
*numerics* even for a racy plan (it executes tenants' kernels in
dependency order on the host), so a plan whose DMA windows or L2
residency rectangles are subtly wrong still passes bitwise-equality
tests — and would corrupt memory on metal once the codegen backend
(ROADMAP item 5) replays the plan's DMA descriptors and L2 offsets
verbatim.  Every structural property the backend will rely on is
checked here.

Conventions shared by all rules:

* time intervals are half-open ``[start, end)`` in cycles, compared
  with the single ``TIME_EPS`` slack;
* *streamed* tensors — L3-resident operands accessed via planned
  loading (``PlanNode.l3_traffic``) — never occupy L2, and sibling tile
  kernels stream disjoint byte ranges of the same tensor concurrently
  by construction, so the L2-residency rules (PA003/PA004/PA008) exempt
  them;
* nodes that were never scheduled (``start < -0.5``) are reported under
  PA007 and skipped by the timing rules.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.diagnostics import (TIME_EPS, Diagnostic, Severity,
                                        errors_only)

#: The single system DMA engine's resource name (mirrors
#: ``schedule.DMA`` without importing the scheduler).
DMA = "dma"

#: Single-model plan modes that promise global sequential execution.
SEQUENTIAL_MODES = ("tvm", "match")


def _overlap(a0: float, a1: float, b0: float, b1: float) -> bool:
    """Half-open interval conflict with ``TIME_EPS`` slack."""
    return a0 < b1 - TIME_EPS and b0 < a1 - TIME_EPS


def _scheduled(nodes) -> list:
    return [n for n in nodes.values() if n.start >= -0.5]


def _streamed_tensors(nodes) -> Set[str]:
    """Tensors accessed via planned loading (never L2-resident)."""
    out: Set[str] = set()
    for n in nodes.values():
        for t, _dirn, _b in n.l3_traffic:
            out.add(t)
    return out


def _tenant_of(name: str) -> Optional[int]:
    """Tenant index from a namespaced ``t{i}/...`` name, else None."""
    if name.startswith("t"):
        head, sep, _ = name.partition("/")
        if sep and head[1:].isdigit():
            return int(head[1:])
    return None


# ---------------------------------------------------------------------------
# PA007 — DAG shape (checked first: the other rules assume a sane DAG)
# ---------------------------------------------------------------------------


def _check_dag(nodes) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    indeg: Dict[str, int] = {k: 0 for k in nodes}
    succs: Dict[str, List[str]] = {k: [] for k in nodes}
    for n in nodes.values():
        for p in n.preds:
            if p not in nodes:
                diags.append(Diagnostic(
                    "PA007", Severity.ERROR,
                    f"{n.name}: predecessor {p!r} is not in the plan",
                    nodes=(n.name, p)))
                continue
            indeg[n.name] += 1
            succs[p].append(n.name)
    # Kahn's algorithm: whatever survives is on (or downstream of) a cycle
    queue = [k for k, d in indeg.items() if d == 0]
    seen = 0
    while queue:
        k = queue.pop()
        seen += 1
        for s in succs[k]:
            indeg[s] -= 1
            if indeg[s] == 0:
                queue.append(s)
    if seen != len(nodes):
        cyclic = sorted(k for k, d in indeg.items() if d > 0)
        diags.append(Diagnostic(
            "PA007", Severity.ERROR,
            f"dependency cycle through {len(cyclic)} node(s): "
            f"{', '.join(cyclic[:6])}{'...' if len(cyclic) > 6 else ''}",
            nodes=tuple(cyclic)))
    for n in nodes.values():
        if n.start < -0.5:
            diags.append(Diagnostic(
                "PA007", Severity.ERROR, f"{n.name}: never scheduled",
                nodes=(n.name,)))
    return diags


# ---------------------------------------------------------------------------
# PA001 — precedence
# ---------------------------------------------------------------------------


def _check_precedence(nodes, makespan: Optional[float],
                      tenant_makespans: Optional[Sequence[float]]
                      ) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    for n in _scheduled(nodes):
        for p in n.preds:
            pn = nodes.get(p)
            if pn is None or pn.start < -0.5:
                continue                      # PA007's finding, not ours
            if pn.end > n.start + TIME_EPS:
                diags.append(Diagnostic(
                    "PA001", Severity.ERROR,
                    f"precedence: {p} ends at {pn.end:.1f} after "
                    f"{n.name} starts at {n.start:.1f}",
                    nodes=(p, n.name), window=(n.start, pn.end)))
    if makespan is not None and tenant_makespans is not None:
        for i, tm in enumerate(tenant_makespans):
            if tm > makespan + TIME_EPS:
                diags.append(Diagnostic(
                    "PA001", Severity.ERROR,
                    f"tenant {i} finishes at {tm:.1f} after the global "
                    f"makespan {makespan:.1f}", tenant=i))
    return diags


# ---------------------------------------------------------------------------
# PA002 — exclusive-resource overlap
# ---------------------------------------------------------------------------


def _check_resources(nodes, dmas, mode: str) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    by_res: Dict[str, List[Tuple[float, float, str]]] = {}
    for n in _scheduled(nodes):
        by_res.setdefault(n.resource, []).append((n.start, n.end, n.name))
    # inline transfers (swaps, reloads, planned-loading streams) share the
    # single engine with explicit load/store nodes
    for d in dmas:
        by_res.setdefault(DMA, []).append(
            (d.start, d.end, f"dma:{d.tensor}:{d.direction}@{d.start:.0f}"))
    for r, ivs in by_res.items():
        ivs.sort()
        for a, b in zip(ivs, ivs[1:]):
            if _overlap(a[0], a[1], b[0], b[1]):
                diags.append(Diagnostic(
                    "PA002", Severity.ERROR,
                    f"resource {r}: {a[2]} overlaps {b[2]}",
                    nodes=(a[2], b[2]), resource=r,
                    window=(b[0], min(a[1], b[1]))))
    if mode in SEQUENTIAL_MODES:
        comp = sorted((n.start, n.end, n.name) for n in _scheduled(nodes)
                      if n.resource != DMA)
        for a, b in zip(comp, comp[1:]):
            if _overlap(a[0], a[1], b[0], b[1]):
                diags.append(Diagnostic(
                    "PA002", Severity.ERROR,
                    f"sequential mode overlap: {a[2]} / {b[2]}",
                    nodes=(a[2], b[2])))
    return diags


# ---------------------------------------------------------------------------
# PA003 — DMA / compute data hazards on L2 tensors
# ---------------------------------------------------------------------------


def _check_data_hazards(nodes, dmas, streamed: Set[str]
                        ) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    by_tensor: Dict[str, List] = {}
    for d in dmas:
        if d.tensor not in streamed:
            by_tensor.setdefault(d.tensor, []).append(d)
    if not by_tensor:
        return diags
    for n in _scheduled(nodes):
        for kind, tensors in (("reads", n.reads), ("writes", n.writes)):
            for t in tensors:
                for d in by_tensor.get(t, ()):
                    if not _overlap(n.start, n.end, d.start, d.end):
                        continue
                    hazard = {("reads", "out"): "WAR (swap-out mid-read)",
                              ("reads", "in"): "RAW (load mid-read)",
                              ("writes", "in"): "WAW (load mid-write)",
                              ("writes", "out"): "WAR (swap-out mid-write)",
                              }[(kind, d.direction)]
                    diags.append(Diagnostic(
                        "PA003", Severity.ERROR,
                        f"{hazard}: dma {d.direction} of {t} "
                        f"[{d.start:.1f}, {d.end:.1f}) overlaps {n.name} "
                        f"{kind[:-1]}ing it over [{n.start:.1f}, "
                        f"{n.end:.1f})",
                        nodes=(n.name,), tensors=(t,),
                        window=(max(n.start, d.start),
                                min(n.end, d.end))))
    return diags


# ---------------------------------------------------------------------------
# PA004 / PA008 — L2 residency discipline
# ---------------------------------------------------------------------------


def _rects_by_tensor(memory) -> Dict[str, List]:
    out: Dict[str, List] = {}
    for a in memory.allocations:
        out.setdefault(a.tensor, []).append(a)
    return out


def _covered(rects, t0: float, t1: float) -> bool:
    return any(a.t_alloc - TIME_EPS <= t0 and t1 <= a.t_free + TIME_EPS
               for a in rects)


def _check_residency(nodes, memory, streamed: Set[str]
                     ) -> List[Diagnostic]:
    """PA004: every L2 access window of a node must fall inside one of the
    tensor's residency rectangles (use-after-evict otherwise)."""
    diags: List[Diagnostic] = []
    rects = _rects_by_tensor(memory)
    for n in _scheduled(nodes):
        for kind, tensors in (("read", n.reads), ("write", n.writes)):
            for t in tensors:
                if t in streamed:
                    continue                 # planned loading: lives in L3
                rs = rects.get(t)
                if not rs:
                    diags.append(Diagnostic(
                        "PA004", Severity.ERROR,
                        f"{n.name} {kind}s {t}, which is never "
                        f"L2-resident and not planned-loaded",
                        nodes=(n.name,), tensors=(t,)))
                    continue
                if not _covered(rs, n.start, n.end):
                    diags.append(Diagnostic(
                        "PA004", Severity.ERROR,
                        f"use-after-evict: {n.name} {kind}s {t} over "
                        f"[{n.start:.1f}, {n.end:.1f}) outside its "
                        f"residency windows "
                        f"{[(round(a.t_alloc, 1), round(a.t_free, 1)) for a in rs]}",
                        nodes=(n.name,), tensors=(t,),
                        window=(n.start, n.end)))
    return diags


def _check_double_buffer(dmas, memory, streamed: Set[str]
                         ) -> List[Diagnostic]:
    """PA008: every DMA transfer of an L2 tensor must land inside one of
    its residency rectangles — an ``in`` transfer outside them overwrites
    a buffer before its allocation opens (or after readers released it),
    an ``out`` transfer outside them reads freed memory."""
    diags: List[Diagnostic] = []
    rects = _rects_by_tensor(memory)
    for d in dmas:
        if d.tensor in streamed:
            continue
        rs = rects.get(d.tensor)
        if rs and _covered(rs, d.start, d.end):
            continue
        verb = ("overwrites" if d.direction == "in" else "reads")
        diags.append(Diagnostic(
            "PA008", Severity.ERROR,
            f"double-buffer: dma {d.direction} of {d.tensor} over "
            f"[{d.start:.1f}, {d.end:.1f}) {verb} L2 outside the "
            f"tensor's residency windows",
            tensors=(d.tensor,), resource=DMA,
            window=(d.start, d.end)))
    return diags


# ---------------------------------------------------------------------------
# PA005 — L2 address aliasing
# ---------------------------------------------------------------------------


def _check_aliasing(memory) -> List[Diagnostic]:
    """Sweep-line over allocation rectangles: any two concurrently-live
    allocations must occupy disjoint address ranges (and every rectangle
    must sit inside the L2)."""
    diags: List[Diagnostic] = []
    allocs = sorted(memory.allocations, key=lambda a: a.t_alloc)
    for a in allocs:
        if a.addr < 0 or a.addr + a.size > memory.capacity:
            diags.append(Diagnostic(
                "PA005", Severity.ERROR,
                f"{a.tensor}: [{a.addr}, {a.addr + a.size}) out of L2 "
                f"range (capacity {memory.capacity} B)",
                tensors=(a.tensor,)))
    active: List = []
    for a in allocs:
        active = [b for b in active if b.t_free > a.t_alloc + TIME_EPS]
        for b in active:
            if a.addr < b.addr + b.size and b.addr < a.addr + a.size:
                diags.append(Diagnostic(
                    "PA005", Severity.ERROR,
                    f"aliasing: {a.tensor} [{a.addr}, "
                    f"{a.addr + a.size}) overlaps {b.tensor} "
                    f"[{b.addr}, {b.addr + b.size}) while both live",
                    tensors=(a.tensor, b.tensor),
                    window=(a.t_alloc, min(a.t_free, b.t_free))))
        active.append(a)
    return diags


# ---------------------------------------------------------------------------
# PA006 — tenant isolation in the shared L2
# ---------------------------------------------------------------------------


def _check_isolation(plan) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    budgets = list(getattr(plan, "budgets", ()) or ())
    n_tenants = len(plan.tenants)
    if budgets and len(budgets) != n_tenants:
        diags.append(Diagnostic(
            "PA006", Severity.ERROR,
            f"{len(budgets)} L2 budgets for {n_tenants} tenants"))
        budgets = []
    for a in plan.memory.allocations:
        ns = _tenant_of(a.tensor)
        if ns is not None and ns != a.owner:
            diags.append(Diagnostic(
                "PA006", Severity.ERROR,
                f"{a.tensor}: allocation owned by tenant {a.owner} but "
                f"namespaced to tenant {ns}",
                tensors=(a.tensor,), tenant=a.owner))
        if ns is None:
            diags.append(Diagnostic(
                "PA006", Severity.ERROR,
                f"{a.tensor}: allocation without a tenant namespace in "
                f"a multi-tenant plan", tensors=(a.tensor,)))
    # budget checks only bind for genuinely co-resident plans: the
    # sequential concat runs each tenant alone against the full L2
    if not budgets or plan.mode == "sequential":
        return diags
    static_by: Dict[int, int] = {}
    events: Dict[int, List[Tuple[float, int]]] = {}
    for a in plan.memory.allocations:
        o = a.owner
        if not (0 <= o < n_tenants):
            diags.append(Diagnostic(
                "PA006", Severity.ERROR,
                f"{a.tensor}: owner {o} is not a tenant index",
                tensors=(a.tensor,)))
            continue
        if a.strategy == "static":
            static_by[o] = static_by.get(o, 0) + a.size
        events.setdefault(o, []).append((a.t_alloc, a.size))
        if a.t_free != float("inf"):
            events[o].append((a.t_free, -a.size))
    for o, s in static_by.items():
        if s > budgets[o]:
            diags.append(Diagnostic(
                "PA006", Severity.ERROR,
                f"tenant {o}: persistent (static) footprint {s} B "
                f"escapes its L2 budget slice ({budgets[o]} B)",
                tenant=o))
    for o, evs in events.items():
        evs.sort(key=lambda e: (e[0], e[1]))
        live = peak = 0
        for _, delta in evs:
            live += delta
            peak = max(peak, live)
        if peak > budgets[o]:
            diags.append(Diagnostic(
                "PA006", Severity.WARNING,
                f"tenant {o}: peak L2 use {peak} B exceeds its soft "
                f"budget ({budgets[o]} B) — allowed under the "
                f"SharedL2Allocator's soft-budget policy, but this "
                f"tenant is squeezing its co-residents", tenant=o))
    return diags


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def analyze_memory(memory) -> List[Diagnostic]:
    """PA005 over a bare ``MemoryPlan`` (the ``validate_plan`` shim)."""
    return _check_aliasing(memory)


def analyze_plan(plan) -> List[Diagnostic]:
    """All rules over a single-model ``ExecutionPlan``."""
    nodes = plan.nodes
    streamed = _streamed_tensors(nodes)
    diags = _check_dag(nodes)
    diags += _check_precedence(nodes, None, None)
    diags += _check_resources(nodes, plan.dmas, plan.mode)
    diags += _check_data_hazards(nodes, plan.dmas, streamed)
    diags += _check_residency(nodes, plan.memory, streamed)
    diags += _check_double_buffer(plan.dmas, plan.memory, streamed)
    diags += _check_aliasing(plan.memory)
    return sorted(diags, key=lambda d: (d.rule, d.message))


def analyze_multi_plan(plan) -> List[Diagnostic]:
    """All rules over a multi-tenant ``MultiExecutionPlan``."""
    nodes = plan.nodes
    streamed = _streamed_tensors(nodes)
    diags = _check_dag(nodes)
    diags += _check_precedence(nodes, plan.makespan, plan.tenant_makespans)
    diags += _check_resources(nodes, plan.dmas, plan.mode)
    diags += _check_data_hazards(nodes, plan.dmas, streamed)
    diags += _check_residency(nodes, plan.memory, streamed)
    diags += _check_double_buffer(plan.dmas, plan.memory, streamed)
    diags += _check_aliasing(plan.memory)
    diags += _check_isolation(plan)
    return sorted(diags, key=lambda d: (d.rule, d.message))


def analyze(plan) -> List[Diagnostic]:
    """Dispatch on plan shape: multi, single, or bare memory plan."""
    if hasattr(plan, "tenants"):
        return analyze_multi_plan(plan)
    if hasattr(plan, "nodes"):
        return analyze_plan(plan)
    return analyze_memory(plan)


def analyze_errors(plan) -> List[Diagnostic]:
    """ERROR-severity findings only (what strict mode gates on)."""
    return errors_only(analyze(plan))


def summarize(diags: Iterable[Diagnostic]) -> Dict[str, int]:
    """Per-rule counts, for reports and CI gates."""
    out: Dict[str, int] = {}
    for d in diags:
        out[d.rule] = out.get(d.rule, 0) + 1
    return out
