"""Global scheduling + memory planning (paper §3.2).

Builds the execution DAG from the rewritten graph (supernodes, slice/concat
helpers, parameter planned-loads, input/output DMA), then searches for a
minimum-makespan schedule subject to:

  * data-dependency precedence,
  * concurrency: each device runs one kernel at a time; one system DMA
    engine, serialized with compute (the paper's current model);
  * L2 capacity: tensors are packed by the first-fit allocator; when space
    runs out the scheduler evicts the live tensor whose next use is farthest
    (dynamic swap to L3) and pays the DMA both ways — exactly the Fig. 4
    behaviour where constrained memory forces serialization.

Search: priority-list scheduling (HEFT-style upward ranks) with several
priority schemes + seeded perturbations; every candidate is validated against
the constraint set and the best feasible makespan wins.  Sequential modes
(tvm / match) additionally serialize all compute on a global mutex, which is
how the paper's baselines execute (§4).
"""

from __future__ import annotations

import dataclasses
import heapq
import random
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.ir import Graph
from repro_torch.core.memplan import (L2Allocator, MemoryPlan, SharedL2Allocator,
                                SwapOp)
from repro_torch.core.rewrite import HelperNode, Supernode, TiledGraph
from repro_torch.core.tiling import DELTA_HELPER
from repro_torch.core.zigzag import refine_latency
from repro_torch.soc.device import SoC

DMA = "dma"


@dataclasses.dataclass
class PlanNode:
    name: str
    kind: str                  # kernel | slice | concat | load | store
    resource: str              # device name or "dma"
    duration: float
    preds: List[str]
    # tensors this node reads (must be L2-resident) / writes (L2 buffers)
    reads: List[str]
    writes: List[str]
    supernode: Optional[str] = None
    start: float = -1.0
    end: float = -1.0
    tenant: int = 0            # model index in a multi-tenant co-schedule
    # planned-loading traffic for L3-resident tensors: (tensor, dir, bytes).
    # Tensors too large for the L2 scratchpad stay in L3; every access
    # streams its touched bytes through the system DMA (§3.2 strategy iii).
    l3_traffic: List[Tuple[str, str, float]] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class ScheduledDma:
    tensor: str
    direction: str             # in | out
    start: float
    end: float
    bytes: int


@dataclasses.dataclass
class ExecutionPlan:
    mode: str
    tiled: TiledGraph
    nodes: Dict[str, PlanNode]
    order: List[str]                      # by start time
    dmas: List[ScheduledDma]
    memory: MemoryPlan
    makespan: float
    busy: Dict[str, float]                # per-resource busy cycles

    def utilization(self) -> Dict[str, float]:
        return {r: (b / self.makespan if self.makespan else 0.0)
                for r, b in self.busy.items()}


# ---------------------------------------------------------------------------
# DAG construction
# ---------------------------------------------------------------------------


def l3_resident(g: Graph, soc: SoC) -> Set[str]:
    """Tensors that never fit the L2 scratchpad: stay in L3, accessed via
    planned loading (§3.2 strategy iii)."""
    cap = soc.l2.size // 2
    return {t for t, ti in g.tensors.items() if ti.bytes > cap}


STATIC_PARAM_BUDGET = 0.6      # fraction of L2 reserved for resident params


def static_params(g: Graph, soc: SoC,
                  l2_budget: Optional[int] = None) -> Set[str]:
    """Strategy (i): parameters kept L2-resident for the whole execution —
    loaded once at startup, so their DMA is *not* in the inference makespan.
    Smallest-first greedy within the budget; the rest use planned loading.
    ``l2_budget`` caps this tenant's L2 share in a multi-tenant co-schedule
    (defaults to the whole scratchpad for single-model plans)."""
    budget = int((soc.l2.size if l2_budget is None else l2_budget)
                 * STATIC_PARAM_BUDGET)
    l3res = l3_resident(g, soc)
    out: Set[str] = set()
    used = 0
    params = sorted((t for t, ti in g.tensors.items()
                     if ti.kind == "param" and t not in l3res),
                    key=lambda t: g.tensors[t].bytes)
    for t in params:
        b = g.tensors[t].bytes
        if used + b <= budget:
            out.add(t)
            used += b
    return out


def build_dag(tg: TiledGraph, soc: SoC,
              l2_budget: Optional[int] = None) -> Dict[str, PlanNode]:
    g = tg.graph
    host = soc.host.name
    l3res = l3_resident(g, soc)
    nodes: Dict[str, PlanNode] = {}

    def add(n: PlanNode) -> PlanNode:
        nodes[n.name] = n
        return n

    # graph inputs arrive via the system DMA (L3-resident ones stay put)
    for t in g.inputs:
        if t not in l3res:
            add(PlanNode(f"load:{t}", "load", DMA,
                         g.tensors[t].bytes / soc.dma_l3_bandwidth,
                         [], [], [t]))

    # parameter planned-loads: one DMA per *non-static* param tensor (static
    # params are L2-resident from startup, strategy i — no runtime DMA)
    statics = static_params(g, soc, l2_budget)
    param_load: Dict[str, str] = {}
    for tname, ti in g.tensors.items():
        if ti.kind == "param" and tname not in l3res and tname not in statics:
            n = add(PlanNode(f"load:{tname}", "load", DMA,
                             ti.bytes / soc.dma_l3_bandwidth, [], [], [tname]))
            param_load[tname] = n.name

    helpers_by_sn: Dict[str, Dict[str, HelperNode]] = {}
    for h in tg.helpers:
        helpers_by_sn.setdefault(h.super_name, {})[h.kind] = h

    # readiness of a tensor: names of nodes that complete it
    def readiness(tensor: str) -> List[str]:
        ti = g.tensors[tensor]
        if ti.kind == "input":
            return [f"load:{tensor}"] if tensor not in l3res else []
        if ti.kind == "param":
            return ([param_load[tensor]]
                    if tensor in param_load else [])
        producer = ti.producer
        out = []
        for sn_name in tg.op_cover.get(producer, []):
            h = helpers_by_sn.get(sn_name, {})
            out.append(h["concat"].name if "concat" in h else f"k:{sn_name}")
        return out

    def l3t(tensors: List[str], direction: str, frac: float
            ) -> List[Tuple[str, str, float]]:
        return [(t, direction, g.tensors[t].bytes * frac)
                for t in tensors if t in l3res]

    for sn in tg.supernodes:
        chain_outs = {g.ops[o].output for o in sn.op_names}
        ext_reads: List[str] = []
        for o in sn.op_names:
            for t in g.ops[o].inputs:
                if t not in chain_outs and t not in ext_reads:
                    ext_reads.append(t)
        h = helpers_by_sn.get(sn.name, {})
        frac = sn.tiles / sn.T
        kpreds: List[str] = []
        if "slice" in h:
            hn = h["slice"]
            s = add(PlanNode(hn.name, "slice", host,
                             hn.bytes_moved / soc.host.copy_bandwidth
                             + DELTA_HELPER,
                             [], [hn.tensor], [],
                             l3_traffic=l3t([hn.tensor], "in", frac)))
            for t in ext_reads:
                s.preds.extend(readiness(t))
            kpreds.append(s.name)
        else:
            for t in ext_reads:
                kpreds.extend(readiness(t))
        out_t = g.ops[sn.op_names[-1]].output
        traffic = l3t(ext_reads, "in", frac) + l3t([out_t], "out", frac)
        k = add(PlanNode(f"k:{sn.name}", "kernel", sn.device,
                         refine_latency(g, sn, soc), kpreds,
                         list(ext_reads), [out_t], supernode=sn.name,
                         l3_traffic=traffic))
        if "concat" in h:
            hn = h["concat"]
            add(PlanNode(hn.name, "concat", host,
                         hn.bytes_moved / soc.host.copy_bandwidth
                         + DELTA_HELPER,
                         [k.name], [], [out_t],
                         l3_traffic=l3t([out_t], "out", frac)))

    for t in g.outputs:
        if t in l3res:
            continue                     # already materialized in L3
        add(PlanNode(f"store:{t}", "store", DMA,
                     g.tensors[t].bytes / soc.dma_l3_bandwidth,
                     readiness(t), [t], []))

    # prune dangling preds (defensive) and deduplicate
    for n in nodes.values():
        n.preds = sorted({p for p in n.preds if p in nodes and p != n.name})
    return nodes


# ---------------------------------------------------------------------------
# Priority schemes
# ---------------------------------------------------------------------------


def _upward_rank(nodes: Dict[str, PlanNode]) -> Dict[str, float]:
    succs: Dict[str, List[str]] = {n: [] for n in nodes}
    for n in nodes.values():
        for p in n.preds:
            succs[p].append(n.name)
    rank: Dict[str, float] = {}

    order = _topo(nodes)
    for name in reversed(order):
        n = nodes[name]
        rank[name] = n.duration + max((rank[s] for s in succs[name]),
                                      default=0.0)
    return rank


def _topo(nodes: Dict[str, PlanNode]) -> List[str]:
    indeg = {n: len(nodes[n].preds) for n in nodes}
    succs: Dict[str, List[str]] = {n: [] for n in nodes}
    for n in nodes.values():
        for p in n.preds:
            succs[p].append(n.name)
    q = sorted([n for n, d in indeg.items() if d == 0])
    out: List[str] = []
    while q:
        x = q.pop(0)
        out.append(x)
        for s in succs[x]:
            indeg[s] -= 1
            if indeg[s] == 0:
                q.append(s)
    if len(out) != len(nodes):
        raise ValueError("dependency cycle in execution DAG")
    return out


# ---------------------------------------------------------------------------
# Event-driven simulation with memory
# ---------------------------------------------------------------------------


class _SimState:
    def __init__(self, tg: TiledGraph, soc: SoC, sequential: bool) -> None:
        self.g = tg.graph
        self.soc = soc
        self.sequential = sequential
        self.capacity = soc.l2.size
        # address-aware first-fit allocator runs *online*, so the packing
        # the scheduler commits to is exactly the packing that is emitted
        self.alloc = L2Allocator(soc.l2.size)
        self.res_free: Dict[str, float] = {d: 0.0 for d in soc.devices}
        self.res_free[DMA] = 0.0
        self.res_free["mutex"] = 0.0
        self.busy: Dict[str, float] = {r: 0.0 for r in self.res_free}
        self.dmas: List[ScheduledDma] = []
        self.swaps: List[SwapOp] = []
        # tensor buffer state: "none" | "l2" | "l3" | "l3r" | "dead"
        self.state: Dict[str, str] = {t: "none" for t in self.g.tensors}
        for t in l3_resident(tg.graph, soc):
            self.state[t] = "l3r"            # pinned in L3 (planned loading)
        # static params: resident from t=0, never evicted (strategy i)
        for t in static_params(tg.graph, soc):
            self.alloc.alloc(t, tg.graph.tensors[t].bytes, 0.0, "static")
            self.state[t] = "l2"
        self.remaining_consumers: Dict[str, int] = {}
        # tensor -> latest end of any dispatched node reading/writing it;
        # eviction may not touch the buffer before that (see
        # ``_reserve_slots``) — on metal a swap-out racing an in-flight
        # access corrupts memory even though the analytic makespan is
        # oblivious to it
        self.pin_until: Dict[str, float] = {}
        # tensor -> end of its latest issued transfer: a node touching the
        # tensor may not start under an in-flight DMA on its buffer
        self.tensor_dma_until: Dict[str, float] = {}

    def dma_transfer(self, tensor: str, direction: str, ready: float,
                     nbytes: int) -> float:
        start = max(ready, self.res_free[DMA])
        dur = nbytes / self.soc.dma_l3_bandwidth
        end = start + dur
        self.res_free[DMA] = end
        self.busy[DMA] += dur
        self.tensor_dma_until[tensor] = max(
            self.tensor_dma_until.get(tensor, 0.0), end)
        self.dmas.append(ScheduledDma(tensor, direction, start, end, nbytes))
        self.swaps.append(SwapOp(tensor, direction, nbytes, start))
        return end

    def l2_free(self, tensor: str, now: float) -> None:
        self.alloc.free(tensor, now)

    def reserve(self, needs: List[Tuple[str, int, str]], now: float,
                protect: Set[str]) -> Tuple[bool, float]:
        """Transactionally reserve L2 slots for all ``(tensor, bytes,
        strategy)`` entries, evicting victims (swap to L3, paying the DMA)
        only when the full reservation is guaranteed to succeed.  Returns
        (ok, time when every slot is available).  A False return leaves the
        allocator state untouched — blocked nodes defer without thrashing
        the DMA engine."""
        return _reserve_slots(
            self, needs, now,
            candidates=lambda: self.alloc.eviction_candidates(protect),
            choose=lambda vs: max(vs, key=lambda t: self.alloc.live[t].size),
            do_alloc=lambda t, b, strat, ta: self.alloc.alloc(t, b, ta,
                                                              strat))


def _reserve_slots(st, needs: List[Tuple[str, int, str]], now: float,
                   candidates, choose, do_alloc) -> Tuple[bool, float]:
    """Shared all-or-nothing L2 reservation used by both the single-model
    and the multi-tenant simulators; the policies differ only in victim
    ordering/choice and in how allocations are attributed (``owner``)."""
    if not needs:
        return True, now
    sizes = [int(b) for _, b, _ in needs]
    for (t, b, _s) in needs:
        if int(b) > st.capacity:
            raise MemoryError(f"{t}: {b} B exceeds L2 ({st.capacity} B)")
    hypo = st.alloc.segments_assuming_freed(candidates())
    if not L2Allocator.fits_all(hypo, sizes):
        return False, now                          # no mutation
    t_avail = now
    pin_until = getattr(st, "pin_until", {})
    while not L2Allocator.fits_all(
            st.alloc.segments_assuming_freed([]), sizes):
        vs = candidates()
        # Eviction must not race an in-flight access: a victim still
        # being read/written by an already-dispatched node (its window
        # extends past t_avail) may only be swapped out *after* that
        # window closes.  Prefer victims that are free right now; when
        # every candidate is pinned, take the soonest-released one and
        # push the eviction (and this reservation) past its release —
        # feasibility is unchanged (the fits_all pre-check above ignores
        # pinning), only the eviction clock moves, so no new deadlocks.
        free_now = [v for v in vs if pin_until.get(v, 0.0) <= t_avail]
        if free_now:
            v = choose(free_now)
        else:
            v = min(vs, key=lambda u: pin_until.get(u, 0.0))
            t_avail = max(t_avail, pin_until.get(v, 0.0))
        vb = st.alloc.live[v].size
        t_avail = st.dma_transfer(v, "out", t_avail, vb)
        st.alloc.free(v, t_avail)
        st.alloc.evictions += 1
        st.state[v] = "l3"
    for t, b, strat in needs:
        a = do_alloc(t, int(b), strat, t_avail)
        if a is None:              # fits_all said yes; placement must work
            raise MemoryError(f"L2 reservation lost {t} ({b} B) after "
                              f"eviction — allocator inconsistency")
    return True, t_avail


def simulate(tg: TiledGraph, soc: SoC, sequential: bool,
             priority: Dict[str, float],
             nodes: Optional[Dict[str, PlanNode]] = None,
             strict: bool = False) -> ExecutionPlan:
    """Event-driven schedule construction.

    ``strict=False``: greedy list scheduling — a free resource always runs
    the highest-priority *ready* task.  ``strict=True``: a resource only
    runs its highest-priority *unscheduled* task, i.e. it may sit idle
    waiting for a critical task's dependencies — which greedy scheduling
    cannot express (e.g. keeping PULP free for the branch kernels before
    committing it to a long shortcut conv).  The priority vector is then a
    genuine sequencing decision variable the annealer in :func:`schedule`
    optimizes over."""
    base = nodes or build_dag(tg, soc)
    # fresh copies so repeated simulations don't share mutable state
    nodes = {k: dataclasses.replace(v, preds=list(v.preds),
                                    reads=list(v.reads), writes=list(v.writes))
             for k, v in base.items()}
    g = tg.graph
    st = _SimState(tg, soc, sequential)
    # strict mode: per-resource queues of not-yet-scheduled tasks
    pending_by_res: Dict[str, Set[str]] = {}
    for n in nodes.values():
        pending_by_res.setdefault(n.resource, set()).add(n.name)
    relax = False

    for n in nodes.values():
        for t in n.reads:
            st.remaining_consumers[t] = st.remaining_consumers.get(t, 0) + 1

    succs: Dict[str, List[str]] = {n: [] for n in nodes}
    indeg: Dict[str, int] = {}
    for n in nodes.values():
        indeg[n.name] = len(n.preds)
        for p in n.preds:
            succs[p].append(n.name)

    pred_end: Dict[str, float] = {n: 0.0 for n in nodes}
    ready: List[Tuple[float, str]] = []   # (-priority, name)
    for n, d in indeg.items():
        if d == 0:
            heapq.heappush(ready, (-priority.get(n, 0.0), n))
    events: List[Tuple[float, str]] = []  # (end time, name)
    deferred: List[str] = []
    finished = 0
    now = 0.0
    order: List[str] = []

    while finished < len(nodes):
        progressed = False
        attempt = [heapq.heappop(ready)[1] for _ in range(len(ready))]
        attempt.extend(deferred)
        deferred = []
        for name in attempt:
            n = nodes[name]
            if strict and not relax and n.resource != DMA:
                top = max(pending_by_res[n.resource],
                          key=lambda m: priority.get(m, 0.0))
                if priority.get(top, 0.0) > priority.get(name, 0.0):
                    deferred.append(name)     # resource waits for its top task
                    continue
            t0 = max(pred_end[name], st.res_free[n.resource])
            if sequential and n.resource != DMA:
                t0 = max(t0, st.res_free["mutex"])
            # 1. gather every L2 slot this node requires: reloads of
            # swapped-out inputs + freshly-written output buffers
            protect = set(n.reads) | set(n.writes)
            for t in protect:        # wait out in-flight DMA on operands
                t0 = max(t0, st.tensor_dma_until.get(t, 0.0))
            needs: List[Tuple[str, int, str]] = []
            reloads: List[str] = []
            for t in n.reads:
                if st.state[t] == "l3":
                    needs.append((t, g.tensors[t].bytes, "dynamic"))
                    reloads.append(t)
            for t in n.writes:
                if st.state[t] == "none":
                    strat = ("planned"
                             if g.tensors[t].kind == "param" else "dynamic")
                    needs.append((t, g.tensors[t].bytes, strat))
                elif st.state[t] == "l3":   # partial writer after eviction
                    needs.append((t, g.tensors[t].bytes, "dynamic"))
                    reloads.append(t)
            # 2. transactional reservation (all-or-nothing; no thrash)
            ok, t0 = st.reserve(needs, t0, protect)
            if not ok:
                deferred.append(name)
                continue
            # a buffer cannot be touched before it exists: an operand
            # allocated by an earlier-dispatched sibling (e.g. another
            # spatial partition of the same output) may carry a t_alloc
            # later than this node's natural start on an idle device —
            # before t_alloc the address range can legally belong to a
            # different tensor
            for t in protect:
                a = st.alloc.live.get(t)
                if a is not None:
                    t0 = max(t0, a.t_alloc)
            for t, _, _ in needs:
                st.state[t] = "l2"
            for t in reloads:
                t0 = st.dma_transfer(t, "in", t0, g.tensors[t].bytes)
            # 3. planned-loading DMA for L3-resident operands (serialized
            # with compute on the system DMA, §3.2), then run
            for t, dirn, b in n.l3_traffic:
                t0 = st.dma_transfer(t, dirn, t0, int(b))
            n.start = t0
            n.end = t0 + n.duration
            for t in protect:        # in-flight accesses block eviction
                st.pin_until[t] = max(st.pin_until.get(t, 0.0), n.end)
            st.res_free[n.resource] = n.end
            st.busy[n.resource] += n.duration
            if sequential and n.resource != DMA:
                st.res_free["mutex"] = n.end
            pending_by_res[n.resource].discard(name)
            heapq.heappush(events, (n.end, name))
            order.append(name)
            progressed = True
            relax = False

        if not events:
            if deferred and not progressed:
                if strict and not relax:
                    relax = True        # strict sequencing deadlock: fall
                    continue            # back to greedy for one round
                raise RuntimeError(
                    f"scheduler deadlock: {len(deferred)} nodes blocked on "
                    f"L2 capacity ({soc.l2.size} B)")
            continue
        end, name = heapq.heappop(events)
        now = end
        finished += 1
        n = nodes[name]
        # release read refs; free dead tensors
        for t in n.reads:
            st.remaining_consumers[t] -= 1
            if (st.remaining_consumers[t] == 0 and st.state[t] == "l2"
                    and t not in g.outputs):
                st.l2_free(t, now)
                st.state[t] = "dead"
        for s in succs[name]:
            indeg[s] -= 1
            pred_end[s] = max(pred_end[s], end)
            if indeg[s] == 0:
                heapq.heappush(ready, (-priority.get(s, 0.0), s))

    makespan = max((n.end for n in nodes.values()), default=0.0)
    st.alloc.finish(makespan)
    mem = MemoryPlan(capacity=soc.l2.size, allocations=st.alloc.history,
                     swaps=st.swaps, peak=st.alloc.peak,
                     evictions=st.alloc.evictions)
    order.sort(key=lambda n: nodes[n].start)
    busy = {r: b for r, b in st.busy.items() if r != "mutex"}
    return ExecutionPlan(mode="", tiled=tg, nodes=nodes, order=order,
                         dmas=st.dmas, memory=mem, makespan=makespan,
                         busy=busy)


def schedule(tg: TiledGraph, soc: SoC, mode: str,
             restarts: int = 3, seed: int = 0,
             anneal_iters: Optional[int] = None) -> ExecutionPlan:
    """Search over priority schemes (greedy + strict-sequencing), then
    refine the best strict-mode priority vector by simulated annealing —
    the priorities are genuine sequencing decisions in strict mode, so this
    explores schedules greedy list scheduling cannot reach (e.g. holding a
    device for late-arriving critical tasks)."""
    sequential = mode in ("tvm", "match")
    dag = build_dag(tg, soc)
    rank = _upward_rank(dag)
    topo_idx = {n: float(-i) for i, n in enumerate(_topo(dag))}
    schemes: List[Dict[str, float]] = [rank, topo_idx]
    rng = random.Random(seed)
    for _ in range(restarts):
        noisy = {n: r * (1.0 + 0.25 * rng.random()) for n, r in rank.items()}
        schemes.append(noisy)

    best: Optional[ExecutionPlan] = None
    best_pr: Optional[Dict[str, float]] = None
    best_strict = False
    last_err: Optional[Exception] = None
    stricts = (False,) if sequential else (False, True)
    for pr in schemes:
        for strict in stricts:
            try:
                plan = simulate(tg, soc, sequential, pr, nodes=dag,
                                strict=strict)
            except (MemoryError, RuntimeError) as e:   # packing: skip
                last_err = e
                continue
            if best is None or plan.makespan < best.makespan:
                best, best_pr, best_strict = plan, pr, strict
    if best is None:
        raise RuntimeError(f"no feasible schedule found: {last_err}")

    if not sequential:
        # simulated-annealing polish over strict-mode priorities
        iters = anneal_iters if anneal_iters is not None \
            else min(220, 40 + 3 * len(dag))
        names = list(dag.keys())
        lo = min(best_pr.values(), default=0.0)
        hi = max(best_pr.values(), default=1.0)
        cur = dict(best_pr)
        cur_span = best.makespan
        for it in range(iters):
            cand = dict(cur)
            for _ in range(rng.randint(1, 2)):
                n = rng.choice(names)
                cand[n] = lo + (hi - lo) * rng.random()
            try:
                plan = simulate(tg, soc, sequential, cand, nodes=dag,
                                strict=True)
            except (MemoryError, RuntimeError):
                continue
            accept = plan.makespan < cur_span or \
                rng.random() < 0.1 * (1.0 - it / iters)
            if accept:
                cur, cur_span = cand, plan.makespan
            if plan.makespan < best.makespan:
                best, best_pr, best_strict = plan, cand, True
    best.mode = mode
    return best


def validate_schedule(plan: ExecutionPlan) -> List[str]:
    """Constraint checker, now a thin shim over the static plan analyzer
    (:mod:`repro.analysis`): precedence and per-resource mutual exclusion
    as before, plus DMA/compute data hazards, use-after-evict, L2 address
    aliasing, and double-buffer discipline — every rule at one shared
    ``TIME_EPS``.  Returns ERROR findings as strings (empty == valid)."""
    from repro_torch.analysis import analyze_errors
    return [str(d) for d in analyze_errors(plan)]


# ---------------------------------------------------------------------------
# Multi-tenant co-scheduling (inter-model concurrency)
# ---------------------------------------------------------------------------
#
# The paper's Fig. 4 story generalized from intra-model to inter-model
# concurrency: N independent models share one SoC.  Their execution DAGs are
# merged under per-device mutual exclusion, a *shared* L2 allocator with
# per-tenant budgets + contention-aware eviction (memplan.SharedL2Allocator),
# and a double-buffered DMA discipline — planned loads are issued as soon as
# a node's dependencies resolve, so DMA traffic of one tenant overlaps
# compute of another instead of serializing (cf. arXiv:2308.05869).


def default_budgets(soc: SoC, n: int) -> List[int]:
    """Equal soft split of the shared L2 scratchpad across ``n`` tenants."""
    return [soc.l2.size // n] * n


def _check_budgets(budgets: Sequence[int], n_tenants: int) -> List[int]:
    budgets = list(budgets)
    if len(budgets) != n_tenants:
        raise ValueError(f"budgets has {len(budgets)} entries for "
                         f"{n_tenants} tenants")
    if any(b <= 0 for b in budgets):
        raise ValueError(f"budgets must be positive: {budgets}")
    return budgets


def _namespace_node(n: PlanNode, prefix: str, tenant: int) -> PlanNode:
    """Copy of ``n`` with every node/tensor reference prefixed for its
    tenant (shared by the co-scheduler DAG merge and the sequential
    concatenation so the two can never desynchronize)."""
    return dataclasses.replace(
        n, name=prefix + n.name,
        preds=[prefix + q for q in n.preds],
        reads=[prefix + t for t in n.reads],
        writes=[prefix + t for t in n.writes],
        l3_traffic=[(prefix + t, d, b) for t, d, b in n.l3_traffic],
        tenant=tenant)


def build_multi_dag(tgs: Sequence[TiledGraph], soc: SoC,
                    budgets: Sequence[int]) -> Dict[str, PlanNode]:
    """Merge per-tenant execution DAGs into one namespaced DAG.

    Node and tensor names are prefixed ``t{i}/`` so two instances of the
    same model never collide; cross-tenant edges do not exist (tenants are
    independent), coupling happens only through shared resources."""
    budgets = _check_budgets(budgets, len(tgs))
    merged: Dict[str, PlanNode] = {}
    for i, tg in enumerate(tgs):
        p = f"t{i}/"
        for name, n in build_dag(tg, soc, l2_budget=budgets[i]).items():
            merged[p + name] = _namespace_node(n, p, i)
    return merged


@dataclasses.dataclass
class MultiExecutionPlan:
    """A co-schedule of N independent models on one SoC."""
    tenants: List[TiledGraph]
    nodes: Dict[str, PlanNode]            # namespaced "t{i}/..."
    order: List[str]                      # by start time
    dmas: List[ScheduledDma]
    memory: MemoryPlan
    makespan: float
    busy: Dict[str, float]
    tenant_makespans: List[float]         # completion time of each tenant
    budgets: List[int]
    mode: str = "matcha"
    # which candidate source won the arbitration ("primary", a labelled
    # alternative tiling set such as "joint-cp", or "sequential") — stamped
    # by schedule_multi so benchmark regressions are attributable
    origin: str = "primary"
    # contention-fixpoint rounds that produced this plan (a tie-break key:
    # among near-equal plans the less-re-tiled one is the stabler choice)
    retile_rounds: int = 0

    def utilization(self) -> Dict[str, float]:
        return {r: (b / self.makespan if self.makespan else 0.0)
                for r, b in self.busy.items()}


class _MultiSimState:
    """Shared-resource simulation state for N tenants (one L2, one DMA)."""

    def __init__(self, tgs: Sequence[TiledGraph], soc: SoC,
                 budgets: Sequence[int]) -> None:
        self.soc = soc
        self.capacity = soc.l2.size
        self.alloc = SharedL2Allocator(soc.l2.size, list(budgets))
        self.res_free: Dict[str, float] = {d: 0.0 for d in soc.devices}
        self.res_free[DMA] = 0.0
        self.busy: Dict[str, float] = {r: 0.0 for r in self.res_free}
        self.dmas: List[ScheduledDma] = []
        self.swaps: List[SwapOp] = []
        self.tensors: Dict[str, object] = {}     # namespaced -> TensorInfo
        self.state: Dict[str, str] = {}
        self.outputs: Set[str] = set()
        for i, tg in enumerate(tgs):
            p = f"t{i}/"
            g = tg.graph
            for t, ti in g.tensors.items():
                self.tensors[p + t] = ti
                self.state[p + t] = "none"
            for t in l3_resident(g, soc):
                self.state[p + t] = "l3r"
            for t in static_params(g, soc, budgets[i]):
                a = self.alloc.alloc(p + t, g.tensors[t].bytes, 0.0,
                                     "static", owner=i)
                if a is None:      # over-committed budgets: a real capacity
                    raise MemoryError(   # condition, recoverable by caller
                        f"static params exceed shared L2: {p + t} "
                        f"({g.tensors[t].bytes} B) does not fit "
                        f"(budgets={budgets})")
                self.state[p + t] = "l2"
            self.outputs.update(p + t for t in g.outputs)
        self.remaining_consumers: Dict[str, int] = {}
        # tensor -> latest end of any dispatched access (same eviction
        # pinning as the single-model sim; see ``_reserve_slots``)
        self.pin_until: Dict[str, float] = {}
        # tensor -> end of its latest issued transfer (see _SimState)
        self.tensor_dma_until: Dict[str, float] = {}
        # Monotonic clock over allocator mutations.  With double-buffered
        # DMA, reservation times are pred-driven and can run *backwards*
        # relative to the sequential allocator order; without the clamp a
        # later reservation could reuse an address whose previous occupant
        # is (in simulated time) not yet evicted, producing overlapping
        # residency rectangles.  Allocations are therefore stamped no
        # earlier than the latest allocator event.
        self.mem_clock = 0.0

    def nbytes(self, tensor: str) -> int:
        return self.tensors[tensor].bytes

    # identical single-engine DMA serialization as the single-model sim
    dma_transfer = _SimState.dma_transfer

    def reserve(self, needs: List[Tuple[str, int, str]], now: float,
                protect: Set[str], owner: int) -> Tuple[bool, float]:
        """Transactional multi-tenant reservation: same all-or-nothing
        semantics as the single-model scheduler, but victims are chosen
        contention-aware (over-budget *other* tenants pay first, in the
        allocator's budget-aware order) and allocator mutations are
        clamped to the monotonic ``mem_clock``."""
        if not needs:
            return True, now
        now = max(now, self.mem_clock)
        ok, t_avail = _reserve_slots(
            self, needs, now,
            candidates=lambda: self.alloc.eviction_candidates(protect,
                                                              owner),
            choose=lambda vs: vs[0],               # budget-aware order
            do_alloc=lambda t, b, strat, ta: self.alloc.alloc(
                t, b, ta, strat, owner=owner))
        if ok:
            self.mem_clock = max(self.mem_clock, t_avail)
        return ok, t_avail


def simulate_multi(tgs: Sequence[TiledGraph], soc: SoC,
                   priority: Dict[str, float],
                   nodes: Optional[Dict[str, PlanNode]] = None,
                   budgets: Optional[Sequence[int]] = None
                   ) -> MultiExecutionPlan:
    """Greedy event-driven co-schedule construction over the merged DAG.

    Differs from the single-model :func:`simulate` in two resource-model
    respects: (a) L2 slots come from the shared budgeted allocator, and
    (b) DMA is double-buffered — a node's reload / planned-load transfers
    start when its *dependencies* resolve (not when its device frees up),
    so loads for one tenant overlap compute of another; compute then waits
    on max(transfers done, device free)."""
    budgets = list(budgets) if budgets is not None \
        else default_budgets(soc, len(tgs))
    base = nodes or build_multi_dag(tgs, soc, budgets)
    nodes = {k: dataclasses.replace(v, preds=list(v.preds),
                                    reads=list(v.reads),
                                    writes=list(v.writes))
             for k, v in base.items()}
    st = _MultiSimState(tgs, soc, budgets)

    for n in nodes.values():
        for t in n.reads:
            st.remaining_consumers[t] = st.remaining_consumers.get(t, 0) + 1

    succs: Dict[str, List[str]] = {n: [] for n in nodes}
    indeg: Dict[str, int] = {}
    for n in nodes.values():
        indeg[n.name] = len(n.preds)
        for p in n.preds:
            succs[p].append(n.name)

    pred_end: Dict[str, float] = {n: 0.0 for n in nodes}
    ready: List[Tuple[float, str]] = []
    for n, d in indeg.items():
        if d == 0:
            heapq.heappush(ready, (-priority.get(n, 0.0), n))
    events: List[Tuple[float, str]] = []
    deferred: List[str] = []
    finished = 0
    now = 0.0
    order: List[str] = []

    while finished < len(nodes):
        progressed = False
        attempt = [heapq.heappop(ready)[1] for _ in range(len(ready))]
        attempt.extend(deferred)
        deferred = []
        for name in attempt:
            n = nodes[name]
            t0 = pred_end[name]
            protect = set(n.reads) | set(n.writes)
            for t in protect:        # wait out in-flight DMA on operands
                t0 = max(t0, st.tensor_dma_until.get(t, 0.0))
            needs: List[Tuple[str, int, str]] = []
            reloads: List[str] = []
            for t in n.reads:
                if st.state[t] == "l3":
                    needs.append((t, st.nbytes(t), "dynamic"))
                    reloads.append(t)
            for t in n.writes:
                if st.state[t] == "none":
                    strat = ("planned"
                             if st.tensors[t].kind == "param" else "dynamic")
                    needs.append((t, st.nbytes(t), strat))
                elif st.state[t] == "l3":   # partial writer after eviction
                    needs.append((t, st.nbytes(t), "dynamic"))
                    reloads.append(t)
            ok, t0 = st.reserve(needs, t0, protect, n.tenant)
            if not ok:
                deferred.append(name)
                continue
            # a buffer cannot be touched before it exists (same clamp as
            # the single-model sim: a sibling spatial partition may have
            # allocated this operand at a later t_alloc than this node's
            # natural start on an idle device)
            for t in protect:
                a = st.alloc.live.get(t)
                if a is not None:
                    t0 = max(t0, a.t_alloc)
            for t, _, _ in needs:
                st.state[t] = "l2"
            for t in reloads:
                t0 = st.dma_transfer(t, "in", t0, st.nbytes(t))
            for t, dirn, b in n.l3_traffic:
                t0 = st.dma_transfer(t, dirn, t0, int(b))
            # double-buffering: transfers above ran off pred_end; the
            # device only gates the compute start, not the DMA issue
            n.start = max(t0, st.res_free[n.resource])
            n.end = n.start + n.duration
            for t in protect:        # in-flight accesses block eviction
                st.pin_until[t] = max(st.pin_until.get(t, 0.0), n.end)
            st.res_free[n.resource] = n.end
            st.busy[n.resource] += n.duration
            heapq.heappush(events, (n.end, name))
            order.append(name)
            progressed = True

        if not events:
            if deferred and not progressed:
                raise RuntimeError(
                    f"co-scheduler deadlock: {len(deferred)} nodes blocked "
                    f"on shared L2 ({soc.l2.size} B, budgets={budgets})")
            continue
        end, name = heapq.heappop(events)
        now = end
        finished += 1
        n = nodes[name]
        for t in n.reads:
            st.remaining_consumers[t] -= 1
            if (st.remaining_consumers[t] == 0 and st.state[t] == "l2"
                    and t not in st.outputs):
                st.alloc.free(t, now)
                st.mem_clock = max(st.mem_clock, now)
                st.state[t] = "dead"
        for s in succs[name]:
            indeg[s] -= 1
            pred_end[s] = max(pred_end[s], end)
            if indeg[s] == 0:
                heapq.heappush(ready, (-priority.get(s, 0.0), s))

    makespan = max((n.end for n in nodes.values()), default=0.0)
    st.alloc.finish(makespan)
    mem = MemoryPlan(capacity=soc.l2.size, allocations=st.alloc.history,
                     swaps=st.swaps, peak=st.alloc.peak,
                     evictions=st.alloc.evictions)
    order.sort(key=lambda n: nodes[n].start)
    tenant_ms = [0.0] * len(tgs)
    for n in nodes.values():
        tenant_ms[n.tenant] = max(tenant_ms[n.tenant], n.end)
    return MultiExecutionPlan(tenants=list(tgs), nodes=nodes, order=order,
                              dmas=st.dmas, memory=mem, makespan=makespan,
                              busy=dict(st.busy),
                              tenant_makespans=tenant_ms,
                              budgets=budgets)


def concat_plans(singles: Sequence[ExecutionPlan], soc: SoC,
                 budgets: Optional[Sequence[int]] = None
                 ) -> MultiExecutionPlan:
    """Sequential multi-tenant baseline: tenant i's single-model schedule
    runs after tenants 0..i-1 finish (compile-each-model-alone, run
    back-to-back).  Also the co-scheduler's fallback, which guarantees
    co-scheduled makespan <= sum of single-model makespans."""
    tgs = [p.tiled for p in singles]
    budgets = _check_budgets(budgets, len(singles)) if budgets is not None \
        else default_budgets(soc, len(singles))
    nodes: Dict[str, PlanNode] = {}
    dmas: List[ScheduledDma] = []
    allocs = []
    swaps: List[SwapOp] = []
    busy: Dict[str, float] = {}
    tenant_ms: List[float] = []
    offset = 0.0
    for i, plan in enumerate(singles):
        p = f"t{i}/"
        for name, n in plan.nodes.items():
            nodes[p + name] = dataclasses.replace(
                _namespace_node(n, p, i),
                start=n.start + offset, end=n.end + offset)
        for d in plan.dmas:
            dmas.append(ScheduledDma(p + d.tensor, d.direction,
                                     d.start + offset, d.end + offset,
                                     d.bytes))
        for a in plan.memory.allocations:
            allocs.append(dataclasses.replace(
                a, tensor=p + a.tensor, t_alloc=a.t_alloc + offset,
                t_free=(a.t_free + offset
                        if a.t_free != float("inf") else a.t_free),
                owner=i))
        for s in plan.memory.swaps:
            swaps.append(SwapOp(p + s.tensor, s.direction, s.bytes,
                                s.time + offset))
        for r, b in plan.busy.items():
            busy[r] = busy.get(r, 0.0) + b
        offset += plan.makespan
        tenant_ms.append(offset)
    order = sorted(nodes, key=lambda n: nodes[n].start)
    mem = MemoryPlan(capacity=soc.l2.size, allocations=allocs,
                     swaps=swaps,
                     peak=max((p.memory.peak for p in singles), default=0),
                     evictions=sum(p.memory.evictions for p in singles))
    return MultiExecutionPlan(tenants=tgs, nodes=nodes, order=order,
                              dmas=dmas, memory=mem, makespan=offset,
                              busy=busy, tenant_makespans=tenant_ms,
                              budgets=budgets, mode="sequential")


def _objective_better(cand, incumbent, objective) -> bool:
    """Candidate-vs-incumbent comparison for the co-schedule search.

    ``objective`` is a typed objective (``core.deploy.Objective`` — duck-
    typed here to keep this module free of a deploy import) whose
    ``better`` resolves near-equal primary values by the tie-break
    (eviction count by default); ``None`` falls back to the legacy pure-
    makespan strict comparison."""
    if incumbent is None:
        return cand is not None
    if cand is None:
        return False
    if objective is not None:
        return objective.better(cand, incumbent)
    return cand.makespan < incumbent.makespan - 1e-9


def _search_coschedule(tgs: Sequence[TiledGraph], soc: SoC,
                       budgets: Sequence[int], restarts: int, seed: int,
                       objective=None
                       ) -> Tuple[Optional[MultiExecutionPlan],
                                  Optional[Exception]]:
    """Priority-scheme search for ONE candidate tiling set: merged-DAG
    upward rank, per-tenant-normalized rank, topological index, and seeded
    perturbations — each simulated greedily under the shared-resource
    model; the best feasible plan under ``objective`` wins."""
    try:
        dag = build_multi_dag(tgs, soc, budgets)
    except (MemoryError, RuntimeError, ValueError) as e:
        return None, e
    rank = _upward_rank(dag)
    topo_idx = {n: float(-i) for i, n in enumerate(_topo(dag))}
    # fairness scheme: normalize each tenant's ranks so no tenant's whole
    # DAG dominates another's (round-robin-ish interleave)
    tmax: Dict[int, float] = {}
    for n, r in rank.items():
        t = dag[n].tenant
        tmax[t] = max(tmax.get(t, 0.0), r)
    fair = {n: r / tmax[dag[n].tenant] for n, r in rank.items()
            if tmax.get(dag[n].tenant)}
    schemes: List[Dict[str, float]] = [rank, fair, topo_idx]
    rng = random.Random(seed)
    for _ in range(restarts):
        schemes.append({n: r * (1.0 + 0.25 * rng.random())
                        for n, r in rank.items()})

    best: Optional[MultiExecutionPlan] = None
    last_err: Optional[Exception] = None
    for pr in schemes:
        try:
            plan = simulate_multi(tgs, soc, pr, nodes=dag, budgets=budgets)
        except (MemoryError, RuntimeError) as e:
            last_err = e
            continue
        if validate_multi_schedule(plan):
            continue
        if best is None or (objective.better(plan, best)
                            if objective is not None
                            else plan.makespan < best.makespan):
            best = plan
    return best, last_err


def schedule_multi(tgs: Sequence[TiledGraph], soc: SoC,
                   budgets: Optional[Sequence[int]] = None,
                   singles: Optional[Sequence[ExecutionPlan]] = None,
                   restarts: int = 3, seed: int = 0,
                   alt_tgs: Optional[Sequence[Sequence[TiledGraph]]] = None,
                   incumbent: Optional[MultiExecutionPlan] = None,
                   objective=None,
                   alt_labels: Optional[Sequence[str]] = None,
                   retile_round: int = 0) -> MultiExecutionPlan:
    """Search for a minimum-objective co-schedule of N tiled graphs.

    ``tgs`` holds each tenant's compile-alone tiling; ``alt_tgs`` supplies
    alternative per-tenant tiling sets (e.g. contention-aware re-tilings
    from the deployment session) that are searched under the same
    shared-resource model.  An alternative replaces the primary only when
    *strictly* better under ``objective`` (a ``core.deploy.Objective``;
    ``None`` = legacy pure makespan — the default typed objective adds an
    eviction-count tie-break among near-equal makespans), so with a fixed
    seed the result is never worse than scheduling the compile-alone
    tilings.  When the single-model plans are supplied, the sequential
    concatenation is a candidate too, so the result is never worse than
    running each model alone back-to-back.  ``incumbent`` injects a
    previously computed plan for ``tgs`` (same budgets/seed) as the plan
    to beat, skipping the deterministic re-search of the primary set.
    ``alt_labels`` (parallel to ``alt_tgs``) names each alternative set;
    the winner's label is stamped on ``plan.origin`` — freshly-built
    candidates are labelled in place, an incumbent keeps the origin it
    arrived with (relabelling a cached plan would mutate shared state).
    ``retile_round`` is stamped on every fresh candidate as its
    ``retile_rounds`` before arbitration, so the objective's optional
    retile-rounds tie-break compares the incumbent's (earlier) round
    against the current one rather than against a default 0."""
    budgets = _check_budgets(budgets, len(tgs)) if budgets is not None \
        else default_budgets(soc, len(tgs))
    if incumbent is not None:
        best, last_err = incumbent, None
    else:
        best, last_err = _search_coschedule(tgs, soc, budgets, restarts,
                                            seed, objective=objective)
        if best is not None:
            best.retile_rounds = retile_round
    for k, alt in enumerate(alt_tgs or []):
        cand, err = _search_coschedule(alt, soc, budgets, restarts, seed,
                                       objective=objective)
        if cand is None:
            last_err = err or last_err
            continue
        cand.origin = (alt_labels[k] if alt_labels is not None
                       and k < len(alt_labels) else f"alt{k}")
        cand.retile_rounds = retile_round
        if _objective_better(cand, best, objective):
            best = cand
    if singles is not None:
        seq = concat_plans(singles, soc, budgets)
        seq.origin = "sequential"
        seq.retile_rounds = retile_round
        if best is None or (objective.better(seq, best)
                            if objective is not None
                            else seq.makespan < best.makespan):
            best = seq
    if best is None:
        raise RuntimeError(f"no feasible co-schedule found: {last_err}")
    return best


def validate_multi_schedule(plan: MultiExecutionPlan) -> List[str]:
    """Co-schedule constraint checker, now a thin shim over the static
    plan analyzer (:mod:`repro.analysis`).  Beyond the historical checks
    (precedence, per-device mutual exclusion, single-DMA-engine
    exclusivity across all tenants' explicit load/store nodes and inline
    transfers, tenant completion within the makespan) this validates L2
    *address* aliasing across concurrently-live allocations — memory
    overlap across tenants used to be unchecked in multi plans — plus
    DMA/compute data hazards, use-after-evict, double-buffer discipline,
    and tenant budget isolation.  Returns ERROR findings as strings
    (empty == valid)."""
    from repro_torch.analysis import analyze_errors
    return [str(d) for d in analyze_errors(plan)]


def _tenant_of(namespaced: str) -> int:
    """Tenant index from a namespaced node/tensor name ``t{i}/...``."""
    return int(namespaced[1:namespaced.index("/")])


def contention_hints(plan: MultiExecutionPlan, soc: SoC) -> List:
    """Summarize a merged co-schedule into per-tenant
    :class:`repro.core.tiling.Contention` contexts for re-tiling.

    For tenant ``i``: the L2 slice is its ``SharedL2Allocator`` budget; the
    device-affinity hint is the busy fraction its *co-residents* put on
    each device; the DMA congestion factor is 1 + the co-residents' share
    of the single system DMA engine (their traffic serializes with this
    tenant's planned loads and swaps)."""
    from repro_torch.core.tiling import Contention
    n = len(plan.tenants)
    mk = plan.makespan or 1.0
    busy: List[Dict[str, float]] = [{} for _ in range(n)]
    dma_busy = [0.0] * n      # explicit load/store nodes + inline transfers
    for nd in plan.nodes.values():
        if nd.resource == DMA:
            dma_busy[nd.tenant] += nd.duration
            continue
        busy[nd.tenant][nd.resource] = \
            busy[nd.tenant].get(nd.resource, 0.0) + nd.duration
    for d in plan.dmas:
        dma_busy[_tenant_of(d.tensor)] += d.end - d.start
    hints = []
    for i in range(n):
        load: Dict[str, float] = {}
        for j in range(n):
            if j == i:
                continue
            for dev, b in busy[j].items():
                load[dev] = load.get(dev, 0.0) + b / mk
        others_dma = sum(b for j, b in enumerate(dma_busy) if j != i) / mk
        hints.append(Contention(l2_budget=plan.budgets[i],
                                dma_scale=1.0 + others_dma,
                                device_load=load))
    return hints
