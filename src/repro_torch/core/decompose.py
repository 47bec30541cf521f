"""Decomposed joint tiling: per-device-cluster subproblems + Benders-style
reconciliation.

The monolithic joint CP (:class:`repro.core.tiling.JointTilingProblem`)
couples every tenant's tile variables through shared per-device loads, one
shared-L2 capacity constraint, and a congested-DMA makespan term.  That is
exact — and it is also why the solve degrades to the warm-start fallback
once a mix grows past a handful of tenants: the B&B search space is the
product of all tenants' match domains.

This module keeps the time budget at 10-50 tenants by *decomposing* the
joint problem, the same way MATCH (Hamdi et al., 2024) keeps per-target
mapping exploration tractable by splitting it per hardware module and
Dagli & Belviranli (2023) layer shared-memory contention terms onto
per-accelerator decisions:

1.  **Cluster by dominant device affinity.**  Each tenant's stage-1 work
    is summed per device from its match variables (the same
    ``slope * T + delta`` latencies the CP would price, i.e.
    ``refined_tile_slope`` through :func:`~repro.core.tiling.
    build_match_vars`); tenants whose argmax device coincides form one
    cluster.  Tenants in different clusters barely compete for compute
    devices — what they *do* share is the L2 and the DMA engine.

2.  **Split the shared resources, solve clusters concurrently.**  Each
    cluster gets an L2 slice proportional to its linearized working set
    (:func:`~repro.core.tiling._match_ws_linear` totals) and a DMA-time
    inflation equal to the reciprocal of its traffic share (so every
    cluster prices the *full* system's DMA serialization, not just its
    own), plus a share of the wall-clock solve budget proportional to its
    variable count (:func:`repro.core.cpsolver.split_time_budget`).  The
    per-cluster :class:`JointTilingProblem`\\ s are independent CPs and
    solve concurrently on a bounded thread pool.

3.  **Reconcile with Benders-style cuts from the stage-2 evaluation.**
    The combined per-tenant solutions are evaluated under the exact
    shared-resource schedule (``schedule_multi``, via a caller-supplied
    ``evaluate`` callback).  A cluster whose *realized* makespan exceeds
    its CP relaxation was under-pricing the shared L2/DMA it spills
    onto; it contributes a cut (:meth:`JointTilingProblem.
    add_overflow_cut` — bound the L2 overflow below the incumbent's) and
    gets a larger L2 slice in the re-split, then re-solves warm-started
    from its own incumbent.  The loop runs to a bounded fixpoint
    (``max_cut_rounds``) and keeps the best *evaluated* combination seen
    — any-time semantics, so a late bad round can never ship.

The deployment session offers the decomposed solutions as one more
candidate tiling set into its ``schedule_multi`` arbitration, alongside
the monolithic joint solve and the best-response candidates — so
``decomposed <= best-response`` is preserved by construction: candidates
only ever *add*, and the incumbent is replaced only on strict objective
improvement.
"""

from __future__ import annotations

import dataclasses
import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import cpsolver
from repro_torch.core.ir import Graph
from repro_torch.core.patterns import Pattern
from repro_torch.core.tiling import (JointTilingProblem, L2_QUANTUM,
                               TilingSolution, _match_ws_linear,
                               build_match_vars, solution_ws_bytes)
from repro_torch.soc.device import SoC

# a cluster's realized stage-2 makespan must exceed its CP relaxation by
# this factor before it contributes a cut (small schedule-model noise
# must not trigger re-solves)
CUT_VIOLATION_TOL = 1.02

# minimum per-cluster wall budget worth spawning a solve for
MIN_CLUSTER_BUDGET_S = 0.05


@dataclasses.dataclass
class Cluster:
    """One per-device-cluster subproblem's bookkeeping."""
    device: str                   # dominant device the members share
    tenants: List[int]            # indices into the decomposed graph list
    ws_bytes: float               # summed linearized working sets
    dma_bytes: float              # summed tensor traffic (split weight)
    var_weight: float             # CP variable count (time-split weight)
    l2_budget: float = 0.0
    dma_scale: float = 1.0
    time_budget_s: float = 0.0
    relaxation: float = 0.0       # cluster CP objective (cycles)
    realized: float = 0.0         # stage-2 realized makespan (cycles)
    overflow_quanta: int = 0      # L2 overflow of the incumbent solution
    cuts: int = 0
    solves: int = 0


@dataclasses.dataclass
class DecomposeResult:
    """Per-tenant solutions (original order) plus reconciliation
    telemetry.  ``makespan`` is the stage-2 *evaluated* makespan of the
    returned combination when an ``evaluate`` callback was supplied
    (else the max cluster relaxation)."""
    solutions: List[TilingSolution]
    clusters: List[Cluster]
    rounds: int
    cuts: int
    makespan: float
    wall_s: float

    def stats(self) -> Dict[str, object]:
        return {"clusters": len(self.clusters),
                "cluster_sizes": [len(c.tenants) for c in self.clusters],
                "cluster_devices": [c.device for c in self.clusters],
                "rounds": self.rounds, "cuts": self.cuts,
                "makespan": self.makespan, "wall_s": self.wall_s}


def _affinity(g: Graph, soc: SoC, patterns: Sequence[Pattern],
              requested_tiles: int) -> Tuple[str, float, float, float]:
    """``(dominant device, ws_bytes, dma_bytes, var_weight)`` for one
    tenant: the stage-1 work of each fused region credited to the
    *cheapest* device offering it (that is where the CP will land the
    region when uncontended), summed per device — the argmax is the
    tenant's dominant device (ties broken by device name for
    determinism).  Also returns its linearized working-set total, a
    tensor-traffic proxy for the DMA split, and its CP variable count.

    Summing over every candidate match instead (the obvious choice)
    makes all tenants look alike whenever patterns are symmetric across
    devices — the per-region winner is what actually differentiates a
    dense-heavy tenant from a gelu-heavy one."""
    mvars = build_match_vars(g, soc, patterns, requested_tiles)
    best: Dict[Tuple[str, ...], Tuple[float, str]] = {}
    ws = 0.0
    for mv in mvars:
        cost = mv.slope * mv.T + mv.delta
        key = tuple(mv.match.ops)
        cand = (cost, mv.match.pattern.device)
        if key not in best or cand < best[key]:
            best[key] = cand
        per_tile, fixed = _match_ws_linear(g, mv.match, mv.T)
        ws += per_tile * mv.T + fixed
    work: Dict[str, float] = {}
    for cost, d in best.values():
        work[d] = work.get(d, 0.0) + cost
    dev = max(sorted(work), key=lambda d: work[d])
    traffic = float(sum(ti.bytes for ti in g.tensors.values()))
    return dev, ws, traffic, 2.0 * len(mvars)


def cluster_by_affinity(graphs: Sequence[Graph], soc: SoC,
                        patterns: Sequence[Pattern],
                        requested_tiles: int,
                        max_cluster_size: Optional[int] = None
                        ) -> List[Cluster]:
    """Group tenants by dominant device affinity, deterministically
    ordered by device name.  One cluster (every tenant wants the same
    device) means decomposition has nothing to split — the caller should
    use the monolithic solve.

    ``max_cluster_size`` caps the subproblem size: a device cluster with
    more members is split into balanced sub-clusters (contiguous in
    tenant order).  Members of the same device cluster couple through
    shared L2/DMA exactly like members of different ones, so the split
    budgets and reconciliation cuts apply unchanged — this is what keeps
    per-subproblem CP search bounded as mixes grow to dozens of tenants
    instead of letting the largest cluster re-inherit the monolithic
    blowup."""
    by_dev: Dict[str, List[Tuple[int, float, float, float]]] = {}
    for i, g in enumerate(graphs):
        dev, ws, traffic, vw = _affinity(g, soc, patterns, requested_tiles)
        by_dev.setdefault(dev, []).append((i, ws, traffic, vw))
    clusters: List[Cluster] = []
    for dev in sorted(by_dev):
        members = by_dev[dev]
        n_sub = (1 if not max_cluster_size
                 else max(1, math.ceil(len(members) / max_cluster_size)))
        # balanced contiguous chunks: sizes differ by at most one
        base, extra = divmod(len(members), n_sub)
        start = 0
        for k in range(n_sub):
            size = base + (1 if k < extra else 0)
            chunk = members[start:start + size]
            start += size
            if not chunk:
                continue
            clusters.append(Cluster(
                device=dev, tenants=[m[0] for m in chunk],
                ws_bytes=sum(m[1] for m in chunk),
                dma_bytes=sum(m[2] for m in chunk),
                var_weight=sum(m[3] for m in chunk)))
    return clusters


def _split_l2(clusters: Sequence[Cluster], l2_size: float,
              weights: Sequence[float], min_frac: float = 0.125) -> None:
    """Assign each cluster's ``l2_budget``: proportional to ``weights``
    with a ``min_frac``-of-equal-share floor (the same DORY-style rule
    as ``deploy.proportional_budgets``, over clusters instead of
    tenants).  The budgets must NEVER sum past ``l2_size`` — each is a
    subproblem's shared-L2 capacity bound, and a float-ulp overshoot in
    the rescale (``r * scale`` rounds each product independently) would
    let the union of cluster solutions exceed the physical L2 by a few
    bytes, making the reconciled joint plan infeasible — so any rounding
    excess is shaved off the largest budget."""
    n = len(clusters)
    total = sum(max(w, 0.0) for w in weights)
    equal = l2_size / n
    if total <= 0.0:
        for c in clusters:
            c.l2_budget = equal
        return
    floor = equal * min_frac
    raw = [max(floor, max(w, 0.0) / total * l2_size) for w in weights]
    scale = l2_size / sum(raw)
    vals = [r * scale for r in raw]
    excess = sum(vals) - l2_size
    if excess > 0.0:
        vals[max(range(n), key=lambda i: vals[i])] -= excess
    for c, v in zip(clusters, vals):
        c.l2_budget = v


def _split_dma(clusters: Sequence[Cluster]) -> None:
    """Assign each cluster's ``dma_scale``: the reciprocal of its traffic
    share, so a cluster owning fraction ``f`` of the fleet's DMA traffic
    prices its transfers at ``1/f`` bandwidth — every cluster then sees
    the full mix's DMA serialization time, which is exactly the
    conservative coupling the removed shared ``dma`` term provided."""
    total = sum(max(c.dma_bytes, 0.0) for c in clusters)
    for c in clusters:
        share = (max(c.dma_bytes, 0.0) / total) if total > 0.0 \
            else 1.0 / len(clusters)
        c.dma_scale = max(1.0 / max(share, 1e-9), 1.0)


def _solve_cluster(c: Cluster, graphs: Sequence[Graph], soc: SoC,
                   patterns: Sequence[Pattern], requested_tiles: int,
                   mode: str, node_limit: int,
                   warm: Optional[Sequence[Optional[TilingSolution]]],
                   seeds: Optional[Sequence[Sequence[TilingSolution]]],
                   cut_quanta: Optional[int] = None
                   ) -> Optional[List[TilingSolution]]:
    """Build and solve one cluster subproblem under its split budgets.
    Returns per-member solutions (cluster order) or ``None`` when the
    solve produced nothing within its budget (or a cut made the
    subproblem infeasible — the caller keeps the incumbent)."""
    cluster_graphs = [graphs[i] for i in c.tenants]
    try:
        problem = JointTilingProblem(
            cluster_graphs, soc, patterns,
            requested_tiles=requested_tiles, mode=mode,
            l2_budget=c.l2_budget, dma_scale=c.dma_scale)
        if cut_quanta is not None:
            problem.add_overflow_cut(cut_quanta)
            c.cuts += 1
        cluster_warm = ([warm[i] for i in c.tenants]
                        if warm is not None else None)
        if cluster_warm is not None and any(s is None
                                            for s in cluster_warm):
            cluster_warm = None
        cluster_seeds = [[s[i] for i in c.tenants] for s in (seeds or [])
                         if len(s) == len(graphs)]
        sols = problem.solve(warm=cluster_warm,
                             time_budget_s=c.time_budget_s,
                             node_limit=node_limit,
                             seeds=cluster_seeds or None)
    except cpsolver.Infeasible:
        return None
    c.solves += 1
    c.relaxation = sols[0].objective if sols else 0.0
    used = sum(solution_ws_bytes(g, s)
               for g, s in zip(cluster_graphs, sols))
    c.overflow_quanta = int(math.ceil(
        max(used - c.l2_budget, 0.0) / L2_QUANTUM))
    return sols


def solve_decomposed(
        graphs: Sequence[Graph], soc: SoC, patterns: Sequence[Pattern],
        *, requested_tiles: int = 16, mode: str = "matcha",
        time_budget_s: float = 6.0, node_limit: int = 200_000,
        warm: Optional[Sequence[Optional[TilingSolution]]] = None,
        seeds: Optional[Sequence[Sequence[TilingSolution]]] = None,
        evaluate: Optional[Callable[[List[TilingSolution]],
                                    Tuple[float, List[float]]]] = None,
        max_cut_rounds: int = 2,
        max_cluster_size: Optional[int] = None,
        max_workers: Optional[int] = None) -> Optional[DecomposeResult]:
    """Decomposed joint stage-1 solve over all ``graphs`` (module
    docstring has the full story).  ``evaluate`` maps a combined
    per-tenant solution list to ``(makespan_cycles,
    per_tenant_makespans)`` under the exact stage-2 schedule — without
    it the reconciliation loop is skipped (no cuts, single pass).
    Returns ``None`` when decomposition degenerates (fewer than two
    device clusters) or no cluster produced a solution — the caller's
    monolithic / best-response path then engages."""
    t0 = time.perf_counter()
    clusters = cluster_by_affinity(graphs, soc, patterns, requested_tiles,
                                   max_cluster_size=max_cluster_size)
    # degeneracy is judged on *device* clusters: a homogeneous mix stays
    # monolithic even when a size cap would chop it into sub-clusters
    if len({c.device for c in clusters}) < 2:
        return None
    _split_l2(clusters, float(soc.l2.size),
              [c.ws_bytes for c in clusters])
    _split_dma(clusters)
    shares = cpsolver.split_time_budget(
        time_budget_s, [c.var_weight for c in clusters])
    for c, s in zip(clusters, shares):
        c.time_budget_s = max(s, MIN_CLUSTER_BUDGET_S)

    def solve_round(work: Sequence[Tuple[Cluster, Optional[int]]]
                    ) -> List[Optional[List[TilingSolution]]]:
        pool_size = min(len(work), max_workers or len(work))
        with ThreadPoolExecutor(max_workers=max(pool_size, 1)) as pool:
            futs = [pool.submit(_solve_cluster, c, graphs, soc, patterns,
                                requested_tiles, mode, node_limit, warm,
                                seeds, cut)
                    for c, cut in work]
            return [f.result() for f in futs]

    per_cluster = solve_round([(c, None) for c in clusters])
    if any(s is None for s in per_cluster):
        return None

    def combine(sols_by_cluster: Sequence[List[TilingSolution]]
                ) -> List[TilingSolution]:
        out: List[Optional[TilingSolution]] = [None] * len(graphs)
        for c, sols in zip(clusters, sols_by_cluster):
            for i, s in zip(c.tenants, sols):
                out[i] = s
        return list(out)  # type: ignore[arg-type]

    combined = combine(per_cluster)
    total_cuts = 0
    rounds = 0
    best = combined
    best_makespan = max(c.relaxation for c in clusters)
    if evaluate is not None:
        makespan, per_tenant = evaluate(combined)
        best_makespan = makespan
        for r in range(max_cut_rounds):
            for c in clusters:
                c.realized = max((per_tenant[i] for i in c.tenants),
                                 default=0.0)
            violators = [c for c in clusters
                         if c.realized > c.relaxation * CUT_VIOLATION_TOL
                         and c.overflow_quanta > 0]
            if not violators:
                break
            rounds += 1
            # master reaction: grow the violators' L2 slices in
            # proportion to how far stage 2 says the relaxation lied
            weights = [c.ws_bytes * (c.realized
                                     / max(c.relaxation, 1e-9)
                                     if c in violators else 1.0)
                       for c in clusters]
            _split_l2(clusters, float(soc.l2.size), weights)
            resolved = solve_round(
                [(c, max(c.overflow_quanta - 1, 0)) for c in violators])
            total_cuts += len(violators)
            changed = False
            for c, sols in zip(violators, resolved):
                if sols is None:
                    continue             # cut infeasible: keep incumbent
                idx = clusters.index(c)
                per_cluster[idx] = sols
                changed = True
            if not changed:
                break
            combined = combine(per_cluster)
            makespan, per_tenant = evaluate(combined)
            if makespan < best_makespan:
                best, best_makespan = combined, makespan
            else:
                # any-time: the re-solve did not beat the incumbent
                # combination; stop cutting
                break

    return DecomposeResult(solutions=best, clusters=clusters,
                           rounds=rounds, cuts=total_cuts,
                           makespan=best_makespan,
                           wall_s=time.perf_counter() - t0)
