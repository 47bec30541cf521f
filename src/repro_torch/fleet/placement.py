"""Fleet-scale tenant placement: which model lives on which SoC.

The joint cross-tenant tiling CP already *prices* pairwise contention — the
``joint <= best-response`` gap says how much complementarity the
cross-tenant solve recovered when two models share one L2 and DMA
engine — so placement reuses it as the edge weight of an assignment
problem, exactly the way ``core/meshplan.py`` CP-assigns tensor classes
to mesh lanes one level down: SoCs are the "devices", tenants the
"tiles", coverage = every tenant hosted exactly once, capacity = per-SoC
tenant slots (replicas of one model class always land on distinct SoCs,
so per-SoC graph names stay unique and request routing by class name is
well defined).

:func:`place_contention_aware` is a CP/greedy hybrid:

  1. a greedy seed orders tenants by compile-alone cost and drops each
     on the SoC where the serving objective (worst-class replica
     dilution, :func:`capacity_ratio`) grows least;
  2. a ``cpsolver.CpModel`` with the meshplan coverage/capacity
     structure polishes the load balance (linear compile-alone loads,
     exactly-one coverage per tenant, per-SoC capacity, per-SoC
     ``add_load`` makespan terms; the greedy seed is the warm-start
     hint, so the CP never ships a worse assignment than the seed);
  3. a bounded move/swap local search re-introduces the pairwise
     contention terms the linear CP cannot express.

The :class:`ContentionModel` compiles each unordered class pair once on
the (homogeneous) template SoC — shared fleet-wide through the
:class:`PlanCache` — and records

    ``excess(a, b) = co_makespan(a, b) - max(alone_a, alone_b)``

the serialization beyond perfect overlap (0 = the pair co-resides for
free), plus ``complementarity(a, b) = (best_response - joint) /
best_response``, the joint-CP recovery fraction.  A SoC's predicted
round is ``max(max_alone, sum_alone - pairwise overlap savings)``; the
fleet objective built on it is :func:`capacity_ratio` — per-class
effective replica counts, not per-SoC round makespans, because a
serving fleet loses throughput when a light class queues behind a
heavy co-resident even if the pair's round barely exceeds the heavy
model's alone time.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import cpsolver
from repro_torch.core.deploy import (CompileRequest, DeploymentSession,
                               MultiCompiledModel)
from repro_torch.core.ir import Graph
from repro_torch.core.shapes import key_parts, remap_key
from repro_torch.serve.admission import Priority, RoundComposer
from repro_torch.serve.compiler_thread import BackgroundCompiler
from repro_torch.serve.engine import MultiModelEngine


@dataclasses.dataclass
class FleetConfig:
    """One homogeneous rack: ``n_socs`` identical SoCs built by
    ``soc_factory`` (returning ``(SoC, patterns)``), each hosting at
    most ``capacity`` co-resident tenants.  The compile budgets are the
    per-mix :class:`CompileRequest` budgets — fleet instantiation
    compiles one session per *distinct* class mix, so small budgets keep
    a 16-64-SoC fleet affordable."""
    soc_factory: Callable[[], Tuple[Any, Sequence[Any]]]
    n_socs: int
    capacity: int = 2
    requested_tiles: int = 4
    time_budget_s: float = 0.5
    joint_time_budget_s: float = 1.0
    lazy_joint_time_budget_s: float = 0.5
    incremental_time_budget_s: float = 0.5
    analysis: str = "strict"
    precompile: str = "all"          # "all" | "singles" | "none"
    execute: bool = False            # numeric execution in fleet engines
    max_batch: int = 1
    seed: int = 0
    # background compile pipeline: with async_compile on, every SoC
    # hosting a given class mix shares ONE BackgroundCompiler (a
    # max_workers pool over the mix's shared session) through the
    # PlanCache — identical compile keys dedupe fleet-wide, and misses
    # serve the compile-alone floor instead of stalling the round.
    # prefetch additionally compiles predicted-next occupancies
    # speculatively (the occupancy-lattice prefetcher).
    async_compile: bool = False
    prefetch: bool = False
    max_workers: int = 2
    # where every engine's parameters, request inputs and numeric
    # execution live: "cuda" (the card's kernels) unless the caller asks
    # for "cpu" (the kernels' plain torch versions).  Named explicitly on
    # every allocation: the current CUDA device is per thread
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.n_socs < 1:
            raise ValueError(f"n_socs must be >= 1: {self.n_socs}")
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1: {self.capacity}")
        if self.precompile not in ("all", "singles", "none"):
            raise ValueError(f"unknown precompile mode: {self.precompile}")
        if self.max_workers < 1:
            raise ValueError(f"max_workers must be >= 1: "
                             f"{self.max_workers}")


def transplant_solutions(src: DeploymentSession,
                         dst: DeploymentSession) -> int:
    """Copy the plan store's non-evicting solutions sidecar from ``src`` into
    ``dst`` for every occupancy whose member classes all exist in
    ``dst``, remapped to the destination's tenant indices.  The graphs
    are shared objects across a fleet's sessions, so the per-tenant
    tiling solutions stay valid — after a migration the destination's
    subset compiles warm-start from the source SoC's landed tilings
    instead of solving from scratch.  Returns the occupancy count
    seeded."""
    src_names = [g.name for g in src.request.graphs]
    dst_index = {g.name: i for i, g in enumerate(dst.request.graphs)}
    seeded = 0
    for key in src.store.solution_occupancies():
        occ, _ = key_parts(key)
        names = [src_names[i] for i in occ]
        if not all(n in dst_index for n in names):
            continue
        sols = src.store.solutions(key)
        if not sols:
            continue
        index_map = {i: dst_index[src_names[i]] for i in occ}
        mapped = {index_map[i]: sol for i, sol in sols.items()}
        # bucketed lattice points keep their bucket vector under the
        # destination's tenant indexing (a solution tiled for seq=1 must
        # never warm-start a seq=64 compile over there either)
        dst.store.seed_solutions(remap_key(key, index_map), mapped)
        seeded += 1
    return seeded


class PlanCache:
    """Fleet-wide compiled-artifact cache.

    The rack is homogeneous, so two SoCs hosting the same set of model
    classes share one ``DeploymentSession``/``MultiCompiledModel`` (and
    through it one occupancy-indexed ``PlanStore``) — engines keep all
    per-SoC queue/clock state, the compiled artifact carries none.
    Fleet instantiation therefore compiles each *distinct* mix exactly
    once, and a migration onto an already-seen mix is a cache hit whose
    recovery cost is the engine rebind, not a compile.

    Thread-safe: lookups and inserts hold the lock, compiles run outside
    it (a racing duplicate build is deterministic-identical; the first
    insert wins)."""

    def __init__(self, config: FleetConfig, graphs: Sequence[Graph]):
        self.config = config
        self.soc, self.patterns = config.soc_factory()
        self.classes: Dict[str, Graph] = {}
        for g in graphs:
            if g.name in self.classes:
                raise ValueError(f"duplicate model class name: {g.name}")
            self.classes[g.name] = g
        self._order = {n: i for i, n in enumerate(sorted(self.classes))}
        self._lock = threading.Lock()
        self._mcs: Dict[Tuple[str, ...], MultiCompiledModel] = {}
        self._params: Dict[str, Any] = {}
        self._build_info: Dict[Tuple[str, ...], Dict[str, Any]] = {}
        # one shared BackgroundCompiler per distinct mix (async_compile):
        # every SoC hosting the mix submits into the same pool, so an
        # identical compile key in flight anywhere dedupes fleet-wide
        self._compilers: Dict[Tuple[str, ...], BackgroundCompiler] = {}
        self._hits = 0
        self._builds = 0

    def key_for(self, names: Sequence[str]) -> Tuple[str, ...]:
        """Canonical cache key: the sorted class-name tuple.  Duplicate
        or unknown classes are placement bugs and raise."""
        key = tuple(sorted(names))
        if len(set(key)) != len(key):
            raise ValueError(f"duplicate class on one SoC: {key}")
        for n in key:
            if n not in self.classes:
                raise ValueError(f"unknown model class: {n}")
        if not key:
            raise ValueError("empty class set")
        return key

    def has(self, names: Sequence[str]) -> bool:
        key = tuple(sorted(names))
        with self._lock:
            return key in self._mcs

    def _subsets(self, n: int) -> List[List[int]]:
        if self.config.precompile == "none" or n == 1:
            return []
        if self.config.precompile == "singles" or n > 3:
            return [[i] for i in range(n)]
        ids = list(range(n))
        return [list(c) for r in range(1, n)
                for c in itertools.combinations(ids, r)]

    def mc_for(self, names: Sequence[str],
               warm_from: Sequence[DeploymentSession] = ()
               ) -> MultiCompiledModel:
        """The compiled artifact for this class mix (building and
        precompiling subset occupancies on first use).  ``warm_from``
        sessions donate their solutions sidecar to a fresh build (see
        :func:`transplant_solutions`) — the migration warm-start path."""
        key = self.key_for(names)
        with self._lock:
            got = self._mcs.get(key)
            if got is not None:
                self._hits += 1
                return got
        t0 = time.perf_counter()
        graphs = [self.classes[n] for n in key]
        cfg = self.config
        session = DeploymentSession(CompileRequest(
            graphs=graphs, soc=self.soc, patterns=self.patterns,
            requested_tiles=cfg.requested_tiles,
            time_budget_s=cfg.time_budget_s,
            joint_time_budget_s=cfg.joint_time_budget_s,
            lazy_joint_time_budget_s=cfg.lazy_joint_time_budget_s,
            incremental_time_budget_s=cfg.incremental_time_budget_s,
            analysis=cfg.analysis))
        seeded = 0
        for src in warm_from:
            if src is not None:
                seeded += transplant_solutions(src, session)
        mc = session.compile(precompile=self._subsets(len(key)))
        wall = time.perf_counter() - t0
        with self._lock:
            if key not in self._mcs:
                self._mcs[key] = mc
                self._builds += 1
                self._build_info[key] = {"wall_s": wall,
                                         "seeded_occupancies": seeded}
            return self._mcs[key]

    def compiler_for(self, names: Sequence[str]
                     ) -> Optional[BackgroundCompiler]:
        """The mix's shared background compile pool (built on first use
        over the mix's shared session, ``config.max_workers`` threads,
        prefetcher per ``config.prefetch``).  Returns ``None`` when the
        compiled artifact carries no session.  Sharing one compiler per
        mix is the fleet-wide dedup: a compile key queued or in flight
        for *any* SoC hosting the mix bounces every other SoC's submit
        of the same key."""
        key = self.key_for(names)
        mc = self.mc_for(key)
        session = getattr(mc, "session", None)
        if session is None:
            return None
        with self._lock:
            got = self._compilers.get(key)
            if got is None:
                got = BackgroundCompiler(
                    session, max_workers=self.config.max_workers,
                    prefetch=self.config.prefetch)
                self._compilers[key] = got
            return got

    def stop_compilers(self, timeout_s: float = 30.0) -> None:
        """Stop every mix's background compile pool (shutdown barrier
        for benchmarks and tests)."""
        with self._lock:
            compilers = list(self._compilers.values())
        for c in compilers:
            c.stop(timeout_s=timeout_s)

    def build_info(self, names: Sequence[str]) -> Optional[Dict[str, Any]]:
        with self._lock:
            got = self._build_info.get(tuple(sorted(names)))
            return dict(got) if got is not None else None

    def params_for(self, name: str):
        """Per-class parameter arrays, deterministic in the class name —
        every engine (and every migration destination) serving a class
        uses bitwise the same parameters, which is what makes
        cross-SoC migration numerics comparable."""
        with self._lock:
            got = self._params.get(name)
        if got is not None:
            return got
        from repro_torch.core.runtime import init_params
        params = init_params(self.classes[name],
                             seed=self.config.seed + self._order[name],
                             device=self.config.device)
        with self._lock:
            return self._params.setdefault(name, params)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"hits": self._hits, "builds": self._builds,
                    "mixes": sorted("+".join(k) for k in self._mcs),
                    "build_wall_s": {"+".join(k): round(v["wall_s"], 3)
                                     for k, v in self._build_info.items()},
                    "compilers": {"+".join(k): c.stats()
                                  for k, c in self._compilers.items()}}

    def cycles_to_s(self, cycles: float) -> float:
        return self.soc.cycles_to_ms(cycles) / 1e3


class ContentionModel:
    """Pairwise co-residency contention predictor over the fleet's model
    classes, derived from the joint-CP cost model itself: each unordered
    pair is co-compiled once (through the shared :class:`PlanCache`, so
    a placement that actually creates the pair reuses the artifact) and
    scored by its makespan excess over perfect overlap.  Single-threaded
    by design — placement runs before serving starts."""

    def __init__(self, cache: PlanCache):
        self.cache = cache
        self._alone: Dict[str, float] = {}
        self._pair: Dict[Tuple[str, str], float] = {}
        self._compl: Dict[Tuple[str, str], float] = {}

    def alone_s(self, name: str) -> float:
        got = self._alone.get(name)
        if got is None:
            mc = self.cache.mc_for((name,))
            got = self.cache.cycles_to_s(mc.plan.makespan)
            self._alone[name] = got
        return got

    def _pair_key(self, a: str, b: str) -> Tuple[str, str]:
        return (a, b) if a <= b else (b, a)

    def pair_s(self, a: str, b: str,
               warm_from: Sequence[DeploymentSession] = ()) -> float:
        """Co-makespan of the pair, seconds.  ``warm_from`` sessions
        warm-start a first-time pair compile (the rebalancer's
        destination probe passes the migration donors, so the probe
        build is seeded the same way the re-host would be)."""
        key = self._pair_key(a, b)
        got = self._pair.get(key)
        if got is None:
            mc = self.cache.mc_for(key, warm_from=warm_from)
            got = self.cache.cycles_to_s(mc.plan.makespan)
            self._pair[key] = got
            br = mc.best_response_makespan_cycles
            self._compl[key] = ((br - mc.plan.makespan) / br) if br else 0.0
        return got

    def excess_s(self, a: str, b: str) -> float:
        """Serialization beyond perfect overlap: 0 means the pair
        co-resides for free, ``min(alone_a, alone_b)`` means fully
        serialized — the placement edge weight."""
        return max(0.0, self.pair_s(a, b)
                   - max(self.alone_s(a), self.alone_s(b)))

    def complementarity(self, a: str, b: str) -> float:
        """``(best_response - joint) / best_response`` for the pair: how
        much of the co-residency cost the joint cross-tenant CP solve
        recovered over per-tenant best-response re-tiling."""
        self.pair_s(a, b)
        return self._compl[self._pair_key(a, b)]

    def predict_round_s(self, names: Sequence[str],
                        warm_from: Sequence[DeploymentSession] = ()
                        ) -> float:
        """Predicted co-scheduled round makespan for a SoC hosting
        ``names``: the compile-alone sum minus pairwise overlap savings
        (``alone_a + alone_b - pair``), floored by the largest member —
        exact for 0-2 tenants, a pairwise estimator above that."""
        names = list(names)
        if not names:
            return 0.0
        alones = [self.alone_s(n) for n in names]
        if len(names) == 1:
            return alones[0]
        saving = sum(
            max(0.0, self.alone_s(a) + self.alone_s(b)
                - self.pair_s(a, b, warm_from=warm_from))
            for a, b in itertools.combinations(names, 2))
        return max(max(alones), sum(alones) - saving)

    def slowdown(self, names: Sequence[str],
                 warm_from: Sequence[DeploymentSession] = ()) -> float:
        """Worst relative service-latency inflation any member of this
        co-residency set suffers: ``predicted round / alone``, maxed
        over members.  This — not the raw round makespan — is the
        placement objective: a light model next to a heavy one pays the
        heavy model's round per request even when the pair's *excess*
        is near zero, and that throughput collapse is exactly the
        contention a serving fleet must avoid."""
        names = list(names)
        if not names:
            return 0.0
        round_s = self.predict_round_s(names, warm_from=warm_from)
        return max(round_s / self.alone_s(n) for n in names)

    def edges(self) -> Dict[str, Dict[str, float]]:
        """All scored pair edges so far (reporting surface)."""
        return {"+".join(k): {"pair_s": v,
                              "excess_s": self.excess_s(*k),
                              "slowdown": self.slowdown(k),
                              "complementarity": self._compl[k]}
                for k, v in sorted(self._pair.items())}


# ---------------------------------------------------------------------------
# Placement strategies
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Placement:
    """An assignment of tenants to SoCs: ``assignment[s]`` is the sorted
    class-name tuple SoC ``s`` hosts (possibly empty).
    ``max_rho`` is the serving objective (see
    :func:`balanced_utilization`): the bottleneck SoC's utilization
    under optimally-split demand — below 1.0 the fleet clears the
    demand shape, above it some class must backlog.  ``capacity_ratio``
    is the saturated worst-case replica-dilution diagnostic.

    ``demand_split[s][c]`` is the fraction of class ``c``'s demand the
    balanced-utilization solve directed at SoC ``s`` — the routing
    table this placement implies.  The router takes it as a pacing
    prior (:class:`~repro_torch.fleet.router.FleetRouter`): a placement is
    only as good as the split that realizes its ``max_rho``, and a
    myopic per-request router does not discover that split on its
    own."""
    assignment: List[Tuple[str, ...]]
    method: str
    predicted_round_s: List[float] = dataclasses.field(default_factory=list)
    objective_s: float = 0.0
    max_rho: float = 0.0
    capacity_ratio: float = 1.0
    demand_split: List[Dict[str, float]] = dataclasses.field(
        default_factory=list)
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def tenants(self) -> List[str]:
        return [n for names in self.assignment for n in names]


def capacity_ratio(socs: Sequence[Sequence[str]],
                   contention: ContentionModel) -> float:
    """The placement objective: worst-class replica dilution.

    A co-scheduled round on a SoC hosting mix ``S`` serves one request
    of each busy co-resident per ``round(S)`` seconds, so a replica of
    class ``c`` hosted there contributes ``alone_c / round(S)`` of an
    *effective* replica (1.0 when alone, near 0 for a light model
    queued behind a heavy co-resident — even when the pair's makespan
    *excess* is tiny).  With open-loop demand proportional to
    ``replicas_c / alone_c``, the class that backlogs first is the one
    with the largest

        ``replicas_c / sum_{s hosting c} alone_c / round(s)``

    and that max is what contention-aware placement minimizes.  The
    max-round objective alone gets this badly wrong: it happily parks
    light classes under heavy ones ("free" by excess) and starves
    them."""
    eff = effective_replicas(socs, contention)
    count: Dict[str, int] = {}
    for s in socs:
        for name in s:
            count[name] = count.get(name, 0) + 1
    return max((count[n] / eff[n] for n in count), default=1.0)


def effective_replicas(socs: Sequence[Sequence[str]],
                       contention: ContentionModel) -> Dict[str, float]:
    """Per-class effective replica count under an assignment: each
    replica contributes ``alone / predicted round`` of its SoC's mix —
    its saturated service rate relative to serving alone.  A
    worst-case (all co-residents saturated) diagnostic; the demand-
    aware capacity analytic is :func:`balanced_utilization`."""
    eff: Dict[str, float] = {}
    for s in socs:
        if not s:
            continue
        round_s = contention.predict_round_s(s)
        for name in s:
            eff[name] = eff.get(name, 0.0) \
                + contention.alone_s(name) / round_s
    return eff


def default_demand(tenants: Sequence[str],
                   contention: ContentionModel) -> Dict[str, float]:
    """The rate-free demand shape: every class arrives in proportion to
    its replica count times its alone service rate (each replica is
    meant to be equally busy).  Utilization under
    :func:`balanced_utilization` is linear in demand, so any uniform
    scale gives the same placement ranking."""
    counts: Dict[str, int] = {}
    for t in tenants:
        counts[t] = counts.get(t, 0) + 1
    return {c: n / contention.alone_s(c) for c, n in counts.items()}


def soc_utilization(names: Sequence[str], rates: Dict[str, float],
                    contention: ContentionModel) -> float:
    """Fraction of this SoC's time spent serving per-class arrival
    rates ``rates`` (req/s), under nested-busy round composition: with
    per-class rates sorted descending, the busiest class runs
    ``lam_1 - lam_2`` solo rounds, the top two ``lam_2 - lam_3`` joint
    rounds, and so on — each joint round serving one request of every
    member, at the contention model's predicted round length.  This is
    the analytic mirror of ``MultiModelEngine`` rounds: a co-resident
    with an empty queue costs nothing, a busy light co-resident rides a
    heavy partner's round for just the pair's makespan excess.
    ``>= 1`` means the SoC cannot keep up."""
    active = sorted((n for n in names if rates.get(n, 0.0) > 0.0),
                    key=lambda n: (-rates[n], n))
    rho = 0.0
    for i, n in enumerate(active):
        lam = rates[n]
        lam_next = rates[active[i + 1]] if i + 1 < len(active) else 0.0
        rho += (lam - lam_next) \
            * contention.predict_round_s(active[:i + 1])
    return rho


def balanced_utilization(socs: Sequence[Sequence[str]],
                         contention: ContentionModel,
                         demand: Dict[str, float],
                         iters: int = 120
                         ) -> Tuple[float, List[float],
                                    List[Dict[str, float]]]:
    """Minimized bottleneck utilization when per-class demand is split
    across each class's hosts — the static analogue of what the fleet
    router does per request.  Demand starts proportional to each
    host's saturated service share, then a bounded descent repeatedly
    shifts a fraction of some class's rate off the bottleneck SoC onto
    the co-host where it hurts least.  Returns ``(max_rho, per_soc_rho,
    split)`` where ``split[s][c]`` is the per-SoC rate allocation that
    realizes ``max_rho`` — the routing table the placement implies; a
    placement whose ``max_rho`` exceeds 1.0 cannot clear ``demand`` no
    matter how the router spreads it."""
    socs = [list(s) for s in socs]
    hosts: Dict[str, List[int]] = {}
    for s, names in enumerate(socs):
        for n in names:
            hosts.setdefault(n, []).append(s)
    split: List[Dict[str, float]] = [{} for _ in socs]
    for c, lam in demand.items():
        at = hosts.get(c)
        if not at or lam <= 0.0:
            continue
        w = [contention.alone_s(c) / contention.predict_round_s(socs[s])
             for s in at]
        tot = sum(w)
        for s, wi in zip(at, w):
            split[s][c] = lam * wi / tot
    rho = [soc_utilization(socs[s], split[s], contention)
           for s in range(len(socs))]
    for _ in range(iters):
        b = max(range(len(socs)), key=lambda s: rho[s])
        best = None
        for c, lam in split[b].items():
            if lam <= 0.0 or len(hosts[c]) < 2:
                continue
            for s2 in hosts[c]:
                if s2 == b:
                    continue
                for frac in (0.5, 0.2, 0.05):
                    delta = lam * frac
                    r_b = dict(split[b])
                    r_b[c] = lam - delta
                    r_2 = dict(split[s2])
                    r_2[c] = r_2.get(c, 0.0) + delta
                    nb = soc_utilization(socs[b], r_b, contention)
                    n2 = soc_utilization(socs[s2], r_2, contention)
                    if max(nb, n2) < max(rho[b], rho[s2]) - 1e-12:
                        key = max(nb, n2)
                        if best is None or key < best[0]:
                            best = (key, c, s2, delta, nb, n2)
                        break
        if best is None:
            break
        _, c, s2, delta, nb, n2 = best
        split[b][c] -= delta
        split[s2][c] = split[s2].get(c, 0.0) + delta
        rho[b], rho[s2] = nb, n2
    return max(rho, default=0.0), rho, split


def _check_workload(tenants: Sequence[str], n_socs: int,
                    capacity: int) -> None:
    if len(tenants) > n_socs * capacity:
        raise ValueError(f"{len(tenants)} tenants exceed fleet capacity "
                         f"{n_socs} x {capacity}")
    counts: Dict[str, int] = {}
    for t in tenants:
        counts[t] = counts.get(t, 0) + 1
    worst = max(counts.values(), default=0)
    if worst > n_socs:
        raise ValueError(f"a class has {worst} replicas but only "
                         f"{n_socs} SoCs exist (replicas need distinct "
                         f"SoCs)")


def _finish(socs: List[List[str]], method: str,
            contention: Optional[ContentionModel],
            stats: Optional[Dict[str, Any]] = None,
            demand: Optional[Dict[str, float]] = None) -> Placement:
    assignment = [tuple(sorted(s)) for s in socs]
    predicted: List[float] = []
    ratio, rho = 1.0, 0.0
    shares: List[Dict[str, float]] = []
    if contention is not None:
        predicted = [contention.predict_round_s(s) for s in assignment]
        ratio = capacity_ratio(assignment, contention)
        if demand is None:
            demand = default_demand([n for s in assignment for n in s],
                                    contention)
        rho, _, split = balanced_utilization(assignment, contention,
                                             demand)
        totals: Dict[str, float] = {}
        for per_soc in split:
            for c, lam in per_soc.items():
                totals[c] = totals.get(c, 0.0) + lam
        shares = [{c: lam / totals[c] for c, lam in per_soc.items()
                   if totals.get(c, 0.0) > 0.0}
                  for per_soc in split]
    return Placement(assignment=assignment, method=method,
                     predicted_round_s=predicted,
                     objective_s=max(predicted, default=0.0),
                     max_rho=rho, capacity_ratio=ratio,
                     demand_split=shares,
                     stats=dict(stats or {}))


def _objective(socs: Sequence[Sequence[str]],
               contention: ContentionModel,
               demand: Dict[str, float]
               ) -> Tuple[float, float, float]:
    """What the optimizer minimizes, lexicographic: bottleneck
    utilization under balanced demand, then total utilization (spare
    fleet headroom), then the makespan round."""
    max_rho, rho, _ = balanced_utilization(socs, contention, demand)
    rounds = [contention.predict_round_s(s) for s in socs if s]
    return (max_rho, sum(rho), max(rounds, default=0.0))


def place_round_robin(tenants: Sequence[str], n_socs: int, capacity: int,
                      contention: Optional[ContentionModel] = None,
                      demand: Optional[Dict[str, float]] = None
                      ) -> Placement:
    """Deal tenants across SoCs in submission order, skipping SoCs that
    are full or already host the class — the classic contention-blind
    baseline."""
    _check_workload(tenants, n_socs, capacity)
    socs: List[List[str]] = [[] for _ in range(n_socs)]
    for i, t in enumerate(tenants):
        for off in range(n_socs):
            s = (i + off) % n_socs
            if len(socs[s]) < capacity and t not in socs[s]:
                socs[s].append(t)
                break
        else:
            raise ValueError(f"no feasible SoC for tenant {t!r}")
    return _finish(socs, "round_robin", contention, demand=demand)


def place_random(tenants: Sequence[str], n_socs: int, capacity: int,
                 contention: Optional[ContentionModel] = None,
                 seed: int = 0, max_attempts: int = 50,
                 demand: Optional[Dict[str, float]] = None) -> Placement:
    """Uniform-random feasible assignment (the other baseline).  Near a
    full rack a sequential random deal can dead-end (the remaining
    slots all sit on SoCs already hosting the remaining class), so it
    redraws — still seed-deterministic — up to ``max_attempts``
    times."""
    _check_workload(tenants, n_socs, capacity)
    rng = random.Random(seed)
    for attempt in range(max_attempts):
        socs: List[List[str]] = [[] for _ in range(n_socs)]
        dead_end = False
        for t in tenants:
            feasible = [s for s in range(n_socs)
                        if len(socs[s]) < capacity and t not in socs[s]]
            if not feasible:
                dead_end = True
                break
            socs[rng.choice(feasible)].append(t)
        if not dead_end:
            return _finish(socs, "random", contention,
                           {"seed": seed, "attempts": attempt + 1},
                           demand=demand)
    raise ValueError(f"no feasible random assignment after "
                     f"{max_attempts} attempts (seed {seed})")


def _cp_polish(tenants: Sequence[str], n_socs: int, capacity: int,
               alone: Sequence[float], seed_socs: List[List[str]],
               node_limit: int, time_budget_s: float
               ) -> Tuple[Optional[List[List[str]]], Dict[str, Any]]:
    """The meshplan-structured CP: binary y[t][s], exactly-one coverage
    per tenant, per-SoC capacity and same-class exclusion, one
    ``add_load`` makespan term per SoC over the compile-alone costs.
    The greedy seed is the warm-start hint, so the polished assignment
    is never worse than the seed *on this linear objective*."""
    T = len(tenants)
    if T == 0 or T * n_socs > 4096:
        return None, {"cp": "skipped", "vars": T * n_socs}
    model = cpsolver.CpModel()
    y = [[model.new_int(0, 1, f"y{t}_{s}") for s in range(n_socs)]
         for t in range(T)]
    for t in range(T):
        model.add_eq({y[t][s]: 1.0 for s in range(n_socs)}, -1.0)
    for s in range(n_socs):
        model.add_le({y[t][s]: 1.0 for t in range(T)}, -float(capacity))
        model.add_load({y[t][s]: float(alone[t]) for t in range(T)})
    by_class: Dict[str, List[int]] = {}
    for t, name in enumerate(tenants):
        by_class.setdefault(name, []).append(t)
    for name, ids in by_class.items():
        if len(ids) > 1:
            for s in range(n_socs):
                model.add_le({y[t][s]: 1.0 for t in ids}, -1.0)
    hint = [0] * model.num_vars
    used = [list(s) for s in seed_socs]
    for t, name in enumerate(tenants):
        for s in range(n_socs):
            if name in used[s]:
                used[s].remove(name)
                hint[y[t][s]] = 1
                break
    try:
        sol = model.solve(hint=hint, node_limit=node_limit,
                          time_budget_s=time_budget_s)
    except cpsolver.Infeasible:
        return None, {"cp": "infeasible", "vars": T * n_socs}
    socs: List[List[str]] = [[] for _ in range(n_socs)]
    for t in range(T):
        for s in range(n_socs):
            if sol.values[y[t][s]]:
                socs[s].append(tenants[t])
                break
    return socs, {"cp": "solved", "vars": T * n_socs,
                  "nodes": sol.nodes, "optimal": sol.optimal,
                  "objective_s": sol.objective}


def _better(a: Tuple[float, ...], b: Tuple[float, ...]) -> bool:
    """Lexicographic strict improvement with a tolerance per term."""
    for x, y in zip(a, b):
        if x < y - 1e-12:
            return True
        if x > y + 1e-12:
            return False
    return False


def _local_search(socs: List[List[str]], capacity: int,
                  contention: ContentionModel,
                  demand: Dict[str, float], max_iters: int
                  ) -> Tuple[List[List[str]], int]:
    """Bounded move/swap descent on the full objective the linear CP
    cannot see (:func:`_objective` — bottleneck utilization under
    balanced demand).  Moves re-home one tenant; swaps exchange two
    tenants across SoCs.  Pairwise round predictions are memoized in
    the :class:`ContentionModel`, so a full objective re-evaluation per
    candidate is arithmetic, not compiles."""
    n = len(socs)
    socs = [list(s) for s in socs]

    iters = 0
    improved = True
    while improved and iters < max_iters:
        improved = False
        iters += 1
        current = _objective(socs, contention, demand)
        # visit the busiest SoCs first — the dilution/makespan terms
        # are maxima, and only their argmax SoCs can lower them
        by_round = sorted(range(n),
                          key=lambda s: -contention.predict_round_s(
                              socs[s]))
        for s1 in by_round:
            for t in list(socs[s1]):
                rest1 = [x for x in socs[s1] if x != t]
                # move t -> s2
                for s2 in range(n):
                    if s2 == s1 or len(socs[s2]) >= capacity \
                            or t in socs[s2]:
                        continue
                    trial = list(socs)
                    trial[s1], trial[s2] = rest1, socs[s2] + [t]
                    if _better(_objective(trial, contention, demand),
                               current):
                        socs[s1].remove(t)
                        socs[s2].append(t)
                        improved = True
                        break
                if improved:
                    break
                # swap t <-> u
                for s2 in range(n):
                    if s2 == s1:
                        continue
                    for u in list(socs[s2]):
                        if u == t or u in rest1 or t in socs[s2]:
                            continue
                        rest2 = [x for x in socs[s2] if x != u]
                        trial = list(socs)
                        trial[s1], trial[s2] = rest1 + [u], rest2 + [t]
                        if _better(_objective(trial, contention, demand),
                                   current):
                            socs[s1].remove(t)
                            socs[s2].remove(u)
                            socs[s1].append(u)
                            socs[s2].append(t)
                            improved = True
                            break
                    if improved:
                        break
                if improved:
                    break
            if improved:
                break
    return socs, iters


def place_contention_aware(tenants: Sequence[str], n_socs: int,
                           capacity: int, contention: ContentionModel,
                           demand: Optional[Dict[str, float]] = None,
                           use_cp: bool = True,
                           cp_node_limit: int = 20_000,
                           cp_time_budget_s: float = 2.0,
                           max_iters: int = 200) -> Placement:
    """The CP/greedy hybrid (see module docstring): greedy seed ->
    linear CP load-balance polish -> pairwise move/swap descent; the
    shipped assignment is whichever candidate scores best on the full
    contention objective (:func:`_objective` — bottleneck utilization
    under balanced per-class ``demand``, req/s; defaults to the
    rate-free :func:`default_demand` shape).  The round-robin deal is
    always one of the descent starts, so the hybrid never ships an
    assignment its own objective scores worse than that baseline."""
    _check_workload(tenants, n_socs, capacity)
    tenants = list(tenants)
    alone = [contention.alone_s(t) for t in tenants]
    if demand is None:
        demand = default_demand(tenants, contention)

    # 1. greedy seed: heaviest tenant first, least objective growth over
    # the partially-built assignment
    socs: List[List[str]] = [[] for _ in range(n_socs)]
    for i in sorted(range(len(tenants)), key=lambda i: -alone[i]):
        t = tenants[i]
        best: Optional[Tuple[Tuple[Tuple[float, ...], int, int], int]] = None
        for s in range(n_socs):
            if len(socs[s]) >= capacity or t in socs[s]:
                continue
            trial = list(socs)
            trial[s] = socs[s] + [t]
            key = (_objective(trial, contention, demand),
                   len(socs[s]), s)
            if best is None or key < best[0]:
                best = (key, s)
        if best is None:
            raise ValueError(f"no feasible SoC for tenant {t!r}")
        socs[best[1]].append(t)
    stats: Dict[str, Any] = {
        "seed_max_rho": _objective(socs, contention, demand)[0]}

    # 2. CP polish of the linear load balance (meshplan structure), plus
    # the round-robin deal as a never-worse-than-baseline start
    candidates = [socs,
                  [list(s) for s in place_round_robin(
                      tenants, n_socs, capacity).assignment]]
    if use_cp:
        polished, cp_stats = _cp_polish(tenants, n_socs, capacity, alone,
                                        socs, cp_node_limit,
                                        cp_time_budget_s)
        stats.update(cp_stats)
        if polished is not None:
            candidates.append(polished)

    # 3. pairwise move/swap descent from every candidate; best wins
    best_socs, best_obj = None, None
    total_iters = 0
    for cand in candidates:
        searched, iters = _local_search(cand, capacity, contention,
                                        demand, max_iters)
        total_iters += iters
        obj = _objective(searched, contention, demand)
        if best_obj is None or obj < best_obj:
            best_socs, best_obj = searched, obj
    stats["search_iters"] = total_iters
    return _finish(best_socs, "contention_aware", contention, stats,
                   demand=demand)


# ---------------------------------------------------------------------------
# The simulated fleet
# ---------------------------------------------------------------------------


class SoCInstance:
    """One simulated SoC in the fleet: the shared compiled artifact for
    its class mix (via the :class:`PlanCache`) plus its *own*
    :class:`MultiModelEngine` — queues, the analytic serving clock and
    SLO state are strictly per-SoC.  Re-hosting (migration) retires the
    current engine into ``retired`` (its served history keeps counting)
    and binds a fresh engine over the new mix, carrying the clock
    forward."""

    def __init__(self, soc_id: int, cache: PlanCache, config: FleetConfig):
        self.soc_id = soc_id
        self.cache = cache
        self.config = config
        self.classes: Tuple[str, ...] = ()
        self.mc: Optional[MultiCompiledModel] = None
        self.engine: Optional[MultiModelEngine] = None
        self.retired: List[MultiModelEngine] = []
        self.epoch = 0
        self.failed = False
        self.draining = False

    @property
    def accepting(self) -> bool:
        """Routable: hosted, not failed, not draining."""
        return (self.engine is not None and not self.failed
                and not self.draining)

    def hosts(self, name: str) -> bool:
        return name in self.classes

    def host(self, class_names: Sequence[str],
             at_s: Optional[float] = None,
             warm_from: Sequence[DeploymentSession] = ()) -> float:
        """(Re)bind this SoC to host exactly ``class_names``; returns
        the wall seconds spent (compile on a cache miss, engine rebind
        on a hit) — the rebalancer's per-migration recovery latency.
        ``at_s`` advances the new engine's clock to the rebind instant
        (never backwards)."""
        t0 = time.perf_counter()
        key = self.cache.key_for(class_names)
        mc = self.cache.mc_for(key, warm_from=warm_from)
        params = [self.cache.params_for(n) for n in key]
        clock = self.engine.clock_s if self.engine is not None else 0.0
        if at_s is not None:
            clock = max(clock, at_s)
        if self.engine is not None:
            self.retired.append(self.engine)
            self.epoch += 1
        compiler = (self.cache.compiler_for(key)
                    if self.config.async_compile else None)
        eng = MultiModelEngine(mc, params_list=params,
                               composer=RoundComposer(),
                               execute=self.config.execute,
                               max_batch=self.config.max_batch,
                               async_compile=(compiler if compiler
                                              is not None else False),
                               device=self.config.device)
        if compiler is not None and len(key) > 1:
            # this SoC's tenant set seeds the occupancy-lattice
            # prefetcher: the singleton and leave-one-out occupancies
            # are the Hamming-1 shells around the hosted full house —
            # the mixes serving actually dispatches as queues churn
            n = len(key)
            occs = [[i] for i in range(n)]
            if n > 2:
                occs += [[j for j in range(n) if j != i]
                         for i in range(n)]
            compiler.prefetch_hint(occs)
        eng.advance_clock(clock)
        self.classes, self.mc, self.engine = key, mc, eng
        return time.perf_counter() - t0

    def engine_at(self, epoch: int) -> Optional[MultiModelEngine]:
        """The engine that was current at ``epoch`` (retired engines
        stay addressable — served history and result lookup survive a
        migration rebuild)."""
        if epoch < len(self.retired):
            return self.retired[epoch]
        if epoch == self.epoch:
            return self.engine
        return None

    def engines(self) -> List[MultiModelEngine]:
        out = list(self.retired)
        if self.engine is not None:
            out.append(self.engine)
        return out

    @property
    def clock_s(self) -> float:
        return self.engine.clock_s if self.engine is not None else 0.0

    def backlog_s(self) -> float:
        return self.engine.backlog_s() if self.engine is not None else 0.0


class Fleet:
    """A homogeneous rack of :class:`SoCInstance`\\ s over one shared
    :class:`PlanCache` and one :class:`ContentionModel`."""

    def __init__(self, config: FleetConfig, graphs: Sequence[Graph],
                 cache: Optional[PlanCache] = None,
                 contention: Optional[ContentionModel] = None):
        """``cache``/``contention`` let several fleets (e.g. a benchmark
        comparing placements over the same rack) share one compiled-
        artifact cache and one scored contention model — engines and
        instances stay per-fleet."""
        self.config = config
        self.cache = cache if cache is not None else PlanCache(config,
                                                               graphs)
        self.contention = (contention if contention is not None
                           else ContentionModel(self.cache))
        self.instances = [SoCInstance(i, self.cache, config)
                          for i in range(config.n_socs)]

    def apply_placement(self, placement: Placement) -> None:
        if len(placement.assignment) != len(self.instances):
            raise ValueError(
                f"placement covers {len(placement.assignment)} SoCs, "
                f"fleet has {len(self.instances)}")
        for inst, names in zip(self.instances, placement.assignment):
            if names:
                inst.host(names)

    def stop_compilers(self, timeout_s: float = 30.0) -> None:
        """Stop the shared per-mix background compile pools (see
        :meth:`PlanCache.stop_compilers`)."""
        self.cache.stop_compilers(timeout_s=timeout_s)

    def live(self) -> List[SoCInstance]:
        return [i for i in self.instances if not i.failed]

    def hosts_of(self, name: str) -> List[SoCInstance]:
        """Accepting SoCs that host ``name`` (routing candidates)."""
        return [i for i in self.instances
                if i.accepting and i.hosts(name)]

    def engines(self) -> List[MultiModelEngine]:
        return [e for inst in self.instances for e in inst.engines()]

    def makespan_s(self) -> float:
        """Trace makespan: the latest analytic clock any engine (live,
        retired or failed) reached — when the last queued work finished
        anywhere in the fleet."""
        return max((e.clock_s for e in self.engines()), default=0.0)

    def aggregate(self) -> Dict[str, Any]:
        """Fleet-wide serving stats, summed over every engine epoch."""
        engines = self.engines()
        done = [r for e in engines for r in e.done.values()]
        with_dl = [r for r in done if r.deadline_met is not None]
        per_class: Dict[str, Dict[str, Any]] = {}
        for p in Priority:
            reqs = [r for r in done if r.priority == p]
            pdl = [r for r in reqs if r.deadline_met is not None]
            met = sum(1 for r in pdl if r.deadline_met)
            per_class[p.name] = {
                "served": len(reqs),
                "slo_total": len(pdl),
                "slo_met": met,
                "slo_attainment": met / len(pdl) if pdl else None,
            }
        return {
            "socs": len(self.instances),
            "live_socs": len(self.live()),
            "served": len(done),
            "rejected": sum(len(e.rejected) for e in engines),
            "rounds": sum(e.rounds for e in engines),
            "floor_rounds": sum(e.floor_rounds for e in engines),
            "starvation_events": sum(e.starvation_events()
                                     for e in engines),
            "makespan_s": self.makespan_s(),
            "slo_attainment": (sum(1 for r in with_dl if r.deadline_met)
                               / len(with_dl) if with_dl else None),
            "per_class": per_class,
            "plan_cache": self.cache.stats(),
        }
