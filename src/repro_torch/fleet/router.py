"""Fleet request routing: which SoC serves each arriving request.

The router is the fleet's front door.  Every request names a model
*class*; the router picks among the SoCs currently hosting that class by
predicted completion time, built from observable per-SoC engine state —
no oracle knowledge of the trace:

    ``score(soc) = max(clock_s, arrival) + (own_depth + 1) * round_cost
                   + co_resident_depth * round_dilation``

The estimate is *round-structured*, matching how the engine actually
serves: every round co-schedules the head of each non-empty queue, so a
request of class ``c`` landing with ``own_depth`` same-class requests
ahead of it completes after ``own_depth + 1`` more rounds containing
``c`` — co-resident backlog does not delay it serially, it rides the
same joint rounds.  A serial estimate (total backlog ahead) would steer
traffic away from exactly the SoCs where a class is cheapest to serve,
scattering classes onto solo rounds and forfeiting the co-scheduling
throughput the placement objective (``balanced_utilization``) assumes.

The last term prices the *externality*: when ``c``'s queue is empty,
this request changes the SoC's round composition, stretching the round
every queued co-resident rides by ``round_dilation = round(busy + c) -
round(busy)``.  A light class riding a heavy partner dilates its rounds
by almost nothing (cheap, attracted); a heavy class landing on a host
whose light queue is deep would throttle that queue to the joint
cadence (expensive, repelled).  Selfish round-structured scoring
without this term herds heavy traffic onto light hosts — the request
itself completes quickly while strangling everyone behind it.

``round_cost`` depends on plan warmth: if the SoC's session already
holds a cached co-schedule for the occupancy this request would create
(``try_plan_for`` probe — non-blocking, never compiles), a round costs
that plan's makespan; otherwise the router charges the compile-alone
concat floor the engine would serve while the subset plan compiles.
Warm plans therefore *attract* traffic — the routing analogue of cache
affinity.

Priority class and deadline pass straight through to the chosen engine's
:class:`~repro_torch.serve.admission.RoundComposer`, which owns
within-SoC ordering; the router never reorders, it only places.

:func:`replay_open_loop` replays a timestamped trace against the fleet —
the benchmark/e2e driver: arrivals route as the clock reaches them,
engines catch up between arrivals, scheduled :class:`FailureEvent`\\ s
fire mid-trace through the rebalancer, and the tail drains to empty.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.fleet.placement import Fleet, SoCInstance
from repro_torch.serve.admission import Priority


@dataclasses.dataclass
class RoutedRequest:
    """The router's ledger entry for one request: where it went and
    under which engine identity — ``(soc_id, epoch, engine_rid)`` stays
    resolvable across migrations because retired engines remain
    addressable via :meth:`SoCInstance.engine_at`."""
    fleet_rid: int
    class_name: str
    priority: Priority
    deadline_s: Optional[float]
    arrival_s: float
    soc_id: int
    epoch: int
    engine_rid: int
    requeues: int = 0
    rejected: bool = False


@dataclasses.dataclass
class FailureEvent:
    """A scheduled mid-trace SoC lifecycle event: ``kind='fail'`` is an
    abrupt death (queued work must be requeued elsewhere), ``'drain'``
    is a graceful decommission (the SoC finishes its queue first)."""
    at_s: float
    soc_id: int
    kind: str = "fail"              # "fail" | "drain"

    def __post_init__(self) -> None:
        if self.kind not in ("fail", "drain"):
            raise ValueError(f"unknown failure kind: {self.kind}")


class FleetRouter:
    """Per-request dispatch over a :class:`Fleet` (see module docstring
    for the scoring rule).  Thread-safe on its own ledger.

    ``split`` is the placement's implied routing table
    (:attr:`~repro_torch.fleet.placement.Placement.demand_split`): per SoC,
    the fraction of each hosted class's demand the balanced-utilization
    solve directed there.  When given, the router paces dispatch toward
    those shares (a deficit penalty on hosts running ahead of quota) —
    the live queue/warmth score still decides among hosts near their
    quota and still owns failover, but the split keeps the fleet on the
    demand distribution whose bottleneck utilization the placement was
    optimized for.  A myopic score alone provably cannot do this: it
    routes each request to *its* cheapest host, which concentrates
    light classes onto hosts whose cheap rounds exist precisely because
    the split kept them lightly loaded."""

    def __init__(self, fleet: Fleet,
                 split: Optional[Sequence[Dict[str, float]]] = None):
        self.fleet = fleet
        self._lock = threading.Lock()
        self._next_rid = 0
        self.requests: Dict[int, RoutedRequest] = {}
        self._by_engine: Dict[Tuple[int, int, int], int] = {}
        self.routed_per_soc: Dict[int, int] = {}
        self.warm_routes = 0
        self.cold_routes = 0
        self.requeued = 0
        self._split: Dict[str, Dict[int, float]] = {}
        for soc_id, per_soc in enumerate(split or ()):
            for c, share in per_soc.items():
                if share > 0.0:
                    self._split.setdefault(c, {})[soc_id] = share
        self._routed_class: Dict[str, int] = {}
        self._routed_cs: Dict[Tuple[str, int], int] = {}

    # -- scoring ------------------------------------------------------------

    def _score(self, inst: SoCInstance, class_name: str,
               arrival_s: float) -> Tuple[float, bool]:
        """Predicted completion estimate for routing this request to
        ``inst`` (round-structured — see module docstring), and whether
        the occupancy it creates has a warm cached plan."""
        eng = inst.engine
        tenant = eng.resolve(class_name)
        depth = len(eng.queues[tenant])
        busy = sorted(i for i, q in enumerate(eng.queues) if q)
        active = sorted(set(busy) | {tenant})
        plan = inst.mc.try_plan_for(active)
        warm = plan is not None

        def floor(i: int) -> float:
            # queued tenants priced at their head's shape bucket (a
            # decode head is orders cheaper than the prefill default)
            q = eng.queues[i]
            return eng._req_floor_s(q[0]) if q else eng._floor_s(i)

        if warm:
            round_s = self.fleet.cache.cycles_to_s(plan.makespan)
        else:
            # a cold occupancy serves the compile-alone concat floor
            round_s = sum(floor(i) for i in active)
        externality = 0.0
        others = sum(len(q) for i, q in enumerate(eng.queues)
                     if i != tenant)
        if depth == 0 and busy and others:
            # this request adds its class to the round mix, dilating
            # the round every queued co-resident rides
            base_plan = inst.mc.try_plan_for(busy)
            base_s = (self.fleet.cache.cycles_to_s(base_plan.makespan)
                      if base_plan is not None
                      else sum(floor(i) for i in busy))
            externality = others * max(0.0, round_s - base_s)
        start = max(eng.clock_s, arrival_s)
        return start + (depth + 1) * round_s + externality, warm

    def _shares_for(self, class_name: str,
                    soc_ids: Sequence[int]
                    ) -> Optional[Dict[int, float]]:
        """The split table's shares renormalized over the currently
        accepting hosts.  Hosts the split never saw (migration targets)
        get the mean listed share, so failover traffic is neither
        repelled nor herded."""
        table = self._split.get(class_name)
        if not table:
            return None
        mean = sum(table.values()) / len(table)
        raw = {s: table.get(s, mean) for s in soc_ids}
        tot = sum(raw.values())
        if tot <= 0.0:
            return None
        return {s: v / tot for s, v in raw.items()}

    def pick(self, class_name: str, arrival_s: float) -> Tuple[
            SoCInstance, bool]:
        """The accepting host with the lowest predicted completion plus
        split-pacing penalty (ties to the lowest SoC id, so replay is
        deterministic)."""
        hosts = self.fleet.hosts_of(class_name)
        if not hosts:
            raise RuntimeError(f"no accepting SoC hosts class "
                               f"{class_name!r}")
        shares = self._shares_for(class_name,
                                  [h.soc_id for h in hosts])
        with self._lock:
            total = self._routed_class.get(class_name, 0)
            routed = {h.soc_id: self._routed_cs.get(
                (class_name, h.soc_id), 0) for h in hosts}
        alone = self.fleet.contention.alone_s(class_name) \
            if shares else 0.0
        best = None
        for inst in hosts:
            score, warm = self._score(inst, class_name, arrival_s)
            if shares:
                # overage: requests this host would be ahead of its
                # quota after taking this one, priced in alone-work
                over = ((routed[inst.soc_id] + 1)
                        - shares[inst.soc_id] * (total + 1))
                score += max(0.0, over) * alone
            key = (score, inst.soc_id)
            if best is None or key < best[0]:
                best = (key, inst, warm)
        return best[1], best[2]

    # -- dispatch -----------------------------------------------------------

    def submit(self, class_name: str,
               priority: Priority = Priority.NORMAL,
               deadline_s: Optional[float] = None,
               arrival_s: float = 0.0,
               seq_len: Optional[int] = None,
               deadline_abs_s: Optional[float] = None,
               _requeues: int = 0) -> int:
        """Route one request; returns the fleet-wide request id.

        ``seq_len`` passes through to the engine's shape bucketing for
        LM classes.  ``deadline_abs_s`` pins the deadline on the
        absolute clock instead of relative to arrival — the requeue
        path uses it so a migrated request's SLO never restarts."""
        inst, warm = self.pick(class_name, arrival_s)
        engine_rid = inst.engine.submit(class_name, priority=priority,
                                        deadline_s=deadline_s,
                                        arrival_s=arrival_s,
                                        seq_len=seq_len,
                                        deadline_abs_s=deadline_abs_s)
        if engine_rid is not None and inst.engine.compiler is not None:
            # the set of classes now queued on the chosen SoC is its
            # likeliest next dispatch occupancy — hand it to the shared
            # compiler's prefetcher so the subset plan can be ready
            # before the round composes it
            active = [i for i, q in enumerate(inst.engine.queues) if q]
            if active:
                inst.engine.compiler.prefetch_hint([active])
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            rr = RoutedRequest(rid, class_name, Priority(priority),
                               deadline_s, arrival_s, inst.soc_id,
                               inst.epoch,
                               -1 if engine_rid is None else engine_rid,
                               requeues=_requeues,
                               rejected=engine_rid is None)
            self.requests[rid] = rr
            if engine_rid is not None:
                self._by_engine[(inst.soc_id, inst.epoch,
                                 engine_rid)] = rid
            self.routed_per_soc[inst.soc_id] = \
                self.routed_per_soc.get(inst.soc_id, 0) + 1
            self._routed_class[class_name] = \
                self._routed_class.get(class_name, 0) + 1
            self._routed_cs[(class_name, inst.soc_id)] = \
                self._routed_cs.get((class_name, inst.soc_id), 0) + 1
            if warm:
                self.warm_routes += 1
            else:
                self.cold_routes += 1
        return rid

    def requeue(self, items: Sequence[Tuple[str, Any]], src_soc_id: int,
                epoch_at_drain: int, now_s: float) -> List[int]:
        """Re-route requests evicted from a failed or re-hosted SoC (the
        rebalancer's zero-drop path).  ``items`` are ``(class_name,
        InferRequest)`` pairs — the rebalancer resolves tenant indices to
        class names *before* re-hosting, while the evicting engine's
        graph order is still current.  Each request keeps its *absolute*
        deadline — the SLO clock does not restart on migration — and its
        original priority; the ledger retires the old engine identity
        and binds the new one.  Returns the new fleet rids."""
        out: List[int] = []
        for name, r in sorted(items, key=lambda nr: (nr[1].submit_s,
                                                     nr[1].rid)):
            # the ORIGINAL absolute deadline rides along verbatim (the
            # engine's deadline_abs_override_s): re-deriving a relative
            # deadline against now_s and letting the destination engine
            # re-add its own clock drifted the SLO whenever the two
            # engines' analytic clocks disagreed — and a second
            # migration compounded it.  May already be in the past
            # (hopeless) — still routed, never dropped.
            with self._lock:
                old = self._by_engine.pop(
                    (src_soc_id, epoch_at_drain, r.rid), None)
                prev = 0 if old is None else \
                    self.requests[old].requeues
                if old is not None:
                    del self.requests[old]
                self.requeued += 1
            rid = self.submit(name, priority=r.priority,
                              deadline_abs_s=r.deadline_abs_s,
                              arrival_s=now_s, seq_len=r.seq_len,
                              _requeues=prev + 1)
            out.append(rid)
        return out

    # -- audit --------------------------------------------------------------

    def audit(self) -> Dict[str, Any]:
        """Conservation check over the ledger: every routed request must
        be found served (in its engine's ``done``), still queued, or
        admission-rejected.  ``dropped`` counts requests the fleet lost
        track of — the zero-drop gate across failures."""
        with self._lock:
            ledger = list(self.requests.values())
            stats = {"requeued": self.requeued,
                     "warm_routes": self.warm_routes,
                     "cold_routes": self.cold_routes,
                     "routed_per_soc": dict(self.routed_per_soc)}
        served = rejected = queued = dropped = 0
        for rr in ledger:
            if rr.rejected:
                rejected += 1
                continue
            inst = self.fleet.instances[rr.soc_id]
            eng = inst.engine_at(rr.epoch)
            if eng is None:
                dropped += 1
            elif rr.engine_rid in eng.done:
                served += 1
            elif any(q and any(x.rid == rr.engine_rid for x in q)
                     for q in eng.queues):
                queued += 1
            else:
                dropped += 1
        stats.update(submitted=len(ledger), served=served,
                     rejected=rejected, queued=queued, dropped=dropped)
        return stats


# ---------------------------------------------------------------------------
# Open-loop trace replay
# ---------------------------------------------------------------------------


def _catch_up(fleet: Fleet, t_s: float) -> None:
    """Step every live engine until its analytic clock reaches ``t_s``
    or its queues are empty — the inter-arrival serving work."""
    for inst in fleet.live():
        eng = inst.engine
        if eng is None:
            continue
        while eng.pending and eng.clock_s < t_s:
            eng.step()


def replay_open_loop(fleet: Fleet, router: FleetRouter,
                     trace: Sequence[Tuple[float, str, Priority,
                                           Optional[float]]],
                     failures: Sequence[FailureEvent] = (),
                     rebalancer: Optional[Any] = None) -> Dict[str, Any]:
    """Replay a timestamped open-loop trace against the fleet.

    ``trace`` rows are ``(t_s, class_name, priority, deadline_s)``,
    sorted by time.  Due :class:`FailureEvent`\\ s fire (via the
    ``rebalancer``) before the arrivals that follow them; after the last
    arrival the remaining failures fire and every live engine drains.
    Returns the merged fleet aggregate + router audit."""
    if failures and rebalancer is None:
        raise ValueError("failure events need a rebalancer")
    trace = sorted(trace, key=lambda row: row[0])
    fails = sorted(failures, key=lambda f: f.at_s)
    fi = 0

    def fire_due(now_s: float) -> None:
        nonlocal fi
        while fi < len(fails) and fails[fi].at_s <= now_s:
            ev = fails[fi]
            fi += 1
            # serve what the doomed SoC can finish before the event
            inst = fleet.instances[ev.soc_id]
            if inst.engine is not None:
                while inst.engine.pending and \
                        inst.engine.clock_s < ev.at_s:
                    inst.engine.step()
            if ev.kind == "fail":
                rebalancer.fail(ev.soc_id, ev.at_s)
            else:
                rebalancer.drain(ev.soc_id, ev.at_s)

    for t_s, name, priority, deadline_s in trace:
        fire_due(t_s)
        _catch_up(fleet, t_s)
        router.submit(name, priority=priority, deadline_s=deadline_s,
                      arrival_s=t_s)
    fire_due(float("inf"))
    for inst in fleet.live():
        if inst.engine is not None:
            inst.engine.run()

    summary = fleet.aggregate()
    summary["router"] = router.audit()
    if rebalancer is not None:
        summary["rebalance"] = rebalancer.stats()
    return summary
