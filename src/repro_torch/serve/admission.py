"""SLO-aware admission control and round composition for the
multi-tenant serving engine.

MATCHA's occupancy-indexed plan store makes *which tenants run together*
a cheaply answerable question (``plan_for`` / ``try_plan_for`` on the
deployment session), so the serving round's composition no longer has to
be "whoever is at the front of a FIFO queue".  This module supplies the
two policy pieces :class:`repro.serve.engine.MultiModelEngine` dispatches
through:

  * :class:`AdmissionController` — per-priority-class queue bounds.  A
    request whose class queue is full is rejected at ``submit`` time
    (recorded, never silently dropped), so a burst of best-effort traffic
    cannot grow the queues without bound and push latency-critical
    tenants past their deadlines.
  * :class:`RoundComposer` — scores candidate occupancies (subsets of the
    tenants with queued work) and picks the round composition with the
    best urgency density: each member's head request contributes a
    priority-weighted, starvation-aged urgency term — doubled when the
    candidate round would meet the request's deadline, discounted when
    the deadline would already be missed — and the sum is divided by the
    candidate round's predicted duration (the cached occupancy plan's
    makespan when the :class:`~repro.core.deploy.PlanStore` has it, the
    compile-alone concat floor otherwise).  Deadline-protective rule:
    candidates that exclude a tenant whose head request would run out of
    slack during the round are discarded, and any tenant whose head
    request has been the queue head for ``starvation_rounds`` dispatch
    steps (compose decisions — one step spans up to ``max_batch``
    wave-rounds) is force-included in every candidate — the two rules
    that make "no admitted request starves" a structural property
    instead of a tuning accident.

When no request in the queues carries an SLO signal (every priority is
``Priority.NORMAL`` and no deadline is set), :meth:`RoundComposer.compose`
returns the FIFO composition — all active tenants, one request each —
bitwise identical to the pre-SLO engine's dispatch order, so plugging the
composer in is free until SLOs are actually configured.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class Priority(enum.IntEnum):
    """Request priority classes, ordered: higher value = more urgent."""
    LOW = 0
    NORMAL = 1
    HIGH = 2


# relative urgency of the classes in the composer's scoring (geometric
# spacing: one HIGH head outweighs a few NORMAL heads but not an aged one)
PRIORITY_WEIGHTS: Dict[Priority, float] = {
    Priority.LOW: 1.0,
    Priority.NORMAL: 4.0,
    Priority.HIGH: 16.0,
}


@dataclasses.dataclass(frozen=True)
class ClassPolicy:
    """Admission policy for one priority class.

    ``max_queued`` bounds how many requests of this class may be queued
    across all tenants (``None`` = unbounded, the default)."""
    max_queued: Optional[int] = None

    def __post_init__(self) -> None:
        if self.max_queued is not None and self.max_queued < 0:
            raise ValueError(f"max_queued must be >= 0: {self.max_queued}")


class AdmissionController:
    """Reject-or-queue admission by per-class queue bounds.

    ``policies`` maps :class:`Priority` to :class:`ClassPolicy`; classes
    without an entry are unbounded.  ``admit`` is called by the engine at
    ``submit`` time with the would-be request's class and the current
    per-class queue depths; rejections are counted per class."""

    def __init__(self, policies: Optional[Dict[Priority, ClassPolicy]]
                 = None) -> None:
        self.policies: Dict[Priority, ClassPolicy] = dict(policies or {})
        self.admitted: Dict[Priority, int] = {p: 0 for p in Priority}
        self.rejected: Dict[Priority, int] = {p: 0 for p in Priority}

    def admit(self, priority: Priority,
              class_depths: Dict[Priority, int]) -> bool:
        policy = self.policies.get(priority)
        if (policy is not None and policy.max_queued is not None
                and class_depths.get(priority, 0) >= policy.max_queued):
            self.rejected[priority] += 1
            return False
        self.admitted[priority] += 1
        return True

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {p.name: {"admitted": self.admitted[p],
                         "rejected": self.rejected[p]}
                for p in Priority}


@dataclasses.dataclass(frozen=True)
class ComposerConfig:
    """Tuning knobs of the deadline-driven round composer.

    ``starvation_rounds`` is the hard no-starvation bound: a request that
    has been its tenant's queue *head* for this many dispatch steps is
    force-included in every candidate occupancy, so it dispatches *this*
    step — every admitted request therefore completes within
    ``starvation_rounds * (depth_at_submit + 1)`` dispatch steps, i.e.
    that many times ``max_batch`` wave-rounds (each request ahead of it
    pops within one head tenure).  ``aging_weight``
    is the soft counterpart — urgency grows linearly with rounds waited
    since submission, so low-priority traffic climbs toward dispatch
    long before the hard bound.  ``miss_factor`` discounts (but does not zero) the urgency of
    a request whose deadline the candidate round would miss: a hopeless
    request still deserves service, just not at the expense of one that
    can still make its deadline.  ``max_enumerate`` caps exhaustive
    subset enumeration; larger deployments fall back to a linear
    candidate family (full house, singletons, cached occupancies)."""
    starvation_rounds: int = 8
    aging_weight: float = 0.25
    miss_factor: float = 0.25
    met_bonus: float = 2.0
    max_enumerate: int = 4
    queue_decay: float = 0.5     # weight of position-p queued requests

    def __post_init__(self) -> None:
        if self.starvation_rounds < 1:
            raise ValueError(f"starvation_rounds must be >= 1: "
                             f"{self.starvation_rounds}")
        if self.aging_weight < 0.0:
            raise ValueError(f"aging_weight must be >= 0: "
                             f"{self.aging_weight}")
        if not 0.0 <= self.miss_factor <= 1.0:
            raise ValueError(f"miss_factor must be in [0, 1]: "
                             f"{self.miss_factor}")
        if not 0.0 < self.queue_decay <= 1.0:
            raise ValueError(f"queue_decay must be in (0, 1]: "
                             f"{self.queue_decay}")


@dataclasses.dataclass
class TenantView:
    """What the composer may see about one tenant with queued work: the
    head request's SLO fields, the tenant's compile-alone floor, and
    (optionally) the SLO fields of the whole queue — deferring a tenant
    delays *everything* queued behind its head, so scoring heads alone
    would build backlogs that later tight-deadline arrivals sit behind."""
    tenant: int
    priority: Priority
    deadline_abs_s: Optional[float]       # head's absolute deadline
    wait_rounds: int                      # head's age in serving rounds
    depth: int                            # queued requests for this tenant
    floor_s: float                        # compile-alone makespan, seconds
    # dispatch steps (compose decisions — one step spans up to max_batch
    # wave-rounds) since this head BECAME the head: the starvation clock.
    # Submit-age would force-include every tenant of a saturated queue
    # (all queued requests are old), collapsing the composer back to
    # FIFO exactly when SLOs matter most; head tenure stays small while
    # a queue is being served and only grows under real deferral.
    head_tenure_rounds: int = 0
    # (priority, deadline_abs_s, wait_rounds) per queued request, head
    # first; empty = head only
    queue: Tuple[Tuple[Priority, Optional[float], int], ...] = ()

    def requests(self) -> Tuple[Tuple[Priority, Optional[float], int], ...]:
        if self.queue:
            return self.queue
        return ((self.priority, self.deadline_abs_s, self.wait_rounds),)


@dataclasses.dataclass
class RoundPlanProbe:
    """Non-blocking occupancy-plan probe handed to the composer by the
    engine: ``lookup(ids)`` returns ``(round_s, completion_s_by_tenant)``
    from the cached occupancy plan when the store has it, else the
    back-to-back compile-alone floor (prefix sums in sorted-tenant
    order) — never a compile on the dispatch path."""
    try_plan: Callable[[Sequence[int]], Optional[object]]
    cycles_to_s: Callable[[float], float]
    floors_s: Dict[int, float]

    def lookup(self, ids: Sequence[int]
               ) -> Tuple[float, Dict[int, float]]:
        ids = sorted(ids)
        plan = self.try_plan(ids) if self.try_plan is not None else None
        if plan is not None:
            comp = {i: self.cycles_to_s(plan.tenant_makespans[pos])
                    for pos, i in enumerate(ids)}
            return self.cycles_to_s(plan.makespan), comp
        offset, comp = 0.0, {}
        for i in ids:
            offset += self.floors_s[i]
            comp[i] = offset
        return offset, comp


def has_slo_signal(views: Sequence[TenantView]) -> bool:
    """True when any queued head request carries an SLO: a non-default
    priority class or a deadline."""
    return any(v.priority != Priority.NORMAL or v.deadline_abs_s is not None
               for v in views)


class RoundComposer:
    """Deadline-driven occupancy selection for one serving round.

    ``compose`` returns the sorted tenant ids to dispatch this round.
    With no SLO signal among the queued heads it returns every active
    tenant (the FIFO composition, bitwise the pre-SLO dispatch order).
    Otherwise candidates are scored by urgency density (see module
    docstring) under two hard rules: starvation-aged heads are force-
    included, and candidates that would let an excluded head's deadline
    expire during the round are discarded."""

    def __init__(self, config: Optional[ComposerConfig] = None) -> None:
        self.config = config if config is not None else ComposerConfig()
        self.slo_rounds = 0          # rounds composed by scoring
        self.fifo_rounds = 0         # rounds passed through as FIFO
        self.forced_inclusions = 0   # starvation-bound force-includes

    # -- candidate generation ----------------------------------------------

    def _candidates(self, active: List[int], forced: frozenset,
                    cached: Sequence[frozenset]) -> List[Tuple[int, ...]]:
        if len(active) <= self.config.max_enumerate:
            subsets = [tuple(sorted(c))
                       for r in range(1, len(active) + 1)
                       for c in itertools.combinations(active, r)]
        else:
            subsets = [tuple(sorted(active))]
            subsets += [(i,) for i in active]
            act = set(active)
            for occ in cached:
                ids = tuple(sorted(occ & act))
                if ids:
                    subsets.append(ids)
            if forced:
                subsets.append(tuple(sorted(forced)))
        out, seen = [], set()
        for c in subsets:
            if c not in seen and forced <= set(c):
                seen.add(c)
                out.append(c)
        return out

    # -- scoring ------------------------------------------------------------

    def _queue_at_risk(self, v: TenantView, clock_s: float,
                       round_s: float) -> bool:
        """True when deferring tenant ``v`` for this round would let some
        queued request's *still-feasible* deadline expire: position ``p``
        can finish no earlier than ``(p+1)`` back-to-back floors, and
        deferral pushes that whole ladder out by the round."""
        for pos, (_, deadline, _) in enumerate(v.requests()):
            if deadline is None:
                continue
            earliest = clock_s + (pos + 1) * v.floor_s
            if deadline >= earliest and deadline < earliest + round_s:
                return True
        return False

    def score(self, ids: Sequence[int], views: Dict[int, TenantView],
              clock_s: float, probe: RoundPlanProbe
              ) -> Optional[Tuple[float, int, float]]:
        """Score of dispatching exactly ``ids`` this round (compared
        lexicographically; larger is better), or ``None`` when the
        candidate is discarded by the deadline-protective rule (an
        excluded tenant's queue would run out of slack).

        The score is ``(predicted met weight, full-set bonus, urgency
        density)``:

          * *met weight* — the priority-weighted sum over every queued
            deadline the system is predicted to attain if this candidate
            runs: an included tenant's position-``p`` request finishes
            around the candidate plan's completion plus ``p`` floors; an
            excluded tenant's around the round plus ``(p+1)`` floors.
          * *full-set bonus* — serving every active tenant is work-
            conserving (the co-schedule advances everyone at once), so
            deferral must *strictly* improve the predicted deadline
            outcome to be chosen; ties go to the FIFO composition.
          * *urgency density* — priority-weighted, starvation-aged,
            queue-decayed urgency of the members per predicted round
            second; breaks ties among proper subsets.
        """
        cfg = self.config
        round_s, completion = probe.lookup(ids)
        included = set(ids)
        met_weight = 0.0
        density = 0.0
        for i, v in views.items():
            if i not in included:
                if self._queue_at_risk(v, clock_s, round_s):
                    return None
                for pos, (prio, deadline, _) in enumerate(v.requests()):
                    if deadline is None:
                        continue
                    finish = clock_s + round_s + (pos + 1) * v.floor_s
                    if finish <= deadline:
                        met_weight += PRIORITY_WEIGHTS[prio]
                continue
            for pos, (prio, deadline, wait) in enumerate(v.requests()):
                w = (PRIORITY_WEIGHTS[prio]
                     * (1.0 + cfg.aging_weight * wait)
                     * cfg.queue_decay ** pos)
                if deadline is not None:
                    finish = clock_s + completion[i] + pos * v.floor_s
                    met = finish <= deadline
                    if met:
                        met_weight += PRIORITY_WEIGHTS[prio]
                    w *= cfg.met_bonus if met else cfg.miss_factor
                density += w
        full = 1 if included == set(views) else 0
        return (met_weight, full, density / max(round_s, 1e-12))

    # -- the round decision -------------------------------------------------

    def compose(self, views: Sequence[TenantView], clock_s: float,
                probe: RoundPlanProbe,
                cached_occupancies: Sequence[frozenset] = ()
                ) -> List[int]:
        active = sorted(v.tenant for v in views)
        if not active:
            return []
        if not has_slo_signal(views):
            self.fifo_rounds += 1
            return active
        self.slo_rounds += 1
        by_tenant = {v.tenant: v for v in views}
        forced = frozenset(
            v.tenant for v in views
            if v.head_tenure_rounds >= self.config.starvation_rounds)
        if forced:
            self.forced_inclusions += 1
        best_ids: Optional[Tuple[int, ...]] = None
        best_key: Optional[tuple] = None
        for ids in self._candidates(active, forced,
                                    cached_occupancies):
            s = self.score(ids, by_tenant, clock_s, probe)
            if s is None:
                continue
            # deterministic arbitration: best score, then the larger
            # occupancy (more work per round), then lexicographic order
            key = (s, len(ids), tuple(-i for i in ids))
            if best_key is None or key > best_key:
                best_key, best_ids = key, ids
        if best_ids is None:
            # unreachable by construction — the full-house candidate is
            # always generated and excludes no tenant, so the protective
            # rule cannot discard it; kept as a defensive backstop
            best_ids = tuple(active)
        return list(best_ids)

    def stats(self) -> Dict[str, int]:
        return {"slo_rounds": self.slo_rounds,
                "fifo_rounds": self.fifo_rounds,
                "forced_inclusions": self.forced_inclusions}
