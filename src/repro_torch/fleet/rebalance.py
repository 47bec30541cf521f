"""Fleet lifecycle: SoC failure, graceful drain, and load rebalancing.

The rebalancer is the fleet's supervisor — the same
checkpoint/restart shape as :mod:`repro_torch.fault.supervisor`, lifted one
level: where the training supervisor restores model *state* from the
latest checkpoint after a step failure, the fleet rebalancer restores
serving *capacity* after a SoC failure by migrating the dead SoC's
tenants onto survivors.  The "checkpoint" is the compiled artifact plus
the non-evicting solutions sidecar of the plan store: a migration destination
whose new class mix is already in the fleet :class:`PlanCache` rebinds
an engine in microseconds (cache hit), and a genuinely new mix
warm-starts its compile from the tiling solutions the failed SoC (and
the destination's own previous session) had already landed —
``transplant_solutions`` remaps them by class name.

Per-event recovery latency is measured, not assumed, and reported in
the same shape as the training supervisor's
:class:`~repro_torch.fault.supervisor.RunReport` (``stats()["recovery_s"]``).

Zero-drop invariant: queued requests on a failed SoC are drained
*before* the engine is abandoned and requeued through the router with
their absolute deadlines preserved; the router's ``audit()`` proves
conservation end to end.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.fleet.placement import Fleet, SoCInstance
from repro_torch.fleet.router import FleetRouter


@dataclasses.dataclass
class MigrationRecord:
    """One tenant-class migration: where it moved, what it cost, and
    whether the destination artifact was already compiled (cache hit)
    or had to be built (and then: how many sidecar occupancies
    warm-started the build)."""
    class_name: str
    src_soc: int
    dst_soc: int
    at_s: float
    recovery_s: float               # wall seconds for the re-host
    cache_hit: bool
    seeded_occupancies: int         # sidecar occupancies transplanted
    analyzer_errors: int            # ERROR diagnostics on the dst plans
    kind: str = "fail"              # "fail" | "drain" | "rebalance"


class FleetRebalancer:
    """Failure handling and load-shift rebalancing over one fleet +
    router pair.  Thread-safe on its own bookkeeping; the migration
    work itself runs on the caller's thread (replay is single-threaded,
    matching the engines' analytic clocks)."""

    def __init__(self, fleet: Fleet, router: FleetRouter):
        self.fleet = fleet
        self.router = router
        self._lock = threading.Lock()
        self.migrations: List[MigrationRecord] = []
        self.recovery_s: List[float] = []
        self.failures = 0
        self.drains = 0
        self.moves = 0

    # -- placement of a displaced class -------------------------------------

    def _pick_destination(self, class_name: str,
                          exclude: Sequence[int] = (),
                          warm_sessions: Sequence[Any] = ()
                          ) -> Tuple[SoCInstance, bool]:
        """The surviving SoC where adding ``class_name`` dilutes
        serving capacity least — the worst member slowdown of the new
        mix (round / alone, the per-SoC term of the placement
        objective), applied incrementally.  Unhosted (spare) SoCs are
        valid destinations.

        Returns ``(dst, pre_hit)`` where ``pre_hit`` records whether
        the chosen mix was cached *before* this probe ran: the probe
        itself may compile candidate pairs (warm-started from the
        donated ``warm_sessions``), so a post-probe ``has()`` check
        would always say hit and hide the warm-start in the migration
        record."""
        contention = self.fleet.contention
        cap = self.fleet.config.capacity
        pre_hit: Dict[int, bool] = {}
        best: Optional[Tuple[Tuple[float, float, int, int],
                             SoCInstance]] = None
        for inst in self.fleet.instances:
            if inst.soc_id in exclude or inst.failed or inst.draining:
                continue
            if class_name in inst.classes or len(inst.classes) >= cap:
                continue
            mix = list(inst.classes) + [class_name]
            pre_hit[inst.soc_id] = self.fleet.cache.has(mix)
            key = (contention.slowdown(mix, warm_from=warm_sessions),
                   contention.predict_round_s(mix),
                   len(inst.classes), inst.soc_id)
            if best is None or key < best[0]:
                best = (key, inst)
        if best is None:
            raise RuntimeError(
                f"no surviving SoC can host class {class_name!r}")
        return best[1], pre_hit[best[1].soc_id]

    def _migrate(self, class_name: str, src: SoCInstance, at_s: float,
                 kind: str,
                 warm_sessions: Sequence[Any]) -> MigrationRecord:
        """Pick a destination by incremental contention and re-host it
        with ``class_name`` added (see :meth:`_migrate_to`)."""
        dst, pre_hit = self._pick_destination(class_name,
                                              exclude=(src.soc_id,),
                                              warm_sessions=warm_sessions)
        return self._migrate_to(class_name, src, dst, at_s,
                                warm_sessions, kind, pre_hit=pre_hit)

    def _relocate_all(self, inst: SoCInstance, at_s: float,
                      kind: str) -> List[MigrationRecord]:
        """Move every class of ``inst`` that has no other accepting
        replica onto survivors (replicated classes keep serving from
        their other hosts — nothing to move)."""
        recs: List[MigrationRecord] = []
        src_session = inst.mc.session if inst.mc is not None else None
        warm = [s for s in (src_session,) if s is not None]
        for name in inst.classes:
            if self.fleet.hosts_of(name):
                continue                     # replica elsewhere still up
            recs.append(self._migrate(name, inst, at_s, kind, warm))
        return recs

    # -- lifecycle events ---------------------------------------------------

    def fail(self, soc_id: int, at_s: float) -> List[MigrationRecord]:
        """Abrupt SoC death: queued requests are evacuated, orphaned
        classes re-hosted on survivors (compile warm-started from the
        dead SoC's solutions sidecar), and the evacuated work requeued
        through the router with absolute deadlines preserved."""
        inst = self.fleet.instances[soc_id]
        if inst.failed:
            raise ValueError(f"SoC {soc_id} already failed")
        t0 = time.perf_counter()
        inst.failed = True
        epoch = inst.epoch
        items: List[Tuple[str, Any]] = []
        if inst.engine is not None:
            graphs = inst.mc.graphs
            items = [(graphs[r.tenant].name, r)
                     for r in inst.engine.drain_pending()]
        recs = self._relocate_all(inst, at_s, "fail")
        if items:
            self.router.requeue(items, soc_id, epoch, at_s)
        wall = time.perf_counter() - t0
        with self._lock:
            self.failures += 1
            self.migrations.extend(recs)
            self.recovery_s.append(wall)
        return recs

    def drain(self, soc_id: int, at_s: float) -> List[MigrationRecord]:
        """Graceful decommission: stop routing to the SoC, let it finish
        its queue, then re-host its classes and mark it out of the
        fleet.  No requests move — the queue empties in place."""
        inst = self.fleet.instances[soc_id]
        if inst.failed or inst.draining:
            raise ValueError(f"SoC {soc_id} already failed or draining")
        t0 = time.perf_counter()
        inst.draining = True
        if inst.engine is not None:
            inst.engine.run()
        recs = self._relocate_all(inst, at_s, "drain")
        inst.failed = True
        wall = time.perf_counter() - t0
        with self._lock:
            self.drains += 1
            self.migrations.extend(recs)
            self.recovery_s.append(wall)
        return recs

    # -- load-shift rebalancing ---------------------------------------------

    def rebalance(self, at_s: float, max_moves: int = 1,
                  min_gain_s: float = 0.0) -> List[MigrationRecord]:
        """Shift load off the most-backlogged SoC: move its heaviest-
        backlog class (by queued work) to the accepting SoC with the
        least predicted round, if the backlog gap exceeds
        ``min_gain_s``.  The moved class's queued requests requeue
        through the router (which may well pick the new host)."""
        recs: List[MigrationRecord] = []
        for _ in range(max_moves):
            live = [i for i in self.fleet.instances if i.accepting]
            if len(live) < 2:
                break
            src = max(live, key=lambda i: i.backlog_s())
            others = [i for i in live if i.soc_id != src.soc_id]
            floor = min(i.backlog_s() for i in others)
            if src.backlog_s() - floor <= min_gain_s:
                break
            eng = src.engine
            by_class = sorted(
                ((len(eng.queues[t]) * eng._floor_s(t), t)
                 for t in range(eng.n_tenants)), reverse=True)
            moved = False
            for backlog, tenant in by_class:
                if backlog <= 0.0 or len(src.classes) <= 1:
                    break
                name = src.mc.graphs[tenant].name
                try:
                    dst, pre_hit = self._pick_destination(
                        name, exclude=(src.soc_id,),
                        warm_sessions=[src.mc.session])
                except RuntimeError:
                    continue
                # evacuate the whole src queue set, shrink src, grow dst
                src_epoch = src.epoch
                graphs = src.mc.graphs
                items = [(graphs[r.tenant].name, r)
                         for r in eng.drain_pending()]
                src_session = src.mc.session
                remaining = [n for n in src.classes if n != name]
                src.host(remaining, at_s=at_s)
                rec = self._migrate_to(name, src, dst, at_s,
                                       [src_session], "rebalance",
                                       pre_hit=pre_hit)
                recs.append(rec)
                if items:
                    self.router.requeue(items, src.soc_id, src_epoch,
                                        at_s)
                with self._lock:
                    self.moves += 1
                    self.migrations.append(rec)
                    self.recovery_s.append(rec.recovery_s)
                moved = True
                break
            if not moved:
                break
        return recs

    def _migrate_to(self, class_name: str, src: SoCInstance,
                    dst: SoCInstance, at_s: float,
                    warm_sessions: Sequence[Any], kind: str,
                    pre_hit: Optional[bool] = None) -> MigrationRecord:
        """Re-host ``dst`` with its current classes plus ``class_name``,
        warm-starting any fresh compile from the donated sessions'
        solutions sidecars, and requeue whatever the destination had
        queued (its engine is rebuilt over a larger graph set, so its
        pending work re-routes — normally straight back to itself, now
        with the migrant as a co-resident).  ``pre_hit`` is the cache
        state snapshotted before the destination probe (which may itself
        have built the mix)."""
        new_mix = list(dst.classes) + [class_name]
        hit = (pre_hit if pre_hit is not None
               else self.fleet.cache.has(new_mix))
        dst_epoch = dst.epoch
        dst_items: List[Tuple[str, Any]] = []
        if dst.engine is not None:
            graphs = dst.mc.graphs
            dst_items = [(graphs[r.tenant].name, r)
                         for r in dst.engine.drain_pending()]
        warm = list(warm_sessions)
        if dst.mc is not None:
            warm.append(dst.mc.session)
        wall = dst.host(new_mix, at_s=at_s, warm_from=warm)
        info = self.fleet.cache.build_info(new_mix) or {}
        stats = (dst.mc.session.analysis_stats()
                 if dst.mc.session is not None else {"errors": 0})
        rec = MigrationRecord(
            class_name=class_name, src_soc=src.soc_id,
            dst_soc=dst.soc_id, at_s=at_s, recovery_s=wall,
            cache_hit=hit,
            seeded_occupancies=0 if hit else
            info.get("seeded_occupancies", 0),
            analyzer_errors=int(stats["errors"]), kind=kind)
        if dst_items:
            self.router.requeue(dst_items, dst.soc_id, dst_epoch, at_s)
        return rec

    # -- reporting ----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "failures": self.failures,
                "drains": self.drains,
                "moves": self.moves,
                "migrations": len(self.migrations),
                "cache_hits": sum(1 for m in self.migrations
                                  if m.cache_hit),
                "seeded_occupancies": sum(m.seeded_occupancies
                                          for m in self.migrations),
                "analyzer_errors": sum(m.analyzer_errors
                                       for m in self.migrations),
                # same shape as fault.supervisor RunReport.recovery_s
                "recovery_s": list(self.recovery_s),
                "records": [dataclasses.asdict(m)
                            for m in self.migrations],
            }
