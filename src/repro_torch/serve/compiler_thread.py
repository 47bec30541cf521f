"""Background subset-plan compiler for the serving engine.

A ``plan_for`` miss at an unseen occupancy pays the whole subset compile
— including up to ``CompileRequest.joint_time_budget_s`` of joint
cross-tenant CP solving — on the caller's thread.  On the serving
engine's dispatch path that is a first-round stall of seconds at every
occupancy the operator forgot to ``precompile``.  This module moves the
compile off the dispatch path:

  * the engine probes the store with the session's non-blocking
    :meth:`~repro.core.deploy.DeploymentSession.try_plan_for`;
  * on a miss it enqueues a :class:`CompileJob` here and serves the
    round on the compile-alone concat floor (each member's compile-alone
    schedule back-to-back — exactly the hard floor
    ``DeploymentSession._compile_subset`` guarantees the eventual subset
    plan will beat or tie, so serving the floor never costs more than
    1x the plan the round is waiting for);
  * a bounded **worker pool** (``max_workers`` threads, sized from
    ``CompileRequest.max_workers`` by default) drains the queue through
    :meth:`~repro.core.deploy.DeploymentSession.submit_compile`, which
    compiles each occupancy with the smaller
    ``CompileRequest.lazy_joint_time_budget_s`` joint budget, exactly
    once per occupancy even under pool concurrency (the compiler's
    queued/in-flight set and the session's own in-flight set both
    dedupe), and lands the plan in the store — the next round at that
    occupancy dispatches the real subset co-schedule.

With ``prefetch=True`` the compiler also *predicts* likely next
occupancies and compiles them speculatively at lower queue priority
(the **shape/occupancy-lattice prefetcher**): candidates are the
Hamming-adjacent neighbors of recently observed store keys — one tenant
joins or leaves at the anchor's bucket vector (how serving mixes
actually churn), and, for anchors with shape-bucketed tenants, one
tenant steps one rung down or up its bucket ladder (down-steps weighted
double: a tenant observed at a prefill bucket is about to decode, so
the prefill->decode transition is the lattice edge worth paying for
before it is demanded) — plus any externally registered hints
(:meth:`prefetch_hint` — e.g. the fleet placement's per-SoC tenant
sets), ranked by predicted request probability (recency-decayed
neighbor counts + hint weights) times staleness (how long since the
candidate was last attempted; already-cached keys have zero staleness
and are never re-prefetched).  Reactive miss jobs always outrank
prefetch jobs in the queue, so prefetching can only fill idle worker
capacity, never delay a miss.

For deterministic tests (and fake-clock serving simulations) construct
with ``start=False`` and pump jobs synchronously with
:meth:`run_pending`: same dedupe, same budgets, no thread.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import queue
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.shapes import (PlanKey, StoreKey, describe_key, key_parts,
                               key_sort, make_plan_key)


def _norm_key(active: Union[StoreKey, Sequence[int]]) -> StoreKey:
    """Canonical store key: a :class:`PlanKey` passes through, anything
    else is an iterable of tenant ids (the bare-occupancy key)."""
    if isinstance(active, PlanKey):
        return active
    return frozenset(int(a) for a in active)


@dataclasses.dataclass(frozen=True)
class CompileJob:
    """One queued background compile: a store key — bare occupancy or
    ``(occupancy, bucket-vector)`` lattice point — to materialize.
    ``source`` labels the session's miss event (``"background"`` for
    reactive miss compiles, ``"prefetch"`` for speculative ones)."""
    occupancy: StoreKey
    source: str = "background"


class BackgroundCompiler:
    """Owns the compile queue and (optionally) the worker pool.

    ``submit(active)`` enqueues an occupancy unless it is already cached
    or already queued/in-flight (returns whether a job was enqueued).
    ``run_pending()`` drains the queue on the caller's thread — the
    deterministic mode tests use; with ``start=True`` (the default)
    ``max_workers`` daemon workers drain it continuously.  ``drain()``
    blocks until every submitted job has finished compiling, for
    shutdown barriers and benchmarks that want the steady state.

    A raised compile no longer poisons its occupancy permanently (a
    transient joint-CP timeout would pin that subset to the concat floor
    for the session's lifetime): the occupancy may be re-submitted up to
    ``max_retries`` more times, each retry gated behind exponentially
    more submit *rounds* of backoff (``backoff_rounds * 2**(attempt-1)``
    — rounds, not wall time, so the deterministic fake-clock mode backs
    off too).  Only after ``max_retries + 1`` raised compiles is the
    occupancy poisoned; :meth:`clear_failed` lifts the poison (e.g.
    after an operator fixes the underlying condition).

    Queue, retry and prefetcher state is shared by all pool workers and
    declared for the concurrency lint (``repro.analysis.lockcheck``):

    Lock-guarded: _queued, _failed, _attempts, _retry_after, _tick,
    Lock-guarded: _inflight, _recent, _hints, _last_attempt
    """

    def __init__(self, session, start: bool = True,
                 max_retries: int = 2, backoff_rounds: int = 1,
                 max_workers: Optional[int] = None,
                 prefetch: bool = False, prefetch_depth: int = 4,
                 recent_window: int = 8) -> None:
        if max_workers is None:
            # duck-typed sessions (test fakes) may not carry a request
            max_workers = getattr(getattr(session, "request", None),
                                  "max_workers", 1)
        if max_workers < 1:
            raise ValueError(f"max_workers must be >= 1: {max_workers}")
        self.session = session
        self.max_workers = int(max_workers)
        self.prefetch = bool(prefetch)
        self.prefetch_depth = int(prefetch_depth)
        self.recent_window = int(recent_window)
        # priority queue: (priority, seq, job|None).  Reactive misses go
        # in at priority 0.0, prefetches at 1/(1+score) in (0, 1], the
        # stop sentinel at +inf — so misses beat prefetches and the
        # sentinel drains everything first (stop() semantics)
        self._jobs: "queue.PriorityQueue[Tuple[float, int, Optional[CompileJob]]]" = \
            queue.PriorityQueue()
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._queued: set = set()          # occupancies queued or running
        self._failed: set = set()          # poisoned: retries exhausted
        self._attempts: dict = {}          # occupancy -> raised compiles
        self._retry_after: dict = {}       # occupancy -> earliest retry tick
        self._tick = 0                     # submit rounds seen (backoff clock)
        self._idle = threading.Condition(self._lock)
        self._inflight = 0
        self._threads: List[threading.Thread] = []
        # prefetcher state (all guarded by _lock): recently observed
        # store keys in recency order, external hint weights, and the
        # tick each candidate was last attempted at (its staleness clock)
        self._recent: "OrderedDict[StoreKey, None]" = OrderedDict()
        self._hints: Dict[StoreKey, float] = {}
        self._last_attempt: Dict[StoreKey, int] = {}
        self.max_retries = max_retries
        self.backoff_rounds = backoff_rounds
        self.submitted = 0
        self.compiled = 0
        self.duplicates = 0                # submits deduped away
        self.retries = 0                   # re-submits after a raised compile
        self.backoffs = 0                  # submits deferred by backoff
        self.prefetch_submitted = 0        # speculative jobs enqueued
        self.prefetch_compiled = 0         # ... that landed a plan
        self.errors: List[str] = []
        self.max_errors = 32               # errors list retention cap
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    @property
    def running(self) -> bool:
        return any(t.is_alive() for t in self._threads)

    def start(self) -> None:
        """(Re)fill the worker pool to ``max_workers`` live threads."""
        self._threads = [t for t in self._threads if t.is_alive()]
        for k in range(len(self._threads), self.max_workers):
            t = threading.Thread(target=self._worker,
                                 name=f"matcha-bg-compile-{k}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self, timeout_s: float = 30.0) -> None:
        """Finish queued jobs, then stop the worker pool.  Any worker
        still mid-compile when the timeout expires stays registered
        (``running`` remains True) so a later ``drain`` or ``start``
        cannot race a zombie worker on the same queue; it will exit at
        its sentinel once the compile finishes."""
        live = [t for t in self._threads if t.is_alive()]
        if not live:
            self._threads = []
            return
        for _ in live:                     # one sentinel per live worker
            self._jobs.put((math.inf, next(self._seq), None))
        per_join = timeout_s / len(live)   # split the budget across joins
        for t in live:
            t.join(timeout=per_join)
        self._threads = [t for t in self._threads if t.is_alive()]

    # -- the queue ----------------------------------------------------------

    def submit(self, active, source: str = "background",
               priority: float = 0.0) -> bool:
        """Enqueue a compile for ``active`` (tenant ids, or a
        :class:`~repro.core.shapes.PlanKey` lattice point) unless the
        plan is already cached, the key is already queued/in-flight, its
        backoff window after a raised compile has not elapsed, or its
        retries are exhausted (poisoned — the engine keeps serving that
        key on the compile-alone floor instead of burning a worker on a
        doomed compile every round)."""
        key = _norm_key(active)
        with self._lock:
            self._tick += 1
            if key in self._queued or key in self._failed:
                self.duplicates += 1
                return False
            if self._tick < self._retry_after.get(key, 0):
                self.backoffs += 1         # still backing off: try later
                return False
            if self.session.try_plan_for(key) is not None:
                self.duplicates += 1
                return False
            if self._attempts.get(key, 0) > 0:
                self.retries += 1
            self._queued.add(key)
            self._inflight += 1
            self._last_attempt[key] = self._tick
            if source == "prefetch":
                self.prefetch_submitted += 1
            else:
                self.submitted += 1
        self._jobs.put((priority, next(self._seq),
                        CompileJob(key, source=source)))
        return True

    def clear_failed(self) -> int:
        """Un-poison every failed occupancy (and reset its retry state) so
        future submits compile again; returns how many were cleared."""
        with self._lock:
            n = len(self._failed)
            self._failed.clear()
            self._attempts.clear()
            self._retry_after.clear()
            return n

    @property
    def pending(self) -> int:
        with self._lock:
            return self._inflight

    # -- the occupancy-lattice prefetcher -----------------------------------

    def observe(self, active) -> int:
        """Record one dispatched store key (hit or miss) as a lattice
        anchor, then speculatively enqueue the top-ranked uncompiled
        neighbors (when ``prefetch`` is on).  Returns the number of
        prefetch jobs enqueued.  The engine calls this on every resolve;
        it is cheap — candidate generation walks at most
        ``recent_window`` anchors' Hamming-1 neighborhoods (occupancy
        joins/leaves plus one-rung bucket-ladder steps)."""
        key = _norm_key(active)
        with self._lock:
            self._recent.pop(key, None)
            self._recent[key] = None       # most-recent at the end
            while len(self._recent) > self.recent_window:
                self._recent.popitem(last=False)
        if not self.prefetch:
            return 0
        return self.prefetch_now()

    def prefetch_hint(self, occupancies: Sequence[Sequence[int]],
                      weight: float = 1.0) -> None:
        """Register externally predicted store keys (e.g. the fleet
        placement's per-SoC tenant sets, mapped to this session's tenant
        indices — bare id lists or :class:`PlanKey` lattice points) as
        standing prefetch candidates with the given probability weight."""
        with self._lock:
            for occ in occupancies:
                self._hints[_norm_key(occ)] = float(weight)

    def _bucket_spec(self, tenant: int):
        """The tenant's shape-bucket spec via the session (``None`` for
        fixed-shape tenants and duck-typed test-fake sessions)."""
        spec_of = getattr(self.session, "bucket_spec", None)
        return spec_of(tenant) if spec_of is not None else None

    def _candidates(self) -> List[Tuple[float, StoreKey]]:
        """Ranked prefetch candidates: Hamming-1 lattice neighbors of
        the recent anchors (recency-decayed) plus the standing hints,
        scored by predicted request probability x staleness.

        A neighbor differs from its anchor in exactly one coordinate of
        the (occupancy x bucket-vector) product lattice: one tenant
        joins (at its default bucket) or leaves, or one shape-bucketed
        tenant steps one rung along its bucket ladder.  Down-steps carry
        the anchor's full recency weight while up-steps carry half — a
        tenant just observed at a prefill bucket is about to decode, so
        walking toward seq=1 prefetches the prefill->decode transition
        before the engine demands it.  Caller holds the lock."""
        n = len(self.session.request.graphs)
        universe = frozenset(range(n))
        scores: Dict[StoreKey, float] = {}

        def bump(key: StoreKey, w: float) -> None:
            scores[key] = scores.get(key, 0.0) + w

        recents = list(self._recent)       # oldest .. newest
        for age, anchor in enumerate(reversed(recents)):   # newest first
            w = 0.5 ** age                 # recency-decayed probability
            occ, bks = key_parts(anchor)
            for t in universe - occ:       # a tenant joins (at default)
                bump(make_plan_key(occ | {t}, bks), w)
            if len(occ) > 1:
                for t in occ:              # a tenant leaves
                    bump(make_plan_key(
                        occ - {t},
                        {k: v for k, v in bks.items() if k != t}), w)
            for t in sorted(occ):          # one bucket-ladder step
                spec = self._bucket_spec(t)
                if spec is None:
                    continue
                cur = bks.get(t, spec.default)
                for nb in spec.neighbors(cur):
                    nbks = dict(bks)
                    if nb == spec.default:
                        nbks.pop(t, None)
                    else:
                        nbks[t] = nb
                    bump(make_plan_key(occ, nbks),
                         w if nb < cur else w * 0.5)
        for key, w in self._hints.items():
            bump(key, w)
        out: List[Tuple[float, StoreKey]] = []
        window = max(self.recent_window, 1)
        for key, prob in scores.items():
            occ = key_parts(key)[0]
            if not occ:
                continue
            if not isinstance(key, PlanKey) and key == universe:
                continue                   # bare full house: always cached
            if key in self._queued or key in self._failed:
                continue
            last = self._last_attempt.get(key)
            staleness = (1.0 if last is None else
                         min((self._tick - last) / window, 1.0))
            if staleness <= 0.0:
                continue
            out.append((prob * staleness, key))
        # deterministic rank: score desc, then canonical lattice order
        out.sort(key=lambda so: (-so[0], key_sort(so[1])))
        return out

    def prefetch_now(self, limit: Optional[int] = None) -> int:
        """Enqueue up to ``limit`` (default ``prefetch_depth``) top-
        ranked speculative compiles.  Cached occupancies rank zero
        (``submit`` also bounces them, keeping exactly-once); prefetch
        jobs carry priority ``1/(1+score)`` so reactive misses always
        dequeue first."""
        limit = self.prefetch_depth if limit is None else limit
        with self._lock:
            ranked = self._candidates()
        enqueued = 0
        for score, occ in ranked:
            if enqueued >= limit:
                break
            if self.submit(occ, source="prefetch",
                           priority=1.0 / (1.0 + score)):
                enqueued += 1
        return enqueued

    # -- job execution ------------------------------------------------------

    def _run_job(self, job: CompileJob) -> None:
        try:
            landed = self.session.submit_compile(job.occupancy,
                                                 source=job.source)
            with self._lock:               # success clears retry state
                if landed:
                    self.compiled += 1
                    if job.source == "prefetch":
                        self.prefetch_compiled += 1
                self._attempts.pop(job.occupancy, None)
                self._retry_after.pop(job.occupancy, None)
        except Exception as exc:           # keep serving on compile bugs
            with self._lock:
                attempts = self._attempts.get(job.occupancy, 0) + 1
                self._attempts[job.occupancy] = attempts
                if len(self.errors) < self.max_errors:
                    self.errors.append(
                        f"{describe_key(job.occupancy)}: {exc!r}")
                if attempts > self.max_retries:
                    self._failed.add(job.occupancy)   # retries exhausted
                    self._retry_after.pop(job.occupancy, None)
                else:
                    self._retry_after[job.occupancy] = (
                        self._tick
                        + self.backoff_rounds * (2 ** (attempts - 1)))
        finally:
            with self._lock:
                self._queued.discard(job.occupancy)
                self._inflight -= 1
                self._idle.notify_all()

    def run_pending(self) -> int:
        """Synchronously compile every queued job on the caller's thread
        (the deterministic no-thread mode).  Returns jobs processed."""
        n = 0
        while True:
            try:
                _, _, job = self._jobs.get_nowait()
            except queue.Empty:
                return n
            if job is None:
                continue
            self._run_job(job)
            n += 1

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Block until all submitted jobs have compiled (True), or the
        timeout expired (False).  With no worker thread running, pumps
        the queue synchronously instead of waiting."""
        if not self.running:
            self.run_pending()
            return self.pending == 0
        with self._idle:
            return self._idle.wait_for(lambda: self._inflight == 0,
                                       timeout=timeout_s)

    def _worker(self) -> None:
        while True:
            _, _, job = self._jobs.get()
            if job is None:
                return
            self._run_job(job)

    def stats(self) -> dict:
        # one consistent snapshot: every counter the worker threads write
        # is read under the same lock that guards the writes (reading
        # `pending` via its property here would re-take the non-reentrant
        # lock and deadlock, so `_inflight` is read directly)
        with self._lock:
            return {"submitted": self.submitted, "compiled": self.compiled,
                    "duplicates": self.duplicates,
                    "pending": self._inflight,
                    "retries": self.retries, "backoffs": self.backoffs,
                    "max_retries": self.max_retries,
                    "max_workers": self.max_workers,
                    "prefetch": self.prefetch,
                    "prefetch_submitted": self.prefetch_submitted,
                    "prefetch_compiled": self.prefetch_compiled,
                    "prefetch_hints": len(self._hints),
                    "failed_occupancies": len(self._failed),
                    "errors": len(self.errors), "running": self.running}
