"""Multi-tenant serving engine.

:class:`MultiModelEngine` admits inference requests for N *different*
models compiled onto one SoC (``repro.core.api.compile_multi`` / a
``repro.core.deploy.DeploymentSession``) and dispatches them in
co-scheduled rounds — every round executes the plan covering exactly that
occupancy (``plan_for(active)``, answered from the session's
occupancy-indexed plan store), including singleton occupancies, whose
one-tenant plan is never worse than the full-house reference schedule.
The compile-alone back-to-back fallback remains only for session-less
artifacts.

LM tenants ride the same engine since the shape-bucket rework: a request
may carry a ``seq_len``, which the tenant's
:class:`~repro.core.shapes.ShapeBucketSpec` rounds up to a power-of-two
sequence bucket.  The round then resolves its plan at the
``(occupancy, bucket-vector)`` lattice point of the dispatched heads
(``plan_for(ids, shapes=...)``), so a prefill round and a decode round at
the same occupancy are distinct cached plans, and every service-time
estimate the scheduler leans on — per-request floors, backlog, EDF
winnability, the composer's probe — is priced at the request's *bucket*,
not at the tenant's default (prefill) graph.  This retired the old
single-model token-loop ``Engine``: prefill and decode are submitted as
separate bucketed requests through this engine instead (see
``examples/serve_lm.py``).

Since the SLO rework the dispatch layer is pluggable:

  * requests carry a :class:`~repro.serve.admission.Priority` class and an
    optional relative ``deadline_s``; an
    :class:`~repro.serve.admission.AdmissionController` can bound queue
    depth per class (rejections are recorded, never silent);
  * a :class:`~repro.serve.admission.RoundComposer` picks the round's
    occupancy by deadline pressure (priority-weighted, starvation-aged
    urgency per predicted round second) instead of taking the FIFO front
    — and degrades to the bitwise-identical FIFO composition while no
    queued request carries an SLO; once SLOs exist, each tenant's queue
    also dispatches EDF *within the head's priority class* (earliest
    still-winnable ``deadline_abs_s`` first, deadline-protected and
    bypass-bounded — see ``MultiModelEngine._edf_index``);
  * an attached :class:`~repro.serve.compiler_thread.BackgroundCompiler`
    moves ``plan_for`` misses off the dispatch path: the engine probes
    the store non-blockingly (``try_plan_for``), serves the compile-alone
    concat floor while the subset plan compiles in the background, and
    swaps to the real co-schedule when it lands — the first round at an
    unseen occupancy never stalls on a joint CP solve;
  * ``max_batch > 1`` lifts the one-request-per-tenant-per-round limit: a
    dispatched tenant drains up to ``max_batch`` queued requests in
    back-to-back waves inside the round, and consecutive waves that
    re-execute the *same* cached plan are charged the weights-resident
    repeat cost (the plan's parameter-load DMA cycles are saved, floored
    by the busiest resource's work — params stay in shared L2 between
    identical back-to-back executions).

The engine's clock is the analytic schedule model's: every round advances
``clock_s`` by the round's makespan at the SoC clock, so deadlines,
per-class latency percentiles and SLO attainment are deterministic,
machine-independent quantities.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from repro_torch.serve.admission import (AdmissionController, Priority,
                                   RoundComposer, RoundPlanProbe,
                                   TenantView)
from repro_torch.serve.compiler_thread import BackgroundCompiler


@dataclasses.dataclass
class InferRequest:
    rid: int
    tenant: int
    inputs: Dict[str, Any]
    submit_round: int
    latency_ms: float = 0.0
    wait_rounds: int = 0          # serving rounds spent queued (FIFO depth)
    co_scheduled: bool = False
    # --- SLO surface -------------------------------------------------------
    priority: Priority = Priority.NORMAL
    deadline_s: Optional[float] = None    # relative to submit_s; None = none
    submit_s: float = 0.0                 # engine clock at submission
    depth_at_submit: int = 0              # queue depth ahead at submission
    finish_s: float = 0.0                 # engine clock at completion
    e2e_latency_ms: float = 0.0           # submit -> completion, wall model
    deadline_met: Optional[bool] = None   # None when no deadline was set
    served_on_floor: bool = False         # compile-alone floor round (async)
    edf_bypasses: int = 0                 # times an EDF pick jumped this one
    # --- shape buckets -----------------------------------------------------
    seq_len: Optional[int] = None         # raw sequence length, if any
    bucket: Optional[int] = None          # resolved shape bucket, if any
    # absolute deadline pinned at the ORIGINAL submission: a requeued /
    # migrated request re-enters another engine with a fresh submit_s on a
    # different analytic clock, and recomputing submit_s + deadline_s there
    # would silently extend the SLO by the time already burned waiting
    deadline_abs_override_s: Optional[float] = None

    @property
    def deadline_abs_s(self) -> Optional[float]:
        if self.deadline_abs_override_s is not None:
            return self.deadline_abs_override_s
        return (None if self.deadline_s is None
                else self.submit_s + self.deadline_s)


class MultiModelEngine:
    """Admits requests for N co-compiled models and serves them in rounds.

    Each round runs the co-schedule covering exactly the round's occupancy
    (``plan_for`` from the session's occupancy-indexed plan store) — the
    active models advance concurrently and the round costs that
    co-schedule's makespan; a lone active tenant runs its cached singleton
    occupancy plan (falling back to the single-model reference schedule on
    session-less artifacts).  Per-request latency is taken from the
    analytic schedule model (cycles -> ms at the SoC clock).

    Optional layers (all off by default — the default engine is bitwise
    the FIFO engine):

      * ``admission`` — per-class queue bounds; rejected requests are
        recorded in ``rejected`` and ``submit`` returns ``None``.
      * ``composer`` — SLO-aware round composition; engages only once a
        request with a priority class or deadline has been submitted.
      * ``async_compile`` — ``True`` (spawn a worker thread) or a
        :class:`BackgroundCompiler` (e.g. ``start=False`` for
        deterministic pumping): occupancy-plan misses serve the
        compile-alone concat floor and compile in the background.
      * ``max_batch`` — per-tenant batch depth within one round.
      * ``execute=False`` skips the numeric execution (analytic
        timing only) for long serving-trace simulations.
      * ``device`` is where parameters, request inputs and the numeric
        execution live (``"cuda"`` by default; ``"cpu"`` runs the
        kernels' plain torch versions).
    """

    def __init__(self, compiled, params_list=None, seed: int = 0, *,
                 admission: Optional[AdmissionController] = None,
                 composer: Optional[RoundComposer] = None,
                 async_compile=False,
                 max_batch: int = 1,
                 execute: bool = True,
                 device="cuda"):
        from repro_torch.core.runtime import init_params
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1: {max_batch}")
        self.compiled = compiled
        self.soc = compiled.soc
        self.execute = execute
        self.device = device
        self.params = (list(params_list) if params_list is not None else
                       [init_params(g, seed + i, device)
                        for i, g in enumerate(compiled.graphs)])
        self.n_tenants = len(compiled.graphs)
        self._by_name = {g.name: i for i, g in enumerate(compiled.graphs)}
        self.queues: List[List[InferRequest]] = [[] for _ in
                                                 range(self.n_tenants)]
        # dispatch step (= compose decision) at which each queue's current
        # head became the head — the composer's starvation clock.  Tenure
        # is measured in STEPS, not rounds: with max_batch > 1 one step
        # runs several wave-rounds, and a rounds-based clock would let a
        # deferred head overshoot the forced-inclusion bound by up to
        # max_batch - 1 rounds between compose decisions.
        self._steps = 0
        self._head_since: List[int] = [0] * self.n_tenants
        self.results: Dict[int, Dict[str, Any]] = {}
        self.done: Dict[int, InferRequest] = {}
        self.rejected: List[InferRequest] = []
        self._next_rid = 0
        self._round = 0
        self.co_rounds = 0
        self.subset_co_rounds = 0     # co-rounds at partial occupancy
        self.solo_rounds = 0          # singleton occupancy-plan rounds
        self.fallback_rounds = 0      # session-less back-to-back rounds
        self.floor_rounds = 0         # async-miss compile-alone floor rounds
        self.batched_repeat_rounds = 0
        self.solo_dispatches = 0
        self.busy_cycles = 0.0
        self.clock_s = 0.0            # analytic serving clock, seconds
        # --- SLO / async layers -------------------------------------------
        self.admission = admission
        self.composer = composer
        self.max_batch = max_batch
        self._slo_seen = False        # any request ever carried an SLO
        self.class_submitted: Dict[Priority, int] = {p: 0 for p in Priority}
        session = getattr(compiled, "session", None)
        self.session = session
        if async_compile and session is None:
            raise ValueError("async_compile needs a session-backed "
                             "compiled artifact")
        if isinstance(async_compile, BackgroundCompiler):
            self.compiler: Optional[BackgroundCompiler] = async_compile
        elif async_compile:
            self.compiler = BackgroundCompiler(session)
        else:
            self.compiler = None

    def resolve(self, model) -> int:
        if isinstance(model, str):
            return self._by_name[model]
        return int(model)

    # -- clock & admission --------------------------------------------------

    def _cycles_to_s(self, cycles: float) -> float:
        return self.soc.cycles_to_ms(cycles) / 1e3

    def advance_clock(self, t_s: float) -> None:
        """Open-loop arrivals: move the serving clock forward to ``t_s``
        (never backwards) — the idle gap before the next arrival."""
        self.clock_s = max(self.clock_s, t_s)

    def _class_depths(self) -> Dict[Priority, int]:
        depths: Dict[Priority, int] = {p: 0 for p in Priority}
        for q in self.queues:
            for r in q:
                depths[r.priority] += 1
        return depths

    def _resolve_bucket(self, tenant: int,
                        seq_len: Optional[int]) -> Optional[int]:
        """Round ``seq_len`` up to the tenant's shape bucket (``None``
        for shapeless requests).  Requires a session-backed artifact with
        a :class:`~repro.core.shapes.ShapeBucketSpec` for the tenant."""
        if seq_len is None:
            return None
        spec = (self.session.bucket_spec(tenant)
                if self.session is not None else None)
        if spec is None:
            raise ValueError(f"tenant {tenant} takes no seq_len: no "
                             f"shape_buckets spec (session-backed "
                             f"artifacts only)")
        return spec.bucket_for(seq_len)

    def submit(self, model, inputs=None, seed: int = 0,
               priority: Priority = Priority.NORMAL,
               deadline_s: Optional[float] = None,
               arrival_s: Optional[float] = None,
               seq_len: Optional[int] = None,
               deadline_abs_s: Optional[float] = None) -> Optional[int]:
        """Queue one inference for ``model`` (graph name or tenant index).

        ``inputs`` defaults to random inputs for smoke runs (skipped when
        the engine runs with ``execute=False``).  ``deadline_s`` is
        relative to the submission clock; ``deadline_abs_s`` instead pins
        the deadline on the absolute analytic clock — the fleet router
        uses it to requeue a migrated request without restarting its SLO.
        ``arrival_s`` stamps an open-loop arrival time (also advancing
        the idle clock).  ``seq_len`` routes an LM tenant's request to
        its shape bucket (prefill at the prompt length, decode at 1); the
        bucket's compile-alone artifact is built here, at submission —
        off the dispatch path.  Returns the request id, or ``None`` when
        admission rejected the request (recorded in ``rejected``)."""
        tenant = self.resolve(model)
        priority = Priority(priority)
        bucket = self._resolve_bucket(tenant, seq_len)
        if arrival_s is not None:
            self.advance_clock(arrival_s)
        submit_s = arrival_s if arrival_s is not None else self.clock_s
        self.class_submitted[priority] += 1
        rid = self._next_rid
        self._next_rid += 1
        if (self.admission is not None
                and not self.admission.admit(priority,
                                             self._class_depths())):
            # rejected before any input generation; no arrays retained
            self.rejected.append(
                InferRequest(rid, tenant, None, self._round,
                             priority=priority, deadline_s=deadline_s,
                             submit_s=submit_s,
                             depth_at_submit=len(self.queues[tenant]),
                             seq_len=seq_len, bucket=bucket,
                             deadline_abs_override_s=deadline_abs_s))
            return None
        if (priority != Priority.NORMAL or deadline_s is not None
                or deadline_abs_s is not None):
            # only ADMITTED SLO traffic ends the zero-cost FIFO
            # short-circuit — a rejected request never enters a queue
            self._slo_seen = True
        if bucket is not None:
            # price the request's floor before it can be dispatched (and
            # never inside a round): compile-alone at the bucket
            self.session.bucket_single(tenant, bucket)
        if inputs is None and self.execute:
            from repro_torch.core.runtime import init_inputs
            g = (self.session.bucket_graph(tenant, bucket)
                 if bucket is not None else self.compiled.graphs[tenant])
            inputs = init_inputs(g, seed + rid, self.device)
        req = InferRequest(rid, tenant, inputs, self._round,
                           priority=priority, deadline_s=deadline_s,
                           submit_s=submit_s,
                           depth_at_submit=len(self.queues[tenant]),
                           seq_len=seq_len, bucket=bucket,
                           deadline_abs_override_s=deadline_abs_s)
        if not self.queues[tenant]:
            self._head_since[tenant] = self._steps
        self.queues[tenant].append(req)
        if self.compiler is not None and self.compiler.prefetch:
            # announce the bucket transition at ARRIVAL: the lattice
            # point the next round will dispatch at (current heads'
            # buckets) goes straight into the prefetch queue, so a
            # prefill->decode transition compiles off-path before it is
            # ever demanded — the lattice walk alone only reaches one
            # rung per observed round and a decode bucket can be several
            # rungs down.  Fires on ANY arrival while a bucketed head is
            # queued (an unbucketed tenant joining changes the lattice
            # point too); pure fixed-shape traffic never reaches it.
            active = [t for t, q in enumerate(self.queues) if q]
            shapes = {t: self.queues[t][0].bucket for t in active
                      if self.queues[t][0].bucket is not None}
            if shapes:
                self.compiler.submit(
                    self.session.plan_key(active, shapes),
                    source="prefetch", priority=0.25)
        return rid

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self.queues)

    def backlog_s(self) -> float:
        """Analytic upper estimate of the queued work, in seconds: every
        queued request charged its *bucket's* compile-alone makespan (a
        decode request is ~2 orders cheaper than its tenant's prefill
        default — pricing both at the default graph was the shape-blind
        bug that made the fleet router steer decode streams away from
        lightly loaded engines).  It ignores co-scheduling overlap — a
        deliberate upper bound, used by the fleet router's
        least-predicted-completion scoring."""
        return sum(self._req_floor_s(r) for q in self.queues for r in q)

    def drain_pending(self) -> List[InferRequest]:
        """Remove and return every queued (not yet dispatched) request,
        in tenant-then-FIFO order.  The fleet rebalancer calls this on a
        failed or draining SoC to requeue the unserved work elsewhere —
        dispatched (``done``) requests are untouched."""
        out: List[InferRequest] = []
        for q in self.queues:
            out.extend(q)
            q.clear()
        return out

    # -- round composition --------------------------------------------------

    def _floor_s(self, tenant: int, bucket: Optional[int] = None) -> float:
        """Compile-alone makespan of one tenant at ``bucket`` (default
        graph when ``None``), seconds — the concat floor's per-member
        contribution.  The bucket artifact was compiled at submission,
        so this lookup is cache-hit cheap on the dispatch path."""
        if bucket is None:
            return self._cycles_to_s(
                self.compiled.singles[tenant].plan.makespan)
        return self._cycles_to_s(
            self.session.bucket_single(tenant, bucket).plan.makespan)

    def _req_floor_s(self, r: InferRequest) -> float:
        """One request's compile-alone service estimate, priced at its
        shape bucket."""
        return self._floor_s(r.tenant, r.bucket)

    def _head_shapes(self, ids: List[int]
                     ) -> Optional[Mapping[int, int]]:
        """Bucket vector of the requests the next wave over ``ids``
        would pop (the EDF pick per tenant) — the ``shapes=`` argument
        for plan resolution.  ``None`` when every head is shapeless."""
        shapes: Dict[int, int] = {}
        for i in ids:
            q = self.queues[i]
            if not q:
                continue
            r = q[self._edf_index(i)]
            if r.bucket is not None:
                shapes[i] = r.bucket
        return shapes or None

    def _probe(self) -> RoundPlanProbe:
        heads = {i: self.queues[i][self._edf_index(i)]
                 for i in range(self.n_tenants) if self.queues[i]}
        if self.session is not None:
            buckets = {i: r.bucket for i, r in heads.items()
                       if r.bucket is not None}

            def try_plan(ids, touch: bool = False):
                sh = {i: buckets[i] for i in ids if i in buckets}
                return self.session.try_plan_for(ids, touch=touch,
                                                 shapes=sh or None)
        else:
            try_plan = None
        return RoundPlanProbe(
            try_plan=try_plan, cycles_to_s=self._cycles_to_s,
            floors_s={i: (self._req_floor_s(heads[i]) if i in heads
                          else self._floor_s(i))
                      for i in range(self.n_tenants)})

    def _compose_round(self, active: List[int]) -> List[int]:
        if self.composer is None:
            return active
        if not self._slo_seen:
            # bitwise FIFO until the first SLO-carrying request arrives
            # (short-circuited before any view construction: the
            # composer-equipped engine costs nothing until SLOs exist)
            self.composer.fifo_rounds += 1
            return active
        views = [TenantView(tenant=i, priority=self.queues[i][0].priority,
                            deadline_abs_s=self.queues[i][0].deadline_abs_s,
                            wait_rounds=self._round
                            - self.queues[i][0].submit_round,
                            depth=len(self.queues[i]),
                            floor_s=self._req_floor_s(self.queues[i][0]),
                            head_tenure_rounds=self._steps
                            - self._head_since[i],
                            queue=tuple((r.priority, r.deadline_abs_s,
                                         self._round - r.submit_round)
                                        for r in self.queues[i]))
                 for i in active]
        cached = (self.session.store.occupancies()
                  if self.session is not None else ())
        ids = self.composer.compose(views, self.clock_s, self._probe(),
                                    cached_occupancies=cached)
        return ids if ids else active

    # -- dispatch -----------------------------------------------------------

    def _resolve_plan(self, ids: List[int],
                      shapes: Optional[Mapping[int, int]] = None):
        """The round's occupancy plan at the given bucket vector, or
        ``None`` for a floor/fallback round.  With a background compiler
        attached the lookup never compiles: a miss enqueues the compile
        and this round serves the compile-alone concat floor."""
        if self.compiler is not None:
            # every dispatched lattice point (hit or miss) anchors the
            # compiler's shape/occupancy-lattice prefetcher
            key = self.session.plan_key(ids, shapes)
            self.compiler.observe(key)
            plan = self.session.try_plan_for(key, touch=True)
            if plan is None:
                self.compiler.submit(key)
            return plan, plan is None          # floor round on miss
        return self.compiled.plan_for(ids, shapes=shapes), False

    def _param_dma_in_cycles(self, plan) -> float:
        """DMA cycles this plan spends loading parameter tensors — the
        traffic a back-to-back re-execution of the same plan skips
        (weights already resident in shared L2)."""
        tenants = getattr(plan, "tenants", None)
        if tenants is None:
            return 0.0
        total = 0.0
        for d in plan.dmas:
            if d.direction != "in":
                continue
            name = d.tensor
            if "/" not in name or not name.startswith("t"):
                continue
            idx, _, base = name.partition("/")
            try:
                ti = tenants[int(idx[1:])].graph.tensors.get(base)
            except (ValueError, IndexError):
                continue
            if ti is not None and ti.kind == "param":
                total += d.end - d.start
        return total

    def _repeat_cycles(self, plan) -> float:
        """Cost of re-executing ``plan`` immediately after itself: the
        makespan minus the saved parameter-load DMA cycles, floored by
        the busiest resource's work (removing DMAs cannot beat the
        critical compute).  Computed per call — the DMA scan is tens of
        records, and caching by plan identity would go stale across the
        store's LRU evictions."""
        saved = self._param_dma_in_cycles(plan)
        busy = dict(plan.busy)
        if "dma" in busy:
            busy["dma"] = max(0.0, busy["dma"] - saved)
        lower = max(busy.values(), default=0.0)
        return max(plan.makespan - saved, lower)

    def _edf_index(self, tenant: int) -> int:
        """Queue index the next dispatch for ``tenant`` pops.

        Plain FIFO (the head, index 0) unless a composer is attached and
        SLO traffic has been seen — the bitwise-FIFO-without-SLOs
        property is decided here exactly as in ``_compose_round``.

        With SLOs the queue serves EDF *within the head's priority
        class*: among queued requests of the head's class, the earliest
        still-winnable absolute deadline dispatches first (deadline-less
        requests keep FIFO order among themselves).  Three guards keep
        the reorder from trading attainment or boundedness away:

          * a deadline that cannot be met even if served immediately
            (absolute deadline before ``clock_s`` plus the *request's
            bucket* compile-alone floor — a decode request stays
            winnable far later than a prefill one) earns no jump — EDF
            never delays a winnable request for a lost cause;
          * a jump may not predictably kill a bypassed request's
            deadline: every deadline-carrying request it would jump
            must survive one extra wave of delay (``clock_s + 2 *`` its
            own bucket floor) — the composer's deadline-protection rule
            applied inside the queue — unless that deadline is already
            sealed;
          * a request bypassed ``starvation_rounds`` times blocks any
            further jump over it, so the structural wait bound
            stretches by at most the recorded ``edf_bypasses`` (see
            :meth:`starvation_events`).
        """
        q = self.queues[tenant]
        if self.composer is None or not self._slo_seen or len(q) <= 1:
            return 0
        cls = q[0].priority
        limit = self.composer.config.starvation_rounds

        def key(r: InferRequest, i: int):
            dl = r.deadline_abs_s
            winnable = (dl is not None
                        and dl >= self.clock_s + self._req_floor_s(r))
            return (dl if winnable else float("inf"), i)

        best_i, best_key = 0, key(q[0], 0)
        for i in range(1, len(q)):
            prev = q[i - 1]
            if prev.edf_bypasses >= limit:
                break                      # bypass budget exhausted ahead
            pdl = prev.deadline_abs_s
            if pdl is not None:
                pfloor = self._req_floor_s(prev)
                if (self.clock_s + pfloor <= pdl
                        < self.clock_s + 2.0 * pfloor):
                    break                  # jump would endanger a winnable
            r = q[i]
            if r.priority != cls:
                continue
            k = key(r, i)
            if k < best_key:
                best_i, best_key = i, k
        return best_i

    def _pop_head(self, tenant: int) -> InferRequest:
        """Pop the next request for ``tenant``: the FIFO head, or the
        EDF pick within the head's class once SLOs exist (see
        :meth:`_edf_index`).  Popping a non-head leaves the head — and
        its starvation-tenure clock — in place."""
        k = self._edf_index(tenant)
        q = self.queues[tenant]
        for j in range(k):
            q[j].edf_bypasses += 1
        r = q.pop(k)
        if k == 0:
            self._head_since[tenant] = self._steps   # next head's tenure
        return r

    def _finish(self, r: InferRequest, finish_s: float, latency_ms: float,
                co: bool, out, completed: List[int],
                floor: bool = False) -> None:
        r.latency_ms = latency_ms
        r.wait_rounds = self._round - 1 - r.submit_round
        r.co_scheduled = co
        r.finish_s = finish_s
        r.e2e_latency_ms = (finish_s - r.submit_s) * 1e3
        r.served_on_floor = floor
        dl = r.deadline_abs_s
        if dl is not None:
            # via deadline_abs_s, NOT submit_s + deadline_s: a migrated
            # request's override keeps the original SLO across engines
            r.deadline_met = finish_s <= dl
        self.results[r.rid] = out
        self.done[r.rid] = r
        completed.append(r.rid)

    def _dispatch_wave(self, ids: List[int], completed: List[int],
                       prev_plan):
        """One serving round over exactly the tenants in ``ids``; returns
        the plan executed (for the batched repeat discount)."""
        from repro_torch.core.runtime import execute_multi_plan, execute_plan
        self._round += 1
        round_start = self.clock_s
        # the bucket vector of the heads this wave pops — resolved BEFORE
        # popping, so the plan lookup and the pop see the same EDF picks
        plan, floor = self._resolve_plan(ids, self._head_shapes(ids))
        if plan is not None:
            # positions in the occupancy plan follow sorted tenant ids,
            # which is the order ``ids`` arrives in
            reqs = [self._pop_head(i) for i in ids]
            outs = (execute_multi_plan(plan, [r.inputs for r in reqs],
                                       [self.params[r.tenant]
                                        for r in reqs])
                    if self.execute else [None] * len(reqs))
            if len(reqs) == 1:
                self.solo_dispatches += 1
                self.solo_rounds += 1
            else:
                self.co_rounds += 1
                if len(reqs) < self.n_tenants:
                    self.subset_co_rounds += 1
            round_cycles = plan.makespan
            if plan is prev_plan:
                round_cycles = self._repeat_cycles(plan)
                self.batched_repeat_rounds += 1
            self.busy_cycles += round_cycles
            for pos, r in enumerate(reqs):
                # clamped to the (possibly repeat-discounted) round cost,
                # so recorded service latency never exceeds the wave's
                # wall duration that finish_s / clock_s are built on
                comp = min(plan.tenant_makespans[pos], round_cycles)
                self._finish(r, round_start + self._cycles_to_s(comp),
                             self.soc.cycles_to_ms(comp),
                             len(reqs) > 1, outs[pos], completed)
            self.clock_s = round_start + self._cycles_to_s(round_cycles)
            return plan
        # floor (async miss) or fallback (session-less partial occupancy):
        # single-model schedules back-to-back; each request's latency
        # includes the in-round wait behind the tenants dispatched before
        # it (consistent with the co-scheduled path, which charges
        # tenant_makespans[pos]).  The async floor runs the compile-alone
        # schedules — the hard floor the pending subset plan is
        # guaranteed to beat or tie — while the legacy session-less
        # fallback keeps the reference (tenant_plan) schedules.
        if floor:
            self.floor_rounds += 1
        else:
            self.fallback_rounds += 1
        round_offset = 0.0
        for i in ids:
            r = self._pop_head(i)
            if floor:
                splan = (self.session.bucket_single(i, r.bucket).plan
                         if r.bucket is not None
                         else self.compiled.singles[i].plan)
            else:
                splan = self.compiled.tenant_plan(i)
            out = (execute_plan(splan, r.inputs, self.params[i])
                   if self.execute else None)
            self.solo_dispatches += 1
            self.busy_cycles += splan.makespan
            round_offset += splan.makespan
            self._finish(r, round_start + self._cycles_to_s(round_offset),
                         self.soc.cycles_to_ms(round_offset),
                         False, out, completed, floor=floor)
        self.clock_s = round_start + self._cycles_to_s(round_offset)
        return None

    def step(self) -> List[int]:
        """Dispatch one serving round (``max_batch`` waves at most);
        returns the completed request ids.

        The round's occupancy comes from the composer when one is
        attached (FIFO — every tenant with queued work — otherwise, and
        bitwise FIFO until any request carries an SLO).  The occupancy
        plan comes from ``plan_for(active)`` (the session's plan store),
        or from the non-blocking ``try_plan_for`` + background compile +
        compile-alone floor path when a :class:`BackgroundCompiler` is
        attached.  With ``max_batch > 1`` the chosen tenants drain up to
        that many queued requests in back-to-back waves; waves re-running
        the same plan pay the weights-resident repeat cost."""
        active = [i for i, q in enumerate(self.queues) if q]
        if not active:
            return []
        ids = sorted(self._compose_round(active))
        completed: List[int] = []
        budget = {i: min(len(self.queues[i]), self.max_batch) for i in ids}
        prev_plan = None
        while True:
            wave = [i for i in ids if budget[i] > 0 and self.queues[i]]
            if not wave:
                break
            prev_plan = self._dispatch_wave(wave, completed, prev_plan)
            for i in wave:
                budget[i] -= 1
        self._steps += 1
        return completed

    def run(self) -> Dict[int, Dict[str, Any]]:
        """Drain all queues; returns {rid: output arrays}."""
        while self.pending:
            self.step()
        return self.results

    # -- reporting ----------------------------------------------------------

    @property
    def rounds(self) -> int:
        return self._round

    def _percentile(self, xs: List[float], q: float) -> float:
        return float(np.percentile(np.asarray(xs), q)) if xs else 0.0

    def _per_class(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        rej: Dict[Priority, int] = {p: 0 for p in Priority}
        for r in self.rejected:
            rej[r.priority] += 1
        for p in Priority:
            reqs = [r for r in self.done.values() if r.priority == p]
            with_dl = [r for r in reqs if r.deadline_met is not None]
            met = sum(1 for r in with_dl if r.deadline_met)
            e2e = [r.e2e_latency_ms for r in reqs]
            out[p.name] = {
                "submitted": self.class_submitted[p],
                "rejected": rej[p],
                "served": len(reqs),
                "slo_total": len(with_dl),
                "slo_met": met,
                "slo_attainment": (met / len(with_dl)
                                   if with_dl else None),
                "p50_e2e_ms": self._percentile(e2e, 50.0),
                "p99_e2e_ms": self._percentile(e2e, 99.0),
                "max_wait_rounds": max((r.wait_rounds for r in reqs),
                                       default=0),
            }
        return out

    def starvation_events(self) -> int:
        """Served requests that overstayed the composer's hard bound:
        ``wait_rounds > starvation_rounds * (depth_at_submit + 1 +
        edf_bypasses) * max_batch`` — every request ahead at submission
        pops within one head tenure (the composer force-includes any
        head older than ``starvation_rounds`` tenure *steps*), each step
        spans at most ``max_batch`` wave-rounds, and then the request's
        own tenure starts.  EDF reordering adds at most ``edf_bypasses``
        extra pops before a request, and ``_edf_index`` caps that count
        at ``starvation_rounds`` structurally (an exhausted request
        blocks further jumps).  Always 0 without a composer (FIFO serves
        every active tenant each round) and identical to the pre-EDF
        bound when no request was ever bypassed."""
        if self.composer is None:
            return 0
        bound = (self.composer.config.starvation_rounds * self.max_batch)
        return sum(1 for r in self.done.values()
                   if r.wait_rounds > bound * (r.depth_at_submit + 1
                                               + r.edf_bypasses))

    def report(self) -> Dict[str, Any]:
        """Aggregate serving stats from the analytic schedule model."""
        served = len(self.done)
        secs = self.busy_cycles / (self.soc.freq_mhz * 1e6)
        per_tenant: List[Dict[str, Any]] = []
        for i, g in enumerate(self.compiled.graphs):
            reqs = [r for r in self.done.values() if r.tenant == i]
            per_tenant.append({
                "model": g.name,
                "served": len(reqs),
                "mean_latency_ms": (sum(r.latency_ms for r in reqs)
                                    / len(reqs) if reqs else 0.0),
                "mean_wait_rounds": (sum(r.wait_rounds for r in reqs)
                                     / len(reqs) if reqs else 0.0),
            })
        stats = (self.compiled.store_stats()
                 if hasattr(self.compiled, "store_stats") else None)
        joint = (self.compiled.joint_stats()
                 if hasattr(self.compiled, "joint_stats") else None)
        with_dl = [r for r in self.done.values()
                   if r.deadline_met is not None]
        return {
            "served": served,
            "rejected": len(self.rejected),
            "rounds": self._round,
            "co_rounds": self.co_rounds,
            "subset_co_rounds": self.subset_co_rounds,
            "solo_rounds": self.solo_rounds,
            "fallback_rounds": self.fallback_rounds,
            "floor_rounds": self.floor_rounds,
            "batched_repeat_rounds": self.batched_repeat_rounds,
            "solo_dispatches": self.solo_dispatches,
            "plan_store": stats,
            "joint_cp": joint,
            "solver": (self.session.solver_stats()
                       if self.session is not None else None),
            "compile_latency": (self.session.compile_latency_stats()
                                if self.session is not None else None),
            "analysis": (self.session.analysis_stats()
                         if self.session is not None else None),
            "throughput_inf_per_s": served / secs if secs else 0.0,
            "speedup_vs_sequential": self.compiled.speedup,
            "retiled": self.compiled.retiled,
            "l2_evictions_per_co_round": self.compiled.plan.memory.evictions,
            "per_tenant": per_tenant,
            "per_class": self._per_class(),
            "slo_attainment": (sum(1 for r in with_dl if r.deadline_met)
                               / len(with_dl) if with_dl else None),
            "starvation_events": self.starvation_events(),
            "admission": (self.admission.stats()
                          if self.admission is not None else None),
            "composer": (self.composer.stats()
                         if self.composer is not None else None),
            "async_compiler": (self.compiler.stats()
                               if self.compiler is not None else None),
            "clock_s": self.clock_s,
        }
