"""Deployment-session front-end for the MATCHA compiler.

The pipeline (stage-1 tile-centric CP -> IR rewrite -> exact stage-2
arbitration) used to be wired through two monolithic free functions with
hardcoded trial lists (``core.api.compile_model`` / ``compile_multi``).
This module redesigns that front-end around a :class:`DeploymentSession`
— a long-lived compiler session over a fixed set of tenant models — the
shape HaX-CoNN and MATCH expose, and the one mixed multi-tenant traffic
at varying occupancy needs:

  * :class:`CompileRequest` — the typed input: graphs, SoC, patterns,
    mode, tile budgets, per-tenant L2 budgets, contention-iteration
    bound, and an optional explicit strategy list;
  * :class:`Objective` — the typed goal: makespan-primary with an
    eviction-count tie-break (near-equal makespans resolve toward the
    plan with less shared-L2 traffic), threaded through
    ``schedule_multi``;
  * :class:`CandidateStrategy` — a registry of named stage-1 candidate
    sources (tile-centric at several granularities, the all-or-nothing
    corner, HEFT, contention-priced re-runs, complementary selections
    from the compile-alone pools) that replaces the duplicated trial-
    list logic; one unified search core arbitrates every candidate
    under the exact stage-2 model;
  * :class:`PlanStore` — an occupancy-indexed plan cache keyed by
    ``frozenset`` of active tenants: requested subsets are pre-compiled,
    anything else is lazily compiled-and-cached on first miss, so
    ``plan_for(active)`` answers *partial* occupancy instead of
    returning ``None``.

Inside the session's multi-tenant loop, ``contention_hints`` ->
re-tile -> re-schedule iterates to a fixpoint (bounded by
``CompileRequest.max_hint_rounds``, default 3) instead of the previous
single round; each round's winner seeds the next round's hints.  The
fixpoint has two phases: the per-tenant *best-response*
strategies run first (the exact best-response trajectory, recorded as
``best_response_plan``), then the ``joint-cp`` strategy — ONE constraint
program over every tenant's tile variables
(:class:`repro.core.tiling.JointTilingProblem`: shared device loads, one
shared-L2 capacity constraint, DMA coupling) — continues from that
incumbent, so ``joint <= best-response <= baseline <= sequential`` holds by
construction.  ``plan_for`` misses re-decide tiling *per occupancy* (the
L2 re-split among just the active tenants, compile-alone tilings as warm
starts) with the compile-alone back-to-back concatenation as a hard
floor, and numerics stay bitwise via per-``(tenant, tiling)`` reference
schedules.

``core.api.compile_model`` / ``compile_multi`` remain as thin wrappers
over a session, so every existing caller keeps working.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import threading
import time
from collections import OrderedDict
from typing import (Callable, Dict, FrozenSet, Hashable, List, Mapping,
                    Optional, Sequence, Set, Tuple)

from repro_torch.core import cpsolver
from repro_torch.core.decompose import solve_decomposed
from repro_torch.core.ir import Graph
from repro_torch.core.patterns import Pattern
from repro_torch.core.rewrite import TiledGraph, rewrite
from repro_torch.core.shapes import (PlanKey, ShapeBucketSpec, StoreKey,
                               describe_key, key_distance, key_occupancy,
                               key_parts, key_sort, make_plan_key)
from repro_torch.core.schedule import (ExecutionPlan, MultiExecutionPlan,
                                 concat_plans, contention_hints,
                                 default_budgets, schedule, schedule_multi,
                                 validate_schedule)
from repro_torch.core.tiling import (Contention, JointTilingProblem,
                               TilingSolution, optimize_tiling,
                               solution_ws_bytes, tile_granularities)
from repro_torch.soc.device import SoC

MODES = ("tvm", "match", "matcha_nt", "matcha")

# modes whose stage 2 exploits asynchronous inter-device concurrency —
# the only ones contention-aware re-tiling applies to (the sequential
# tvm / match ablation baselines must not be re-tiled onto accelerators)
ASYNC_MODES = ("matcha", "matcha_nt")

# how the shared L2 is re-split among the active tenants of a plan:
# "equal" is the blind 1/n split, "proportional" weights each tenant by
# the linearized working set of its chosen tiling (DORY-style)
L2_SPLITS = ("equal", "proportional")

# whether the joint solve is also attempted *decomposed* (per-device-
# cluster subproblems reconciled by Benders-style cuts, see
# repro.core.decompose): "auto" decomposes only at or above
# ``decompose_min_tenants`` (small mixes gain nothing from splitting),
# "on" always attempts it, "off" never does
DECOMPOSE_MODES = ("auto", "on", "off")

# what the session does with static-analyzer diagnostics on each plan it
# is about to insert into the PlanStore: "strict" raises on any ERROR,
# "warn" records them (analysis_stats()) but ships the plan, "off" skips
# the analyzer entirely
ANALYSIS_MODES = ("strict", "warn", "off")


def proportional_budgets(l2_size: int, weights: Sequence[float],
                         min_frac: float = 0.125) -> List[int]:
    """Shared-L2 split proportional to per-tenant weights — the joint
    solve's linearized working sets (:func:`repro.core.tiling.
    solution_ws_bytes`), the DORY-style memory-splitting heuristic.

    Budgets are *soft* (``SharedL2Allocator`` lets a tenant exceed its
    slice when space is free), but ``static_params`` residency and the
    eviction order key off them, so every tenant keeps at least
    ``min_frac`` of its equal share — a near-zero-weight tenant must not
    be starved of resident weights.  Degenerate weights (all zero, or a
    floor that cannot fit) fall back to the equal split, which sums to
    *at most* ``l2_size``; every other path sums exactly to ``l2_size``.
    The sum NEVER exceeds ``l2_size`` — a one-byte overshoot here makes
    the joint CP's shared-L2 capacity constraint infeasible, so the
    invariant is enforced explicitly instead of trusting float division
    (``avail * w / total`` can round a ulp high before truncation, and
    a blind remainder line would then push the heaviest slice below its
    floor to compensate)."""
    n = len(weights)
    if n == 0:
        return []
    if n == 1:
        return [int(l2_size)]
    equal = int(l2_size) // n
    total = float(sum(max(w, 0.0) for w in weights))
    if total <= 0.0:
        return [equal] * n
    floor = max(int(equal * min_frac), 1)
    avail = int(l2_size) - n * floor
    if avail < 0:
        return [equal] * n
    budgets = [floor + int(avail * max(w, 0.0) / total) for w in weights]
    excess = sum(budgets) - int(l2_size)
    if excess > 0:
        # float-ulp overshoot: shave the largest slices, never below floor
        for i in sorted(range(n), key=lambda j: -budgets[j]):
            take = min(excess, budgets[i] - floor)
            budgets[i] -= take
            excess -= take
            if excess <= 0:
                break
    else:
        # integer-truncation remainder goes to the heaviest tenant
        k = max(range(n), key=lambda i: (weights[i], -i))
        budgets[k] -= excess
    return budgets


# ---------------------------------------------------------------------------
# Typed objective
# ---------------------------------------------------------------------------


OBJECTIVE_PRIMARIES = ("makespan",)

# tie-break key -> plan accessor; keys absent from a plan type score 0
# (``retile_rounds`` only exists on MultiExecutionPlan, stamped by the
# session's contention fixpoint)
TIE_BREAK_KEYS = {
    "evictions": lambda plan: float(plan.memory.evictions),
    "dma_bytes": lambda plan: float(sum(d.bytes for d in plan.dmas)),
    "retile_rounds": lambda plan: float(getattr(plan, "retile_rounds", 0)),
}
OBJECTIVE_TIE_BREAKS = (None,) + tuple(sorted(TIE_BREAK_KEYS))


@dataclasses.dataclass(frozen=True)
class Objective:
    """What the candidate search optimizes, as data instead of inlined
    comparisons.

    ``primary`` is minimized first; candidates whose primaries are within
    ``tolerance`` of each other are resolved by the ordered tie-break
    chain.  ``tie_breaks`` accepts any ordered tuple of keys from
    ``TIE_BREAK_KEYS`` (evictions, dma_bytes, retile_rounds), compared
    lexicographically; the legacy single-key ``tie_break`` remains as a
    convenience spelling for a one-element chain.  The default keeps the
    original behaviour: makespan-primary with an eviction-count tie-break, so
    among near-equal makespans the plan with less forced shared-L2 swap
    traffic wins."""
    primary: str = "makespan"
    tie_break: Optional[str] = "evictions"
    tie_breaks: Optional[Tuple[str, ...]] = None
    tolerance: float = 1e-9

    def __post_init__(self) -> None:
        if self.primary not in OBJECTIVE_PRIMARIES:
            raise ValueError(f"unknown primary objective {self.primary!r}; "
                             f"expected one of {OBJECTIVE_PRIMARIES}")
        if self.tie_break not in OBJECTIVE_TIE_BREAKS:
            raise ValueError(f"unknown tie-break {self.tie_break!r}; "
                             f"expected one of {OBJECTIVE_TIE_BREAKS}")
        if self.tie_breaks is not None:
            for key in self.tie_breaks:
                if key not in TIE_BREAK_KEYS:
                    raise ValueError(
                        f"unknown tie-break {key!r} in chain "
                        f"{self.tie_breaks}; expected keys from "
                        f"{sorted(TIE_BREAK_KEYS)}")
        if self.tolerance < 0.0:
            raise ValueError(f"tolerance must be >= 0: {self.tolerance}")

    @property
    def chain(self) -> Tuple[str, ...]:
        """The effective ordered tie-break chain."""
        if self.tie_breaks is not None:
            return tuple(self.tie_breaks)
        return () if self.tie_break is None else (self.tie_break,)

    def value(self, plan) -> Tuple[float, ...]:
        """(primary, *tie-break chain) score of an Execution/
        MultiExecutionPlan — lexicographically smaller is better."""
        return (plan.makespan,) + tuple(TIE_BREAK_KEYS[k](plan)
                                        for k in self.chain)

    def better(self, cand, incumbent) -> bool:
        """True when ``cand`` should replace ``incumbent``: strictly better
        on the primary (beyond ``tolerance``), or tied on the primary and
        strictly better somewhere down the tie-break chain."""
        if incumbent is None:
            return cand is not None
        if cand is None:
            return False
        cv, iv = self.value(cand), self.value(incumbent)
        if cv[0] < iv[0] - self.tolerance:
            return True
        if cv[0] > iv[0] + self.tolerance:
            return False
        return cv[1:] < iv[1:]


# ---------------------------------------------------------------------------
# Typed compile request
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompileRequest:
    """Everything a :class:`DeploymentSession` needs, as one typed value.

    ``budgets`` fixes the per-tenant shared-L2 split (default: equal split
    among however many tenants are active in a given plan); ``strategies``
    overrides the mode-derived candidate-strategy list by registry name;
    ``max_hint_rounds`` bounds the contention-hint fixpoint iteration.

    ``joint_time_budget_s`` caps each joint cross-tenant CP solve (the
    tentpole compile-latency bound: a solve that produces nothing within
    the budget makes the session fall back to per-tenant best-response
    re-tiling, so adding the joint stage never unbounds compile time);
    ``joint_tiling=False`` disables the joint stage entirely (the
    ``joint-cp`` strategy then contributes nothing).  The joint stage
    rides the contention re-tiling loop, so it also needs
    ``retile_for_contention=True`` (the default) — to ablate the joint CP
    *against* best-response, pass an explicit ``strategies`` list
    containing ``joint-cp``.

    ``lazy_joint_time_budget_s`` is the smaller joint budget used by
    :meth:`DeploymentSession.submit_compile` — the background (serving-
    time) subset compiles a :class:`~repro.serve.compiler_thread.
    BackgroundCompiler` runs on ``plan_for`` misses, where a long solve
    only delays how soon the engine can leave the compile-alone floor.
    An inverted pair (lazy budget above the foreground one) would
    silently make background compiles *more* expensive than foreground
    ones, so it is rejected — except when ``joint_time_budget_s <= 0``,
    the ablation sentinel for "joint budget already spent", under which
    every joint solve (foreground or lazy) is clamped to nothing and
    falls back to best-response.

    ``incremental`` (default on) warm-starts each ``plan_for`` miss at
    occupancy ``S`` from the Hamming-nearest cached occupancy's
    per-tenant tiling solutions (a non-evicting sidecar in the
    :class:`PlanStore`) instead of from scratch, under the smaller
    ``incremental_time_budget_s`` joint budget; ``l2_split`` picks how
    the shared L2 is re-split among a plan's active tenants — "equal"
    (the pre-incremental behaviour) or "proportional" to the chosen
    tilings' linearized working sets (both splits are arbitrated, so
    "proportional" never ships a worse plan than "equal" would have).

    ``analysis`` controls the static plan analyzer
    (:mod:`repro.analysis`) the session runs over every plan before it
    lands in the :class:`PlanStore`: ``"strict"`` (default) raises on
    any ERROR-severity diagnostic, ``"warn"`` records diagnostics in
    :meth:`DeploymentSession.analysis_stats` but still ships the plan,
    ``"off"`` skips the analyzer.

    ``decompose`` controls the decomposed joint solve
    (:mod:`repro.core.decompose` — per-device-cluster subproblems under
    split L2/DMA budgets, reconciled with Benders-style cuts from the
    stage-2 evaluation): ``"auto"`` (default) attempts it only for mixes
    of at least ``decompose_min_tenants`` tenants, ``"on"`` always,
    ``"off"`` never.  The decomposed solutions are arbitrated as one
    more candidate set alongside the monolithic joint solve — never a
    replacement — so enabling decomposition cannot ship a worse plan.
    ``decompose_cut_rounds`` bounds the reconciliation fixpoint, and
    ``decompose_max_cluster`` caps subproblem size (oversized device
    clusters are split into balanced sub-clusters, so per-subproblem CP
    search stays bounded as mixes grow to dozens of tenants).

    ``max_workers`` sizes the compile-side thread pools: the decomposed
    solve's concurrent per-cluster solves, and the
    :class:`~repro.serve.compiler_thread.BackgroundCompiler` worker pool
    when a serving engine constructs one from this request.

    ``shape_buckets`` maps tenant index -> :class:`~repro.core.shapes.
    ShapeBucketSpec` for tenants whose workload varies by sequence
    length (the autoregressive LM tenants).  The graph registered in
    ``graphs[i]`` must be the tenant's *default-bucket* graph (the spec's
    ``make_graph(spec.default)`` — the session trusts this identity and
    never rebuilds the default bucket); other buckets' graphs are built
    lazily on the first bucketed compile and cached.  Tenants absent
    from the mapping are fixed-shape and always key on the bare
    occupancy."""
    graphs: Sequence[Graph]
    soc: SoC
    patterns: Sequence[Pattern]
    mode: str = "matcha"
    requested_tiles: int = 16
    time_budget_s: float = 8.0
    budgets: Optional[Sequence[int]] = None
    retile_for_contention: bool = True
    max_hint_rounds: int = 3
    strategies: Optional[Sequence[str]] = None
    joint_tiling: bool = True
    joint_time_budget_s: float = 6.0
    lazy_joint_time_budget_s: float = 1.5
    incremental: bool = True
    incremental_time_budget_s: float = 1.5
    l2_split: str = "proportional"
    store_max_entries: int = 64
    analysis: str = "strict"
    decompose: str = "auto"
    decompose_min_tenants: int = 6
    decompose_cut_rounds: int = 2
    decompose_max_cluster: int = 4
    max_workers: int = 2
    shape_buckets: Optional[Mapping[int, ShapeBucketSpec]] = None

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; "
                             f"expected one of {MODES}")
        if not self.graphs:
            raise ValueError("CompileRequest needs at least one graph")
        if self.max_hint_rounds < 1:
            raise ValueError(f"max_hint_rounds must be >= 1: "
                             f"{self.max_hint_rounds}")
        if self.budgets is not None and len(self.budgets) != len(self.graphs):
            raise ValueError(f"budgets has {len(self.budgets)} entries for "
                             f"{len(self.graphs)} graphs")
        if self.store_max_entries < 1:
            raise ValueError(f"store_max_entries must be >= 1: "
                             f"{self.store_max_entries}")
        if self.lazy_joint_time_budget_s <= 0.0:
            raise ValueError(f"lazy_joint_time_budget_s must be > 0: "
                             f"{self.lazy_joint_time_budget_s}")
        if (self.joint_time_budget_s > 0.0
                and self.lazy_joint_time_budget_s > self.joint_time_budget_s):
            raise ValueError(
                f"lazy_joint_time_budget_s "
                f"({self.lazy_joint_time_budget_s}) exceeds "
                f"joint_time_budget_s ({self.joint_time_budget_s}): "
                f"background compiles would be more expensive than "
                f"foreground ones")
        if self.incremental_time_budget_s <= 0.0:
            raise ValueError(f"incremental_time_budget_s must be > 0: "
                             f"{self.incremental_time_budget_s}")
        if self.l2_split not in L2_SPLITS:
            raise ValueError(f"unknown l2_split {self.l2_split!r}; "
                             f"expected one of {L2_SPLITS}")
        if self.analysis not in ANALYSIS_MODES:
            raise ValueError(f"unknown analysis mode {self.analysis!r}; "
                             f"expected one of {ANALYSIS_MODES}")
        if self.decompose not in DECOMPOSE_MODES:
            raise ValueError(f"unknown decompose mode {self.decompose!r}; "
                             f"expected one of {DECOMPOSE_MODES}")
        if self.decompose_min_tenants < 2:
            raise ValueError(f"decompose_min_tenants must be >= 2: "
                             f"{self.decompose_min_tenants}")
        if self.decompose_cut_rounds < 0:
            raise ValueError(f"decompose_cut_rounds must be >= 0: "
                             f"{self.decompose_cut_rounds}")
        if self.decompose_max_cluster < 1:
            raise ValueError(f"decompose_max_cluster must be >= 1: "
                             f"{self.decompose_max_cluster}")
        if self.max_workers < 1:
            raise ValueError(f"max_workers must be >= 1: "
                             f"{self.max_workers}")
        if self.shape_buckets is not None:
            norm: Dict[int, ShapeBucketSpec] = {}
            for t, spec in self.shape_buckets.items():
                t = int(t)
                if t < 0 or t >= len(self.graphs):
                    raise ValueError(f"shape_buckets tenant {t} out of "
                                     f"range for {len(self.graphs)} graphs")
                if not isinstance(spec, ShapeBucketSpec):
                    raise ValueError(f"shape_buckets[{t}] is not a "
                                     f"ShapeBucketSpec: {spec!r}")
                norm[t] = spec
            self.shape_buckets = norm


# ---------------------------------------------------------------------------
# Candidate strategies (named, registered)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CandidateSpec:
    """One stage-1 trial: which optimizer variant, at which granularity,
    with or without host tile participation."""
    stage1: str                # matcha | matcha_nt | match | tvm | heft
    tiles: int
    host_tiles: bool = True

    @property
    def label(self) -> str:
        return (f"{self.stage1}@T{self.tiles}"
                + ("" if self.host_tiles else "!h"))


class CandidateStrategy:
    """A named source of stage-1 candidates for the unified search core.

    ``single_candidates`` contributes :class:`CandidateSpec` trials to a
    single-model compile; ``retile_sets`` contributes joint per-tenant
    tiling sets (each a ``List[TiledGraph]``) to one round of the
    multi-tenant contention loop via the deduplicating ``add`` callback.
    Strategies are stateless; everything they need rides on the session."""

    name = "base"
    retiles = False            # contributes to the contention re-tile loop

    def single_candidates(self, request: CompileRequest
                          ) -> List[CandidateSpec]:
        return []

    def retile_sets(self, session: "DeploymentSession",
                    hints: Sequence[Contention],
                    plan: MultiExecutionPlan,
                    add: Callable[[Sequence[TiledGraph]], bool]) -> None:
        pass


STRATEGY_REGISTRY: Dict[str, CandidateStrategy] = {}


def register_strategy(strategy: CandidateStrategy) -> CandidateStrategy:
    STRATEGY_REGISTRY[strategy.name] = strategy
    return strategy


def get_strategy(name: str) -> CandidateStrategy:
    try:
        return STRATEGY_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown candidate strategy {name!r}; registered: "
                       f"{sorted(STRATEGY_REGISTRY)}") from None


def default_strategy_names(mode: str,
                           retile_for_contention: bool = True) -> List[str]:
    """The mode-derived strategy list the old hardcoded trial lists encoded:
    tile-centric search only for full matcha, the all-or-nothing corner and
    HEFT for both asynchronous modes, a single sequential trial for the
    tvm / match ablation baselines.  The multi-tenant re-tiling strategies
    end with ``joint-cp`` / ``decomposed-cp`` — the joint cross-tenant CPs
    run *after* the best-response strategies so the session's two-phase
    fixpoint can report an exact best-response incumbent for the joint
    solves to beat."""
    if mode == "matcha":
        names = ["tile-centric", "all-or-nothing", "heft"]
    elif mode == "matcha_nt":
        names = ["all-or-nothing", "heft"]
    else:
        return ["sequential-baseline"]
    if retile_for_contention:
        names += ["contention-retile", "complementary", "joint-cp",
                  "decomposed-cp"]
    return names


class TileCentricStrategy(CandidateStrategy):
    """The paper's tile-centric CP at the granularity ladder from
    :func:`repro.core.tiling.tile_granularities`, with and without host
    tile participation at the full granularity (§3.1)."""

    name = "tile-centric"

    def single_candidates(self, request: CompileRequest
                          ) -> List[CandidateSpec]:
        if request.mode != "matcha":
            return []
        ladder = tile_granularities(request.requested_tiles)
        specs = [CandidateSpec("matcha", ladder[0], True),
                 CandidateSpec("matcha", ladder[0], False)]
        specs.extend(CandidateSpec("matcha", t, True) for t in ladder[1:])
        return specs


class AllOrNothingStrategy(CandidateStrategy):
    """The all-or-nothing (no-tiling) corner: layer-device assignment as a
    corner case of the tile-centric optimization, plus the strictly
    sequential match baseline as a feasibility backstop."""

    name = "all-or-nothing"

    def single_candidates(self, request: CompileRequest
                          ) -> List[CandidateSpec]:
        if request.mode not in ASYNC_MODES:
            return []
        return [CandidateSpec("matcha_nt", request.requested_tiles, True),
                CandidateSpec("match", request.requested_tiles, True)]


class HeftStrategy(CandidateStrategy):
    """HEFT list-scheduling seeds (with and without join fusion) — cheap
    candidates that occasionally beat the CP on join-free chains."""

    name = "heft"

    def single_candidates(self, request: CompileRequest
                          ) -> List[CandidateSpec]:
        if request.mode not in ASYNC_MODES:
            return []
        return [CandidateSpec("heft", request.requested_tiles, True),
                CandidateSpec("heft", request.requested_tiles, False)]


class SequentialBaselineStrategy(CandidateStrategy):
    """One trial in the request's own (sequential) mode — the tvm / match
    ablation baselines are a single stage-1 run, untiled for tvm."""

    name = "sequential-baseline"

    def single_candidates(self, request: CompileRequest
                          ) -> List[CandidateSpec]:
        if request.mode in ASYNC_MODES:
            return []
        tiles = request.requested_tiles if request.mode != "tvm" else 1
        return [CandidateSpec(request.mode, tiles, True)]


class ContentionRetileStrategy(CandidateStrategy):
    """Contention-priced stage-1 re-runs: each tenant re-tiled under its
    :class:`Contention` context (shrunk L2 slice, congested DMA, loaded
    devices), applied symmetrically (every tenant re-tiled, per stage-1
    variant including the all-or-nothing corner) and asymmetrically (one
    tenant re-tiled against the incumbent plan's tilings — simultaneous
    best-response moves all tenants off the same devices and helps
    nobody).  A tenant whose re-run fails keeps its incumbent tiling so
    every set stays schedulable."""

    name = "contention-retile"
    retiles = True

    def retile_sets(self, session, hints, plan, add) -> None:
        req = session.request
        base_tgs = list(plan.tenants)
        stage1 = req.mode
        variants = [stage1] + (["matcha_nt"] if stage1 != "matcha_nt"
                               else [])
        retiled: Dict[str, List[Optional[TiledGraph]]] = {}
        for m in variants:
            row: List[Optional[TiledGraph]] = []
            for i, g in enumerate(req.graphs):
                try:
                    sol = optimize_tiling(g, req.soc, req.patterns, mode=m,
                                          requested_tiles=req.requested_tiles,
                                          time_budget_s=req.time_budget_s,
                                          contention=hints[i])
                    row.append(rewrite(g, req.soc, sol))
                except Exception:
                    row.append(None)
            retiled[m] = row
            add([tg if tg is not None else base_tgs[i]
                 for i, tg in enumerate(row)])
        for i, tg in enumerate(retiled[stage1]):      # asymmetric moves
            if tg is not None:
                add([tg if j == i else base_tgs[j]
                     for j in range(len(base_tgs))])


class ComplementaryStrategy(CandidateStrategy):
    """Complementary selections: cross-products of each tenant's
    compile-alone candidate pool (``CompiledModel.alt_plans`` — runner-up
    tilings that lost alone can pair into a better mix), ranked by the
    per-device congestion proxy max_dev(sum_i busy_i[dev]) and capped at
    ``max_complementary`` new sets per round."""

    name = "complementary"
    retiles = True
    max_complementary = 3
    max_pool = 3               # distinct tilings kept per tenant
    max_tenants = 6            # cross-product guard

    def retile_sets(self, session, hints, plan, add) -> None:
        options: List[List[ExecutionPlan]] = []
        for cm in session.singles:
            uniq: List[ExecutionPlan] = []
            seen = set()
            for _, p in sorted(cm.alt_plans.items(),
                               key=lambda kv: kv[1].makespan):
                s = _tiling_sig(p.tiled)
                if s not in seen:
                    seen.add(s)
                    uniq.append(p)
            options.append(uniq[:self.max_pool])

        def congestion(plans) -> float:
            load: Dict[str, float] = {}
            for p in plans:
                for r, b in p.busy.items():
                    load[r] = load.get(r, 0.0) + b
            return max(load.values(), default=0.0)

        if all(options) and len(options) <= self.max_tenants:
            combos = sorted(itertools.product(*options), key=congestion)
            picked = 0
            for plans in combos:
                if picked >= self.max_complementary:
                    break
                if add([p.tiled for p in plans]):
                    picked += 1


class JointTilingStrategy(CandidateStrategy):
    """The tentpole: ONE constraint program over every tenant's tile
    variables (:class:`repro.core.tiling.JointTilingProblem` — per-device
    loads summed across tenants, one shared-L2 capacity constraint, DMA
    congestion coupled through a shared makespan term), warm-started from
    the incumbent plan's tilings and solved under the request's
    ``joint_time_budget_s``.  A solve that produces nothing within the
    budget falls back to per-tenant best-response re-tiling (delegated to
    ``contention-retile`` when that strategy is not already running), so
    enabling the joint stage never unbounds compile latency."""

    name = "joint-cp"
    retiles = True
    joint = True               # session runs this in the second fixpoint
    #                            phase, after the best-response incumbent

    def retile_sets(self, session, hints, plan, add) -> None:
        req = session.request
        if not req.joint_tiling or req.mode not in ASYNC_MODES:
            return
        tgs = session.joint_tilings(list(range(len(req.graphs))),
                                    warm=list(plan.tenants))
        if tgs is not None:
            add(tgs)
            return
        if not any(s.name == "contention-retile"
                   for s in session.strategies):
            # delegated fallback candidates must carry the *delegate's*
            # label — a best-response plan must not be attributed to the
            # joint solver in plan.origin
            get_strategy("contention-retile").retile_sets(
                session, hints, plan,
                lambda tgs: add(tgs, "contention-retile"))


class DecomposedTilingStrategy(CandidateStrategy):
    """The decomposed joint solve (:mod:`repro.core.decompose`):
    per-device-cluster subproblems under split L2/DMA budgets, solved
    concurrently and reconciled with Benders-style cuts generated from
    the exact stage-2 evaluation.  Contributes its combined tiling set
    as one more candidate *alongside* the monolithic ``joint-cp``
    solve — the session's arbitration keeps whichever evaluates better,
    so ``decomposed <= best-response`` holds by construction.  A
    degenerate decomposition (single device cluster, or no cluster
    solved) contributes nothing; the monolithic joint / best-response
    candidates already cover that case."""

    name = "decomposed-cp"
    retiles = True
    joint = True               # second fixpoint phase, like joint-cp

    def retile_sets(self, session, hints, plan, add) -> None:
        req = session.request
        if not req.joint_tiling or req.mode not in ASYNC_MODES:
            return
        tgs = session.decomposed_tilings(list(range(len(req.graphs))),
                                         warm=list(plan.tenants))
        if tgs is not None:
            add(tgs)


for _strategy in (TileCentricStrategy(), AllOrNothingStrategy(),
                  HeftStrategy(), SequentialBaselineStrategy(),
                  ContentionRetileStrategy(), ComplementaryStrategy(),
                  JointTilingStrategy(), DecomposedTilingStrategy()):
    register_strategy(_strategy)


# ---------------------------------------------------------------------------
# Compiled artifacts
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledModel:
    graph: Graph
    soc: SoC
    mode: str
    solution: TilingSolution
    tiled: TiledGraph
    plan: ExecutionPlan
    candidates: Dict[str, float]       # candidate label -> exact makespan
    # every feasible stage-1 candidate's exact stage-2 plan (including the
    # winner): runner-up tilings that lose compile-alone can still be the
    # co-optimal choice in a multi-tenant compile (complementary device
    # affinities), so the multi-tenant search re-examines them
    alt_plans: Dict[str, ExecutionPlan] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def makespan_cycles(self) -> float:
        return self.plan.makespan

    @property
    def runtime_ms(self) -> float:
        return self.soc.cycles_to_ms(self.plan.makespan)

    def flops_per_s(self) -> float:
        """FLOPS as reported in the paper's tables (2*MACs / runtime)."""
        secs = self.plan.makespan / (self.soc.freq_mhz * 1e6)
        return 2.0 * self.graph.total_macs() / secs if secs else 0.0

    def run(self, inputs, params):
        from repro_torch.core.runtime import execute_plan
        return execute_plan(self.plan, inputs, params)

    def emit(self, out_dir: str):
        from repro_torch.core.codegen import generate
        return generate(self.plan, self.soc, out_dir)


@dataclasses.dataclass
class MultiCompiledModel:
    """N independent models compiled into ONE co-schedule on one SoC.

    ``singles`` holds the per-model compilations (each model's best tiling
    and its compile-alone schedule — the sequential baseline); ``plan`` is
    the merged resource-constrained co-schedule, whose tilings may be the
    compile-alone ones or a contention-aware re-tiling (whichever gave the
    better objective); ``baseline_plan`` is the co-schedule restricted to
    the compile-alone tilings (the pre-re-tiling behaviour).  When built by
    a :class:`DeploymentSession` (the normal path), ``plan_for`` and
    ``tenant_plan`` route through the session's occupancy-indexed
    :class:`PlanStore`, so partial occupancy gets a real (cached) subset
    co-schedule instead of ``None``."""
    graphs: List[Graph]
    soc: SoC
    mode: str
    singles: List[CompiledModel]
    plan: MultiExecutionPlan
    baseline_plan: Optional[MultiExecutionPlan] = None
    session: Optional["DeploymentSession"] = \
        dataclasses.field(default=None, repr=False)
    _tenant_plans: Optional[List[Optional[ExecutionPlan]]] = \
        dataclasses.field(default=None, repr=False)

    @property
    def makespan_cycles(self) -> float:
        return self.plan.makespan

    @property
    def runtime_ms(self) -> float:
        return self.soc.cycles_to_ms(self.plan.makespan)

    @property
    def sequential_makespan_cycles(self) -> float:
        """Compile-each-model-alone, run back-to-back (the baseline)."""
        return sum(cm.plan.makespan for cm in self.singles)

    @property
    def baseline_makespan_cycles(self) -> float:
        """Co-scheduled makespan with the compile-alone tilings (the baseline
        behaviour, before contention-aware re-tiling)."""
        return (self.baseline_plan.makespan if self.baseline_plan is not None
                else self.plan.makespan)

    @property
    def best_response_makespan_cycles(self) -> float:
        """Makespan after per-tenant best-response re-tiling only (the
        best-response behaviour — phase A of the session's fixpoint, before the
        joint cross-tenant solve).  By construction
        ``plan.makespan <= best_response <= baseline <= sequential``."""
        if self.session is not None and \
                self.session.best_response_plan is not None:
            return self.session.best_response_plan.makespan
        return self.plan.makespan

    def reference_plan(self, i: int, tg=None) -> ExecutionPlan:
        """Reference schedule for tenant ``i`` over ``tg`` (default: the
        full-house tiling) — see :meth:`DeploymentSession.reference_plan`."""
        if tg is None or tg is self.plan.tenants[i]:
            return self.tenant_plan(i)
        if self.session is not None:
            return self.session.reference_plan(i, tg)
        raise ValueError("session-less artifact has no per-occupancy "
                         "reference plans")

    def joint_stats(self) -> Optional[Dict[str, int]]:
        """Joint cross-tenant solver counters (``None`` for session-less
        artifacts): successful solves and best-response fallbacks."""
        if self.session is None:
            return None
        return {"solves": self.session.joint_solves,
                "fallbacks": self.session.joint_fallbacks}

    @property
    def retiled(self) -> bool:
        """True when the winning co-schedule uses re-tiled graphs."""
        return any(tg is not cm.tiled
                   for tg, cm in zip(self.plan.tenants, self.singles))

    @property
    def speedup(self) -> float:
        return (self.sequential_makespan_cycles / self.plan.makespan
                if self.plan.makespan else 1.0)

    def tenant_latency_ms(self, i: int) -> float:
        """Completion time of tenant ``i`` inside the co-schedule."""
        return self.soc.cycles_to_ms(self.plan.tenant_makespans[i])

    def tenant_plan(self, i: int) -> ExecutionPlan:
        """Single-model schedule over the SAME tiled graph tenant ``i``
        uses inside the co-schedule — the bitwise numeric reference for the
        interleaved execution.  Equals ``singles[i].plan`` unless that
        tenant was re-tiled; re-tiled schedules are built once and cached
        in the session's :class:`PlanStore` (repeated engine rounds reuse
        the cached schedule instead of re-deriving it)."""
        if self.plan.tenants[i] is self.singles[i].tiled:
            return self.singles[i].plan
        if self.session is not None:
            return self.session.tenant_plan(i)
        # legacy path for hand-built artifacts without a session
        if self._tenant_plans is None:
            self._tenant_plans = [None] * len(self.graphs)
        if self._tenant_plans[i] is None:
            self._tenant_plans[i] = schedule(self.plan.tenants[i], self.soc,
                                             self.mode, restarts=1,
                                             anneal_iters=0)
        return self._tenant_plans[i]

    def plan_for(self, active: Sequence[int],
                 shapes=None) -> Optional[MultiExecutionPlan]:
        """Co-schedule covering exactly the ``active`` tenants (at the
        optional per-tenant sequence ``shapes`` — tenant -> bucket).

        Routed through the session's occupancy-indexed :class:`PlanStore`:
        pre-compiled subsets hit the cache, anything else is compiled
        lazily and cached, so *every* non-empty occupancy gets a validated
        co-schedule.  Tenant indices inside the returned plan are
        positional over ``sorted(set(active))``.  Returns ``None`` only on
        a session-less artifact asked for a partial occupancy (the legacy
        behaviour)."""
        ids = sorted({int(a) for a in active})
        if not shapes and ids == list(range(len(self.graphs))):
            return self.plan
        if self.session is None:
            return None
        return self.session.plan_for(ids, shapes=shapes)

    def try_plan_for(self, active: Sequence[int], touch: bool = False,
                     shapes=None) -> Optional[MultiExecutionPlan]:
        """Non-blocking occupancy lookup: the cached plan or ``None`` —
        never compiles (delegates to
        :meth:`DeploymentSession.try_plan_for`, including the ``touch``
        accounting and the optional ``shapes`` buckets).  On a
        session-less artifact only the full house answers."""
        ids = sorted({int(a) for a in active})
        if not shapes and ids == list(range(len(self.graphs))):
            return self.plan
        if self.session is None:
            return None
        return self.session.try_plan_for(ids, touch=touch, shapes=shapes)

    def store_stats(self) -> Optional[Dict[str, int]]:
        """Hit/miss/compile counters of the session's plan store (``None``
        for session-less artifacts)."""
        return (self.session.store.stats()
                if self.session is not None else None)

    def run(self, inputs_list, params_list):
        from repro_torch.core.runtime import execute_multi_plan
        return execute_multi_plan(self.plan, inputs_list, params_list)


def _tiling_sig(tg: TiledGraph) -> tuple:
    return tuple(sorted((s.device, s.op_names, s.tile_lo, s.tile_hi)
                        for s in tg.supernodes))


def _sets_sig(tgs: Sequence[TiledGraph]) -> tuple:
    return tuple(_tiling_sig(tg) for tg in tgs)


# ---------------------------------------------------------------------------
# Occupancy-indexed plan store
# ---------------------------------------------------------------------------


class PlanStore:
    """Cache of compiled schedules keyed by occupancy, LRU-bounded.

    Co-schedules are keyed by a :data:`~repro.core.shapes.StoreKey` — a
    ``frozenset`` of active tenant indices for fixed-shape occupancies
    (every tenant at its default bucket), or a
    :class:`~repro.core.shapes.PlanKey` point on the (occupancy x
    bucket-vector) product lattice when any tenant runs at a non-default
    sequence bucket.  The two never collide (``make_plan_key``
    canonicalizes the all-default case to the bare ``frozenset``), so
    fixed-shape sessions see bitwise the pre-shape store.  Plain
    iterables of tenant indices are accepted everywhere a key is and
    normalize to the bare ``frozenset``.

    Single-tenant reference schedules (the bitwise numeric references for
    re-tiled / per-occupancy tenants) are keyed by tenant index or by a
    ``(tenant, tiling-signature)`` /  ``(tenant, bucket,
    tiling-signature)`` tuple.  ``hits`` / ``misses`` /
    ``compiles`` count lookups and lazy compilations across both maps —
    a miss that compiles increments both ``misses`` and ``compiles``, so
    the cache contract "miss compiles once, then hits" is assertable.

    The co-schedule map grows ``2^N - 1`` occupancies worst-case, so it is
    bounded by ``max_entries`` (generous default): when full, the least-
    recently-``co_plan``'d occupancy is dropped (an evicted occupancy
    recompiles on its next miss).  Protected occupancies — the full house,
    registered via :meth:`protect` — and the tenant reference schedules
    (the numerics contract) are never evicted.  ``evictions`` in
    :meth:`stats` counts the drops; ``re_misses`` counts the drops that
    later *forced a re-compile* of the same occupancy (cache thrash —
    counted once per eviction, at the first subsequent miss of the
    evicted key).

    Alongside the bounded plan map, a small non-evicting *solutions
    sidecar* (:meth:`seed_solutions`) records each landed plan's
    per-tenant :class:`~repro.core.tiling.TilingSolution`\\ s — a few
    integers per tenant, not a schedule — so LRU eviction of a plan never
    destroys the warm-start source for the session's incremental
    re-solves (:meth:`nearest_solutions`).

    The store is thread-safe: every map access holds an internal RLock,
    and the builder callbacks of :meth:`co_plan` / :meth:`tenant_plan` run
    *outside* it, so a serving thread's non-blocking :meth:`peek` never
    waits behind a background subset compile.  (Exactly-once compilation
    for concurrent misses of the same occupancy is the session's job —
    :meth:`DeploymentSession.submit_compile` — not the store's; two
    concurrent *blocking* ``co_plan`` misses may both build, with the
    first landed plan winning so cached-identity contracts hold.)"""

    def __init__(self, max_entries: int = 64) -> None:
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1: {max_entries}")
        self._co: "OrderedDict[StoreKey, MultiExecutionPlan]" = \
            OrderedDict()
        self._tenant: Dict[Hashable, ExecutionPlan] = {}
        self._protected: Set[StoreKey] = set()
        # non-evicting warm-start sidecar: store key -> {tenant -> solution}
        self._solutions: Dict[StoreKey, Dict[int, TilingSolution]] = {}
        self._evicted: Set[StoreKey] = set()         # awaiting re-miss count
        self._lock = threading.RLock()
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.compiles = 0
        self.lru_evictions = 0
        self.re_misses = 0

    @staticmethod
    def _norm(active) -> StoreKey:
        """Normalize a key argument: :class:`PlanKey` passes through, any
        plain iterable of tenant indices becomes the bare frozenset."""
        if isinstance(active, PlanKey):
            return active
        return frozenset(int(a) for a in active)

    def __len__(self) -> int:
        with self._lock:
            return len(self._co) + len(self._tenant)

    def __contains__(self, key) -> bool:
        """ints and tuples query the tenant-reference map (tuples are the
        ``(tenant, [bucket,] tiling-signature)`` keys); query occupancies
        with a list / set / frozenset / PlanKey, never a tuple."""
        with self._lock:
            if isinstance(key, (int, tuple)):
                return key in self._tenant
            return self._norm(key) in self._co

    def has_tenant(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._tenant

    def occupancies(self) -> List[FrozenSet[int]]:
        """Cached *fixed-shape* co-schedule occupancies (bare frozensets),
        smallest first.  Bucketed :class:`PlanKey` entries are excluded —
        callers (the round composer's cached-occupancy bonus) do set
        algebra on these; the full key list is :meth:`keys`."""
        with self._lock:
            return sorted((k for k in self._co if not isinstance(k, PlanKey)),
                          key=lambda s: (len(s), sorted(s)))

    def keys(self) -> List[StoreKey]:
        """Every cached co-schedule key — bare occupancies and bucketed
        lattice points — in deterministic order."""
        with self._lock:
            return sorted(self._co, key=key_sort)

    def protect(self, active) -> None:
        """Exempt a key from LRU eviction (the full house)."""
        with self._lock:
            self._protected.add(self._norm(active))

    def peek(self, active, touch: bool = False
             ) -> Optional[MultiExecutionPlan]:
        """Non-compiling occupancy lookup: the cached co-schedule or
        ``None``.  By default a *pure read* — no counters, no LRU
        recency — so speculative probes (the round composer scores many
        candidate occupancies per round) neither corrupt the hit/miss
        stats nor let candidate enumeration evict dispatch-hot plans.
        The serving engine's actual dispatch probe passes ``touch=True``
        to count the lookup and refresh recency like ``co_plan`` does."""
        key = self._norm(active)
        with self._lock:
            plan = self._co.get(key)
            if touch:
                if plan is not None:
                    self.hits += 1
                    self._co.move_to_end(key)
                else:
                    self.misses += 1
                    self._note_re_miss(key)
            return plan

    def _note_re_miss(self, key: StoreKey) -> None:
        """Count (once) a miss of an occupancy a prior eviction dropped —
        the eviction demonstrably forced a re-compile.  Caller holds the
        lock."""
        if key in self._evicted:
            self._evicted.discard(key)
            self.re_misses += 1

    def _evict_lru(self, keep: Optional[StoreKey] = None) -> None:
        """Drop LRU occupancies down to the bound; never drops protected
        occupancies or ``keep`` (the entry being inserted — evicting it
        would break 'miss compiles once, then hits'), so the bound can be
        exceeded by the protected set.  Caller holds the lock."""
        while len(self._co) > self.max_entries:
            victim = next((k for k in self._co
                           if k not in self._protected and k != keep), None)
            if victim is None:
                return                       # everything left is exempt
            del self._co[victim]
            self.lru_evictions += 1
            self._evicted.add(victim)        # re-miss = thrash (see stats)

    def seed(self, active, plan: MultiExecutionPlan) -> bool:
        """Register an already-compiled co-schedule (no counter changes).
        First landed plan wins, like ``co_plan``: if a concurrent
        blocking compile already cached this occupancy, callers holding
        that object must keep seeing it (the engine compares plans by
        identity), so the late arrival is dropped.  Returns whether
        ``plan`` was actually inserted."""
        key = self._norm(active)
        with self._lock:
            inserted = key not in self._co
            if inserted:
                self._co[key] = plan
            self._co.move_to_end(key)
            self._evicted.discard(key)     # at most one re-miss per eviction
            self._evict_lru(keep=key)
            return inserted

    def seed_tenant(self, tenant: Hashable, plan: ExecutionPlan) -> None:
        """Register an already-compiled tenant reference schedule (no
        counter changes — reuse of an existing plan is not a compile)."""
        with self._lock:
            self._tenant[tenant] = plan

    def co_plan(self, active,
                build: Callable[[], MultiExecutionPlan]
                ) -> MultiExecutionPlan:
        key = self._norm(active)
        with self._lock:
            if key in self._co:
                self.hits += 1
                self._co.move_to_end(key)
                return self._co[key]
            self.misses += 1
            self._note_re_miss(key)
        plan = build()                     # outside the lock: see class doc
        with self._lock:
            self.compiles += 1
            if key not in self._co:        # first landed plan wins
                self._co[key] = plan
            self._co.move_to_end(key)
            self._evicted.discard(key)
            self._evict_lru(keep=key)
            return self._co[key]

    def tenant_plan(self, tenant: Hashable,
                    build: Callable[[], ExecutionPlan]) -> ExecutionPlan:
        with self._lock:
            if tenant in self._tenant:
                self.hits += 1
                return self._tenant[tenant]
            self.misses += 1
        plan = build()
        with self._lock:
            self.compiles += 1
            if tenant not in self._tenant:
                self._tenant[tenant] = plan
            return self._tenant[tenant]

    # -- warm-start solutions sidecar ---------------------------------------

    def seed_solutions(self, active,
                       solutions: Dict[int, TilingSolution]) -> None:
        """Record the per-tenant tiling solutions a landed plan chose, in
        the non-evicting sidecar (latest landed plan wins — the sidecar
        mirrors whatever currently answers ``peek`` for this key, or last
        did before an eviction)."""
        with self._lock:
            self._solutions[self._norm(active)] = dict(solutions)

    def solutions(self, active) -> Optional[Dict[int, TilingSolution]]:
        """The recorded per-tenant solutions for exactly this key,
        or ``None`` — survives LRU eviction of the plan itself."""
        with self._lock:
            got = self._solutions.get(self._norm(active))
            return dict(got) if got is not None else None

    def solution_occupancies(self) -> List[StoreKey]:
        """Store keys with recorded sidecar solutions — bare occupancies
        and bucketed lattice points — the warm-start export surface: the
        fleet rebalancer reads these to migrate a drained SoC's tiling
        solutions into the destination SoC's session (remapped to the
        destination's tenant indices via
        :func:`~repro.core.shapes.remap_key`), so post-migration subset
        compiles warm-start instead of solving from scratch."""
        with self._lock:
            return list(self._solutions.keys())

    def nearest_solutions(self, active
                          ) -> Optional[Tuple[StoreKey,
                                              Dict[int, TilingSolution]]]:
        """``(key, {tenant -> solution})`` of the product-lattice-nearest
        recorded key comparable to ``active`` — one whose occupancy is a
        superset or subset (an unrelated occupancy's solutions reflect
        contention from tenants that are not here and tell us nothing
        about the missing ones).  Distance is
        :func:`~repro.core.shapes.key_distance`: occupancy Hamming plus
        one per shared tenant at a different bucket, so the key itself
        counts at distance 0 — an evicted plan's own solutions are the
        best possible warm start for its re-compile.  Occupancy
        supersets win distance ties (they tiled every member under at
        least this much contention); ``None`` when nothing comparable is
        recorded.  Callers warm-starting a *bucketed* compile must check
        each returned tenant's bucket against the neighbor key — a
        solution tiled at another sequence bucket is not a valid tiling
        for this one (the session substitutes that tenant's
        bucket-alone solution)."""
        key = self._norm(active)
        occ = key_occupancy(key)
        best: Optional[tuple] = None
        with self._lock:
            for cand, sols in self._solutions.items():
                cocc = key_occupancy(cand)
                if not (cocc >= occ or cocc <= occ):
                    continue
                rank = (key_distance(cand, key),
                        0 if cocc >= occ else 1, key_sort(cand))
                if best is None or rank < best[0]:
                    best = (rank, cand, sols)
            if best is None:
                return None
            return best[1], dict(best[2])

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "compiles": self.compiles, "co_plans": len(self._co),
                    "tenant_plans": len(self._tenant),
                    "evictions": self.lru_evictions,
                    "re_misses": self.re_misses,
                    "solution_seeds": len(self._solutions),
                    "max_entries": self.max_entries}


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------


class DeploymentSession:
    """A reusable compiler session over one :class:`CompileRequest`.

    The session owns the per-model compilations (``singles``), the unified
    candidate search (one loop over the registered
    :class:`CandidateStrategy` entries, arbitrated by the exact stage-2
    model under the typed :class:`Objective`), the bounded
    contention-hint fixpoint iteration, and the occupancy-indexed
    :class:`PlanStore` answering ``plan_for`` at any occupancy."""

    def __init__(self, request: CompileRequest,
                 objective: Optional[Objective] = None) -> None:
        self.request = request
        self.objective = objective if objective is not None else Objective()
        names = (list(request.strategies) if request.strategies is not None
                 else default_strategy_names(request.mode,
                                             request.retile_for_contention))
        self.strategies: List[CandidateStrategy] = \
            [get_strategy(n) for n in names]
        self.store = PlanStore(max_entries=request.store_max_entries)
        self.hint_rounds = 0           # contention fixpoint rounds executed
        self.joint_solves = 0          # successful joint cross-tenant solves
        self.joint_fallbacks = 0       # joint solves that fell back to
        #                                best-response (budget exhausted)
        self.lazy_compiles = 0         # background submit_compile landings
        self.decomposed_solves = 0     # successful decomposed joint solves
        self.decomposed_fallbacks = 0  # degenerate clustering / no cluster
        #                                solution (monolithic path engages)
        self.decomposed_cuts = 0       # Benders-style cuts applied
        self.decomposed_stats: Optional[Dict[str, object]] = None
        # aggregated CP-solver telemetry: every stage-1 solve's (nodes,
        # wall_s, budget_exhausted, incumbent_source), tallied by context
        # ("single" / "joint" / "decomposed") — solver_stats()
        self._solver: Dict[str, object] = {
            "solves": 0, "nodes": 0, "wall_s": 0.0, "budget_exhausted": 0,
            "incumbent_source": {}, "by_context": {}}
        self.incremental_hits = 0      # misses warm-started from a neighbor
        self.prop_split_wins = 0       # proportional L2 split won arbitration
        self.equal_split_wins = 0      # ... or the equal split held
        self.fullhouse_split: Optional[Dict[str, object]] = None
        self.miss_events: List[Dict[str, object]] = []   # per-miss telemetry
        # static plan-analyzer bookkeeping (see _analyze): every plan is
        # analyzed before PlanStore insertion, diagnostics tallied here
        self.plans_analyzed = 0
        self.analysis_error_count = 0
        self.analysis_warning_count = 0
        self.analysis_by_rule: Dict[str, int] = {}
        self.analysis_findings: List[str] = []           # retained messages
        self.max_analysis_findings = 32
        self._lock = threading.RLock()
        self._inflight: Set[StoreKey] = set()      # submit_compile dedupe
        # lazily-built non-default-bucket artifacts: (tenant, bucket) ->
        # graph / compile-alone artifact (first-wins under _lock)
        self._bucket_graphs: Dict[Tuple[int, int], Graph] = {}
        self._bucket_singles: Dict[Tuple[int, int], CompiledModel] = {}
        # the exact best-response incumbent (phase A of the fixpoint): what
        # best-response alone would have shipped — the bound the joint CP must beat
        self.best_response_plan: Optional[MultiExecutionPlan] = None
        self._singles: Optional[List[CompiledModel]] = None
        self._multi: Optional[MultiCompiledModel] = None

    # -- unified single-model candidate search ------------------------------

    @property
    def singles(self) -> List[CompiledModel]:
        if self._singles is None:
            self._singles = [self._compile_one(g)
                             for g in self.request.graphs]
        return self._singles

    def compile_single(self, index: int = 0) -> CompiledModel:
        """Compile-alone artifact for graph ``index`` (what the
        ``compile_model`` wrapper returns)."""
        return self.singles[index]

    def _single_specs(self) -> List[CandidateSpec]:
        specs: List[CandidateSpec] = []
        for strat in self.strategies:
            specs.extend(strat.single_candidates(self.request))
        return specs

    def _build_candidate(self, g: Graph, spec: CandidateSpec
                         ) -> Optional[tuple]:
        req = self.request
        tiles = max(spec.tiles, 1)
        if spec.stage1 == "heft":
            from repro_torch.core.heft import heft_solution
            try:
                sol = heft_solution(g, req.soc, req.patterns,
                                    requested_tiles=tiles,
                                    fuse_joins=spec.host_tiles)
                tg = rewrite(g, req.soc, sol)
                plan = schedule(tg, req.soc, "matcha_nt")
            except Exception:
                return None
        else:
            try:
                sol = optimize_tiling(g, req.soc, req.patterns,
                                      mode=spec.stage1,
                                      requested_tiles=tiles,
                                      time_budget_s=req.time_budget_s,
                                      host_tiles=spec.host_tiles)
                self._note_solve("single", sol)
                tg = rewrite(g, req.soc, sol)
                plan = schedule(tg, req.soc, spec.stage1)
            except Exception:
                return None
        if validate_schedule(plan):
            return None
        return sol, tg, plan

    def _compile_one(self, g: Graph) -> CompiledModel:
        req = self.request
        g.validate()
        candidates: Dict[str, float] = {}
        alt_plans: Dict[str, ExecutionPlan] = {}
        best: Optional[tuple] = None
        for spec in self._single_specs():
            got = self._build_candidate(g, spec)
            if got is None:
                continue
            sol, tg, plan = got
            candidates[spec.label] = plan.makespan
            alt_plans[spec.label] = plan
            if best is None or plan.makespan < best[2].makespan:
                best = (sol, tg, plan)
        if best is None:
            raise RuntimeError(f"compilation produced no feasible plan "
                               f"(mode={req.mode})")
        sol, tg, plan = best
        # the winner is registered in alt_plans under its candidate label;
        # relabelling the returned plan with the *requested* mode must not
        # drift the stored candidate, so label a shallow copy instead of
        # mutating the shared object
        plan = dataclasses.replace(plan, mode=req.mode)
        return CompiledModel(graph=g, soc=req.soc, mode=req.mode,
                             solution=sol, tiled=tg, plan=plan,
                             candidates=candidates, alt_plans=alt_plans)

    # -- multi-tenant compile with bounded contention fixpoint --------------

    def compile(self, precompile: Optional[Sequence[Sequence[int]]] = None
                ) -> MultiCompiledModel:
        """Compile the full house; idempotent (the artifact is cached).

        ``precompile`` optionally lists occupancy subsets to co-schedule
        eagerly into the :class:`PlanStore` (anything else is compiled
        lazily on the first ``plan_for`` miss)."""
        if self._multi is None:
            self._multi = self._compile_multi()
        if precompile:
            self.precompile(precompile)
        return self._multi

    # -- static plan analysis ----------------------------------------------

    def _analyze(self, plan, context: str):
        """Run the static plan analyzer (:mod:`repro.analysis`) over
        ``plan`` and tally the diagnostics.  In ``"strict"`` analysis
        mode any ERROR-severity diagnostic raises ``RuntimeError`` with
        the given ``context`` prefix (so nothing hazardous reaches the
        PlanStore); in ``"warn"`` mode diagnostics are only recorded; in
        ``"off"`` mode the analyzer is skipped.  Returns ``plan`` so
        call sites can wrap plan-producing expressions."""
        mode = self.request.analysis
        if mode == "off":
            return plan
        from repro_torch.analysis import Severity, analyze
        diags = analyze(plan)
        errors = [d for d in diags if d.severity >= Severity.ERROR]
        with self._lock:
            self.plans_analyzed += 1
            self.analysis_error_count += len(errors)
            self.analysis_warning_count += len(diags) - len(errors)
            for d in diags:
                self.analysis_by_rule[d.rule] = \
                    self.analysis_by_rule.get(d.rule, 0) + 1
                if len(self.analysis_findings) < self.max_analysis_findings:
                    self.analysis_findings.append(f"{context}: {d}")
        if errors and mode == "strict":
            raise RuntimeError(
                f"{context}: {[str(d) for d in errors[:5]]}")
        return plan

    def analysis_stats(self) -> Dict[str, object]:
        """Snapshot of the static plan-analyzer tallies this session:
        analysis mode, plans analyzed, error/warning diagnostic counts,
        per-rule counts, and the retained finding messages."""
        with self._lock:
            return {"mode": self.request.analysis,
                    "plans_analyzed": self.plans_analyzed,
                    "errors": self.analysis_error_count,
                    "warnings": self.analysis_warning_count,
                    "by_rule": dict(self.analysis_by_rule),
                    "findings": list(self.analysis_findings)}

    def _compile_multi(self) -> MultiCompiledModel:
        req = self.request
        singles = self.singles
        base_tgs = [cm.tiled for cm in singles]
        single_plans = [cm.plan for cm in singles]
        baseline = schedule_multi(base_tgs, req.soc, budgets=req.budgets,
                                  singles=single_plans,
                                  objective=self.objective)
        plan = baseline
        retilers = [s for s in self.strategies if s.retiles]
        if (req.retile_for_contention and len(req.graphs) > 1
                and req.mode in ASYNC_MODES and retilers):
            plan = self._contention_fixpoint(baseline, base_tgs, retilers)
        plan = self._l2_split_refine(plan)
        self._analyze(plan, "infeasible co-schedule")
        mc = MultiCompiledModel(graphs=list(req.graphs), soc=req.soc,
                                mode=req.mode, singles=singles, plan=plan,
                                baseline_plan=baseline, session=self)
        self.store.seed(range(len(req.graphs)), plan)
        self.store.protect(range(len(req.graphs)))
        self._record_solutions(list(range(len(req.graphs))), plan)
        return mc

    def _contention_fixpoint(self, baseline: MultiExecutionPlan,
                             base_tgs: List[TiledGraph],
                             retilers: Sequence[CandidateStrategy]
                             ) -> MultiExecutionPlan:
        """Two-phase hints -> re-tile -> re-schedule fixpoint.

        Phase A runs the per-tenant *best-response* strategies alone
        (exactly the best-response loop) and records its final incumbent as
        ``best_response_plan``.  Phase B continues from that incumbent
        with the joint cross-tenant strategies added (the best-response
        strategies keep running too, reacting to joint winners).  Because
        the incumbent is only ever replaced on strict objective
        improvement, the final plan satisfies, by construction,

            joint-CP  <=  best-response  <=  baseline  <=  sequential

        — and phase A's trajectory is bitwise the trajectory of a session
        configured without ``joint-cp``, so 'best-response' here means the
        real thing, not a degraded re-run."""
        req = self.request
        br = [s for s in retilers if not getattr(s, "joint", False)]
        joint = [s for s in retilers if getattr(s, "joint", False)]
        seen = {_sets_sig(base_tgs)}
        plan = self._fixpoint_rounds(baseline, base_tgs, br, seen)
        self.best_response_plan = plan
        if joint:
            # phase B opens with the joint strategies alone — phase A just
            # converged the best-response strategies on these exact hints,
            # so re-running them here would only recompute already-seen
            # candidate sets.  They re-enter for the remaining rounds only
            # when the joint solve actually moved the incumbent (fresh
            # hints to respond to).
            improved = self._fixpoint_rounds(plan, base_tgs, joint, seen,
                                             rounds=1)
            if improved is not plan and req.max_hint_rounds > 1:
                improved = self._fixpoint_rounds(
                    improved, base_tgs, list(retilers), seen,
                    rounds=req.max_hint_rounds - 1)
            plan = improved
        # determinism guard, under the same objective semantics the search
        # used (a tolerance-free makespan comparison here could revert a
        # winner the objective picked on the eviction tie-break)
        if self.objective.better(baseline, plan):
            plan = baseline
        return plan

    def _fixpoint_rounds(self, plan: MultiExecutionPlan,
                         base_tgs: List[TiledGraph],
                         retilers: Sequence[CandidateStrategy],
                         seen: set,
                         rounds: Optional[int] = None
                         ) -> MultiExecutionPlan:
        """Up to ``rounds`` (default ``max_hint_rounds``) rounds of the
        contention loop with the given strategies: summarize the incumbent
        into per-tenant :class:`Contention` hints, collect fresh candidate
        tiling sets (deduplicated against every earlier round via
        ``seen``, labelled by contributing strategy for ``plan.origin``
        attribution), and re-arbitrate under the exact shared-resource
        model."""
        req = self.request
        for _ in range(rounds if rounds is not None
                       else req.max_hint_rounds):
            hints = contention_hints(plan, req.soc)
            alt_sets: List[List[TiledGraph]] = []
            labels: List[str] = []
            current = [""]

            def add(tgs: Sequence[TiledGraph],
                    label: Optional[str] = None) -> bool:
                sig = _sets_sig(tgs)
                if sig in seen:
                    return False
                seen.add(sig)
                alt_sets.append(list(tgs))
                labels.append(label if label is not None else current[0])
                return True

            for strat in retilers:
                current[0] = strat.name
                strat.retile_sets(self, hints, plan, add)
            if not alt_sets:
                break                   # nothing new to try: fixpoint
            self.hint_rounds += 1
            new_plan = schedule_multi(base_tgs, req.soc, budgets=req.budgets,
                                      alt_tgs=alt_sets, incumbent=plan,
                                      objective=self.objective,
                                      alt_labels=labels,
                                      retile_round=self.hint_rounds)
            if new_plan is plan:
                break                   # no candidate beat the incumbent
            plan = new_plan
        return plan

    def _l2_split_refine(self, plan: MultiExecutionPlan
                         ) -> MultiExecutionPlan:
        """Post-fixpoint proportional re-split of the full house: the
        winning tiling set is re-arbitrated under budgets proportional to
        each tenant's linearized working set, and the better of the two
        plans ships — so enabling the proportional split can never
        regress the equal-split result.  Records the comparison in
        ``fullhouse_split`` and the win counters."""
        req = self.request
        if (req.l2_split != "proportional" or req.budgets is not None
                or len(req.graphs) < 2 or req.mode not in ASYNC_MODES):
            return plan
        sols = [getattr(tg, "solution", None) for tg in plan.tenants]
        if any(s is None for s in sols):
            return plan
        ws = [solution_ws_bytes(g, s) for g, s in zip(req.graphs, sols)]
        prop = proportional_budgets(req.soc.l2.size, ws)
        if prop == default_budgets(req.soc, len(req.graphs)):
            return plan
        cand = schedule_multi(list(plan.tenants), req.soc, budgets=prop,
                              objective=self.objective)
        cand.origin = plan.origin
        cand.retile_rounds = getattr(plan, "retile_rounds", 0)
        better = self.objective.better(cand, plan)
        with self._lock:
            if better:
                self.prop_split_wins += 1
            else:
                self.equal_split_wins += 1
            self.fullhouse_split = {
                "equal_makespan": plan.makespan,
                "proportional_makespan": cand.makespan,
                "budgets": list(prop),
                "winner": "proportional" if better else "equal"}
        return cand if better else plan

    def joint_tilings(self, ids: Sequence[int],
                      warm: Optional[Sequence[TiledGraph]] = None,
                      time_budget_s: Optional[float] = None,
                      seeds: Optional[
                          Sequence[Sequence[TilingSolution]]] = None,
                      graphs: Optional[Sequence[Graph]] = None
                      ) -> Optional[List[TiledGraph]]:
        """One joint cross-tenant stage-1 solve over the tenants in ``ids``
        (the full house or any occupancy subset), warm-started from the
        given tiled graphs' solutions, bounded by ``time_budget_s``
        (default ``request.joint_time_budget_s``; background lazy-miss
        compiles pass the smaller ``lazy_joint_time_budget_s``, and
        incremental warm-started re-solves ``incremental_time_budget_s``).
        Every effective budget is clamped to ``joint_time_budget_s`` — it
        is the *ceiling* on joint solving, so the ``<= 0`` ablation
        sentinel disables lazy and incremental solves too instead of
        letting them outspend the foreground path.  ``seeds`` re-seeds
        the solver with additional per-tenant solution lists (the
        compile-alone tilings, when ``warm`` came from a cached
        neighbor).  ``graphs`` overrides the per-tenant graphs (the
        bucketed subset compile passes each tenant's graph at its
        requested sequence bucket; default: the request's registered
        graphs).  Returns the coordinated per-tenant tile graphs, or
        ``None`` when the solver produced nothing within the budget — the
        caller's best-response fallback then engages (counted in
        ``joint_fallbacks``)."""
        req = self.request
        if graphs is None:
            graphs = [req.graphs[i] for i in ids]
        else:
            graphs = list(graphs)
        budget = (time_budget_s if time_budget_s is not None
                  else req.joint_time_budget_s)
        budget = min(budget, req.joint_time_budget_s)
        try:
            problem = JointTilingProblem(
                graphs, req.soc, req.patterns,
                requested_tiles=req.requested_tiles, mode=req.mode)
            warm_sols = ([tg.solution for tg in warm]
                         if warm is not None else None)
            sols = problem.solve(warm=warm_sols, time_budget_s=budget,
                                 seeds=seeds)
        except cpsolver.Infeasible:
            # the designed fallback path: budget exhausted with nothing
            # feasible found.  Real programming errors propagate — they
            # must not masquerade as budget exhaustion.
            self.joint_fallbacks += 1
            return None
        # one CpModel solve produced all N TilingSolutions — they share
        # telemetry, so record it once
        if sols:
            self._note_solve("joint", sols[0])
        tgs = [rewrite(g, req.soc, s) for g, s in zip(graphs, sols)]
        self.joint_solves += 1
        return tgs

    def decomposed_tilings(self, ids: Sequence[int],
                           warm: Optional[Sequence[TiledGraph]] = None,
                           time_budget_s: Optional[float] = None
                           ) -> Optional[List[TiledGraph]]:
        """The decomposed counterpart of :meth:`joint_tilings`
        (:func:`repro.core.decompose.solve_decomposed`): per-device-
        cluster subproblems under split L2/DMA budgets, solved
        concurrently on up to ``request.max_workers`` threads, then
        reconciled with Benders-style cuts generated from the exact
        stage-2 ``schedule_multi`` evaluation.  Runs under the same
        (clamped) budget rules as the monolithic solve; returns ``None``
        when decomposition is disabled, the mix is below
        ``decompose_min_tenants`` (in ``"auto"`` mode), the clustering
        degenerates to fewer than two device clusters, or no cluster
        produced a solution — counted in ``decomposed_fallbacks``, and
        the monolithic / best-response candidates cover the round."""
        req = self.request
        if (req.decompose == "off" or req.mode not in ASYNC_MODES
                or not req.joint_tiling):
            return None
        if req.decompose == "auto" and len(ids) < req.decompose_min_tenants:
            return None
        budget = (time_budget_s if time_budget_s is not None
                  else req.joint_time_budget_s)
        budget = min(budget, req.joint_time_budget_s)
        if budget <= 0.0:
            with self._lock:
                self.decomposed_fallbacks += 1
            return None
        graphs = [req.graphs[i] for i in ids]
        budgets = ([req.budgets[i] for i in ids]
                   if req.budgets is not None else None)

        def evaluate(sols: List[TilingSolution]
                     ) -> Tuple[float, List[float]]:
            tgs = [rewrite(g, req.soc, s) for g, s in zip(graphs, sols)]
            plan = schedule_multi(tgs, req.soc, budgets=budgets,
                                  objective=self.objective)
            return plan.makespan, list(plan.tenant_makespans)

        warm_sols = ([tg.solution for tg in warm]
                     if warm is not None else None)
        result = solve_decomposed(
            graphs, req.soc, req.patterns,
            requested_tiles=req.requested_tiles, mode=req.mode,
            time_budget_s=budget, warm=warm_sols, evaluate=evaluate,
            max_cut_rounds=req.decompose_cut_rounds,
            max_cluster_size=req.decompose_max_cluster,
            max_workers=req.max_workers)
        if result is None:
            with self._lock:
                self.decomposed_fallbacks += 1
            return None
        # each cluster was one CpModel solve; its members share telemetry
        for c in result.clusters:
            if c.tenants:
                self._note_solve("decomposed",
                                 result.solutions[c.tenants[0]])
        with self._lock:
            self.decomposed_solves += 1
            self.decomposed_cuts += result.cuts
            self.decomposed_stats = result.stats()
        return [rewrite(g, req.soc, s)
                for g, s in zip(graphs, result.solutions)]

    # -- solver telemetry ---------------------------------------------------

    def _note_solve(self, context: str, sol: TilingSolution) -> None:
        """Tally one stage-1 CP solve's telemetry (mirrored from
        ``cpsolver.Solution`` onto the :class:`TilingSolution`)."""
        with self._lock:
            s = self._solver
            s["solves"] += 1
            s["nodes"] += int(sol.solver_nodes)
            s["wall_s"] += float(sol.wall_s)
            if sol.budget_exhausted:
                s["budget_exhausted"] += 1
            src = getattr(sol, "incumbent_source", "search")
            srcs = s["incumbent_source"]
            srcs[src] = srcs.get(src, 0) + 1
            ctx = s["by_context"].setdefault(
                context, {"solves": 0, "nodes": 0, "wall_s": 0.0,
                          "budget_exhausted": 0})
            ctx["solves"] += 1
            ctx["nodes"] += int(sol.solver_nodes)
            ctx["wall_s"] += float(sol.wall_s)
            if sol.budget_exhausted:
                ctx["budget_exhausted"] += 1

    def solver_stats(self) -> Dict[str, object]:
        """Aggregated CP-solver telemetry over every stage-1 solve this
        session ran — total nodes / wall seconds, how many solves
        exhausted their budget (the previously *silent* fallback
        trigger), where incumbents came from (``hint`` / ``seed`` /
        ``search``), split by context (``single`` compile-alone solves,
        monolithic ``joint`` solves, ``decomposed`` per-cluster solves)
        — plus the decomposition counters.  Surfaced as
        ``MultiModelEngine.report()["solver"]``."""
        with self._lock:
            out: Dict[str, object] = {
                "solves": self._solver["solves"],
                "nodes": self._solver["nodes"],
                "wall_s": self._solver["wall_s"],
                "budget_exhausted": self._solver["budget_exhausted"],
                "incumbent_source": dict(self._solver["incumbent_source"]),
                "by_context": {k: dict(v) for k, v
                               in self._solver["by_context"].items()},
                "decomposed_solves": self.decomposed_solves,
                "decomposed_fallbacks": self.decomposed_fallbacks,
                "decomposed_cuts": self.decomposed_cuts,
                "decomposed": (dict(self.decomposed_stats)
                               if self.decomposed_stats is not None
                               else None)}
        return out

    # -- occupancy-indexed plans --------------------------------------------

    def _check_active(self, active: Sequence[int]) -> List[int]:
        n = len(self.request.graphs)
        ids = sorted({int(a) for a in active})
        if not ids:
            raise ValueError("plan_for needs at least one active tenant")
        if ids[0] < 0 or ids[-1] >= n:
            raise ValueError(f"active tenants {ids} out of range for "
                             f"{n} graphs")
        return ids

    # -- shape buckets -------------------------------------------------------

    def bucket_spec(self, i: int) -> Optional[ShapeBucketSpec]:
        """Tenant ``i``'s bucket spec, or ``None`` (fixed-shape)."""
        sb = self.request.shape_buckets
        return sb.get(i) if sb else None

    def plan_key(self, active: Sequence[int],
                 shapes: Optional[Mapping[int, int]] = None) -> StoreKey:
        """Canonical :data:`StoreKey` for ``active`` at the given
        per-tenant sequence buckets.  ``shapes`` maps tenant -> bucket
        (values must be members of the tenant's
        :class:`~repro.core.shapes.ShapeBucketSpec`; round raw lengths
        with ``spec.bucket_for`` first); tenants at their default bucket
        are dropped, so an all-default query collapses to the bare
        occupancy frozenset and hits the fixed-shape store entries.

        A :class:`~repro.core.shapes.PlanKey` passed as ``active`` is
        already canonical and returned as-is (``shapes`` must then be
        empty) — this lets the background compiler hand store keys it
        mined from the lattice straight back to :meth:`try_plan_for` /
        :meth:`submit_compile`."""
        if isinstance(active, PlanKey):
            if shapes:
                raise ValueError("pass buckets inside the PlanKey, not "
                                 "via shapes=")
            self._check_active(active.occupancy)
            return active
        ids = self._check_active(active)
        if not shapes:
            return frozenset(ids)
        nondefault: Dict[int, int] = {}
        for t, b in shapes.items():
            t, b = int(t), int(b)
            if t not in ids:
                raise ValueError(f"shaped tenant {t} not active: {ids}")
            spec = self.bucket_spec(t)
            if spec is None:
                raise ValueError(f"tenant {t} has no shape_buckets spec")
            if b not in spec.buckets:
                raise ValueError(f"bucket {b} not in tenant {t}'s bucket "
                                 f"set {spec.buckets}")
            if b != spec.default:
                nondefault[t] = b
        return make_plan_key(ids, nondefault)

    def bucket_graph(self, i: int, bucket: int) -> Graph:
        """Tenant ``i``'s IR graph at ``bucket`` — the registered request
        graph for the default bucket, else built once via the spec's
        ``make_graph`` and cached."""
        spec = self.bucket_spec(i)
        if spec is None:
            raise ValueError(f"tenant {i} has no shape_buckets spec")
        if bucket not in spec.buckets:
            raise ValueError(f"bucket {bucket} not in tenant {i}'s bucket "
                             f"set {spec.buckets}")
        if bucket == spec.default:
            return self.request.graphs[i]
        bkey = (i, int(bucket))
        with self._lock:
            got = self._bucket_graphs.get(bkey)
        if got is not None:
            return got
        g = spec.make_graph(bucket)
        g.validate()
        with self._lock:
            return self._bucket_graphs.setdefault(bkey, g)

    def bucket_single(self, i: int, bucket: int) -> CompiledModel:
        """Compile-alone artifact for tenant ``i`` at ``bucket`` — the
        bucketed analogue of ``singles[i]`` (which it *is* at the default
        bucket).  Built once on first use and cached; the engine's floor
        rounds and per-bucket service estimates key off these, so decode
        buckets stop being priced at the prefill graph's makespan."""
        spec = self.bucket_spec(i)
        if spec is not None and bucket == spec.default:
            return self.singles[i]
        g = self.bucket_graph(i, bucket)       # validates spec + bucket
        bkey = (i, int(bucket))
        with self._lock:
            got = self._bucket_singles.get(bkey)
        if got is not None:
            return got
        cm = self._compile_one(g)              # outside the lock: slow
        with self._lock:
            return self._bucket_singles.setdefault(bkey, cm)

    def plan_for(self, active: Sequence[int],
                 shapes: Optional[Mapping[int, int]] = None
                 ) -> MultiExecutionPlan:
        """Validated co-schedule covering exactly the ``active`` tenants,
        from the :class:`PlanStore` (compiled lazily on the first miss).
        Tenant indices inside the returned plan are positional over
        ``sorted(set(active))``.

        ``shapes`` (tenant -> sequence bucket) selects non-default shape
        buckets for LM tenants; the resulting plan is keyed by the
        (occupancy, bucket-vector) lattice point, so the same occupancy
        at prefill and at decode are distinct cached plans.

        A miss pays the subset compile — including up to
        ``joint_time_budget_s`` of per-occupancy joint solving — on the
        caller's thread; latency-sensitive callers (a serving engine's
        first round at a new occupancy) should :meth:`precompile` the
        occupancies they expect, or probe with :meth:`try_plan_for` and
        push the miss to a background
        :class:`~repro.serve.compiler_thread.BackgroundCompiler`."""
        self.compile()
        key = self.plan_key(active, shapes)
        if isinstance(key, PlanKey):
            plan = self.store.co_plan(
                key, lambda: self._compile_subset_bucketed(key))
        else:
            ids = sorted(key)
            plan = self.store.co_plan(ids,
                                      lambda: self._compile_subset(ids))
        self._record_solutions(key, plan)
        return plan

    def try_plan_for(self, active: Sequence[int], touch: bool = False,
                     shapes: Optional[Mapping[int, int]] = None
                     ) -> Optional[MultiExecutionPlan]:
        """Non-blocking, non-compiling occupancy lookup — the serving
        engine's dispatch-path probe.  Returns the cached co-schedule for
        exactly the ``active`` tenants at the given ``shapes`` (the
        fixed-shape full house always answers once the session is
        compiled), or ``None`` on a store miss.  Thread-safe; never
        triggers a compile, so it never stalls a round.  ``touch`` counts
        the lookup and refreshes LRU recency (pass it from real
        dispatches, not speculative scoring probes)."""
        if self._multi is None:
            return None
        key = self.plan_key(active, shapes)
        if (not isinstance(key, PlanKey)
                and sorted(key) == list(range(len(self.request.graphs)))):
            return self._multi.plan
        return self.store.peek(key, touch=touch)

    def submit_compile(self, active: Sequence[int],
                       joint_budget_s: Optional[float] = None,
                       source: str = "background",
                       shapes: Optional[Mapping[int, int]] = None) -> bool:
        """Compile-and-cache the occupancy for ``active``, exactly once
        under concurrent submission (the background compiler's worker
        entry point — also safe to call inline).

        Uses the smaller ``request.lazy_joint_time_budget_s`` joint
        budget by default: on the serving path a long joint solve only
        delays how soon the engine can leave the compile-alone floor, and
        the floor is already a hard lower bound on the plan quality this
        compile must deliver.  Returns True when this call compiled the
        plan AND landed it in the store; False when the occupancy was
        already cached, in flight on another thread, the (always-cached)
        full house, or lost the store race to a concurrent blocking
        ``plan_for``.

        ``source`` labels the miss event for the per-origin
        compile-latency split (:meth:`compile_latency_stats`):
        ``"background"`` for reactive miss compiles, ``"prefetch"`` for
        speculative occupancy-lattice prefetches."""
        if source not in ("background", "prefetch"):
            raise ValueError(f"unknown compile source {source!r}")
        self.compile()
        key = self.plan_key(active, shapes)
        if (not isinstance(key, PlanKey)
                and sorted(key) == list(range(len(self.request.graphs)))):
            return False
        with self._lock:
            if key in self.store or key in self._inflight:
                return False
            self._inflight.add(key)
        budget = (joint_budget_s if joint_budget_s is not None
                  else self.request.lazy_joint_time_budget_s)
        landed = False
        try:
            if isinstance(key, PlanKey):
                plan = self._compile_subset_bucketed(
                    key, joint_budget_s=budget, source=source)
            else:
                plan = self._compile_subset(sorted(key),
                                            joint_budget_s=budget,
                                            source=source)
            # a concurrent blocking plan_for may have landed first; only
            # a plan that actually entered the store counts as compiled
            landed = self.store.seed(key, plan)
            if landed:
                self._record_solutions(key, plan)
                with self._lock:
                    self.lazy_compiles += 1
        finally:
            with self._lock:
                self._inflight.discard(key)
        return landed

    def precompile(self, subsets: Sequence[Sequence[int]]) -> None:
        """Eagerly co-schedule the given occupancy subsets into the store."""
        for subset in subsets:
            self.plan_for(subset)

    def _compile_subset(self, ids: List[int],
                        joint_budget_s: Optional[float] = None,
                        source: str = "foreground"
                        ) -> MultiExecutionPlan:
        """Per-occupancy compile: tiling is re-decided for the subset
        instead of blindly reusing the full-house winner's tilings.

        Candidate tiling sets, arbitrated under the exact shared-resource
        model with the shared L2 re-split among just the active tenants
        (or sliced from the request's explicit budgets):

          * the full-house winner's tilings (the full-house behaviour — right
            when the subset's contention resembles the full house),
          * the members' compile-alone tilings (right at low occupancy,
            where a tenant runs nearly alone),
          * with ``incremental`` on, the Hamming-nearest cached
            occupancy's tilings (:meth:`PlanStore.nearest_solutions` —
            a superset/subset that already co-tiled these members under
            similar contention),
          * a fresh joint cross-tenant solve over just the subset —
            warm-started from the neighbor's solutions when one exists
            (re-seeded with the compile-alone tilings so the solver never
            starts worse than before), from the compile-alone tilings
            otherwise.  A warm-started solve runs under the smaller
            ``incremental_time_budget_s``: it starts at a near-optimal
            incumbent, so the long from-scratch budget buys nothing.

        With ``l2_split="proportional"`` (and no explicit request
        budgets) the multi-tenant candidates are arbitrated twice — once
        under budgets proportional to the tenants' linearized working
        sets, once under the equal split — and the better plan ships, so
        the proportional split can never lose to the old equal re-split.

        The sequential concatenation of the members' reference schedules
        is a candidate inside ``schedule_multi``, and the compile-alone
        back-to-back concatenation (the pre-session engine fallback) is a
        hard floor at the end — so every occupancy's co-schedule beats (or
        ties) both, and the partial-occupancy benchmark can no longer
        report negative-gain rounds.  Numerics stay bitwise: whichever
        tiling set wins, each tenant's reference schedule for *that*
        tiling is served by :meth:`reference_plan`.  Each miss's wall
        time, warm-start source and split winner are appended to
        ``miss_events`` (see :meth:`compile_latency_stats`)."""
        req = self.request
        t0 = time.perf_counter()
        mc = self._multi
        full_tgs = [mc.plan.tenants[i] for i in ids]
        alone_tgs = [self.singles[i].tiled for i in ids]
        refs = [self.tenant_plan(i) for i in ids]
        budgets = ([req.budgets[i] for i in ids]
                   if req.budgets is not None else None)
        sigs = {_sets_sig(full_tgs)}
        alt_sets: List[List[TiledGraph]] = []
        labels: List[str] = []

        def offer(tgs: List[TiledGraph], label: str) -> None:
            sig = _sets_sig(tgs)
            if sig not in sigs:
                sigs.add(sig)
                alt_sets.append(list(tgs))
                labels.append(label)

        offer(alone_tgs, "compile-alone")

        # incremental warm start: the nearest cached occupancy's tilings
        neighbor: Optional[StoreKey] = None
        warm_tgs: Optional[List[TiledGraph]] = None
        if req.incremental:
            near = self.store.nearest_solutions(ids)
            if near is not None:
                nkey, nsols = near
                nbks = key_parts(nkey)[1]
                # members the neighbor lacks (it was a strict subset) —
                # or tiled at a NON-default bucket (a solution for
                # another sequence length is not a tiling of this
                # graph) — fall back to their full-house co-tiled
                # solutions
                warm_sols = [nsols[i] if i in nsols and nbks.get(i) is None
                             else mc.plan.tenants[i].solution
                             for i in ids]
                neighbor = nkey
                warm_tgs = [self._rewrite_cached(i, s)
                            for i, s in zip(ids, warm_sols)]
                offer(warm_tgs, "warm-neighbor")
                with self._lock:
                    self.incremental_hits += 1

        if (len(ids) > 1 and req.joint_tiling and req.mode in ASYNC_MODES
                and any(getattr(s, "joint", False)
                        for s in self.strategies)):
            if joint_budget_s is not None:
                budget = joint_budget_s
            elif warm_tgs is not None:
                budget = req.incremental_time_budget_s
            else:
                budget = req.joint_time_budget_s
            seeds = ([[self.singles[i].solution for i in ids]]
                     if warm_tgs is not None else None)
            jtgs = self.joint_tilings(ids,
                                      warm=(warm_tgs if warm_tgs is not None
                                            else alone_tgs),
                                      time_budget_s=budget, seeds=seeds)
            if jtgs is not None:
                offer(jtgs, "joint-cp")
            dtgs = self.decomposed_tilings(
                ids, warm=(warm_tgs if warm_tgs is not None else alone_tgs),
                time_budget_s=budget)
            if dtgs is not None:
                offer(dtgs, "decomposed-cp")

        prop = self._subset_prop_budgets(ids, alt_sets, labels, budgets)
        plan = schedule_multi(full_tgs, req.soc,
                              budgets=(prop if prop is not None
                                       else budgets),
                              singles=refs, alt_tgs=alt_sets,
                              alt_labels=labels, objective=self.objective)
        split = None
        prop_ms = equal_ms = None
        if prop is not None:
            # arbitrate the proportional split against the equal one: the
            # same candidate search under the old equal split, with the
            # better plan shipping — "proportional" can then never ship a
            # plan worse than the equal re-split would have
            prop_ms = plan.makespan
            plan_eq = schedule_multi(full_tgs, req.soc, budgets=None,
                                     singles=refs, alt_tgs=alt_sets,
                                     alt_labels=labels,
                                     objective=self.objective)
            equal_ms = plan_eq.makespan
            if self.objective.better(plan_eq, plan):
                plan, split = plan_eq, "equal"
            else:
                split = "proportional"
            with self._lock:
                if split == "proportional":
                    self.prop_split_wins += 1
                else:
                    self.equal_split_wins += 1
        seq_alone = concat_plans([self.singles[i].plan for i in ids],
                                 req.soc, budgets)
        seq_alone.origin = "sequential-alone"
        if self.objective.better(seq_alone, plan):
            plan = seq_alone
        self._analyze(plan, f"infeasible subset co-schedule for "
                            f"tenants {ids}")
        event = {"occupancy": tuple(ids),
                 "wall_s": time.perf_counter() - t0,
                 "source": source,
                 "warm": neighbor is not None,
                 "neighbor": (None if neighbor is None
                              else describe_key(neighbor)
                              if isinstance(neighbor, PlanKey)
                              else tuple(sorted(neighbor))),
                 "origin": plan.origin, "makespan": plan.makespan,
                 "split": split, "proportional_makespan": prop_ms,
                 "equal_makespan": equal_ms}
        with self._lock:
            self.miss_events.append(event)
        return plan

    def _compile_subset_bucketed(self, key: PlanKey,
                                 joint_budget_s: Optional[float] = None,
                                 source: str = "foreground"
                                 ) -> MultiExecutionPlan:
        """Per-lattice-point compile: :meth:`_compile_subset` with each
        tenant's graph materialized at its requested sequence bucket, so
        the candidate tilings, the L2-split arbitration and the
        sequential floor all price the actual shapes of the round.

        Candidate tiling sets:

          * the members' *bucket-alone* tilings (the base set — each
            tenant compiled alone at its bucket),
          * the product-lattice-nearest recorded key's solutions
            (:meth:`PlanStore.nearest_solutions`), reused per tenant
            ONLY where that key's bucket matches this one — a tiling
            chosen for another sequence length is not a tiling of this
            graph; mismatched tenants substitute their bucket-alone
            solution,
          * a fresh joint cross-tenant solve over the bucket graphs
            (:meth:`joint_tilings` with the ``graphs`` override).

        The fixed-shape path's full-house-tilings candidate is
        deliberately absent (those tilings were derived at default
        buckets and are shape-invalid here), and the decomposed solve is
        skipped (it reads the request's registered graphs); the
        compile-alone concatenation floor still guarantees a bucketed
        round never loses to running its members back to back."""
        req = self.request
        t0 = time.perf_counter()
        occ, bks = key_parts(key)
        ids = sorted(occ)
        graphs: List[Graph] = []
        alones: List[CompiledModel] = []
        for i in ids:
            b = bks.get(i)
            if b is None:
                graphs.append(req.graphs[i])
                alones.append(self.singles[i])
            else:
                graphs.append(self.bucket_graph(i, b))
                alones.append(self.bucket_single(i, b))
        base_tgs = [cm.tiled for cm in alones]
        refs = [cm.plan for cm in alones]
        budgets = ([req.budgets[i] for i in ids]
                   if req.budgets is not None else None)
        sigs = {_sets_sig(base_tgs)}
        alt_sets: List[List[TiledGraph]] = []
        labels: List[str] = []

        def offer(tgs: List[TiledGraph], label: str) -> None:
            sig = _sets_sig(tgs)
            if sig not in sigs:
                sigs.add(sig)
                alt_sets.append(list(tgs))
                labels.append(label)

        neighbor: Optional[StoreKey] = None
        warm_tgs: Optional[List[TiledGraph]] = None
        if req.incremental:
            near = self.store.nearest_solutions(key)
            if near is not None:
                nkey, nsols = near
                nbks = key_parts(nkey)[1]
                matched = 0
                warm_sols: List[TilingSolution] = []
                for pos, i in enumerate(ids):
                    sol = nsols.get(i)
                    if sol is not None and nbks.get(i) == bks.get(i):
                        warm_sols.append(sol)
                        matched += 1
                    else:
                        warm_sols.append(alones[pos].solution)
                if matched:
                    neighbor = nkey
                    warm_tgs = [cm.tiled if s is cm.solution
                                else rewrite(g, req.soc, s)
                                for g, cm, s in zip(graphs, alones,
                                                    warm_sols)]
                    offer(warm_tgs, "warm-neighbor")
                    with self._lock:
                        self.incremental_hits += 1

        if (len(ids) > 1 and req.joint_tiling and req.mode in ASYNC_MODES
                and any(getattr(s, "joint", False)
                        for s in self.strategies)):
            if joint_budget_s is not None:
                budget = joint_budget_s
            elif warm_tgs is not None:
                budget = req.incremental_time_budget_s
            else:
                budget = req.joint_time_budget_s
            seeds = ([[cm.solution for cm in alones]]
                     if warm_tgs is not None else None)
            jtgs = self.joint_tilings(ids,
                                      warm=(warm_tgs if warm_tgs is not None
                                            else base_tgs),
                                      time_budget_s=budget, seeds=seeds,
                                      graphs=graphs)
            if jtgs is not None:
                offer(jtgs, "joint-cp")

        prop = None
        if (budgets is None and req.l2_split == "proportional"
                and len(ids) >= 2):
            src_tgs = base_tgs
            for label in ("joint-cp", "warm-neighbor"):
                if label in labels:
                    src_tgs = alt_sets[labels.index(label)]
                    break
            ws = [solution_ws_bytes(g, tg.solution)
                  for g, tg in zip(graphs, src_tgs)]
            p = proportional_budgets(req.soc.l2.size, ws)
            prop = p if p != default_budgets(req.soc, len(ids)) else None

        plan = schedule_multi(base_tgs, req.soc,
                              budgets=(prop if prop is not None
                                       else budgets),
                              singles=refs, alt_tgs=alt_sets,
                              alt_labels=labels, objective=self.objective)
        split = None
        prop_ms = equal_ms = None
        if prop is not None:
            prop_ms = plan.makespan
            plan_eq = schedule_multi(base_tgs, req.soc, budgets=None,
                                     singles=refs, alt_tgs=alt_sets,
                                     alt_labels=labels,
                                     objective=self.objective)
            equal_ms = plan_eq.makespan
            if self.objective.better(plan_eq, plan):
                plan, split = plan_eq, "equal"
            else:
                split = "proportional"
            with self._lock:
                if split == "proportional":
                    self.prop_split_wins += 1
                else:
                    self.equal_split_wins += 1
        seq_alone = concat_plans(refs, req.soc, budgets)
        seq_alone.origin = "sequential-alone"
        if self.objective.better(seq_alone, plan):
            plan = seq_alone
        self._analyze(plan, f"infeasible bucketed co-schedule for "
                            f"{describe_key(key)}")
        event = {"occupancy": tuple(ids),
                 "key": describe_key(key),
                 "wall_s": time.perf_counter() - t0,
                 "source": source,
                 "warm": neighbor is not None,
                 "neighbor": (describe_key(neighbor)
                              if neighbor is not None else None),
                 "origin": plan.origin, "makespan": plan.makespan,
                 "split": split, "proportional_makespan": prop_ms,
                 "equal_makespan": equal_ms}
        with self._lock:
            self.miss_events.append(event)
        return plan

    def _subset_prop_budgets(self, ids: List[int],
                             alt_sets: List[List[TiledGraph]],
                             labels: List[str],
                             budgets: Optional[List[int]]
                             ) -> Optional[List[int]]:
        """The proportional L2 split for this subset compile, or ``None``
        when the equal split (or the request's explicit slice) applies.
        Weights come from the best available per-tenant solutions: the
        joint solve's if it ran, else the warm neighbor's, else the
        compile-alone ones."""
        req = self.request
        if (budgets is not None or req.l2_split != "proportional"
                or len(ids) < 2):
            return None
        for label in ("joint-cp", "decomposed-cp", "warm-neighbor",
                      "compile-alone"):
            if label in labels:
                tgs = alt_sets[labels.index(label)]
                break
        else:
            return None
        ws = [solution_ws_bytes(req.graphs[i], tg.solution)
              for i, tg in zip(ids, tgs)]
        prop = proportional_budgets(req.soc.l2.size, ws)
        return prop if prop != default_budgets(req.soc, len(ids)) else None

    def _rewrite_cached(self, i: int, sol: TilingSolution) -> TiledGraph:
        """Tiled graph for tenant ``i`` over ``sol``, reusing the already-
        rewritten graph when the solution IS the compile-alone or
        full-house one — cached reference plans and the engine's identity
        contracts key off those exact objects."""
        if sol is self.singles[i].solution:
            return self.singles[i].tiled
        mc = self._multi
        if mc is not None and mc.plan.tenants[i].solution is sol:
            return mc.plan.tenants[i]
        return rewrite(self.request.graphs[i], self.request.soc, sol)

    def _record_solutions(self, key,
                          plan: MultiExecutionPlan) -> None:
        """Sidecar the landed plan's per-tenant tiling solutions so later
        misses can warm-start from them even after the plan itself is
        LRU-evicted (skipped if any tenant lacks a solution).  ``key`` is
        any :meth:`PlanStore` key form; bucketed plans record under their
        lattice point, so the warm-start search can tell which bucket a
        recorded solution was tiled at."""
        key = PlanStore._norm(key)
        sols: Dict[int, TilingSolution] = {}
        for pos, i in enumerate(sorted(key_occupancy(key))):
            sol = getattr(plan.tenants[pos], "solution", None)
            if sol is None:
                return
            sols[i] = sol
        self.store.seed_solutions(key, sols)

    def compile_latency_stats(self) -> Dict[str, object]:
        """p50/p99 wall time of the subset-miss compiles this session ran
        (``miss_events``), overall, split by warm (neighbor-seeded) vs
        cold (from-scratch), and split by origin — ``foreground``
        (blocking ``plan_for`` misses), ``background`` (reactive
        ``submit_compile`` misses) and ``prefetch`` (speculative
        occupancy-lattice prefetches) — so a busy prefetcher cannot mask
        a foreground-latency regression in the blended percentiles.  The
        serving engine surfaces this in its ``report()``."""
        with self._lock:
            events = list(self.miss_events)

        def pct(vals: List[float], q: float) -> Optional[float]:
            if not vals:
                return None
            vs = sorted(vals)
            k = max(min(int(math.ceil(q * len(vs))) - 1, len(vs) - 1), 0)
            return vs[k]

        def block(evts: List[Dict[str, object]]) -> Dict[str, object]:
            walls = [float(e["wall_s"]) * 1e3 for e in evts]
            return {"count": len(evts), "p50_ms": pct(walls, 0.50),
                    "p99_ms": pct(walls, 0.99)}

        out = block(events)
        out["warm"] = block([e for e in events if e["warm"]])
        out["cold"] = block([e for e in events if not e["warm"]])
        for src in ("foreground", "background", "prefetch"):
            out[src] = block([e for e in events
                              if e.get("source", "foreground") == src])
        with self._lock:
            out["incremental_hits"] = self.incremental_hits
            out["prop_split_wins"] = self.prop_split_wins
            out["equal_split_wins"] = self.equal_split_wins
        return out

    def tenant_plan(self, i: int) -> ExecutionPlan:
        """Single-model reference schedule for tenant ``i`` over the tiled
        graph it uses inside the *full-house* co-schedule, cached in the
        store."""
        mc = self.compile()
        return self.reference_plan(i, mc.plan.tenants[i])

    def reference_plan(self, i: int, tg: TiledGraph,
                       bucket: Optional[int] = None) -> ExecutionPlan:
        """Single-model reference schedule for tenant ``i`` over exactly
        the tiled graph ``tg`` — the bitwise numerics reference for any
        occupancy's co-schedule (per-occupancy plans may tile a tenant
        differently from the full house, so references are cached per
        ``(tenant, tiling-signature)``).  ``bucket`` scopes the cache key
        to a sequence bucket — tiling signatures only describe device /
        tile-range structure, so the same signature at two buckets is
        two different schedules (key ``(tenant, bucket, signature)``)."""
        alone = (self.singles[i] if bucket is None
                 else self.bucket_single(i, bucket))
        if tg is alone.tiled:
            return alone.plan
        key: Hashable = ((i, _tiling_sig(tg)) if bucket is None
                         else (i, int(bucket), _tiling_sig(tg)))
        if not self.store.has_tenant(key):
            # a complementary-selection winner's tiling already has a
            # full-effort compile-alone plan in the candidate pool; seed
            # it (reuse, not a compile) instead of re-scheduling at
            # reduced effort
            for p in alone.alt_plans.values():
                if p.tiled is tg:
                    self.store.seed_tenant(key, p)
                    break
        return self.store.tenant_plan(
            key, lambda: self._analyze(
                schedule(tg, self.request.soc, self.request.mode,
                         restarts=1, anneal_iters=0),
                f"infeasible reference plan for tenant {i}"))
